"""Kernels K5, K3 (fly form), K6 and K7: the no-volume window cost of both
views, every pyramid level in one launch (csrc/fly_cost.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel` on
its fly path (`_fly_build`, the strided window, `_fly_build_image` with the
`image_lerp` branch, the Lab weight slab).  Its plain version is
ops.onthefly_cost.fly_plane_cost.  The kernel reads O(H*W) inputs per level
(packed BGR interleaved with the f32 gradient, packed Lab) and never builds
a volume.

`prepare_fly` does once per pair what does not depend on the candidates
(the JAX package's `prepare_fly`): it checks the levels, packs the images
into the kernel's layout, builds the weight table and the per-level
argument arrays; `fly_cost_prepared` then only launches.  On CPU tensors
the same object routes to the plain version.

Two designs (csrc/fly_cost.cu), chosen by `launch_plan` from the call's
shape: a block walks its window rows, building each once into shared
memory that all its centers and candidates read (the shared-row design):
the GRD slice costs in cost-lerp mode (K5, K3's fly form, K7), the other
view's reachable columns as f32 channels in image-lerp mode (K6, a ring
of tile rows walked diagonally); where those rows do not fit a block's
shared memory, a thread computes every sample's data term itself, one
sample at a time.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .. import onthefly_cost, plane_cost
from . import _build, check_half_wnd, check_tensor, pack_bgr

# Kernel launches by variant, keyed (lerp, lab, strided): lerp "cost" is
# K5, "image" K6, lab the Lab weight slab of K7, strided the window of K3.
# The GPU tier clears and reads it.
launches: collections.Counter = collections.Counter()
# The launches among them that took the shared-row design, keyed alike.
shared_launches: collections.Counter = collections.Counter()


def count(lerp: str | None = None, lab: bool | None = None,
          strided: bool | None = None) -> int:
    """Launches whose variant matches every part given: count(lerp="cost")
    for K5, count(lerp="image") K6, count(lab=True) K7, count(strided=True)
    K3; count() all."""
    want = (lerp, lab, strided)
    return sum(n for key, n in launches.items()
               if all(w is None or w == k for w, k in zip(want, key)))

MAX_LEVELS = 8
# trunc(dq) is read from the mantissa of dq + 2^23 (csrc/window_common.cuh)
MAX_DIS_LIMIT = 1 << 22

# The kernels' tiling (csrc/fly_cost.cu, csrc/window_common.cuh): a tile's
# columns and most rows, the weight table's entries, the shared-row
# design's raw and slice-cost rings (cost lerp), its ring of tile rows and
# padded weight table (image lerp), and the H100's shared memory a block
# may hold, an SM has, and the runtime keeps of each block.
TX, MAX_TY = 32, 16
LUT_N = 766
RAW_STAGES, COST_STAGES = 3, 2
TAP_ROWS, TAP_LUT = 17, 768
RANGE_WORDS = 8
MAX_SMEM = 232_448
SM_SMEM = 233_472
BLOCK_RESERVE = 1024
# candidates a thread of the shared-row design holds (its instances)
ROW_CANDS = (1, 2, 4, 5, 8)


class Plan(NamedTuple):
    """How one fly launch runs (launch_plan)."""
    rows: bool       # the shared-row design, else one sample at a time
    tile_rows: int   # a block's rows of 32 pixels: 16 or 8
    lattice: int     # its rows' spacing, and in cost lerp its columns':
    #                  1, or the stride (shared rows)
    cands: int       # candidates a thread holds (1 one sample at a time)
    per_chunk: int   # candidates a block takes
    chunks: int      # blocks along z a view: ceil(K / per_chunk)
    smem: int        # shared bytes a block
    grid: Tuple[int, int, int]


def cost_stride(max_dis: int) -> int:
    """The row buffer's column stride in floats (csrc/fly_cost.cu
    cost_stride): odd, so 32 neighbouring columns at one slice lie in 32
    banks."""
    return max_dis | 1


def row_cols(half_wnd: int, stride: int, lattice: int) -> int:
    """The shared-row design's tile columns (csrc/fly_cost.cu row_cols):
    every column from the tile's first center - half_wnd to its last +
    half_wnd, or on a lattice only the columns its windows sample."""
    if lattice == 1:
        return TX + 2 * half_wnd
    return TX - 1 + (2 * half_wnd) // stride + 1


def rows_smem_bytes(half_wnd: int, stride: int, lattice: int, max_dis: int,
                    lab: bool) -> int:
    """A block's shared memory in the shared-row design (csrc/fly_cost.cu
    rows_smem_bytes): the rows' slice ranges, the weight table, RAW_STAGES
    window rows of the other view's reachable columns (8 bytes a pixel) and
    of the tile's colour, gradient and, with Lab weights, Lab words, and
    COST_STAGES rows of the slice costs 1 .. max_dis of the tile's
    columns."""
    tw = row_cols(half_wnd, stride, lattice)
    ow = lattice * (tw - 1) + 1 + max_dis
    return 4 * (RANGE_WORDS + LUT_N
                + RAW_STAGES * (2 * ow + tw * (3 if lab else 2))
                + COST_STAGES * tw * cost_stride(max_dis))


def image_rows_smem_bytes(half_wnd: int, max_dis: int, lab: bool) -> int:
    """A block's shared memory in image lerp's shared-row design
    (csrc/fly_cost.cu image_rows_smem_bytes): the weight table (TAP_LUT
    words) and TAP_ROWS tile rows, each the other view's reachable columns
    as f32 channels (16 bytes a column: the tile's 32 + 2 half_wnd columns,
    max_dis beyond them and one more) and the tile's columns as weight
    words, gradients and, with Lab weights, colour words."""
    tw = TX + 2 * half_wnd
    ow = tw + max_dis + 1
    return 4 * (TAP_LUT + TAP_ROWS * (4 * ow + tw * (3 if lab else 2)))


def sample_smem_bytes(half_wnd: int, max_dis: int, lab: bool,
                      tile_rows: int) -> int:
    """A block's shared memory one sample at a time (csrc/fly_cost.cu
    sample_smem_bytes): the level-0 tiles of the reference view, its Lab
    words, and the other view's reachable columns."""
    tile = (TX + 2 * half_wnd) * (tile_rows + 2 * half_wnd)
    oth = (TX + 2 * half_wnd + max_dis) * (tile_rows + 2 * half_wnd)
    return 4 * (LUT_N + tile * (3 if lab else 2) + oth * 2)


def resident_warps(smem: int, tile_rows: int) -> int:
    """Warps an SM keeps resident with this tile one sample at a time, at
    the 64 registers a thread that two 512-thread blocks leave."""
    if smem > MAX_SMEM:
        return 0
    by_smem = SM_SMEM // (smem + BLOCK_RESERVE)
    return min(by_smem, 2 * MAX_TY // tile_rows) * tile_rows


@functools.lru_cache(maxsize=None)
def launch_plan(k: int, h: int, w: int, half_wnd: int, max_dis: int,
                stride: int, levels: int, lab: bool, image: bool) -> Plan:
    """The design and tiling of one launch on K candidates of an H x W
    frame at a window stride over `levels` levels, from the call's shape
    alone (max_dis the finest level's; a coarser level needs less): either
    lerp (cost, K5 / K7; image, K6) takes the shared-row design where its
    rings fit a block, a thread holding the fewest of ROW_CANDS that take a
    chunk of at most 8 candidates (the K split as evenly as it goes), and
    at one level with a stride a block's pixels on a lattice of that step
    (its windows then sample one residue of rows and columns); past the
    rings' fit a launch computes one sample at a time on a tile of 16 rows
    unless 8 keep more warps resident."""
    lat = stride if levels == 1 else 1
    smem = (image_rows_smem_bytes(half_wnd, max_dis, lab) if image else
            rows_smem_bytes(half_wnd, stride, lat, max_dis, lab))
    if smem <= MAX_SMEM:
        chunks = -(-k // ROW_CANDS[-1])
        per = -(-k // chunks)
        cands = min(c for c in ROW_CANDS if c >= per)
        chunks = -(-k // per)
        lx = 1 if image else lat  # image lerp's columns stay adjacent
        return Plan(True, MAX_TY, lat, cands, per, chunks, smem,
                    (-(-w // (TX * lx)) * lx,
                     -(-h // (MAX_TY * lat)) * lat, 2 * chunks))
    return sample_plan(k, h, w, half_wnd, max_dis, lab)


def sample_plan(k: int, h: int, w: int, half_wnd: int, max_dis: int,
                lab: bool) -> Plan:
    """One sample at a time (either lerp): a block a candidate and view, on
    a tile of 16 rows unless 8 keep more warps resident."""
    w16 = resident_warps(sample_smem_bytes(half_wnd, max_dis, lab, 16), 16)
    w8 = resident_warps(sample_smem_bytes(half_wnd, max_dis, lab, 8), 8)
    rows = 16 if w16 >= w8 else 8
    return Plan(False, rows, 1, 1, 1, k,
                sample_smem_bytes(half_wnd, max_dis, lab, rows),
                (-(-w // TX), -(-h // rows), 2 * k))


def interleave_ref(img_u8: torch.Tensor, grd: torch.Tensor) -> torch.Tensor:
    """u8[..., 3] BGR and f32[...] gradient -> i32[..., 2]: per pixel the
    packed colour word and the gradient's bits, the 8 bytes the kernel
    stages with one load."""
    return torch.stack([pack_bgr(img_u8), grd.contiguous().view(torch.int32)],
                       dim=-1).contiguous()


@dataclasses.dataclass
class PreparedFly:
    """What the fly cost needs per pair (see prepare_fly)."""

    fd: onthefly_cost.FlyData
    scale_wgts: Tuple[float, ...] | None
    half_wnd: int
    max_dis: int
    kw: dict    # gamma, alpha, tau_clr, tau_grd, border_thres, lerp
    hw: Tuple[int, int]            # fine-level (H, W)
    device: torch.device
    # the kernel's side: the tensors its argument arrays point into (the
    # weight table last), and the arrays
    tensors: List[torch.Tensor] = dataclasses.field(default_factory=list)
    args: tuple = ()

    @property
    def levels(self) -> int:
        return len(self.fd.imgs)


def prepare_fly(fd: onthefly_cost.FlyData,
                scale_wgts: Sequence[float] | None, *, half_wnd: int,
                max_dis: int, gamma: float, alpha: float, tau_clr: float,
                tau_grd: float, border_thres: float,
                lerp: str) -> PreparedFly:
    """Everything of the fly cost that does not depend on the candidates
    (see ops.onthefly_cost.fly_plane_cost for the arguments); raises
    ValueError on inputs the kernel does not take."""
    n = len(fd.imgs)
    dev = fd.imgs[0].device
    h, w = fd.imgs[0].shape[1:3]
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels outside the kernel's [1, {MAX_LEVELS}]")
    if (scale_wgts is None) != (n == 1) or (
            scale_wgts is not None and len(scale_wgts) != n):
        raise ValueError("scale_wgts must be None for one level and hold "
                         "one weight per level for several")
    if len(fd.grds) != n or (fd.wimgs is not None and len(fd.wimgs) != n):
        raise ValueError("imgs, grds and wimgs must have one entry per level")
    if lerp not in ("cost", "image"):
        raise ValueError(f"lerp must be 'cost' or 'image', got {lerp!r}")
    check_half_wnd(half_wnd, dev)
    if not 0 <= max_dis < MAX_DIS_LIMIT:
        raise ValueError(f"max_dis {max_dis} outside [0, {MAX_DIS_LIMIT})")
    prep = PreparedFly(
        fd=fd, scale_wgts=(None if scale_wgts is None
                           else tuple(float(x) for x in scale_wgts)),
        half_wnd=half_wnd, max_dis=max_dis,
        kw=dict(gamma=gamma, alpha=alpha, tau_clr=tau_clr, tau_grd=tau_grd,
                border_thres=border_thres, lerp=lerp),
        hw=(h, w), device=dev)
    lab = fd.wimgs is not None
    md, shapes = max_dis, []
    for s in range(n):
        # ceil-halved per level, so every fine pixel's center (y >> s,
        # x >> s) lies inside level s
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        if dev.type != "cpu":
            check_tensor(f"imgs[{s}]", fd.imgs[s], (torch.uint8,),
                         (2, hs, ws, 3))
            check_tensor(f"grds[{s}]", fd.grds[s], (torch.float32,),
                         (2, hs, ws))
            if lab:
                check_tensor(f"wimgs[{s}]", fd.wimgs[s], (torch.uint8,),
                             (2, hs, ws, 3))
        if dev.type != "cpu" and lerp == "image" and md > 1 and md >= ws:
            # the kernel wraps a tap modulo the width, HandleBorder by one
            # +-W: the two agree while max_dis < W
            raise ValueError(f"image lerp needs max_dis {md} < width {ws} "
                             f"at level {s}")
        shapes.append((hs, ws, md))
        md //= 2
    refs = [interleave_ref(im, g) for im, g in zip(fd.imgs, fd.grds)]
    wgts = [pack_bgr(im) for im in fd.wimgs] if lab else refs
    lut = plane_cost.asw_lut(gamma, dev)
    sat = onthefly_cost.fly_sat_cost(alpha, tau_clr, tau_grd)

    def arr(ctype, xs):
        return (ctype * n)(*xs)

    prep.tensors = [*refs, *wgts, lut]
    prep.args = (
        arr(ctypes.c_void_p, [t.data_ptr() for t in refs]),
        arr(ctypes.c_void_p, [t.data_ptr() for t in wgts]),
        arr(ctypes.c_int, [sh[0] for sh in shapes]),
        arr(ctypes.c_int, [sh[1] for sh in shapes]),
        arr(ctypes.c_int, [sh[2] for sh in shapes]),
        arr(ctypes.c_float, prep.scale_wgts or [1.0]),
        n, int(lerp == "image"), int(lab),
        (ctypes.c_float * 6)(alpha, 1.0 - alpha, tau_clr, tau_grd,
                             border_thres, sat))
    return prep


def fly_cost_prepared(prep: PreparedFly, abc: torch.Tensor, *, half_wnd: int,
                      max_dis: int, levels: int,
                      wnd_stride: int = 1) -> torch.Tensor:
    """No-volume plane cost of K candidate plane fields in both views on a
    prepared pair.  The caller restates the geometry it assumes (half_wnd,
    max_dis, the level count); a mismatch with the prepared object, or
    planes of another shape or device, raises ValueError.

    Returns:
      f32[2, K, H, W].  A pair prepared from CPU tensors takes the plain
      version, one from CUDA tensors the kernel.
    """
    if (half_wnd, max_dis, levels) != (prep.half_wnd, prep.max_dis,
                                       prep.levels):
        raise ValueError(
            f"call with half_wnd={half_wnd}, max_dis={max_dis}, "
            f"levels={levels} on a pair prepared for "
            f"half_wnd={prep.half_wnd}, max_dis={prep.max_dis}, "
            f"levels={prep.levels}")
    if abc.device != prep.device:
        raise ValueError(f"abc on {abc.device}, the pair on {prep.device}")
    if abc.dim() != 5 or tuple(abc.shape[2:4]) != prep.hw:
        raise ValueError(f"abc shape {tuple(abc.shape)} does not match the "
                         f"prepared (H, W) = {prep.hw}")
    if wnd_stride < 1:
        raise ValueError(f"wnd_stride {wnd_stride} < 1")
    if prep.device.type == "cpu":
        return onthefly_cost.fly_plane_cost(
            prep.fd, prep.scale_wgts, abc, half_wnd=half_wnd,
            max_dis=max_dis, wnd_stride=wnd_stride, **prep.kw)
    k = abc.shape[1]
    h, w = prep.hw
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    if not 1 <= 2 * k <= 65535:
        raise ValueError(f"K={k} outside the kernel's grid")
    lib = _build.load()
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    lab = prep.fd.wimgs is not None
    plan = launch_plan(k, h, w, half_wnd, max_dis, wnd_stride, levels, lab,
                       prep.kw["lerp"] == "image")
    err = lib.cspm_fly_cost(
        *prep.args, abc.data_ptr(), prep.tensors[-1].data_ptr(),
        out.data_ptr(), k, h, w, half_wnd, wnd_stride, int(plan.rows),
        plan.tile_rows, plan.lattice, plan.cands, plan.per_chunk, plan.smem,
        _build.stream_of(abc))
    _build.check(err, "cspm_fly_cost")
    key = (prep.kw["lerp"], lab, wnd_stride > 1)
    launches[key] += 1
    if plan.rows:
        shared_launches[key] += 1
    return out


def fly_cost(fd: onthefly_cost.FlyData, scale_wgts: Sequence[float] | None,
             abc: torch.Tensor, *, half_wnd: int, max_dis: int, gamma: float,
             alpha: float, tau_clr: float, tau_grd: float,
             border_thres: float, lerp: str,
             wnd_stride: int = 1) -> torch.Tensor:
    """One evaluation on an unprepared pair: prepare_fly, then
    fly_cost_prepared (a caller with several evaluations per pair prepares
    once itself).

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    prep = prepare_fly(fd, scale_wgts, half_wnd=half_wnd, max_dis=max_dis,
                       gamma=gamma, alpha=alpha, tau_clr=tau_clr,
                       tau_grd=tau_grd, border_thres=border_thres, lerp=lerp)
    return fly_cost_prepared(prep, abc, half_wnd=half_wnd, max_dis=max_dis,
                             levels=prep.levels, wnd_stride=wnd_stride)


def fly_cost_cuda(fd: onthefly_cost.FlyData,
                  scale_wgts: Sequence[float] | None, abc: torch.Tensor,
                  **kw) -> torch.Tensor:
    """fly_cost for CUDA tensors only: launches the kernel, raises
    ValueError on inputs it does not take, RuntimeError on a launch it
    refuses (more shared memory than a block has, for a large half_wnd +
    max_dis)."""
    check_tensor("abc", abc, (torch.float32,), abc.shape)
    check_tensor("imgs[0]", fd.imgs[0], (torch.uint8,), fd.imgs[0].shape)
    return fly_cost(fd, scale_wgts, abc, **kw)
