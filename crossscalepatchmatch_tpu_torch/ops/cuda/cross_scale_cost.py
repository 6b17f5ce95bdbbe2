"""Kernel K4: the cross-scale window cost of both views, every pyramid level
in one launch (csrc/cross_scale_cost.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel` at
scale > 0 (with its scale-0 term and the weighted level sum of
`cross_scale_plane_cost_prepared`).  Its plain version is
ops.plane_cost.cross_scale_plane_cost.  On the card the volumes may be f32
or bf16 (cfg.vol_dtype); the kernel accumulates in f32 either way.

`prepare_cross_scale` does once per pair what does not depend on the
candidates (the JAX package's `prepare_cross_scale`): it checks the levels,
packs the images, lays the volumes out for the kernel (`pair_volume`),
builds the weight table and the per-level argument arrays;
`cross_scale_cost_prepared` then only launches.  On CPU tensors the same
object routes to the plain version.

Band form (a spatial tile, parallel.tiled): level 0 is the tile's block
with a half_wnd halo on its extended axes, the coarser levels are whole;
`origin` is the block's global fine (row, col) and each level has a
validity interval (band_rect).  The kernel takes each level's origin and
rectangle; the plain version the same origins and validity vectors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import plane_cost
from . import (_build, check_half_wnd, check_tensor, pack_bgr,
               pair_volume)

# Kernel launches (a plain count; the GPU tier resets and reads it).
launches = 0

MAX_LEVELS = 8
# trunc(dq) is read from the mantissa of dq + 2^23 (csrc/window_common.cuh)
MAX_DIS_LIMIT = 1 << 22


def take_pair(pvol: torch.Tensor, pos: torch.Tensor,
              f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both taps of a pair-layout volume [H, W, D, 2] at flat pixel index
    pos and depth index f: what plane_cost.take_depth(vol, pos, f) and
    take_depth(vol, pos, f + 1) read from the plain layout."""
    d = pvol.shape[-2]
    flat = pvol.reshape(-1, 2)[pos * d + f]
    return flat[..., 0], flat[..., 1]


def check_candidates(k: int, h: int, w: int) -> None:
    """Raise ValueError unless the K4 kernel's grid (32 x 16 tiles times K
    candidates, blockIdx.x) takes K candidates on an H x W image."""
    tiles = -(-w // 32) * -(-h // 16)
    if k < 1 or tiles * k >= 1 << 31:
        raise ValueError(f"K={k} outside the kernel's grid")


Rect = Tuple[int, int, int, int]   # (ylo, yhi, xlo, xhi), half-open


def band_rect(level_hw: Tuple[int, int], scale: int,
              origin: Tuple[int, int], out_hw: Tuple[int, int],
              bounds: Rect | None = None) -> Rect:
    """The validity rectangle of one level's arrays.

    origin (oy, ox): the arrays' position of fine output pixel (0, 0), whose
    level-s center is ((y + oy) >> s, (x + ox) >> s).  bounds: the JAX
    package's interval (ylo, yhi, xlo, xhi) in the output's fine coordinates
    (JAX tiled.py:336-350): an array pixel q of level s counts when
    (q << s) - origin lies inside it; None: the whole arrays.  Raises
    ValueError unless every output pixel's center lies inside the
    rectangle."""
    hs, ws = level_hw
    h, w = out_hw
    oy, ox = origin
    if bounds is None:
        rect = (0, hs, 0, ws)
    else:
        ylo, yhi, xlo, xhi = (int(b) for b in bounds)
        def first(v):  # ceil(v / 2^s): the first level pixel from v on
            return -(-v >> scale)

        rect = (max(0, first(ylo + oy)), min(hs, first(yhi + oy)),
                max(0, first(xlo + ox)), min(ws, first(xhi + ox)))
    if (oy < 0 or ox < 0 or rect[0] > oy >> scale
            or (h - 1 + oy) >> scale >= rect[1] or rect[2] > ox >> scale
            or (w - 1 + ox) >> scale >= rect[3]):
        raise ValueError(
            f"level {scale}: centers of the {h}x{w} output from {origin} do "
            f"not lie inside the valid rectangle {rect} of {hs}x{ws}")
    return rect


def valid_vectors(rect: Rect, level_hw: Tuple[int, int], device):
    """bool[Hs], bool[Ws]: the rows and columns of a rectangle (the plain
    versions' form of it)."""
    ys = torch.arange(level_hw[0], device=device)
    xs = torch.arange(level_hw[1], device=device)
    return ((ys >= rect[0]) & (ys < rect[1]),
            (xs >= rect[2]) & (xs < rect[3]))


def level_args(packed: Sequence[torch.Tensor], kvols: Sequence[torch.Tensor],
               max_costs: Sequence[torch.Tensor],
               shapes: Sequence[Tuple[int, int, int, int]],
               scale_wgts: Sequence[float],
               origins: Sequence[Tuple[int, int]] | None = None,
               rects: Sequence[Rect] | None = None) -> tuple:
    """The arguments of cspm_cross_scale_cost before the planes: per-level
    host arrays of the packed images', kernel-layout volumes' and
    saturation values' pointers, the levels' geometry ((Hs, Ws, Ds,
    max_dis), the origin and the validity rectangle: by default (0, 0) and
    the whole level) and weights, then the level count and the bf16 flag.
    The caller keeps the tensors alive."""
    n = len(shapes)
    origins = origins or [(0, 0)] * n
    rects = rects or [(0, sh[0], 0, sh[1]) for sh in shapes]

    def arr(ctype, xs):
        return (ctype * len(xs))(*xs)

    geom = [int(g) for sh, o, rc in zip(shapes, origins, rects)
            for g in (*sh, *o, *rc)]
    return (arr(ctypes.c_void_p, [t.data_ptr() for t in packed]),
            arr(ctypes.c_void_p, [t.data_ptr() for t in kvols]),
            arr(ctypes.c_void_p, [t.data_ptr() for t in max_costs]),
            arr(ctypes.c_int, geom),
            arr(ctypes.c_float, [float(x) for x in scale_wgts]),
            n, int(kvols[0].dtype == torch.bfloat16))


@dataclasses.dataclass
class PreparedCrossScale:
    """What the cross-scale cost needs per pair (see prepare_cross_scale)."""

    imgs_u8: Sequence[torch.Tensor]
    vols: Sequence[torch.Tensor]
    max_costs: Sequence[torch.Tensor]
    scale_wgts: Tuple[float, ...]
    half_wnd: int
    max_dis: int
    gamma: float
    hw: Tuple[int, int]            # the output's fine (H, W)
    device: torch.device
    # per level: the arrays' position of fine (0, 0) and the validity
    # rectangle (band_rect)
    origins: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    rects: List[Rect] = dataclasses.field(default_factory=list)
    band: bool = False
    # the kernel's side: the tensors its argument arrays point into (the
    # weight table last), and the arrays
    tensors: List[torch.Tensor] = dataclasses.field(default_factory=list)
    args: tuple = ()

    @property
    def levels(self) -> int:
        return len(self.scale_wgts)


def prepare_cross_scale(imgs_u8: Sequence[torch.Tensor],
                        vols: Sequence[torch.Tensor],
                        max_costs: Sequence[torch.Tensor],
                        scale_wgts: Sequence[float], *, half_wnd: int,
                        max_dis: int, gamma: float,
                        rows_extended: bool = False,
                        cols_extended: bool = False,
                        origin: Tuple[int, int] = (0, 0),
                        bounds: Sequence[Rect] | None = None
                        ) -> PreparedCrossScale:
    """Everything of the cross-scale cost that does not depend on the
    candidates.

    Args:
      imgs_u8: per level u8[2, Hs, Ws, 3] images, level 0 finest.
      vols: per level f32 or bf16 [2, Hs, Ws, Ds], Ds = (max_dis >> s) + 1.
      max_costs: per level f32[2] per-view saturation values.
      scale_wgts: per level inter-scale weights (ops.scale_weights).
      rows_extended / cols_extended: level 0's rows / columns carry a
        half_wnd halo on each side (a spatial tile's block); the output is
        the block.
      origin: the block's global fine (row, col): a coarser level is the
        whole level, and fine output pixel (x, y) centers at
        ((y + row0) >> s, (x + col0) >> s) of it.
      bounds: per level the JAX package's validity interval in the
        output's fine coordinates (band_rect); None: every level whole.

    On the card the volumes are copied into the kernel's pair layout
    (pair_volume: twice their memory) and the caller's are not held; the
    plain version reads them as they are.  Raises ValueError on inputs the
    kernel does not take.
    """
    n = len(vols)
    dev = vols[0].device
    h = vols[0].shape[1] - 2 * half_wnd * rows_extended
    w = vols[0].shape[2] - 2 * half_wnd * cols_extended
    band = rows_extended or cols_extended or tuple(origin) != (0, 0)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels outside the kernel's [1, {MAX_LEVELS}]")
    if (len(imgs_u8) != n or len(max_costs) != n or len(scale_wgts) != n
            or (bounds is not None and len(bounds) != n)):
        raise ValueError("imgs, vols, max_costs, scale_wgts and bounds must "
                         "have one entry per level")
    if h < 1 or w < 1:
        raise ValueError(f"level 0 {tuple(vols[0].shape)} holds no output "
                         "pixel")
    check_half_wnd(half_wnd, dev)
    if not 0 <= max_dis < MAX_DIS_LIMIT:
        raise ValueError(f"max_dis {max_dis} outside [0, {MAX_DIS_LIMIT})")
    prep = PreparedCrossScale(
        imgs_u8=imgs_u8, vols=vols, max_costs=max_costs,
        scale_wgts=tuple(float(x) for x in scale_wgts), half_wnd=half_wnd,
        max_dis=max_dis, gamma=gamma, hw=(h, w), device=dev, band=band)
    vol_dtype = vols[0].dtype
    if vol_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vols: dtype {vol_dtype} not f32 or bf16")
    md, shapes = max_dis, []
    for s in range(n):
        if band:
            # level 0 the extended block, the coarser levels whole
            hs, ws = vols[s].shape[1:3]
            o = ((half_wnd * rows_extended, half_wnd * cols_extended)
                 if s == 0 else tuple(int(v) for v in origin))
        else:
            # ceil-halved per level, so every fine pixel's center (y >> s,
            # x >> s) lies inside level s
            hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
            o = (0, 0)
        prep.origins.append(o)
        prep.rects.append(band_rect((hs, ws), s, o, (h, w),
                                    None if bounds is None else bounds[s]))
        if dev.type != "cpu":
            check_tensor(f"imgs_u8[{s}]", imgs_u8[s], (torch.uint8,),
                         (2, hs, ws, 3))
            check_tensor(f"vols[{s}]", vols[s], (vol_dtype,),
                         (2, hs, ws, md + 1))
            check_tensor(f"max_costs[{s}]", max_costs[s], (torch.float32,),
                         (2,))
            if hs * ws * (md + 1) >= 1 << 31:
                raise ValueError(f"vols[{s}]: {hs * ws * (md + 1)} elements "
                                 "a view, the kernel's offsets are 32-bit")
        shapes.append((hs, ws, md + 1, md))
        md //= 2
    packed = [pack_bgr(im) for im in imgs_u8]
    on_card = dev.type != "cpu"
    kvols = [pair_volume(v) for v in vols] if on_card else list(vols)
    lut = plane_cost.asw_lut(gamma, dev)
    prep.tensors = [*packed, *kvols, *max_costs, lut]
    prep.args = level_args(packed, kvols, max_costs, shapes, prep.scale_wgts,
                           prep.origins, prep.rects)
    if on_card:
        # the kernel reads the copies; the caller's volumes are not held
        prep.vols = ()
    return prep


def cross_scale_cost_prepared(prep: PreparedCrossScale, abc: torch.Tensor, *,
                              half_wnd: int, max_dis: int,
                              levels: int) -> torch.Tensor:
    """Cross-scale plane cost of K candidate plane fields in both views on
    a prepared pair.  The caller restates the geometry it assumes
    (half_wnd, max_dis, the level count); a mismatch with the prepared
    object, or planes of another shape or device, raises ValueError.

    Returns:
      f32[2, K, H, W].  A pair prepared from CPU tensors takes the plain
      version, one from CUDA tensors the kernel.
    """
    global launches
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
    if prep.device.type == "cpu":
        band = {}
        if prep.band:
            vecs = [valid_vectors(rc, im.shape[1:3], prep.device)
                    for rc, im in zip(prep.rects, prep.imgs_u8)]
            band = dict(origins=prep.origins,
                        row_valids=[v[0] for v in vecs],
                        col_valids=[v[1] for v in vecs])
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in prep.imgs_u8], [vo[v] for vo in prep.vols],
            [mc[v] for mc in prep.max_costs], prep.scale_wgts, abc[v],
            half_wnd=half_wnd, max_dis=max_dis, gamma=prep.gamma, **band)
            for v in range(2)])
    k = abc.shape[1]
    h, w = prep.hw
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    check_candidates(k, h, w)
    lib = _build.load()
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    err = lib.cspm_cross_scale_cost(
        *prep.args, abc.data_ptr(), prep.tensors[-1].data_ptr(),
        out.data_ptr(), k, h, w, half_wnd, 1, _build.stream_of(abc))
    _build.check(err, "cspm_cross_scale_cost")
    launches += 1
    return out


def cross_scale_cost(imgs_u8: Sequence[torch.Tensor],
                     vols: Sequence[torch.Tensor],
                     max_costs: Sequence[torch.Tensor],
                     scale_wgts: Sequence[float], abc: torch.Tensor, *,
                     half_wnd: int, max_dis: int,
                     gamma: float) -> torch.Tensor:
    """One evaluation on an unprepared pair: prepare_cross_scale, then
    cross_scale_cost_prepared (a caller with several evaluations per pair
    prepares once itself).

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    if abc.device != vols[0].device:
        raise ValueError(f"abc on {abc.device}, the volumes on "
                         f"{vols[0].device}")
    prep = prepare_cross_scale(imgs_u8, vols, max_costs, scale_wgts,
                               half_wnd=half_wnd, max_dis=max_dis,
                               gamma=gamma)
    return cross_scale_cost_prepared(prep, abc, half_wnd=half_wnd,
                                     max_dis=max_dis, levels=prep.levels)


def cross_scale_cost_cuda(imgs_u8: Sequence[torch.Tensor],
                          vols: Sequence[torch.Tensor],
                          max_costs: Sequence[torch.Tensor],
                          scale_wgts: Sequence[float], abc: torch.Tensor,
                          **kw) -> torch.Tensor:
    """cross_scale_cost for CUDA tensors only: launches K4, raises on
    anything it does not take."""
    check_tensor("abc", abc, (torch.float32,), abc.shape)
    check_tensor("vols[0]", vols[0], (torch.float32, torch.bfloat16),
                 vols[0].shape)
    return cross_scale_cost(imgs_u8, vols, max_costs, scale_wgts, abc, **kw)
