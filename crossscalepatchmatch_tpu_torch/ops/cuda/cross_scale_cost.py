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
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import plane_cost
from . import _build, check_tensor, pack_bgr, pair_volume

# Kernel launches (a plain count; chip_smoke resets and reads it).
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


def level_args(packed: Sequence[torch.Tensor], kvols: Sequence[torch.Tensor],
               max_costs: Sequence[torch.Tensor],
               shapes: Sequence[Tuple[int, int, int, int]],
               scale_wgts: Sequence[float]) -> tuple:
    """The arguments of cspm_cross_scale_cost before the planes: per-level
    host arrays of the packed images', kernel-layout volumes' and
    saturation values' pointers, the levels' (Hs, Ws, Ds, max_dis) and
    weights, then the level count and the bf16 flag.  The caller keeps the
    tensors alive."""
    n = len(shapes)

    def arr(ctype, xs):
        return (ctype * n)(*xs)

    return (arr(ctypes.c_void_p, [t.data_ptr() for t in packed]),
            arr(ctypes.c_void_p, [t.data_ptr() for t in kvols]),
            arr(ctypes.c_void_p, [t.data_ptr() for t in max_costs]),
            *(arr(ctypes.c_int, [sh[i] for sh in shapes]) for i in range(4)),
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
    hw: Tuple[int, int]            # fine-level (H, W)
    device: torch.device
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
                        max_dis: int, gamma: float) -> PreparedCrossScale:
    """Everything of the cross-scale cost that does not depend on the
    candidates.

    Args:
      imgs_u8: per level u8[2, Hs, Ws, 3] images, level 0 finest.
      vols: per level f32 or bf16 [2, Hs, Ws, Ds], Ds = (max_dis >> s) + 1.
      max_costs: per level f32[2] per-view saturation values.
      scale_wgts: per level inter-scale weights (ops.scale_weights).

    On the card the volumes are copied into the kernel's pair layout
    (pair_volume: twice their memory) and the caller's are not held; the
    plain version reads them as they are.  Raises ValueError on inputs the
    kernel does not take.
    """
    n = len(vols)
    dev = vols[0].device
    h, w = vols[0].shape[1:3]
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels outside the kernel's [1, {MAX_LEVELS}]")
    if len(imgs_u8) != n or len(max_costs) != n or len(scale_wgts) != n:
        raise ValueError("imgs, vols, max_costs and scale_wgts must have "
                         "one entry per level")
    if not 0 <= half_wnd <= 64:
        raise ValueError(f"half_wnd {half_wnd} outside the kernel's [0, 64]")
    if not 0 <= max_dis < MAX_DIS_LIMIT:
        raise ValueError(f"max_dis {max_dis} outside [0, {MAX_DIS_LIMIT})")
    prep = PreparedCrossScale(
        imgs_u8=imgs_u8, vols=vols, max_costs=max_costs,
        scale_wgts=tuple(float(x) for x in scale_wgts), half_wnd=half_wnd,
        max_dis=max_dis, gamma=gamma, hw=(h, w), device=dev)
    vol_dtype = vols[0].dtype
    if vol_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vols: dtype {vol_dtype} not f32 or bf16")
    md, shapes = max_dis, []
    for s in range(n):
        # ceil-halved per level, so every fine pixel's center (y >> s,
        # x >> s) lies inside level s
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
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
    prep.args = level_args(packed, kvols, max_costs, shapes, prep.scale_wgts)
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
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in prep.imgs_u8], [vo[v] for vo in prep.vols],
            [mc[v] for mc in prep.max_costs], prep.scale_wgts, abc[v],
            half_wnd=half_wnd, max_dis=max_dis, gamma=prep.gamma)
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
