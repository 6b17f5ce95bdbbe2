"""Kernel K4: the cross-scale window cost of both views, every pyramid level
in one launch (csrc/cross_scale_cost.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel` at
scale > 0 (with its scale-0 term and the weighted level sum of
`cross_scale_plane_cost_prepared`).  Its plain version is
ops.plane_cost.cross_scale_plane_cost.  On the card the volumes may be f32
or bf16 (cfg.vol_dtype); the kernel accumulates in f32 either way.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import plane_cost
from . import _build, check_tensor, pack_bgr

# Kernel launches (a plain count; chip_smoke resets and reads it).
launches = 0

MAX_LEVELS = 8


def cross_scale_cost(imgs_u8: Sequence[torch.Tensor],
                     vols: Sequence[torch.Tensor],
                     max_costs: Sequence[torch.Tensor],
                     scale_wgts: Sequence[float], abc: torch.Tensor, *,
                     half_wnd: int, max_dis: int,
                     gamma: float) -> torch.Tensor:
    """Cross-scale plane cost of K candidate plane fields in both views.

    Args:
      imgs_u8: per level u8[2, Hs, Ws, 3] images, level 0 finest.
      vols: per level f32 or bf16 [2, Hs, Ws, Ds], Ds = (max_dis >> s) + 1.
      max_costs: per level f32[2] per-view saturation values.
      scale_wgts: per level inter-scale weights (ops.scale_weights).
      abc: f32[2, K, H, W, 3] fine-grid candidate planes.

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    if abc.device.type == "cpu":
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in imgs_u8], [vo[v] for vo in vols],
            [mc[v] for mc in max_costs], scale_wgts, abc[v],
            half_wnd=half_wnd, max_dis=max_dis, gamma=gamma)
            for v in range(2)])
    return cross_scale_cost_cuda(imgs_u8, vols, max_costs, scale_wgts, abc,
                                 half_wnd=half_wnd, max_dis=max_dis,
                                 gamma=gamma)


def cross_scale_cost_cuda(imgs_u8: Sequence[torch.Tensor],
                          vols: Sequence[torch.Tensor],
                          max_costs: Sequence[torch.Tensor],
                          scale_wgts: Sequence[float], abc: torch.Tensor, *,
                          half_wnd: int, max_dis: int,
                          gamma: float) -> torch.Tensor:
    """Launch K4 (see cross_scale_cost); raises on anything it does not
    take."""
    global launches
    _, k, h, w, _ = abc.shape
    n = len(vols)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels outside the kernel's [1, {MAX_LEVELS}]")
    if len(imgs_u8) != n or len(max_costs) != n or len(scale_wgts) != n:
        raise ValueError("imgs, vols, max_costs and scale_wgts must have "
                         "one entry per level")
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    if not 0 <= half_wnd <= 64:
        raise ValueError(f"half_wnd {half_wnd} outside the kernel's [0, 64]")
    if not 1 <= 2 * k <= 65535:
        raise ValueError(f"K={k} outside the kernel's grid")
    vol_dtype = vols[0].dtype
    if vol_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vols: dtype {vol_dtype} not f32 or bf16")
    md, shapes = max_dis, []
    for s in range(n):
        # ceil-halved per level, so every fine pixel's center (y >> s,
        # x >> s) lies inside level s
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        check_tensor(f"imgs_u8[{s}]", imgs_u8[s], (torch.uint8,),
                     (2, hs, ws, 3))
        check_tensor(f"vols[{s}]", vols[s], (vol_dtype,), (2, hs, ws, md + 1))
        check_tensor(f"max_costs[{s}]", max_costs[s], (torch.float32,), (2,))
        shapes.append((hs, ws, md + 1, md))
        md //= 2
    lib = _build.load()
    packed = [pack_bgr(im) for im in imgs_u8]
    lut = plane_cost.asw_lut(gamma, abc.device)
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)

    def arr(ctype, xs):
        return (ctype * n)(*xs)

    err = lib.cspm_cross_scale_cost(
        arr(ctypes.c_void_p, [p.data_ptr() for p in packed]),
        arr(ctypes.c_void_p, [v.data_ptr() for v in vols]),
        arr(ctypes.c_void_p, [m.data_ptr() for m in max_costs]),
        arr(ctypes.c_int, [sh[0] for sh in shapes]),
        arr(ctypes.c_int, [sh[1] for sh in shapes]),
        arr(ctypes.c_int, [sh[2] for sh in shapes]),
        arr(ctypes.c_int, [sh[3] for sh in shapes]),
        arr(ctypes.c_float, [float(x) for x in scale_wgts]),
        n, int(vol_dtype == torch.bfloat16), abc.data_ptr(), lut.data_ptr(),
        out.data_ptr(), k, h, w, half_wnd, _build.stream_of(abc))
    _build.check(err, "cspm_cross_scale_cost")
    launches += 1
    return out
