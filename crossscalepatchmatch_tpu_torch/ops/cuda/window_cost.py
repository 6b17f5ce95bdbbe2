"""Kernel K1: the slanted-plane window cost of both views
(csrc/window_cost.cu), and at wnd_stride > 1 kernel K3's volume form, the
strided-window prescreen.

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel`
(volume form, scale 0).  Its plain version is
ops.plane_cost.window_plane_cost.  On the card the volume may be f32 or
bf16 (cfg.vol_dtype); the kernel accumulates in f32 either way.
"""

from __future__ import annotations

import torch

from .. import plane_cost
from . import _build, check_tensor, pack_bgr

# Kernel launches (plain counts; chip_smoke resets and reads them): all,
# and those at wnd_stride > 1 (K3).
launches = 0
strided_launches = 0


def window_cost(imgs_u8: torch.Tensor, vols: torch.Tensor,
                max_costs: torch.Tensor, abc: torch.Tensor, *,
                half_wnd: int, max_dis: int, gamma: float,
                wnd_stride: int = 1) -> torch.Tensor:
    """Window plane cost of K candidate plane fields in both views.

    Args:
      imgs_u8: u8[2, H, W, 3] reference-view images.
      vols: f32 or bf16 [2, H, W, D], D = max_dis + 1.
      max_costs: f32[2] per-view saturation values.
      abc: f32[2, K, H, W, 3] candidate planes.
      wnd_stride: every wnd_stride-th window offset per axis from
        -half_wnd (the strided prescreen); 1 for the exact cost.

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    if abc.device.type == "cpu":
        return torch.stack([plane_cost.window_plane_cost(
            imgs_u8[v], vols[v], max_costs[v], abc[v], half_wnd=half_wnd,
            max_dis=max_dis, gamma=gamma, wnd_stride=wnd_stride)
            for v in range(2)])
    return window_cost_cuda(imgs_u8, vols, max_costs, abc,
                            half_wnd=half_wnd, max_dis=max_dis, gamma=gamma,
                            wnd_stride=wnd_stride)


def window_cost_cuda(imgs_u8: torch.Tensor, vols: torch.Tensor,
                     max_costs: torch.Tensor, abc: torch.Tensor, *,
                     half_wnd: int, max_dis: int, gamma: float,
                     wnd_stride: int = 1) -> torch.Tensor:
    """Launch K1, or K3 at wnd_stride > 1 (see window_cost); raises on
    anything it does not take."""
    global launches, strided_launches
    _, k, h, w, _ = abc.shape
    d = max_dis + 1
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    check_tensor("imgs_u8", imgs_u8, (torch.uint8,), (2, h, w, 3))
    check_tensor("vols", vols, (torch.float32, torch.bfloat16), (2, h, w, d))
    check_tensor("max_costs", max_costs, (torch.float32,), (2,))
    if not 0 <= half_wnd <= 64:
        raise ValueError(f"half_wnd {half_wnd} outside the kernel's [0, 64]")
    if wnd_stride < 1:
        raise ValueError(f"wnd_stride {wnd_stride} < 1")
    if not 1 <= 2 * k <= 65535:
        raise ValueError(f"K={k} outside the kernel's grid")
    lib = _build.load()
    img = pack_bgr(imgs_u8)
    lut = plane_cost.asw_lut(gamma, abc.device)
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    err = lib.cspm_window_cost(
        img.data_ptr(), vols.data_ptr(), int(vols.dtype == torch.bfloat16),
        max_costs.data_ptr(), abc.data_ptr(), lut.data_ptr(),
        out.data_ptr(), k, h, w, d, half_wnd, max_dis, wnd_stride,
        _build.stream_of(abc))
    _build.check(err, "cspm_window_cost")
    launches += 1
    strided_launches += wnd_stride > 1
    return out
