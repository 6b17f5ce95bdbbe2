"""Kernel GRDV: the GRD cost volumes of both reference views
(csrc/grd_volume.cu, one launch a pair of views).

Replaces the JAX engine's per-slice loop in
crossscalepatchmatch_tpu/ops/grad_cost.py grd_cost_volume (:62-71), which
XLA fuses under run_pair's jit; it is not a TPU kernel.  Its plain version
is ops.grad_cost.grd_cost_volume, which grd_volumes takes for CPU tensors;
on the card the kernel's volume is bit-equal to it (see the source's
note).  The plain version stays what the plain fly cost
(ops.onthefly_cost) builds its volume with, on every device.

The kernel reads the two u8 RGB views as they are (their strides passed
in) and forms in shared memory what pack_views states with the plain
functions: each pixel's packed RGB and the Sobel-x gradient of its gray
image (ops.color.rgb_to_gray_f32, ops.gradient.sobel_x_k1).  pack_views
is not called on the card's path; the CPU tests hold the kernel's order
against it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda_pair, check_views, pack_bgr
from .. import grad_cost
from ..color import rgb_to_gray_f32
from ..gradient import sobel_x_k1

# Kernel launches (a plain count; the GPU tier resets and reads it).
launches = 0


def pack_views(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor
               ) -> torch.Tensor:
    """i32[2, H, W, 2]: per pixel of the left (0) and right (1) u8[H, W,
    3] RGB view its packed RGB (R | G << 8 | B << 16) and the bits of its
    f32 Sobel-x gradient of the gray image, both made by the plain
    functions: what the kernel's prologue forms in shared memory."""
    imgs = torch.stack([l_rgb_u8, r_rgb_u8])
    grd = sobel_x_k1(rgb_to_gray_f32(imgs))
    return torch.stack([pack_bgr(imgs), grd.view(torch.int32)], -1)


def grd_volumes_plain(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                      max_dis: int, **kw) -> torch.Tensor:
    """The plain version of grd_volumes, on any device: both views'
    grad_cost.grd_cost_volume, stacked."""
    return torch.stack([
        grad_cost.grd_cost_volume(l_rgb_u8, r_rgb_u8, max_dis, right=right,
                                  **kw) for right in (False, True)])


def grd_volumes_cuda(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                     max_dis: int, *, alpha: float, tau_clr: float,
                     tau_grd: float, border_thres: float) -> torch.Tensor:
    """grd_volumes on the card: one GRDV launch writes both views'
    volumes from the u8 views as they are; raises ValueError on anything
    it does not take (CPU tensors included), RuntimeError where the C
    entry refuses the launch (a block's columns past the card's shared
    memory, at depths of ~29,000)."""
    global launches
    check_views(l_rgb_u8, r_rgb_u8, max_dis)
    h, w, _ = l_rgb_u8.shape
    check_cuda_pair(l_rgb_u8, r_rgb_u8)
    out = torch.empty((2, h, w, max_dis + 1), dtype=torch.float32,
                      device=l_rgb_u8.device)
    f = ctypes.c_float
    err = _build.load().cspm_grd_volume(
        l_rgb_u8.data_ptr(), *l_rgb_u8.stride(), r_rgb_u8.data_ptr(),
        *r_rgb_u8.stride(), out.data_ptr(), h, w, max_dis + 1, f(alpha),
        f(1.0 - alpha), f(tau_clr), f(tau_grd), f(border_thres),
        _build.stream_of(out))
    _build.check(err, "cspm_grd_volume")
    launches += 1
    return out


def grd_volumes(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                max_dis: int, alpha: float = 0.1, tau_clr: float = 10.0,
                tau_grd: float = 2.0, border_thres: float = 3.0
                ) -> torch.Tensor:
    """Both views' grad_cost.grd_cost_volume, f32[2, H, W, max_dis+1]: the
    left-referenced volume at 0, the right-referenced one at 1.  CPU
    tensors take the plain version (grd_volumes_plain), CUDA tensors the
    kernel (grd_volumes_cuda).

    Args:
      l_rgb_u8 / r_rgb_u8: u8[H, W, 3] RGB views (any strides).
    """
    kw = dict(alpha=alpha, tau_clr=tau_clr, tau_grd=tau_grd,
              border_thres=border_thres)
    if l_rgb_u8.device.type == "cpu":
        return grd_volumes_plain(l_rgb_u8, r_rgb_u8, max_dis, **kw)
    return grd_volumes_cuda(l_rgb_u8, r_rgb_u8, max_dis, **kw)
