"""Kernel GRDV: the GRD cost volumes of both reference views
(csrc/grd_volume.cu, one launch a view).

Replaces the JAX engine's per-slice loop in
crossscalepatchmatch_tpu/ops/grad_cost.py grd_cost_volume (:62-71), which
XLA fuses under run_pair's jit; it is not a TPU kernel.  Its plain version
is ops.grad_cost.grd_cost_volume, which grd_volumes takes for CPU tensors;
on the card the kernel's volume is bit-equal to it (see the source's
note).  The plain version stays what the plain fly cost
(ops.onthefly_cost) builds its volume with, on every device.

The wrapper makes the kernel's input with the plain functions: the gray
image and Sobel-x gradient of both views (ops.color.rgb_to_gray_f32,
ops.gradient.sobel_x_k1), packed beside the RGB pixels as one 8-byte word
a pixel (pack_views), once a pair; each launch then writes every (y, x,
d) of one view's volume.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pack_bgr
from .. import grad_cost
from ..color import rgb_to_gray_f32
from ..gradient import sobel_x_k1

# Kernel launches (a plain count; chip_smoke resets and reads it).
launches = 0


def _check_views(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                 max_dis: int) -> None:
    """Raise ValueError on views or a depth the kernel does not take, on
    any device (the device is checked after)."""
    for name, t in (("l_rgb", l_rgb_u8), ("r_rgb", r_rgb_u8)):
        if t.dtype != torch.uint8:
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             f"torch.uint8")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"[H, W, 3]")
    if l_rgb_u8.shape != r_rgb_u8.shape:
        raise ValueError(f"views of shapes {tuple(l_rgb_u8.shape)} and "
                         f"{tuple(r_rgb_u8.shape)}")
    h, w, _ = l_rgb_u8.shape
    if max_dis < 0 or h * w == 0 or h > 65535 or w * (max_dis + 1) > 2 ** 30:
        raise ValueError(f"{h} x {w} pixels at max_dis {max_dis}: outside "
                         f"the kernel's max_dis >= 0, 1 <= H <= 65535, "
                         f"W * (max_dis + 1) <= 2^30")


def pack_views(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor
               ) -> torch.Tensor:
    """i32[2, H, W, 2], the kernel's input: per pixel of the left (0) and
    right (1) u8[H, W, 3] RGB view its packed RGB (R | G << 8 | B << 16)
    and the bits of its f32 Sobel-x gradient of the gray image, both made
    by the plain functions."""
    imgs = torch.stack([l_rgb_u8, r_rgb_u8])
    grd = sobel_x_k1(rgb_to_gray_f32(imgs))
    return torch.stack([pack_bgr(imgs), grd.view(torch.int32)], -1)


def grd_volume_packed(pix: torch.Tensor, max_dis: int, *, alpha: float,
                      tau_clr: float, tau_grd: float, border_thres: float,
                      right: bool, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """One launch of GRDV on views packed by pack_views (a contiguous i32[2,
    H, W, 2] CUDA tensor, not checked further): f32[H, W, max_dis+1] of the
    left (right=False) or right reference view, written into `out` (a
    contiguous f32 tensor of that shape on pix's device) when given."""
    global launches
    _, h, w, _ = pix.shape
    if out is None:
        out = torch.empty((h, w, max_dis + 1), dtype=torch.float32,
                          device=pix.device)
    f = ctypes.c_float
    err = _build.load().cspm_grd_volume(
        pix.data_ptr(), out.data_ptr(), h, w, max_dis + 1, int(right),
        f(alpha), f(1.0 - alpha), f(tau_clr), f(tau_grd), f(border_thres),
        _build.stream_of(out))
    _build.check(err, "cspm_grd_volume")
    launches += 1
    return out


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
    """grd_volumes on the card: pack_views once, then one GRDV launch a
    view; raises ValueError on anything it does not take (CPU tensors
    included)."""
    _check_views(l_rgb_u8, r_rgb_u8, max_dis)
    if l_rgb_u8.device.type != "cuda":
        raise ValueError(f"l_rgb: expected a CUDA tensor, got "
                         f"{l_rgb_u8.device}")
    if r_rgb_u8.device != l_rgb_u8.device:
        raise ValueError(f"r_rgb on {r_rgb_u8.device}, l_rgb on "
                         f"{l_rgb_u8.device}")
    pix = pack_views(l_rgb_u8, r_rgb_u8)
    h, w, _ = l_rgb_u8.shape
    out = torch.empty((2, h, w, max_dis + 1), dtype=torch.float32,
                      device=pix.device)
    for v in range(2):
        grd_volume_packed(pix, max_dis, alpha=alpha, tau_clr=tau_clr,
                          tau_grd=tau_grd, border_thres=border_thres,
                          right=bool(v), out=out[v])
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
