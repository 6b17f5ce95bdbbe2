"""Wrappers of the hand-written CUDA kernels (sources in ../../csrc).

Each wrapper sends a CPU tensor to its plain PyTorch version and a CUDA
tensor to its kernel; any other device, or an input the kernel does not
take, raises.  Nothing here imports or builds anything at import time.
"""

from __future__ import annotations

import torch

# The widest window the kernels take (csrc/*.cu): half_wnd <= 64.
MAX_HALF_WND = 64
# The widest census window kernel CENV takes (csrc/census_volume.cu): 7
# words of code.
MAX_CENSUS_WND = 15
def pack_bgr(imgs_u8: torch.Tensor) -> torch.Tensor:
    """u8[..., 3] -> i32[...]: one pixel per 32-bit word (byte 3 zero), the
    layout the kernels' __vsadu4 L1 distance reads."""
    p = imgs_u8.to(torch.int32)
    return (p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)).contiguous()


def pair_volume(vol: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., D, 2], the kernels' pair layout: element f holds
    (vol[f], vol[min(f + 1, D - 1)]), the two lerp taps of a sample at
    f = trunc(dq), so a kernel fetches both with one aligned load.  Twice
    the volume's memory, written in place of a stacked copy (no temporary).
    (f + 1 <= D - 1 for every in-range sample; the last element's second
    half is never read as a tap.)"""
    out = torch.empty((*vol.shape, 2), dtype=vol.dtype, device=vol.device)
    out[..., 0] = vol
    out[..., :-1, 1] = vol[..., 1:]
    out[..., -1, 1] = vol[..., -1]
    return out


def check_half_wnd(half_wnd: int, device: torch.device) -> None:
    """Raise ValueError for a negative half window, or on the card for one
    past the kernels' MAX_HALF_WND (the plain versions take any)."""
    if half_wnd < 0:
        raise ValueError(f"half_wnd {half_wnd} < 0")
    if device.type != "cpu" and half_wnd > MAX_HALF_WND:
        raise ValueError(f"half_wnd {half_wnd} outside the kernels' "
                         f"[0, {MAX_HALF_WND}]")


def check_tensor(name: str, t: torch.Tensor, dtypes, shape) -> None:
    """Raise ValueError unless t is a contiguous CUDA tensor of one of
    dtypes and the given shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_views(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                max_dis: int) -> None:
    """Raise ValueError on RGB views or a depth the volume kernels (GRDV,
    CENV) do not take, on any device: u8[H, W, 3] views of one shape (any
    strides), max_dis >= 0, 1 <= H <= 65535, W * (max_dis + 1) <= 2^30."""
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


def check_cuda_pair(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor) -> None:
    """Raise ValueError unless both views lie on one CUDA device."""
    if l_rgb_u8.device.type != "cuda":
        raise ValueError(f"l_rgb: expected a CUDA tensor, got "
                         f"{l_rgb_u8.device}")
    if r_rgb_u8.device != l_rgb_u8.device:
        raise ValueError(f"r_rgb on {r_rgb_u8.device}, l_rgb on "
                         f"{l_rgb_u8.device}")
