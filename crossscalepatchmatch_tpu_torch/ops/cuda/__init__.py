"""Wrappers of the hand-written CUDA kernels (sources in ../../csrc).

Each wrapper sends a CPU tensor to its plain PyTorch version and a CUDA
tensor to its kernel; any other device, or an input the kernel does not
take, raises.  Nothing here imports or builds anything at import time.
"""

from __future__ import annotations

import torch


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
