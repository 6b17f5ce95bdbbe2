"""Kernel CENV: the census-Hamming cost volumes of both reference views at
one level (csrc/census_volume.cu: one C call a level, two launches, the
census codes and then the volumes).

Replaces the JAX engine's census_transform and per-slice loop in
crossscalepatchmatch_tpu/ops/census.py (:24-85), which XLA fuses under
run_pair's jit; it is not a TPU kernel.  Its plain version is
census_volumes_plain (ops.color.rgb_to_gray_u8, then
ops.census.census_cost_volume per view), which census_volumes takes for
CPU tensors; on the card the kernel's volumes equal it element for element
(integers throughout).  The kernel reads the two u8 RGB views as they are
(their strides passed in) and forms the fixed-point gray image and the
codes itself.
"""

from __future__ import annotations

import torch

from . import MAX_CENSUS_WND, _build, check_cuda_pair, check_views
from ..census import census_cost_volume
from ..color import rgb_to_gray_u8

# Kernel calls, one a level (a plain count; the GPU tier resets and reads
# it).
launches = 0


def code_quads(wnd: int) -> int:
    """16-byte quads a census code of wnd^2 - 1 bits takes in the kernel's
    layout (its u32 words padded to whole quads)."""
    return (wnd * wnd - 1 + 127) // 128


def census_volumes_plain(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                         max_dis: int, wnd: int = 9) -> torch.Tensor:
    """The plain version of census_volumes, on any device: the u8 gray
    images, then both views' census.census_cost_volume, stacked."""
    lg, rg = rgb_to_gray_u8(l_rgb_u8), rgb_to_gray_u8(r_rgb_u8)
    return torch.stack([census_cost_volume(lg, rg, max_dis, wnd=wnd,
                                           right=right)
                        for right in (False, True)])


def _check_wnd(wnd: int) -> None:
    if wnd < 1 or wnd % 2 != 1 or wnd > MAX_CENSUS_WND:
        raise ValueError(f"census window {wnd}: the kernel takes an odd "
                         f"window in [1, {MAX_CENSUS_WND}]")


def census_volumes_cuda(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                        max_dis: int, wnd: int = 9) -> torch.Tensor:
    """census_volumes on the card: one CENV call (two launches) writes
    both views' volumes; raises ValueError on anything it does not take
    (CPU tensors included), RuntimeError where the C entry refuses the
    launch (a block's codes past the card's shared memory: at window 15,
    widths and depths past ~7,000)."""
    global launches
    check_views(l_rgb_u8, r_rgb_u8, max_dis)
    h, w, _ = l_rgb_u8.shape
    _check_wnd(wnd)
    check_cuda_pair(l_rgb_u8, r_rgb_u8)
    dev = l_rgb_u8.device
    out = torch.empty((2, h, w, max_dis + 1), dtype=torch.float32,
                      device=dev)
    # the codes, each padded to whole quads (the kernel's scratch)
    codes = torch.empty((2, h, w, 4 * code_quads(wnd)), dtype=torch.int32,
                        device=dev)
    err = _build.load().cspm_census_volume(
        l_rgb_u8.data_ptr(), *l_rgb_u8.stride(), r_rgb_u8.data_ptr(),
        *r_rgb_u8.stride(), codes.data_ptr(), out.data_ptr(), h, w,
        max_dis + 1, wnd, _build.stream_of(out))
    _build.check(err, "cspm_census_volume")
    launches += 1
    return out


def census_volumes(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                   max_dis: int, wnd: int = 9) -> torch.Tensor:
    """Both views' census-Hamming volumes, f32[2, H, W, max_dis+1]: the
    left-referenced volume at 0, the right-referenced one at 1.  CPU
    tensors take the plain version (census_volumes_plain), CUDA tensors the
    kernel (census_volumes_cuda).

    Args:
      l_rgb_u8 / r_rgb_u8: u8[H, W, 3] RGB views (any strides).
      wnd: the odd census window (census_wnd).
    """
    if l_rgb_u8.device.type == "cpu":
        return census_volumes_plain(l_rgb_u8, r_rgb_u8, max_dis, wnd)
    return census_volumes_cuda(l_rgb_u8, r_rgb_u8, max_dis, wnd)
