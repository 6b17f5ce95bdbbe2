"""Kernel K2: the ASW quadrant-volume build of both views
(csrc/quadrant_build.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/quadrant_build.py `_kernel`.
Its plain version is ops.prescreen_volume.build_quadrant_volumes.  On the
card the volume may be f32 or bf16 (cfg.vol_dtype); the outputs are f32.
"""

from __future__ import annotations

import torch

from .. import plane_cost, prescreen_volume
from . import _build, check_tensor, pack_bgr

# Kernel launches (a plain count; chip_smoke resets and reads it).
launches = 0

# Slices the kernel takes: eight 32-lane chunks of accumulators.
MAX_DEPTH = 256


def quadrant_volumes(imgs_u8: torch.Tensor, vols: torch.Tensor, *,
                     half_wnd: int, gamma: float, stride: int):
    """Quadrant volumes of both views.

    Args:
      imgs_u8: u8[2, H, W, 3]; vols: f32 or bf16 [2, H, W, D].

    Returns:
      (bq f32[2, 4, H, W, D], wq f32[2, 4, H, W]).  CPU tensors take the
      plain version, CUDA tensors the kernel.
    """
    if vols.device.type == "cpu":
        parts = [prescreen_volume.build_quadrant_volumes(
            imgs_u8[v], vols[v], half_wnd=half_wnd, gamma=gamma,
            stride=stride) for v in range(2)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    return quadrant_volumes_cuda(imgs_u8, vols, half_wnd=half_wnd,
                                 gamma=gamma, stride=stride)


def quadrant_volumes_cuda(imgs_u8: torch.Tensor, vols: torch.Tensor, *,
                          half_wnd: int, gamma: float, stride: int):
    """Launch K2 (see quadrant_volumes); raises on anything it does not
    take."""
    global launches
    _, h, w, d = vols.shape
    check_tensor("vols", vols, (torch.float32, torch.bfloat16), (2, h, w, d))
    check_tensor("imgs_u8", imgs_u8, (torch.uint8,), (2, h, w, 3))
    if not 1 <= d <= MAX_DEPTH:
        raise ValueError(f"depth {d} outside the kernel's [1, {MAX_DEPTH}]")
    if half_wnd < 0 or stride < 1:
        raise ValueError(f"half_wnd {half_wnd} / stride {stride} invalid")
    lib = _build.load()
    img = pack_bgr(imgs_u8)
    lut = plane_cost.asw_lut(gamma, vols.device)
    bq = torch.empty((2, 4, h, w, d), dtype=torch.float32, device=vols.device)
    wq = torch.empty((2, 4, h, w), dtype=torch.float32, device=vols.device)
    err = lib.cspm_quadrant_build(
        img.data_ptr(), vols.data_ptr(), int(vols.dtype == torch.bfloat16),
        lut.data_ptr(), bq.data_ptr(), wq.data_ptr(), h, w, d, half_wnd,
        stride, _build.stream_of(vols))
    _build.check(err, "cspm_quadrant_build")
    launches += 1
    return bq, wq
