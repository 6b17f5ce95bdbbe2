"""Kernel K2: the ASW quadrant-volume build of both views
(csrc/quadrant_build.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/quadrant_build.py `_kernel`.
Its plain version is ops.prescreen_volume.build_quadrant_volumes.  On the
card the volume may be f32 or bf16 (cfg.vol_dtype); the outputs are f32.
The kernel reads a pair prepared by window_cost.prepare_volumes: the packed
images, the weight table and the pair-layout volume K1 reads too.
"""

from __future__ import annotations

import torch

from .. import prescreen_volume
from . import _build, check_tensor
from .window_cost import PreparedVolumes, prepare_volumes

# Kernel launches (a plain count; chip_smoke resets and reads it).
launches = 0

# Slices the wrapper takes (the kernel runs any depth in chunks of 16; 256
# is the largest tested on the card, and KITTI's 129 fits).
MAX_DEPTH = 256


def quadrant_volumes_prepared(prep: PreparedVolumes, *, half_wnd: int,
                              gamma: float, stride: int):
    """Quadrant volumes of both views on a prepared pair.  The caller
    restates the geometry it assumes (half_wnd, gamma); a mismatch with the
    prepared object, or a stride below 1, raises ValueError.

    Returns:
      (bq f32[2, 4, H, W, D], wq f32[2, 4, H, W]).  A pair prepared from
      CPU tensors takes the plain version, one from CUDA tensors the
      kernel.
    """
    global launches
    if (half_wnd, gamma) != (prep.half_wnd, prep.gamma):
        raise ValueError(
            f"call with half_wnd={half_wnd}, gamma={gamma} on a pair "
            f"prepared for half_wnd={prep.half_wnd}, gamma={prep.gamma}")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    if prep.device.type == "cpu":
        parts = [prescreen_volume.build_quadrant_volumes(
            prep.imgs_u8[v], prep.vols[v], half_wnd=half_wnd, gamma=gamma,
            stride=stride) for v in range(2)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
    h, w = prep.hw
    d = prep.max_dis + 1
    if not d <= MAX_DEPTH:
        raise ValueError(f"depth {d} outside the kernel's [1, {MAX_DEPTH}]")
    lib = _build.load()
    dev = prep.device
    bq = torch.empty((2, 4, h, w, d), dtype=torch.float32, device=dev)
    wq = torch.empty((2, 4, h, w), dtype=torch.float32, device=dev)
    err = lib.cspm_quadrant_build(
        prep.img.data_ptr(), prep.pvols.data_ptr(),
        int(prep.pvols.dtype == torch.bfloat16), prep.lut.data_ptr(),
        bq.data_ptr(), wq.data_ptr(), h, w, d, half_wnd, stride,
        _build.stream_of(bq))
    _build.check(err, "cspm_quadrant_build")
    launches += 1
    return bq, wq


def quadrant_volumes(imgs_u8: torch.Tensor, vols: torch.Tensor, *,
                     half_wnd: int, gamma: float, stride: int):
    """Quadrant volumes of both views on an unprepared pair: prepare_volumes,
    then quadrant_volumes_prepared.

    Args:
      imgs_u8: u8[2, H, W, 3]; vols: f32 or bf16 [2, H, W, D].

    Returns:
      (bq f32[2, 4, H, W, D], wq f32[2, 4, H, W]).  CPU tensors take the
      plain version, CUDA tensors the kernel.
    """
    prep = prepare_volumes(imgs_u8, vols, None, half_wnd=half_wnd,
                           max_dis=vols.shape[-1] - 1, gamma=gamma)
    return quadrant_volumes_prepared(prep, half_wnd=half_wnd, gamma=gamma,
                                     stride=stride)


def quadrant_volumes_cuda(imgs_u8: torch.Tensor, vols: torch.Tensor, **kw):
    """quadrant_volumes for CUDA tensors only: launches K2, raises on
    anything it does not take."""
    check_tensor("vols", vols, (torch.float32, torch.bfloat16), vols.shape)
    return quadrant_volumes(imgs_u8, vols, **kw)
