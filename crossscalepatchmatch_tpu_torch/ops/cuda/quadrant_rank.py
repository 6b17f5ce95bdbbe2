"""Kernel QRANK: the quadrant ranking of both views' candidate planes
(csrc/quadrant_rank.cu).

Replaces the JAX engine's tent contractions in
crossscalepatchmatch_tpu/ops/prescreen_volume.py quadrant_prescreen_cost
(:114-153), which XLA fuses under run_pair's jit; it is not a TPU kernel.
Its plain version is ops.prescreen_volume.quadrant_prescreen_cost, one
view a call, which quadrant_rank takes for CPU tensors; on the card the
kernel's costs are bit-equal to it (see the source's note).  The kernel
reads kernel K2's outputs (ops.cuda.quadrant_build) as K2 writes them,
whole image or band form.
"""

from __future__ import annotations

import torch

from . import _build
from .. import prescreen_volume

# Kernel launches (a plain count; the GPU tier resets and reads it).
launches = 0


def _check_inputs(bq, wq, max_costs, abc, half_wnd, max_dis) -> tuple:
    """(K, H, W, D); raises ValueError on dtypes, shapes, strides or a
    range bound the kernel does not take, on any device (the device is
    checked after)."""
    for name, t in (("bq", bq), ("wq", wq), ("max_costs", max_costs),
                    ("abc", abc)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected "
                             f"torch.float32")
    if abc.dim() != 5 or abc.shape[0] != 2 or abc.shape[-1] != 3:
        raise ValueError(f"abc: shape {tuple(abc.shape)}, expected "
                         f"[2, K, H, W, 3]")
    _, k, h, w, _ = abc.shape
    d = bq.shape[-1] if bq.dim() else 0
    # K2's layout: the quadrant before the pixel, depth minor
    for name, t, shape in (("bq", bq, (2, 4, h, w, d)),
                           ("wq", wq, (2, 4, h, w)),
                           ("max_costs", max_costs, (2,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if not abc.is_contiguous():
        raise ValueError("abc: must be contiguous")
    if k * h * w == 0 or k * h * w >= 2 ** 37:
        raise ValueError(f"abc: {k} x {h} x {w} candidates a view, outside "
                         f"the kernel's [1, 2^37)")
    if not 1 <= max_dis <= d - 1:
        raise ValueError(f"max_dis {max_dis} outside [1, D - 1 = {d - 1}]")
    if half_wnd < 0:
        raise ValueError(f"half_wnd {half_wnd} < 0")
    return k, h, w, d


def quadrant_rank_cuda(bq: torch.Tensor, wq: torch.Tensor,
                       max_costs: torch.Tensor, abc: torch.Tensor, *,
                       half_wnd: int, max_dis: int) -> torch.Tensor:
    """quadrant_rank on the card: launches QRANK once for both views;
    raises ValueError on anything it does not take (CPU tensors
    included)."""
    global launches
    k, h, w, d = _check_inputs(bq, wq, max_costs, abc, half_wnd, max_dis)
    dev = abc.device
    if dev.type != "cuda":
        raise ValueError(f"abc: expected a CUDA tensor, got {dev}")
    for name, t in (("bq", bq), ("wq", wq), ("max_costs", max_costs)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, abc on {dev}")
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=dev)
    err = _build.load().cspm_quadrant_rank(
        bq.data_ptr(), wq.data_ptr(), max_costs.data_ptr(), abc.data_ptr(),
        out.data_ptr(), k, h, w, d, max_dis, half_wnd, _build.stream_of(out))
    _build.check(err, "cspm_quadrant_rank")
    launches += 1
    return out


def quadrant_rank(bq: torch.Tensor, wq: torch.Tensor,
                  max_costs: torch.Tensor, abc: torch.Tensor, *,
                  half_wnd: int, max_dis: int) -> torch.Tensor:
    """Ranking costs of K candidate plane fields of both views,
    f32[2, K, H, W]: CPU tensors take the plain version per view
    (stacked), CUDA tensors the kernel (quadrant_rank_cuda, one launch).

    Args:
      bq / wq: f32[2, 4, H, W, D] / f32[2, 4, H, W], K2's outputs.
      max_costs: f32[2] per-view saturation values.
      abc: f32[2, K, H, W, 3] candidate planes.
      max_dis: the range test's bound, <= D - 1.
    """
    if abc.device.type == "cpu":
        return torch.stack([prescreen_volume.quadrant_prescreen_cost(
            bq[v], wq[v], max_costs[v], abc[v], half_wnd=half_wnd,
            max_dis=max_dis) for v in range(2)])
    return quadrant_rank_cuda(bq, wq, max_costs, abc, half_wnd=half_wnd,
                              max_dis=max_dis)
