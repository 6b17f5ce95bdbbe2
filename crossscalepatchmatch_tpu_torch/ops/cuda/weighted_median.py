"""Kernel WMF: the weighted median of post-processing at the invalid pixels
of both views (csrc/weighted_median.cu).

Replaces the JAX engine's device loop in
crossscalepatchmatch_tpu/models/postprocess.py weighted_median (the
lax.fori_loop over the window offsets, :151, run for the total and inside
the 8-step bisection, :185); it is not a TPU kernel.  Its plain version is
models.postprocess.weighted_median_plain, which models.postprocess.
weighted_median takes for CPU tensors; the kernel's output is u8-equal to
it (see the source's note).

The wrapper lays the inputs out for the kernel: the pixels packed as
B | G << 8 | R << 16 (pack_bgr), the key dis where valid and 256 where not,
and the invalid output pixels compacted into one list over both views
(view-major, raster order) by a stable sort, with their count left on the
device, so nothing waits for the card.  dis, imgs and valid are read
through these copies and may have any strides; the weight table is read as
it is and must be contiguous.
"""

from __future__ import annotations

import torch

from . import _build, pack_bgr
from ..plane_cost import L1_MAX

# Kernel launches (a plain count; chip_smoke resets and reads it).
launches = 0

# The key of an invalid pixel: above every threshold t <= 255.
KEY_INVALID = 256


def _check_inputs(dis: torch.Tensor, imgs: torch.Tensor,
                  valid: torch.Tensor, lut: torch.Tensor, half_wnd: int,
                  center_row0: int, out_h: int | None, center_col0: int,
                  out_w: int | None) -> tuple:
    """(Ha, Wa, out_h, out_w), the output's extent defaulting to the
    arrays'; raises ValueError on dtypes, shapes or an output window the
    kernel does not take, on any device (the device is checked after)."""
    for name, t, dtype in (("dis", dis, torch.uint8),
                           ("imgs", imgs, torch.uint8),
                           ("valid", valid, torch.bool),
                           ("lut", lut, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if dis.dim() != 3 or dis.shape[0] != 2:
        raise ValueError(f"dis: shape {tuple(dis.shape)}, expected [2, H, W]")
    _, h, w = dis.shape
    if h * w == 0 or 2 * h * w >= 2 ** 31:
        raise ValueError(f"dis: {h} x {w} pixels a view, outside the "
                         f"kernel's [1, 2^30)")
    if tuple(imgs.shape) != (2, h, w, 3):
        raise ValueError(f"imgs: shape {tuple(imgs.shape)} != {(2, h, w, 3)}")
    if tuple(valid.shape) != (2, h, w):
        raise ValueError(f"valid: shape {tuple(valid.shape)} != {(2, h, w)}")
    if tuple(lut.shape) != (L1_MAX + 1,):
        raise ValueError(f"lut: shape {tuple(lut.shape)} != {(L1_MAX + 1,)}")
    if half_wnd < 0:
        raise ValueError(f"half_wnd {half_wnd} < 0")
    out_h = h if out_h is None else out_h
    out_w = w if out_w is None else out_w
    if not (0 <= center_row0 and 0 < out_h and center_row0 + out_h <= h
            and 0 <= center_col0 and 0 < out_w
            and center_col0 + out_w <= w):
        raise ValueError(f"output window {out_h} x {out_w} at "
                         f"({center_row0}, {center_col0}) outside the "
                         f"{h} x {w} arrays")
    return h, w, out_h, out_w


def weighted_median_cuda(dis: torch.Tensor, imgs: torch.Tensor,
                         valid: torch.Tensor, lut: torch.Tensor, *,
                         half_wnd: int, center_row0: int = 0,
                         out_h: int | None = None, center_col0: int = 0,
                         out_w: int | None = None) -> torch.Tensor:
    """models.postprocess.weighted_median on the card: launches WMF once for
    both views; raises ValueError on anything it does not take (CPU tensors
    included).

    Args:
      dis / imgs / valid: u8[2, Ha, Wa] / u8[2, Ha, Wa, 3] / bool[2, Ha, Wa]
        on one CUDA device (halo-extended on a spatial tile, pixels past the
        global image with valid = 0).
      lut: f32[766], plane_cost.asw_lut(cfg.wmf_gamma) on the same device.
      half_wnd: cfg.wnd_size // 2.
      center_row0 / center_col0, out_h / out_w: as weighted_median's.

    Returns:
      u8[2, out_h, out_w].
    """
    global launches
    h, w, oh, ow = _check_inputs(dis, imgs, valid, lut, half_wnd,
                                 center_row0, out_h, center_col0, out_w)
    dev = dis.device
    if dev.type != "cuda":
        raise ValueError(f"dis: expected a CUDA tensor, got {dev}")
    for name, t in (("imgs", imgs), ("valid", valid), ("lut", lut)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, dis on {dev}")
    if not lut.is_contiguous():
        raise ValueError("lut: must be contiguous")
    pix = pack_bgr(imgs)
    key = dis.to(torch.int16, memory_format=torch.contiguous_format
                 ).masked_fill_(~valid, KEY_INVALID)
    region = (slice(None), slice(center_row0, center_row0 + oh),
              slice(center_col0, center_col0 + ow))
    n = (~valid[region]).sum(dtype=torch.int32).reshape(1)
    # stable: the invalid pixels (key 0) first, each view's in raster order
    idx = torch.argsort(valid[region].reshape(-1).to(torch.uint8),
                        stable=True)
    out = torch.empty((2, oh, ow), dtype=torch.uint8, device=dev)
    out.copy_(dis[region])
    err = _build.load().cspm_weighted_median(
        pix.data_ptr(), key.data_ptr(), lut.data_ptr(), idx.data_ptr(),
        n.data_ptr(), out.data_ptr(), h, w, oh, ow, center_row0,
        center_col0, half_wnd, _build.stream_of(out))
    _build.check(err, "cspm_weighted_median")
    launches += 1
    return out
