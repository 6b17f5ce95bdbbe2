"""Kernel WMF: the weighted median of post-processing at the invalid pixels
of both views (csrc/weighted_median.cu).

Replaces the JAX engine's device loop in
crossscalepatchmatch_tpu/models/postprocess.py weighted_median (the
lax.fori_loop over the window offsets, :151, run for the total and inside
the 8-step bisection, :185); it is not a TPU kernel.  Its plain version is
models.postprocess.weighted_median_plain, which models.postprocess.
weighted_median takes for CPU tensors; the kernel's output is u8-equal to
it (see the source's note).

The wrapper lays the inputs out for the kernel with two launches of its
own (prepare_median, the C entry cspm_wmf_prepare): every pixel packed as
one 8-byte word, its colour B | G << 8 | R << 16 beside its key, dis where
valid and 256 where not; the output window of dis copied into the output;
and the invalid output pixels compacted into one list over both views
(view-major, raster order), with their count left on the device, so
nothing waits for the card.  dis, imgs and valid are read through
contiguous copies (none where they are contiguous already); the weight
table is read as it is and must be contiguous.
"""

from __future__ import annotations

import torch

from . import _build
from ..plane_cost import L1_MAX

# Kernel launches (a plain count; the GPU tier resets and reads it).
launches = 0

# Pixels a block of cspm_wmf_prepare's counting covers (csrc/
# weighted_median.cu kChunk); the C entry refuses a counts buffer shorter
# than its own kChunk needs.
_CHUNK = 1024


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
    return weighted_median_prepared(
        prepare_median(dis, imgs, valid, center_row0, oh, center_col0, ow),
        lut, half_wnd=half_wnd)


def prepare_median(dis: torch.Tensor, imgs: torch.Tensor,
                   valid: torch.Tensor, center_row0: int, out_h: int,
                   center_col0: int, out_w: int) -> tuple:
    """The kernel's inputs on the card, two launches (inputs as
    weighted_median_cuda's, already checked): (packed i32[2, Ha, Wa, 2], the
    invalid output pixels i32[2 * out_h * out_w] (the first n), n i32[1],
    out u8[2, out_h, out_w] holding dis's output window, the origin)."""
    _, h, w = dis.shape
    dev = dis.device
    dis, imgs, valid = dis.contiguous(), imgs.contiguous(), valid.contiguous()
    packed = torch.empty((2, h, w, 2), dtype=torch.int32, device=dev)
    counts = torch.empty((-(-2 * h * w // _CHUNK),), dtype=torch.int32,
                         device=dev)
    idx = torch.empty((2 * out_h * out_w,), dtype=torch.int32, device=dev)
    n = torch.empty((1,), dtype=torch.int32, device=dev)
    out = torch.empty((2, out_h, out_w), dtype=torch.uint8, device=dev)
    err = _build.load().cspm_wmf_prepare(
        dis.data_ptr(), imgs.data_ptr(), valid.data_ptr(), packed.data_ptr(),
        counts.data_ptr(), counts.numel(), idx.data_ptr(), n.data_ptr(),
        out.data_ptr(), h, w, out_h, out_w, center_row0, center_col0,
        _build.stream_of(out))
    _build.check(err, "cspm_wmf_prepare")
    return packed, idx, n, out, (center_row0, center_col0)


def weighted_median_prepared(prep: tuple, lut: torch.Tensor, *,
                             half_wnd: int) -> torch.Tensor:
    """One launch of WMF on prepare_median's output: overwrites the
    replaced pixels of its `out` and returns it."""
    global launches
    packed, idx, n, out, (oy, ox) = prep
    _, h, w, _ = packed.shape
    _, oh, ow = out.shape
    err = _build.load().cspm_weighted_median(
        packed.data_ptr(), lut.data_ptr(), idx.data_ptr(), n.data_ptr(),
        out.data_ptr(), h, w, oh, ow, oy, ox, half_wnd, _build.stream_of(out))
    _build.check(err, "cspm_weighted_median")
    launches += 1
    return out
