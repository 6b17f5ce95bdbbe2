"""Kernel BFV: the joint bilateral filter (the BF aggregator, BFCA) of every
inner slice of a level's cost volumes, all views in one launch
(csrc/bilateral_volume.cu).

Replaces the JAX engine's device loop over the window offsets in
crossscalepatchmatch_tpu/ops/filters.py bilateral_filter, which XLA fuses
under run_pair's jit; it is not a TPU kernel.  Its plain version is
ops.filters.bilateral_filter_volume, a host loop over the wnd^2 offsets,
which bilateral_volumes takes for CPU tensors.  On the card the kernel
keeps the plain version's order of work per pixel and slice (see the
source's note), so its volumes equal the plain version's there.
"""

from __future__ import annotations

import torch

from . import MAX_HALF_WND, _build, check_tensor
from .. import filters

# Kernel launches, one a level (a plain count; chip_smoke resets and reads
# it), and the plain version's calls on a level's views.
launches = 0
plain_launches = 0
# the widest window the kernel takes (csrc/bilateral_volume.cu kMaxWnd)
MAX_WND = 2 * MAX_HALF_WND + 1


def bilateral_volumes_plain(vols: torch.Tensor, guides_u8: torch.Tensor,
                            wnd: int) -> torch.Tensor:
    """The plain version of bilateral_volumes, on any device: each view's
    filters.bilateral_filter_volume, stacked."""
    global plain_launches
    plain_launches += 1
    return torch.stack([filters.bilateral_filter_volume(
        vols[v], guides_u8[v], wnd=wnd) for v in range(vols.shape[0])])


def bilateral_volumes_cuda(vols: torch.Tensor, guides_u8: torch.Tensor,
                           wnd: int) -> torch.Tensor:
    """bilateral_volumes on the card: one BFV launch filters every view's
    inner slices and copies slices 0 and D - 1; a volume of at most 2
    slices is returned as it is (as the plain version does).  Raises
    ValueError on anything the kernel does not take (CPU tensors
    included)."""
    global launches
    if vols.dim() != 4:
        raise ValueError(f"vols: shape {tuple(vols.shape)}, expected "
                         f"[V, H, W, D]")
    n, h, w, d = vols.shape
    check_tensor("vols", vols, (torch.float32,), (n, h, w, d))
    check_tensor("guides", guides_u8, (torch.uint8,), (n, h, w, 3))
    if guides_u8.device != vols.device:
        raise ValueError(f"guides on {guides_u8.device}, vols on "
                         f"{vols.device}")
    if not 1 <= wnd <= MAX_WND:
        raise ValueError(f"window {wnd} outside the kernel's [1, "
                         f"{MAX_WND}]")
    if n < 1 or h < 1 or w < 1 or h > 65535:
        raise ValueError(f"{n} views of {h} x {w}: outside the kernel's "
                         f"V >= 1, 1 <= H <= 65535, W >= 1")
    if d <= 2:
        return vols
    inv_sp2, inv_clr2 = filters.bilateral_constants(wnd)
    out = torch.empty_like(vols)
    err = _build.load().cspm_bilateral_volume(
        vols.data_ptr(), guides_u8.data_ptr(), out.data_ptr(), n, h, w, d,
        wnd, float(inv_sp2), float(inv_clr2), _build.stream_of(out))
    _build.check(err, "cspm_bilateral_volume")
    launches += 1
    return out


def bilateral_volumes(vols: torch.Tensor, guides_u8: torch.Tensor,
                      wnd: int) -> torch.Tensor:
    """Each view's filters.bilateral_filter_volume: the wnd x wnd joint
    bilateral filter of slices 1 .. D - 2 with wrap-around borders
    (sig_clr filters.BF_SIG_CLR), guided by the view's image, slices 0 and
    D - 1 passed through.  CPU tensors
    take the plain version (bilateral_volumes_plain), CUDA tensors the
    kernel (bilateral_volumes_cuda).

    Args:
      vols: f32[V, H, W, D] the views' volumes (contiguous on the card).
      guides_u8: u8[V, H, W, 3] the views' images (likewise).
    """
    if vols.device.type == "cpu":
        return bilateral_volumes_plain(vols, guides_u8, wnd)
    return bilateral_volumes_cuda(vols, guides_u8, wnd)
