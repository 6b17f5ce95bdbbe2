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

from typing import NamedTuple

import torch

from . import MAX_HALF_WND, _build, check_tensor
from .. import filters

# Kernel launches, one a level (a plain count; the GPU tier resets and
# reads it), and the plain version's calls on a level's views.
launches = 0
plain_launches = 0
# the widest window the kernel takes (csrc/bilateral_volume.cu kMaxWnd)
MAX_WND = 2 * MAX_HALF_WND + 1
# the kernel's tiling (csrc/bilateral_volume.cu): a warp's pixels along a
# row and its rows, the window rows a block's ring holds, the shared memory
# a block may hold on the H100, and the blocks a launch should give the
# H100's 132 SMs (two each, so one block's barrier overlaps another's work)
PIX, ROWS = 8, 2
STAGES = 2
MAX_SMEM = 232_448
MIN_BLOCKS = 2 * 132
# a block's warps along a row and down the rows: 4 x 2, or 2 x 2 on a
# level too small for MIN_BLOCKS blocks of 4 x 2 or at a window too wide
# for their shared memory (2 x 2 fits at every window up to MAX_WND)
BLOCKS = ((4, 2), (2, 2))


class Plan(NamedTuple):
    """How one BFV launch tiles a level (launch_plan)."""
    dc: int         # consecutive slices a lane holds: 1, 2 or 4
    per_chunk: int  # inner slices a block filters, at most 32 dc - 1
    chunks: int     # blocks that split a pixel's inner slices
    wx: int         # a block's warps along a row (PIX pixels each)
    wy: int         # ... and down the rows (ROWS rows each)
    smem: int       # bytes of shared memory a block holds
    blocks: int     # blocks of the launch, for V views


def smem_bytes(dc: int, wx: int, wy: int, wnd: int) -> int:
    """A block's shared memory (csrc/bilateral_volume.cu smem_bytes): the
    ring of STAGES window rows of its PIX wx + wnd - 1 columns at 32 dc
    floats a column, the same rows of the guide as float4, each warp's
    weight table (PIX + wnd - 1 columns of PIX ROWS floats) and the
    wrapped column indices."""
    nb = PIX * wx + wnd - 1
    return 4 * (STAGES * nb * 32 * dc + STAGES * nb * 4
                + wx * wy * (PIX + wnd - 1) * PIX * ROWS) + 4 * nb


def launch_plan(v: int, h: int, w: int, d: int, wnd: int) -> Plan:
    """The kernel's tiling of V views of an H x W x D level at window wnd,
    from the shape alone: the fewest slices a lane that holds the inner
    slices and sw's slot (past 127 of them, chunks of at most 32 dc - 1
    slices, as even as they split), then the first block of BLOCKS that
    fits MAX_SMEM and gives the launch MIN_BLOCKS blocks, else the last."""
    inner = d - 2
    dc = 1 if inner < 32 else 2 if inner < 64 else 4
    chunks = -(-inner // (32 * dc - 1))
    per_chunk = -(-inner // chunks)
    chunks = -(-inner // per_chunk)
    for wx, wy in BLOCKS:
        smem = smem_bytes(dc, wx, wy, wnd)
        blocks = v * chunks * -(-w // (PIX * wx)) * -(-h // (ROWS * wy))
        if smem <= MAX_SMEM and blocks >= MIN_BLOCKS or \
                (wx, wy) == BLOCKS[-1]:
            return Plan(dc, per_chunk, chunks, wx, wy, smem, blocks)


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
    plan = launch_plan(n, h, w, d, wnd)
    out = torch.empty_like(vols)
    err = _build.load().cspm_bilateral_volume(
        vols.data_ptr(), guides_u8.data_ptr(), out.data_ptr(), n, h, w, d,
        wnd, float(inv_sp2), float(inv_clr2), *plan[:5],
        _build.stream_of(out))
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
