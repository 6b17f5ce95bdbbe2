"""Census transform and census-Hamming cost volume
(port of crossscalepatchmatch_tpu.ops.census).

Reference semantics (cc/cen_cc.cc):
  * wnd x wnd window (9x9), center excluded -> 80 comparison bits;
  * window coordinates wrap around the image borders (cen_cc.cc:30-43);
  * bit b is set iff center > neighbour, bits in row-major window order
    skipping (0, 0);
  * cost[d](x) = popcount(l(x) XOR r(x-d)), and the maximum cost (80)
    where x-d leaves the image (cen_cc.cc:56-64); the right-referenced
    volume mirrors this with x+d (cen_cc.cc:120-133).

The bits are packed eight to a byte (bit b in byte b // 8 at position
b % 8): uint8 bitwise ops run on every device, and the Hamming distance is a
byte popcount.  The volume is built for all disparities at once from one
gather of the other view's codes.

census_cost_volume is the plain version of kernel CENV
(ops.cuda.census_volume, which ops.cost_volume.build_volumes takes for
CUDA tensors).
"""

from __future__ import annotations

import torch

# Calls of the plain census volume (a plain count; the GPU tier reads it to
# show the card's main paths never came through here).
launches = 0


def census_transform(gray_u8: torch.Tensor, wnd: int = 9) -> torch.Tensor:
    """Packed census codes.

    Args:
      gray_u8: u8[H, W] grayscale image.
      wnd: odd census window size.

    Returns:
      u8[H, W, ceil((wnd*wnd-1)/8)] comparison bits, eight per byte.
    """
    half = wnd // 2
    bits = wnd * wnd - 1
    h, w = gray_u8.shape
    dev = gray_u8.device
    offs = torch.arange(-half, half + 1, device=dev)
    rows = (torch.arange(h, device=dev)[None, :] + offs[:, None]) % h
    cols = (torch.arange(w, device=dev)[None, :] + offs[:, None]) % w
    g = gray_u8.to(torch.int32)
    # nb[i, j, y, x] = g[(y + i - half) % h, (x + j - half) % w]
    nb = g[rows[:, None, :, None], cols[None, :, None, :]]
    nb = nb.reshape(wnd * wnd, h, w)
    center = (wnd * wnd) // 2
    nb = torch.cat([nb[:center], nb[center + 1:]])            # [bits, H, W]
    bit = (g[None] > nb).to(torch.uint8)
    n_bytes = (bits + 7) // 8
    bit = torch.cat([bit, bit.new_zeros((n_bytes * 8 - bits, h, w))])
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32)).to(
        torch.uint8)
    packed = (bit.reshape(n_bytes, 8, h, w)
              * weights[None, :, None, None]).sum(1, dtype=torch.uint8)
    return packed.permute(1, 2, 0).contiguous()


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each byte of a uint8 tensor (SWAR, in uint8)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def census_cost_volume(l_gray_u8: torch.Tensor, r_gray_u8: torch.Tensor,
                       max_dis: int, wnd: int = 9,
                       right: bool = False) -> torch.Tensor:
    """Census-Hamming cost volume with d in [0, max_dis] inclusive.

    Args:
      l_gray_u8 / r_gray_u8: u8[H, W] grayscale views.
      right: build the right-referenced volume (match at x+d in the left
        view) instead of the left-referenced one (match at x-d).

    Returns:
      f32[H, W, max_dis+1].
    """
    global launches
    launches += 1
    bits = wnd * wnd - 1
    l_code = census_transform(l_gray_u8, wnd)
    r_code = census_transform(r_gray_u8, wnd)
    _, w = l_gray_u8.shape
    dev = l_gray_u8.device
    x = torch.arange(w, device=dev)[:, None]
    d = torch.arange(max_dis + 1, device=dev)[None, :]
    if right:
        ref, other, src = r_code, l_code, x + d
        in_range = src < w
    else:
        ref, other, src = l_code, r_code, x - d
        in_range = src >= 0
    shifted = other[:, src % w]                          # [H, W, D, bytes]
    cost = popcount_u8(ref[:, :, None] ^ shifted).sum(-1, dtype=torch.int32)
    cost = torch.where(in_range[None], cost, bits)
    return cost.to(torch.float32)
