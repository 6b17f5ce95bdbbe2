"""Pre-aggregated ASW quadrant volumes for cheap candidate prescreening
(port of crossscalepatchmatch_tpu.ops.prescreen_volume).

Once per pair the ASW-weighted window aggregation of the cost volume is
split into the 2x2 window quadrants:

    B_Q[c, d] = sum_{q in quadrant Q of c's window} w(c, q) * vol[q, d]
    W_Q[c]    = sum_{q in Q} w(c, q)

Ranking a candidate plane then costs four volume lerps per pixel.
build_quadrant_volumes is the plain PyTorch version of kernel K2
(ops.cuda.quadrant_build), quadrant_prescreen_cost that of kernel QRANK
(ops.cuda.quadrant_rank, which ranks both views in one launch).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .plane import pixel_grid
from .plane_cost import asw_weight, take_depth

# Calls of the plain build and of the plain ranking (see
# plane_cost.launches).
launches = 0
rank_launches = 0


def quadrant_anchors(half_wnd: int) -> Tuple[Tuple[float, float], ...]:
    """(dy, dx) anchor offsets of the 2x2 window quadrants: the centroid
    of each quadrant's offset range (Q00 spans dy, dx in [-half_wnd, 0);
    the dy == 0 / dx == 0 lines belong to the + side)."""
    lo = -(half_wnd + 1) / 2.0
    hi = half_wnd / 2.0
    return ((lo, lo), (lo, hi), (hi, lo), (hi, hi))


def quadrant_offsets(half_wnd: int, stride: int):
    """(neg, pos) window offsets per axis: range(-hw, 0, s) and
    range(0, hw + 1, s).  At hw=17, s=2: 9 + 9 offsets; +17 is not
    sampled."""
    return (list(range(-half_wnd, 0, stride)),
            list(range(0, half_wnd + 1, stride)))


def build_quadrant_volumes(img_u8: torch.Tensor, vol: torch.Tensor,
                           valid: torch.Tensor | None = None, *,
                           half_wnd: int, gamma: float, stride: int = 2):
    """ASW-weighted quadrant aggregation of one view's cost volume.

    Args:
      img_u8: u8[H, W, 3] reference view (or a spatial tile's
        halo-extended block).
      vol: f32[H, W, D].
      valid: optional bool[H, W], the pixels inside the global image: a
        tile passes its block's clip, so a neighbour's halo pixels count
        and pixels past the global border do not.  Defaults to the array.

    Returns:
      (bq: f32[4, H, W, D], wq: f32[4, H, W]) in quadrant order
      (--), (-+), (+-), (++) like quadrant_anchors.  Window pixels
      outside the (valid) image contribute nothing.
    """
    global launches
    launches += 1
    h, w, _ = img_u8.shape
    dev = img_u8.device
    img = img_u8.to(torch.int32)
    vol = vol.to(torch.float32)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    neg, pos = quadrant_offsets(half_wnd, stride)
    ranges = {False: neg, True: pos}

    bqs, wqs = [], []
    for y_pos in (False, True):
        for x_pos in (False, True):
            b = torch.zeros_like(vol)
            wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
            for dy in ranges[y_pos]:
                for dx in ranges[x_pos]:
                    q_img = torch.roll(img, (-dy, -dx), dims=(0, 1))
                    q_vol = torch.roll(vol, (-dy, -dx), dims=(0, 1))
                    ok = ((ys + dy >= 0) & (ys + dy < h)
                          & (xs + dx >= 0) & (xs + dx < w))
                    if valid is not None:
                        ok = ok & torch.roll(valid, (-dy, -dx), dims=(0, 1))
                    l1 = (q_img - img).abs().sum(-1).to(torch.float32)
                    wgt = torch.where(ok, asw_weight(l1, gamma), 0.0)
                    b = b + wgt[..., None] * q_vol
                    wsum = wsum + wgt
            bqs.append(b)
            wqs.append(wsum)
    return torch.stack(bqs), torch.stack(wqs)


def quadrant_prescreen_cost(bq: torch.Tensor, wq: torch.Tensor,
                            max_cost: torch.Tensor, abc: torch.Tensor, *,
                            half_wnd: int, max_dis: int) -> torch.Tensor:
    """Ranking cost of K candidate plane fields from the quadrant volumes:
    sum_Q lerp(B_Q[c], dq(anchor_Q)), out-of-range anchors saturating at
    W_Q[c] * max_cost.

    The lerp is a two-tap gather at trunc(dq) and trunc(dq) + 1; the JAX
    reference writes it as a tent contraction over all D slices only
    because XLA:TPU serialises that gather.  In range the two are equal up
    to rounding.

    Args:
      bq / wq: build_quadrant_volumes outputs (one view).
      abc: f32[K, H, W, 3].

    Returns:
      f32[K, H, W] ranking costs (not the exact window cost).
    """
    global rank_launches
    rank_launches += 1
    k, h, w, _ = abc.shape
    xs, ys = pixel_grid(h, w, abc.device)
    pos = torch.arange(h * w, device=abc.device).reshape(h, w)
    a, b = abc[..., 0], abc[..., 1]
    d_center = a * xs + b * ys + abc[..., 2]
    total = torch.zeros((k, h, w), dtype=torch.float32, device=abc.device)
    for qi, (ay, ax) in enumerate(quadrant_anchors(half_wnd)):
        dq = d_center + a * ax + b * ay
        in_range = (dq >= 1.0) & (dq < float(max_dis))
        f = torch.where(in_range, dq, 0.0).trunc()
        fi = f.to(torch.int64)
        t = dq - f
        val = ((1.0 - t) * take_depth(bq[qi], pos, fi)
               + t * take_depth(bq[qi], pos, fi + 1))
        total = total + torch.where(in_range, val, wq[qi] * max_cost)
    return total
