"""Slanted-plane adaptive-support-weight window cost over a precomputed
volume: the plain PyTorch version of kernel K1
(port of crossscalepatchmatch_tpu.ops.plane_cost.window_plane_cost).

Per center pixel c and candidate plane (a, b, c0), summed over the in-image
window offsets o = (dy, dx) in dy-major order:

    w(c, q)  = exp(-L1(img_c, img_q) / gamma)                  q = c + o
    dq       = d_c + a*dx + b*dy,   d_c = a*x + b*y + c0
    val(q)   = lerp(vol[q, f], vol[q, f+1]) at dq, f = trunc(dq),
               or max(vol) unless 1 <= f <= max_dis-1
    cost(c)  = sum_o w(c, q) * val(q)

(pre_ss_pc.cc:74-118).  The range test is made on the float
(1 <= trunc(dq) <= max_dis-1  <=>  1 <= dq < max_dis) and dq is converted
to an integer only inside that range: random planes with a near-zero nz
give |dq| far beyond the int32 range.

The CUDA kernel (ops.cuda.window_cost) computes the same function with the
same rounding steps; this module is what it is held against, and what a CPU
tensor runs.
"""

from __future__ import annotations

import torch

# Calls of the plain version (a plain count; chip_smoke reads it to show
# the card's main path never came through here).
launches = 0

# Largest L1 distance between two u8 BGR pixels.
L1_MAX = 3 * 255


def stride_start(half_wnd: int, stride: int) -> int:
    """First window offset per axis at a sampling stride: -half_wnd
    (deliberately not 0-anchored; see the JAX module's note)."""
    return -half_wnd


def asw_weight(l1: torch.Tensor, gamma: float) -> torch.Tensor:
    """exp(-L1 / gamma) as the reference computes it: exp(-l1 * f32(1/g))."""
    inv_gamma = torch.tensor(1.0 / gamma, dtype=torch.float32,
                             device=l1.device)
    return torch.exp(-l1 * inv_gamma)


def asw_lut(gamma: float, device) -> torch.Tensor:
    """f32[L1_MAX + 1]: asw_weight at every integer L1 distance.

    The kernels read weights from this table; built by asw_weight on the
    same device, it holds bit for bit what the plain version computes.
    """
    l1 = torch.arange(L1_MAX + 1, dtype=torch.float32, device=device)
    return asw_weight(l1, gamma)


def take_depth(vol: torch.Tensor, pos: torch.Tensor,
               f: torch.Tensor) -> torch.Tensor:
    """vol[pos, f] for a flat pixel index pos and a depth index f.

    Args:
      vol: [H, W, D] volume; pos: i64 broadcastable to f; f: i64 [...].
    """
    d = vol.shape[-1]
    return vol.reshape(-1)[pos * d + f]


def window_plane_cost(img_u8: torch.Tensor, vol: torch.Tensor,
                      max_cost: torch.Tensor, abc: torch.Tensor, *,
                      half_wnd: int, max_dis: int, gamma: float,
                      wnd_stride: int = 1) -> torch.Tensor:
    """Single-view plane cost for K candidate plane fields.

    Args:
      img_u8: u8[H, W, 3] reference-view image.
      vol: f32[H, W, D] cost volume, D = max_dis + 1.
      max_cost: f32 scalar, max over the volume (saturation value).
      abc: f32[K, H, W, 3] candidate planes.
      wnd_stride: evaluate every wnd_stride-th window offset per axis (the
        strided prescreen approximation; 1 for true costs).

    Returns:
      f32[K, H, W].
    """
    global launches
    launches += 1
    h, w, _ = img_u8.shape
    dev = abc.device
    o_start = stride_start(half_wnd, wnd_stride)
    img = img_u8.to(torch.int32).reshape(-1, 3)
    vol = vol.to(torch.float32).contiguous()
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    a, b = abc[..., 0], abc[..., 1]
    d_c = a * xs.float() + b * ys.float() + abc[..., 2]
    img_c = img.reshape(h, w, 3)

    acc = torch.zeros(abc.shape[:-1], dtype=torch.float32, device=dev)
    for dy in range(o_start, half_wnd + 1, wnd_stride):
        qy = ys + dy
        for dx in range(o_start, half_wnd + 1, wnd_stride):
            qx = xs + dx
            q_ok = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)     # [H, W]
            pos = qy.clamp(0, h - 1) * w + qx.clamp(0, w - 1)
            l1 = (img[pos] - img_c).abs().sum(-1).to(torch.float32)
            wgt = asw_weight(l1, gamma)

            dq = d_c + a * dx + b * dy                             # [K, H, W]
            in_range = (dq >= 1.0) & (dq < float(max_dis))
            f = torch.where(in_range, dq, 0.0).trunc().to(torch.int64)
            v_f = take_depth(vol, pos, f)
            v_c = take_depth(vol, pos, f + 1)
            floor_wgt = (f + 1).to(torch.float32) - dq
            val = floor_wgt * v_f + (1.0 - floor_wgt) * v_c
            val = torch.where(in_range, val, max_cost)
            acc = acc + torch.where(q_ok, wgt * val, 0.0)
    return acc
