"""Slanted-plane adaptive-support-weight window cost over precomputed
volumes: the plain PyTorch versions of kernels K1 (window_plane_cost) and
K4 (cross_scale_plane_cost) (port of crossscalepatchmatch_tpu.ops.plane_cost).

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

The CUDA kernels (ops.cuda.window_cost, ops.cuda.cross_scale_cost) compute
the same functions with the same rounding steps; this module is what they
are held against, and what a CPU tensor runs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Calls of the plain versions of K1 and K4 (plain counts; the GPU tier
# reads them to show the card's main paths never came through here).
launches = 0
cross_scale_launches = 0

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
                      center_row0: int = 0,
                      row_valid: torch.Tensor | None = None,
                      center_col0: int = 0,
                      col_valid: torch.Tensor | None = None,
                      wnd_stride: int = 1) -> torch.Tensor:
    """Single-view plane cost for K candidate plane fields.

    Args:
      img_u8: u8[Ha, Wa, 3] reference-view image; vol: f32[Ha, Wa, D] cost
        volume, D = max_dis + 1.  Ha / Wa exceed the output's H / W when a
        spatial tile (parallel.tiled) passes its block with a halo.
      max_cost: f32 scalar, max over the volume (saturation value).
      abc: f32[K, H, W, 3] candidate planes, in output coordinates.
      center_row0 / center_col0: array row / column of output pixel (0, 0)
        (the halo depth on an extended axis, else 0).
      row_valid / col_valid: optional bool[Ha] / bool[Wa]: the array rows /
        columns inside the global image (a neighbour's halo counts, rows
        past the global border do not).  Window pixels outside the array
        never count.
      wnd_stride: evaluate every wnd_stride-th window offset per axis (the
        strided prescreen approximation; 1 for true costs).

    Returns:
      f32[K, H, W].
    """
    global launches
    launches += 1
    return level_plane_cost(img_u8, vol, max_cost, abc, scale=0,
                            half_wnd=half_wnd, max_dis=max_dis, gamma=gamma,
                            wnd_stride=wnd_stride, row0=center_row0,
                            col0=center_col0, row_valid=row_valid,
                            col_valid=col_valid)


def level_plane_cost(img_u8: torch.Tensor, vol: torch.Tensor,
                     max_cost: torch.Tensor, abc: torch.Tensor, *,
                     scale: int, half_wnd: int, max_dis: int, gamma: float,
                     wnd_stride: int = 1, row0: int = 0, col0: int = 0,
                     row_valid: torch.Tensor | None = None,
                     col_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Window cost of fine-grid planes on pyramid level `scale`.

    Every fine pixel (x, y) keeps its own plane; its window is
    (2*half_wnd+1)^2 level-s pixels around ((y + row0) >> s,
    (x + col0) >> s), and the plane is re-anchored through d0 / 2^s with
    the same (a, b) (pre_cs_pc.cc:133-188):

        dq = ((d0 * 2^-s) + a*dx) + b*dy,   d0 = a*x + b*y + c

    A window pixel counts only inside the level-s arrays and, when given,
    on a row / column that row_valid / col_valid mark; the weights come
    from the level-s colours; the range test uses max_dis (the level's).
    Scale 0 is the plain window cost.  Level s is indexed directly (the JAX
    package's nearest upsampling was the TPU's way around gathers).

    (row0, col0) is the array position of fine pixel (0, 0) at level 0 and
    its global fine position at level s > 0: a spatial tile (parallel.tiled)
    passes its halo depth at level 0 and its block's origin on the whole
    coarser levels; planes stay in the tile's own coordinates.

    Args:
      img_u8: u8[Hs, Ws, 3] level-s image; vol: f32[Hs, Ws, Ds] level-s
        volume, Ds = max_dis + 1; abc: f32[K, H, W, 3] fine-grid planes.
      row_valid / col_valid: optional bool[Hs] / bool[Ws].

    Returns:
      f32[K, H, W].
    """
    hs, ws, _ = img_u8.shape
    _, h, w, _ = abc.shape
    dev = abc.device
    d = vol.shape[-1]
    o_start = stride_start(half_wnd, wnd_stride)
    img = img_u8.to(torch.int32).reshape(-1, 3)
    vol = vol.to(torch.float32).contiguous()
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    cy, cx = (ys + row0) >> scale, (xs + col0) >> scale
    a, b = abc[..., 0], abc[..., 1]
    d_c = a * xs.float() + b * ys.float() + abc[..., 2]
    if scale:
        d_c = d_c * (1.0 / (1 << scale))
    img_c = img[cy * ws + cx]                                      # [H, W, 3]

    acc = torch.zeros(abc.shape[:-1], dtype=torch.float32, device=dev)
    for dy in range(o_start, half_wnd + 1, wnd_stride):
        qy = cy + dy
        for dx in range(o_start, half_wnd + 1, wnd_stride):
            qx = cx + dx
            q_ok = (qy >= 0) & (qy < hs) & (qx >= 0) & (qx < ws)   # [H, W]
            qyc, qxc = qy.clamp(0, hs - 1), qx.clamp(0, ws - 1)
            if row_valid is not None:
                q_ok = q_ok & row_valid[qyc]
            if col_valid is not None:
                q_ok = q_ok & col_valid[qxc]
            pos = qyc * ws + qxc
            l1 = (img[pos] - img_c).abs().sum(-1).to(torch.float32)
            wgt = asw_weight(l1, gamma)

            dq = d_c + a * dx + b * dy                             # [K, H, W]
            in_range = (dq >= 1.0) & (dq < float(max_dis))
            f = torch.where(in_range, dq, 0.0).trunc().to(torch.int64)
            v_f = take_depth(vol, pos, f)
            # f + 1 <= max_dis in range; the clamp only keeps the discarded
            # out-of-range tap inside a one-slice volume
            v_c = take_depth(vol, pos, torch.clamp(f + 1, max=d - 1))
            floor_wgt = (f + 1).to(torch.float32) - dq
            val = floor_wgt * v_f + (1.0 - floor_wgt) * v_c
            val = torch.where(in_range, val, max_cost)
            acc = acc + torch.where(q_ok, wgt * val, 0.0)
    return acc


def cross_scale_plane_cost(pyr_imgs: Sequence[torch.Tensor],
                           pyr_vols: Sequence[torch.Tensor],
                           pyr_max_costs: Sequence[torch.Tensor],
                           scale_wgts: Sequence[float], abc0: torch.Tensor,
                           *, half_wnd: int, max_dis: int, gamma: float,
                           origins: Sequence[Tuple[int, int]] | None = None,
                           row_valids: Sequence | None = None,
                           col_valids: Sequence | None = None
                           ) -> torch.Tensor:
    """Cross-scale aggregated plane cost of one view, the plain version of
    kernel K4: ((w0*c0 + w1*c1) + w2*c2) + ... (pre_cs_pc.cc:182), c_s the
    level-s window cost (level_plane_cost) with max_dis >> s.

    Args:
      pyr_imgs / pyr_vols / pyr_max_costs: per-level u8[Hs, Ws, 3],
        f32[Hs, Ws, Ds] and f32 scalars, level 0 finest.
      scale_wgts: inter-scale weights (ops.scale_weights).
      abc0: f32[K, H, W, 3] fine-grid planes.
      origins / row_valids / col_valids: per level, level_plane_cost's
        (row0, col0) and its optional validity vectors (a spatial tile's
        band form; None: (0, 0) and the arrays' extent).

    Returns:
      f32[K, H, W].
    """
    global cross_scale_launches
    cross_scale_launches += 1
    n = len(pyr_imgs)
    origins = origins or [(0, 0)] * n
    row_valids = row_valids or [None] * n
    col_valids = col_valids or [None] * n
    total = None
    md = max_dis
    for s, (img_s, vol_s, mc_s) in enumerate(
            zip(pyr_imgs, pyr_vols, pyr_max_costs)):
        cost_s = level_plane_cost(img_s, vol_s, mc_s, abc0, scale=s,
                                  half_wnd=half_wnd, max_dis=md, gamma=gamma,
                                  row0=origins[s][0], col0=origins[s][1],
                                  row_valid=row_valids[s],
                                  col_valid=col_valids[s])
        term = float(scale_wgts[s]) * cost_s
        total = term if total is None else total + term
        md //= 2
    return total
