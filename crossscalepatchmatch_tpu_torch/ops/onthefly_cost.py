"""On-the-fly slanted-plane window costs, no precomputed volume (port of
crossscalepatchmatch_tpu.ops.onthefly_cost plus the semantics of the fused
no-volume kernel, crossscalepatchmatch_tpu.ops.pallas.window_cost fly path).

Two sub-pixel modes (cfg.fly_lerp), both the plain PyTorch versions of one
CUDA kernel (ops.cuda.fly_cost):

  * "cost" (kernel K5; K3 at wnd_stride > 1): the Pre* window cost
    (ops.plane_cost.level_plane_cost) over the GRD volume that
    ops.grad_cost.grd_cost_volume builds from the level's views, with the
    out-of-range saturation fly_sat_cost instead of max(volume).  The plain
    version builds that volume; the kernel never does.
  * "image" (kernel K6): the literal GrdPC / CSPC data term
    (grd_pc.cc:149-171, cspc.cc:107-182): per window pixel q the other
    view is warped to other_x = q_x -+ dq with C-trunc taps (the
    extrapolating weights at negative other_x included), the two tap
    columns wrapped by +-W (HandleBorder, commfunc.h:129-145), and one TAD
    colour + gradient term applied:
        clr = mean_ch |I_q - lerp(I_other)|   (truncated at tau_clr)
        grd = |G_q - lerp(G_other)|           (truncated at tau_grd)
    mixed alpha*clr + (1-alpha)*grd; trunc(dq) outside [1, max_dis-1]
    saturates at fly_sat_cost.

With Lab weights (kernel K7, cfg.use_lab_weights) the ASW weights read the
level's Lab image while the data term reads BGR + gradient.  Cross-scale
runs (fly_plane_cost over several levels) index level s directly at
(y >> s, x >> s) with d0 / 2^s and max_dis >> s, and sum the levels with
the scale weights ((w0*c0 + w1*c1) + w2*c2 + ..., CSPC's cspc.cc:107-182).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..config import CSPMConfig
from .color import bgr_to_lab_u8, bgr_to_rgb, rgb_to_gray_f32
from .grad_cost import grd_cost_volume
from .gradient import sobel_x_k1
from .plane_cost import asw_weight, level_plane_cost
from .pyramid import build_pyramid

# Calls of the plain version of the fly kernel (a plain count; the GPU tier
# reads it to show the card's fly paths never came through here).
launches = 0


def fly_sat_cost(alpha: float, tau_clr: float, tau_grd: float) -> float:
    """Out-of-range saturation of the fly path: alpha*tau_clr +
    (1-alpha)*tau_grd, GrdPC's own constant (grd_pc.cc:118-123) and the
    supremum of every GRD volume entry (the fly path has no volume to take
    a max over)."""
    return alpha * tau_clr + (1.0 - alpha) * tau_grd


def gray_gradient(bgr_u8: torch.Tensor) -> torch.Tensor:
    """x-Sobel(ksize=1) of the float BT.601 gray (grd_pc.cc:37-41):
    u8[..., H, W, 3] -> f32[..., H, W]."""
    return sobel_x_k1(rgb_to_gray_f32(bgr_to_rgb(bgr_u8)))


def _handle_border(x: torch.Tensor, n: int) -> torch.Tensor:
    """Wrap by +-n (commfunc.h:129-145); inputs must lie in (-n, 2n)."""
    return torch.where(x < 0, x + n, torch.where(x >= n, x - n, x))


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[idx] along the first axis with jnp.take's bounds: an index in
    [-N, 0) counts from the end, one outside [-N, N) reads NaN (at
    max_dis >= W a tap can fall past the last row's one +-W wrap)."""
    n = flat.shape[0]
    ok = (idx >= -n) & (idx < n)
    out = flat[torch.where(ok, idx, 0)]
    if out.dim() > ok.dim():
        ok = ok[..., None]
    return torch.where(ok, out, float("nan"))


def _data_term(q_img, q_grd, oth_img, oth_grd, dq, q_x, q_y, sign: int, *,
               w_oth: int, alpha: float, tau_clr: float, tau_grd: float):
    """TAD colour + gradient against the sub-pixel warped other view.

    Args:
      q_img: f32[..., 3] window-pixel BGR; q_grd: f32[...] its gradient.
      oth_img: f32[N, 3] other-view BGR, row-major flat; oth_grd: f32[N].
      dq: f32[...] hypothesis disparity at the window pixel.
      q_x / q_y: i64 column and row of the window pixel, broadcastable.
    """
    other_x = q_x.to(torch.float32) + sign * dq
    fx = other_x.trunc().to(torch.int64)
    floor_wgt = (fx + 1).to(torch.float32) - other_x
    flat_f = q_y * w_oth + _handle_border(fx, w_oth)
    flat_c = q_y * w_oth + _handle_border(fx + 1, w_oth)
    fw = floor_wgt[..., None]
    lerp = fw * _take(oth_img, flat_f) + (1.0 - fw) * _take(oth_img, flat_c)
    diff = (q_img - lerp).abs()
    # the channel mean in a fixed order (the CUDA kernel's)
    clr = (diff[..., 0] + diff[..., 1] + diff[..., 2]) / 3.0
    g_lerp = (floor_wgt * _take(oth_grd, flat_f)
              + (1.0 - floor_wgt) * _take(oth_grd, flat_c))
    grd = (q_grd - g_lerp).abs()
    return (alpha * torch.clamp(clr, max=tau_clr)
            + (1.0 - alpha) * torch.clamp(grd, max=tau_grd))


def level_fly_image_cost(wgt_u8: torch.Tensor, img_u8: torch.Tensor,
                         grd: torch.Tensor, oth_u8: torch.Tensor,
                         oth_grd: torch.Tensor, abc: torch.Tensor, *,
                         sign: int, scale: int, half_wnd: int, max_dis: int,
                         gamma: float, alpha: float = 0.1,
                         tau_clr: float = 10.0, tau_grd: float = 2.0,
                         wnd_stride: int = 1) -> torch.Tensor:
    """Image-space-lerp window cost of fine-grid planes on pyramid level
    `scale` (the loop of ops.plane_cost.level_plane_cost with the GrdPC
    data term in place of the volume lerp).

    Args:
      wgt_u8: u8[Hs, Ws, 3] weight image (BGR, or Lab); img_u8 / grd: the
        level's BGR view and gray_gradient; oth_u8 / oth_grd: the other
        view's; abc: f32[K, H, W, 3] fine-grid planes; sign: -1 for the
        left view (other_x = q_x - dq), +1 for the right; max_dis: the
        level's.

    Returns:
      f32[K, H, W].
    """
    hs, ws, _ = img_u8.shape
    _, h, w, _ = abc.shape
    dev = abc.device
    wimg = wgt_u8.to(torch.int32).reshape(-1, 3)
    img = img_u8.to(torch.float32).reshape(-1, 3)
    grd = grd.reshape(-1)
    oth = oth_u8.to(torch.float32).reshape(-1, 3)
    oth_g = oth_grd.reshape(-1)
    sat = torch.tensor(fly_sat_cost(alpha, tau_clr, tau_grd),
                       dtype=torch.float32, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    cy, cx = ys >> scale, xs >> scale
    a, b = abc[..., 0], abc[..., 1]
    d_c = a * xs.float() + b * ys.float() + abc[..., 2]
    if scale:
        d_c = d_c * (1.0 / (1 << scale))
    wgt_c = wimg[cy * ws + cx]                                    # [H, W, 3]

    acc = torch.zeros(abc.shape[:-1], dtype=torch.float32, device=dev)
    for dy in range(-half_wnd, half_wnd + 1, wnd_stride):
        qy = cy + dy
        for dx in range(-half_wnd, half_wnd + 1, wnd_stride):
            qx = cx + dx
            q_ok = (qy >= 0) & (qy < hs) & (qx >= 0) & (qx < ws)  # [H, W]
            qyc, qxc = qy.clamp(0, hs - 1), qx.clamp(0, ws - 1)
            pos = qyc * ws + qxc
            l1 = (wimg[pos] - wgt_c).abs().sum(-1).to(torch.float32)
            wgt = asw_weight(l1, gamma)

            dq = d_c + a * dx + b * dy                             # [K, H, W]
            ok = (dq >= 1.0) & (dq < float(max_dis))
            val = _data_term(img[pos], grd[pos], oth, oth_g,
                             torch.where(ok, dq, 1.0), qxc, qyc, sign,
                             w_oth=ws, alpha=alpha, tau_clr=tau_clr,
                             tau_grd=tau_grd)
            val = torch.where(ok, val, sat)
            acc = acc + torch.where(q_ok, wgt * val, 0.0)
    return acc


def level_fly_volume_cost(wgt_u8: torch.Tensor, ref_u8: torch.Tensor,
                          oth_u8: torch.Tensor, abc: torch.Tensor, *,
                          right: bool, scale: int, half_wnd: int,
                          max_dis: int, gamma: float, alpha: float = 0.1,
                          tau_clr: float = 10.0, tau_grd: float = 2.0,
                          border_thres: float = 3.0,
                          wnd_stride: int = 1) -> torch.Tensor:
    """Cost-space-lerp ("cost" mode) window cost on level `scale`: the
    level's GRD volume of this view (border pseudo-cost included), then
    level_plane_cost saturating at fly_sat_cost.  u8[Hs, Ws, 3] BGR views,
    f32[K, H, W] fine-grid planes; returns f32[K, H, W]."""
    l_rgb, r_rgb = bgr_to_rgb(oth_u8 if right else ref_u8), bgr_to_rgb(
        ref_u8 if right else oth_u8)
    vol = grd_cost_volume(l_rgb, r_rgb, max_dis, alpha=alpha,
                          tau_clr=tau_clr, tau_grd=tau_grd,
                          border_thres=border_thres, right=right)
    sat = torch.tensor(fly_sat_cost(alpha, tau_clr, tau_grd),
                       dtype=torch.float32, device=abc.device)
    return level_plane_cost(wgt_u8, vol, sat, abc, scale=scale,
                            half_wnd=half_wnd, max_dis=max_dis, gamma=gamma,
                            wnd_stride=wnd_stride)


@dataclasses.dataclass
class FlyData:
    """Per-level per-view inputs of the no-volume cost (O(H*W) per level).

    imgs[s]: u8[2, Hs, Ws, 3] level-s views (BGR)
    grds[s]: f32[2, Hs, Ws] their gray_gradient
    wimgs[s]: optional u8[2, Hs, Ws, 3] Lab weight images (None: the
      weights read imgs)
    """

    imgs: List[torch.Tensor]
    grds: List[torch.Tensor]
    wimgs: List[torch.Tensor] | None = None

    @property
    def weight_imgs(self) -> List[torch.Tensor]:
        return self.imgs if self.wimgs is None else self.wimgs


def build_fly_data(l_bgr_u8: torch.Tensor, r_bgr_u8: torch.Tensor,
                   cfg: CSPMConfig) -> FlyData:
    """The no-volume path's inputs: scale_num levels when cfg.use_cs, else
    one; Lab weight images per level when cfg.use_lab_weights (cspc.cc:
    48-49)."""
    levels = cfg.scale_num if cfg.use_cs else 1
    l_pyr = build_pyramid(l_bgr_u8, levels)
    r_pyr = build_pyramid(r_bgr_u8, levels)
    imgs = [torch.stack([l_pyr[s], r_pyr[s]]) for s in range(levels)]
    return FlyData(imgs=imgs, grds=[gray_gradient(im) for im in imgs],
                   wimgs=([bgr_to_lab_u8(im) for im in imgs]
                          if cfg.use_lab_weights else None))


def fly_plane_cost(fd: FlyData, scale_wgts: Sequence[float] | None,
                   abc: torch.Tensor, *, half_wnd: int, max_dis: int,
                   gamma: float, alpha: float = 0.1, tau_clr: float = 10.0,
                   tau_grd: float = 2.0, border_thres: float = 3.0,
                   lerp: str = "cost", wnd_stride: int = 1) -> torch.Tensor:
    """No-volume plane cost of both views, the plain version of the fly
    kernel (K5 / K3 / K6 / K7, ops.cuda.fly_cost).

    Args:
      fd: build_fly_data output; one level, or the pyramid's.
      scale_wgts: per-level weights (ops.scale_weights) for several levels;
        None for one level (its cost is returned unweighted).
      abc: f32[2, K, H, W, 3] fine-grid candidate planes.
      lerp: "cost" or "image" (module docstring).
      wnd_stride: window subsampling (the strided prescreen; 1 for exact).

    Returns:
      f32[2, K, H, W].
    """
    global launches
    launches += 1
    n = len(fd.imgs)
    if (scale_wgts is None) != (n == 1):
        raise ValueError("scale_wgts must be None for one level and given "
                         "for several")
    if lerp not in ("cost", "image"):
        raise ValueError(f"lerp must be 'cost' or 'image', got {lerp!r}")
    kw = dict(half_wnd=half_wnd, gamma=gamma, alpha=alpha, tau_clr=tau_clr,
              tau_grd=tau_grd, wnd_stride=wnd_stride)
    views = []
    for v in range(2):
        total, md = None, max_dis
        for s in range(n):
            wgt, img, oth = (fd.weight_imgs[s][v], fd.imgs[s][v],
                             fd.imgs[s][1 - v])
            if lerp == "image":
                cost_s = level_fly_image_cost(
                    wgt, img, fd.grds[s][v], oth, fd.grds[s][1 - v], abc[v],
                    sign=2 * v - 1, scale=s, max_dis=md, **kw)
            else:
                cost_s = level_fly_volume_cost(
                    wgt, img, oth, abc[v], right=v == 1, scale=s,
                    max_dis=md, border_thres=border_thres, **kw)
            if n == 1:
                total = cost_s
            else:
                term = float(scale_wgts[s]) * cost_s
                total = term if total is None else total + term
            md //= 2
        views.append(total)
    return torch.stack(views)
