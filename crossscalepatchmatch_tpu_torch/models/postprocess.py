"""Disparity post-processing: LR consistency check, invalid fill, weighted
median (port of crossscalepatchmatch_tpu.models.postprocess, single
device; cs_patchmatch.cc:347-588).

  * lr_check (cs_patchmatch.cc:347-369): per-pixel gather of the other
    view's disparity at the warped column.
  * fill_invalid (cs_patchmatch.cc:370-428): the nearest valid pixel to the
    left and right of each invalid pixel come from prefix / suffix cummax
    scans; their planes are extrapolated at the filled pixel.
  * weighted_median (cs_patchmatch.cc:430-506): at each invalid pixel, the
    smallest d whose colour-weighted count of valid window disparities
    <= d reaches half the window's total weight; on the card kernel WMF
    (ops.cuda.weighted_median), on the CPU its plain version
    weighted_median_plain.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import CSPMConfig
from ..ops import plane
from ..ops.cuda import weighted_median as wmf
from ..ops.plane_cost import asw_lut
from ..utils.spans import span

# Disparity levels of a u8 map.
N_LEVELS = 256
# Budget of one block of weighted-median contributions, in f32 elements.
WMF_BLOCK_ELEMS = 1 << 26

# Calls of weighted_median_plain (a plain count; the GPU tier reads it to
# show the card's paths never came through here).
plain_launches = 0


def lr_check(dis: torch.Tensor, cfg: CSPMConfig) -> torch.Tensor:
    """valid[v,y,x] iff |d_v(x) - d_other(x -+ round(d_v))| <= lr_check_thres
    and d_v > 0, an out-of-image warp being invalid.

    Args:
      dis: u8[2, H, W] scaled disparity maps.

    Returns:
      bool[2, H, W].
    """
    _, h, w = dis.shape
    xs = torch.arange(w, device=dis.device)[None, :]
    d = dis.to(torch.float32) / cfg.dis_scale

    def per_view(dv, d_other, sign):
        other_x = xs + sign * torch.round(dv).to(torch.int64)
        in_range = (other_x >= 0) & (other_x < w)
        other = torch.gather(d_other, 1, other_x.clamp(0, w - 1))
        return (in_range & ((dv - other).abs() <= cfg.lr_check_thres)
                & (dv > 0))

    return torch.stack([per_view(d[0], d[1], -1), per_view(d[1], d[0], +1)])


def fill_invalid(dis: torch.Tensor, abc: torch.Tensor, valid: torch.Tensor,
                 cfg: CSPMConfig) -> torch.Tensor:
    """Fill each invalid pixel from the planes of the nearest valid pixels
    to its left and right in its row: the smaller of the two extrapolated
    disparities, the one that exists if only one does, unchanged if
    neither; quantized as saturate(dis_scale * round(d)).

    Args:
      dis: u8[2, H, W]; abc: f32[2, H, W, 3]; valid: bool[2, H, W].
    """
    _, h, w = dis.shape
    dev = dis.device
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    xf, ys = plane.pixel_grid(h, w, dev)

    def per_view(dis_v, abc_v, valid_v):
        # nearest valid column to the left (inclusive): prefix cummax of
        # (x if valid else -1); to the right: the same on the mirrored row
        lidx = torch.cummax(torch.where(valid_v, xs, -1), dim=1).values
        ridx_rev = torch.cummax(
            torch.where(valid_v, w - 1 - xs, -1).flip(1), dim=1).values.flip(1)
        ridx = torch.where(ridx_rev >= 0, w - 1 - ridx_rev, w)
        l_ok = lidx >= 0
        r_ok = ridx < w

        def planes_at(idx):
            i = idx.clamp(0, w - 1)[..., None].expand(h, w, 3)
            return torch.gather(abc_v, 1, i)

        l_d = plane.disparity_at(planes_at(lidx), xf, ys)
        r_d = plane.disparity_at(planes_at(ridx), xf, ys)
        d_fill = torch.where(l_ok & r_ok, torch.minimum(l_d, r_d),
                             torch.where(l_ok, l_d, r_d))
        fill_u8 = torch.clamp(cfg.dis_scale * torch.round(d_fill), 0,
                              255).to(torch.uint8)
        do_fill = (~valid_v) & (l_ok | r_ok)
        return torch.where(do_fill, fill_u8, dis_v)

    return torch.stack([per_view(dis[v], abc[v], valid[v]) for v in range(2)])


def weighted_median(dis: torch.Tensor, imgs: torch.Tensor,
                    valid: torch.Tensor, cfg: CSPMConfig,
                    center_row0: int = 0, out_h: int | None = None,
                    center_col0: int = 0,
                    out_w: int | None = None) -> torch.Tensor:
    """weighted_median_plain's result: CPU tensors take it, CUDA tensors
    kernel WMF (u8-equal to it); any other device raises ValueError."""
    if dis.device.type == "cpu":
        return weighted_median_plain(dis, imgs, valid, cfg, center_row0,
                                     out_h, center_col0, out_w)
    return wmf.weighted_median_cuda(
        dis, imgs, valid, asw_lut(cfg.wmf_gamma, dis.device),
        half_wnd=cfg.wnd_size // 2, center_row0=center_row0, out_h=out_h,
        center_col0=center_col0, out_w=out_w)


def weighted_median_plain(dis: torch.Tensor, imgs: torch.Tensor,
                          valid: torch.Tensor, cfg: CSPMConfig,
                          center_row0: int = 0, out_h: int | None = None,
                          center_col0: int = 0,
                          out_w: int | None = None) -> torch.Tensor:
    """Colour-weighted median of the valid window disparities, applied at
    the invalid pixels only.

    With w_o = exp(-L1(img_p, img_q)/wmf_gamma) * valid_q over the window
    offsets o in dy-major order, the median at p is the smallest t with

        S(t) = sum_o w_o * [dis_q <= t]  >=  0.5 * S(255)

    (the reference's 256-bin histogram scan).  S(t) is accumulated for all
    256 thresholds at once, offset by offset in window order, so each S(t)
    is the same sequential f32 sum the JAX engine forms for its binary
    search; a sequential sum of non-negative terms is monotone in t, so
    both pick the same t.  Only invalid pixels with a positive total are
    replaced.

    Args:
      dis / imgs / valid: u8[2, Ha, Wa] / u8[2, Ha, Wa, 3] / bool[2, Ha, Wa].
        Ha / Wa exceed the output when a spatial tile (parallel.tiled)
        passes its block with halos; pixels past the global border must
        carry valid = 0, which drops them like window pixels outside the
        array.
      center_row0 / center_col0: array position of output pixel (0, 0)
        (the halo depth; 0 on one device).
      out_h / out_w: the output's extent (defaults: Ha / Wa).

    Returns:
      u8[2, out_h, out_w].
    """
    global plain_launches
    plain_launches += 1
    _, h, w = dis.shape
    oh = h if out_h is None else out_h
    ow = w if out_w is None else out_w
    hw = cfg.wnd_size // 2
    dev = dis.device
    lut = asw_lut(cfg.wmf_gamma, dev)
    levels = torch.arange(N_LEVELS, device=dev, dtype=torch.int32)
    offs = torch.arange(-hw, hw + 1, device=dev)

    def per_view(dis_v, img_v, valid_v):
        out = dis_v[center_row0:center_row0 + oh,
                    center_col0:center_col0 + ow]
        ys, xs = torch.nonzero(~valid_v[center_row0:center_row0 + oh,
                                        center_col0:center_col0 + ow],
                               as_tuple=True)
        n = ys.numel()
        if n == 0:
            return out
        oys, oxs = ys, xs
        ys, xs = ys + center_row0, xs + center_col0
        img_i = img_v.to(torch.int32)
        dis_i = dis_v.to(torch.int32)
        center = img_i[ys, xs]                                   # [N, 3]
        qx = xs[:, None] + offs[None, :]                         # [N, wnd]
        x_ok = (qx >= 0) & (qx < w)
        qx = qx.clamp(0, w - 1)
        # columns of one window row per block of contributions
        cols = max(1, min(len(offs), WMF_BLOCK_ELEMS // (n * N_LEVELS)))
        acc = torch.zeros((n, N_LEVELS), dtype=torch.float32, device=dev)
        for dy in range(-hw, hw + 1):
            qy = ys + dy
            ok = x_ok & ((qy >= 0) & (qy < h))[:, None]
            qy = qy.clamp(0, h - 1)[:, None]
            l1 = (img_i[qy, qx] - center[:, None]).abs().sum(-1)
            wgt = lut[l1.long()] * (ok & valid_v[qy, qx]).to(torch.float32)
            le = dis_i[qy, qx][..., None] <= levels          # [N, wnd, 256]
            for c0 in range(0, len(offs), cols):
                contrib = wgt[:, c0:c0 + cols, None] * le[:, c0:c0 + cols]
                for j in range(contrib.shape[1]):
                    acc.add_(contrib[:, j])
        half_total = acc[:, -1] * 0.5
        median = (acc < half_total[:, None]).sum(-1).to(torch.uint8)
        out = out.clone()
        replace = half_total > 0
        out[oys[replace], oxs[replace]] = median[replace]
        return out

    return torch.stack([per_view(dis[v], imgs[v], valid[v])
                        for v in range(2)])


def postprocess(dis: torch.Tensor, abc: torch.Tensor, imgs: torch.Tensor,
                cfg: CSPMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """LR check -> fill -> weighted median (cs_patchmatch.cc:508-588).

    Returns (dis, valid): the cleaned maps and the LR-check validity mask.
    """
    with span("postprocess"):
        with span("lr_check"):
            valid = lr_check(dis, cfg)
        with span("fill"):
            dis = fill_invalid(dis, abc, valid, cfg)
        with span("weighted_median"):
            dis = weighted_median(dis, imgs, valid, cfg)
        return dis, valid
