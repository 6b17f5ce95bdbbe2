"""Cost-volume aggregation filters and the constant-median capability
(port of crossscalepatchmatch_tpu.ops.filters; plain PyTorch, no kernel).

Semantics kept from the JAX module (its docstring has the reference's
line numbers):
  * box_filter: truncated-window raw sums, out(y, x) = the sum of src over
    the window clipped to the image, not normalised; one cumsum and two
    clipped gathers per axis.
  * guided_filter: He et al. with N = box_filter(ones); a gray guide's
    closed form, and a colour guide's regularised 3x3 inverse written out
    (FAST_INV).  Defaults r = 9, eps = 1e-4.
  * bilateral_filter: joint bilateral with wrap-around window borders
    (the pixels jnp.roll shifts in), sig_sp = wnd / 2, weight
    exp(-(dx^2 + dy^2) / sig_sp^2 - clr^2 / sig_clr^2), clr the mean
    absolute channel difference for a colour guide; sig_clr = 0.03.
  * the volume filters (BOX radius 3, GF r = 9, BF wnd 35 in the presets)
    filter slices d = 1 .. max_dis - 1 only; slices 0 and max_dis pass
    through.  Guides are u8 images, normalised to [0, 1] inside.
  * median_filter_u8: the (2r+1)^2 median of a u8 image with replicate
    borders, by an 8-step binary search over intensity, each step a count
    over the window offsets; exact u8.

The filters take any leading batch axes on the filtered signal (the
volume filters run all inner slices of a view at once, where the JAX module
maps over them).  Sums accumulate in another order than XLA's, so results
agree with the JAX module within f32 rounding, not bit for bit; the median
is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _box_along(v: torch.Tensor, dim: int, radius: int) -> torch.Tensor:
    n = v.shape[dim]
    c = torch.cumsum(v, dim=dim)
    idx = torch.arange(n, device=v.device)
    hi = c.index_select(dim, torch.clamp(idx + radius, max=n - 1))
    lo_idx = idx - radius - 1
    lo = c.index_select(dim, torch.clamp(lo_idx, min=0))
    shape = [1] * v.dim()
    shape[dim] = n
    return hi - torch.where((lo_idx >= 0).view(shape), lo,
                            torch.zeros((), dtype=v.dtype, device=v.device))


def box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Truncated-window box sum over the last two axes: out[..., y, x] is
    the sum of x over rows [y-r, y+r] and columns [x-r, x+r] clipped to the
    array."""
    return _box_along(_box_along(x, x.dim() - 2, radius), x.dim() - 1,
                      radius)


def box_count(hw, radius: int, dtype=torch.float32,
              device="cpu") -> torch.Tensor:
    """N = box_filter(ones): each pixel's clipped-window pixel count."""
    return box_filter(torch.ones(tuple(hw), dtype=dtype, device=device),
                      radius)


def guided_filter(guide: torch.Tensor, p: torch.Tensor, radius: int = 9,
                  eps: float = 1e-4) -> torch.Tensor:
    """He et al. guided filter of a single-channel signal.

    Args:
      guide: f32[H, W] (gray) or f32[H, W, 3] (colour, the FAST_INV 3x3
        inverse), range [0, 1].
      p: f32[..., H, W], the signal (leading axes filtered independently).
    """
    n = box_count(p.shape[-2:], radius, p.dtype, p.device)

    def bf(v):
        return box_filter(v, radius) / n

    mean_p = bf(p)
    if guide.dim() == 2:
        mean_i = bf(guide)
        cov_ip = bf(guide * p) - mean_i * mean_p
        var_i = bf(guide * guide) - mean_i * mean_i
        a = cov_ip / (var_i + eps)
        b = mean_p - a * mean_i
        return bf(a) * guide + bf(b)

    chans = [guide[..., c] for c in range(3)]
    mean_i = [bf(c) for c in chans]
    cov_ip = [bf(chans[c] * p) - mean_i[c] * mean_p for c in range(3)]
    # upper-triangular covariance entries rr, rg, rb, gg, gb, bb
    var = {}
    for c in range(3):
        for cp in range(c, 3):
            var[(c, cp)] = (bf(chans[c] * chans[cp])
                            - mean_i[c] * mean_i[cp])
    a11 = var[(0, 0)] + eps
    a12, a13 = var[(0, 1)], var[(0, 2)]
    a22 = var[(1, 1)] + eps
    a23 = var[(1, 2)]
    a33 = var[(2, 2)] + eps
    det = (a11 * (a33 * a22 - a23 * a23)
           - a12 * (a33 * a12 - a23 * a13)
           + a13 * (a23 * a12 - a22 * a13))
    inv_det = 1.0 / det
    c0, c1, c2 = cov_ip
    a = [inv_det * (c0 * (a33 * a22 - a23 * a23)
                    + c1 * (a13 * a23 - a33 * a12)
                    + c2 * (a23 * a12 - a13 * a22)),
         inv_det * (c0 * (a23 * a13 - a33 * a12)
                    + c1 * (a33 * a11 - a13 * a13)
                    + c2 * (a13 * a12 - a23 * a11)),
         inv_det * (c0 * (a23 * a12 - a22 * a13)
                    + c1 * (a12 * a13 - a23 * a11)
                    + c2 * (a22 * a11 - a12 * a12))]
    b = mean_p - sum(a[c] * mean_i[c] for c in range(3))
    q = box_filter(b, radius)
    for c in range(3):
        q = q + box_filter(a[c], radius) * chans[c]
    return q / n


def bilateral_filter(guide: torch.Tensor, p: torch.Tensor, wnd: int,
                     sig_clr: float = 0.03) -> torch.Tensor:
    """Joint bilateral filter with wrap-around borders, sig_sp = wnd / 2.

    Args:
      guide: f32[H, W] or f32[H, W, 3], range [0, 1].
      p: f32[..., H, W] (leading axes filtered independently).

    The window offsets are summed in the JAX module's order.  Each offset
    reads views of one wrap-padded copy of p and of the guide (what
    jnp.roll would shift into place), and the weight sum is kept per pixel,
    not per slice.
    """
    h, w = p.shape[-2:]
    half = wnd // 2
    sig_sp = wnd / 2.0
    # f32 constants and the spatial term's product in f32, as the JAX
    # module computes them
    inv_sp2 = np.float32(1.0 / (sig_sp * sig_sp))
    inv_clr2 = float(np.float32(1.0 / (sig_clr * sig_clr)))
    color = guide.dim() == 3
    rows = torch.remainder(torch.arange(-half, h + half, device=p.device), h)
    cols = torch.remainder(torch.arange(-half, w + half, device=p.device), w)
    p_pad = p.index_select(-2, rows).index_select(-1, cols)
    g_pad = guide.index_select(0, rows).index_select(1, cols)
    s = torch.zeros_like(p)
    sw = torch.zeros((h, w), dtype=p.dtype, device=p.device)
    for o in range(wnd * wnd):
        dy = o // wnd - half
        dx = o % wnd - half
        # out[y, x] reads in[(y + dy) % h, (x + dx) % w]
        y0, x0 = half + dy, half + dx
        q_guide = g_pad[y0:y0 + h, x0:x0 + w]
        diff = torch.abs(q_guide - guide)
        clr = diff.mean(dim=-1) if color else diff
        sp = float(-np.float32(dx * dx + dy * dy) * inv_sp2)
        wgt = torch.exp(sp - clr * clr * inv_clr2)
        s.addcmul_(wgt, p_pad[..., y0:y0 + h, x0:x0 + w])
        sw += wgt
    return s / sw


def _filter_inner_slices(vol: torch.Tensor, fn) -> torch.Tensor:
    """fn over slices 1..D-2 of an [H, W, D] volume (all at once, as
    [D-2, H, W]); slices 0 and D-1 pass through."""
    d = vol.shape[-1]
    if d <= 2:
        return vol
    inner = fn(vol[..., 1:d - 1].permute(2, 0, 1))
    return torch.cat([vol[..., :1], inner.permute(1, 2, 0),
                      vol[..., d - 1:]], dim=-1)


def box_filter_volume(vol: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """BoxCA: the 7x7 box sum of each inner slice."""
    return _filter_inner_slices(vol, lambda x: box_filter(x, radius))


def guided_filter_volume(vol: torch.Tensor, guide_u8: torch.Tensor,
                         radius: int = 9, eps: float = 1e-4) -> torch.Tensor:
    """GFCA: the guided filter of each inner slice, the view's colour image
    as the guide."""
    guide = guide_u8.to(vol.dtype) / 255.0
    return _filter_inner_slices(
        vol, lambda x: guided_filter(guide, x, radius=radius, eps=eps))


def bilateral_filter_volume(vol: torch.Tensor, guide_u8: torch.Tensor,
                            wnd: int = 35,
                            sig_clr: float = 0.03) -> torch.Tensor:
    """BFCA: the wnd x wnd joint bilateral of each inner slice."""
    guide = guide_u8.to(vol.dtype) / 255.0
    return _filter_inner_slices(
        vol, lambda x: bilateral_filter(guide, x, wnd=wnd, sig_clr=sig_clr))


def median_filter_u8(img: torch.Tensor, radius: int) -> torch.Tensor:
    """The (2r+1)^2 median of a u8 image (or of each channel of u8[H, W, C])
    with replicate borders: an 8-step binary search over intensity, each
    step counting the window pixels <= the probe value."""
    if img.dim() == 3:
        return torch.stack([median_filter_u8(img[..., c], radius)
                            for c in range(img.shape[-1])], dim=-1)
    h, w = img.shape
    wnd = 2 * radius + 1
    dev = img.device
    rows = torch.clamp(torch.arange(-radius, h + radius, device=dev), 0,
                       h - 1)
    cols = torch.clamp(torch.arange(-radius, w + radius, device=dev), 0,
                       w - 1)
    pad = img.to(torch.int32)[rows][:, cols]
    half = (wnd * wnd + 1) // 2

    def count_le(mid):
        acc = torch.zeros((h, w), dtype=torch.int32, device=dev)
        for dy in range(wnd):
            for dx in range(wnd):
                acc = acc + (pad[dy:dy + h, dx:dx + w] <= mid)
        return acc

    lo = torch.zeros((h, w), dtype=torch.int32, device=dev)
    hi = torch.full((h, w), 255, dtype=torch.int32, device=dev)
    for _ in range(8):
        mid = (lo + hi) >> 1
        ge = count_le(mid) >= half
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    return lo.to(torch.uint8)
