"""Plain reference of what the stereo engine returns for one pair, in plain
PyTorch, written from the method's description and independent of the
program: it imports nothing of it.

Given the two u8 BGR views and the plane field f32[2, H, W, 3] that the
program returned, it works out again:

  * the cost volumes, from the u8 views: GRD (truncated colour and x-
    gradient differences, a pseudo-intensity beyond the border) or census
    (the 5-tap Gaussian pyramid, 8-bit gray, wrap-around census codes,
    Hamming distances), both views referenced, d in [0, max_dis];
  * the plane cost of each pixel's returned plane: the adaptive-support-
    weight window sum of the two-tap lerp of the stored volume along the
    plane, the volume's maximum outside [1, max_dis), summed over the
    pyramid's levels with the closed-form inter-scale weights when
    use_cs;
  * the u8 disparity maps of the planes, and with use_pp the left-right
    check (`valid`), the fill from the nearest valid planes of the row and
    the colour-weighted median at the invalid pixels (`dis`).

`compute` is the dtype of the arithmetic (float32 as the configuration
states; a lower one makes the control) and `store` the dtype the volume
is rounded to before the window cost reads it (the configuration's
vol_dtype; the saturation value is the maximum of the unrounded volume).
"""

from __future__ import annotations

import numpy as np
import torch

N_LEVELS = 256
_STORE = {"f32": torch.float32, "bf16": torch.bfloat16}
# the controls (name -> (compute, store)): all arithmetic in bfloat16, and
# float32 arithmetic on a volume stored in float8 e4m3
CONTROLS = {"bf16": (torch.bfloat16, torch.bfloat16),
            "fp8_volume": (torch.float32, torch.float8_e4m3fn)}


def store_dtype(engine: dict) -> torch.dtype:
    return _STORE[engine["vol_dtype"]]


def check_engine(engine: dict) -> None:
    """Raise ValueError on a configuration this reference does not cover."""
    if not engine["precompute_volume"]:
        raise ValueError("the reference covers the volume path only")
    if engine["aggregator"] != "NONE" or engine["use_lab_weights"]:
        raise ValueError("the reference covers no aggregation filter and "
                         "no Lab weights")
    if engine["cost_method"] not in ("GRD", "CEN"):
        raise ValueError(f"unknown cost method {engine['cost_method']}")


# --- volumes ---------------------------------------------------------------

def _sobel_x(gray: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(gray)
    if gray.shape[-1] > 2:
        out[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    return out


def grd_volumes(l_bgr: torch.Tensor, r_bgr: torch.Tensor, max_dis: int,
                e: dict, dt: torch.dtype) -> torch.Tensor:
    """[2, H, W, max_dis + 1]: the left-referenced volume (other view at
    x - d) and the right-referenced one (other view at x + d)."""
    rgb = [v.flip(-1).to(dt) for v in (l_bgr, r_bgr)]
    grad = [_sobel_x(0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2])
            for c in rgb]
    alpha, tau_c, tau_g = e["cost_alpha"], e["tau_clr"], e["tau_grd"]
    border = e["border_thres"]

    def mix(clr, grd):
        return (alpha * torch.clamp(clr, max=tau_c)
                + (1.0 - alpha) * torch.clamp(grd, max=tau_g))

    w = rgb[0].shape[1]
    vols = []
    for ref, oth, sign in ((0, 1, -1), (1, 0, 1)):
        c, g = rgb[ref], grad[ref]
        out_cost = mix((c - border).abs().sum(-1) / 3.0, (g - border).abs())
        slices = []
        for d in range(max_dis + 1):
            s = out_cost.clone()
            if d < w:
                if sign < 0:   # x - d, defined for x >= d
                    cs, gs, co, go = c[:, d:], g[:, d:], rgb[oth][:, :w - d], \
                        grad[oth][:, :w - d]
                    dst = s[:, d:]
                else:          # x + d, defined for x < w - d
                    cs, gs, co, go = c[:, :w - d], g[:, :w - d], \
                        rgb[oth][:, d:], grad[oth][:, d:]
                    dst = s[:, :w - d]
                dst.copy_(mix((cs - co).abs().sum(-1) / 3.0, (gs - go).abs()))
            slices.append(s)
        vols.append(torch.stack(slices, -1))
    return torch.stack(vols)


def pyr_down(img_u8: torch.Tensor) -> torch.Tensor:
    """5-tap (1, 4, 6, 4, 1) / 16 blur on both axes with a reflect-101
    border, the even rows and columns kept, rounded half to even."""
    x = img_u8.to(torch.float32)
    for dim in (0, 1):
        n = x.shape[dim]
        idx = torch.arange(-2, n + 2, device=x.device).abs()
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
        xp = x.index_select(dim, idx)
        x = sum(k / 16.0 * xp.narrow(dim, i, n)
                for i, k in enumerate((1, 4, 6, 4, 1)))
    return torch.clamp(torch.round(x[::2, ::2]), 0, 255).to(torch.uint8)


def census_bits(gray: torch.Tensor, wnd: int) -> torch.Tensor:
    """bool[wnd * wnd - 1, H, W]: center > neighbour for each window offset
    in row-major order without the center, the window wrapping around."""
    half = wnd // 2
    g = gray.to(torch.int32)
    bits = []
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            if dy == 0 and dx == 0:
                continue
            bits.append(g > torch.roll(g, (-dy, -dx), (0, 1)))
    return torch.stack(bits)


def census_volumes(l_bgr: torch.Tensor, r_bgr: torch.Tensor, max_dis: int,
                   wnd: int) -> torch.Tensor:
    """[2, H, W, max_dis + 1] Hamming distances between the census codes of
    the 8-bit gray views (wnd * wnd - 1 beyond the border)."""
    codes = []
    for v in (l_bgr, r_bgr):
        p = v.to(torch.int32)   # BGR
        gray = (p[..., 2] * 4899 + p[..., 1] * 9617 + p[..., 0] * 1868
                + (1 << 13)) >> 14
        codes.append(census_bits(gray, wnd))
    nbits, h, w = codes[0].shape
    vols = []
    for ref, oth, sign in ((0, 1, -1), (1, 0, 1)):
        out = torch.full((h, w, max_dis + 1), float(nbits),
                         device=l_bgr.device)
        for d in range(min(max_dis + 1, w)):
            if sign < 0:
                ham = (codes[ref][:, :, d:] != codes[oth][:, :, :w - d]).sum(0)
                out[:, d:, d] = ham.to(torch.float32)
            else:
                ham = (codes[ref][:, :, :w - d] != codes[oth][:, :, d:]).sum(0)
                out[:, :w - d, d] = ham.to(torch.float32)
        vols.append(out)
    return torch.stack(vols)


def scale_weights(n: int, lam: float) -> list:
    """Row 0 of (I + lam * L)^-1, L the path graph's Laplacian over the n
    levels (the closed form of the cross-scale objective)."""
    m = np.eye(n) * (1.0 + 2.0 * lam)
    m[0, 0] = m[-1, -1] = 1.0 + lam
    for s in range(n - 1):
        m[s, s + 1] = m[s + 1, s] = -lam
    return [float(x) for x in np.linalg.inv(m)[0].astype(np.float32)]


class Levels:
    """The per-level data of one pair: BGR u8 images [2, Hs, Ws, 3], the
    float32 volumes' maxima f32[2] and the volumes as the window cost reads
    them (`store`)."""

    def __init__(self, l_bgr: torch.Tensor, r_bgr: torch.Tensor, e: dict,
                 compute: torch.dtype, store: torch.dtype):
        check_engine(e)
        n = e["scale_num"] if e["use_cs"] else 1
        ls, rs = [l_bgr], [r_bgr]
        for _ in range(n - 1):
            ls.append(pyr_down(ls[-1]))
            rs.append(pyr_down(rs[-1]))
        self.imgs, self.vols, self.max_costs = [], [], []
        md = e["max_dis"]
        for l, r in zip(ls, rs):
            if e["cost_method"] == "GRD":
                vol = grd_volumes(l, r, md, e, compute)
            else:
                vol = census_volumes(l, r, md, e["census_wnd"])
            self.imgs.append(torch.stack([l, r]))
            self.max_costs.append(vol.float().amax(dim=(1, 2, 3)))
            # rounded through the stored type, read in the compute type
            self.vols.append(vol.to(store).to(compute))
            md //= 2


# --- the plane cost ----------------------------------------------------------

def level_cost(img: torch.Tensor, vol: torch.Tensor, max_cost: torch.Tensor,
               abc: torch.Tensor, s: int, half_wnd: int, max_dis: int,
               gamma: float, dt: torch.dtype) -> torch.Tensor:
    """[H, W] window cost of each fine pixel's plane on level s: the window
    centres at (y >> s, x >> s), the plane's disparity is scaled by 2^-s
    and the range test takes the level's max_dis."""
    hs, ws, depth = vol.shape
    h, w, _ = abc.shape
    dev = abc.device
    abc = abc.to(dt)
    a, b = abc[..., 0], abc[..., 1]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    cy, cx = ys >> s, xs >> s
    d_c = a * xs.to(dt) + b * ys.to(dt) + abc[..., 2]
    if s:
        d_c = d_c * (1.0 / (1 << s))
    pix = img.to(torch.int32).reshape(-1, 3)
    flat = vol.reshape(-1)
    c_pix = pix[cy * ws + cx]
    inv_g = torch.tensor(1.0 / gamma, dtype=torch.float32).to(dt)
    offs = torch.arange(-half_wnd, half_wnd + 1, device=dev)
    qx = cx[None] + offs[:, None, None]                       # [n, 1, W]
    x_ok = (qx >= 0) & (qx < ws)
    qx = qx.clamp(0, ws - 1)
    a_dx = a[None] * offs.to(dt)[:, None, None]              # [n, H, W]
    acc = torch.zeros((h, w), dtype=dt, device=dev)
    for dy in range(-half_wnd, half_wnd + 1):
        qy = cy + dy
        ok = x_ok & ((qy >= 0) & (qy < hs))[None]
        pos = qy.clamp(0, hs - 1) * ws + qx                   # [n, H, W]
        l1 = (pix[pos] - c_pix[None]).abs().sum(-1)
        wgt = torch.exp(-l1.to(dt) * inv_g)
        dq = d_c[None] + a_dx + b[None] * dy
        in_range = (dq >= 1.0) & (dq < float(max_dis))
        f = torch.where(in_range, dq, 0.0).trunc().long()
        v0 = flat[pos * depth + f].to(dt)
        v1 = flat[pos * depth + torch.clamp(f + 1, max=depth - 1)].to(dt)
        fw = (f + 1).to(dt) - dq
        val = torch.where(in_range, fw * v0 + (1.0 - fw) * v1,
                          max_cost.to(dt))
        acc = acc + torch.where(ok, wgt * val, 0.0).sum(0)
    return acc


def plane_cost(lv: Levels, abc: torch.Tensor, e: dict,
               dt: torch.dtype) -> torch.Tensor:
    """f32[2, H, W]: each view's cost of its planes."""
    n = len(lv.vols)
    wgts = scale_weights(n, e["reg_lambda"]) if e["use_cs"] else None
    out = []
    for v in range(2):
        total, md = None, e["max_dis"]
        for s in range(n):
            c = level_cost(lv.imgs[s][v], lv.vols[s][v], lv.max_costs[s][v],
                           abc[v], s, e["wnd_size"] // 2, md,
                           e["wgt_gamma"], dt)
            if wgts is not None:
                c = wgts[s] * c
            total = c if total is None else total + c
            md //= 2
        out.append(total)
    return torch.stack(out).float()


# --- disparity maps and post-processing ---------------------------------------

def _disp(abc: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    h, w = abc.shape[-3:-1]
    abc = abc.to(dt)
    ys = torch.arange(h, device=abc.device, dtype=dt)[:, None]
    xs = torch.arange(w, device=abc.device, dtype=dt)[None, :]
    return abc[..., 0] * xs + abc[..., 1] * ys + abc[..., 2]


def to_u8(d: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.clamp(torch.round(d * scale), 0, 255).to(torch.uint8)


def lr_check(dis: torch.Tensor, e: dict, dt: torch.dtype) -> torch.Tensor:
    """bool[2, H, W]: d > 0 and the other view, at the column this pixel's
    rounded disparity points to, within lr_check_thres of it."""
    _, h, w = dis.shape
    d = dis.to(dt) / e["dis_scale"]
    xs = torch.arange(w, device=dis.device)[None, :]
    out = []
    for v, sign in ((0, -1), (1, 1)):
        ox = xs + sign * torch.round(d[v]).long()
        inside = (ox >= 0) & (ox < w)
        other = torch.gather(d[1 - v], 1, ox.clamp(0, w - 1))
        out.append(inside & ((d[v] - other).abs() <= e["lr_check_thres"])
                   & (d[v] > 0))
    return torch.stack(out)


def fill(dis: torch.Tensor, abc: torch.Tensor, valid: torch.Tensor, e: dict,
         dt: torch.dtype) -> torch.Tensor:
    """Each invalid pixel takes the smaller of the disparities that the
    planes of the nearest valid pixels to its left and right give at it
    (the one that exists if only one does)."""
    _, h, w = dis.shape
    xs = torch.arange(w, device=dis.device)[None, :].expand(h, w)
    out = []
    for v in range(2):
        left = torch.cummax(torch.where(valid[v], xs, -1), 1).values
        right = torch.cummin(torch.where(valid[v], xs, w).flip(1),
                             1).values.flip(1)
        got_l, got_r = left >= 0, right < w

        def at(col):
            i = col.clamp(0, w - 1)[..., None].expand(h, w, 3)
            return _disp(torch.gather(abc[v], 1, i), dt)

        dl, dr = at(left), at(right)
        d = torch.where(got_l & got_r, torch.minimum(dl, dr),
                        torch.where(got_l, dl, dr))
        filled = torch.clamp(e["dis_scale"] * torch.round(d), 0,
                             255).to(torch.uint8)
        out.append(torch.where(~valid[v] & (got_l | got_r), filled, dis[v]))
    return torch.stack(out)


def weighted_median(dis: torch.Tensor, imgs: torch.Tensor,
                    valid: torch.Tensor, e: dict,
                    dt: torch.dtype) -> torch.Tensor:
    """At each invalid pixel, the smallest t with S(t) >= S(255) / 2, S(t)
    the sum, in window order (rows, then columns), of the colour weights
    exp(-L1 / wmf_gamma) of the valid window pixels whose disparity is at
    most t; pixels whose window holds no valid pixel keep their value."""
    _, h, w = dis.shape
    half = e["wnd_size"] // 2
    dev = dis.device
    inv_g = torch.tensor(1.0 / e["wmf_gamma"], dtype=torch.float32).to(dt)
    levels = torch.arange(N_LEVELS, device=dev)
    offs = torch.arange(-half, half + 1, device=dev)
    out = dis.clone()
    for v in range(2):
        ys, xs = torch.nonzero(~valid[v], as_tuple=True)
        if ys.numel() == 0:
            continue
        img = imgs[v].to(torch.int32)
        dv = dis[v].long()
        qx = xs[:, None] + offs[None, :]
        x_ok = (qx >= 0) & (qx < w)
        qx = qx.clamp(0, w - 1)
        centre = img[ys, xs][:, None]
        acc = torch.zeros((ys.numel(), N_LEVELS), dtype=dt, device=dev)
        for dy in range(-half, half + 1):
            qy = ys[:, None] + dy
            ok = x_ok & (qy >= 0) & (qy < h)
            qy = qy.clamp(0, h - 1)
            l1 = (img[qy, qx] - centre).abs().sum(-1)
            wgt = torch.exp(-l1.to(dt) * inv_g) * (ok & valid[v][qy, qx])
            le = dv[qy, qx]
            for j in range(len(offs)):
                acc += wgt[:, j, None] * (le[:, j, None] <= levels)
        half_total = acc[:, -1] * 0.5
        med = (acc < half_total[:, None]).sum(-1).to(torch.uint8)
        keep = half_total > 0
        out[v, ys[keep], xs[keep]] = med[keep]
    return out


def maps(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
         e: dict, compute: torch.dtype) -> dict:
    """The maps the engine returns for these planes: "dis" u8[2, H, W] and
    "valid" bool[2, H, W] (with use_pp the left-right check, the fill and
    the weighted median; else all valid)."""
    dis = to_u8(_disp(abc, compute), e["dis_scale"])
    if not e["use_pp"]:
        return {"dis": dis, "valid": torch.ones_like(dis, dtype=torch.bool)}
    valid = lr_check(dis, e, compute)
    dis = fill(dis, abc, valid, e, compute)
    imgs = torch.stack([l_bgr, r_bgr])
    return {"dis": weighted_median(dis, imgs, valid, e, compute),
            "valid": valid}


def outputs(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
            e: dict, compute: torch.dtype = torch.float32,
            store: torch.dtype | None = None) -> dict:
    """What the engine returns for this pair and these planes: "cost"
    f32[2, H, W], "dis" u8[2, H, W], "valid" bool[2, H, W]."""
    store = store_dtype(e) if store is None else store
    lv = Levels(l_bgr, r_bgr, e, compute, store)
    cost = plane_cost(lv, abc, e, compute)
    del lv
    return dict(cost=cost, **maps(l_bgr, r_bgr, abc, e, compute))
