"""Plain reference of what the stereo engine returns for one pair on its
no-volume path with PatchMatch Stereo's own data term (precompute_volume
false, GRD, fly_lerp "image"), in plain PyTorch, written from the method's
description and independent of the program: it imports nothing of it,
only the shared steps of stereobench.reference.

The data term is GrdPC's (Bleyer et al., BMVC 2011; the reference's
plane_cost/grd_pc.cc:71-178).  At each window sample q of a pixel's window
the plane gives the disparity dq = a * q_x + b * q_y + c, and f =
trunc(dq):

  * a sample outside 1 <= f <= max_dis - 1 costs alpha * tau_clr +
    (1 - alpha) * tau_grd (grd_pc.cc:118-123);
  * otherwise the other view is read at the fractional column other_x =
    q_x - dq (left view) or q_x + dq (right view): its two tap columns
    trunc(other_x) and trunc(other_x) + 1 (C's truncation towards zero,
    so the floor tap's weight (trunc(other_x) + 1) - other_x exceeds 1
    when other_x is negative), each wrapped once by +-W where it falls
    past the border (HandleBorder, commfunc.h:129-145; grd_pc.cc:153-154),
    and its BGR and x-gradient are lerped there (grd_pc.cc:149-171);
  * the sample costs alpha * min(mean_c |I_q - lerp(I_other)|, tau_clr) +
    (1 - alpha) * min(|G_q - lerp(G_other)|, tau_grd), G the x-Sobel
    (ksize 1) of the level's BT.601 gray, weighted by
    stereobench.reference's adaptive-support weight;
  * window samples outside the image are skipped (grd_pc.cc:86,103).

Departures from GrdPC, each one the program's as well:

  * the arithmetic is float32 (GrdPC's is double) and the weight is
    exp(-L1 / gamma) at the integer L1 distance, where GrdPC reads a
    1000-entry table of the same values;
  * with use_cs the levels are the 5-tap pyramid's (reference.pyr_down),
    each level's range max_dis >> s and disparity scaled by 2^-s, and the
    levels' costs summed with the closed-form scale weights (CSPC,
    cspc.cc:107-182), as in stereobench.reference.

The disparity maps, the left-right check, the fill and the weighted median
are stereobench.reference's (reference.maps).  `compute` is the dtype of
the arithmetic; `store`, when given, is a dtype each lerped tap (colour
and gradient) is rounded to before the cost takes it (a control).
"""

from __future__ import annotations

import torch

from . import reference as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the controls (name -> (compute, store)): all arithmetic in bfloat16, and
# float32 arithmetic with each lerped tap rounded to bfloat16
CONTROLS = {"bf16": (torch.bfloat16, None),
            "bf16_taps": (torch.float32, torch.bfloat16)}


def check_engine(engine: dict) -> None:
    """Raise ValueError on a configuration this reference does not cover."""
    if engine["precompute_volume"]:
        raise ValueError("this reference covers the no-volume path only "
                         "(stereobench.reference covers the volume path)")
    if engine["cost_method"] != "GRD" or engine["fly_lerp"] != "image":
        raise ValueError("this reference covers GrdPC's data term lerped in "
                         "image space (fly_lerp 'image') only "
                         "(stereobench.reference_fly covers 'cost')")
    if engine["aggregator"] != "NONE" or engine["use_lab_weights"]:
        raise ValueError("this reference covers no aggregation filter and "
                         "no Lab weights")


def saturation(e: dict) -> float:
    """The cost of an out-of-range window sample: alpha * tau_clr +
    (1 - alpha) * tau_grd (grd_pc.cc:118-123)."""
    return e["cost_alpha"] * e["tau_clr"] \
        + (1.0 - e["cost_alpha"]) * e["tau_grd"]


def gradient(bgr_u8: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """[H, W]: the x-Sobel (ksize 1) of the BT.601 gray of a u8 BGR view
    (grd_pc.cc:37-41), as stereobench.reference's GRD volume takes it."""
    c = bgr_u8.flip(-1).to(dt)
    return ref._sobel_x(0.299 * c[..., 0] + 0.587 * c[..., 1]
                        + 0.114 * c[..., 2])


def handle_border(x: torch.Tensor, n: int) -> torch.Tensor:
    """x wrapped once by +-n (commfunc.h:129-145)."""
    return torch.where(x < 0, x + n, torch.where(x >= n, x - n, x))


def level_cost(img: torch.Tensor, oth: torch.Tensor, abc: torch.Tensor,
               s: int, e: dict, max_dis: int, sign: int, dt: torch.dtype,
               store: torch.dtype | None) -> torch.Tensor:
    """[H, W] window cost of each fine pixel's plane on level s: img / oth
    the level's u8 BGR views [Hs, Ws, 3] of this view and the other one,
    the window centred at (y >> s, x >> s), the plane's disparity scaled by
    2^-s, max_dis the level's; sign -1 for the left view (other_x = q_x -
    dq), +1 for the right."""
    hs, ws, _ = img.shape
    h, w, _ = abc.shape
    dev = abc.device
    half_wnd = e["wnd_size"] // 2
    alpha, tau_c, tau_g = e["cost_alpha"], e["tau_clr"], e["tau_grd"]
    abc = abc.to(dt)
    a, b = abc[..., 0], abc[..., 1]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    cy, cx = ys >> s, xs >> s
    d_c = a * xs.to(dt) + b * ys.to(dt) + abc[..., 2]
    if s:
        d_c = d_c * (1.0 / (1 << s))
    pix = img.to(torch.int32).reshape(-1, 3)
    q_clr = img.to(dt).reshape(-1, 3)
    q_grd = gradient(img, dt).reshape(-1)
    o_clr = oth.to(dt).reshape(-1, 3)
    o_grd = gradient(oth, dt).reshape(-1)
    c_pix = pix[cy * ws + cx]
    inv_g = torch.tensor(1.0 / e["wgt_gamma"], dtype=torch.float32).to(dt)
    sat = torch.tensor(saturation(e), dtype=torch.float32,
                       device=dev).to(dt)
    offs = torch.arange(-half_wnd, half_wnd + 1, device=dev)
    qx = cx[None] + offs[:, None, None]                       # [n, 1, W]
    x_ok = (qx >= 0) & (qx < ws)
    qx = qx.clamp(0, ws - 1)
    fqx = qx.to(dt)
    a_dx = a[None] * offs.to(dt)[:, None, None]              # [n, H, W]

    def rounded(t):
        return t if store is None else t.to(store).to(dt)

    acc = torch.zeros((h, w), dtype=dt, device=dev)
    for dy in range(-half_wnd, half_wnd + 1):
        qy = cy + dy
        ok = x_ok & ((qy >= 0) & (qy < hs))[None]
        row = qy.clamp(0, hs - 1) * ws
        pos = row + qx                                        # [n, H, W]
        l1 = (pix[pos] - c_pix[None]).abs().sum(-1)
        wgt = torch.exp(-l1.to(dt) * inv_g)
        dq = d_c[None] + a_dx + b[None] * dy
        in_range = (dq >= 1.0) & (dq < float(max_dis))
        other_x = fqx + sign * torch.where(in_range, dq, 1.0)
        f = other_x.trunc()
        fw = (f + 1.0) - other_x
        f = f.long()
        t0 = row + handle_border(f, ws)
        t1 = row + handle_border(f + 1, ws)
        clr = rounded(fw[..., None] * o_clr[t0]
                      + (1.0 - fw[..., None]) * o_clr[t1])
        grd = rounded(fw * o_grd[t0] + (1.0 - fw) * o_grd[t1])
        diff = (q_clr[pos] - clr).abs()
        mean = (diff[..., 0] + diff[..., 1] + diff[..., 2]) / 3.0
        val = (alpha * torch.clamp(mean, max=tau_c) + (1.0 - alpha)
               * torch.clamp((q_grd[pos] - grd).abs(), max=tau_g))
        val = torch.where(in_range, val, sat)
        acc = acc + torch.where(ok, wgt * val, 0.0).sum(0)
    return acc


def plane_cost(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
               e: dict, compute: torch.dtype,
               store: torch.dtype | None = None) -> torch.Tensor:
    """f32[2, H, W]: each view's cost of its planes f32[2, H, W, 3], from
    the u8 BGR views [H, W, 3]."""
    check_engine(e)
    n = e["scale_num"] if e["use_cs"] else 1
    wgts = ref.scale_weights(n, e["reg_lambda"]) if e["use_cs"] else None
    totals = [None, None]
    l, r, md = l_bgr, r_bgr, e["max_dis"]
    for s in range(n):
        if s:
            l, r = ref.pyr_down(l), ref.pyr_down(r)
            md //= 2
        for v, (img, oth) in enumerate(((l, r), (r, l))):
            c = level_cost(img, oth, abc[v], s, e, md, 2 * v - 1, compute,
                           store)
            if wgts is not None:
                c = wgts[s] * c
            totals[v] = c if totals[v] is None else totals[v] + c
    return torch.stack(totals).float()


def outputs(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
            e: dict, compute: torch.dtype = torch.float32,
            store: torch.dtype | None = None) -> dict:
    """What the engine returns for this pair and these planes: "cost"
    f32[2, H, W], "dis" u8[2, H, W], "valid" bool[2, H, W]."""
    cost = plane_cost(l_bgr, r_bgr, abc, e, compute, store)
    return dict(cost=cost, **ref.maps(l_bgr, r_bgr, abc, e, compute))
