"""Plain reference of what the stereo engine returns for one pair on its
volume path with the bilateral aggregation filter (aggregator "BF"), in
plain PyTorch, written from the method's description and independent of
the program: it imports nothing of it, only the shared steps of
stereobench.reference.

The filter is the BF aggregator of the cross-scale framework (Zhang et
al., Cross-Scale Cost Aggregation for Stereo Matching, CVPR 2014; the
reference's CSPM/ca_filter/BFCA.cpp and BilateralFilter.cpp): every inner
slice d = 1 .. D - 2 of a view's cost volume is replaced by its joint
bilateral filter over a wnd x wnd window (wnd the configuration's
wnd_size), guided by the view's colour image in [0, 1] (u8 / 255), with

    weight(p, q) = exp(-|p - q|^2 / sig_sp^2 - clr(p, q)^2 / sig_clr^2),

sig_sp = wnd / 2, sig_clr = 0.03, clr the mean over the three channels of
the absolute guide difference, and the window wrapping around the image's
borders; out(p) = sum_q weight(p, q) vol(q) / sum_q weight(p, q).  Slices
0 and D - 1 pass through.

Everything else is stereobench.reference's: the volumes
(reference.grd_volumes or reference.census_volumes, and the 5-tap
pyramid with use_cs) are built as there, each level's two volumes are
filtered here before the saturation value (the filtered volume's
maximum) is taken, the filtered volume is rounded through the stored
dtype (the configuration's vol_dtype) before the window cost reads it,
and the plane cost (reference.level_cost, the closed-form scale weights)
and the maps (reference.maps) are reference.py's.

Departures, each within f32 rounding of the description: the window's
offsets are summed row by row, dy outer and dx inner (BilateralFilter's
own loop order), each product of a weight and a slice value rounded and
then added; each weight's exponent is formed in the compute dtype from
the f32 constants 1 / sig_sp^2 and 1 / sig_clr^2; the guide's division by
255 and the colour mean are the compute dtype's own.  The filtered volume
is rounded through the stored dtype before the window cost reads it, so a
filtered value one ulp off a program's, which another sound f32 order of
the sums gives, moves a tap by a whole bf16 step: the configuration's
cost_gap limit leaves room for that, not for one order alone.
"""

from __future__ import annotations

import torch

from . import reference as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIG_CLR = 0.03
# the controls (name -> (compute, store)): all arithmetic in bfloat16, and
# float32 arithmetic on a filtered volume stored in float8 e4m3
CONTROLS = {"bf16": (torch.bfloat16, torch.bfloat16),
            "fp8_volume": (torch.float32, torch.float8_e4m3fn)}


def store_dtype(engine: dict) -> torch.dtype:
    return ref.store_dtype(engine)


def check_engine(engine: dict) -> None:
    """Raise ValueError on a configuration this reference does not cover."""
    if not engine["precompute_volume"]:
        raise ValueError("this reference covers the volume path only")
    if engine["aggregator"] != "BF":
        raise ValueError("this reference covers the BF aggregator only "
                         "(stereobench.reference covers no filter)")
    if engine["use_lab_weights"]:
        raise ValueError("this reference covers no Lab weights")
    if engine["cost_method"] not in ("GRD", "CEN"):
        raise ValueError(f"unknown cost method {engine['cost_method']}")


def bilateral_filter_volume(vol: torch.Tensor, guide_u8: torch.Tensor,
                            wnd: int, dt: torch.dtype,
                            sig_clr: float = SIG_CLR) -> torch.Tensor:
    """The wnd x wnd joint bilateral filter of the inner slices of one
    view's volume [H, W, D] (in dt), guided by its u8[H, W, 3] image, the
    window wrapping around the borders; slices 0 and D - 1 as they are."""
    h, w, d = vol.shape
    if d <= 2:
        return vol
    half = wnd // 2
    inv_sp2 = torch.tensor(1.0 / (wnd / 2.0) ** 2, dtype=torch.float32)
    inv_clr2 = torch.tensor(1.0 / sig_clr ** 2, dtype=torch.float32)
    inv_sp2, inv_clr2 = (c.to(dt).to(vol.device) for c in (inv_sp2,
                                                           inv_clr2))
    guide = guide_u8.to(dt) / 255.0
    inner = vol[..., 1:d - 1].to(dt)
    num = torch.zeros_like(inner)
    den = torch.zeros((h, w, 1), dtype=dt, device=vol.device)
    for dy in range(-half, wnd - half):
        for dx in range(-half, wnd - half):
            # out(y, x) reads (y + dy, x + dx), wrapped
            shift = (-dy, -dx)
            clr = (torch.roll(guide, shift, (0, 1)) - guide).abs().mean(
                -1, keepdim=True)
            wgt = torch.exp(-(dy * dy + dx * dx) * inv_sp2
                            - clr * clr * inv_clr2)
            num += wgt * torch.roll(inner, shift, (0, 1))
            den += wgt
    return torch.cat([vol[..., :1].to(dt), num / den, vol[..., d - 1:]
                      .to(dt)], -1)


def levels(l_bgr: torch.Tensor, r_bgr: torch.Tensor, e: dict,
           compute: torch.dtype, store: torch.dtype) -> ref.Levels:
    """stereobench.reference's per-level data with each level's volumes
    filtered: the saturation value the filtered volume's maximum, the
    filtered volume rounded through `store`."""
    check_engine(e)
    lv = ref.Levels(l_bgr, r_bgr, dict(e, aggregator="NONE"), compute,
                    compute)
    for s, (img, vol) in enumerate(zip(lv.imgs, lv.vols)):
        filt = torch.stack([bilateral_filter_volume(vol[v], img[v],
                                                    e["wnd_size"], compute)
                            for v in range(2)])
        lv.max_costs[s] = filt.float().amax(dim=(1, 2, 3))
        lv.vols[s] = filt.to(store).to(compute)
        del filt
    return lv


def outputs(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
            e: dict, compute: torch.dtype = torch.float32,
            store: torch.dtype | None = None) -> dict:
    """What the engine returns for this pair and these planes: "cost"
    f32[2, H, W], "dis" u8[2, H, W], "valid" bool[2, H, W]."""
    store = store_dtype(e) if store is None else store
    lv = levels(l_bgr, r_bgr, e, compute, store)
    cost = ref.plane_cost(lv, abc, e, compute)
    del lv
    return dict(cost=cost, **ref.maps(l_bgr, r_bgr, abc, e, compute))
