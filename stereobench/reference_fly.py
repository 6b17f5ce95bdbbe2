"""Plain reference of what the stereo engine returns for one pair on its
no-volume path (precompute_volume false, GRD, fly_lerp "cost"), in plain
PyTorch, written from the method's description and independent of the
program: it imports nothing of it, only the shared steps of
stereobench.reference.

The no-volume plane cost is the GRD plane cost of PatchMatch Stereo
(Bleyer et al., BMVC 2011; the reference's GrdPC / CSPC) with the window
sample's cost lerped between GRD's truncated colour-plus-gradient cost at
the two integer disparities around the plane.  It departs from
stereobench.reference in two places:

  * the slice costs are computed in the compute dtype from the level's u8
    views and not rounded through a stored dtype: the engine stores no
    volume on this path (the configuration's vol_dtype is unused).  This
    module builds the float volume of those slice costs
    (reference.grd_volumes) only as its own way to compute them.  `store`,
    when given, rounds each slice cost to that dtype before the window
    reads it (a control);
  * outside [1, max_dis) a window sample costs alpha * tau_clr +
    (1 - alpha) * tau_grd, the most a GRD slice cost can be (GrdPC's own
    constant, grd_pc.cc:118-123), not the volume's maximum: without a
    volume there is no maximum to take.

With use_cs the levels are the 5-tap pyramid's (reference.pyr_down), each
level's range max_dis >> s, and the levels' costs are summed with the
closed-form scale weights, as in stereobench.reference.  The disparity
maps, the left-right check, the fill and the weighted median are
stereobench.reference's (reference.maps).
"""

from __future__ import annotations

import torch

from . import reference as ref

# the controls (name -> (compute, store)): all arithmetic in bfloat16, and
# float32 arithmetic with each slice cost rounded to bfloat16 (the fly path
# moved onto a bf16 volume)
CONTROLS = {"bf16": (torch.bfloat16, None),
            "bf16_slices": (torch.float32, torch.bfloat16)}


def check_engine(engine: dict) -> None:
    """Raise ValueError on a configuration this reference does not cover."""
    if engine["precompute_volume"]:
        raise ValueError("this reference covers the no-volume path only "
                         "(stereobench.reference covers the volume path)")
    if engine["cost_method"] != "GRD" or engine["fly_lerp"] != "cost":
        raise ValueError("this reference covers the GRD cost lerped in cost "
                         "space (fly_lerp 'cost') only")
    if engine["aggregator"] != "NONE" or engine["use_lab_weights"]:
        raise ValueError("this reference covers no aggregation filter and "
                         "no Lab weights")


def saturation(e: dict) -> float:
    """The cost of an out-of-range window sample: alpha * tau_clr +
    (1 - alpha) * tau_grd (grd_pc.cc:118-123)."""
    return e["cost_alpha"] * e["tau_clr"] \
        + (1.0 - e["cost_alpha"]) * e["tau_grd"]


def plane_cost(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
               e: dict, compute: torch.dtype,
               store: torch.dtype | None = None) -> torch.Tensor:
    """f32[2, H, W]: each view's no-volume cost of its planes f32[2, H, W,
    3], from the u8 BGR views [H, W, 3]."""
    check_engine(e)
    n = e["scale_num"] if e["use_cs"] else 1
    wgts = ref.scale_weights(n, e["reg_lambda"]) if e["use_cs"] else None
    sat = torch.tensor(saturation(e), dtype=torch.float32,
                       device=abc.device)
    totals = [None, None]
    l, r, md = l_bgr, r_bgr, e["max_dis"]
    for s in range(n):
        if s:
            l, r = ref.pyr_down(l), ref.pyr_down(r)
            md //= 2
        vol = ref.grd_volumes(l, r, md, e, compute)
        if store is not None:
            vol = vol.to(store).to(compute)
        for v, img in enumerate((l, r)):
            c = ref.level_cost(img, vol[v], sat, abc[v], s,
                               e["wnd_size"] // 2, md, e["wgt_gamma"],
                               compute)
            if wgts is not None:
                c = wgts[s] * c
            totals[v] = c if totals[v] is None else totals[v] + c
        del vol
    return torch.stack(totals).float()


def outputs(l_bgr: torch.Tensor, r_bgr: torch.Tensor, abc: torch.Tensor,
            e: dict, compute: torch.dtype = torch.float32,
            store: torch.dtype | None = None) -> dict:
    """What the engine returns for this pair and these planes: "cost"
    f32[2, H, W], "dis" u8[2, H, W], "valid" bool[2, H, W]."""
    cost = plane_cost(l_bgr, r_bgr, abc, e, compute, store)
    return dict(cost=cost, **ref.maps(l_bgr, r_bgr, abc, e, compute))
