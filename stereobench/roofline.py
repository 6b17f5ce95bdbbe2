"""The least time the H100 could take for the work a pair's schedule needs,
counted from the configuration and the frame's shape alone (a frozen copy
of the launch model, the window-sample arithmetic and the fly kernel's
operation count of the program's utils/roofline): the same count whatever
implements the work.

A roofline share is that least time over the measured device time.  The
least time of a launch is the larger of its f32 operations over
F32_FLOP_PER_S (the f32 rate outside the tensor cores) and its bytes over
HBM_BYTES_PER_S, each input byte read once and each output byte written
once.  A kernel moved onto the tensor cores needs another peak here.
"""

from __future__ import annotations

from typing import List, Tuple

# NVIDIA H100 SXM data sheet, 700 W: f32 FLOP/s outside the tensor cores
# and HBM3 bytes/s
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 operations of a window sample: the plane's disparity at the sample (a
# multiply and two adds) and the weighted accumulation (a multiply and an
# add) for every in-image sample; the two-tap lerp ((f + 1) - dq, 1 - fw,
# two multiplies, an add) for an in-range one.  Without the planes every
# in-image sample is counted as in range.
FLOPS_IN_IMAGE = 5
FLOPS_IN_RANGE = 5
# the fly kernel's in-range sample in "cost" mode (K5, K3-fly) adds to the
# lerp two GRD slice costs (the colour sum's multiply by 1/3, |grad diff| (a
# subtract and an abs), two mins, two multiplies, an add: 8 each)
FLY_FLOPS_IN_RANGE = FLOPS_IN_RANGE + 16
# bytes a pixel of a level's view that the fly kernel reads: u8 BGR and the
# f32 gray gradient
FLY_PLANE_BYTES = 3 + 4
_VOL_BYTES = {"f32": 4, "bf16": 2}


def refinement_rounds(e: dict) -> int:
    """Rounds of the halving refinement: z = max_dis / 2, / 4, ... while
    z >= z_stop_thres."""
    n, z = 0, e["max_dis"] / 2.0
    while z >= e["z_stop_thres"]:
        n += 1
        z /= 2.0
    return n


def rank_iters(e: dict) -> int:
    """Leading iterations that adopt on the quadrant ranking."""
    if not (e["adopt_mode"] != "exact" and e["prescreen_mode"] == "volume"
            and e["prescreen_stride"] > 1 and e["precompute_volume"]):
        return 0
    if e["adopt_mode"] == "rank":
        return e["max_iter"]
    return max(0, e["max_iter"] - e["exact_iters"])


def warm_engine(e: dict, warm_iters: int) -> dict:
    """The schedule of a warm-started frame: warm_iters iterations, all
    adopting exactly, entered with a deferred cost."""
    return dict(e, max_iter=warm_iters, adopt_mode="exact")


def plan(e: dict) -> Tuple[List[Tuple[int, int]], float]:
    """(launches, rank_cands): the window-cost launches of one pair as (K
    candidates, window stride), in order, and the candidates ranked on the
    quadrant volumes per pixel and view."""
    stride = max(e["prescreen_stride"], 1)
    volume_rank = e["prescreen_stride"] > 1 and e["prescreen_mode"] == "volume"
    prescreen = e["prescreen_stride"] > 1 and (not e["use_cs"] or volume_rank)
    k_stencil = 4 + (4 if e["far_offsets"] else 0)
    r = refinement_rounds(e)
    if e["batch_refine"]:
        stages = max(1, min(e["refine_stages"], r))
        per = -(-r // stages)
        stage_ks = [min(per, r - s0) for s0 in range(0, r, per)]
    else:
        stage_ks = [1] * r
    n_rank = rank_iters(e)
    n_exact = e["max_iter"] - n_rank
    merge = e["merge_view"] and e["prop_sweeps"] > 0
    defer = e["prop_sweeps"] > 0 and n_exact > 0

    rank_cands = 0.0
    launches: List[Tuple[int, int]] = []
    if n_rank:
        rank_cands += 1
    elif not defer:
        launches.append((1, 1))
    rank_cands += n_rank * (e["prop_sweeps"] * k_stencil + 1 + sum(stage_ks))
    if n_rank and n_exact and not defer:
        launches.append((1, 1))
    for it in range(n_exact):
        for s in range(e["prop_sweeps"]):
            k_extra = (1 if (defer and it == 0 and s == 0) else 0) \
                + (1 if (merge and s == e["prop_sweeps"] - 1) else 0)
            if prescreen:
                if volume_rank:
                    rank_cands += k_stencil
                else:
                    launches.append((k_stencil, stride))
                launches.append((1 + k_extra, 1))
            else:
                launches.append((k_stencil + k_extra, 1))
        if not merge:
            launches.append((1, 1))
        for k in stage_ks:
            if prescreen and k > 1:
                if volume_rank:
                    rank_cands += k
                else:
                    launches.append((k, stride))
                launches.append((1, 1))
            else:
                launches.append((k, 1))
    return launches, rank_cands


def fly_plan(e: dict) -> List[Tuple[int, int]]:
    """The fly kernel's launches of one pair without a volume, as (K,
    window stride): the no-volume path prescreens with the fly kernel itself
    at prescreen_stride when not use_cs (the program's
    models/patchmatch.make_fly_cost_fns), which `plan` counts as the window
    prescreen whatever prescreen_mode says; no launch with a volume."""
    if e["precompute_volume"]:
        return []
    return plan(dict(e, prescreen_mode="window"))[0]


def axis_count(n: int, hw: int, stride: int, s: int) -> int:
    """Sum over the n fine positions p of the offsets o of range(-hw, hw + 1,
    stride) with 0 <= (p >> s) + o < ceil(n / 2^s)."""
    hi = ((n - 1) >> s) + 1
    return sum(sum(0 <= (p >> s) + o < hi
                   for o in range(-hw, hw + 1, stride)) for p in range(n))


def level_shapes(e: dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    """(Hs, Ws, Ds) of each pyramid level the window cost reads."""
    n = e["scale_num"] if e["use_cs"] else 1
    return [(((h - 1) >> s) + 1, ((w - 1) >> s) + 1, (e["max_dis"] >> s) + 1)
            for s in range(n)]


def in_image_samples(e: dict, h: int, w: int, stride: int) -> int:
    """In-image window samples of one candidate field of both views at a
    window stride, over every level the window cost reads."""
    hw = e["wnd_size"] // 2
    return 2 * sum(axis_count(h, hw, stride, s) * axis_count(w, hw, stride, s)
                   for s in range(len(level_shapes(e, h, w))))


def least_seconds(bytes_: float, flops: float) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def _launches_seconds(e: dict, h: int, w: int, launches: list,
                      level_bytes: int, ops_per_sample: int) -> float:
    """The least time of window-cost launches (K, stride): per launch K *
    in-image samples at its stride * ops_per_sample operations; bytes: the
    levels' data (level_bytes) read once, the candidate planes read and
    their costs written."""
    samples = {}
    total = 0.0
    for k, stride in launches:
        if stride not in samples:
            samples[stride] = in_image_samples(e, h, w, stride)
        flops = k * samples[stride] * ops_per_sample
        total += least_seconds(level_bytes + 2 * k * h * w * (3 + 1) * 4,
                               flops)
    return total


def window_cost_seconds(e: dict, h: int, w: int) -> float:
    """The least time of one pair's window-cost launches (K1, K3 and K4's
    work): per launch K * in-image samples * (FLOPS_IN_IMAGE +
    FLOPS_IN_RANGE) operations; bytes: every level's volume of both views
    in vol_dtype and its packed images (4 bytes a pixel), the candidate
    planes read and their costs written."""
    vb = _VOL_BYTES[e["vol_dtype"]]
    levels = sum(2 * hs * ws * (ds * vb + 4)
                 for hs, ws, ds in level_shapes(e, h, w))
    return _launches_seconds(e, h, w, plan(e)[0], levels,
                             FLOPS_IN_IMAGE + FLOPS_IN_RANGE)


def fly_cost_seconds(e: dict, h: int, w: int) -> float | None:
    """The least time of one pair's fly-kernel launches (K5 and K3-fly's
    work, fly_plan), None where the schedule makes none: per launch K *
    in-image samples at its stride * (FLOPS_IN_IMAGE + FLY_FLOPS_IN_RANGE)
    operations; bytes: every level's views of both images (FLY_PLANE_BYTES
    a pixel) read once, the candidate planes read and their costs
    written."""
    launches = fly_plan(e)
    if not launches:
        return None
    planes = sum(2 * hs * ws * FLY_PLANE_BYTES
                 for hs, ws, _ in level_shapes(e, h, w))
    return _launches_seconds(e, h, w, launches, planes,
                             FLOPS_IN_IMAGE + FLY_FLOPS_IN_RANGE)


def quadrant_build_samples(h: int, w: int, half_wnd: int,
                           stride: int) -> int:
    """In-image window samples of the quadrant build over both views: every
    pixel's four quadrants at the stride."""
    neg = list(range(-half_wnd, 0, stride))
    pos = list(range(0, half_wnd + 1, stride))

    def axis(n, offs):
        return sum(sum(0 <= p + o < n for o in offs) for p in range(n))

    return 2 * sum(axis(h, oy) * axis(w, ox)
                   for oy in (neg, pos) for ox in (neg, pos))


def quadrant_build_seconds(e: dict, h: int, w: int) -> float | None:
    """The least time of one pair's quadrant build (K2), None where the
    schedule builds none: (2 D + 1) operations an in-image sample; bytes:
    the fine volume of both views in vol_dtype and the packed images read,
    the quadrant volumes f32[2, 4, H, W, D] and their weights f32[2, 4, H,
    W] written."""
    if not (e["prescreen_stride"] > 1 and e["prescreen_mode"] == "volume"
            and e["precompute_volume"]):
        return None
    d = e["max_dis"] + 1
    flops = quadrant_build_samples(h, w, e["wnd_size"] // 2,
                                   e["prescreen_stride"]) * (2 * d + 1)
    bytes_ = (2 * h * w * (d * _VOL_BYTES[e["vol_dtype"]] + 4)
              + 2 * 4 * h * w * (d + 1) * 4)
    return least_seconds(bytes_, flops)
