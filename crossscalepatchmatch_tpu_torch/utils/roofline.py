"""Roofline accounting for the window-cost hot path on the card (the port's
crossscalepatchmatch_tpu utils/roofline.py).

  * count_plane_cost_work: the analytic count of a run_pair's plane-cost
    work, the JAX package's launch model (an own copy: the same dict for
    every config), which the port's optimizer follows launch for launch;
  * pipeline_flops: per pair, the semantic flops (the JAX formula) and what
    the Hopper kernels execute (FLOPS_IN_IMAGE / FLOPS_IN_RANGE per window
    sample, K2's strided build, the two-tap quadrant ranking), with the
    bytes each launch reads;
  * the card's bound: HBM_BYTES_PER_S, F32_FLOP_PER_S (NVIDIA's H100 SXM
    data sheet at 700 W), the per-sample operation counts, the exact
    window-sample counts of a launch on given planes (axis_count,
    window_samples), bound() and nbytes(); tools/torch_kernel_ab.py reads
    its kernels' bounds from these;
  * median_samples: the window samples a bisection for the weighted
    median reads on a validity mask, with WMF_OPS_PER_SAMPLE; and
    median_least_ops, the operations the least work of an exact weighted
    median needs there (kernel WMF's bound);
  * grd_volume_work / census_volume_work / quadrant_rank_work: the bytes
    and operations of a pair's GRD volumes (kernel GRDV, one launch), of
    its census volumes over the pyramid's levels (kernel CENV, one call a
    level) and of one launch of kernel QRANK (a ranking call, its in-range quadrants counted on the
    planes); quadrant_rank_row_work: the same with each distinct tap float
    of a quadrant row counted once (the bound on candidates that share
    taps); quadrant_rank_sectors: the distinct 32-byte sectors of the
    quadrant volume that a QRANK launch's taps touch;
  * bilateral_volume_work: the bytes and operations of one launch of the
    bilateral volume filter (kernel BFV, the BF aggregator) on a level;
  * measure_f32_peak: the f32 ceiling the card sustains, from a
    hand-written FMA-chain kernel (csrc/f32_peak.cu).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..config import CSPMConfig
from ..ops.plane import pixel_grid
from ..ops.prescreen_volume import quadrant_anchors

# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per window sample of K1 / K4: dq (a*dx and two adds) and
# the weighted accumulation (a multiply and an add) for every in-image
# sample; the two-tap lerp ((f+1)-dq, 1-fw, two multiplies, an add) for an
# in-range one
FLOPS_IN_IMAGE = 5
FLOPS_IN_RANGE = 5
# the fly kernel's in-range sample: K5 adds to the lerp two GRD slice costs
# (the colour sum's multiply by 1/3, |grad diff| (a subtract and an abs),
# two mins, two multiplies, an add: 8 each); K6 instead the warp (other_x,
# fw, 1-fw), four channel lerps (3 each), three |q - lerp| (2 each), their
# two adds and 1/3, |grad diff| (2) and the mix (5)
FLY_FLOPS_IN_RANGE = {"cost": FLOPS_IN_RANGE + 16, "image": 3 + 12 + 6 + 3
                      + 2 + 5}
# the quadrant ranking (ops.prescreen_volume.quadrant_prescreen_cost) per
# ranked candidate and pixel: the centre disparity (two multiplies, two
# adds), then per quadrant dq (two multiplies, two adds), t = dq - f, 1 - t,
# the two-tap lerp (two multiplies, an add) and the running sum
RANK_FLOPS_CENTER = 4
RANK_FLOPS_PER_QUADRANT = 10
# an out-of-range quadrant of the ranking (kernel QRANK): dq (two
# multiplies, two adds), W_Q * max_cost and the running sum
RANK_FLOPS_OUT_OF_RANGE = 6
# a GRD volume element (kernel GRDV): the colour term's multiply by 1/3,
# |grad diff| (a subtract and an abs), two mins, two multiplies and an add
GRD_FLOPS_PER_ELEMENT = 8
# the weighted median's window sample in each pass of a bisection
# (median_samples): the L1 distance (three absolute differences, two
# adds), the threshold test and the f32 add; counted at the f32 rate
WMF_OPS_PER_SAMPLE = 7
# the least an exact weighted median does with a window sample, once
# (median_least_ops): the L1 distance (five), the weight table's look-up
# and one add into the sample's level; and per level of the scan that
# finds the median, the running sum's add and the test against half
MEDIAN_OPS_PER_SAMPLE = 7
MEDIAN_OPS_PER_LEVEL = 2
MEDIAN_LEVELS = 256
# a census volume element (kernel CENV): per u32 word of the codes an XOR,
# a popcount and an add; a census code: a compare and a shift-or for each
# of its wnd^2 - 1 bits; integer operations, counted at the f32 rate
CENSUS_OPS_PER_WORD = 3
CENSUS_OPS_PER_BIT = 2
# a refinement proposal (kernel RPROP): per pixel, once, its plane's
# disparity (two multiplies, two adds) and unit normal (two squares, two
# adds, a reciprocal square root, two multiplies); per candidate, its four
# draws (a multiply and an add each), z and the normal's jitter (four
# adds), the norm (three squares, three adds, a square root, a max), three
# divides, the sign's max, the plane's (a, b) (two divides) and c (three
# multiplies, three adds, a divide); the Philox rounds are integer work
RPROP_FLOPS_PER_PIXEL = 11
RPROP_FLOPS_PER_CANDIDATE = 33
# the bilateral volume filter (kernel BFV) per (pixel, window offset): the
# weight (three subtracts and absolute values, two adds and the 1/3 of the
# colour mean, its square and scale, the spatial term's subtract, the exp
# counted as one, the weight sum's add) once, and a multiply and an add for
# each of the D - 2 inner slices
BF_FLOPS_PER_WEIGHT = 12

# the JAX model's semantic op counts (crossscalepatchmatch_tpu
# utils/roofline.py): per (center, offset, candidate) the plane at q (2
# fma), trunc + range test (~3), two tent weights (~6), the 2-tap lerp (4),
# the weighted accumulation (2); per (center, offset) the ASW weight (3
# abs-diffs, 2 adds, a scale)
SEMANTIC_OPS_PER_SAMPLE = 17
WEIGHT_OPS_PER_OFFSET = 6

_VOL_BYTES = {"f32": 4, "bf16": 2}


def _plan(cfg: CSPMConfig) -> Tuple[List[Tuple[int, int]], float]:
    """(launches, rank_cands): the window-cost launches of one run_pair as
    (K, window stride) pairs, in order, and the candidates ranked on the
    quadrant volumes, per pixel and view.

    The optimizer's launch structure with the schedule's launch economy:
    rank-phase iterations adopt on quadrant rankings (no exact launches),
    cfg.merge_view folds the view candidate into the last sweep's launch,
    and the deferred-cost entry replaces the init / boundary K=1 exact
    launch with one extra candidate in the first exact sweep."""
    stride = max(cfg.prescreen_stride, 1)
    volume_rank = (cfg.prescreen_stride > 1
                   and cfg.prescreen_mode == "volume")
    # the window prescreen is single-scale only; the volume prescreen
    # also serves cross-scale configs (fine-level ranking)
    prescreen = cfg.prescreen_stride > 1 and (not cfg.use_cs or volume_rank)
    k_stencil = 4 + (4 if cfg.far_offsets else 0)
    r = len(cfg.refinement_schedule())
    if cfg.batch_refine:
        stages = max(1, min(cfg.refine_stages, r))
        per = -(-r // stages)
        stage_ks = [min(per, r - s0) for s0 in range(0, r, per)]
    else:
        stage_ks = [1] * r

    n_rank = cfg.rank_iters
    n_exact = cfg.max_iter - n_rank
    merge = cfg.merge_view and cfg.prop_sweeps > 0
    defer = cfg.prop_sweeps > 0 and n_exact > 0

    rank_cands = 0.0
    launches: List[Tuple[int, int]] = []

    # init: ranking eval (rank phase), deferred (exact entry), or K=1
    if n_rank:
        rank_cands += 1
    elif not defer:
        launches.append((1, 1))

    # rank-phase iterations: every adoption (sweeps, view candidate,
    # refinement stages) on the quadrant ranking
    rank_cands += n_rank * (cfg.prop_sweeps * k_stencil + 1
                            + sum(stage_ks))

    # rank -> exact boundary: exact refresh unless deferred
    if n_rank and n_exact and not defer:
        launches.append((1, 1))

    for it in range(n_exact):
        for s in range(cfg.prop_sweeps):
            k_extra = (1 if (defer and it == 0 and s == 0) else 0) \
                + (1 if (merge and s == cfg.prop_sweeps - 1) else 0)
            if prescreen:
                if volume_rank:
                    rank_cands += k_stencil
                else:
                    launches.append((k_stencil, stride))
                launches.append((1 + k_extra, 1))   # winner (+ riders)
            else:
                launches.append((k_stencil + k_extra, 1))
        if not merge:
            launches.append((1, 1))                  # view propagation
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


def _offsets(cfg: CSPMConfig, stride: int) -> int:
    n = len(range(-cfg.half_wnd, cfg.half_wnd + 1, stride))
    return n * n


def count_plane_cost_work(cfg: CSPMConfig) -> Dict[str, float]:
    """Per-pixel-per-view evaluation counts of one run_pair pipeline, in
    units of window-offset-candidate samples ("ocu") and weight
    evaluations ("exps"), with the window-cost launches, the candidates
    ranked on the quadrant volumes and the quadrant build's offsets (the
    JAX package's count_plane_cost_work, key for key)."""
    launches, rank_cands = _plan(cfg)
    # the window is evaluated at every pyramid level (unscaled window,
    # pre_cs_pc.cc:135): the same offset count per level
    scales = cfg.scale_num if cfg.use_cs else 1
    ocu = 0.0
    exps = 0.0
    for k, stride in launches:
        offs = _offsets(cfg, stride)
        ocu += k * offs * scales
        exps += offs * scales
    volume_rank = (cfg.prescreen_stride > 1
                   and cfg.prescreen_mode == "volume")
    build_offs = (_offsets(cfg, cfg.prescreen_stride) if volume_rank
                  else 0.0)
    return {"ocu": ocu, "exps": exps, "launches": len(launches),
            "rank_cands": rank_cands, "build_offs": build_offs}


def axis_count(n, hw, stride, s, origin=0, lo=0, hi=None):
    """sum over the n fine positions p of the offsets o of range(-hw, hw +
    1, stride) with lo <= ((p + origin) >> s) + o < hi (hi: the level size
    ceil(n / 2^s) by default)."""
    hi = ((n - 1) >> s) + 1 if hi is None else hi
    return sum(sum(lo <= ((p + origin) >> s) + o < hi
                   for o in range(-hw, hw + 1, stride)) for p in range(n))


def window_samples(abc, levels, half_wnd, max_dis, stride=1, geoms=None):
    """(in-image, in-range) window samples of K1 / K3 / K4 / K5 on these
    planes: per level s (`levels` of them, max_dis >> s), every fine
    pixel's level-s window at the stride; in range means
    1 <= dq < max_dis_s.  geoms: per level the band form's (origin (oy,
    ox), valid rectangle (ylo, yhi, xlo, xhi)); the window then centers at
    ((y + oy) >> s, (x + ox) >> s) and counts inside the rectangle."""
    nv, k, h, w, _ = abc.shape
    dev = abc.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    a, b = abc[..., 0], abc[..., 1]
    d0 = a * xs.float() + b * ys.float() + abc[..., 2]
    n_img, n_rng = 0, torch.zeros((), dtype=torch.int64, device=dev)
    md = max_dis
    for s in range(levels):
        (oy, ox), (ylo, yhi, xlo, xhi) = (
            geoms[s] if geoms else
            ((0, 0), (0, ((h - 1) >> s) + 1, 0, ((w - 1) >> s) + 1)))
        cy, cx = (ys + oy) >> s, (xs + ox) >> s
        d_f = d0 * (1.0 / (1 << s))
        for dy in range(-half_wnd, half_wnd + 1, stride):
            y_ok = (cy + dy >= ylo) & (cy + dy < yhi)
            for dx in range(-half_wnd, half_wnd + 1, stride):
                ok = y_ok & (cx + dx >= xlo) & (cx + dx < xhi)
                dq = d_f + a * dx + b * dy
                n_rng += ((dq >= 1.0) & (dq < float(md)) & ok).sum()
        n_img += nv * k * (axis_count(h, half_wnd, stride, s, oy, ylo, yhi)
                           * axis_count(w, half_wnd, stride, s, ox, xlo,
                                        xhi))
        md //= 2
    return n_img, int(n_rng)


def bound(bytes_, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def quadrant_build_samples(h: int, w: int, half_wnd: int, stride: int,
                           origin=(0, 0), rect=None) -> int:
    """In-image window samples of K2 over both views of its H x W outputs:
    every pixel's four quadrants at the stride.  Band form: output pixel
    (y, x) is array pixel (y + oy, x + ox), origin = (oy, ox), and a sample
    counts inside rect = (ylo, yhi, xlo, xhi) (default: the outputs)."""
    neg = list(range(-half_wnd, 0, stride))
    pos = list(range(0, half_wnd + 1, stride))
    ylo, yhi, xlo, xhi = rect if rect is not None else (0, h, 0, w)

    def axis(n, o0, lo, hi, offs):
        return sum(sum(lo <= p + o0 + o < hi for o in offs)
                   for p in range(n))

    return 2 * sum(axis(h, origin[0], ylo, yhi, oy)
                   * axis(w, origin[1], xlo, xhi, ox)
                   for oy in (neg, pos) for ox in (neg, pos))


def _median_windows(valid: torch.Tensor, half_wnd: int, center_row0: int,
                    out_h, center_col0: int, out_w):
    """(in-array window pixels, valid ones, invalid output mask) of each
    output pixel of the weighted median, each [2, Ho, Wo]."""
    _, h, w = valid.shape
    oh = h if out_h is None else out_h
    ow = w if out_w is None else out_w
    dev = valid.device

    def spans(c0, n, size):
        c = torch.arange(c0, c0 + n, device=dev)
        return (c - half_wnd).clamp(min=0), (c + half_wnd).clamp(max=size - 1)

    y0, y1 = spans(center_row0, oh, h)
    x0, x1 = spans(center_col0, ow, w)
    area = (y1 - y0 + 1)[:, None] * (x1 - x0 + 1)[None, :]
    # valid pixels in each window, from a summed-area table
    sat = torch.nn.functional.pad(
        valid.to(torch.int64).cumsum(1).cumsum(2), (1, 0, 1, 0))
    y0, y1, x0, x1 = y0[:, None], y1[:, None] + 1, x0[None, :], x1[None, :] + 1
    held = (sat[:, y1, x1] - sat[:, y0, x1] - sat[:, y1, x0]
            + sat[:, y0, x0])
    invalid = ~valid[:, center_row0:center_row0 + oh,
                     center_col0:center_col0 + ow]
    return area, held, invalid


def median_samples(valid: torch.Tensor, half_wnd: int, center_row0: int = 0,
                   out_h: int | None = None, center_col0: int = 0,
                   out_w: int | None = None) -> int:
    """Window samples of the weighted median as a bisection reads them on
    this mask (models.postprocess.weighted_median's arguments): at each
    invalid output pixel of both views, its window's pixels inside the
    array, once for the total and 8 more times (the bisection's steps)
    where the window holds a valid pixel, the total then being positive
    (the table's weights are all positive for wmf_gamma > 765 / 103, where
    exp(-765 / gamma) is no f32 zero).  The bisection's work, at
    WMF_OPS_PER_SAMPLE a sample: neither what kernel WMF reads (its search
    makes 2 passes, of 16 and 15 thresholds) nor the least work an exact
    search needs (median_least_ops, WMF's bound).

    Args:
      valid: bool[2, Ha, Wa]; the output window as weighted_median's.
    """
    area, held, invalid = _median_windows(valid, half_wnd, center_row0,
                                          out_h, center_col0, out_w)
    passes = 1 + 8 * (held > 0).to(torch.int64)
    return int((invalid * area * passes).sum())


def median_least_ops(valid: torch.Tensor, half_wnd: int,
                     center_row0: int = 0, out_h: int | None = None,
                     center_col0: int = 0, out_w: int | None = None) -> int:
    """The operations the least work of an exact weighted median needs on
    this mask (median_samples' arguments): each in-array window pixel of
    each invalid output pixel read once, MEDIAN_OPS_PER_SAMPLE each (its
    weight and one add into its level's sum), and one scan of the
    MEDIAN_LEVELS levels' sums, MEDIAN_OPS_PER_LEVEL a level, at each
    invalid pixel whose window holds a valid pixel (elsewhere the total is
    0 and the pixel keeps its value).  Kernel WMF's bound counts this."""
    area, held, invalid = _median_windows(valid, half_wnd, center_row0,
                                          out_h, center_col0, out_w)
    samples = int((invalid * area).sum())
    scans = int((invalid & (held > 0)).sum())
    return (MEDIAN_OPS_PER_SAMPLE * samples
            + MEDIAN_OPS_PER_LEVEL * MEDIAN_LEVELS * scans)


def grd_volume_work(h: int, w: int, max_dis: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of both views' H x W x (max_dis + 1) GRD
    volumes (ops.cuda.grd_volume.grd_volumes: one GRDV launch, which reads
    the u8 views and forms their gray image and gradient itself): both u8
    RGB views read once and both f32 volumes written once;
    GRD_FLOPS_PER_ELEMENT an element."""
    n = 2 * h * w * (max_dis + 1)
    return 2 * h * w * 3 + 4 * n, GRD_FLOPS_PER_ELEMENT * n


def census_volume_work(h: int, w: int, max_dis: int, levels: int = 1,
                       wnd: int = 9) -> Tuple[int, int]:
    """(bytes, operations) of both views' census volumes over `levels`
    pyramid levels of an H x W pair (ops.cuda.census_volume.census_volumes,
    one CENV call a level): level s is ceil(H / 2^s) x ceil(W / 2^s) at
    max_dis >> s; both u8 RGB views of each level read once and both f32
    volumes written once; CENSUS_OPS_PER_WORD a word of each element,
    CENSUS_OPS_PER_BIT a bit of each pixel's code."""
    words = (wnd * wnd - 1 + 31) // 32
    bytes_ = ops = 0
    for s in range(levels):
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        n = 2 * hs * ws * ((max_dis >> s) + 1)
        bytes_ += 2 * hs * ws * 3 + 4 * n
        ops += (CENSUS_OPS_PER_WORD * words * n
                + CENSUS_OPS_PER_BIT * (wnd * wnd - 1) * 2 * hs * ws)
    return bytes_, ops


def refine_propose_work(k: int, h: int, w: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of one RPROP launch: K rounds of both
    views' H x W planes (ops.cuda.refine_propose.refine_propose); the
    starting planes read once, the f32[2, K, H, W, 3] candidates written
    once."""
    n = 2 * h * w
    return 12 * n * (1 + k), (RPROP_FLOPS_PER_PIXEL
                              + RPROP_FLOPS_PER_CANDIDATE * k) * n


def bilateral_volume_work(h: int, w: int, d: int,
                          wnd: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of one BFV launch: the wnd x wnd bilateral
    filter of both views' H x W x D volumes on one level
    (ops.cuda.bilateral_volume.bilateral_volumes).  The borders wrap, so
    every window offset of every pixel is in the image:
    2 (D - 2) + BF_FLOPS_PER_WEIGHT operations a (pixel, offset); the f32
    volumes read once, their D - 2 filtered inner slices written once and
    the u8 guides read once."""
    n = 2 * h * w
    inner = max(d - 2, 0)
    return (n * (4 * d + 4 * inner + 3),
            n * wnd * wnd * (2 * inner + BF_FLOPS_PER_WEIGHT))


def quadrant_rank_work(abc: torch.Tensor, half_wnd: int,
                       max_dis: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of one QRANK launch on these planes (f32[2,
    K, H, W, 3], the ranking's own arithmetic for the range test): the
    planes and the saturation values read once, the two taps (8 bytes) of
    every in-range quadrant, a quadrant weight of W_Q (4 bytes) once for
    each (view, quadrant, pixel) where some candidate is out of range (the
    only place the function needs it), the f32[2, K, H, W] costs written
    once; RANK_FLOPS_CENTER a ranked candidate and pixel,
    RANK_FLOPS_PER_QUADRANT an in-range quadrant,
    RANK_FLOPS_OUT_OF_RANGE an out-of-range one."""
    nv, k, h, w, _ = abc.shape
    xs, ys = pixel_grid(h, w, abc.device)
    a, b = abc[..., 0], abc[..., 1]
    d_center = a * xs + b * ys + abc[..., 2]
    n_rng = n_wq = 0
    for ay, ax in quadrant_anchors(half_wnd):
        dq = d_center + a * ax + b * ay
        rng = (dq >= 1.0) & (dq < float(max_dis))
        n_rng += int(rng.sum())
        n_wq += int((~rng).any(dim=1).sum())
    n = nv * k * h * w
    bytes_ = abc.numel() * 4 + nv * 4 + 8 * n_rng + 4 * n_wq + n * 4
    ops = (RANK_FLOPS_CENTER * n + RANK_FLOPS_PER_QUADRANT * n_rng
           + RANK_FLOPS_OUT_OF_RANGE * (4 * n - n_rng))
    return bytes_, ops


def _distinct_taps(abc: torch.Tensor, d: int, half_wnd: int, max_dis: int,
                   per: int) -> Tuple[int, int]:
    """(the distinct units of `per` floats of bq, f32[2, 4, H, W, d] from an
    aligned base, that one QRANK launch's in-range taps on these planes
    touch, counted per (view, quadrant, pixel) row; the in-range taps)."""
    nv, _, h, w, _ = abc.shape
    dev = abc.device
    xs, ys = pixel_grid(h, w, dev)
    a, b = abc[..., 0], abc[..., 1]
    d_center = a * xs + b * ys + abc[..., 2]
    pix = torch.arange(h * w, device=dev).reshape(1, 1, h, w)
    view = torch.arange(nv, device=dev).reshape(nv, 1, 1, 1)
    n = taps = 0
    for qi, (ay, ax) in enumerate(quadrant_anchors(half_wnd)):
        dq = d_center + a * ax + b * ay
        rng = (dq >= 1.0) & (dq < float(max_dis))
        taps += 2 * int(rng.sum())
        f = torch.where(rng, dq, 1.0).trunc().to(torch.int64)
        first = ((4 * view + qi) * (h * w) + pix) * d + f
        unit = torch.cat([first // per, (first + 1) // per], dim=1)
        unit = torch.where(torch.cat([rng, rng], dim=1), unit, -1)
        unit = unit.sort(dim=1).values
        n += int((unit[:, :1] >= 0).sum())
        n += int(((unit[:, 1:] != unit[:, :-1]) & (unit[:, 1:] >= 0)).sum())
    return n, taps


def quadrant_rank_sectors(abc: torch.Tensor, d: int, half_wnd: int,
                          max_dis: int) -> int:
    """The distinct 32-byte sectors of K2's bq (f32[2, 4, H, W, d], its
    base 512-byte aligned) that one QRANK launch's in-range taps touch on
    these planes (f32[2, K, H, W, 3]), counted per (view, quadrant, pixel)
    row: the floor a gather of these taps can reach, each sector fetched
    from DRAM once (quadrant_rank_work is the function's own bound)."""
    return _distinct_taps(abc, d, half_wnd, max_dis, 32 // 4)[0]


def quadrant_rank_row_work(abc: torch.Tensor, half_wnd: int,
                           max_dis: int) -> Tuple[int, int]:
    """quadrant_rank_work with each distinct float of bq that the in-range
    taps read counted once (4 bytes) for every (view, quadrant, pixel) row,
    instead of 8 bytes for every in-range quadrant: the bytes the function
    must move on candidates that share taps, as the pipeline's do (a
    pixel's K candidates read the same four rows), and the same f32
    operations."""
    bytes_, ops = quadrant_rank_work(abc, half_wnd, max_dis)
    floats, taps = _distinct_taps(abc, max_dis + 1, half_wnd, max_dis, 1)
    return bytes_ - 4 * taps + 4 * floats, ops


def pipeline_flops(cfg: CSPMConfig, h: int, w: int) -> Dict[str, float]:
    """Flop and byte totals of one H x W stereo pair on the card.

    semantic_flops: the JAX model's formula (the 2-tap lerp the reference
    semantics require and the ASW weights).  executed: what the Hopper
    kernels execute, FLOPS_IN_IMAGE per in-image window sample of every
    launch (at its stride, on every pyramid level: exact border counts)
    plus FLOPS_IN_RANGE per in-range one, where this analytic form takes
    every in-image sample as in range (it has no planes;
    tools/torch_kernel_ab.py counts the real share on its inputs); K2's
    2 * D + 1 per in-image sample of its strided build; the quadrant
    ranking's two taps per quadrant (RANK_FLOPS_*).  hbm_bytes: per launch
    the pair-layout volume in cfg.vol_dtype ([2, H, W, D, 2] a level), the
    packed images, the planes and the outputs; K2 reads the fine level's
    pair-layout volume and images and writes its quadrant volumes.
    """
    counts = count_plane_cost_work(cfg)
    launches, rank_cands = _plan(cfg)
    px = h * w * 2   # both views
    d = cfg.max_dis + 1
    sem = counts["ocu"] * px * SEMANTIC_OPS_PER_SAMPLE \
        + counts["exps"] * px * WEIGHT_OPS_PER_OFFSET

    levels = cfg.scale_num if cfg.use_cs else 1
    vb = _VOL_BYTES[cfg.vol_dtype]
    level_hw = [(((h - 1) >> s) + 1, ((w - 1) >> s) + 1, (cfg.max_dis >> s)
                 + 1) for s in range(levels)]
    vol_bytes = sum(2 * hs * ws * ds * 2 * vb + 2 * hs * ws * 4
                    for hs, ws, ds in level_hw)
    samples = {}
    executed = 0.0
    hbm = 0.0
    for k, stride in launches:
        if stride not in samples:
            samples[stride] = 2 * sum(
                axis_count(h, cfg.half_wnd, stride, s)
                * axis_count(w, cfg.half_wnd, stride, s)
                for s in range(levels))
        executed += k * samples[stride] * (FLOPS_IN_IMAGE + FLOPS_IN_RANGE)
        hbm += vol_bytes + 2 * k * h * w * (3 + 1) * 4
    executed += rank_cands * px * (RANK_FLOPS_CENTER
                                   + 4 * RANK_FLOPS_PER_QUADRANT)
    k2 = 0
    if counts["build_offs"]:
        k2 = 1
        executed += quadrant_build_samples(
            h, w, cfg.half_wnd, cfg.prescreen_stride) * (2 * d + 1)
        hbm += (2 * h * w * d * 2 * vb + 2 * h * w * 4
                + 2 * 4 * h * w * (d + 1) * 4)
    return {
        "semantic_flops": sem,
        "executed": executed,
        "transcendentals": (counts["exps"] + counts["build_offs"]) * px,
        "kernel_launches": counts["launches"] + k2,
        "hbm_bytes": hbm,
    }


def measure_f32_peak(device=None, iters=(64, 2048), reps: int = 3) -> float:
    """The f32 ceiling the card sustains outside the tensor cores, in FLOP/s
    (an FMA counts 2): csrc/f32_peak.cu's chains over every SM at full
    occupancy, timed with CUDA events as the difference of two loop counts
    (which cancels the launch and the loads and stores), best of `reps`.

    The chains start at 0 with m = c = 1, so every step adds exactly 1 (an
    FFMA's rate does not depend on its values): every element of every
    timed launch must come out as its step count, iters * UNROLL (at most
    32768, exact in f32), which holds the work counted in the FLOP/s to
    have been done at the timed shape; RuntimeError otherwise.  Raises
    RuntimeError without a CUDA device: there is no CPU figure."""
    from ..ops.cuda import f32_peak

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_f32_peak needs a CUDA device")
    n_lo, n_hi = iters
    if not 0 <= n_lo < n_hi or n_hi * f32_peak.UNROLL > 2 ** 24:
        raise ValueError(f"iters {iters}: need 0 <= lo < hi and "
                         f"hi * {f32_peak.UNROLL} <= 2^24")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 16 blocks of 256 threads an SM: full occupancy, twice over
    x = torch.zeros(sms * 16 * f32_peak.BLOCK_ELEMS, dtype=torch.float32,
                    device=dev)

    def timed(n):
        f32_peak.fma_chain(x, n, 1.0, 1.0)         # warm-up (and the build)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = f32_peak.fma_chain(x, n, 1.0, 1.0)
        end.record()
        torch.cuda.synchronize(dev)
        want = float(n * f32_peak.UNROLL)
        if not bool((out == want).all()):
            bad = int((out != want).sum())
            raise RuntimeError(f"f32 peak kernel: {bad} of {out.numel()} "
                               f"elements are not {want} after {n} loops")
        return start.elapsed_time(end) * 1e-3

    flops = (n_hi - n_lo) * f32_peak.UNROLL * x.numel() * 2.0
    best = 0.0
    for _ in range(reps):
        dt = timed(n_hi) - timed(n_lo)
        best = max(best, flops / max(dt, 1e-9))
    return best
