"""Smoke run of the PyTorch port (crossscalepatchmatch_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel;
     timed);
  3. K1, the window cost: kernel vs its plain PyTorch version on the card
     at the bench shape (375x450, max_dis=60, wnd=35, GRD) for K=1 and K=2
     candidates (converged-like, random and wild near-zero-nz planes), f32
     and bf16 volumes; K3's volume form (stride 2, K=8) the same;
  4. K2, the quadrant-volume build: the same at the bench shape; K2 and K1
     (K=1) again on the KITTI scene's 129 slices (375x1242, max_dis=128);
  5. K4, the cross-scale window cost: the same on the 5-level census
     pyramid of the bench scene (CEN_CS_PP); f32 within 2e-5 relative, and
     bf16 census volumes (integers, exact in bf16) bit-equal; K = 2, 3, 5,
     8 against one K=8 plain call, another window (half_wnd 8), and the
     kernel's pair-layout volume (pair_volume against the plain layout's
     taps);
  6. the no-volume fly kernel on the bench scene: K5 (cost lerp) at K=1
     and, against one K=8 plain call, K = 2, 3, 5, 8; K3's fly form
     (stride 2, K=8 and its first 3 and 5 candidates), K6 (image lerp), K7
     (Lab weights), the 5-level cross-scale fly at K=1 and another window
     (half_wnd 8, strides 1 and 3); on the KITTI scene (max_dis=128, the
     wider staged span) K5 at K=1 and K3's fly form; each within 2e-5
     relative of its plain version; every kernel is timed on prepared
     pairs (packing and layout copies outside the timed region);
  each kernel's bound: the larger of its bytes over the HBM rate and its
  f32 operations, counted on this run's inputs, over the f32 peak; every
  plain version is timed on its one comparison call, the kernels with
  CUDA events in turns after a warm-up;
  7. the main paths, each with every launch counter reset just before and
     read just after: run_pair at README_DEMO, CEN_CS_PP and README_DEMO
     without a volume (precompute_volume=False) on the bench scene for
     seeds 0, 1, 2 and 0 again (bad-pixel(nonocc) @1px <= 0.01 per seed,
     left view), KITTI without a volume on a 375x1242 max_dis=128 scene for
     seeds 0 and 0 again (@3px <= 0.01, @1px printed) and KITTI with its
     volumes for seed 0 (the K2 repair, and the memory comparison); the
     path's kernels must have launched and no plain version; seed 0
     bit-identical on rerun, and a digest of its `dis` bytes printed (to
     compare two checkouts on one card); ms/pair and peak device memory;
     for CEN_CS_PP
     also the time and launch count of postprocess;
  8. small pairs run on the card and on the CPU (plain versions) from the
     same draws must agree (README_DEMO-like, CEN_CS_PP-like, the volume
     path's window prescreen, and without a volume: cost lerp, image lerp
     + cross-scale, Lab weights); each is a path of its own for the
     launch counters;
  9. the entry points on the bench scene, every one a path of its own for
     the counters: the command line (`python -m
     crossscalepatchmatch_tpu_torch` with the README demo's flags, in a
     subprocess and in process, on PNGs of the scene: its maps equal
     run_pair_np's byte for byte; then --input_list with two seeds); a
     warm frame after a cold one (run_sequence_np, README_DEMO: ms a
     frame, peak memory, bad-pixel @1px <= 0.01, bit-identical rerun);
     run_pair_resumable (uninterrupted equal to run_pair, rewound to
     iterations 1 and 2 and resumed bit-equal); --aggregator BOX, GF and
     BF (ms/pair, the filter's device time, peak memory, bad-pixel,
     printed); small pairs card vs CPU for each aggregator, CEN+CS+BOX and
     a warm frame; and README_DEMO (seeds 0-2), CEN_CS_PP and KITTI (seed
     0) with f32 kernel volumes, their bad-pixel beside phase 7's bf16
     (printed, not gated).
The line before the last is the kernels' JSON record, the last line the
device record.  Exits non-zero, printing no result, without a CUDA device.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# scratch files of the entry-point phase (PNGs, checkpoints), inside the
# checkout's ignored build/ directory
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")
SHAPE = dict(h=375, w=450, max_dis=60)
# the README demo's command line (README_DEMO)
README_FLAGS = ("--max_dis=60", "--dis_scale=4", "--cc_name=GRD",
                "--use_cs=false", "--use_pp=false", "--reg_lambda=0.0")
KITTI_SHAPE = dict(h=375, w=1242, max_dis=128)
F32_REL_TOL = 2e-5          # |kernel - plain| <= tol * max(1, |plain|)
BAD_PIXEL_MAX = 0.01
# candidate counts of the optimizer's batches (exact 1-3, prescreen 4-8)
MANY_KS = (1, 2, 3, 5, 8)
OTHER_HALF_WND = 8          # a window other than the presets' half_wnd 17
SMALL_AGREE_MIN = 0.98      # share of u8 pixels within 1 level, card vs CPU
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


def rel_err(got, want):
    import torch

    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d / torch.clamp(want.float().abs(), min=1.0)).max()))


def time_turns(fns, reps):
    """ms per call of each fn, CUDA events, in turns a, b, ..., ..., b, a
    after one warm-up call of each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    acc = {n: [] for n in names}
    for n in names + names[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps[n]):
            fns[n]()
        end.record()
        torch.cuda.synchronize()
        acc[n].append(start.elapsed_time(end) / reps[n])
    return {n: sum(v) / len(v) for n, v in acc.items()}


def timed_once(fn):
    """(fn(), ms): one call between CUDA events (a plain version's time is
    its comparison call; plain versions cost most of the run)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def test_planes(pair, max_dis, k, gen, device):
    """f32[2, K, H, W, 3] on the scene `pair`: candidate 0 converged-like
    (ground truth plus jitter, small slopes), the others random init planes
    over [0, max_dis); ~0.1% of the pixels of the last candidate get a wild
    near-zero-nz plane."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch.ops import plane

    h, w = pair.disp_left.shape
    xs, ys = plane.pixel_grid(h, w, device)
    gt = torch.as_tensor(np.stack([pair.disp_left, pair.disp_right]),
                         device=device)
    md = float(max_dis)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    ab = u(2, h, w, 2, lo=-0.05, hi=0.05)
    dc = gt + u(2, h, w, lo=-0.5, hi=0.5)
    cands = [plane.reanchor(ab, xs, ys, dc)]
    for _ in range(k - 1):
        cands.append(plane.random_planes(
            u(2, h, w, lo=1e-8, hi=md),
            torch.randn((2, h, w, 3), generator=gen, device=device)))
    wild_n = torch.cat([u(2, h, w, 2), torch.full((2, h, w, 1), 1e-9,
                                                   device=device)], -1)
    wild = plane.random_planes(u(2, h, w, lo=1e-8, hi=md), wild_n)
    pick = torch.rand((2, h, w), generator=gen, device=device) < 1e-3
    cands[-1] = torch.where(pick[..., None], wild, cands[-1])
    return torch.stack(cands, dim=1).contiguous()


def axis_count(n, hw, stride, s):
    """sum over the n fine positions of the in-level offsets of
    range(-hw, hw + 1, stride) around (p >> s), level size ceil(n / 2^s)."""
    ns = ((n - 1) >> s) + 1
    return sum(sum(0 <= (p >> s) + o < ns
                   for o in range(-hw, hw + 1, stride)) for p in range(n))


def window_samples(abc, levels, half_wnd, max_dis, stride=1):
    """(in-image, in-range) window samples of K1 / K3 / K4 / K5 on these
    planes: per level s (`levels` of them, max_dis >> s), every fine
    pixel's level-s window at the stride; in range means
    1 <= dq < max_dis_s."""
    import torch

    nv, k, h, w, _ = abc.shape
    dev = abc.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    a, b = abc[..., 0], abc[..., 1]
    d0 = a * xs.float() + b * ys.float() + abc[..., 2]
    n_img, n_rng = 0, torch.zeros((), dtype=torch.int64, device=dev)
    md = max_dis
    for s in range(levels):
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        cy, cx = ys >> s, xs >> s
        d_f = d0 * (1.0 / (1 << s))
        for dy in range(-half_wnd, half_wnd + 1, stride):
            y_ok = (cy + dy >= 0) & (cy + dy < hs)
            for dx in range(-half_wnd, half_wnd + 1, stride):
                ok = y_ok & (cx + dx >= 0) & (cx + dx < ws)
                dq = d_f + a * dx + b * dy
                n_rng += ((dq >= 1.0) & (dq < float(md)) & ok).sum()
        n_img += nv * k * (axis_count(h, half_wnd, stride, s)
                           * axis_count(w, half_wnd, stride, s))
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


def check_close(name, got, want):
    """(max |d|, max rel); raises on a bad shape, a non-finite value or an
    f32 error over the tolerance."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: bad output {tuple(got.shape)}")
    ab, rl = rel_err(got, want)
    print(f"{name}: f32 max|d| {ab:.3e} max rel {rl:.3e}")
    if rl > F32_REL_TOL:
        raise RuntimeError(f"{name}: f32 rel error {rl} > {F32_REL_TOL}")
    return ab, rl


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from PIL import Image

    from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, KITTI, Aggregator,
                                                CostMethod, CSPMConfig,
                                                README_DEMO)
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                                run_pair_np)
    from crossscalepatchmatch_tpu_torch.models.postprocess import postprocess
    from crossscalepatchmatch_tpu_torch.ops import (onthefly_cost, plane_cost,
                                                    prescreen_volume)
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import (_build,
                                                         cross_scale_cost,
                                                         fly_cost,
                                                         quadrant_build,
                                                         window_cost)
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws

    pkg = "crossscalepatchmatch_tpu_torch"
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build(verbose=True)
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {paths}")

    cfg = README_DEMO
    hw, gamma, md = cfg.half_wnd, cfg.wgt_gamma, cfg.max_dis
    pair = make_pair(seed=0, **SHAPE)
    l = torch.as_tensor(pair.left, device=dev)
    r = torch.as_tensor(pair.right, device=dev)
    vd = build_volume_data(l, r, cfg)
    imgs, vols, mc = vd.imgs[0], vd.vols[0].contiguous(), vd.max_costs[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    h, w = SHAPE["h"], SHAPE["w"]

    # -- 3. K1 and K3's volume form ------------------------------------------
    def volume_phase(name, k, stride, reps, scene=None):
        """K1 (K3 at stride > 1) against its plain version on a scene's
        fine-level volumes (the bench scene's by default)."""
        p, v_imgs, v_vols, v_mc, v_md = scene or (pair, imgs, vols, mc, md)
        v_bf16 = v_vols.to(torch.bfloat16)
        ph, pw = p.disp_left.shape

        def plain():
            return torch.stack([plane_cost.window_plane_cost(
                v_imgs[v], v_vols[v], v_mc[v], abc[v], half_wnd=hw,
                max_dis=v_md, gamma=gamma, wnd_stride=stride)
                for v in range(2)])

        # prepared pairs: packing and the pair layout stay outside the
        # timed region
        preps = {key: window_cost.prepare_volumes(
            v_imgs, vol, v_mc, half_wnd=hw, max_dis=v_md, gamma=gamma)
            for key, vol in (("f32", v_vols), ("bf16", v_bf16))}

        def kernel(key):
            return window_cost.window_cost_prepared(
                preps[key], abc, half_wnd=hw, max_dis=v_md,
                wnd_stride=stride)

        abc = test_planes(p, v_md, k, gen, dev)
        want, plain_ms = timed_once(plain)
        ab, rl = check_close(f"{name} K={k}", kernel("f32"), want)
        _, rl_bf = rel_err(kernel("bf16"), want)
        del want
        t = time_turns({"f32": lambda: kernel("f32"),
                        "bf16": lambda: kernel("bf16")},
                       {"f32": reps, "bf16": reps})
        print(f"{name} K={k}: plain {plain_ms:.3f} ms | kernel f32 "
              f"{t['f32']:.3f} ms | kernel bf16 {t['bf16']:.3f} ms | bf16 "
              f"volume max rel {rl_bf:.3e}")
        n_img, n_rng = window_samples(abc, 1, hw, v_md, stride)
        b_ms, b_by = bound(nbytes(v_imgs, v_bf16, v_mc, abc)
                           + 2 * k * ph * pw * 4,
                           FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
        print(f"{name} K={k}: {n_img} in-image samples, {n_rng} in range; "
              f"bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=ab, max_rel_err=rl, bf16_max_rel_err=rl_bf,
                    ms=t["bf16"], ms_f32=t["f32"], plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    rec["k1"] = volume_phase("K1", 1, 1, 10)
    k1_k2 = volume_phase("K1", 2, 1, 10)
    rec["k1"].update(ms_k2=k1_k2["ms"], ms_f32_k2=k1_k2["ms_f32"],
                     plain_ms_k2=k1_k2["plain_ms"],
                     max_abs_err=max(rec["k1"]["max_abs_err"],
                                     k1_k2["max_abs_err"]))
    rec["k3_volume"] = volume_phase("K3 volume form, stride 2", 8, 2, 5)

    # -- 4. K2 ----------------------------------------------------------------
    stride = max(cfg.prescreen_stride, 1)

    def k2_phase(name, k2_imgs, k2_vols, reps):
        k2_bf16 = k2_vols.to(torch.bfloat16)

        def plain():
            parts = [prescreen_volume.build_quadrant_volumes(
                k2_imgs[v], k2_vols[v], half_wnd=hw, gamma=gamma,
                stride=stride) for v in range(2)]
            return (torch.stack([p[0] for p in parts]),
                    torch.stack([p[1] for p in parts]))

        d_max = k2_vols.shape[-1] - 1
        preps = {key: window_cost.prepare_volumes(
            k2_imgs, vol, None, half_wnd=hw, max_dis=d_max, gamma=gamma)
            for key, vol in (("f32", k2_vols), ("bf16", k2_bf16))}

        def kernel(key):
            return quadrant_build.quadrant_volumes_prepared(
                preps[key], half_wnd=hw, gamma=gamma, stride=stride)

        (want_b, want_w), plain_ms = timed_once(plain)
        got_b, got_w = kernel("f32")
        ab_b, rl_b = check_close(f"{name} bq", got_b, want_b)
        ab_w, rl_w = check_close(f"{name} wq", got_w, want_w)
        _, rl_bf = rel_err(kernel("bf16")[0], want_b)
        out_bytes = nbytes(got_b, got_w)
        del want_b, want_w, got_b, got_w
        t = time_turns({"f32": lambda: kernel("f32"),
                        "bf16": lambda: kernel("bf16")},
                       {"f32": reps, "bf16": reps})
        print(f"{name}: plain {plain_ms:.3f} ms | kernel f32 {t['f32']:.3f} "
              f"ms | kernel bf16 {t['bf16']:.3f} ms | bf16 volume bq max rel "
              f"{rl_bf:.3e}")
        # every in-image offset of a quadrant adds w * vol[q, :] (2 flops
        # per slice) and w to the weight sum
        neg, pos = prescreen_volume.quadrant_offsets(hw, stride)
        _, kh, kw_, d = k2_vols.shape

        def axis_samples(n, offs):
            return sum(sum(0 <= i + o < n for o in offs) for i in range(n))

        samples = 2 * sum(axis_samples(kh, oy) * axis_samples(kw_, ox)
                          for oy in (neg, pos) for ox in (neg, pos))
        b_ms, b_by = bound(nbytes(k2_imgs, k2_bf16) + out_bytes,
                           samples * (2 * d + 1))
        print(f"{name}: D={d}, {samples} in-image samples; bound "
              f"{b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=max(ab_b, ab_w), max_rel_err=max(rl_b, rl_w),
                    bf16_max_rel_err=rl_bf, ms=t["bf16"], ms_f32=t["f32"],
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    rec["k2"] = k2_phase("K2", imgs, vols, 10)
    del vd, vols
    kpair = make_pair(seed=0, **KITTI_SHAPE)
    kl = torch.as_tensor(kpair.left, device=dev)
    kr = torch.as_tensor(kpair.right, device=dev)
    kvd = build_volume_data(kl, kr, KITTI)
    k2_129 = k2_phase("K2 KITTI D=129", kvd.imgs[0], kvd.vols[0], 2)
    rec["k2"].update({f"{key}_d129": val for key, val in k2_129.items()
                      if key != "bound_by"})
    rec["k2"]["max_abs_err"] = max(rec["k2"]["max_abs_err"],
                                   k2_129["max_abs_err"])
    k1_129 = volume_phase("K1 KITTI D=129", 1, 1, 3,
                          (kpair, kvd.imgs[0], kvd.vols[0].contiguous(),
                           kvd.max_costs[0], KITTI.max_dis))
    rec["k1"].update({f"{key}_d129": val for key, val in k1_129.items()
                      if key != "bound_by"})
    rec["k1"]["max_abs_err"] = max(rec["k1"]["max_abs_err"],
                                   k1_129["max_abs_err"])
    del kvd

    # -- 5. K4 ----------------------------------------------------------------
    ccfg = CEN_CS_PP
    cvd = build_volume_data(l, r, ccfg)
    cimgs, cvols, cmc = cvd.imgs, cvd.vols, cvd.max_costs
    cvols_bf16 = [v.to(torch.bfloat16) for v in cvols]
    wgts = [float(x) for x in scale_weights(ccfg.scale_num, ccfg.reg_lambda)]
    chw = ccfg.half_wnd
    print(f"K4: levels {[tuple(v.shape) for v in cvols]}, weights {wgts}")

    def k4_plain(abc):
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in cimgs], [vo[v] for vo in cvols],
            [m[v] for m in cmc], wgts, abc[v], half_wnd=chw,
            max_dis=ccfg.max_dis, gamma=ccfg.wgt_gamma) for v in range(2)])

    k4_kw = dict(half_wnd=chw, max_dis=ccfg.max_dis, levels=len(cvols))

    def k4_prepare(v):
        return cross_scale_cost.prepare_cross_scale(
            cimgs, v, cmc, wgts, half_wnd=chw, max_dis=ccfg.max_dis,
            gamma=ccfg.wgt_gamma)

    def k4_kernel(abc, prep):
        return cross_scale_cost.cross_scale_cost_prepared(prep, abc, **k4_kw)

    k4_f32, k4_bf16 = k4_prepare(cvols), k4_prepare(cvols_bf16)
    # the kernel's pair layout: pair_volume against the plain layout's taps
    pos = torch.randint(0, h * w, (1 << 20,), generator=gen, device=dev)
    f = torch.randint(0, ccfg.max_dis, (1 << 20,), generator=gen, device=dev)
    for v in range(2):
        t0, t1 = cross_scale_cost.take_pair(
            cross_scale_cost.pair_volume(cvols[0][v]), pos, f)
        if not (torch.equal(t0, plane_cost.take_depth(cvols[0][v], pos, f))
                and torch.equal(t1, plane_cost.take_depth(cvols[0][v], pos,
                                                          f + 1))):
            raise RuntimeError("K4: pair-layout volume differs from the "
                               "plain layout's taps")
    k4 = {"max_abs_err": 0.0, "max_rel_err": 0.0}

    def k4_check(name, got, want):
        ab, rl = check_close(name, got, want)
        k4["max_abs_err"] = max(k4["max_abs_err"], ab)
        k4["max_rel_err"] = max(k4["max_rel_err"], rl)

    def k4_exact_bf16(name, abc, want):
        ab_bf, _ = rel_err(k4_kernel(abc, k4_bf16), want)
        print(f"{name}: bf16 census volumes max|d| {ab_bf:.3e}")
        if ab_bf != 0.0:
            raise RuntimeError(f"{name}: bf16 census volumes differ from "
                               f"the f32 plain version by {ab_bf}")

    def k4_times(name, abc):
        t = time_turns({"f32": lambda: k4_kernel(abc, k4_f32),
                        "bf16": lambda: k4_kernel(abc, k4_bf16)},
                       {"f32": 5, "bf16": 5})
        print(f"{name}: kernel f32 {t['f32']:.3f} ms | kernel bf16 "
              f"{t['bf16']:.3f} ms")
        return t

    abc = test_planes(pair, md, 1, gen, dev)
    want, plain_ms = timed_once(lambda: k4_plain(abc))
    k4_check("K4 K=1", k4_kernel(abc, k4_f32), want)
    k4_exact_bf16("K4 K=1", abc, want)
    del want
    print(f"K4 K=1: plain {plain_ms:.3f} ms")
    t = k4_times("K4 K=1", abc)
    n_img, n_rng = window_samples(abc, len(cvols), chw, ccfg.max_dis)
    b_ms, b_by = bound(nbytes(*cimgs, *cvols_bf16, *cmc, abc) + 2 * h * w * 4,
                       FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
    print(f"K4 K=1: {n_img} in-image samples, {n_rng} in range; "
          f"bound {b_ms:.4f} ms ({b_by})")
    k4.update(ms=t["bf16"], ms_f32=t["f32"], plain_ms=plain_ms,
              bound_ms=b_ms, bound_by=b_by)
    # more candidates, against one K=8 plain call (the plain version treats
    # each candidate on its own, so its first k results are those of a
    # K=k call)
    abc8 = test_planes(pair, md, 8, gen, dev)
    want, plain_ms = timed_once(lambda: k4_plain(abc8))
    for k in MANY_KS[1:]:
        k4_check(f"K4 first {k} of 8 candidates",
                 k4_kernel(abc8[:, :k].contiguous(), k4_f32), want[:, :k])
    abc = abc8[:, :2].contiguous()
    k4_exact_bf16("K4 K=2", abc, want[:, :2])
    del want
    t = k4_times("K4 K=2", abc)
    k4.update(ms_k2=t["bf16"], ms_f32_k2=t["f32"], plain_ms_k8=plain_ms,
              ms_k8=time_turns({"k": lambda: k4_kernel(abc8, k4_bf16)},
                               {"k": 3})["k"])
    print(f"K4 K=8: plain {plain_ms:.3f} ms | kernel bf16 "
          f"{k4['ms_k8']:.3f} ms")
    del abc8, k4_f32, k4_bf16
    # a window other than the presets'
    abc = test_planes(pair, md, 2, gen, dev)
    kw8 = dict(half_wnd=OTHER_HALF_WND, max_dis=ccfg.max_dis,
               gamma=ccfg.wgt_gamma)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in cimgs], [vo[v] for vo in cvols],
        [m[v] for m in cmc], wgts, abc[v], **kw8) for v in range(2)])
    k4_check(f"K4 half_wnd={OTHER_HALF_WND} K=2",
             cross_scale_cost.cross_scale_cost_cuda(cimgs, cvols, cmc, wgts,
                                                    abc, **kw8), want)
    rec["k4"] = k4
    del want, cvd, cvols, cvols_bf16

    # -- 6. the fly kernel: K5, K3 (fly form), K6, K7 -------------------------
    def fly_phase(name, fcfg, k, lerp, stride, reps, scene=None,
                  first_ks=(), time_first=0):
        """The fly kernel against its plain version on a scene (the bench
        scene by default), K candidates; first_ks: also its first k
        candidates for each k given, against the same plain call (the
        plain version treats each candidate on its own); time_first: also
        time the kernel on the first time_first candidates.  reps = 0: the
        check only."""
        p, pl, pr = scene or (pair, l, r)
        ph, pw = p.disp_left.shape
        fd = onthefly_cost.build_fly_data(pl, pr, fcfg)
        levels = len(fd.imgs)
        wg = ([float(x) for x in scale_weights(fcfg.scale_num,
                                               fcfg.reg_lambda)]
              if levels > 1 else None)
        kw = dict(half_wnd=fcfg.half_wnd, max_dis=fcfg.max_dis, lerp=lerp,
                  gamma=fcfg.wgt_gamma, alpha=fcfg.cost_alpha,
                  tau_clr=fcfg.tau_clr, tau_grd=fcfg.tau_grd,
                  border_thres=fcfg.border_thres)
        prep = fly_cost.prepare_fly(fd, wg, **kw)

        def kernel(planes):
            return fly_cost.fly_cost_prepared(
                prep, planes, half_wnd=fcfg.half_wnd, max_dis=fcfg.max_dis,
                levels=levels, wnd_stride=stride)

        abc = test_planes(p, fcfg.max_dis, k, gen, dev)
        want, plain_ms = timed_once(
            lambda: onthefly_cost.fly_plane_cost(fd, wg, abc,
                                                 wnd_stride=stride, **kw))
        ab, rl = check_close(f"{name} K={k}", kernel(abc), want)
        for kk in first_ks:
            ab_k, rl_k = check_close(f"{name} first {kk} of {k} candidates",
                                     kernel(abc[:, :kk].contiguous()),
                                     want[:, :kk])
            ab, rl = max(ab, ab_k), max(rl, rl_k)
        del want
        if not reps:
            return dict(max_abs_err=ab, max_rel_err=rl)
        fns = {"kernel": lambda: kernel(abc)}
        if time_first:
            head = abc[:, :time_first].contiguous()
            fns["first"] = lambda: kernel(head)
        t = time_turns(fns, dict.fromkeys(fns, reps))
        if time_first:
            print(f"{name} K={time_first}: kernel {t['first']:.3f} ms")
        n_img, n_rng = window_samples(abc, levels, fcfg.half_wnd,
                                      fcfg.max_dis, stride)
        inputs = [*fd.imgs, *fd.grds, *(fd.wimgs or []), abc]
        b_ms, b_by = bound(nbytes(*inputs) + 2 * k * ph * pw * 4,
                           FLOPS_IN_IMAGE * n_img
                           + FLY_FLOPS_IN_RANGE[lerp] * n_rng)
        print(f"{name} K={k}: plain {plain_ms:.3f} ms | kernel "
              f"{t['kernel']:.3f} ms | {n_img} in-image samples, {n_rng} in "
              f"range; bound {b_ms:.4f} ms ({b_by})")
        out = dict(max_abs_err=ab, max_rel_err=rl, ms=t["kernel"],
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if time_first:
            out["ms_first"] = t["first"]
        return out

    fcfg = dataclasses.replace(README_DEMO, precompute_volume=False)
    kitti_fly = dataclasses.replace(KITTI, precompute_volume=False)
    kitti = (kpair, kl, kr)
    rec["k5"] = fly_phase("K5", fcfg, 1, "cost", 1, 10)
    k5_cs = fly_phase("K5 cross-scale (5 levels)",
                      CSPMConfig(max_dis=md, precompute_volume=False,
                                 use_cs=True, reg_lambda=0.3),
                      1, "cost", 1, 5)
    # more candidates (stride 1) against one K=8 plain call, and a window
    # other than the presets'
    k5_k8 = fly_phase("K5", fcfg, 8, "cost", 1, 3, first_ks=(2, 3, 5),
                      time_first=2)
    k5_gen = fly_phase(
        f"K5 half_wnd={OTHER_HALF_WND}",
        dataclasses.replace(fcfg, wnd_size=2 * OTHER_HALF_WND + 1), 2,
        "cost", 1, 0)
    k3_gen = fly_phase(
        f"K3 fly form half_wnd={OTHER_HALF_WND}, stride 3",
        dataclasses.replace(fcfg, wnd_size=2 * OTHER_HALF_WND + 1), 5,
        "cost", 3, 0)
    k5_parts = (rec["k5"], k5_cs, k5_k8, k5_gen)
    rec["k5"].update(ms_k2=k5_k8["ms_first"], ms_k8=k5_k8["ms"],
                     plain_ms_k8=k5_k8["plain_ms"],
                     ms_cross_scale=k5_cs["ms"],
                     plain_ms_cross_scale=k5_cs["plain_ms"],
                     bound_ms_cross_scale=k5_cs["bound_ms"],
                     max_abs_err=max(p["max_abs_err"] for p in k5_parts),
                     max_rel_err=max(p["max_rel_err"] for p in k5_parts))
    k3_fly = fly_phase("K3 fly form, stride 2", fcfg, 8, "cost", 2, 5,
                       first_ks=(3, 5))
    k3_fly.update(
        max_abs_err=max(k3_fly["max_abs_err"], k3_gen["max_abs_err"]),
        max_rel_err=max(k3_fly["max_rel_err"], k3_gen["max_rel_err"]))
    rec["k3_fly"] = k3_fly
    # KITTI: the other view's staged span is tile + 128 columns wide
    k5_kitti = fly_phase("K5 KITTI d=128", kitti_fly, 1, "cost", 1, 3,
                         kitti)
    k3_kitti = fly_phase("K3 fly form KITTI d=128, stride 2", kitti_fly, 8,
                         "cost", 2, 3, kitti)
    for key, sub in (("k5", k5_kitti), ("k3_fly", k3_kitti)):
        rec[key].update({f"{f}_kitti": val for f, val in sub.items()
                         if f != "bound_by"})
        rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"],
                                      sub["max_abs_err"])
        rec[key]["max_rel_err"] = max(rec[key]["max_rel_err"],
                                      sub["max_rel_err"])
    rec["k6"] = fly_phase("K6 image lerp", fcfg, 1, "image", 1, 5)
    rec["k7"] = fly_phase("K7 Lab weights",
                          CSPMConfig(max_dis=md, precompute_volume=False,
                                     use_lab_weights=True), 1, "cost", 1, 5)
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. main paths --------------------------------------------------------
    def reset_counts():
        window_cost.launches = window_cost.strided_launches = 0
        quadrant_build.launches = cross_scale_cost.launches = 0
        fly_cost.launches.clear()
        plane_cost.launches = prescreen_volume.launches = 0
        plane_cost.cross_scale_launches = onthefly_cost.launches = 0

    def read_counts():
        return {"k1": window_cost.launches - window_cost.strided_launches,
                "k3_volume": window_cost.strided_launches,
                "k2": quadrant_build.launches,
                "k4": cross_scale_cost.launches,
                "k3_fly": fly_cost.count(strided=True),
                "k5": fly_cost.count(lerp="cost"),
                "k6": fly_cost.count(lerp="image"),
                "k7": fly_cost.count(lab=True),
                "fly": fly_cost.count(),
                "k1_plain": plane_cost.launches,
                "k2_plain": prescreen_volume.launches,
                "k4_plain": plane_cost.cross_scale_launches,
                "fly_plain": onthefly_cost.launches}

    def check_counts(name, counts, kernels):
        print(f"{name}: launches {counts}")
        if any(counts[k] == 0 for k in kernels):
            raise RuntimeError(f"{name}: a kernel of the path never "
                               "launched")
        if any(counts[k] for k in counts if k.endswith("_plain")):
            raise RuntimeError(f"{name}: the path ran a plain version on "
                               "the card")

    def main_path(name, pcfg, kernels, scene, seeds, px, gate=True):
        """Run the seeds (a repeated seed must give the same outputs);
        returns (outputs by seed, launch counts, bad-pixel @px by seed)."""
        p, pl, pr = scene
        ph, pw = p.left.shape[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        outs, times, bads = {}, [], {}
        for seed in seeds:
            t0 = time.perf_counter()
            out = run_pair(pl, pr, seed, pcfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if seed in outs:
                same = all(torch.equal(outs[seed][k], out[k]) for k in out)
                print(f"{name}: seed {seed} rerun bit-identical: {same}")
                if not same:
                    raise RuntimeError(f"{name}: same seed gave different "
                                       "outputs")
                continue
            outs[seed] = out
            dis = out["dis"].cpu().numpy()
            if seed == 0:
                digest = hashlib.sha256(dis.tobytes()).hexdigest()[:16]
                print(f"{name}: seed 0 dis digest {digest}")
            if dis.shape != (2, ph, pw):
                raise RuntimeError(f"{name}: dis shape {dis.shape}")
            if not bool(torch.isfinite(out["cost"]).all()):
                raise RuntimeError(f"{name}: non-finite final costs")
            bad = {t: bad_pixel_rate(dis[0] / pcfg.dis_scale, p.disp_left,
                                     p.valid_left, t) for t in (1.0, px)}
            bad_r = bad_pixel_rate(dis[1] / pcfg.dis_scale, p.disp_right,
                                   p.valid_right, px)
            bads[seed] = bad[px]
            print(f"{name}: seed {seed} {times[-1]:.1f} ms "
                  f"bad-pixel(nonocc) @{px:g}px left {bad[px]:.4f} right "
                  f"{bad_r:.4f}; @1px left {bad[1.0]:.4f}")
            if gate and bad[px] > BAD_PIXEL_MAX:
                raise RuntimeError(f"{name} seed {seed}: bad-pixel "
                                   f"{bad[px]} > {BAD_PIXEL_MAX}")
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check_counts(name, counts, kernels)
        mid = ""
        if len(times) > 1:
            later = sorted(times[1:])
            mid = f"; median of runs 2+ {later[len(later) // 2]:.1f}"
        print(f"{name}: ms/pair per run {times}{mid}; peak device memory "
              f"{peak / 2**20:.1f} MiB")
        return outs, counts, bads

    bench = (pair, l, r)
    paths, bf16_bads = {}, {}
    _, paths["README_DEMO"], bf16_bads["README_DEMO"] = main_path(
        "README_DEMO", README_DEMO, ("k1", "k2"), bench, (0, 1, 2, 0), 1.0)
    outs_cs, paths["CEN_CS_PP"], bf16_bads["CEN_CS_PP"] = main_path(
        "CEN_CS_PP", CEN_CS_PP, ("k4", "k2"), bench, (0, 1, 2, 0), 1.0)
    _, paths["README_DEMO-fly"], _ = main_path(
        "README_DEMO-fly", fcfg, ("k5", "k3_fly"), bench, (0, 1, 2, 0), 1.0)
    _, paths["KITTI-fly"], _ = main_path("KITTI-fly", kitti_fly,
                                         ("k5", "k3_fly"), kitti, (0, 0), 3.0)
    _, paths["KITTI"], bf16_bads["KITTI"] = main_path(
        "KITTI", KITTI, ("k1", "k2"), kitti, (0,), 3.0)

    # postprocess alone on the seed-0 planes: time, launches, same output
    from torch.profiler import ProfilerActivity, profile

    abc0 = outs_cs[0]["abc"]
    imgs0 = torch.stack([l, r])
    dis0 = pm.plane_to_disp(abc0, CEN_CS_PP.dis_scale)
    pp_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp_dis, _ = postprocess(dis0, abc0, imgs0, CEN_CS_PP)
        torch.cuda.synchronize()
        pp_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(pp_dis, outs_cs[0]["dis"]):
        raise RuntimeError("postprocess alone differs from the pipeline's")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        postprocess(dis0, abc0, imgs0, CEN_CS_PP)
        torch.cuda.synchronize()
    pp_launches = sum(1 for e in prof.events()
                      if e.device_type.name == "CUDA")
    n_invalid = int((~outs_cs[0]["valid"]).sum())
    print(f"CEN_CS_PP postprocess: ms per call {pp_ms}; "
          f"{pp_launches} kernel launches; {n_invalid} LR-invalid pixels")

    # -- 8. small pairs: card (kernels) vs CPU (plain versions), same draws -----
    small = make_pair(h=48, w=64, max_dis=12, seed=3)
    base = dict(max_dis=12, dis_scale=16, wnd_size=11, vol_dtype="f32")

    def card_vs_cpu(name, kernels, run):
        """run(device) -> u8 maps, on the card (a path of its own for the
        counters) and on the CPU; they must agree within 1 level on
        SMALL_AGREE_MIN of the pixels."""
        reset_counts()
        o_gpu = run(dev)
        torch.cuda.synchronize()
        paths[name] = read_counts()
        check_counts(f"small pair {name}", paths[name], kernels)
        o_cpu = run(torch.device("cpu"))
        agree = float((np.abs(o_gpu.astype(int) - o_cpu.astype(int))
                       <= 1).mean())
        print(f"small pair {name} card vs CPU: {agree:.4f} of u8 pixels "
              f"within 1")
        if agree < SMALL_AGREE_MIN:
            raise RuntimeError(f"{name}: card vs CPU agreement {agree} < "
                               f"{SMALL_AGREE_MIN}")

    for name, kernels, scfg in (
            ("README_DEMO-like", ("k1", "k2"), CSPMConfig(**base)),
            ("CEN_CS_PP-like", ("k4", "k2"), CSPMConfig(
                cost_method=CostMethod.CEN, use_cs=True, use_pp=True,
                reg_lambda=0.3, scale_num=3, **base)),
            ("window-prescreen", ("k1", "k3_volume"), CSPMConfig(
                prescreen_mode="window", **base)),
            ("fly-cost", ("k5", "k3_fly"), CSPMConfig(
                precompute_volume=False, **base)),
            ("fly-image-CS", ("k6",), CSPMConfig(
                precompute_volume=False, fly_lerp="image", use_cs=True,
                reg_lambda=0.3, scale_num=3, **{**base, "wnd_size": 7})),
            ("fly-Lab", ("k5", "k7", "k3_fly"), CSPMConfig(
                precompute_volume=False, use_lab_weights=True, **base))):
        card_vs_cpu(name, kernels, lambda d, c=scfg: run_pair_np(
            small.left, small.right, c, device=d,
            draws=TorchDraws(0, "cpu"))["dis"])

    # -- 9. the entry points on the card -----------------------------------
    from crossscalepatchmatch_tpu_torch import checkpoint, cli
    from crossscalepatchmatch_tpu_torch import io as cspm_io
    from crossscalepatchmatch_tpu_torch.models.pipeline import (
        run_pair_warm, run_sequence_np)
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        aggregate_volume)
    from crossscalepatchmatch_tpu_torch.utils.rng import PHASE_WARM

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[
            :16]

    def bad1(dis, p, scale):
        return bad_pixel_rate(dis[0] / scale, p.disp_left, p.valid_left, 1.0)

    os.makedirs(WORK_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=WORK_DIR)
    try:
        # 9.1 the CLI: a subprocess, then in-process for the counters
        lp, rp = os.path.join(work, "l.png"), os.path.join(work, "r.png")
        cspm_io.write_bgr(lp, pair.left)
        cspm_io.write_bgr(rp, pair.right)
        if not (np.array_equal(cspm_io.read_bgr(lp), pair.left)
                and np.array_equal(cspm_io.read_bgr(rp), pair.right)):
            raise RuntimeError("CLI: the PNG round trip changed the views")

        def flags(tag, seed=None):
            f = [f"--l_img_file={lp}", f"--r_img_file={rp}",
                 f"--l_dis_file={work}/{tag}_l.png",
                 f"--r_dis_file={work}/{tag}_r.png", *README_FLAGS]
            return f if seed is None else [*f, f"--seed={seed}"]

        def cli_maps(tag):
            return np.stack([np.asarray(Image.open(f"{work}/{tag}_{v}.png"))
                             for v in "lr"])

        def run_cli(args):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", pkg, *args], cwd=REPO,
                capture_output=True, text=True, timeout=600)
            wall = (time.perf_counter() - t0) * 1e3
            if res.returncode != 0:
                raise RuntimeError(f"CLI exit {res.returncode}:\n"
                                   f"{res.stdout}\n{res.stderr}")
            total = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("Total Time:")]
            print(f"CLI {' '.join(args[:1])} ...: {total}, process "
                  f"{wall:.0f} ms")
            return total

        run_cli(flags("sub"))
        reset_counts()
        if cli.main(flags("inproc")) != 0:
            raise RuntimeError("CLI in-process: non-zero exit")
        torch.cuda.synchronize()
        paths["CLI"] = read_counts()
        check_counts("CLI (in process)", paths["CLI"], ("k1", "k2"))
        want = run_pair_np(pair.left, pair.right, cli.config_from_args(
            cli.build_parser().parse_args(flags("x"))), seed=0)["dis"]
        same = [np.array_equal(cli_maps(t), want) for t in ("sub", "inproc")]
        print(f"CLI README demo flags: subprocess maps == run_pair_np "
              f"{same[0]}, in-process == run_pair_np {same[1]}, digest "
              f"{digest(want)}, bad-pixel @1px {bad1(want, pair, 4):.4f}")
        if not all(same):
            raise RuntimeError("CLI maps differ from run_pair_np's")
        lst = os.path.join(work, "input.txt")
        with open(lst, "w") as f:
            for seed in (0, 1):
                f.write(f"cspm {' '.join(flags(f'list{seed}', seed))}\n")
        if len(run_cli([f"--input_list={lst}"])) != 2:
            raise RuntimeError("CLI --input_list: not two runs")
        lists = [cli_maps(f"list{seed}") for seed in (0, 1)]
        print(f"CLI --input_list: seed 0 == the single run "
              f"{np.array_equal(lists[0], want)}, seed 1 differs "
              f"{not np.array_equal(lists[1], want)}, seed 1 bad-pixel "
              f"@1px {bad1(lists[1], pair, 4):.4f}")
        if (not np.array_equal(lists[0], want)
                or np.array_equal(lists[1], want)
                or bad1(lists[1], pair, 4) > BAD_PIXEL_MAX):
            raise RuntimeError("CLI --input_list: wrong maps")

        # 9.2 a warm frame after a cold one (README_DEMO): the same
        # geometry, the next frame's sensor noise
        nxt = make_pair(seed=0, noise_sigma=2.0, **SHAPE)
        frames = [(pair.left, pair.right), (nxt.left, nxt.right)]

        def sequence():
            outs, ms = [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for out in run_sequence_np(frames, README_DEMO, seed=0):
                outs.append(out)
                t1 = time.perf_counter()
                ms.append((t1 - t0) * 1e3)
                t0 = t1
            return outs, ms

        sequence()       # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        seq, ms = sequence()
        paths["warm sequence"] = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check_counts("warm sequence", paths["warm sequence"], ("k1", "k2"))
        again, ms2 = sequence()
        same = all(np.array_equal(a[k], b[k])
                   for a, b in zip(seq, again) for k in a)
        warm_bad = bad1(seq[1]["dis"], nxt, 4)
        print(f"warm frame (README_DEMO, warm_iters 1): cold {ms[0]:.1f} / "
              f"{ms2[0]:.1f} ms, warm {ms[1]:.1f} / {ms2[1]:.1f} ms a frame; "
              f"peak device memory {peak / 2**20:.1f} MiB; bad-pixel @1px "
              f"cold {bad1(seq[0]['dis'], pair, 4):.4f} warm {warm_bad:.4f}; "
              f"rerun bit-identical {same}; warm digest "
              f"{digest(seq[1]['dis'])}")
        if warm_bad > BAD_PIXEL_MAX or not same:
            raise RuntimeError("warm frame: bad-pixel over the gate or a "
                               "rerun differs")

        # 9.3 checkpoint and resume (README_DEMO)
        ck_path = os.path.join(work, "state.npz")
        saved = {}
        save_state = checkpoint.save_state

        def spy(path, state, iteration, scfg, seed):
            saved[iteration] = state
            save_state(path, state, iteration, scfg, seed)

        reset_counts()
        checkpoint.save_state = spy
        try:
            full = checkpoint.run_pair_resumable(pair.left, pair.right,
                                                 README_DEMO, ck_path)
        finally:
            checkpoint.save_state = save_state
        paths["resume"] = read_counts()
        check_counts("resume", paths["resume"], ("k1", "k2"))
        plain = run_pair_np(pair.left, pair.right, README_DEMO, seed=0)
        same = [all(np.array_equal(full[k], plain[k]) for k in plain)]
        for rewind in (1, 2):
            checkpoint.save_state(ck_path, saved[rewind], rewind,
                                  README_DEMO, 0)
            res = checkpoint.run_pair_resumable(pair.left, pair.right,
                                                README_DEMO, ck_path)
            same.append(all(np.array_equal(full[k], res[k]) for k in full))
        print(f"resume (README_DEMO): uninterrupted == run_pair {same[0]} "
              f"(dis digest {digest(full['dis'])}); rewound to iteration 1 "
              f"and resumed bit-equal {same[1]}, to iteration 2 {same[2]}")
        if not all(same):
            raise RuntimeError("resume: not bit-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 9.4 the aggregators (README_DEMO, seed 0): ms/pair, the filter's own
    # device time on the two views' level-0 volumes, peak memory, bad-pixel
    plain_vd = build_volume_data(l, r, README_DEMO)
    for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF):
        acfg = dataclasses.replace(README_DEMO, aggregator=agg)
        run_pair(l, r, 0, acfg)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        out = run_pair(l, r, 0, acfg)
        torch.cuda.synchronize()
        ms_pair = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        paths[f"aggregator {agg.value}"] = read_counts()
        check_counts(f"aggregator {agg.value}",
                     paths[f"aggregator {agg.value}"], ("k1", "k2"))
        _, agg_ms = timed_once(lambda: [aggregate_volume(
            plain_vd.vols[0][v], plain_vd.imgs[0][v], acfg)
            for v in range(2)])
        bad = bad1(out["dis"].cpu().numpy(), pair, 4)
        bf16_bads[f"README_DEMO-{agg.value}"] = {0: bad}
        print(f"aggregator {agg.value}: {ms_pair:.1f} ms/pair, aggregation "
              f"{agg_ms:.1f} device ms (2 views), peak device memory "
              f"{peak / 2**20:.1f} MiB, bad-pixel @1px {bad:.4f}")
    del plain_vd

    # 9.5 small pairs, card vs CPU: each aggregator, CEN+CS+BOX, a warm
    # frame (both from the CPU's cold planes, the same warm draws)
    for agg in ("BOX", "GF", "BF"):
        scfg = CSPMConfig(aggregator=Aggregator(agg), **base)
        card_vs_cpu(f"aggregator {agg}", ("k1", "k2"),
                    lambda d, c=scfg: run_pair_np(
                        small.left, small.right, c, device=d,
                        draws=TorchDraws(0, "cpu"))["dis"])
    scfg = CSPMConfig(cost_method=CostMethod.CEN, use_cs=True,
                      reg_lambda=0.3, scale_num=3, aggregator=Aggregator.BOX,
                      **base)
    card_vs_cpu("CEN+CS+BOX", ("k4", "k2"), lambda d: run_pair_np(
        small.left, small.right, scfg, device=d,
        draws=TorchDraws(0, "cpu"))["dis"])
    scfg = CSPMConfig(**base)
    prior = run_pair_np(small.left, small.right, scfg, device="cpu",
                        draws=TorchDraws(0, "cpu"))["abc"]
    card_vs_cpu("warm frame", ("k1", "k2"), lambda d: run_pair_warm(
        small.left, small.right, 1, prior, scfg, device=d,
        draws=TorchDraws(1, "cpu", refine_phase=PHASE_WARM))[
            "dis"].cpu().numpy())

    # 9.6 kernel volumes in f32 against the default bf16: bad-pixel per
    # seed (printed, not gated: the JAX engine has the same bf16 default);
    # the aggregators' filtered volumes are not integers, so bf16 rounds them
    for name, pcfg, kernels, scene, seeds, px in (
            ("README_DEMO", README_DEMO, ("k1", "k2"), bench, (0, 1, 2),
             1.0),
            ("CEN_CS_PP", CEN_CS_PP, ("k4", "k2"), bench, (0,), 1.0),
            ("KITTI", KITTI, ("k1", "k2"), kitti, (0,), 3.0),
            *((f"README_DEMO-{agg.value}",
               dataclasses.replace(README_DEMO, aggregator=agg), ("k1", "k2"),
               bench, (0,), 1.0)
              for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF))):
        _, paths[f"{name} f32"], f32 = main_path(
            f"{name} f32 volumes", dataclasses.replace(pcfg, vol_dtype="f32"),
            kernels, scene, seeds, px, gate=False)
        for seed in seeds:
            gap = f32[seed] - bf16_bads[name][seed]
            print(f"{name} seed {seed}: bad-pixel @{px:g}px f32 "
                  f"{f32[seed]:.4f} bf16 {bf16_bads[name][seed]:.4f} gap "
                  f"{gap:+.4f}{' (over 0.005)' if abs(gap) > 0.005 else ''}")

    wc = "crossscalepatchmatch_tpu/ops/pallas/window_cost.py"

    def entry(name, key, source, replaces):
        by_path = {p: c[key] for p, c in paths.items() if c[key]}
        return dict(name=name, route="cuda", source=f"{pkg}/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    library_ms=None, launches_by_path=by_path, **rec[key])

    kernels = [
        entry("window_cost (K1)", "k1", "cross_scale_cost.cu", f"{wc}:138"),
        entry("quadrant_build (K2)", "k2", "quadrant_build.cu",
              "crossscalepatchmatch_tpu/ops/pallas/quadrant_build.py:45"),
        entry("strided window, volume form (K3)", "k3_volume",
              "cross_scale_cost.cu", f"{wc}:331"),
        entry("strided window, fly form (K3)", "k3_fly", "fly_cost.cu",
              f"{wc}:331"),
        entry("cross_scale_cost (K4)", "k4", "cross_scale_cost.cu",
              f"{wc}:138"),
        entry("fly cost, cost lerp (K5)", "k5", "fly_cost.cu", f"{wc}:74"),
        entry("fly cost, image lerp (K6)", "k6", "fly_cost.cu", f"{wc}:50"),
        entry("fly cost, Lab weights (K7)", "k7", "fly_cost.cu", f"{wc}:316"),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          "card check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
