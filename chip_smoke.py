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
     and bf16 volumes; errors and CUDA-event times in turns;
  4. K2, the quadrant-volume build: the same;
  5. K4, the cross-scale window cost: the same on the 5-level census
     pyramid of the bench scene (CEN_CS_PP); f32 within 2e-5 relative, and
     bf16 census volumes (integers, exact in bf16) bit-equal;
  6. each kernel's bound: the larger of its bytes over the HBM rate and its
     f32 operations, counted on this run's inputs, over the f32 peak;
  7. the main paths, each with every launch counter reset just before and
     read just after: run_pair at README_DEMO and at CEN_CS_PP on the bench
     scene for seeds 0, 1, 2 and 0 again; the path's kernels must have
     launched and no plain version; bad-pixel(nonocc) @1px <= 0.01 per seed
     (left view); seed 0 bit-identical on rerun; ms/pair and peak device
     memory; for CEN_CS_PP also the time and launch count of postprocess;
  8. small pairs run on the card and on the CPU (plain versions) from the
     same draws must agree (README_DEMO-like and CEN_CS_PP-like).
The line before the last is the kernels' JSON record, the last line the
device record.  Exits non-zero, printing no result, without a CUDA device.
"""

import json
import subprocess
import sys
import time

SHAPE = dict(h=375, w=450, max_dis=60)
F32_REL_TOL = 2e-5          # |kernel - plain| <= tol * max(1, |plain|)
BAD_PIXEL_MAX = 0.01
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


def test_planes(imgs0, pair, k, gen, device):
    """f32[2, K, H, W, 3]: candidate 0 converged-like (ground truth plus
    jitter, small slopes), candidate 1 random init planes; ~0.1% of the
    pixels of the last candidate get a wild near-zero-nz plane."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch.ops import plane

    _, h, w, _ = imgs0.shape
    xs, ys = plane.pixel_grid(h, w, device)
    gt = torch.as_tensor(np.stack([pair.disp_left, pair.disp_right]),
                         device=device)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    ab = u(2, h, w, 2, lo=-0.05, hi=0.05)
    dc = gt + u(2, h, w, lo=-0.5, hi=0.5)
    conv = plane.reanchor(ab, xs, ys, dc)
    rand = plane.random_planes(u(2, h, w, lo=1e-8, hi=60.0),
                               torch.randn((2, h, w, 3), generator=gen,
                                           device=device))
    cands = [conv, rand][:k]
    wild_n = torch.cat([u(2, h, w, 2), torch.full((2, h, w, 1), 1e-9,
                                                   device=device)], -1)
    wild = plane.random_planes(u(2, h, w, lo=1e-8, hi=60.0), wild_n)
    pick = torch.rand((2, h, w), generator=gen, device=device) < 1e-3
    cands[-1] = torch.where(pick[..., None], wild, cands[-1])
    return torch.stack(cands, dim=1).contiguous()


def window_samples(abc, level_hw, half_wnd, max_dis):
    """(in-image, in-range) window samples of K1 / K4 on these planes:
    per level s (level_hw[s] = (Hs, Ws), max_dis >> s), every fine pixel's
    (2*half_wnd+1)^2 level-s window; in range means 1 <= dq < max_dis_s."""
    import torch

    _, _, h, w, _ = abc.shape
    dev = abc.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    a, b = abc[..., 0], abc[..., 1]
    d0 = a * xs.float() + b * ys.float() + abc[..., 2]
    n_img, n_rng = 0, torch.zeros((), dtype=torch.int64, device=dev)
    md = max_dis
    for s, (hs, ws) in enumerate(level_hw):
        cy, cx = ys >> s, xs >> s
        d_f = d0 * (1.0 / (1 << s))
        for dy in range(-half_wnd, half_wnd + 1):
            y_ok = (cy + dy >= 0) & (cy + dy < hs)
            for dx in range(-half_wnd, half_wnd + 1):
                ok = y_ok & (cx + dx >= 0) & (cx + dx < ws)
                dq = d_f + a * dx + b * dy
                n_rng += ((dq >= 1.0) & (dq < float(md)) & ok).sum()
        ny = sum(min(hs, (y >> s) + half_wnd + 1) - max(0, (y >> s) - half_wnd)
                 for y in range(h))
        nx = sum(min(ws, (x >> s) + half_wnd + 1) - max(0, (x >> s) - half_wnd)
                 for x in range(w))
        n_img += abc.shape[0] * abc.shape[1] * ny * nx
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, CostMethod,
                                                CSPMConfig, README_DEMO)
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                                run_pair_np)
    from crossscalepatchmatch_tpu_torch.models.postprocess import postprocess
    from crossscalepatchmatch_tpu_torch.ops import plane_cost, prescreen_volume
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import (_build,
                                                         cross_scale_cost,
                                                         quadrant_build,
                                                         window_cost)
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws

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
    vols_bf16 = vols.to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    h, w = SHAPE["h"], SHAPE["w"]

    # -- 3. K1 --------------------------------------------------------------
    def k1_plain(abc):
        return torch.stack([plane_cost.window_plane_cost(
            imgs[v], vols[v], mc[v], abc[v], half_wnd=hw, max_dis=md,
            gamma=gamma) for v in range(2)])

    def k1_kernel(abc, v):
        return window_cost.window_cost_cuda(imgs, v, mc, abc, half_wnd=hw,
                                            max_dis=md, gamma=gamma)

    k1 = {"max_abs_err": 0.0, "max_rel_err": 0.0, "bf16_max_rel_err": 0.0}
    for k in (1, 2):
        abc = test_planes(imgs, pair, k, gen, dev)
        want = k1_plain(abc)
        got = k1_kernel(abc, vols)
        got_bf = k1_kernel(abc, vols_bf16)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K1 K={k}: bad output {tuple(got.shape)}")
        ab, rl = rel_err(got, want)
        _, rl_bf = rel_err(got_bf, want)
        print(f"K1 K={k}: f32 max|d| {ab:.3e} max rel {rl:.3e} | "
              f"bf16 volume max rel {rl_bf:.3e}")
        if rl > F32_REL_TOL:
            raise RuntimeError(f"K1 K={k}: f32 rel error {rl} > "
                               f"{F32_REL_TOL}")
        k1["max_abs_err"] = max(k1["max_abs_err"], ab)
        k1["max_rel_err"] = max(k1["max_rel_err"], rl)
        k1["bf16_max_rel_err"] = max(k1["bf16_max_rel_err"], rl_bf)
        t = time_turns({"plain": lambda: k1_plain(abc),
                        "kernel_f32": lambda: k1_kernel(abc, vols),
                        "kernel_bf16": lambda: k1_kernel(abc, vols_bf16)},
                       {"plain": 1, "kernel_f32": 10, "kernel_bf16": 10})
        print(f"K1 K={k}: plain {t['plain']:.3f} ms | kernel f32 "
              f"{t['kernel_f32']:.3f} ms | kernel bf16 "
              f"{t['kernel_bf16']:.3f} ms")
        if k == 1:
            n_img, n_rng = window_samples(abc, [(h, w)], hw, md)
            b_ms, b_by = bound(
                nbytes(imgs, vols_bf16, mc, abc) + 2 * k * h * w * 4,
                FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
            print(f"K1 K=1: {n_img} in-image samples, {n_rng} in range; "
                  f"bound {b_ms:.4f} ms ({b_by})")
            k1.update(ms=t["kernel_bf16"], ms_f32=t["kernel_f32"],
                      plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by)
        else:
            k1.update(ms_k2=t["kernel_bf16"], ms_f32_k2=t["kernel_f32"],
                      plain_ms_k2=t["plain"])
    rec["k1"] = k1

    # -- 4. K2 --------------------------------------------------------------
    stride = max(cfg.prescreen_stride, 1)

    def k2_plain():
        parts = [prescreen_volume.build_quadrant_volumes(
            imgs[v], vols[v], half_wnd=hw, gamma=gamma, stride=stride)
            for v in range(2)]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))

    def k2_kernel(v):
        return quadrant_build.quadrant_volumes_cuda(
            imgs, v, half_wnd=hw, gamma=gamma, stride=stride)

    want_b, want_w = k2_plain()
    got_b, got_w = k2_kernel(vols)
    bf_b, bf_w = k2_kernel(vols_bf16)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got_b).all())
            and bool(torch.isfinite(got_w).all())):
        raise RuntimeError("K2: non-finite output")
    ab_b, rl_b = rel_err(got_b, want_b)
    ab_w, rl_w = rel_err(got_w, want_w)
    _, rl_bf = rel_err(bf_b, want_b)
    print(f"K2: f32 bq max|d| {ab_b:.3e} rel {rl_b:.3e}, wq max|d| "
          f"{ab_w:.3e} rel {rl_w:.3e} | bf16 volume bq max rel {rl_bf:.3e}")
    if max(rl_b, rl_w) > F32_REL_TOL:
        raise RuntimeError(f"K2: f32 rel error {max(rl_b, rl_w)} > "
                           f"{F32_REL_TOL}")
    out_bytes = nbytes(got_b, got_w)
    del want_b, want_w, got_b, got_w, bf_b, bf_w
    t = time_turns({"plain": k2_plain,
                    "kernel_f32": lambda: k2_kernel(vols),
                    "kernel_bf16": lambda: k2_kernel(vols_bf16)},
                   {"plain": 2, "kernel_f32": 10, "kernel_bf16": 10})
    print(f"K2: plain {t['plain']:.3f} ms | kernel f32 "
          f"{t['kernel_f32']:.3f} ms | kernel bf16 {t['kernel_bf16']:.3f} ms")
    # every in-image offset of a quadrant adds w * vol[q, :] (2 flops per
    # slice) and w to the weight sum
    neg, pos = prescreen_volume.quadrant_offsets(hw, stride)

    def axis_samples(n, offs):
        return sum(sum(0 <= i + o < n for o in offs) for i in range(n))

    k2_samples = 2 * sum(axis_samples(h, oy) * axis_samples(w, ox)
                         for oy in (neg, pos) for ox in (neg, pos))
    d = vols.shape[-1]
    b_ms, b_by = bound(nbytes(imgs, vols_bf16) + out_bytes,
                       k2_samples * (2 * d + 1))
    print(f"K2: {k2_samples} in-image samples; bound {b_ms:.4f} ms ({b_by})")
    rec["k2"] = dict(max_abs_err=max(ab_b, ab_w), max_rel_err=max(rl_b, rl_w),
                     bf16_max_rel_err=rl_bf, ms=t["kernel_bf16"],
                     ms_f32=t["kernel_f32"], plain_ms=t["plain"],
                     bound_ms=b_ms, bound_by=b_by)
    del vd, vols, vols_bf16

    # -- 5. K4 --------------------------------------------------------------
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

    def k4_kernel(abc, v):
        return cross_scale_cost.cross_scale_cost_cuda(
            cimgs, v, cmc, wgts, abc, half_wnd=chw, max_dis=ccfg.max_dis,
            gamma=ccfg.wgt_gamma)

    k4 = {"max_abs_err": 0.0, "max_rel_err": 0.0, "bf16_max_abs_err": 0.0}
    for k in (1, 2):
        abc = test_planes(cimgs[0], pair, k, gen, dev)
        want = k4_plain(abc)
        got = k4_kernel(abc, cvols)
        got_bf = k4_kernel(abc, cvols_bf16)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K4 K={k}: bad output {tuple(got.shape)}")
        ab, rl = rel_err(got, want)
        ab_bf, _ = rel_err(got_bf, want)
        print(f"K4 K={k}: f32 max|d| {ab:.3e} max rel {rl:.3e} | "
              f"bf16 census volumes max|d| {ab_bf:.3e}")
        if rl > F32_REL_TOL:
            raise RuntimeError(f"K4 K={k}: f32 rel error {rl} > "
                               f"{F32_REL_TOL}")
        if ab_bf != 0.0:
            raise RuntimeError(f"K4 K={k}: bf16 census volumes differ from "
                               f"the f32 plain version by {ab_bf}")
        k4["max_abs_err"] = max(k4["max_abs_err"], ab)
        k4["max_rel_err"] = max(k4["max_rel_err"], rl)
        k4["bf16_max_abs_err"] = max(k4["bf16_max_abs_err"], ab_bf)
        t = time_turns({"plain": lambda: k4_plain(abc),
                        "kernel_f32": lambda: k4_kernel(abc, cvols),
                        "kernel_bf16": lambda: k4_kernel(abc, cvols_bf16)},
                       {"plain": 1, "kernel_f32": 5, "kernel_bf16": 5})
        print(f"K4 K={k}: plain {t['plain']:.3f} ms | kernel f32 "
              f"{t['kernel_f32']:.3f} ms | kernel bf16 "
              f"{t['kernel_bf16']:.3f} ms")
        if k == 1:
            n_img, n_rng = window_samples(
                abc, [tuple(v.shape[1:3]) for v in cvols], chw, ccfg.max_dis)
            b_ms, b_by = bound(
                nbytes(*cimgs, *cvols_bf16, *cmc, abc) + 2 * k * h * w * 4,
                FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
            print(f"K4 K=1: {n_img} in-image samples, {n_rng} in range; "
                  f"bound {b_ms:.4f} ms ({b_by})")
            k4.update(ms=t["kernel_bf16"], ms_f32=t["kernel_f32"],
                      plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by)
        else:
            k4.update(ms_k2=t["kernel_bf16"], ms_f32_k2=t["kernel_f32"],
                      plain_ms_k2=t["plain"])
    rec["k4"] = k4
    del cvd, cvols, cvols_bf16
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. main paths --------------------------------------------------------
    def reset_counts():
        window_cost.launches = quadrant_build.launches = 0
        cross_scale_cost.launches = 0
        plane_cost.launches = prescreen_volume.launches = 0
        plane_cost.cross_scale_launches = 0

    def read_counts():
        return {"k1": window_cost.launches, "k2": quadrant_build.launches,
                "k4": cross_scale_cost.launches,
                "k1_plain": plane_cost.launches,
                "k2_plain": prescreen_volume.launches,
                "k4_plain": plane_cost.cross_scale_launches}

    def main_path(name, pcfg, kernels):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        outs, times = {}, []
        for seed in (0, 1, 2, 0):
            t0 = time.perf_counter()
            out = run_pair(l, r, seed, pcfg)
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
            if dis.shape != (2, h, w):
                raise RuntimeError(f"{name}: dis shape {dis.shape}")
            if not bool(torch.isfinite(out["cost"]).all()):
                raise RuntimeError(f"{name}: non-finite final costs")
            bad = bad_pixel_rate(dis[0] / pcfg.dis_scale, pair.disp_left,
                                 pair.valid_left, 1.0)
            bad_r = bad_pixel_rate(dis[1] / pcfg.dis_scale, pair.disp_right,
                                   pair.valid_right, 1.0)
            print(f"{name}: seed {seed} {times[-1]:.1f} ms "
                  f"bad-pixel(nonocc) @1px left {bad:.4f} right {bad_r:.4f}")
            if bad > BAD_PIXEL_MAX:
                raise RuntimeError(f"{name} seed {seed}: bad-pixel {bad} > "
                                   f"{BAD_PIXEL_MAX}")
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"{name}: launches {counts}")
        if any(counts[k] == 0 for k in kernels):
            raise RuntimeError(f"{name}: a kernel of the path never "
                               "launched")
        if any(counts[k] for k in counts if k.endswith("_plain")):
            raise RuntimeError(f"{name}: the path ran a plain version on "
                               "the card")
        print(f"{name}: ms/pair per run {times}; median of runs 2-4 "
              f"{sorted(times[1:])[1]:.1f}; peak device memory "
              f"{peak / 2**20:.1f} MiB")
        return outs, counts

    _, counts_demo = main_path("README_DEMO", README_DEMO, ("k1", "k2"))
    outs_cs, counts_cs = main_path("CEN_CS_PP", CEN_CS_PP, ("k4", "k2"))

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

    # small pairs: card (kernels) vs CPU (plain versions), same draws
    small = make_pair(h=48, w=64, max_dis=12, seed=3)
    for name, scfg in (
            ("README_DEMO-like", CSPMConfig(max_dis=12, dis_scale=16,
                                            wnd_size=11, vol_dtype="f32")),
            ("CEN_CS_PP-like", CSPMConfig(
                max_dis=12, dis_scale=16, wnd_size=11,
                cost_method=CostMethod.CEN,
                use_cs=True, use_pp=True, reg_lambda=0.3, scale_num=3,
                vol_dtype="f32"))):
        o_gpu = run_pair_np(small.left, small.right, scfg, device=dev,
                            draws=TorchDraws(0, "cpu"))
        o_cpu = run_pair_np(small.left, small.right, scfg, device="cpu",
                            draws=TorchDraws(0, "cpu"))
        agree = float((np.abs(o_gpu["dis"].astype(int)
                              - o_cpu["dis"].astype(int)) <= 1).mean())
        print(f"small pair {name} card vs CPU: {agree:.4f} of u8 pixels "
              f"within 1")
        if agree < SMALL_AGREE_MIN:
            raise RuntimeError(f"{name}: card vs CPU agreement {agree} < "
                               f"{SMALL_AGREE_MIN}")

    pkg = "crossscalepatchmatch_tpu_torch"
    wc = "crossscalepatchmatch_tpu/ops/pallas/window_cost.py"
    kernels = [
        dict(name="window_cost (K1)", route="cuda",
             source=f"{pkg}/csrc/window_cost.cu", replaces=f"{wc}:138",
             launches=counts_demo["k1"] + counts_cs["k1"], library_ms=None,
             launches_by_path={"README_DEMO": counts_demo["k1"],
                               "CEN_CS_PP": counts_cs["k1"]}, **rec["k1"]),
        dict(name="quadrant_build (K2)", route="cuda",
             source=f"{pkg}/csrc/quadrant_build.cu",
             replaces=("crossscalepatchmatch_tpu/ops/pallas/"
                       "quadrant_build.py:45"),
             launches=counts_demo["k2"] + counts_cs["k2"], library_ms=None,
             launches_by_path={"README_DEMO": counts_demo["k2"],
                               "CEN_CS_PP": counts_cs["k2"]}, **rec["k2"]),
        dict(name="cross_scale_cost (K4)", route="cuda",
             source=f"{pkg}/csrc/cross_scale_cost.cu", replaces=f"{wc}:138",
             launches=counts_demo["k4"] + counts_cs["k4"], library_ms=None,
             launches_by_path={"README_DEMO": counts_demo["k4"],
                               "CEN_CS_PP": counts_cs["k4"]}, **rec["k4"]),
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
