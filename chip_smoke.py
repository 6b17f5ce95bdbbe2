"""Smoke run of the PyTorch port (crossscalepatchmatch_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (timed);
  3. K1, the window cost: kernel vs its plain PyTorch version on the card
     at the bench shape (375x450, max_dis=60, wnd=35) for K=1 and K=2
     candidates (converged-like, random and wild near-zero-nz planes), f32
     and bf16 volumes; errors and CUDA-event times (plain/kernel/kernel/
     plain);
  4. K2, the quadrant-volume build: the same;
  5. the main path: run_pair at README_DEMO on the bench scene for seeds
     0, 1, 2 with every launch counter reset just before; K1/K2 must have
     launched and their plain versions not; bad-pixel(nonocc) @1px <= 0.01
     per seed; seed 0 run twice must be bit-identical; ms/pair and peak
     device memory; then a small pair run on the card and on the CPU
     (plain versions) from the same draws must agree.
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


def rel_err(got, want):
    import torch

    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d / torch.clamp(want.float().abs(), min=1.0)).max()))


def time_turns(fns, reps):
    """ms per call of each fn, CUDA events, in turns a/b/b/a after one
    warm-up call of each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    order = [names[0], names[1], names[1], names[0]]
    acc = {n: [] for n in names}
    for n in order:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps[n]):
            fns[n]()
        end.record()
        torch.cuda.synchronize()
        acc[n].append(start.elapsed_time(end) / reps[n])
    return {n: sum(v) / len(v) for n, v in acc.items()}


def test_planes(vd, pair, k, gen, device):
    """f32[2, K, H, W, 3]: candidate 0 converged-like (ground truth plus
    jitter, small slopes), candidate 1 random init planes; ~0.1% of the
    pixels of the last candidate get a wild near-zero-nz plane."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch.ops import plane

    _, h, w, _ = vd.imgs[0].shape
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from crossscalepatchmatch_tpu.data import make_pair
    from crossscalepatchmatch_tpu.metrics import bad_pixel_rate
    from crossscalepatchmatch_tpu_torch import CSPMConfig, README_DEMO
    from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                                run_pair_np)
    from crossscalepatchmatch_tpu_torch.ops import plane_cost, prescreen_volume
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import (_build, quadrant_build,
                                                         window_cost)
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

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path}")

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
        abc = test_planes(vd, pair, k, gen, dev)
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
                        "kernel": lambda: k1_kernel(abc, vols)},
                       {"plain": 2, "kernel": 10})
        t_bf = time_turns({"plain": lambda: k1_plain(abc),
                           "kernel": lambda: k1_kernel(abc, vols_bf16)},
                          {"plain": 1, "kernel": 10})
        print(f"K1 K={k}: plain {t['plain']:.3f} ms | kernel f32 "
              f"{t['kernel']:.3f} ms | kernel bf16 {t_bf['kernel']:.3f} ms")
        if k == 1:
            k1.update(ms=t_bf["kernel"], ms_f32=t["kernel"],
                      plain_ms=t["plain"])
        else:
            k1.update(ms_k2=t_bf["kernel"], plain_ms_k2=t["plain"])
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
    del want_b, want_w, got_b, got_w, bf_b, bf_w
    t = time_turns({"plain": k2_plain, "kernel": lambda: k2_kernel(vols)},
                   {"plain": 2, "kernel": 10})
    t_bf = time_turns({"plain": k2_plain,
                       "kernel": lambda: k2_kernel(vols_bf16)},
                      {"plain": 1, "kernel": 10})
    print(f"K2: plain {t['plain']:.3f} ms | kernel f32 {t['kernel']:.3f} ms "
          f"| kernel bf16 {t_bf['kernel']:.3f} ms")
    rec["k2"] = dict(max_abs_err=max(ab_b, ab_w), max_rel_err=max(rl_b, rl_w),
                     bf16_max_rel_err=rl_bf, ms=t_bf["kernel"],
                     ms_f32=t["kernel"], plain_ms=t["plain"])
    del vd, vols, vols_bf16

    # -- 5. main path ---------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    window_cost.launches = quadrant_build.launches = 0
    plane_cost.launches = prescreen_volume.launches = 0
    outs, times = {}, []
    for seed in (0, 1, 2, 0):
        t0 = time.perf_counter()
        out = run_pair(l, r, seed, cfg, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if seed in outs:
            same = all(torch.equal(outs[seed][k], out[k]) for k in out)
            print(f"pipeline: seed {seed} rerun bit-identical: {same}")
            if not same:
                raise RuntimeError("same seed gave different outputs")
            continue
        outs[seed] = out
        dis = out["dis"].cpu().numpy()
        if dis.shape != (2, SHAPE["h"], SHAPE["w"]):
            raise RuntimeError(f"dis shape {dis.shape}")
        if not bool(torch.isfinite(out["cost"]).all()):
            raise RuntimeError("non-finite final costs")
        bad = bad_pixel_rate(dis[0] / cfg.dis_scale, pair.disp_left,
                             pair.valid_left, 1.0)
        bad_r = bad_pixel_rate(dis[1] / cfg.dis_scale, pair.disp_right,
                               pair.valid_right, 1.0)
        print(f"pipeline: seed {seed} {times[-1]:.1f} ms bad-pixel(nonocc) "
              f"@1px left {bad:.4f} right {bad_r:.4f}")
        if bad > BAD_PIXEL_MAX:
            raise RuntimeError(f"seed {seed}: bad-pixel {bad} > "
                               f"{BAD_PIXEL_MAX}")
    counts = {"k1": window_cost.launches, "k2": quadrant_build.launches,
              "k1_plain": plane_cost.launches,
              "k2_plain": prescreen_volume.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"pipeline: launches {counts}")
    if counts["k1"] == 0 or counts["k2"] == 0:
        raise RuntimeError("a kernel of the main path never launched")
    if counts["k1_plain"] or counts["k2_plain"]:
        raise RuntimeError("the main path ran a plain version on the card")
    print(f"pipeline: ms/pair per run {times}; median of runs 2-4 "
          f"{sorted(times[1:])[1]:.1f}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    rec["k1"]["launches"] = counts["k1"]
    rec["k2"]["launches"] = counts["k2"]

    # small pair: card (kernels) vs CPU (plain versions), same draws
    small = make_pair(h=48, w=64, max_dis=12, seed=3)
    scfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11, vol_dtype="f32")
    o_gpu = run_pair_np(small.left, small.right, scfg, device=dev,
                        draws=TorchDraws(0, "cpu"))
    o_cpu = run_pair_np(small.left, small.right, scfg, device="cpu",
                        draws=TorchDraws(0, "cpu"))
    agree = float((np.abs(o_gpu["dis"].astype(int)
                          - o_cpu["dis"].astype(int)) <= 1).mean())
    print(f"small pair card vs CPU: {agree:.4f} of u8 pixels within 1")
    if agree < SMALL_AGREE_MIN:
        raise RuntimeError(f"card vs CPU agreement {agree} < "
                           f"{SMALL_AGREE_MIN}")

    pkg = "crossscalepatchmatch_tpu_torch"
    kernels = [
        dict(name="window_cost (K1)", route="cuda",
             source=f"{pkg}/csrc/window_cost.cu",
             replaces="crossscalepatchmatch_tpu/ops/pallas/window_cost.py:138",
             **rec["k1"]),
        dict(name="quadrant_build (K2)", route="cuda",
             source=f"{pkg}/csrc/quadrant_build.cu",
             replaces=("crossscalepatchmatch_tpu/ops/pallas/"
                       "quadrant_build.py:45"),
             **rec["k2"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
