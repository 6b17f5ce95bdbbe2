"""Time the port's K1, K2, K3, K4, fly, QRANK, WMF, GRDV, census volume and
BFV kernels on a CUDA card, optionally against another checkout of the
repository.

    python tools/torch_kernel_ab.py [--parent DIR] [--reps 5]

Shapes: the bench scene (375x450, max_dis 60, wnd 35) and, for the fly
kernel, the KITTI scene (375x1242, max_dis 128).  Cases: K4 at K = 1, 2 and
3 (5-level census pyramid, bf16 and f32 volumes); the fly kernel as K5 at
K = 1, 2 and 3, as the strided prescreen (K3: stride 2, K = 8 and 5), as K6
(image lerp), K7 (Lab) and the 5-level cross-scale fly, K5 and K3 also on
the KITTI scene; K1 at K = 1 and 2, K3's volume form (stride 2, K = 8) and
K2 on the bench scene's GRD volume (bf16 and f32), K1 (K = 1) and K2 on the
KITTI scene's 129 slices; QRANK on K2's output (f32 GRD volumes) at the
bench and KITTI shapes, K = 8 and 1 on random planes (test_planes) and
K = 8 on the pipeline's candidates (the propagation stencil's neighbours
of the seed-0 run_pair output's final planes); WMF on the seed-0
CEN_CS_PP and KITTI pairs' inputs (the filled maps, the images, the
LR-invalid masks) and in band form on the bench scene's middle tile of a
(1, 3, 2) mesh (the CEN_CS_PP inputs with their half-window halo), the
wrapper and, where the checkout has prepare_median, the kernel's launch
alone; GRDV (grd_volumes: both views, the wrapper) on the bench and KITTI
scenes and the bench tile's full-width row band; the census volumes as
build_volumes makes them (CENV, or the plain census in a checkout without
it) at each of the bench scene's 5 CEN_CS_PP levels, all levels together
and a KITTI-size level; BFV (bilateral_volumes_cuda: both views, wnd 35) on
the bench scene's and the KITTI scene's GRD volumes, README_DEMO-BF's level
(375x450, D 61) and KITTI-BF's (375x1242, D 129).  Every time is CUDA
events around `reps` launches after a warm-up (GRDV, the census volumes
and BFV also their kernels' device time a call, from torch.profiler, and
the kernels a call); where the checkout has prepared pairs (prepare_fly,
prepare_cross_scale, prepare_volumes), the preparation (packing, the
pair-layout volumes) is outside the timed region, and a checkout without
prepare_volumes has its K1 / K2 entries called on pre-packed inputs.

First it runs README_DEMO and CEN_CS_PP on the bench scene and KITTI
(with its volumes) on the KITTI scene, seed 0, three times each: the seed-0 `dis` digest, the
ms/pair of each run and the peak device memory.

--parent DIR: a checkout of another commit (e.g. `git archive` of the
parent unpacked under build/); its kernels are built and timed in a process
of their own before and after this checkout's, so the order is parent,
change, parent on one card.  Prints one JSON line per process with every
time in ms.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import and time")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.parent:
        me = os.path.abspath(__file__)
        steps = [[sys.executable, me, "--root", args.parent],
                 [sys.executable, me],
                 [sys.executable, me, "--root", args.parent]]
        for cmd in steps:
            cmd += ["--reps", str(args.reps)]
            print("+", " ".join(cmd), flush=True)
            rc = subprocess.run(cmd).returncode
            if rc:
                return rc
        return 0

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, KITTI, CSPMConfig,
                                                README_DEMO)
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models import postprocess as pp_mod
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.ops import onthefly_cost, plane_cost
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import (_build,
                                                         cross_scale_cost,
                                                         fly_cost, pack_bgr,
                                                         quadrant_build,
                                                         quadrant_rank,
                                                         window_cost)
    from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median as wmf
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    prepared = hasattr(fly_cost, "prepare_fly")
    print(f"{card} | root {args.root} | prepared wrappers: {prepared}")
    _build.build(verbose=True)
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def timed(name, fn):
        t = chip_smoke.time_turns({"k": fn}, {"k": args.reps})["k"]
        times[name] = t
        print(f"{name}: {t:.3f} ms", flush=True)

    # -- the volume paths: seed-0 output digest, ms/pair, peak memory ---------
    def path_case(name, cfg, scene):
        pair, l, r = scene
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run_pair(l, r, 0, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        digest = hashlib.sha256(out["dis"].cpu().numpy().tobytes()
                                ).hexdigest()[:16]
        times[f"{name} ms/pair"] = ms
        times[f"{name} peak MiB"] = peak
        print(f"{name}: seed 0 dis digest {digest}, ms/pair {ms}, peak "
              f"{peak:.1f} MiB", flush=True)

    def fly_case(name, cfg, scene, k, lerp, stride):
        pair, l, r = scene
        fd = onthefly_cost.build_fly_data(l, r, cfg)
        levels = len(fd.imgs)
        wg = ([float(x) for x in scale_weights(cfg.scale_num,
                                               cfg.reg_lambda)]
              if levels > 1 else None)
        kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis, lerp=lerp,
                  gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha,
                  tau_clr=cfg.tau_clr, tau_grd=cfg.tau_grd,
                  border_thres=cfg.border_thres)
        abc = chip_smoke.test_planes(pair, cfg.max_dis, k, gen, dev)
        if prepared:
            prep = fly_cost.prepare_fly(fd, wg, **kw)

            def fn():
                return fly_cost.fly_cost_prepared(
                    prep, abc, half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
                    levels=levels, wnd_stride=stride)
        else:
            def fn():
                return fly_cost.fly_cost_cuda(fd, wg, abc, wnd_stride=stride,
                                              **kw)
        timed(name, fn)

    def scene_of(shape):
        pair = make_pair(seed=0, **shape)
        return (pair, torch.as_tensor(pair.left, device=dev),
                torch.as_tensor(pair.right, device=dev))

    bench = scene_of(chip_smoke.SHAPE)
    kitti = scene_of(chip_smoke.KITTI_SHAPE)
    fcfg = dataclasses.replace(README_DEMO, precompute_volume=False)
    kcfg = dataclasses.replace(KITTI, precompute_volume=False)
    md = README_DEMO.max_dis
    path_case("README_DEMO", README_DEMO, bench)
    path_case("CEN_CS_PP", CEN_CS_PP, bench)
    path_case("KITTI", KITTI, kitti)

    # -- the volume build: GRDV and the census volumes --------------------------
    from torch.profiler import ProfilerActivity, profile

    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volumes
    from crossscalepatchmatch_tpu_torch.ops.cuda import grd_volume
    from crossscalepatchmatch_tpu_torch.ops.pyramid import build_pyramid

    def timed_device(name, fn):
        """fn's time (CUDA events, as timed) and its kernels' device time
        and count a call (the profiler over `reps` calls)."""
        timed(name, fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type.name == "CUDA"]
        dev_ms = sum(e.time_range.end - e.time_range.start
                     for e in ks) / 1e3 / args.reps
        times[f"{name} device"] = dev_ms
        times[f"{name} kernels"] = len(ks) / args.reps
        print(f"{name}: device {dev_ms:.4f} ms, {len(ks) / args.reps:g} "
              f"kernels a call", flush=True)

    for tag, (_, l, r), cfg, rows in (
            ("bench", bench, README_DEMO, slice(None)),
            ("KITTI", kitti, KITTI, slice(None)),
            ("band (bench tile rows 125-250)", bench, README_DEMO,
             slice(125, 250))):
        lv, rv = bgr_to_rgb(l[rows]), bgr_to_rgb(r[rows])
        timed_device(f"GRDV {tag}", lambda: grd_volume.grd_volumes(
            lv, rv, cfg.max_dis, alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
            tau_grd=cfg.tau_grd, border_thres=cfg.border_thres))
    for tag, (_, l, r), cfg, levels in (("bench", bench, CEN_CS_PP, 5),
                                        ("KITTI", kitti, dataclasses.replace(
                                            KITTI, cost_method=CEN_CS_PP.
                                            cost_method), 1)):
        lp, rp = build_pyramid(l, levels), build_pyramid(r, levels)
        lvs = [(bgr_to_rgb(lp[s]), bgr_to_rgb(rp[s]), cfg.max_dis >> s)
               for s in range(levels)]
        if levels > 1:
            for s, (a, b, m) in enumerate(lvs):
                timed_device(f"census volume {tag} level {s}",
                             lambda: build_volumes(a, b, m, cfg))
        timed_device(f"census volume {tag} all {levels} level(s)",
                     lambda: [build_volumes(a, b, m, cfg)
                              for a, b, m in lvs])
    # -- BFV: README_DEMO-BF's and KITTI-BF's level ---------------------------
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume

    for tag, (_, l, r), cfg in (("README_DEMO level", bench, README_DEMO),
                                ("KITTI level", kitti, KITTI)):
        vd = build_volume_data(l, r, cfg)
        vols, guides = vd.vols[0], vd.imgs[0]
        del vd
        timed_device(f"BFV {tag}", lambda: bilateral_volume.
                     bilateral_volumes_cuda(vols, guides, cfg.wnd_size))
        del vols, guides
    fly_case("K5 K=1", fcfg, bench, 1, "cost", 1)
    fly_case("K5 K=2", fcfg, bench, 2, "cost", 1)
    fly_case("K5 K=3", fcfg, bench, 3, "cost", 1)
    fly_case("K3 fly stride 2 K=8", fcfg, bench, 8, "cost", 2)
    fly_case("K3 fly stride 2 K=5", fcfg, bench, 5, "cost", 2)
    fly_case("K6 K=1", fcfg, bench, 1, "image", 1)
    fly_case("K6 K=2", fcfg, bench, 2, "image", 1)
    fly_case("K7 K=1", CSPMConfig(max_dis=md, precompute_volume=False,
                                  use_lab_weights=True), bench, 1, "cost", 1)
    fly_case("K5 cross-scale K=1",
             CSPMConfig(max_dis=md, precompute_volume=False, use_cs=True,
                        reg_lambda=0.3), bench, 1, "cost", 1)
    fly_case("K5 KITTI K=1", kcfg, kitti, 1, "cost", 1)
    fly_case("K5 KITTI K=2", kcfg, kitti, 2, "cost", 1)
    fly_case("K3 fly KITTI stride 2 K=8", kcfg, kitti, 8, "cost", 2)

    # -- K4 -------------------------------------------------------------------
    ccfg = CEN_CS_PP
    pair, l, r = bench
    cvd = build_volume_data(l, r, ccfg)
    wgts = [float(x) for x in scale_weights(ccfg.scale_num, ccfg.reg_lambda)]
    kw4 = dict(half_wnd=ccfg.half_wnd, max_dis=ccfg.max_dis,
               gamma=ccfg.wgt_gamma)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        vols = [v.to(dtype) for v in cvd.vols]
        for k in (1, 2, 3):
            abc = chip_smoke.test_planes(pair, ccfg.max_dis, k, gen, dev)
            if prepared:
                prep = cross_scale_cost.prepare_cross_scale(
                    cvd.imgs, vols, cvd.max_costs, wgts, **kw4)

                def fn():
                    return cross_scale_cost.cross_scale_cost_prepared(
                        prep, abc, half_wnd=ccfg.half_wnd,
                        max_dis=ccfg.max_dis, levels=len(vols))
            else:
                def fn():
                    return cross_scale_cost.cross_scale_cost_cuda(
                        cvd.imgs, vols, cvd.max_costs, wgts, abc, **kw4)
            timed(f"K4 {tag} K={k}", fn)
    # -- K1, K3's volume form, K2 --------------------------------------------
    # the parent (no prepare_volumes) takes its C entries directly on
    # pre-packed inputs and the plain D-minor volume, so on both sides the
    # packing and the layout copy stay outside the timed region
    has_prep = hasattr(window_cost, "prepare_volumes")
    lib = _build.load()

    def volume_cases(tag, scene, cfg, cases):
        pair, l, r = scene
        vd = build_volume_data(l, r, cfg)
        imgs, mc = vd.imgs[0], vd.max_costs[0]
        h, w = imgs.shape[1:3]
        d = cfg.max_dis + 1
        kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
                  gamma=cfg.wgt_gamma)
        st = _build.stream_of(mc)
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            vols = vd.vols[0].to(dtype).contiguous()
            if has_prep:
                prep = window_cost.prepare_volumes(imgs, vols, mc, **kw)

                def k1(abc, stride):
                    return lambda: window_cost.window_cost_prepared(
                        prep, abc, half_wnd=cfg.half_wnd,
                        max_dis=cfg.max_dis, wnd_stride=stride)

                def k2():
                    return quadrant_build.quadrant_volumes_prepared(
                        prep, half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
                        stride=cfg.prescreen_stride)
            else:
                bf = int(dtype == torch.bfloat16)
                img = pack_bgr(imgs)
                lut = plane_cost.asw_lut(cfg.wgt_gamma, dev)
                bq = torch.empty((2, 4, h, w, d), device=dev)
                wq = torch.empty((2, 4, h, w), device=dev)

                def k1(abc, stride):
                    out = torch.empty(abc.shape[:-1], device=dev)
                    return lambda: lib.cspm_window_cost(
                        img.data_ptr(), vols.data_ptr(), bf, mc.data_ptr(),
                        abc.data_ptr(), lut.data_ptr(), out.data_ptr(),
                        abc.shape[1], h, w, d, cfg.half_wnd, cfg.max_dis,
                        stride, st)

                def k2():
                    return lib.cspm_quadrant_build(
                        img.data_ptr(), vols.data_ptr(), bf, lut.data_ptr(),
                        bq.data_ptr(), wq.data_ptr(), h, w, d, cfg.half_wnd,
                        cfg.prescreen_stride, st)
            for kind, k, stride in cases:
                if kind == "K2":
                    timed(f"K2 {tag} {dt}", k2)
                else:
                    abc = chip_smoke.test_planes(pair, cfg.max_dis, k, gen,
                                                 dev)
                    timed(f"{kind} {tag} {dt} K={k} stride {stride}",
                          k1(abc, stride))

    volume_cases("bench", bench, README_DEMO,
                 [("K1", 1, 1), ("K1", 2, 1), ("K3 volume", 8, 2),
                  ("K2", 0, 0)])
    volume_cases("KITTI", kitti, KITTI, [("K1", 1, 1), ("K2", 0, 0)])

    # -- QRANK ----------------------------------------------------------------
    def qrank_cases(tag, scene, cfg):
        pair, l, r = scene
        vd = build_volume_data(l, r, cfg)
        kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis)
        # QRANK came after prepare_volumes: a checkout with it has both
        prep = window_cost.prepare_volumes(
            vd.imgs[0], vd.vols[0], vd.max_costs[0], gamma=cfg.wgt_gamma, **kw)
        del vd
        bq, wq = quadrant_build.quadrant_volumes_prepared(
            prep, half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
            stride=cfg.prescreen_stride)
        mc = prep.max_costs
        del prep
        cases = [(f"random K={k}", chip_smoke.test_planes(
            pair, cfg.max_dis, k, gen, dev)) for k in (8, 1)]
        cases.append(("pipeline K=8", pm.stencil_candidates(
            run_pair(l, r, 0, cfg)["abc"], pm._stencil(cfg, 0)
        ).contiguous()))
        for name, abc in cases:
            timed(f"QRANK {tag} {name}",
                  lambda: quadrant_rank.quadrant_rank_cuda(bq, wq, mc, abc,
                                                           **kw))

    qrank_cases("bench", bench, README_DEMO)
    qrank_cases("KITTI", kitti, KITTI)

    # -- WMF ------------------------------------------------------------------
    def wmf_inputs(cfg, scene):
        pair, l, r = scene
        out = run_pair(l, r, 0, cfg)
        valid = out["valid"]
        dis = pp_mod.fill_invalid(pm.plane_to_disp(out["abc"],
                                                   cfg.dis_scale),
                                  out["abc"], valid, cfg)
        return dis, torch.stack([l, r]), valid

    def wmf_case(name, cfg, inputs, **band):
        lut = plane_cost.asw_lut(cfg.wmf_gamma, dev)
        timed(f"WMF {name} wrapper", lambda: wmf.weighted_median_cuda(
            *inputs, lut, half_wnd=cfg.half_wnd, **band))
        if hasattr(wmf, "prepare_median"):
            r0, c0 = band.get("center_row0", 0), band.get("center_col0", 0)
            oh = band.get("out_h") or inputs[0].shape[1]
            ow = band.get("out_w") or inputs[0].shape[2]
            prep = wmf.prepare_median(*inputs, r0, oh, c0, ow)
            timed(f"WMF {name} launch alone",
                  lambda: wmf.weighted_median_prepared(
                      prep, lut, half_wnd=cfg.half_wnd))

    cs_in = wmf_inputs(CEN_CS_PP, bench)
    wmf_case("CEN_CS_PP", CEN_CS_PP, cs_in)
    wmf_case("KITTI", KITTI, wmf_inputs(KITTI, kitti))
    # the bench scene's middle tile of a (1, 3, 2) mesh with its halo
    hw = CEN_CS_PP.half_wnd
    hs, ws = chip_smoke.SHAPE["h"] // 3, chip_smoke.SHAPE["w"] // 2
    row0, col0 = hs, ws

    def ext(x):
        return _ext_from_full(_ext_from_full(x, row0, hs, hw, 1), col0, ws,
                              hw, 2).contiguous()

    dis, imgs, valid = cs_in
    wmf_case("band form (bench tile)", CEN_CS_PP,
             (ext(dis), ext(imgs), ext(valid.to(torch.uint8)).bool()),
             center_row0=hw, out_h=hs, center_col0=hw, out_w=ws)
    print(json.dumps({"card": card, "root": args.root, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
