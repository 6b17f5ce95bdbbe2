"""Where one run_pair of the PyTorch port spends its time on a CUDA card.

    python tools/torch_profile_pair.py [--config README_DEMO|CEN_CS_PP|
                                                 README_DEMO-fly|KITTI-fly|
                                                 KITTI|README_DEMO-BOX|
                                                 README_DEMO-GF|
                                                 README_DEMO-BF|
                                                 README_DEMO-warm]
                                       [--h 375 --w 450 --max-dis 60]

Runs the port's main path at the named config once to warm up, then once
under torch.profiler (CPU + CUDA activities), and prints: the wall time of
the profiled pair, the summed device time, the device's idle share over the
pair (1 - busy/wall, busy being the union of kernel intervals), the host
time, device time and launches per top-level phase (record_function
ranges, with a synchronise at each phase end: the volume build (or, without
a volume, the channel planes' build `fly_data`), the cost functions (the K2
build on the volume path), the rank phase, the exact phase, plane_to_disp
and `postprocess` when the config post-processes; the -BOX/-GF/-BF
configs filter the volumes in `volume_build`; README_DEMO-warm profiles a
warm frame, run_pair_warm's one iteration as `warm_phase`, on the
scene's next frame (new sensor noise) from the first frame's planes), and
the top CUDA kernels by device time.  Writes the Chrome trace to
chiprun_out/torch_profile_pair.json.gz.  Needs a CUDA device.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def busy_union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    from crossscalepatchmatch_tpu_torch import config
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.models.postprocess import postprocess
    from crossscalepatchmatch_tpu_torch.ops import cost_volume, onthefly_cost
    from crossscalepatchmatch_tpu_torch.utils.rng import (PHASE_WARM,
                                                          TorchDraws)

    configs = {
        "README_DEMO": config.README_DEMO, "CEN_CS_PP": config.CEN_CS_PP,
        "README_DEMO-fly": dataclasses.replace(config.README_DEMO,
                                               precompute_volume=False),
        "KITTI-fly": dataclasses.replace(config.KITTI,
                                         precompute_volume=False),
        "KITTI": config.KITTI,
        **{f"README_DEMO-{a.value}": dataclasses.replace(
            config.README_DEMO, aggregator=a) for a in
           (config.Aggregator.BOX, config.Aggregator.GF,
            config.Aggregator.BF)},
        "README_DEMO-warm": config.README_DEMO}
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=tuple(configs),
                    default="README_DEMO")
    ap.add_argument("--h", type=int, default=None,
                    help="default 375")
    ap.add_argument("--w", type=int, default=None,
                    help="default 450, 1242 for KITTI and KITTI-fly")
    ap.add_argument("--max-dis", type=int, default=None,
                    help="default the config's max_dis")
    args = ap.parse_args()
    cfg = configs[args.config]
    warm = args.config.endswith("-warm")
    args.h = args.h or 375
    args.w = args.w or (1242 if args.config.startswith("KITTI") else 450)
    args.max_dis = args.max_dis or cfg.max_dis
    dev = torch.device("cuda:0")
    pair = make_pair(h=args.h, w=args.w, max_dis=args.max_dis, seed=0)
    l = torch.as_tensor(pair.left, device=dev)
    r = torch.as_tensor(pair.right, device=dev)
    prior = run_pair(l, r, 0, cfg, device=dev)["abc"]
    if warm:
        nxt = make_pair(h=args.h, w=args.w, max_dis=args.max_dis, seed=0,
                        noise_sigma=2.0)
        l = torch.as_tensor(nxt.left, device=dev)
        r = torch.as_tensor(nxt.right, device=dev)
    torch.cuda.synchronize()

    def phase(name, fn):
        # synchronise at each phase end so the kernels that start between
        # two phase starts belong to the earlier phase
        with record_function(name):
            out = fn()
            torch.cuda.synchronize()
        return out

    def phases():
        draws = TorchDraws(1, dev)
        hw = (args.h, args.w)
        n_rank = cfg.rank_iters
        if cfg.precompute_volume:
            vd = phase("volume_build",
                       lambda: cost_volume.build_volume_data(l, r, cfg))
            cost_fn, sparse_fn = phase("quadrant_build_K2",
                                       lambda: pm.make_cost_fns(cfg, vd))
            pp_imgs = vd.imgs[0]
        else:
            fd = phase("fly_data",
                       lambda: onthefly_cost.build_fly_data(l, r, cfg))
            cost_fn, sparse_fn = pm.make_fly_cost_fns(cfg, fd)
            pp_imgs = fd.imgs[0]

        def rank():
            st = pm.init_state(draws, hw, sparse_fn if n_rank else None,
                               cfg, device=dev)
            return pm.iterate(st, 0, n_rank, draws, cost_fn, cfg, sparse_fn,
                              n_rank=n_rank)

        def exact(st):
            return pm.iterate(st, n_rank, cfg.max_iter, draws, cost_fn, cfg,
                              sparse_fn, n_rank=n_rank)

        def warm_step():
            st = pm.PMState(abc=prior, cost=torch.full(
                prior.shape[:-1], float("inf"), device=dev))
            return pm.iterate(st, 0, 1, TorchDraws(1, dev,
                                                   refine_phase=PHASE_WARM),
                              cost_fn, cfg, sparse_fn)

        if warm:
            st = phase("warm_phase", warm_step)
        else:
            st = phase("rank_phase", rank)
            st = phase("exact_phase", lambda: exact(st))
        dis = phase("plane_to_disp", lambda: pm.plane_to_disp(st.abc,
                                                              cfg.dis_scale))
        if cfg.use_pp:
            phase("postprocess",
                  lambda: postprocess(dis, st.abc, pp_imgs, cfg))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        phases()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    names = ("volume_build", "fly_data", "quadrant_build_K2", "rank_phase",
             "exact_phase", "warm_phase", "plane_to_disp", "postprocess")
    events = prof.events()
    # the phase ranges also appear on the device timeline as annotations;
    # they are not kernels
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and e.name not in names]
    busy_us = busy_union([(e.time_range.start, e.time_range.end)
                          for e in kernels])
    dev_us = sum(e.time_range.end - e.time_range.start for e in kernels)
    print(f"profiled pair: wall {wall_ms:.1f} ms, device kernel time "
          f"{dev_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, "
          f"idle share {1 - busy_us / 1e3 / wall_ms:.3f}, "
          f"{len(kernels)} kernel launches")
    ranges = sorted((e for e in events if e.name in names
                     and e.device_type.name == "CPU"),
                    key=lambda e: e.time_range.start)
    if not kernels:
        print("the profiler recorded no device kernels")
    for i, rg in enumerate(ranges):
        s = rg.time_range.start
        nxt = (ranges[i + 1].time_range.start if i + 1 < len(ranges)
               else float("inf"))
        inside = [(k.time_range.start, k.time_range.end) for k in kernels
                  if s <= k.time_range.start < nxt]
        print(f"phase {rg.name}: host {(rg.time_range.end - s) / 1e3:.1f} "
              f"ms, device busy {busy_union(inside) / 1e3:.1f} ms, "
              f"{len(inside)} kernel launches")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                    max_name_column_width=60))
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/torch_profile_pair.json.gz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
