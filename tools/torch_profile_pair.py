"""Where one run_pair of the PyTorch port spends its time on a CUDA card.

    python tools/torch_profile_pair.py [--config README_DEMO|CEN_CS_PP|
                                                 README_DEMO-fly|KITTI-fly|
                                                 KITTI|README_DEMO-BOX|
                                                 README_DEMO-GF|
                                                 README_DEMO-BF|KITTI-BF|
                                                 README_DEMO-warm]
                                       [--h 375 --w 450 --max-dis 60]

Runs the port's main path at the named config once to warm up, then once
recorded by span (utils/spans) under torch.profiler's device activity
(utils.profiling.profile_pair; nothing synchronises inside the pair),
and prints: the wall time of the
profiled pair, the summed device time, the device's idle share over the
pair (1 - busy/wall, busy being the union of kernel intervals), the host
time, device time and launches per phase span (each device op put down to
the span open at its launch: the volume build (or, without a volume, the
channel planes' build `fly_data`), the cost functions (the K2 build on
the volume path), the rank phase, the exact phase, plane_to_disp and
`postprocess` when the config post-processes; the -BOX/-GF/-BF configs
filter the volumes in `volume_build` (an `aggregate` span a level); README_DEMO-warm profiles a warm
frame, run_pair_warm's one iteration as `warm_phase`, on the scene's next
frame (new sensor noise) from the first frame's planes), host, self and
device ms and launches by span, the per-layer readings (draws.host_ms,
optimizer.host_ms, volume_build.device_ms, postprocess.device_ms), the
device time and launches per kernel (K1 / K2 / K4 / fly / other), the
idle ms by the phase the host was in and the longest idle gaps with the
span the host was in, and the top CUDA kernels by device time.  Writes
the Chrome trace to
chiprun_out/torch_profile_pair.json.gz.  Needs a CUDA device.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from crossscalepatchmatch_tpu_torch import config
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        format_profile, profile_pair)

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
        "KITTI-BF": dataclasses.replace(config.KITTI,
                                        aggregator=config.Aggregator.BF),
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
    # the profiled pair: draw seed 1 (a warm frame from the first frame's
    # planes)
    _, summary, prof = profile_pair(l, r, 1, cfg, device=dev,
                                    prior_abc=prior if warm else None)
    print("\n".join(format_profile(summary)))
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                    max_name_column_width=60))
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/torch_profile_pair.json.gz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
