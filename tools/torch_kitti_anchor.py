"""Production-size accuracy anchor of the PyTorch port: the --engine-only
side of tools/kitti_anchor.py on the port's engine.

    python tools/torch_kitti_anchor.py [--h 256 --w 832 --max_dis 96
                                        --dis_scale 2 --cc GRD
                                        --engine-seeds 5 --thresh 3.0]
                                       [--device cuda]

Runs the port on kitti_anchor.py's one KITTI-like synthetic scene
(make_pair seed 7; GRD + post-processing) for seeds 0 .. engine-seeds-1
and scores it @thresh px against every oracle seed cached in
tools/.kitti_anchor_cache.json under the scene's key
("256x832_d96_GRD_pp"), read only: the oracle takes hours a seed on a CPU,
so a geometry without cached scores exits 1.  Prints kitti_anchor.py's
result JSON (bad_oracle, bad_engine, delta, delta_ci95_hi with its
unpaired bootstrap, bound, seeds, t_oracle_s, t_engine_s), plus ms_pair
(the median of the runs after the first), the per-seed scores and the
device.  Exit 1 when the bootstrap upper bound is over 0.005.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None, engine=None, oracle=None) -> int:
    """engine / oracle: an evaluation.Engine and OracleScores to use
    instead of the port on --device and the repository's caches."""
    from crossscalepatchmatch_tpu_torch import evaluation as ev

    a = ev.ANCHOR
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=a["h"])
    ap.add_argument("--w", type=int, default=a["w"])
    ap.add_argument("--max_dis", type=int, default=a["max_dis"])
    ap.add_argument("--dis_scale", type=int, default=a["dis_scale"])
    ap.add_argument("--cc", default=a["cc"])
    ap.add_argument("--engine-seeds", type=int, default=a["engine_seeds"])
    ap.add_argument("--thresh", type=float, default=a["thresh"],
                    help="bad-pixel threshold (KITTI convention: 3 px)")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    args = ap.parse_args(argv)
    import torch

    if engine is None:
        if torch.device(args.device).type == "cuda" and \
                not torch.cuda.is_available():
            print("torch_kitti_anchor: no CUDA device", file=sys.stderr)
            return 1
        engine = ev.engine_on(args.device)
    res = ev.run_anchor(engine, oracle or ev.OracleScores(), h=args.h,
                        w=args.w, max_dis=args.max_dis,
                        dis_scale=args.dis_scale, cc=args.cc,
                        engine_seeds=args.engine_seeds, thresh=args.thresh)
    if res is None:
        print("no cached oracle scores for this scene (tools/"
              "kitti_anchor.py --oracle-only computes them)",
              file=sys.stderr)
        return 1
    print(json.dumps({**res, "device": ev.device_name(args.device)}))
    return 0 if res["within_bound"] else 1


if __name__ == "__main__":
    sys.exit(main())
