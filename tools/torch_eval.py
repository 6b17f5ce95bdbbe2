"""Accuracy parity of the PyTorch port against the native oracle: eval.py's
config matrix (or its use_cs ablation) on the port's engine.

    python tools/torch_eval.py [--quick] [--cs-ablation] [--seeds 5]
                               [--oracle_seeds 5] [--adopt MODE]
                               [--exact-iters N] [--refine-stages N]
                               [--set KEY=VALUE ...] [--only a,b]
                               [--device cuda]

The flags are eval.py's, plus --device (the card by default).  Each row
runs the engine for seeds 0 .. seeds-1 on the row's synthetic scene and
reads the oracle's per-seed scores from .eval_oracle_cache.json (read
only; a missing entry, e.g. --oracle_seeds 3, runs the native oracle and is
kept in memory).  One line a row goes to stderr; the last stdout line is
eval.py's JSON summary (bad_pixel_delta_vs_oracle_worst, or
cs_ablation_bad_pixel with --cs-ablation), each row with its ms_pair (the
median host-clock time of the runs after the first) and a `skipped` list
(the photo rows without matplotlib's grace_hopper.jpg).  Exit 1 when a
scored row's bootstrap upper bound on the delta is over 0.005 (the matrix)
or when the device is a missing card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="first two configs only")
    ap.add_argument("--cs-ablation", action="store_true",
                    help="paired use_cs on/off comparison on the scenes "
                         "where cross-scale aggregation should help")
    ap.add_argument("--seeds", type=int, default=5,
                    help="engine seeds per config (mean is scored)")
    ap.add_argument("--oracle_seeds", type=int, default=5,
                    help="oracle seeds per config (mean is scored)")
    ap.add_argument("--adopt", default=None,
                    choices=("exact", "rank", "rank+exact"),
                    help="engine adopt_mode override")
    ap.add_argument("--exact-iters", type=int, default=None,
                    help="trailing exact iterations for rank+exact")
    ap.add_argument("--refine-stages", type=int, default=None,
                    help="batched-refinement stages override")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="CSPMConfig field override (repeatable); values "
                         "parsed as bool/int/float when possible")
    ap.add_argument("--only", default=None,
                    help="comma-separated config-name filter")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, engine=None, oracle=None) -> int:
    """engine / oracle: an evaluation.Engine and OracleScores to use
    instead of the port on --device and the repository's caches."""
    args = parse_args(argv)
    import torch

    from crossscalepatchmatch_tpu_torch import evaluation as ev

    if engine is None:
        if torch.device(args.device).type == "cuda" and \
                not torch.cuda.is_available():
            print("torch_eval: no CUDA device", file=sys.stderr)
            return 1
        engine = ev.engine_on(args.device)
    oracle = oracle or ev.OracleScores()
    device = ev.device_name(args.device)
    names = set(args.only.split(",")) if args.only else None
    if args.cs_ablation:
        scenes = [s for s in ev.CS_SCENES if names is None or s[0] in names]
        res = ev.run_cs_ablation(engine, oracle, scenes, seeds=args.seeds,
                                 oracle_seeds=args.oracle_seeds)
        print(json.dumps({**res, "device": device}))
        return 0
    rows = ev.QUICK if args.quick else ev.CONFIGS
    if names is not None:
        rows = [c for c in ev.CONFIGS if c[0] in names]
    kw = ev.overrides(args.adopt, args.exact_iters, args.refine_stages,
                      args.set)
    res = ev.run_matrix(engine, oracle, rows, seeds=args.seeds,
                        oracle_seeds=args.oracle_seeds, engine_kw=kw)
    print(json.dumps({**res, "device": device}))
    return 0 if all(r["within_bound"] for r in res["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
