"""The readings that the limits of stereobench.check are set from, for one
cell and many seeds in one process (the benchmark's own runs never run
this):

    python3 -m stereobench.control --workload <name> --seeds 1,2,3
        [--pairs N] [--faults state_unchanged,rank_bf16,...]

For each seed: the cell's set-up and warm-up, N pairs of its closed loop
(by default the mix's trace_pairs, the shortest window a run judges)
with each pair's map kept as a run keeps them, then every compared number:
the program's (the lower readings); on the kept sample the controls of
the configuration's reference (its CONTROLS: the plain reference put in
the program's place at a precision below the one the configuration
states); and, for each fault named, the program with that fault planted
in this process, read the same way as the program.  One JSON line a seed,
then the worst program reading and the least reading of each control and
fault.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys

import torch

from . import check, workload

def _state_unchanged(pm, loop):
    """Each iteration's step returns its state unchanged."""
    return {"iteration_step": lambda state, *a, **k: state}


def _rank_bf16(pm, loop):
    """K2's quadrant volumes and QRANK's ranking costs rounded to bfloat16:
    the ranking one precision below the configuration's float32 (the
    volume path's; a run without a volume calls neither)."""
    build, rank = pm.quadrant_volumes_prepared, pm.quadrant_rank

    def volumes(*a, **k):
        return tuple(t.to(torch.bfloat16).float() for t in build(*a, **k))

    def ranking(*a, **k):
        return rank(*a, **k).to(torch.bfloat16).float()

    return {"quadrant_volumes_prepared": volumes, "quadrant_rank": ranking}


def _half_candidates(pm, loop):
    """Every other candidate of each batch left out before the prescreen."""
    prescreen = pm._prescreen
    return {"_prescreen": lambda cand, sparse: prescreen(
        cand[:, ::2].contiguous(), sparse)}


def _fewer_rounds(pm, loop):
    """The two finest refinement rounds left out (z_stop_thres x 4)."""
    loop.cfg = dataclasses.replace(loop.cfg,
                                   z_stop_thres=4 * loop.cfg.z_stop_thres)
    return {}


def _one_sweep(pm, loop):
    """One propagation sweep an iteration fewer."""
    loop.cfg = dataclasses.replace(loop.cfg,
                                   prop_sweeps=loop.cfg.prop_sweeps - 1)
    return {}


def _no_sweeps(pm, loop):
    """No propagation sweep at all."""
    loop.cfg = dataclasses.replace(loop.cfg, prop_sweeps=0)
    return {}


FAULTS = {"state_unchanged": _state_unchanged, "rank_bf16": _rank_bf16,
          "half_candidates": _half_candidates,
          "fewer_rounds": _fewer_rounds, "one_sweep": _one_sweep,
          "no_sweeps": _no_sweeps}


@contextlib.contextmanager
def planted(fault: str | None, loop):
    """The program with `fault` planted (None: as it is)."""
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm

    saved = {}
    try:
        if fault is not None:
            for name, fn in FAULTS[fault](pm, loop).items():
                saved[name] = getattr(pm, name)
                setattr(pm, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(pm, name, fn)


def _finite(x):
    return x if math.isfinite(x) else None


def reading(cell, seed: int, pairs: int, scenes, fault: str | None,
            controls: dict) -> dict:
    """Every compared number of `pairs` pairs of the cell's loop from
    `seed`: the program's (with `fault` planted) and each control's."""
    loop = workload.Loop(cell, seed, "cuda", scenes)
    with planted(fault, loop):
        for _ in range(cell.traffic["warmup_pairs"]):
            loop.step()
        win = loop.run(pairs=pairs, maps="host")
    bad = win.bad_px(loop.pool)
    rows = check.judge(win.kept, loop.pool.frame, cell.config["engine"],
                       cell.reference, controls)
    window = {"bad_px_pct": sum(bad) / len(bad)}
    return {name: {k: _finite(v) for k, v in
                   dict(check.worst(r), **window).items()}
            for name, r in rows.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pairs", type=int, default=None)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stereobench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = workload.load_cell(args.workload)
    scenes = workload.make_scenes(cell.config, cell.traffic)
    faults = [f for f in args.faults.split(",") if f]
    pairs = args.pairs or cell.traffic["trace_pairs"]
    readings = {}
    numbers = check.NUMBERS + check.WINDOW_NUMBERS
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = {"seed": seed}
        line.update(reading(cell, seed, pairs, scenes, None,
                            cell.reference.CONTROLS))
        for f in faults:
            line[f] = reading(cell, seed, pairs, scenes, f,
                              {})["program"]
        for name, r in line.items():
            if name != "seed":
                readings.setdefault(name, []).append(r)
        print(json.dumps(line), flush=True)
    summary = {"workload": cell.name, "lower": {}, "least": {}}
    for n in numbers:
        summary["lower"][n] = max(r[n] for r in readings["program"])
        summary["least"][n] = {
            c: min((r[n] for r in readings[c] if r[n] is not None),
                   default=None)
            for c in readings if c != "program"}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
