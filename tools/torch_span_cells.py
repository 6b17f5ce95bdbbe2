"""The benchmark's cells (BENCHMARK.json) with the port's spans recorded:
where a pair's host milliseconds and the device's idle gaps go, layer by
layer, and what recording costs.

    python tools/torch_span_cells.py [--workload NAME ...] [--pairs N]
                                     [--seed S] [--out PATH]

Each cell runs the benchmark's closed loop (stereobench.workload.Loop: its
frames, draws and entry point from the seed) and its warm-up pairs, then
N pairs a run, in turns: nothing recorded, spans recorded
(utils/spans), spans, nothing; then under torch.profiler's device
activity: profiler and spans, profiler alone, profiler alone, profiler and
spans.  The host readings come from the spans-only runs, the device
readings from the last profiled run with spans, whose device ops are each
put down to the span open at their launch (utils/profiling): the
per-layer readings draws.host_ms, optimizer.host_ms,
volume_build.device_ms and postprocess.device_ms, host / self / device
ms and launches a pair by span, the share of refinement stages that
kernel RPROP proposed (the refine spans' `fused`), the no-volume data
term the pairs ran (the fly_data spans' `lerp`: "cost" for K5, "image"
for K6; none with a volume), the device's idle gaps by the span the host
was in, the share of device ops joined to a
launch inside a pair span, the quartiles of start - launch (the device's
clock against the host's), the profile against the program's launch
counters, and each run's ms a pair.  Prints one line of JSON a cell
and, with --out, writes them all there.  Needs a CUDA device.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = ("off", "spans", "spans", "off") * 2 + (
    "profiled_spans", "profiled", "profiled", "profiled_spans")


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(cell, pairs: int, seed: int, device="cuda") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from crossscalepatchmatch_tpu_torch.utils import profiling, spans
    from stereobench import families, workload

    dev = torch.device(device)
    activity = (ProfilerActivity.CUDA if dev.type == "cuda"
                else ProfilerActivity.CPU)
    loop = workload.Loop(cell, seed, dev)
    for _ in range(cell.traffic["warmup_pairs"]):
        loop.step()
    ms = {r: [] for r in dict.fromkeys(RUNS)}
    walls = {r: [] for r in dict.fromkeys(RUNS)}

    def run(kind):
        loop.sync()
        before = families.read_counters()
        with contextlib.ExitStack() as stack:
            prof = (stack.enter_context(profile(activities=[activity]))
                    if kind.startswith("profiled") else None)
            rec = (stack.enter_context(spans.recording())
                   if kind.endswith("spans") else None)
            win = loop.run(pairs=pairs, maps=None)
            loop.sync()
        ms[kind].append(statistics.median(win.ms))
        walls[kind].append(win.seconds)
        if prof is None:
            return rec, None, {}
        ops = profiling.device_ops(prof)
        after = families.read_counters()
        # the profile against the program's launch counters, as the
        # benchmark holds its trace
        missing = {f.name: after[f.name] - before[f.name]
                   - sum(f.counted in o[2] for o in ops)
                   for f in families.FAMILIES if after[f.name] is not None}
        return rec, ops, missing

    for kind in RUNS:
        rec, ops, missing = run(kind)
        if kind == "spans":
            host = rec
        elif kind == "profiled_spans":
            traced = rec, ops, missing
    for _ in range(2):
        if not any(traced[2].values()):
            break
        traced = run("profiled_spans")
    traced, ops, missing = traced
    owner = profiling.owners([o[3] for o in ops], traced)
    table = profiling.span_table(host, pairs, traced, ops, owner)
    paths = profiling.span_paths(traced)
    gaps: dict = {}
    for g in profiling.idle_gaps(ops, traced, paths):
        gaps[g["span"]] = gaps.get(g["span"], 0.0) + g["ms"] / pairs
    busy_ms = profiling.busy_union([(a, b) for a, b, _, _ in ops]) * 1e-6
    untraced_ms = 1e3 * walls["off"][-1]
    in_pair = sum(o is not None for o in owner)
    lead = [a - t for a, _, _, t in ops if t is not None]
    return {
        "cell": cell.name, "seed": seed, "pairs": pairs,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "power_limit": _power_limit() if dev.type == "cuda" else None,
        "ms_pair": ms, "window_s": walls,
        "layers": profiling.layer_metrics(table),
        "refine_fused_share": profiling.fused_share(host),
        "fly_lerp": sorted({sp.attrs["lerp"] for sp in host
                            if sp.name == "fly_data"}),
        "spans_per_pair": len(host) / pairs,
        "launches_per_pair": len(ops) / pairs,
        "joined_pct": 100.0 * in_pair / max(len(ops), 1),
        "launch_lead_us": ([q * 1e-3 for q in statistics.quantiles(lead, n=4)]
                           if len(lead) > 1 else None),
        "family_launches_missing": missing,
        "device_busy_ms_pair": busy_ms / pairs,
        "idle_pct": 100.0 * (1 - busy_ms / untraced_ms),
        "spans": table,
        "idle_gaps": top(gaps)}


def _power_limit():
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", default=None)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 17)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    from stereobench import workload

    names = args.workload or [w["name"] for w in workload.load_json(
        os.path.join(workload.ROOT, "BENCHMARK.json"))["workloads"]]
    results = []
    for name in names:
        t0 = time.perf_counter()
        res = run_cell(workload.load_cell(name), args.pairs, args.seed)
        res["cell_s"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
