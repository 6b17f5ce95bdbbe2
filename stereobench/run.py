"""Run one cell of the benchmark once, on the card it is started on.

    python3 -m stereobench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell is a `workloads` entry of
BENCHMARK.json; its configuration (stereobench/configs/<config>.json) and
traffic mix (stereobench/traffic/<traffic>.json) are data, and each
per-layer metric has a reader of its own (stereobench/layers/<metric>.py).

Set-up (setup_s): import torch and the program, make the configuration's
scenes, put the frames on the card (each scene with fresh sensor noise
drawn from the seed), and run the mix's warm-up pairs, whose first call
builds and loads the kernels.  Then, with --trace 0, the window: a closed
loop, one pair in flight, for --seconds; the end-to-end metrics.  With
--trace 1 the same loop runs the mix's trace_pairs pairs under
torch.profiler instead; the per-layer metrics.  Each pair's left map is
kept (copied to the host after its latency is read; held on the device in
the short traced window) and scored against the scene's ground truth once
the window has closed.  After the window a sample of its pairs, drawn from
the seed, is held against the configuration's plain reference, and the
window's bad-pixel share against its limit (stereobench.check).  The last
line of standard output is one JSON object:
correct, attempted, failed, metrics, device (and breakdown when traced),
then "checks", each number compared beside its limit.

Exits 2, printing no result, without a CUDA device (or with fewer than the
cell asks for), and 3 if jax, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# a library that could load JAX by itself must not
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, workload  # noqa: E402
from . import trace as tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "crossscalepatchmatch_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(obj):
    """obj with every float that is not finite replaced by None (JSON has no
    infinity)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def run_cell(cell: workload.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float) -> dict:
    """One run of the cell; its result (the last line's object)."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    log(f"{cell.name}: torch imported at "
        f"{time.perf_counter() - t0:.3f} s")
    loop = workload.Loop(cell, seed, dev)
    log(f"{cell.name}: frames on the device at "
        f"{time.perf_counter() - t0:.3f} s")
    engine = cell.config["engine"]
    for i in range(cell.traffic["warmup_pairs"]):
        loop.step()
        log(f"{cell.name}: warm-up pair {i} done at "
            f"{time.perf_counter() - t0:.3f} s")
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"{cell.name}: set-up {setup_s:.3f} s, seed {seed}")

    tr = None
    if traced and on_card:
        for attempt in range(2):
            tr = tracing.record(loop, cell.traffic["trace_pairs"], engine)
            if tr.complete:
                break
            log(f"{cell.name}: trace {attempt} incomplete, profiler against "
                f"counters {tr.mismatches}")
        win = tr.window
    elif traced:
        win = loop.run(pairs=cell.traffic["trace_pairs"], maps="device")
    else:
        win = loop.run(seconds=seconds, maps="host")
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n = len(win.ms)
    # each pair's map against the ground truth, once the peak has been read
    bad = win.bad_px(loop.pool)
    bad_px_pct = sum(bad) / len(bad) if bad else math.nan

    res = {"correct": False, "attempted": n, "failed": 0, "metrics": {}}
    if traced:
        if tr is not None:
            res["metrics"] = tracing.per_layer(tr, cell.per_layer)
    else:
        res["metrics"] = {
            "pairs_per_s": {"value": n / win.seconds, "unit": "pairs/s"},
            "pair_ms_p95": {"value": float(np.percentile(win.ms, 95)),
                            "unit": "ms"},
            "peak_mem_mib": {"value": window_peak / 2 ** 20, "unit": "MiB"},
            "bad_px_pct": {"value": bad_px_pct, "unit": "%"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    res["device"] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "power_limit": power_limit() if on_card else None}
    if traced:
        res["device"]["busy_s"] = tr.busy_s() if tr is not None else None
        res["device"]["window_s"] = win.seconds
        res["breakdown"] = (tracing.breakdown(tr) if tr is not None
                            else {"device_ops": [], "idle_gaps": []})
    log(f"{cell.name}: {n} pairs in {win.seconds:.3f} s; "
        + ", ".join(f"{k} {v['value']!r} {v['unit']}"
                    for k, v in res["metrics"].items()))

    # the check, once the window has closed and its peak has been read
    kept = win.kept
    del win, tr
    loop.prior = None
    rows = check.judge(kept, loop.pool.frame, engine,
                       cell.reference)["program"]
    limits = cell.config["limits"]
    correct, failed, window_ok, numbers = check.verdict(
        rows, {"bad_px_pct": bad_px_pct}, limits)
    res["correct"] = correct
    res["failed"] = failed if window_ok else n
    res["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in check.NUMBERS + check.WINDOW_NUMBERS}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = workload.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"stereobench: cell {cell.name} needs {cell.chips} CUDA "
            f"device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
            "visible.  No result.")
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   _T0)
    found = forbidden_modules()
    if found:
        log(f"stereobench: loaded in this process: {found}.  No result.")
        return 3
    log(f"correct {res['correct']}, {res['failed']} of the checked pairs "
        "failed")
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
