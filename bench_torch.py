"""Benchmark of the PyTorch port (crossscalepatchmatch_tpu_torch) on one
CUDA card: stereo pairs/s, with per-phase readings, on six cells.

    python3 bench_torch.py [--config CELL] [--batch B] [--device cuda]
    python3 bench_torch.py --spread OUT [OUT ...]

The port's counterpart of bench.py.  A cell is one configuration on one
synthetic scene (data.make_pair, from its scene seed) under one traffic:
one pair at a time, each ending in torch.cuda.synchronize(), timed on the
host clock.  Per cell: the scene is built once; one warm-up pair (draw
seed 0), which builds the kernels at first use, is not timed; then N
timed pairs with draw seeds 1..N (bench.py takes seed i for pair i); then
one more pair (seed N + 1) under torch.profiler, phase by phase
(utils.profiling.profile_pair), which is not part of the median.  The warm
cell's frames are the scene with fresh sensor noise each (sigma 1, the
scene's own), a cold first frame as the warm-up, then each frame warm-
started (run_pair_warm, one iteration) from the previous frame's planes.

Cells, in order (--config picks one; none runs them all):
  readme_demo       README_DEMO (GRD, d=60, wnd 35), 375x450, @1px, N=30
  cen_cs_pp         CEN_CS_PP (census, 5-level cross-scale, PP), 375x450
  kitti             KITTI (GRD, d=128, PP), 375x1242, @3px, N=20
  kitti_anchor      256x832 d=96 GRD+PP (evaluation.ANCHOR, scene seed
                    7), @3px, N=20, also held against the oracle's cached
                    anchor scores
  readme_demo_warm  README_DEMO, warm frames (video), 375x450, @1px, N=30
  kitti_fly         KITTI without a volume, 375x1242, @3px, N=20

Correctness, per cell: every timed pair's left-view non-occluded
bad-pixel (metrics.bad_pixel_rate) at the cell's threshold is at most
0.01, its maps have the scene's shape and its costs are finite; the anchor
cell's 95% bootstrap upper bound on its delta to the oracle's cached
scores is at most evaluation.BOUND (0.005).  A missed gate ends the run
with exit code 1 and no result line.

Per cell it reports pairs/s, ms/pair (median, quartiles, min, max), the
bad-pixel (mean, max), the peak device memory of the timed pairs, the
set-up seconds (scene, warm-up) and the profiled pair's phases (host ms,
device ms, launches), the device's idle share, the device ms per kernel
(K1 / K2 / K4 / fly / other), the top device ops and the longest idle
gaps, named by the phase the host was in.  The last line of standard
output is one JSON object with bench.py's keys ("metric", "value",
"unit", "vs_baseline": the README_DEMO cell's pairs/s against the CPU
oracle's 282.1 s/pair) and "device" and "cells".  --batch B also times
models.pipeline.run_pairs on B copies of the first cell's scene.
--spread OUT... runs nothing: it reads earlier runs' outputs and prints
each cell's medians across them, their spread (max / min - 1) and the
regression bound that gives (1.5 times the spread, rounded up to 5 %, at
least 5 %).

Runs on the card; --device cpu (the tests) runs the plain versions on the
CPU.  Without a CUDA device and without --device cpu it exits 1.
"""

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

from crossscalepatchmatch_tpu_torch import evaluation as ev
from crossscalepatchmatch_tpu_torch.config import (CEN_CS_PP, KITTI,
                                                   README_DEMO, CostMethod,
                                                   CSPMConfig)
from crossscalepatchmatch_tpu_torch.data import make_pair

# The reference's CPU baseline on README_DEMO's workload: seconds a pair of
# the repository's C++ oracle (csrc/cspm_oracle.cc), bench.py's constant.
BASELINE_CPU_SECONDS_PER_PAIR = 282.1
BASELINE_SOURCE = "measured-oracle"
BAD_PIXEL_MAX = 0.01        # chip_smoke.py's per-pair gate
WARM_NOISE_SIGMA = 1.0      # a warm frame's sensor noise (make_pair's)


class GateMissed(RuntimeError):
    """A cell's output missed its correctness gate."""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str                 # the configuration's name, for the record
    cfg: CSPMConfig
    h: int
    w: int
    max_dis: int                # the scene's disparity range
    scene_seed: int = 0
    thresh: float = 1.0         # bad-pixel threshold, px
    pairs: int = 30             # timed pairs
    warm: bool = False          # warm-started frames (video)
    anchor: bool = False        # held against the oracle's anchor scores
    gate: float = BAD_PIXEL_MAX


_A = ev.ANCHOR
CELLS = (
    Cell("readme_demo", "README_DEMO", README_DEMO, 375, 450, 60),
    Cell("cen_cs_pp", "CEN_CS_PP", CEN_CS_PP, 375, 450, 60),
    Cell("kitti", "KITTI", KITTI, 375, 1242, 128, thresh=3.0, pairs=20),
    Cell("kitti_anchor", "ANCHOR", CSPMConfig(
        max_dis=_A["max_dis"], dis_scale=_A["dis_scale"],
        cost_method=CostMethod[_A["cc"]], use_pp=True), _A["h"], _A["w"],
        _A["max_dis"], scene_seed=_A["scene_seed"], thresh=_A["thresh"],
        pairs=20, anchor=True),
    Cell("readme_demo_warm", "README_DEMO", README_DEMO, 375, 450, 60,
         warm=True),
    Cell("kitti_fly", "KITTI-fly", dataclasses.replace(
        KITTI, precompute_volume=False), 375, 1242, 128, thresh=3.0,
        pairs=20),
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@functools.lru_cache(maxsize=8)
def scene(h: int, w: int, max_dis: int, seed: int, noise_sigma: float):
    """The synthetic scene (kept for the later cells of its geometry)."""
    return make_pair(h=h, w=w, max_dis=max_dis, seed=seed,
                     noise_sigma=noise_sigma)


def cell_frames(cell: Cell, n: int):
    """(scene, [(left, right)] u8 views of frames 0 .. n + 1): one frame
    for a cold cell; for the warm cell the noise-free scene with fresh
    sensor noise a frame."""
    if not cell.warm:
        p = scene(cell.h, cell.w, cell.max_dis, cell.scene_seed, 1.0)
        return p, [(p.left, p.right)]
    p = scene(cell.h, cell.w, cell.max_dis, cell.scene_seed, 0.0)
    rng = np.random.default_rng(cell.scene_seed)
    frames = []
    for _ in range(n + 2):
        frames.append(tuple(
            np.clip(v + rng.normal(0.0, WARM_NOISE_SIGMA, v.shape), 0,
                    255).astype(np.uint8) for v in (p.left, p.right)))
    return p, frames


def quartiles(xs):
    q1, med, q3 = np.percentile(np.asarray(xs, np.float64), (25, 50, 75))
    return dict(median=float(med), q1=float(q1), q3=float(q3),
                min=float(min(xs)), max=float(max(xs)))


def run_cell(cell: Cell, device, pairs: int | None = None,
             oracle=None) -> dict:
    """One cell (module docstring) with `pairs` timed pairs (the cell's
    if None): its record; raises GateMissed when an output misses the
    cell's gate.  oracle: the evaluation.OracleScores the anchor cell reads
    (the repository's caches if None)."""
    import torch

    from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
    from crossscalepatchmatch_tpu_torch.models.pipeline import (
        run_pair, run_pair_warm)
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        format_profile, profile_pair)

    n = pairs or cell.pairs
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = cell.cfg

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    gt, host_frames = cell_frames(cell, n)
    frames = [tuple(torch.as_tensor(v, device=dev) for v in f)
              for f in host_frames]
    sync()
    scene_s = time.perf_counter() - t0

    def frame(i):
        return frames[i if cell.warm else 0]

    def run(i, prior):
        if prior is None:
            return run_pair(*frame(i), i, cfg, device=dev)
        return run_pair_warm(*frame(i), i, prior, cfg, 1, device=dev)

    def check(i, out):
        """The left view's bad-pixel of pair i; raises on a bad output."""
        dis = out["dis"].cpu().numpy()
        if dis.shape != (2, cell.h, cell.w) or not bool(
                torch.isfinite(out["cost"]).all()):
            raise GateMissed(f"{cell.name} pair {i}: maps {dis.shape} or "
                             "non-finite costs")
        bad = bad_pixel_rate(dis[0] / cfg.dis_scale, gt.disp_left,
                             gt.valid_left, cell.thresh)
        if bad > cell.gate:
            raise GateMissed(f"{cell.name} pair {i}: bad-pixel @"
                             f"{cell.thresh:g}px {bad:.4f} > {cell.gate}")
        return bad

    log(f"{cell.name}: {cell.config} {cell.h}x{cell.w} d={cell.max_dis}, "
        f"{n} timed {'frames' if cell.warm else 'pairs'}, scene "
        f"{scene_s:.1f} s")
    t0 = time.perf_counter()
    out = run(0, None)
    sync()
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ms, bads = [], []
    for i in range(1, n + 1):
        prior = out["abc"] if cell.warm else None
        t0 = time.perf_counter()
        out = run(i, prior)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        bads.append(check(i, out))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None

    prof_out, summary, _ = profile_pair(
        *frame(n + 1), n + 1, cfg, device=dev,
        prior_abc=out["abc"] if cell.warm else None, top=5)
    check(n + 1, prof_out)
    rec = dict(config=cell.config, shape=[cell.h, cell.w, cell.max_dis],
               scene_seed=cell.scene_seed, warm=cell.warm, pairs=n,
               ms_pair=quartiles(ms),
               bad_pixel=dict(thresh=cell.thresh, mean=float(np.mean(bads)),
                              max=float(max(bads)), gate=cell.gate),
               peak_mib=None if peak is None else peak / 2**20,
               setup_s=dict(scene=scene_s, warmup=warmup_s),
               ms_pair_runs=ms, profile=summary)
    rec["pairs_per_s"] = 1e3 / rec["ms_pair"]["median"]
    if cell.anchor:
        rec["anchor"] = anchor_check(cell, bads, oracle or ev.OracleScores())
    q = rec["ms_pair"]
    log(f"{cell.name}: {q['median']:.1f} ms/pair (quartiles {q['q1']:.1f} / "
        f"{q['q3']:.1f}, min {q['min']:.1f}, max {q['max']:.1f}), "
        f"{rec['pairs_per_s']:.3f} pairs/s; bad-pixel @{cell.thresh:g}px "
        f"mean {rec['bad_pixel']['mean']:.4f} max "
        f"{rec['bad_pixel']['max']:.4f}; peak "
        + ("not measured" if peak is None else f"{peak / 2**20:.1f} MiB")
        + f"; warm-up {warmup_s:.1f} s")
    for line in format_profile(summary):
        log(f"{cell.name}: {line}")
    return rec


def anchor_check(cell: Cell, bads, oracle) -> dict:
    """The anchor's delta to the oracle's cached scores (the timed pairs'
    mean against the cached seeds' mean) and eval.py's unpaired bootstrap
    upper bound on it; raises GateMissed over evaluation.BOUND or without
    cached scores."""
    key = ev.anchor_key(cell.h, cell.w, cell.max_dis,
                        cell.cfg.cost_method.value)
    cached = oracle.anchor_scores(key)
    if cached is None:
        raise GateMissed(f"{cell.name}: no cached oracle scores for {key}")
    bads_o = cached[0]
    delta = float(np.mean(bads) - np.mean(bads_o))
    ci_hi = ev.unpaired_ci_hi(bads, bads_o)
    res = dict(scene=key, bad_oracle=float(np.mean(bads_o)),
               bad_engine=float(np.mean(bads)), delta=delta,
               delta_ci95_hi=ci_hi, bound=ev.BOUND,
               oracle_seeds=len(bads_o))
    log(f"{cell.name}: oracle {res['bad_oracle']:.4f}, delta {delta:+.4f}, "
        f"CI95 upper {ci_hi:+.4f} (bound {ev.BOUND})")
    if ci_hi > ev.BOUND:
        raise GateMissed(f"{cell.name}: delta to the oracle's CI95 upper "
                         f"{ci_hi:+.4f} > {ev.BOUND}")
    return res


def time_batch(cell: Cell, batch: int, device, reps: int = 3) -> dict:
    """models.pipeline.run_pairs on `batch` copies of the cell's scene
    (bench.py --batch): ms a batch and a pair, after one untimed batch."""
    import torch

    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pairs

    dev = torch.device(device)
    p = scene(cell.h, cell.w, cell.max_dis, cell.scene_seed, 1.0)
    ls = torch.as_tensor(p.left, device=dev).expand(batch, -1, -1, -1)
    rs = torch.as_tensor(p.right, device=dev).expand(batch, -1, -1, -1)
    ms = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        run_pairs(ls, rs, [batch * i + j for j in range(batch)], cell.cfg,
                  device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    per_batch = float(np.median(ms[1:]))
    log(f"{cell.name}: batch={batch}: {per_batch:.1f} ms/batch = "
        f"{per_batch / batch:.1f} ms/pair")
    return dict(cell=cell.name, batch=batch, ms_batch=per_batch,
                ms_pair=per_batch / batch)


def describe_device(dev) -> dict:
    """What the run ran on: the card's name, power limit (nvidia-smi) and
    count; "cpu" and no limit on the CPU."""
    import torch

    if dev.type != "cuda":
        return dict(kind="cpu", power_limit=None, count=0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    idx = dev.index or 0
    limit = smi[idx].split(",")[-1].strip() if len(smi) > idx else None
    return dict(kind=torch.cuda.get_device_name(dev), power_limit=limit,
                count=torch.cuda.device_count())


def result_line(results: dict, device: dict, batch=None) -> dict:
    """The last line: bench.py's keys for the README_DEMO cell (else the
    first cell run, without vs_baseline), the device and every cell."""
    name = "readme_demo" if "readme_demo" in results else next(iter(results))
    rec = results[name]
    h, w, d = rec["shape"]
    value = rec["pairs_per_s"]
    out = {"metric": "stereo_pairs_per_second_per_chip", "value": value}
    if name == "readme_demo":
        out["unit"] = (f"pairs/s ({h}x{w}, max_dis={d}, GRD, vs "
                       f"{BASELINE_SOURCE} CPU baseline "
                       f"{BASELINE_CPU_SECONDS_PER_PAIR:.0f}s/pair)")
        out["vs_baseline"] = value * BASELINE_CPU_SECONDS_PER_PAIR
    else:
        out["unit"] = f"pairs/s (cell {name}: {rec['config']} {h}x{w})"
        out["vs_baseline"] = None
    out["device"] = device
    out["cells"] = results
    if batch is not None:
        out["batch"] = batch
    return out


def spread(paths) -> dict:
    """Each cell's ms/pair median in every run whose output (its last line)
    is at one of `paths`, the spread of those medians (max / min - 1) and
    the regression bound they give: 1.5 times the spread, rounded up to
    the next 5 %, at least 5 %."""
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.loads(f.read().strip().splitlines()[-1]))
    out = {}
    for name in runs[0]["cells"]:
        meds = [r["cells"][name]["ms_pair"]["median"] for r in runs
                if name in r["cells"]]
        gap = max(meds) / min(meds) - 1
        out[name] = dict(medians=meds, spread=gap,
                         bound=max(0.05, np.ceil(round(30 * gap, 9)) / 20))
    return dict(devices=[r["device"] for r in runs], cells=out)


def main(argv=None, cells=CELLS) -> int:
    """cells: the cell table (the tests hand in small ones)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=[c.name for c in cells],
                    help="one cell (default: all, in order)")
    ap.add_argument("--batch", type=int, default=0,
                    help="also time run_pairs on B copies of the first "
                         "cell's scene")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--spread", nargs="+", metavar="OUT",
                    help="no run: print the cells' medians across earlier "
                         "runs' outputs, their spread and bounds")
    args = ap.parse_args(argv)
    if args.spread:
        res = spread(args.spread)
        for name, c in res["cells"].items():
            meds = ", ".join(f"{m:.1f}" for m in c["medians"])
            log(f"{name}: medians {meds} ms/pair, spread {c['spread']:.1%}, "
                f"bound {c['bound']:.0%}")
        print(json.dumps(res))
        return 0
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); --device cpu runs the plain versions on the CPU",
              file=sys.stderr)
        return 1
    device = describe_device(dev)
    log(f"bench_torch: {device['kind']}, power limit "
        f"{device['power_limit']}, torch {torch.__version__}")
    chosen = [c for c in cells if args.config in (None, c.name)]
    results = {}
    try:
        for cell in chosen:
            results[cell.name] = run_cell(cell, dev)
    except GateMissed as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    batch = (time_batch(chosen[0], args.batch, dev) if args.batch > 1
             else None)
    print(json.dumps(result_line(results, device, batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
