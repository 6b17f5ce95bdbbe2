"""Smoke run of the PyTorch port (crossscalepatchmatch_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel;
     timed);
  3. K1, the window cost: kernel vs its plain PyTorch version on the card
     at the bench shape (375x450, max_dis=60, wnd=35, GRD) for K=1 and K=2
     candidates (converged-like, random and wild near-zero-nz planes), f32
     and bf16 volumes; K3's volume form (stride 2, K=8) the same;
  4. K2, the quadrant-volume build: the same at the bench shape; K2 and K1
     (K=1) again on the KITTI scene's 129 slices (375x1242, max_dis=128);
  4b. GRDV (the GRD cost volume), QRANK (the quadrant ranking) and CENV
     (the census volume) against their plain versions on the card, on the
     seed-0 bench (d=60) and KITTI (d=128) scenes: GRDV both views (one
     launch from the u8 views, nothing packed before it; the wrapper must
     launch that one kernel and no other), QRANK on K2's output over the
     scene's volumes at K = 8 and 1 (test_planes) and at K = 8 on the
     pipeline's own candidates (the propagation stencil's neighbours of
     the seed-0 run_pair output's final planes); 0 differing f32
     elements each; the plain GRD volume on the card against the CPU's
     (the elements PyTorch's CUDA division by 3.0, a multiply by f32(1/3),
     rounds apart from the CPU's true division: why GRDV multiplies);
     CENV at the bench scene's 5 CEN_CS_PP levels, a KITTI-size level and
     a 6x5 crop's 3 levels (narrower and lower than the census window),
     0 differing f32 elements at every level, two launches a level and no
     other; kernel (the wrapper in turns, as every kernel's ms; GRDV and
     CENV also their device time, the wrapper's calls queued behind a
     spinning kernel, and the launches a call read from the CUDA graph a
     captured call records: nothing but their kernels),
     plain and bound ms
     (utils.roofline.grd_volume_work, census_volume_work; QRANK's
     quadrant_rank_work on random planes, quadrant_rank_row_work, each
     distinct tap float of a row once, on the pipeline's candidates, whose
     taps share rows), and beside QRANK's bound the floor a gather of its
     taps can reach (quadrant_rank_sectors: the distinct 32-byte sectors
     they touch);
  4d. BFV (the bilateral volume filter) against its plain version on the
     card, equal elements (torch.equal) and slices 0 and D - 1 passed
     through, on the unfiltered volumes a BF path hands it: README_DEMO's
     level (375x450, D=61), the KITTI scene's (375x1242, D=129) and the
     coarsest level of a 5-level README_DEMO pyramid (narrower than the
     35 x 35 window); the plain version's comparison call, the wrapper in
     turns, its device time queued, one launch a call and one kernel in a
     captured call's graph, and the bound (utils.roofline
     .bilateral_volume_work);
  5. K4, the cross-scale window cost: the same on the 5-level census
     pyramid of the bench scene (CEN_CS_PP); f32 within 2e-5 relative, and
     bf16 census volumes (integers, exact in bf16) bit-equal; K = 2, 3, 5,
     8 against one K=8 plain call, another window (half_wnd 8), and the
     kernel's pair-layout volume (pair_volume against the plain layout's
     taps);
  6. the no-volume fly kernel on the bench scene: K5 (cost lerp) at K=1
     and, against one K=8 plain call, K = 2, 3, 5, 8; K3's fly form
     (stride 2, K=8 and its first 3 and 5 candidates), K6 (image lerp), K7
     (Lab weights), the 5-level cross-scale fly at K=1 and another window
     (half_wnd 8, strides 1 and 3); on the KITTI scene (max_dis=128, the
     wider staged span) K5 at K=1 and K3's fly form; each within 2e-5
     relative of its plain version; every kernel is timed on prepared
     pairs (packing and layout copies outside the timed region);
  each kernel's bound: the larger of its bytes over the HBM rate and its
  f32 operations, counted on this run's inputs, over the data sheet's f32
  peak; every
  plain version is timed on its one comparison call, the kernels with
  CUDA events in turns after a warm-up;
  7. the main paths, each with every launch counter reset just before and
     read just after: run_pair at README_DEMO, CEN_CS_PP and README_DEMO
     without a volume (precompute_volume=False) on the bench scene for
     seeds 0, 1, 2 and 0 again (bad-pixel(nonocc) @1px <= 0.01 per seed,
     left view), KITTI without a volume on a 375x1242 max_dis=128 scene for
     seeds 0 and 0 again (@3px <= 0.01, @1px printed) and KITTI with its
     volumes for seed 0 (the K2 repair, and the memory comparison); the
     path's kernels must have launched (GRDV and QRANK on every volume
     path: GRD volumes, the quadrant ranking; CENV on every census path)
     and no plain version; seed 0
     bit-identical on rerun, and a digest of its `dis` bytes printed (to
     compare two checkouts on one card); ms/pair and peak device memory;
     for CEN_CS_PP
     also the time and launch count of postprocess; the paths with
     post-processing (CEN_CS_PP, KITTI-fly, KITTI) must have launched WMF
     and never the plain weighted median;
  7b. WMF, the weighted median: the kernel against its plain version on the
     card on the real inputs of the seed-0 CEN_CS_PP (375x450, wnd 35) and
     KITTI (375x1242) pairs (their filled maps and LR-invalid masks): 0
     differing u8 pixels, and equal to the pipeline's output; N (the
     invalid pixels), the wrapper's ms, the kernel's launch alone on
     prepared inputs, the plain ms (CUDA events, in turns) and the bound,
     the least work of an exact search (utils.roofline.median_least_ops),
     with the share of each time beside it and beside the bisection's
     count (median_samples);
  8. small pairs run on the card and on the CPU (plain versions) from the
     same draws must agree (README_DEMO-like, CEN_CS_PP-like, the volume
     path's window prescreen, and without a volume: cost lerp, image lerp
     + cross-scale, Lab weights); each is a path of its own for the
     launch counters;
  9. the entry points on the bench scene, every one a path of its own for
     the counters: the command line (`python -m
     crossscalepatchmatch_tpu_torch` with the README demo's flags, in a
     subprocess and in process, on PNGs of the scene: its maps equal
     run_pair_np's byte for byte; then --input_list with two seeds); a
     warm frame after a cold one (run_sequence_np, README_DEMO: ms a
     frame, peak memory, bad-pixel @1px <= 0.01, bit-identical rerun);
     run_pair_resumable (uninterrupted equal to run_pair, rewound to
     iterations 1 and 2 and resumed bit-equal); --aggregator BOX, GF and
     BF (ms/pair, the filter's device time on both views of the level,
     one call of aggregate_volumes, peak memory, bad-pixel,
     printed); small pairs card vs CPU for each aggregator, CEN+CS+BOX and
     a warm frame; and README_DEMO (seeds 0-2), CEN_CS_PP and KITTI (seed
     0) with f32 kernel volumes, their bad-pixel beside phase 7's bf16
     (printed, not gated).
  10. sharding (crossscalepatchmatch_tpu_torch.parallel): the band forms
     of K1 (K=1, 2), K3's volume form (stride 2, K=8), K2 and K4 (5 census
     levels) on the bench scene's middle tile of a (1, 3, 2) mesh (125 +
     34 rows x 225 + 34 columns, origin (125, 225)) against their plain
     band forms, f32 bit-equal (bf16 census volumes too for K4), timed
     beside the whole-image forms; QRANK on K2's band-form output (K = 8,
     1) and GRDV on the tile's full-width row band, 0 differing elements;
     WMF's band form on the same tile (the
     seed-0 CEN_CS_PP maps, halo-extended) u8-equal to its plain band form
     and to the whole-image result's tile; a (1, 3, 2) mesh of six gloo
     ranks on the one card (halos staged through the host) runs README_DEMO
     and CEN_CS_PP on the bench scene (bad-pixel @1px <= 0.01 and within
     0.005 of phase 7's one-device run, the band forms launched and no
     plain version, a rerun bit-identical; ms/pair and the bytes staged
     through the host printed); a small pair on a (1, 2, 2) mesh on the
     card against the same mesh on the CPU with the same draws; on a world
     of one rank (NCCL) run_sequence_batch and the no-volume data-only
     mesh, each byte-equal to its per-pair run.
  11. accuracy parity against the native oracle (the port's evaluation
     module, which tools/torch_eval.py and tools/torch_kitti_anchor.py
     drive), each run a path of its own for the counters, at bf16 kernel
     volumes: eval.py's 13-row matrix at 5 seeds a row (the photo rows
     skipped, and listed, without matplotlib's photograph),
     exposure_grd_pp again with adopt_mode="exact", the paired use_cs
     ablation (5 scenes, printed beside the JAX engine's recorded column)
     and the 256x832 d=96 GRD+PP anchor @3px, each scored against the
     oracle's cached per-seed scores; fatal: a scored row (but the
     default-schedule exposure_grd_pp, printed beside the JAX engine's
     +0.0062 / CI +0.0065) or the anchor with the bootstrap's 95% upper
     bound on the delta over 0.005, or fewer than the 11 rows without a
     photo scored; then the port's GRD and CEN volumes (build_volumes on
     the card) against the oracle's cost_volume on a 64x96 d=12 scene
     (rtol 1e-4), and the f32 ceiling (utils.roofline.measure_f32_peak:
     csrc/f32_peak.cu, held against its plain version within 1e-5
     relative on a small input, and every element of its timed launches
     checked to equal its step count exactly) on a line of its own beside
     the data sheet's.
  12. the benchmark's readme_demo cell (bench_torch.run_cell, in process,
     5 timed pairs; a path of its own for the counters): its record must
     make bench_torch's result line (bench.py's keys), every pair within
     its bad-pixel gate, K1, K2, GRDV and QRANK launched; its ms/pair
     printed; then the cen_cs_pp cell (3 timed pairs, a path of its own:
     K4, K2, QRANK, CENV and WMF launched, no plain version; its profiled
     pair's volume_build host and device ms and launches printed).
  13. the scaling bench (bench_scaling_torch.py, 384x448 d=60 wnd 35).
     First the band forms of K1 (K = 1, 2) and K2, bit-equal in f32 to
     their plain band forms on the bench's tiles (the whole image of the
     (1, 1, 1) mesh, both row bands of the (1, 2, 1) mesh: rows extended,
     columns not), the same inputs on the card for both sides.  Then the
     bench, 3 timed calls a mesh, in subprocesses under torchrun: one
     rank (NCCL, mesh ty=1) and two ranks sharing the card (gloo, meshes
     ty=1 over rank 0 and ty=2); each must exit 0 and print one JSON
     line per mesh with bench_scaling.py's keys, every call within its
     bad-pixel gate, the efficiency value / (value at n = 1 * n), and the
     band forms of K1, K2, GRDV and QRANK launched and no plain version
     (each run's
     meshes are paths of their own for the counters: the bench reads the
     counters around its timed calls on every rank); the lines printed.
Every bound is counted by utils.roofline (bound, window_samples,
quadrant_build_samples, median_least_ops, grd_volume_work,
census_volume_work, bilateral_volume_work, quadrant_rank_work, quadrant_rank_row_work and the
per-sample operation counts; quadrant_rank_sectors for QRANK's gather
floor, median_samples for the bisection's count beside WMF's bound).
The line before the last is the kernels' JSON record, the last line the
device record.  Exits non-zero, printing no result, without a CUDA device.
`python3 chip_smoke.py --shard-worker ...` is one rank of phase 10 (the
script starts them itself).
"""

import dataclasses
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# scratch files of the entry-point phase (PNGs, checkpoints), inside the
# checkout's ignored build/ directory
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")
SHAPE = dict(h=375, w=450, max_dis=60)
# the README demo's command line (README_DEMO)
README_FLAGS = ("--max_dis=60", "--dis_scale=4", "--cc_name=GRD",
                "--use_cs=false", "--use_pp=false", "--reg_lambda=0.0")
KITTI_SHAPE = dict(h=375, w=1242, max_dis=128)
F32_REL_TOL = 2e-5          # |kernel - plain| <= tol * max(1, |plain|)
BAD_PIXEL_MAX = 0.01
# candidate counts of the optimizer's batches (exact 1-3, prescreen 4-8)
MANY_KS = (1, 2, 3, 5, 8)
# the kernels a volume path launches: GRD volumes (GRDV) ranked on the
# quadrant volumes (K2, QRANK) with K1 exact; census volumes (CENV) with K4
GRD_PATH = ("k1", "k2", "grdv", "qrank")


def agg_path(agg):
    """The kernels a GRD pair with aggregator `agg` launches: BF adds the
    bilateral volume filter BFV."""
    return GRD_PATH + (("bfv",) if agg.value == "BF" else ())

CEN_CS_PATH = ("k4", "k2", "qrank", "cenv")
OTHER_HALF_WND = 8          # a window other than the presets' half_wnd 17
SMALL_AGREE_MIN = 0.98      # share of u8 pixels within 1 level, card vs CPU
# the sharding phase: the bench scene on a (data, ty, tx) = (1, 3, 2) mesh
# of six gloo ranks on the one card, its band forms checked on the middle
# tile (ty, tx) = (1, 1): rows [125, 250), columns [225, 450), an odd
# origin; a small pair on a (1, 2, 2) mesh, the card against the CPU
MESH_BENCH = (1, 3, 2)
TILE_INDEX = (1, 1)
MESH_SMALL = (1, 2, 2)
SHARDED_GAP_MAX = 0.005     # |bad-pixel sharded - one device| @1px
RANK_TIMEOUT_S = 600
# phase 13: bench_scaling_torch.py's runs, (ranks, backend, meshes)
SCALING_RUNS = ((1, "nccl", ["ty=1"]), (2, "gloo", ["ty=1", "ty=2"]))
SCALING_REPS = 3
# phase 11: the oracle volume check's scene (tests/test_oracle_native.py's)
# and tolerance; the FMA chain's tolerance against its plain version; the
# JAX engine's recorded accuracy (BASELINE.md: exposure_grd_pp delta / CI95
# upper, default schedule and adopt_mode="exact"; the use_cs ablation's
# engine column, ss, cs, delta)
ORACLE_VOLUME_SHAPE = dict(h=64, w=96, max_dis=12)
VOLUME_RTOL = 1e-4
F32_CHAIN_REL_TOL = 1e-5
JAX_EXPOSURE_DEFAULT = (0.0062, 0.0065)
JAX_EXPOSURE_EXACT = (0.0039, 0.0046)
JAX_CS_ABLATION = {"lowtex": (0.0839, 0.0711, -0.0129),
                   "noisy": (0.0824, 0.0702, -0.0121),
                   "noisy_lowtex": (0.1505, 0.1305, -0.0199),
                   "photo": (0.0321, 0.0281, -0.0040),
                   "clean": (0.0460, 0.0439, -0.0021)}


def rel_err(got, want):
    import torch

    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d / torch.clamp(want.float().abs(), min=1.0)).max()))


def time_turns(fns, reps):
    """ms per call of each fn, CUDA events, in turns a, b, ..., ..., b, a
    after one warm-up call of each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    acc = {n: [] for n in names}
    for n in names + names[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps[n]):
            fns[n]()
        end.record()
        torch.cuda.synchronize()
        acc[n].append(start.elapsed_time(end) / reps[n])
    return {n: sum(v) / len(v) for n, v in acc.items()}


def timed_once(fn):
    """(fn(), ms): one call between CUDA events (a plain version's time is
    its comparison call; plain versions cost most of the run)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def queued_ms(fn, reps):
    """fn's device time a call, in ms: `reps` calls queued behind a
    spinning kernel (torch.cuda._sleep, ~10 ms), so that they run back to
    back on the device whatever the host's launch cost, between CUDA
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_kernels(name, fn, want):
    """The launches one call of fn makes, read from the CUDA graph that
    capturing the call (after a warm-up call) records: every kernel or
    copy fn puts on the stream, the port's and PyTorch's alike, is one
    node of the graph; an allocation from PyTorch's caching allocator is
    none.  Raises unless the graph holds exactly `want` nodes, all of them
    kernels."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError(f"{name}: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError(f"{name}: cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError(f"{name}: cuGraphNodeGetType failed")
        kinds.append(kind.value)
    g.reset()
    kernels = kinds.count(0)     # CU_GRAPH_NODE_TYPE_KERNEL
    if kernels != want or len(kinds) != want:
        raise RuntimeError(f"{name}: a call records {len(kinds)} graph "
                           f"nodes, {kernels} of them kernels (expected "
                           f"{want} kernels and nothing else)")
    return kernels


def test_planes(pair, max_dis, k, gen, device):
    """f32[2, K, H, W, 3] on the scene `pair`: candidate 0 converged-like
    (ground truth plus jitter, small slopes), the others random init planes
    over [0, max_dis); ~0.1% of the pixels of the last candidate get a wild
    near-zero-nz plane."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch.ops import plane

    h, w = pair.disp_left.shape
    xs, ys = plane.pixel_grid(h, w, device)
    gt = torch.as_tensor(np.stack([pair.disp_left, pair.disp_right]),
                         device=device)
    md = float(max_dis)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    ab = u(2, h, w, 2, lo=-0.05, hi=0.05)
    dc = gt + u(2, h, w, lo=-0.5, hi=0.5)
    cands = [plane.reanchor(ab, xs, ys, dc)]
    for _ in range(k - 1):
        cands.append(plane.random_planes(
            u(2, h, w, lo=1e-8, hi=md),
            torch.randn((2, h, w, 3), generator=gen, device=device)))
    wild_n = torch.cat([u(2, h, w, 2), torch.full((2, h, w, 1), 1e-9,
                                                   device=device)], -1)
    wild = plane.random_planes(u(2, h, w, lo=1e-8, hi=md), wild_n)
    pick = torch.rand((2, h, w), generator=gen, device=device) < 1e-3
    cands[-1] = torch.where(pick[..., None], wild, cands[-1])
    return torch.stack(cands, dim=1).contiguous()


def check_close(name, got, want):
    """(max |d|, max rel); raises on a bad shape, a non-finite value or an
    f32 error over the tolerance."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: bad output {tuple(got.shape)}")
    ab, rl = rel_err(got, want)
    print(f"{name}: f32 max|d| {ab:.3e} max rel {rl:.3e}")
    if rl > F32_REL_TOL:
        raise RuntimeError(f"{name}: f32 rel error {rl} > {F32_REL_TOL}")
    return ab, rl


def phase11(dev, card, paths, check_counts):
    """The port's accuracy scoring on the card (evaluation, the scoring of
    tools/torch_eval.py and tools/torch_kitti_anchor.py), each run a path of
    its own for the launch counters: eval.py's 13-row matrix at 5 seeds a
    row, exposure_grd_pp again under adopt_mode="exact", the paired use_cs
    ablation and the 256x832 d=96 anchor, all at bf16 kernel volumes
    against the oracle's cached scores; the port's GRD and CEN volumes on
    the card against the oracle's cost_volume; the f32 ceiling.  Raises on a
    scored row (but the default-schedule exposure_grd_pp) or the anchor
    over the bound on the bootstrap's upper end, fewer than the rows
    without a photo scored, or a volume off the oracle's."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch import CostMethod, CSPMConfig
    from crossscalepatchmatch_tpu_torch import evaluation as ev
    from crossscalepatchmatch_tpu_torch import oracle
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volumes
    from crossscalepatchmatch_tpu_torch.ops.cuda import f32_peak
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        launch_counts as read_counts, reset_launch_counts as reset_counts)
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        F32_FLOP_PER_S, measure_f32_peak)

    t0 = time.perf_counter()
    engine = ev.engine_on(dev)
    scores = ev.OracleScores()

    def scored(name, kernels, run):
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        paths[name] = read_counts()
        check_counts(name, paths[name], kernels)
        return res

    matrix = scored("eval matrix", ("k1", "k2", "k4", "wmf", "cenv"),
                    lambda: ev.run_matrix(engine, scores))
    exposure = next(c for c in ev.CONFIGS if c[0] == "exposure_grd_pp")
    exact = scored("eval exposure exact", ("k1", "k2", "wmf"),
                   lambda: ev.run_matrix(engine, scores, [exposure],
                                         engine_kw=dict(adopt_mode="exact")))
    ablation = scored("CS ablation", ("k1", "k2", "k4", "cenv"),
                      lambda: ev.run_cs_ablation(engine, scores))
    anchor = scored("anchor", ("k1", "k2", "wmf"),
                    lambda: ev.run_anchor(engine, scores))
    for r in matrix["rows"] + exact["rows"]:
        print(f"eval {r['config']}: port {r['bad_engine']:.4f} oracle "
              f"{r['bad_oracle']:.4f} delta {r['delta']:+.4f} CI95 upper "
              f"{r['delta_ci95_hi']:+.4f} {r['ms_pair']:.1f} ms/pair; per "
              f"seed {[round(b, 4) for b in r['engine_bads']]}")
    by_name = {r["config"]: r for r in matrix["rows"]}
    ex_row, ex_exact = by_name.get("exposure_grd_pp"), exact["rows"][0]
    if ex_row:
        print(f"eval exposure_grd_pp, default schedule (printed, not "
              f"gated): delta {ex_row['delta']:+.4f} CI95 upper "
              f"{ex_row['delta_ci95_hi']:+.4f} beside the JAX engine's "
              f"recorded {JAX_EXPOSURE_DEFAULT[0]:+.4f} / CI "
              f"{JAX_EXPOSURE_DEFAULT[1]:+.4f}; adopt_mode=\"exact\" "
              f"{ex_exact['delta']:+.4f} / CI {ex_exact['delta_ci95_hi']:+.4f}"
              f" (JAX {JAX_EXPOSURE_EXACT[0]:+.4f} / CI "
              f"{JAX_EXPOSURE_EXACT[1]:+.4f})")
    for row in ablation["rows"]:
        e, o = row["engine"], row["oracle"]
        j = JAX_CS_ABLATION.get(row["scene"])
        print(f"CS ablation {row['scene']}: port ss {e['ss']:.4f} cs "
              f"{e['cs']:.4f} delta {e['delta']:+.4f} {e['delta_ci95']}; "
              f"oracle delta {o['delta']:+.4f} {o['delta_ci95']}"
              + (f"; JAX engine {j[0]:.4f} -> {j[1]:.4f} delta {j[2]:+.4f}"
                 if j else ""))
    if anchor is None:
        raise RuntimeError("anchor: no cached oracle scores")
    print(f"anchor {anchor['scene']} @3px: port {anchor['bad_engine']:.4f} "
          f"(per seed {[round(b, 4) for b in anchor['engine_bads']]}) "
          f"oracle {anchor['bad_oracle']:.4f} delta {anchor['delta']:+.4f} "
          f"CI95 upper {anchor['delta_ci95_hi']:+.4f} "
          f"{anchor['ms_pair']:.1f} ms/pair")
    for name, res in (("eval", {"matrix": matrix, "exposure_exact": exact}),
                      ("CS ablation", ablation), ("anchor", anchor)):
        print(f"{name} JSON: {json.dumps(res)}")

    # the port's volumes (build_volumes on the card) against the oracle's
    vpair = make_pair(**ORACLE_VOLUME_SHAPE, seed=11)
    vl = bgr_to_rgb(torch.as_tensor(vpair.left, device=dev))
    vr = bgr_to_rgb(torch.as_tensor(vpair.right, device=dev))
    md = ORACLE_VOLUME_SHAPE["max_dis"]
    vol_ok = True
    for cc in ("GRD", "CEN"):
        vcfg = CSPMConfig(max_dis=md, dis_scale=16,
                          cost_method=CostMethod[cc])
        both = build_volumes(vl, vr, md, vcfg).double().cpu().numpy()
        for right in (False, True):
            want = oracle.cost_volume(vpair.left, vpair.right, max_dis=md,
                                      cc_name=cc, right=right)
            got = np.moveaxis(both[int(right)], -1, 0)
            ok = got.shape == want.shape and np.allclose(
                got, want, rtol=VOLUME_RTOL, atol=VOLUME_RTOL)
            err = float(np.abs(got - want).max()) if ok else float("nan")
            print(f"volume {cc} {'right' if right else 'left'} "
                  f"{tuple(want.shape)} card vs oracle: max|d| {err:.3e} "
                  f"within rtol {VOLUME_RTOL}: {ok}")
            vol_ok &= ok

    # the f32 ceiling: the FMA-chain kernel against its plain version, then
    # timed (measure_f32_peak raises unless every element of the timed
    # launches equals its step count)
    x = torch.rand(4 * f32_peak.BLOCK_ELEMS, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    chain_err = 0.0
    for m, c, iters in ((1.0, 1.0, 8), (0.75, 0.5, 8), (0.9999999, 1e-7, 64)):
        want = f32_peak.fma_chain_plain(x, iters, m, c)
        _, rl = rel_err(f32_peak.fma_chain(x, iters, m, c), want)
        chain_err = max(chain_err, rl)
    peak = measure_f32_peak(dev)
    print(f"f32 ceiling: kernel vs plain max rel {chain_err:.3e}")
    print(json.dumps({"f32_ceiling": {
        "flop_per_s": peak, "data_sheet_flop_per_s": F32_FLOP_PER_S,
        "share_of_data_sheet": peak / F32_FLOP_PER_S,
        "kernel_vs_plain_max_rel": chain_err,
        "source": "crossscalepatchmatch_tpu_torch/csrc/f32_peak.cu",
        "card": card}}))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    photo_free = [c[0] for c in ev.CONFIGS if not c[8].get("photo")]
    missing = [n for n in photo_free if n not in by_name]
    over = [r["config"] for r in matrix["rows"]
            if r["config"] != "exposure_grd_pp" and not r["within_bound"]]
    if not ex_exact["within_bound"]:
        over.append("exposure_grd_pp (adopt_mode=exact)")
    if not anchor["within_bound"]:
        over.append("anchor")
    print(f"phase 11: {len(by_name)} rows scored, skipped "
          f"{matrix['skipped']}; over the bound: {over}")
    if missing or over or not vol_ok or chain_err > F32_CHAIN_REL_TOL:
        raise RuntimeError(f"phase 11: rows not scored {missing}, over the "
                           f"bound {over}, volumes agree {vol_ok}, FMA "
                           f"chain rel error {chain_err}")


def shard_worker(argv) -> int:
    """One rank of the sharding phase (spawn_ranks): joins the gloo group
    through a file store, runs its job on `--device`, pickles its result
    (maps from rank 0, every rank's launch counts, ms and staged bytes)."""
    import argparse
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, CSPMConfig,
                                                README_DEMO)
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.parallel import _comm
    from crossscalepatchmatch_tpu_torch.parallel.mesh import (TIMEOUT,
                                                              make_mesh)
    from crossscalepatchmatch_tpu_torch.parallel.tiled import (
        run_batch_sharded)
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        launch_counts as read_counts, reset_launch_counts as reset_counts)

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--job", "--device", "--out", "--mesh"):
        ap.add_argument(flag, required=True)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world,
                            timeout=TIMEOUT)
    mesh = make_mesh(*(int(x) for x in args.mesh.split(",")))
    on_card = args.device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    def run(name, pcfg, pair, seeds, reps, **kw):
        """reps runs (the first a warm-up); the last with the counters."""
        outs = []
        for i in range(reps):
            sync()
            reset_counts()
            _comm.host_bytes = 0
            t0 = time.perf_counter()
            outs.append(run_batch_sharded(pair.left[None], pair.right[None],
                                          seeds, pcfg, mesh,
                                          device=args.device, **kw))
            sync()
        res["runs"][name] = dict(
            ms=(time.perf_counter() - t0) * 1e3, counts=read_counts(),
            host_bytes=_comm.host_bytes,
            same=all(torch.equal(o, outs[0]) for o in outs),
            dis=outs[-1].cpu().numpy() if args.rank == 0 else None)

    res = {"transport": _comm.transport(mesh), "runs": {}}
    try:
        if args.job == "bench":
            pair = make_pair(seed=0, **SHAPE)
            run("README_DEMO", README_DEMO, pair, [0], 2)
            run("CEN_CS_PP", CEN_CS_PP, pair, [0], 2)
        else:
            pair = make_pair(h=48, w=64, max_dis=12, seed=3)
            base = dict(max_dis=12, dis_scale=16, wnd_size=11,
                        vol_dtype="f32")
            for name, scfg in (
                    ("small", CSPMConfig(use_pp=True, **base)),
                    ("small window-prescreen",
                     CSPMConfig(prescreen_mode="window", **base))):
                run(name, scfg, pair, [0], 1, draws=lambda seed, tile:
                    TorchDraws(seed, "cpu", tile=tile))
    finally:
        dist.destroy_process_group()
    with open(args.out, "wb") as f:
        pickle.dump(res, f)
    return 0


def spawn_ranks(job, mesh, device):
    """Run a sharding job on prod(mesh) rank processes of this script and
    return their results in rank order; a rank that fails or outlives
    RANK_TIMEOUT_S ends the others and raises."""
    import pickle

    os.makedirs(WORK_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=WORK_DIR)
    world = mesh[0] * mesh[1] * mesh[2]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker",
         "--rank", str(r), "--world", str(world), "--store",
         os.path.join(tmp, "store"), "--job", job, "--device", device,
         "--mesh", ",".join(map(str, mesh)), "--out",
         os.path.join(tmp, f"rank{r}.pkl")], cwd=REPO, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    t_end = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > t_end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    try:
        failed = [r for r, p in enumerate(procs) if p.returncode]
        if failed:
            msg = []
            for r in failed:
                logs[r].seek(0)
                msg.append(f"rank {r} exit {procs[r].returncode}:\n"
                           f"{logs[r].read()[-3000:]}")
            raise RuntimeError(f"sharding job {job} on {device}:\n"
                               + "\n".join(msg))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_scaling_bench(nproc: int) -> list:
    """bench_scaling_torch.py under torchrun on `nproc` ranks (3 timed calls
    a mesh): its JSON lines; raises if it fails or outlives
    RANK_TIMEOUT_S (its process group is killed)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}",
           os.path.join(REPO, "bench_scaling_torch.py"), "--reps",
           str(SCALING_REPS)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f"scaling bench, {nproc} ranks: exit "
                           f"{proc.returncode}:\n{err[-3000:]}")
    return [json.loads(line) for line in out.strip().splitlines()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from PIL import Image

    from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, KITTI, Aggregator,
                                                CostMethod, CSPMConfig,
                                                README_DEMO)
    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models import postprocess as pp_mod
    from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                                run_pair_np)
    from crossscalepatchmatch_tpu_torch.models.postprocess import postprocess
    from crossscalepatchmatch_tpu_torch.ops import (onthefly_cost,
                                                    plane_cost,
                                                    prescreen_volume)
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import (_build,
                                                         bilateral_volume,
                                                         census_volume,
                                                         cross_scale_cost,
                                                         fly_cost,
                                                         grd_volume,
                                                         quadrant_build,
                                                         quadrant_rank,
                                                         window_cost)
    from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median as wmf
    from crossscalepatchmatch_tpu_torch.ops.pyramid import build_pyramid
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        launch_counts as read_counts, reset_launch_counts as reset_counts)
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        FLOPS_IN_IMAGE, FLOPS_IN_RANGE, FLY_FLOPS_IN_RANGE,
        WMF_OPS_PER_SAMPLE, bilateral_volume_work, bound, census_volume_work,
        grd_volume_work,
        median_least_ops, median_samples, nbytes, quadrant_build_samples,
        quadrant_rank_row_work, quadrant_rank_sectors, quadrant_rank_work,
        refine_propose_work, window_samples)

    pkg = "crossscalepatchmatch_tpu_torch"
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
    t_start = time.perf_counter()

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build(verbose=True)
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {paths}")

    cfg = README_DEMO
    hw, gamma, md = cfg.half_wnd, cfg.wgt_gamma, cfg.max_dis
    pair = make_pair(seed=0, **SHAPE)
    l = torch.as_tensor(pair.left, device=dev)
    r = torch.as_tensor(pair.right, device=dev)
    vd = build_volume_data(l, r, cfg)
    imgs, vols, mc = vd.imgs[0], vd.vols[0].contiguous(), vd.max_costs[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    h, w = SHAPE["h"], SHAPE["w"]

    # -- 3. K1 and K3's volume form ------------------------------------------
    def volume_phase(name, k, stride, reps, scene=None):
        """K1 (K3 at stride > 1) against its plain version on a scene's
        fine-level volumes (the bench scene's by default)."""
        p, v_imgs, v_vols, v_mc, v_md = scene or (pair, imgs, vols, mc, md)
        v_bf16 = v_vols.to(torch.bfloat16)
        ph, pw = p.disp_left.shape

        def plain():
            return torch.stack([plane_cost.window_plane_cost(
                v_imgs[v], v_vols[v], v_mc[v], abc[v], half_wnd=hw,
                max_dis=v_md, gamma=gamma, wnd_stride=stride)
                for v in range(2)])

        # prepared pairs: packing and the pair layout stay outside the
        # timed region
        preps = {key: window_cost.prepare_volumes(
            v_imgs, vol, v_mc, half_wnd=hw, max_dis=v_md, gamma=gamma)
            for key, vol in (("f32", v_vols), ("bf16", v_bf16))}

        def kernel(key):
            return window_cost.window_cost_prepared(
                preps[key], abc, half_wnd=hw, max_dis=v_md,
                wnd_stride=stride)

        abc = test_planes(p, v_md, k, gen, dev)
        want, plain_ms = timed_once(plain)
        ab, rl = check_close(f"{name} K={k}", kernel("f32"), want)
        _, rl_bf = rel_err(kernel("bf16"), want)
        del want
        t = time_turns({"f32": lambda: kernel("f32"),
                        "bf16": lambda: kernel("bf16")},
                       {"f32": reps, "bf16": reps})
        print(f"{name} K={k}: plain {plain_ms:.3f} ms | kernel f32 "
              f"{t['f32']:.3f} ms | kernel bf16 {t['bf16']:.3f} ms | bf16 "
              f"volume max rel {rl_bf:.3e}")
        n_img, n_rng = window_samples(abc, 1, hw, v_md, stride)
        b_ms, b_by = bound(nbytes(v_imgs, v_bf16, v_mc, abc)
                           + 2 * k * ph * pw * 4,
                           FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
        print(f"{name} K={k}: {n_img} in-image samples, {n_rng} in range; "
              f"bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=ab, max_rel_err=rl, bf16_max_rel_err=rl_bf,
                    ms=t["bf16"], ms_f32=t["f32"], plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)

    rec["k1"] = volume_phase("K1", 1, 1, 10)
    k1_k2 = volume_phase("K1", 2, 1, 10)
    rec["k1"].update(ms_k2=k1_k2["ms"], ms_f32_k2=k1_k2["ms_f32"],
                     plain_ms_k2=k1_k2["plain_ms"],
                     max_abs_err=max(rec["k1"]["max_abs_err"],
                                     k1_k2["max_abs_err"]))
    rec["k3_volume"] = volume_phase("K3 volume form, stride 2", 8, 2, 5)

    # -- 4. K2 ----------------------------------------------------------------
    stride = max(cfg.prescreen_stride, 1)

    def k2_phase(name, k2_imgs, k2_vols, reps):
        k2_bf16 = k2_vols.to(torch.bfloat16)

        def plain():
            parts = [prescreen_volume.build_quadrant_volumes(
                k2_imgs[v], k2_vols[v], half_wnd=hw, gamma=gamma,
                stride=stride) for v in range(2)]
            return (torch.stack([p[0] for p in parts]),
                    torch.stack([p[1] for p in parts]))

        d_max = k2_vols.shape[-1] - 1
        preps = {key: window_cost.prepare_volumes(
            k2_imgs, vol, None, half_wnd=hw, max_dis=d_max, gamma=gamma)
            for key, vol in (("f32", k2_vols), ("bf16", k2_bf16))}

        def kernel(key):
            return quadrant_build.quadrant_volumes_prepared(
                preps[key], half_wnd=hw, gamma=gamma, stride=stride)

        (want_b, want_w), plain_ms = timed_once(plain)
        got_b, got_w = kernel("f32")
        ab_b, rl_b = check_close(f"{name} bq", got_b, want_b)
        ab_w, rl_w = check_close(f"{name} wq", got_w, want_w)
        _, rl_bf = rel_err(kernel("bf16")[0], want_b)
        out_bytes = nbytes(got_b, got_w)
        del want_b, want_w, got_b, got_w
        t = time_turns({"f32": lambda: kernel("f32"),
                        "bf16": lambda: kernel("bf16")},
                       {"f32": reps, "bf16": reps})
        print(f"{name}: plain {plain_ms:.3f} ms | kernel f32 {t['f32']:.3f} "
              f"ms | kernel bf16 {t['bf16']:.3f} ms | bf16 volume bq max rel "
              f"{rl_bf:.3e}")
        # every in-image offset of a quadrant adds w * vol[q, :] (2 flops
        # per slice) and w to the weight sum
        _, kh, kw_, d = k2_vols.shape
        samples = quadrant_build_samples(kh, kw_, hw, stride)
        b_ms, b_by = bound(nbytes(k2_imgs, k2_bf16) + out_bytes,
                           samples * (2 * d + 1))
        print(f"{name}: D={d}, {samples} in-image samples; bound "
              f"{b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=max(ab_b, ab_w), max_rel_err=max(rl_b, rl_w),
                    bf16_max_rel_err=rl_bf, ms=t["bf16"], ms_f32=t["f32"],
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    rec["k2"] = k2_phase("K2", imgs, vols, 10)
    del vd, vols
    kpair = make_pair(seed=0, **KITTI_SHAPE)
    kl = torch.as_tensor(kpair.left, device=dev)
    kr = torch.as_tensor(kpair.right, device=dev)
    kvd = build_volume_data(kl, kr, KITTI)
    k2_129 = k2_phase("K2 KITTI D=129", kvd.imgs[0], kvd.vols[0], 2)
    rec["k2"].update({f"{key}_d129": val for key, val in k2_129.items()
                      if key != "bound_by"})
    rec["k2"]["max_abs_err"] = max(rec["k2"]["max_abs_err"],
                                   k2_129["max_abs_err"])
    k1_129 = volume_phase("K1 KITTI D=129", 1, 1, 3,
                          (kpair, kvd.imgs[0], kvd.vols[0].contiguous(),
                           kvd.max_costs[0], KITTI.max_dis))
    rec["k1"].update({f"{key}_d129": val for key, val in k1_129.items()
                      if key != "bound_by"})
    rec["k1"]["max_abs_err"] = max(rec["k1"]["max_abs_err"],
                                   k1_129["max_abs_err"])
    del kvd

    # -- 4b. GRDV and QRANK ---------------------------------------------------
    def grdv_check(name, gl, gr, gcfg, reps):
        """GRDV against its plain version on the card, both views (0
        differing elements), the plain volumes on the card against the
        CPU's (the elements the x 1/3 rounds apart); the wrapper and the
        plain version timed in turns (the record's ms and plain_ms, as
        every kernel's), the wrapper's device time with its calls queued
        (queued_ms: device_ms); one launch a call by the counter,
        pack_views never called, and one kernel and nothing else in the
        CUDA graph a captured call records (graph_kernels: nothing packed
        before it)."""
        gmd = gcfg.max_dis
        gkw = dict(alpha=gcfg.cost_alpha, tau_clr=gcfg.tau_clr,
                   tau_grd=gcfg.tau_grd, border_thres=gcfg.border_thres)
        got = grd_volume.grd_volumes(gl, gr, gmd, **gkw)
        want = grd_volume.grd_volumes_plain(gl, gr, gmd, **gkw)
        if got.shape != want.shape:
            raise RuntimeError(f"GRDV {name}: bad output {got.shape}")
        diff = int((got != want).sum())
        ab = float((got - want).abs().max())
        del got
        third = int((want.cpu() != grd_volume.grd_volumes_plain(
            gl.cpu(), gr.cpu(), gmd, **gkw)).sum())
        del want
        print(f"GRDV {name}: kernel vs plain on the card {diff} differing "
              f"f32 elements (both views); plain card vs CPU {third} "
              f"differing elements (the x 1/3 rounding)")
        if diff:
            raise RuntimeError(f"GRDV {name}: {diff} elements differ from "
                               "the plain version")

        def kernel():
            return grd_volume.grd_volumes(gl, gr, gmd, **gkw)

        def packed(*_a, **_k):
            raise RuntimeError(f"GRDV {name}: the wrapper called "
                               "pack_views")

        plain_fn = grd_volume.grd_volumes_plain
        pack_views, grd_volume.pack_views = grd_volume.pack_views, packed
        try:
            n0 = grd_volume.launches
            t = time_turns({
                "kernel": kernel,
                "plain": lambda: plain_fn(gl, gr, gmd, **gkw)},
                {"kernel": reps, "plain": 1})
            dev_ms = queued_ms(kernel, reps)
            n_all = graph_kernels(f"GRDV {name}", kernel, 1)
            calls = 3 * reps + 2 + 2
        finally:
            grd_volume.pack_views = pack_views
        if grd_volume.launches - n0 != calls:
            raise RuntimeError(f"GRDV {name}: {grd_volume.launches - n0} "
                               f"launches counted in {calls} calls")
        gh, gw_ = gl.shape[:2]
        b_ms, b_by = bound(*grd_volume_work(gh, gw_, gmd))
        print(f"GRDV {name} (both views, 2x{gh}x{gw_}x{gmd + 1}): plain "
              f"{t['plain']:.3f} ms | wrapper {t['kernel']:.3f} ms ("
              f"{n_all} kernel a call in its captured graph, one launch by "
              f"the counter, pack_views not called), on the device "
              f"{dev_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}): wrapper "
              f"{b_ms / t['kernel']:.1%}, device {b_ms / dev_ms:.1%}; "
              f"{card}")
        return dict(max_abs_err=ab, differing_elements=diff,
                    third_rounding_elements=third, ms=t["kernel"],
                    device_ms=dev_ms, plain_ms=t["plain"],
                    bound_ms=b_ms, bound_by=b_by, kernels_a_call=n_all)

    def cenv_check(name, cl, cr, cmd, levels, reps, wnd=9):
        """CENV against the plain census volumes on the card at every
        level of the views' pyramid (cl / cr: u8 BGR views; max_dis cmd >>
        s at level s), 0 differing elements each; all levels' calls and the
        plain version timed in turns (the record's ms and plain_ms, as
        every kernel's), their device time and level 0's with the calls
        queued (queued_ms: device_ms, level0_device_ms), one call a level
        by the counter and two kernels a level, and nothing else, in the
        CUDA graph a captured call records; the bound
        counts both u8 views of each level read and both volumes written
        (census_volume_work)."""
        lp, rp = build_pyramid(cl, levels), build_pyramid(cr, levels)
        lv = [(bgr_to_rgb(lp[s]), bgr_to_rgb(rp[s]), cmd >> s)
              for s in range(levels)]
        diff, ab = 0, 0.0
        for s, (a, b, m) in enumerate(lv):
            got = census_volume.census_volumes(a, b, m, wnd)
            want = census_volume.census_volumes_plain(a, b, m, wnd)
            if (got.shape != want.shape
                    or got.shape != (2, *a.shape[:2], m + 1)):
                raise RuntimeError(f"CENV {name} level {s}: bad output "
                                   f"{tuple(got.shape)}")
            n = int((got != want).sum())
            diff += n
            ab = max(ab, float((got - want).abs().max()))
            print(f"CENV {name} level {s} (2x{a.shape[0]}x{a.shape[1]}x"
                  f"{m + 1}): kernel vs plain on the card {n} differing f32 "
                  f"elements")
        if diff:
            raise RuntimeError(f"CENV {name}: {diff} elements differ from "
                               "the plain version")

        def kernel():
            return [census_volume.census_volumes(a, b, m, wnd)
                    for a, b, m in lv]

        def plain():
            return [census_volume.census_volumes_plain(a, b, m, wnd)
                    for a, b, m in lv]

        def level0():
            return census_volume.census_volumes(*lv[0], wnd)

        n0 = census_volume.launches
        t = time_turns({"kernel": kernel, "plain": plain},
                       {"kernel": reps, "plain": 1})
        dev_ms = queued_ms(kernel, reps)
        dev0_ms = queued_ms(level0, reps)
        n_all = graph_kernels(f"CENV {name}", kernel, 2 * levels)
        calls = levels * (3 * reps + 2 + 2) + reps + 1
        if census_volume.launches - n0 != calls:
            raise RuntimeError(f"CENV {name}: {census_volume.launches - n0}"
                               f" calls counted, {calls} made")
        h, w = cl.shape[:2]
        b_ms, b_by = bound(*census_volume_work(h, w, cmd, levels, wnd))
        b0_ms, _ = bound(*census_volume_work(h, w, cmd, 1, wnd))
        print(f"CENV {name} ({levels} level(s), wnd {wnd}): plain "
              f"{t['plain']:.3f} ms | wrappers {t['kernel']:.3f} ms "
              f"({n_all} kernels a call in its captured graph), on the device "
              f"{dev_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}): wrappers "
              f"{b_ms / t['kernel']:.1%}, device {b_ms / dev_ms:.1%} | "
              f"level 0 on the device {dev0_ms:.4f} ms, bound {b0_ms:.4f} "
              f"ms ({b0_ms / dev0_ms:.1%}); {card}")
        return dict(max_abs_err=ab, differing_elements=diff,
                    ms=t["kernel"], device_ms=dev_ms,
                    level0_device_ms=dev0_ms, plain_ms=t["plain"],
                    bound_ms=b_ms, bound_by=b_by, level0_bound_ms=b0_ms,
                    kernels_a_call=n_all)

    def qrank_check(name, bq, wq, qmc, abc, qhw, qmd, reps, shared=False):
        """QRANK against the plain ranking of each view on the card (0
        differing elements), both timed in turns; the bound and, beside
        it, the floor a gather of these taps can reach (the distinct
        32-byte sectors of bq they touch, over the HBM rate).  The bound
        counts 8 bytes a tap pair (quadrant_rank_work) on random planes,
        and each distinct tap float of a row once (quadrant_rank_row_work,
        also printed for random planes) on candidates that share taps
        (`shared`: the pipeline's), where 8 bytes a tap pair is no floor."""
        def kernel():
            return quadrant_rank.quadrant_rank(bq, wq, qmc, abc,
                                               half_wnd=qhw, max_dis=qmd)

        def plain():
            return torch.stack([prescreen_volume.quadrant_prescreen_cost(
                bq[v], wq[v], qmc[v], abc[v], half_wnd=qhw, max_dis=qmd)
                for v in range(2)])

        got, want = kernel(), plain()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"QRANK {name}: bad output {got.shape}")
        diff = int((got != want).sum())
        ab = float((got - want).abs().max())
        del got, want
        t = time_turns({"kernel": kernel, "plain": plain},
                       {"kernel": reps, "plain": 1})
        q_bytes, q_ops = quadrant_rank_work(abc, qhw, qmd)
        tap_ms, tap_by = bound(q_bytes, q_ops)
        r_bytes, r_ops = quadrant_rank_row_work(abc, qhw, qmd)
        row_ms, row_by = bound(r_bytes, r_ops)
        b_ms, b_by = (row_ms, row_by) if shared else (tap_ms, tap_by)
        sectors = quadrant_rank_sectors(abc, bq.shape[-1], qhw, qmd)
        floor_ms = bound(32 * sectors, 0)[0]
        print(f"QRANK {name}: kernel vs plain {diff} differing f32 elements; "
              f"plain {t['plain']:.3f} ms | kernel {t['kernel']:.3f} ms | "
              f"8 B a tap pair: {q_bytes} bytes, {tap_ms:.4f} ms ({tap_by}) "
              f"| each distinct tap float once: {r_bytes} bytes, "
              f"{row_ms:.4f} ms ({row_by}) | bound {b_ms:.4f} ms | "
              f"{sectors} sectors of bq touched, gather floor "
              f"{floor_ms:.4f} ms; {card}")
        if diff:
            raise RuntimeError(f"QRANK {name}: {diff} elements differ from "
                               "the plain version")
        return dict(max_abs_err=ab, differing_elements=diff, ms=t["kernel"],
                    plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by,
                    tap_bound_ms=tap_ms, row_bound_ms=row_ms,
                    sectors=sectors, sector_floor_ms=floor_ms)

    def grd_rank_phase(name, p, pl, pr, pcfg, reps):
        """GRDV on a scene's views, then QRANK on K2's output over the
        scene's GRDV volumes (f32): at K = 8 and 1 on test_planes, and at
        K = 8 on the pipeline's own candidates, the propagation stencil's
        (stencil_candidates, the first sweep's offsets) of the seed-0
        run_pair output's final planes."""
        out = {"grdv": grdv_check(name, bgr_to_rgb(pl), bgr_to_rgb(pr), pcfg,
                                  reps)}
        pvd = build_volume_data(pl, pr, pcfg)
        prep = window_cost.prepare_volumes(
            pvd.imgs[0], pvd.vols[0], pvd.max_costs[0], half_wnd=pcfg.half_wnd,
            max_dis=pcfg.max_dis, gamma=pcfg.wgt_gamma)
        del pvd
        bq, wq = quadrant_build.quadrant_volumes_prepared(
            prep, half_wnd=pcfg.half_wnd, gamma=pcfg.wgt_gamma,
            stride=max(pcfg.prescreen_stride, 1))
        for k in (8, 1):
            abc = test_planes(p, pcfg.max_dis, k, gen, dev)
            out[f"qrank_k{k}"] = qrank_check(
                f"{name} K={k}", bq, wq, prep.max_costs, abc, pcfg.half_wnd,
                pcfg.max_dis, reps)
        abc = pm.stencil_candidates(run_pair(pl, pr, 0, pcfg)["abc"],
                                    pm._stencil(pcfg, 0)).contiguous()
        out["qrank_pipeline"] = qrank_check(
            f"{name} K={abc.shape[1]}, pipeline candidates", bq, wq,
            prep.max_costs, abc, pcfg.half_wnd, pcfg.max_dis, reps,
            shared=True)
        return out

    gr_bench = grd_rank_phase("bench seed 0", pair, l, r, cfg, 10)
    gr_kitti = grd_rank_phase("KITTI seed 0", kpair, kl, kr, KITTI, 5)
    rec["grdv"] = dict(gr_bench["grdv"], **{
        f"{key}_kitti": val for key, val in gr_kitti["grdv"].items()
        if key != "bound_by"})
    rec["qrank"] = dict(gr_bench["qrank_k8"])
    for scene, tag in ((gr_bench, ""), (gr_kitti, "_kitti")):
        for case, suffix in (("qrank_k8", ""), ("qrank_k1", "_k1"),
                             ("qrank_pipeline", "_pipeline")):
            if tag or suffix:
                rec["qrank"].update({
                    f"{key}{tag}{suffix}": val
                    for key, val in scene[case].items() if key != "bound_by"})
    # CENV: the bench scene's 5 CEN_CS_PP levels, a KITTI-size level, and
    # a 6 x 5 crop whose 3 levels (6 x 5, 3 x 3, 2 x 2, the most its
    # pyramid takes) are narrower and lower than the census window
    rec["cenv"] = cenv_check("bench seed 0, CEN_CS_PP levels", l, r,
                             CEN_CS_PP.max_dis, CEN_CS_PP.scale_num, 10,
                             CEN_CS_PP.census_wnd)
    cenv_kitti = cenv_check("KITTI seed 0, one level", kl, kr,
                            KITTI.max_dis, 1, 5)
    tiny = make_pair(h=48, w=64, max_dis=8, seed=5)
    cenv_tiny = cenv_check("6x5 crop, 3 levels", *(
        torch.as_tensor(x[20:26, 30:35].copy(), device=dev)
        for x in (tiny.left, tiny.right)), 8, 3, 2)
    rec["cenv"].update({f"{key}_kitti": val for key, val in cenv_kitti.items()
                        if key != "bound_by"})
    rec["cenv"]["differing_elements_6x5"] = cenv_tiny["differing_elements"]
    for key in ("grdv", "qrank", "cenv"):
        rec[key]["max_abs_err"] = max(v for f, v in rec[key].items()
                                      if f.startswith("max_abs_err"))
    del gr_bench, gr_kitti
    torch.cuda.empty_cache()

    # -- 4c. RPROP: a refinement stage's candidates --------------------------
    from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose

    def rprop_check(name, pl, pr, pcfg, rounds, reps):
        """RPROP on the seed-0 pipeline's final planes of a scene, one
        stage of `rounds` of pcfg's schedule, against its plain version
        (the plain Philox's draws fed to perturb_planes, on the card): 0
        differing elements, both timed in turns; the kernel's device time
        queued behind a spinning kernel, its bound (bytes) and its launches
        read from a captured call's graph (exactly one kernel)."""
        abc = run_pair(pl, pr, 0, pcfg)["abc"].contiguous()
        zs, ns = pm.refinement_magnitudes(pcfg)
        draws = TorchDraws(0, dev)

        def kernel():
            return draws.propose(abc, 1, rounds, zs, ns, pcfg.eps)

        def plain():
            return refine_propose.refine_propose_plain(
                abc, draws.key, phase=draws.refine_phase, iteration=1,
                rounds=rounds, zs=zs, ns=ns, eps=pcfg.eps)

        got, want = kernel(), plain()
        diff = int(((got != want) & ~(got.isnan() & want.isnan())).sum())
        del got, want
        t = time_turns({"kernel": kernel, "plain": plain},
                       {"kernel": reps, "plain": 2})
        dev_ms = queued_ms(kernel, reps)
        n_graph = graph_kernels(f"RPROP {name}", kernel, 1)
        _, ph, pw, _ = abc.shape
        r_bytes, r_ops = refine_propose_work(len(rounds), ph, pw)
        b_ms, b_by = bound(r_bytes, r_ops)
        print(f"RPROP {name} (K={len(rounds)}, {ph}x{pw}): kernel vs plain "
              f"{diff} differing f32 elements; plain {t['plain']:.3f} ms | "
              f"wrapper {t['kernel']:.4f} ms, on the device {dev_ms:.4f} ms "
              f"({n_graph} kernel a call) | bound {b_ms:.4f} ms ({b_by}, "
              f"{r_bytes} bytes): {b_ms / dev_ms:.1%} of it on the device; "
              f"{card}")
        if diff:
            raise RuntimeError(f"RPROP {name}: {diff} elements differ from "
                               "the plain version")
        return dict(differing_elements=diff, ms=t["kernel"], device_ms=dev_ms,
                    plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by)

    # a KITTI stage (5 of 10 rounds), the bench's (Middlebury's 9 rounds:
    # 5, then 4)
    rec["rprop"] = rprop_check("KITTI seed 0", kl, kr, KITTI, range(5), 10)
    for key, val in rprop_check("bench seed 0", l, r, CEN_CS_PP, range(5, 9),
                                10).items():
        if key != "bound_by":
            rec["rprop"][f"{key}_bench"] = val
    torch.cuda.empty_cache()

    # -- 4d. BFV: the bilateral volume filter ---------------------------------
    def bfv_check(name, vols_in, guides, wnd, reps):
        """BFV on a level's unfiltered volumes of both views (what
        build_volume_data hands it on a BF path) against its plain version
        on the card: equal elements (torch.equal), slices 0 and D - 1 the
        input's; the plain version's time its comparison call, the
        wrapper's in turns, its device time queued behind a spinning
        kernel, one launch a call by the counter and one kernel and
        nothing else in a captured call's graph; the bound
        utils.roofline.bilateral_volume_work."""
        _, bh, bw, bd = vols_in.shape
        n0 = bilateral_volume.launches
        got = bilateral_volume.bilateral_volumes_cuda(vols_in, guides, wnd)
        want, plain_ms = timed_once(
            lambda: bilateral_volume.bilateral_volumes_plain(vols_in, guides,
                                                             wnd))
        same = torch.equal(got, want)
        diff = int((got != want).sum())
        ab = float((got - want).abs().max())
        edges = torch.equal(got[..., [0, bd - 1]], vols_in[..., [0, bd - 1]])
        del got, want
        print(f"BFV {name} (2x{bh}x{bw}x{bd}, wnd {wnd}): kernel vs plain on "
              f"the card {diff} differing f32 elements, slices 0 and D - 1 "
              f"passed through {edges}")
        if not same or not edges:
            raise RuntimeError(f"BFV {name}: {diff} elements differ from the "
                               f"plain version, edges kept {edges}")

        def kernel():
            return bilateral_volume.bilateral_volumes_cuda(vols_in, guides,
                                                           wnd)

        t = time_turns({"kernel": kernel}, {"kernel": reps})
        dev_ms = queued_ms(kernel, reps)
        n_graph = graph_kernels(f"BFV {name}", kernel, 1)
        calls = 1 + (1 + 2 * reps) + (1 + reps) + 2
        if bilateral_volume.launches - n0 != calls:
            raise RuntimeError(f"BFV {name}: {bilateral_volume.launches - n0}"
                               f" launches counted in {calls} calls")
        b_ms, b_by = bound(*bilateral_volume_work(bh, bw, bd, wnd))
        print(f"BFV {name}: plain {plain_ms:.3f} ms | wrapper "
              f"{t['kernel']:.3f} ms, on the device {dev_ms:.4f} ms "
              f"({n_graph} kernel a call) | bound {b_ms:.4f} ms ({b_by}): "
              f"device {b_ms / dev_ms:.1%}; {card}")
        return dict(max_abs_err=ab, differing_elements=diff, ms=t["kernel"],
                    device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, kernels_a_call=n_graph)

    # README_DEMO-BF's level (375x450, D=61), the new cell's KITTI level
    # (375x1242, D=129), and the coarsest level of a 5-level README_DEMO
    # pyramid, narrower than the window (the borders wrap more than once)
    bvd = build_volume_data(l, r, dataclasses.replace(
        README_DEMO, use_cs=True, scale_num=5))
    rec["bfv"] = bfv_check("bench seed 0", bvd.vols[0], bvd.imgs[0],
                           README_DEMO.wnd_size, 10)
    coarse = bfv_check("bench seed 0, level 4", bvd.vols[4], bvd.imgs[4],
                       README_DEMO.wnd_size, 10)
    del bvd
    kvd = build_volume_data(kl, kr, KITTI)
    for key, val in bfv_check("KITTI seed 0", kvd.vols[0], kvd.imgs[0],
                              KITTI.wnd_size, 5).items():
        if key != "bound_by":
            rec["bfv"][f"{key}_kitti"] = val
    del kvd
    rec["bfv"]["differing_elements_level4"] = coarse["differing_elements"]
    rec["bfv"]["max_abs_err"] = max(rec["bfv"]["max_abs_err"],
                                    rec["bfv"]["max_abs_err_kitti"],
                                    coarse["max_abs_err"])
    torch.cuda.empty_cache()

    # -- 5. K4 ----------------------------------------------------------------
    ccfg = CEN_CS_PP
    cvd = build_volume_data(l, r, ccfg)
    cimgs, cvols, cmc = cvd.imgs, cvd.vols, cvd.max_costs
    cvols_bf16 = [v.to(torch.bfloat16) for v in cvols]
    wgts = [float(x) for x in scale_weights(ccfg.scale_num, ccfg.reg_lambda)]
    chw = ccfg.half_wnd
    print(f"K4: levels {[tuple(v.shape) for v in cvols]}, weights {wgts}")

    def k4_plain(abc):
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in cimgs], [vo[v] for vo in cvols],
            [m[v] for m in cmc], wgts, abc[v], half_wnd=chw,
            max_dis=ccfg.max_dis, gamma=ccfg.wgt_gamma) for v in range(2)])

    k4_kw = dict(half_wnd=chw, max_dis=ccfg.max_dis, levels=len(cvols))

    def k4_prepare(v):
        return cross_scale_cost.prepare_cross_scale(
            cimgs, v, cmc, wgts, half_wnd=chw, max_dis=ccfg.max_dis,
            gamma=ccfg.wgt_gamma)

    def k4_kernel(abc, prep):
        return cross_scale_cost.cross_scale_cost_prepared(prep, abc, **k4_kw)

    k4_f32, k4_bf16 = k4_prepare(cvols), k4_prepare(cvols_bf16)
    # the kernel's pair layout: pair_volume against the plain layout's taps
    pos = torch.randint(0, h * w, (1 << 20,), generator=gen, device=dev)
    f = torch.randint(0, ccfg.max_dis, (1 << 20,), generator=gen, device=dev)
    for v in range(2):
        t0, t1 = cross_scale_cost.take_pair(
            cross_scale_cost.pair_volume(cvols[0][v]), pos, f)
        if not (torch.equal(t0, plane_cost.take_depth(cvols[0][v], pos, f))
                and torch.equal(t1, plane_cost.take_depth(cvols[0][v], pos,
                                                          f + 1))):
            raise RuntimeError("K4: pair-layout volume differs from the "
                               "plain layout's taps")
    k4 = {"max_abs_err": 0.0, "max_rel_err": 0.0}

    def k4_check(name, got, want):
        ab, rl = check_close(name, got, want)
        k4["max_abs_err"] = max(k4["max_abs_err"], ab)
        k4["max_rel_err"] = max(k4["max_rel_err"], rl)

    def k4_exact_bf16(name, abc, want):
        ab_bf, _ = rel_err(k4_kernel(abc, k4_bf16), want)
        print(f"{name}: bf16 census volumes max|d| {ab_bf:.3e}")
        if ab_bf != 0.0:
            raise RuntimeError(f"{name}: bf16 census volumes differ from "
                               f"the f32 plain version by {ab_bf}")

    def k4_times(name, abc):
        t = time_turns({"f32": lambda: k4_kernel(abc, k4_f32),
                        "bf16": lambda: k4_kernel(abc, k4_bf16)},
                       {"f32": 5, "bf16": 5})
        print(f"{name}: kernel f32 {t['f32']:.3f} ms | kernel bf16 "
              f"{t['bf16']:.3f} ms")
        return t

    abc = test_planes(pair, md, 1, gen, dev)
    want, plain_ms = timed_once(lambda: k4_plain(abc))
    k4_check("K4 K=1", k4_kernel(abc, k4_f32), want)
    k4_exact_bf16("K4 K=1", abc, want)
    del want
    print(f"K4 K=1: plain {plain_ms:.3f} ms")
    t = k4_times("K4 K=1", abc)
    n_img, n_rng = window_samples(abc, len(cvols), chw, ccfg.max_dis)
    b_ms, b_by = bound(nbytes(*cimgs, *cvols_bf16, *cmc, abc) + 2 * h * w * 4,
                       FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
    print(f"K4 K=1: {n_img} in-image samples, {n_rng} in range; "
          f"bound {b_ms:.4f} ms ({b_by})")
    k4.update(ms=t["bf16"], ms_f32=t["f32"], plain_ms=plain_ms,
              bound_ms=b_ms, bound_by=b_by)
    # more candidates, against one K=8 plain call (the plain version treats
    # each candidate on its own, so its first k results are those of a
    # K=k call)
    abc8 = test_planes(pair, md, 8, gen, dev)
    want, plain_ms = timed_once(lambda: k4_plain(abc8))
    for k in MANY_KS[1:]:
        k4_check(f"K4 first {k} of 8 candidates",
                 k4_kernel(abc8[:, :k].contiguous(), k4_f32), want[:, :k])
    abc = abc8[:, :2].contiguous()
    k4_exact_bf16("K4 K=2", abc, want[:, :2])
    del want
    t = k4_times("K4 K=2", abc)
    k4.update(ms_k2=t["bf16"], ms_f32_k2=t["f32"], plain_ms_k8=plain_ms,
              ms_k8=time_turns({"k": lambda: k4_kernel(abc8, k4_bf16)},
                               {"k": 3})["k"])
    print(f"K4 K=8: plain {plain_ms:.3f} ms | kernel bf16 "
          f"{k4['ms_k8']:.3f} ms")
    del abc8, k4_f32, k4_bf16
    # a window other than the presets'
    abc = test_planes(pair, md, 2, gen, dev)
    kw8 = dict(half_wnd=OTHER_HALF_WND, max_dis=ccfg.max_dis,
               gamma=ccfg.wgt_gamma)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in cimgs], [vo[v] for vo in cvols],
        [m[v] for m in cmc], wgts, abc[v], **kw8) for v in range(2)])
    k4_check(f"K4 half_wnd={OTHER_HALF_WND} K=2",
             cross_scale_cost.cross_scale_cost_cuda(cimgs, cvols, cmc, wgts,
                                                    abc, **kw8), want)
    rec["k4"] = k4
    del want, cvd, cvols, cvols_bf16

    # -- 6. the fly kernel: K5, K3 (fly form), K6, K7 -------------------------
    def fly_phase(name, fcfg, k, lerp, stride, reps, scene=None,
                  first_ks=(), time_first=0):
        """The fly kernel against its plain version on a scene (the bench
        scene by default), K candidates; first_ks: also its first k
        candidates for each k given, against the same plain call (the
        plain version treats each candidate on its own); time_first: also
        time the kernel on the first time_first candidates.  reps = 0: the
        check only."""
        p, pl, pr = scene or (pair, l, r)
        ph, pw = p.disp_left.shape
        fd = onthefly_cost.build_fly_data(pl, pr, fcfg)
        levels = len(fd.imgs)
        wg = ([float(x) for x in scale_weights(fcfg.scale_num,
                                               fcfg.reg_lambda)]
              if levels > 1 else None)
        kw = dict(half_wnd=fcfg.half_wnd, max_dis=fcfg.max_dis, lerp=lerp,
                  gamma=fcfg.wgt_gamma, alpha=fcfg.cost_alpha,
                  tau_clr=fcfg.tau_clr, tau_grd=fcfg.tau_grd,
                  border_thres=fcfg.border_thres)
        prep = fly_cost.prepare_fly(fd, wg, **kw)

        def kernel(planes):
            return fly_cost.fly_cost_prepared(
                prep, planes, half_wnd=fcfg.half_wnd, max_dis=fcfg.max_dis,
                levels=levels, wnd_stride=stride)

        abc = test_planes(p, fcfg.max_dis, k, gen, dev)
        want, plain_ms = timed_once(
            lambda: onthefly_cost.fly_plane_cost(fd, wg, abc,
                                                 wnd_stride=stride, **kw))
        ab, rl = check_close(f"{name} K={k}", kernel(abc), want)
        for kk in first_ks:
            ab_k, rl_k = check_close(f"{name} first {kk} of {k} candidates",
                                     kernel(abc[:, :kk].contiguous()),
                                     want[:, :kk])
            ab, rl = max(ab, ab_k), max(rl, rl_k)
        del want
        if not reps:
            return dict(max_abs_err=ab, max_rel_err=rl)
        fns = {"kernel": lambda: kernel(abc)}
        if time_first:
            head = abc[:, :time_first].contiguous()
            fns["first"] = lambda: kernel(head)
        t = time_turns(fns, dict.fromkeys(fns, reps))
        if time_first:
            print(f"{name} K={time_first}: kernel {t['first']:.3f} ms")
        n_img, n_rng = window_samples(abc, levels, fcfg.half_wnd,
                                      fcfg.max_dis, stride)
        inputs = [*fd.imgs, *fd.grds, *(fd.wimgs or []), abc]
        b_ms, b_by = bound(nbytes(*inputs) + 2 * k * ph * pw * 4,
                           FLOPS_IN_IMAGE * n_img
                           + FLY_FLOPS_IN_RANGE[lerp] * n_rng)
        print(f"{name} K={k}: plain {plain_ms:.3f} ms | kernel "
              f"{t['kernel']:.3f} ms | {n_img} in-image samples, {n_rng} in "
              f"range; bound {b_ms:.4f} ms ({b_by})")
        out = dict(max_abs_err=ab, max_rel_err=rl, ms=t["kernel"],
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if time_first:
            out["ms_first"] = t["first"]
        return out

    fcfg = dataclasses.replace(README_DEMO, precompute_volume=False)
    kitti_fly = dataclasses.replace(KITTI, precompute_volume=False)
    kitti = (kpair, kl, kr)
    rec["k5"] = fly_phase("K5", fcfg, 1, "cost", 1, 10)
    k5_cs = fly_phase("K5 cross-scale (5 levels)",
                      CSPMConfig(max_dis=md, precompute_volume=False,
                                 use_cs=True, reg_lambda=0.3),
                      1, "cost", 1, 5)
    # more candidates (stride 1) against one K=8 plain call, and a window
    # other than the presets'
    k5_k8 = fly_phase("K5", fcfg, 8, "cost", 1, 3, first_ks=(2, 3, 5),
                      time_first=2)
    k5_gen = fly_phase(
        f"K5 half_wnd={OTHER_HALF_WND}",
        dataclasses.replace(fcfg, wnd_size=2 * OTHER_HALF_WND + 1), 2,
        "cost", 1, 0)
    k3_gen = fly_phase(
        f"K3 fly form half_wnd={OTHER_HALF_WND}, stride 3",
        dataclasses.replace(fcfg, wnd_size=2 * OTHER_HALF_WND + 1), 5,
        "cost", 3, 0)
    k5_parts = (rec["k5"], k5_cs, k5_k8, k5_gen)
    rec["k5"].update(ms_k2=k5_k8["ms_first"], ms_k8=k5_k8["ms"],
                     plain_ms_k8=k5_k8["plain_ms"],
                     ms_cross_scale=k5_cs["ms"],
                     plain_ms_cross_scale=k5_cs["plain_ms"],
                     bound_ms_cross_scale=k5_cs["bound_ms"],
                     max_abs_err=max(p["max_abs_err"] for p in k5_parts),
                     max_rel_err=max(p["max_rel_err"] for p in k5_parts))
    k3_fly = fly_phase("K3 fly form, stride 2", fcfg, 8, "cost", 2, 5,
                       first_ks=(3, 5))
    k3_fly.update(
        max_abs_err=max(k3_fly["max_abs_err"], k3_gen["max_abs_err"]),
        max_rel_err=max(k3_fly["max_rel_err"], k3_gen["max_rel_err"]))
    rec["k3_fly"] = k3_fly
    # KITTI: the other view's staged span is tile + 128 columns wide
    k5_kitti = fly_phase("K5 KITTI d=128", kitti_fly, 1, "cost", 1, 3,
                         kitti)
    k3_kitti = fly_phase("K3 fly form KITTI d=128, stride 2", kitti_fly, 8,
                         "cost", 2, 3, kitti)
    for key, sub in (("k5", k5_kitti), ("k3_fly", k3_kitti)):
        rec[key].update({f"{f}_kitti": val for f, val in sub.items()
                         if f != "bound_by"})
        rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"],
                                      sub["max_abs_err"])
        rec[key]["max_rel_err"] = max(rec[key]["max_rel_err"],
                                      sub["max_rel_err"])
    rec["k6"] = fly_phase("K6 image lerp", fcfg, 1, "image", 1, 5)
    rec["k7"] = fly_phase("K7 Lab weights",
                          CSPMConfig(max_dis=md, precompute_volume=False,
                                     use_lab_weights=True), 1, "cost", 1, 5)
    print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. main paths --------------------------------------------------------
    def check_counts(name, counts, kernels):
        print(f"{name}: launches {counts}")
        # every path refines: RPROP proposes each stage
        if any(counts[k] == 0 for k in (*kernels, "rprop")):
            raise RuntimeError(f"{name}: a kernel of the path never "
                               "launched")
        if any(counts[k] for k in counts if k.endswith("_plain")):
            raise RuntimeError(f"{name}: the path ran a plain version on "
                               "the card")

    def main_path(name, pcfg, kernels, scene, seeds, px, gate=True):
        """Run the seeds (a repeated seed must give the same outputs);
        returns (outputs by seed, launch counts, bad-pixel @px by seed)."""
        p, pl, pr = scene
        ph, pw = p.left.shape[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        outs, times, bads = {}, [], {}
        for seed in seeds:
            t0 = time.perf_counter()
            out = run_pair(pl, pr, seed, pcfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if seed in outs:
                same = all(torch.equal(outs[seed][k], out[k]) for k in out)
                print(f"{name}: seed {seed} rerun bit-identical: {same}")
                if not same:
                    raise RuntimeError(f"{name}: same seed gave different "
                                       "outputs")
                continue
            outs[seed] = out
            dis = out["dis"].cpu().numpy()
            if seed == 0:
                digest = hashlib.sha256(dis.tobytes()).hexdigest()[:16]
                print(f"{name}: seed 0 dis digest {digest}")
            if dis.shape != (2, ph, pw):
                raise RuntimeError(f"{name}: dis shape {dis.shape}")
            if not bool(torch.isfinite(out["cost"]).all()):
                raise RuntimeError(f"{name}: non-finite final costs")
            bad = {t: bad_pixel_rate(dis[0] / pcfg.dis_scale, p.disp_left,
                                     p.valid_left, t) for t in (1.0, px)}
            bad_r = bad_pixel_rate(dis[1] / pcfg.dis_scale, p.disp_right,
                                   p.valid_right, px)
            bads[seed] = bad[px]
            print(f"{name}: seed {seed} {times[-1]:.1f} ms "
                  f"bad-pixel(nonocc) @{px:g}px left {bad[px]:.4f} right "
                  f"{bad_r:.4f}; @1px left {bad[1.0]:.4f}")
            if gate and bad[px] > BAD_PIXEL_MAX:
                raise RuntimeError(f"{name} seed {seed}: bad-pixel "
                                   f"{bad[px]} > {BAD_PIXEL_MAX}")
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check_counts(name, counts, kernels)
        mid = ""
        if len(times) > 1:
            later = sorted(times[1:])
            mid = f"; median of runs 2+ {later[len(later) // 2]:.1f}"
        print(f"{name}: ms/pair per run {times}{mid}; peak device memory "
              f"{peak / 2**20:.1f} MiB")
        return outs, counts, bads

    bench = (pair, l, r)
    paths, bf16_bads = {}, {}
    _, paths["README_DEMO"], bf16_bads["README_DEMO"] = main_path(
        "README_DEMO", README_DEMO, GRD_PATH, bench, (0, 1, 2, 0), 1.0)
    outs_cs, paths["CEN_CS_PP"], bf16_bads["CEN_CS_PP"] = main_path(
        "CEN_CS_PP", CEN_CS_PP, (*CEN_CS_PATH, "wmf"), bench, (0, 1, 2, 0),
        1.0)
    _, paths["README_DEMO-fly"], _ = main_path(
        "README_DEMO-fly", fcfg, ("k5", "k3_fly"), bench, (0, 1, 2, 0), 1.0)
    _, paths["KITTI-fly"], _ = main_path("KITTI-fly", kitti_fly,
                                         ("k5", "k3_fly", "wmf"), kitti,
                                         (0, 0), 3.0)
    outs_k, paths["KITTI"], bf16_bads["KITTI"] = main_path(
        "KITTI", KITTI, (*GRD_PATH, "wmf"), kitti, (0,), 3.0)

    # postprocess alone on the seed-0 planes: time, launches, same output
    from torch.profiler import ProfilerActivity, profile

    abc0 = outs_cs[0]["abc"]
    imgs0 = torch.stack([l, r])
    dis0 = pm.plane_to_disp(abc0, CEN_CS_PP.dis_scale)
    pp_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp_dis, _ = postprocess(dis0, abc0, imgs0, CEN_CS_PP)
        torch.cuda.synchronize()
        pp_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(pp_dis, outs_cs[0]["dis"]):
        raise RuntimeError("postprocess alone differs from the pipeline's")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        postprocess(dis0, abc0, imgs0, CEN_CS_PP)
        torch.cuda.synchronize()
    pp_launches = sum(1 for e in prof.events()
                      if e.device_type.name == "CUDA")
    n_invalid = int((~outs_cs[0]["valid"]).sum())
    print(f"CEN_CS_PP postprocess: ms per call {pp_ms}; "
          f"{pp_launches} kernel launches; {n_invalid} LR-invalid pixels")

    # -- 7b. WMF: the weighted median against its plain version -------------
    def wmf_inputs(out, pcfg, pl, pr):
        """The weighted median's inputs in postprocess, from a pipeline
        output: the filled maps, the images, the LR mask."""
        valid = out["valid"]
        dis = pp_mod.fill_invalid(pm.plane_to_disp(out["abc"],
                                                   pcfg.dis_scale),
                                  out["abc"], valid, pcfg)
        return dis, torch.stack([pl, pr]), valid

    def wmf_phase(name, pcfg, inputs, reps, want_out, **band):
        """WMF against its plain version on the card (u8, every pixel), and
        against want_out (the pipeline's map, or the whole image's tile);
        timed in turns: the wrapper (its two preparing launches and the
        kernel's), the kernel's launch alone on prepared inputs, the plain
        version."""
        w_dis, w_imgs, w_valid = inputs
        lut = plane_cost.asw_lut(pcfg.wmf_gamma, dev)

        def kernel():
            return wmf.weighted_median_cuda(w_dis, w_imgs, w_valid, lut,
                                            half_wnd=pcfg.half_wnd, **band)

        def plain():
            return pp_mod.weighted_median_plain(w_dis, w_imgs, w_valid, pcfg,
                                                **band)

        got, want = kernel(), plain()
        r0, c0 = band.get("center_row0", 0), band.get("center_col0", 0)
        region = (slice(None), slice(r0, r0 + got.shape[1]),
                  slice(c0, c0 + got.shape[2]))
        n = int((~w_valid[region]).sum())
        diff = int((got != want).sum()) if got.shape == want.shape else -1
        err = int((got.int() - want.int()).abs().max())
        print(f"WMF {name}: {n} invalid pixels, "
              f"{int((got != w_dis[region]).sum())} replaced; kernel vs "
              f"plain {diff} differing u8 pixels (max |d| {err}); equal to "
              f"the reference map {torch.equal(got, want_out)}")
        if diff != 0 or not torch.equal(got, want_out):
            raise RuntimeError(f"WMF {name}: {diff} pixels differ from the "
                               "plain version, or the map differs from the "
                               "reference")
        prep = wmf.prepare_median(
            w_dis, w_imgs, w_valid, r0, got.shape[1], c0, got.shape[2])
        t = time_turns({
            "kernel": kernel,
            "launch": lambda: wmf.weighted_median_prepared(
                prep, lut, half_wnd=pcfg.half_wnd),
            "plain": plain}, {"kernel": reps, "launch": reps, "plain": 1})
        if not torch.equal(prep[3], want):
            raise RuntimeError(f"WMF {name}: the timed launches differ from "
                               "the plain version")
        # the bound: the least work of an exact search (each window sample
        # once, one scan of the levels); beside it the bisection's count
        w_bytes = nbytes(w_dis, w_imgs, w_valid, lut, got)
        least = median_least_ops(w_valid, pcfg.half_wnd, **band)
        b_ms, b_by = bound(w_bytes, least)
        samples = median_samples(w_valid, pcfg.half_wnd, **band)
        bis_ms, bis_by = bound(w_bytes, WMF_OPS_PER_SAMPLE * samples)
        print(f"WMF {name}: plain {t['plain']:.3f} ms | wrapper "
              f"{t['kernel']:.3f} ms | launch alone {t['launch']:.3f} ms | "
              f"bound (least work, {least} operations) {b_ms:.4f} ms "
              f"({b_by}): wrapper {b_ms / t['kernel']:.1%}, launch "
              f"{b_ms / t['launch']:.1%} | the bisection's count ({samples} "
              f"window samples) {bis_ms:.4f} ms ({bis_by}): wrapper "
              f"{bis_ms / t['kernel']:.1%}, launch "
              f"{bis_ms / t['launch']:.1%}; {card}")
        return dict(max_abs_err=float(err), differing_pixels=diff,
                    n_invalid=n, samples=samples, least_ops=least,
                    ms=t["kernel"], launch_ms=t["launch"],
                    plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by,
                    bisection_bound_ms=bis_ms)

    cs_wmf_in = wmf_inputs(outs_cs[0], CEN_CS_PP, l, r)
    rec["wmf"] = wmf_phase("CEN_CS_PP seed 0 (375x450)", CEN_CS_PP,
                           cs_wmf_in, 10, outs_cs[0]["dis"])
    wmf_kitti = wmf_phase("KITTI seed 0 (375x1242)", KITTI,
                          wmf_inputs(outs_k[0], KITTI, kl, kr), 5,
                          outs_k[0]["dis"])
    rec["wmf"].update({f"{key}_kitti": val for key, val in wmf_kitti.items()
                       if key != "bound_by"})
    rec["wmf"]["max_abs_err"] = max(rec["wmf"]["max_abs_err"],
                                    wmf_kitti["max_abs_err"])
    del outs_k, wmf_kitti

    # -- 8. small pairs: card (kernels) vs CPU (plain versions), same draws -----
    small = make_pair(h=48, w=64, max_dis=12, seed=3)
    base = dict(max_dis=12, dis_scale=16, wnd_size=11, vol_dtype="f32")

    def card_vs_cpu(name, kernels, run):
        """run(device) -> u8 maps, on the card (a path of its own for the
        counters) and on the CPU; they must agree within 1 level on
        SMALL_AGREE_MIN of the pixels."""
        reset_counts()
        o_gpu = run(dev)
        torch.cuda.synchronize()
        paths[name] = read_counts()
        check_counts(f"small pair {name}", paths[name], kernels)
        o_cpu = run(torch.device("cpu"))
        agree = float((np.abs(o_gpu.astype(int) - o_cpu.astype(int))
                       <= 1).mean())
        print(f"small pair {name} card vs CPU: {agree:.4f} of u8 pixels "
              f"within 1")
        if agree < SMALL_AGREE_MIN:
            raise RuntimeError(f"{name}: card vs CPU agreement {agree} < "
                               f"{SMALL_AGREE_MIN}")

    for name, kernels, scfg in (
            ("README_DEMO-like", GRD_PATH, CSPMConfig(**base)),
            ("CEN_CS_PP-like", (*CEN_CS_PATH, "wmf"), CSPMConfig(
                cost_method=CostMethod.CEN, use_cs=True, use_pp=True,
                reg_lambda=0.3, scale_num=3, **base)),
            ("window-prescreen", ("k1", "k3_volume", "grdv"), CSPMConfig(
                prescreen_mode="window", **base)),
            ("fly-cost", ("k5", "k3_fly"), CSPMConfig(
                precompute_volume=False, **base)),
            ("fly-image-CS", ("k6",), CSPMConfig(
                precompute_volume=False, fly_lerp="image", use_cs=True,
                reg_lambda=0.3, scale_num=3, **{**base, "wnd_size": 7})),
            ("fly-Lab", ("k5", "k7", "k3_fly"), CSPMConfig(
                precompute_volume=False, use_lab_weights=True, **base))):
        card_vs_cpu(name, kernels, lambda d, c=scfg: run_pair_np(
            small.left, small.right, c, device=d,
            draws=TorchDraws(0, "cpu"))["dis"])

    # -- 9. the entry points on the card -----------------------------------
    from crossscalepatchmatch_tpu_torch import checkpoint, cli
    from crossscalepatchmatch_tpu_torch import io as cspm_io
    from crossscalepatchmatch_tpu_torch.models.pipeline import (
        run_pair_warm, run_sequence_np)
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        aggregate_volumes)
    from crossscalepatchmatch_tpu_torch.utils.rng import PHASE_WARM

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[
            :16]

    def bad1(dis, p, scale):
        return bad_pixel_rate(dis[0] / scale, p.disp_left, p.valid_left, 1.0)

    os.makedirs(WORK_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=WORK_DIR)
    try:
        # 9.1 the CLI: a subprocess, then in-process for the counters
        lp, rp = os.path.join(work, "l.png"), os.path.join(work, "r.png")
        cspm_io.write_bgr(lp, pair.left)
        cspm_io.write_bgr(rp, pair.right)
        if not (np.array_equal(cspm_io.read_bgr(lp), pair.left)
                and np.array_equal(cspm_io.read_bgr(rp), pair.right)):
            raise RuntimeError("CLI: the PNG round trip changed the views")

        def flags(tag, seed=None):
            f = [f"--l_img_file={lp}", f"--r_img_file={rp}",
                 f"--l_dis_file={work}/{tag}_l.png",
                 f"--r_dis_file={work}/{tag}_r.png", *README_FLAGS]
            return f if seed is None else [*f, f"--seed={seed}"]

        def cli_maps(tag):
            return np.stack([np.asarray(Image.open(f"{work}/{tag}_{v}.png"))
                             for v in "lr"])

        def run_cli(args):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", pkg, *args], cwd=REPO,
                capture_output=True, text=True, timeout=600)
            wall = (time.perf_counter() - t0) * 1e3
            if res.returncode != 0:
                raise RuntimeError(f"CLI exit {res.returncode}:\n"
                                   f"{res.stdout}\n{res.stderr}")
            total = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("Total Time:")]
            print(f"CLI {' '.join(args[:1])} ...: {total}, process "
                  f"{wall:.0f} ms")
            return total

        run_cli(flags("sub"))
        reset_counts()
        if cli.main(flags("inproc")) != 0:
            raise RuntimeError("CLI in-process: non-zero exit")
        torch.cuda.synchronize()
        paths["CLI"] = read_counts()
        check_counts("CLI (in process)", paths["CLI"], GRD_PATH)
        want = run_pair_np(pair.left, pair.right, cli.config_from_args(
            cli.build_parser().parse_args(flags("x"))), seed=0)["dis"]
        same = [np.array_equal(cli_maps(t), want) for t in ("sub", "inproc")]
        print(f"CLI README demo flags: subprocess maps == run_pair_np "
              f"{same[0]}, in-process == run_pair_np {same[1]}, digest "
              f"{digest(want)}, bad-pixel @1px {bad1(want, pair, 4):.4f}")
        if not all(same):
            raise RuntimeError("CLI maps differ from run_pair_np's")
        lst = os.path.join(work, "input.txt")
        with open(lst, "w") as f:
            for seed in (0, 1):
                f.write(f"cspm {' '.join(flags(f'list{seed}', seed))}\n")
        if len(run_cli([f"--input_list={lst}"])) != 2:
            raise RuntimeError("CLI --input_list: not two runs")
        lists = [cli_maps(f"list{seed}") for seed in (0, 1)]
        print(f"CLI --input_list: seed 0 == the single run "
              f"{np.array_equal(lists[0], want)}, seed 1 differs "
              f"{not np.array_equal(lists[1], want)}, seed 1 bad-pixel "
              f"@1px {bad1(lists[1], pair, 4):.4f}")
        if (not np.array_equal(lists[0], want)
                or np.array_equal(lists[1], want)
                or bad1(lists[1], pair, 4) > BAD_PIXEL_MAX):
            raise RuntimeError("CLI --input_list: wrong maps")

        # 9.2 a warm frame after a cold one (README_DEMO): the same
        # geometry, the next frame's sensor noise
        nxt = make_pair(seed=0, noise_sigma=2.0, **SHAPE)
        frames = [(pair.left, pair.right), (nxt.left, nxt.right)]

        def sequence():
            outs, ms = [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for out in run_sequence_np(frames, README_DEMO, seed=0):
                outs.append(out)
                t1 = time.perf_counter()
                ms.append((t1 - t0) * 1e3)
                t0 = t1
            return outs, ms

        sequence()       # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        seq, ms = sequence()
        paths["warm sequence"] = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check_counts("warm sequence", paths["warm sequence"], GRD_PATH)
        again, ms2 = sequence()
        same = all(np.array_equal(a[k], b[k])
                   for a, b in zip(seq, again) for k in a)
        warm_bad = bad1(seq[1]["dis"], nxt, 4)
        print(f"warm frame (README_DEMO, warm_iters 1): cold {ms[0]:.1f} / "
              f"{ms2[0]:.1f} ms, warm {ms[1]:.1f} / {ms2[1]:.1f} ms a frame; "
              f"peak device memory {peak / 2**20:.1f} MiB; bad-pixel @1px "
              f"cold {bad1(seq[0]['dis'], pair, 4):.4f} warm {warm_bad:.4f}; "
              f"rerun bit-identical {same}; warm digest "
              f"{digest(seq[1]['dis'])}")
        if warm_bad > BAD_PIXEL_MAX or not same:
            raise RuntimeError("warm frame: bad-pixel over the gate or a "
                               "rerun differs")

        # 9.3 checkpoint and resume (README_DEMO)
        ck_path = os.path.join(work, "state.npz")
        saved = {}
        save_state = checkpoint.save_state

        def spy(path, state, iteration, scfg, seed):
            saved[iteration] = state
            save_state(path, state, iteration, scfg, seed)

        reset_counts()
        checkpoint.save_state = spy
        try:
            full = checkpoint.run_pair_resumable(pair.left, pair.right,
                                                 README_DEMO, ck_path)
        finally:
            checkpoint.save_state = save_state
        paths["resume"] = read_counts()
        check_counts("resume", paths["resume"], GRD_PATH)
        plain = run_pair_np(pair.left, pair.right, README_DEMO, seed=0)
        same = [all(np.array_equal(full[k], plain[k]) for k in plain)]
        for rewind in (1, 2):
            checkpoint.save_state(ck_path, saved[rewind], rewind,
                                  README_DEMO, 0)
            res = checkpoint.run_pair_resumable(pair.left, pair.right,
                                                README_DEMO, ck_path)
            same.append(all(np.array_equal(full[k], res[k]) for k in full))
        print(f"resume (README_DEMO): uninterrupted == run_pair {same[0]} "
              f"(dis digest {digest(full['dis'])}); rewound to iteration 1 "
              f"and resumed bit-equal {same[1]}, to iteration 2 {same[2]}")
        if not all(same):
            raise RuntimeError("resume: not bit-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 9.4 the aggregators (README_DEMO, seed 0): ms/pair, the filter's own
    # device time on the two views' level-0 volumes, peak memory, bad-pixel
    plain_vd = build_volume_data(l, r, README_DEMO)
    for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF):
        acfg = dataclasses.replace(README_DEMO, aggregator=agg)
        run_pair(l, r, 0, acfg)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        out = run_pair(l, r, 0, acfg)
        torch.cuda.synchronize()
        ms_pair = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        paths[f"aggregator {agg.value}"] = read_counts()
        check_counts(f"aggregator {agg.value}",
                     paths[f"aggregator {agg.value}"], agg_path(agg))
        _, agg_ms = timed_once(lambda: aggregate_volumes(
            plain_vd.vols[0], plain_vd.imgs[0], acfg))
        bad = bad1(out["dis"].cpu().numpy(), pair, 4)
        bf16_bads[f"README_DEMO-{agg.value}"] = {0: bad}
        print(f"aggregator {agg.value}: {ms_pair:.1f} ms/pair, aggregation "
              f"{agg_ms:.1f} device ms (2 views), peak device memory "
              f"{peak / 2**20:.1f} MiB, bad-pixel @1px {bad:.4f}")
    del plain_vd

    # 9.5 small pairs, card vs CPU: each aggregator, CEN+CS+BOX, a warm
    # frame (both from the CPU's cold planes, the same warm draws)
    for agg in ("BOX", "GF", "BF"):
        scfg = CSPMConfig(aggregator=Aggregator(agg), **base)
        card_vs_cpu(f"aggregator {agg}", agg_path(Aggregator(agg)),
                    lambda d, c=scfg: run_pair_np(
                        small.left, small.right, c, device=d,
                        draws=TorchDraws(0, "cpu"))["dis"])
    scfg = CSPMConfig(cost_method=CostMethod.CEN, use_cs=True,
                      reg_lambda=0.3, scale_num=3, aggregator=Aggregator.BOX,
                      **base)
    card_vs_cpu("CEN+CS+BOX", CEN_CS_PATH, lambda d: run_pair_np(
        small.left, small.right, scfg, device=d,
        draws=TorchDraws(0, "cpu"))["dis"])
    scfg = CSPMConfig(**base)
    prior = run_pair_np(small.left, small.right, scfg, device="cpu",
                        draws=TorchDraws(0, "cpu"))["abc"]
    card_vs_cpu("warm frame", GRD_PATH, lambda d: run_pair_warm(
        small.left, small.right, 1, prior, scfg, device=d,
        draws=TorchDraws(1, "cpu", refine_phase=PHASE_WARM))[
            "dis"].cpu().numpy())

    # 9.6 kernel volumes in f32 against the default bf16: bad-pixel per
    # seed (printed, not gated: the JAX engine has the same bf16 default);
    # the aggregators' filtered volumes are not integers, so bf16 rounds them
    for name, pcfg, kernels, scene, seeds, px in (
            ("README_DEMO", README_DEMO, GRD_PATH, bench, (0, 1, 2),
             1.0),
            ("CEN_CS_PP", CEN_CS_PP, (*CEN_CS_PATH, "wmf"), bench, (0,), 1.0),
            ("KITTI", KITTI, (*GRD_PATH, "wmf"), kitti, (0,), 3.0),
            *((f"README_DEMO-{agg.value}",
               dataclasses.replace(README_DEMO, aggregator=agg),
               agg_path(agg), bench, (0,), 1.0)
              for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF))):
        _, paths[f"{name} f32"], f32 = main_path(
            f"{name} f32 volumes", dataclasses.replace(pcfg, vol_dtype="f32"),
            kernels, scene, seeds, px, gate=False)
        for seed in seeds:
            gap = f32[seed] - bf16_bads[name][seed]
            print(f"{name} seed {seed}: bad-pixel @{px:g}px f32 "
                  f"{f32[seed]:.4f} bf16 {bf16_bads[name][seed]:.4f} gap "
                  f"{gap:+.4f}{' (over 0.005)' if abs(gap) > 0.005 else ''}")

    # -- 10. sharding ---------------------------------------------------------
    from crossscalepatchmatch_tpu_torch.parallel import _comm
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full

    n_ty, n_tx = MESH_BENCH[1:]
    ths, tws = h // n_ty, w // n_tx
    row0, col0 = TILE_INDEX[0] * ths, TILE_INDEX[1] * tws

    def bench_tile(tcfg):
        """The bench scene's middle tile of the (1, 3, 2) mesh: level 0 the
        block with its half_wnd halo (zeros past the image), the coarser
        levels whole; per level the band's origin, validity interval and
        rectangle; the level-0 validity vectors."""
        tvd = build_volume_data(l, r, tcfg)
        thw = tcfg.half_wnd

        def ext(x):
            return _ext_from_full(_ext_from_full(x, row0, ths, thw, 1),
                                  col0, tws, thw, 2).contiguous()

        bounds = [(-row0, h - row0, -col0, w - col0)] + [
            (-row0, (im.shape[1] << s) - row0, -col0,
             (im.shape[2] << s) - col0)
            for s, im in enumerate(tvd.imgs) if s]
        origins = [(thw, thw)] + [(row0, col0)] * (len(tvd.imgs) - 1)
        imgs_t = [ext(tvd.imgs[0])] + tvd.imgs[1:]
        rects = [cross_scale_cost.band_rect(im.shape[1:3], s, o, (ths, tws),
                                            b)
                 for s, (im, o, b) in enumerate(zip(imgs_t, origins,
                                                    bounds))]
        g_row = row0 + torch.arange(-thw, ths + thw, device=dev)
        g_col = col0 + torch.arange(-thw, tws + thw, device=dev)
        return dict(imgs=imgs_t, vols=[ext(tvd.vols[0])] + tvd.vols[1:],
                    mcs=tvd.max_costs, bounds=bounds, origins=origins,
                    rects=rects, rv=(g_row >= 0) & (g_row < h),
                    cv=(g_col >= 0) & (g_col < w))

    def tile_planes(tmd, k):
        """test_planes on the scene, cut to the tile and re-anchored to its
        local coordinates."""
        full = test_planes(pair, tmd, k, gen, dev)[
            :, :, row0:row0 + ths, col0:col0 + tws]
        c = full[..., 2] + full[..., 0] * col0 + full[..., 1] * row0
        return torch.cat([full[..., :2], c[..., None]], -1).contiguous()

    def check_bit_equal(name, got, want):
        ab, _ = check_close(name, got, want)
        if ab != 0.0:
            raise RuntimeError(f"{name}: the band form differs from its "
                               f"plain version by {ab} in f32")
        return ab

    # 10.1 the band forms against their plain band forms, bench tile
    bt = bench_tile(cfg)
    b_imgs, b_vols, b_mc = bt["imgs"][0], bt["vols"][0], bt["mcs"][0]
    b_bf16 = b_vols.to(torch.bfloat16)
    band_preps = {key: window_cost.prepare_volumes(
        b_imgs, vol, b_mc, half_wnd=hw, max_dis=md, gamma=gamma,
        rows_extended=True, cols_extended=True)
        for key, vol in (("f32", b_vols), ("bf16", b_bf16))}
    b_geom = [(bt["origins"][0], bt["rects"][0])]

    def band_volume_phase(name, k, stride, reps):
        abc = tile_planes(md, k)

        def kernel(key):
            return window_cost.window_cost_prepared(
                band_preps[key], abc, half_wnd=hw, max_dis=md,
                wnd_stride=stride, bounds=bt["bounds"][0])

        want, plain_ms = timed_once(lambda: torch.stack([
            plane_cost.window_plane_cost(
                b_imgs[v], b_vols[v], b_mc[v], abc[v], half_wnd=hw,
                max_dis=md, gamma=gamma, center_row0=hw,
                row_valid=bt["rv"], center_col0=hw, col_valid=bt["cv"],
                wnd_stride=stride) for v in range(2)]))
        ab = check_bit_equal(f"{name} band form K={k}", kernel("f32"), want)
        _, rl_bf = rel_err(kernel("bf16"), want)
        t = time_turns({"f32": lambda: kernel("f32"),
                        "bf16": lambda: kernel("bf16")},
                       {"f32": reps, "bf16": reps})
        n_img, n_rng = window_samples(abc, 1, hw, md, stride, b_geom)
        b_ms, b_by = bound(nbytes(b_imgs, b_bf16, b_mc, abc)
                           + 2 * k * ths * tws * 4,
                           FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
        print(f"{name} band form K={k} (tile {ths}x{tws} of a "
              f"{MESH_BENCH} mesh): plain {plain_ms:.3f} ms | kernel f32 "
              f"{t['f32']:.3f} ms | bf16 {t['bf16']:.3f} ms | bf16 max rel "
              f"{rl_bf:.3e} | {n_img} valid samples, {n_rng} in range; "
              f"bound {b_ms:.4f} ms ({b_by})")
        return dict(max_abs_err=ab, bf16_max_rel_err=rl_bf, ms=t["bf16"],
                    ms_f32=t["f32"], plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by)

    rec["k1_band"] = band_volume_phase("K1", 1, 1, 10)
    k1b_k2 = band_volume_phase("K1", 2, 1, 10)
    rec["k1_band"].update(ms_k2=k1b_k2["ms"], ms_f32_k2=k1b_k2["ms_f32"],
                          plain_ms_k2=k1b_k2["plain_ms"])
    rec["k3_volume_band"] = band_volume_phase("K3 volume form, stride 2", 8,
                                              2, 5)
    print(f"whole-image forms for comparison (bf16, bench shape): K1 K=1 "
          f"{rec['k1']['ms']:.3f} ms, K=2 {rec['k1']['ms_k2']:.3f} ms, K3 "
          f"{rec['k3_volume']['ms']:.3f} ms, K2 {rec['k2']['ms']:.3f} ms, K4 "
          f"{rec['k4']['ms']:.3f} ms")

    # K2 over the tile's own pixels
    k2_preps = {key: window_cost.prepare_volumes(
        b_imgs, vol, None, half_wnd=hw, max_dis=md, gamma=gamma,
        rows_extended=True, cols_extended=True)
        for key, vol in (("f32", b_vols), ("bf16", b_bf16))}

    def k2_band(key):
        return quadrant_build.quadrant_volumes_prepared(
            k2_preps[key], half_wnd=hw, gamma=gamma, stride=stride,
            bounds=bt["bounds"][0])

    def k2_band_plain():
        valid = bt["rv"][:, None] & bt["cv"][None, :]
        parts = [prescreen_volume.build_quadrant_volumes(
            b_imgs[v], b_vols[v], valid, half_wnd=hw, gamma=gamma,
            stride=stride) for v in range(2)]
        return tuple(torch.stack([p[i] for p in parts])[
            :, :, hw:hw + ths, hw:hw + tws] for i in range(2))

    (want_b, want_w), plain_ms = timed_once(k2_band_plain)
    got_b, got_w = k2_band("f32")
    ab = max(check_bit_equal("K2 band form bq", got_b, want_b),
             check_bit_equal("K2 band form wq", got_w, want_w))
    _, rl_bf = rel_err(k2_band("bf16")[0], want_b)
    out_bytes = nbytes(got_b, got_w)
    # QRANK on K2's band-form output, the tile's planes
    qb = {k: qrank_check(f"band form K={k} (tile {ths}x{tws})", got_b, got_w,
                         b_mc, tile_planes(md, k), hw, md, 10)
          for k in (8, 1)}
    rec["qrank_band"] = dict(qb[8], **{f"{key}_k1": val
                                       for key, val in qb[1].items()
                                       if key != "bound_by"})
    rec["qrank_band"]["max_abs_err"] = max(qb[8]["max_abs_err"],
                                           qb[1]["max_abs_err"])
    # GRDV on the tile's full-width band, as parallel.tiled builds a GRD
    # tile's volumes
    rec["grdv_band"] = grdv_check(
        f"full-width band (rows {row0}-{row0 + ths})",
        bgr_to_rgb(l[row0:row0 + ths]), bgr_to_rgb(r[row0:row0 + ths]), cfg,
        10)
    del want_b, want_w, got_b, got_w, qb
    t = time_turns({"f32": lambda: k2_band("f32"),
                    "bf16": lambda: k2_band("bf16")}, {"f32": 10, "bf16": 10})
    samples = quadrant_build_samples(ths, tws, hw, stride, bt["origins"][0],
                                     bt["rects"][0])
    b_ms, b_by = bound(nbytes(b_imgs, b_bf16) + out_bytes,
                       samples * (2 * (md + 1) + 1))
    print(f"K2 band form (tile {ths}x{tws}): plain {plain_ms:.3f} ms | kernel "
          f"f32 {t['f32']:.3f} ms | bf16 {t['bf16']:.3f} ms | bf16 bq max rel "
          f"{rl_bf:.3e} | {samples} valid samples; bound {b_ms:.4f} ms "
          f"({b_by})")
    rec["k2_band"] = dict(max_abs_err=ab, bf16_max_rel_err=rl_bf,
                          ms=t["bf16"], ms_f32=t["f32"], plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
    del band_preps, k2_preps, b_bf16, bt

    # K4 over the 5-level census pyramid on the tile
    ct = bench_tile(ccfg)
    c_bf16 = [v.to(torch.bfloat16) for v in ct["vols"]]
    k4_band_preps = {key: cross_scale_cost.prepare_cross_scale(
        ct["imgs"], vols_, ct["mcs"], wgts, half_wnd=chw,
        max_dis=ccfg.max_dis, gamma=ccfg.wgt_gamma, rows_extended=True,
        cols_extended=True, origin=(row0, col0), bounds=ct["bounds"])
        for key, vols_ in (("f32", ct["vols"]), ("bf16", c_bf16))}
    n_lv = len(ct["vols"])

    def k4_band(abc, key):
        return cross_scale_cost.cross_scale_cost_prepared(
            k4_band_preps[key], abc, half_wnd=chw, max_dis=ccfg.max_dis,
            levels=n_lv)

    def k4_band_plain(abc):
        return torch.stack([plane_cost.cross_scale_plane_cost(
            [im[v] for im in ct["imgs"]], [vo[v] for vo in ct["vols"]],
            [m[v] for m in ct["mcs"]], wgts, abc[v], half_wnd=chw,
            max_dis=ccfg.max_dis, gamma=ccfg.wgt_gamma,
            origins=ct["origins"], row_valids=[ct["rv"]] + [None] * 4,
            col_valids=[ct["cv"]] + [None] * 4) for v in range(2)])

    k4b = {}
    for k in (1, 2):
        abc = tile_planes(md, k)
        want, plain_ms = timed_once(lambda: k4_band_plain(abc))
        ab = check_bit_equal(f"K4 band form K={k}", k4_band(abc, "f32"),
                             want)
        ab_bf, _ = rel_err(k4_band(abc, "bf16"), want)
        if ab_bf != 0.0:
            raise RuntimeError(f"K4 band form K={k}: bf16 census volumes "
                               f"differ from the f32 plain version by "
                               f"{ab_bf}")
        t = time_turns({"f32": lambda: k4_band(abc, "f32"),
                        "bf16": lambda: k4_band(abc, "bf16")},
                       {"f32": 5, "bf16": 5})
        print(f"K4 band form K={k} (tile, {n_lv} levels, origin "
              f"{(row0, col0)}): plain {plain_ms:.3f} ms | kernel f32 "
              f"{t['f32']:.3f} ms | bf16 {t['bf16']:.3f} ms")
        if k == 1:
            geoms = list(zip(ct["origins"], ct["rects"]))
            n_img, n_rng = window_samples(abc, n_lv, chw, ccfg.max_dis, 1,
                                          geoms)
            b_ms, b_by = bound(
                nbytes(*ct["imgs"], *c_bf16, *ct["mcs"], abc)
                + 2 * ths * tws * 4,
                FLOPS_IN_IMAGE * n_img + FLOPS_IN_RANGE * n_rng)
            print(f"K4 band form K=1: {n_img} valid samples, {n_rng} in "
                  f"range; bound {b_ms:.4f} ms ({b_by})")
            k4b = dict(max_abs_err=ab, ms=t["bf16"], ms_f32=t["f32"],
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        else:
            k4b.update(max_abs_err=max(k4b["max_abs_err"], ab),
                       ms_k2=t["bf16"], ms_f32_k2=t["f32"],
                       plain_ms_k2=plain_ms)
    rec["k4_band"] = k4b
    del k4_band_preps, c_bf16, ct

    # WMF over the tile's own pixels: the seed-0 CEN_CS_PP maps and mask
    # with the half-window halo (zeros, so invalid, past the image), as
    # parallel.tiled passes them
    def wmf_ext(x):
        return _ext_from_full(_ext_from_full(x, row0, ths, chw, 1), col0,
                              tws, chw, 2).contiguous()

    c_dis, c_imgs, c_valid = cs_wmf_in
    rec["wmf_band"] = wmf_phase(
        f"band form (tile {ths}x{tws} of a {MESH_BENCH} mesh)", CEN_CS_PP,
        (wmf_ext(c_dis), wmf_ext(c_imgs),
         wmf_ext(c_valid.to(torch.uint8)).bool()), 10,
        outs_cs[0]["dis"][:, row0:row0 + ths, col0:col0 + tws],
        center_row0=chw, out_h=ths, center_col0=chw, out_w=tws)
    del cs_wmf_in, c_dis, c_imgs, c_valid

    # 10.2 a (1, 3, 2) gloo mesh of six ranks on the one card: README_DEMO
    # and CEN_CS_PP on the bench scene through the band forms
    t0 = time.perf_counter()
    ranks = spawn_ranks("bench", MESH_BENCH, "cuda")
    print(f"sharded bench: {len(ranks)} ranks, transport "
          f"{ranks[0]['transport']}, {time.perf_counter() - t0:.1f} s with "
          f"the processes' start")
    for name, kernels in (("README_DEMO", GRD_PATH),
                          ("CEN_CS_PP", (*CEN_CS_PATH, "wmf"))):
        runs = [rk["runs"][name] for rk in ranks]
        counts = {key: sum(rn["counts"][key] for rn in runs)
                  for key in runs[0]["counts"]}
        paths[f"sharded {name}"] = counts
        check_counts(f"sharded {name} {MESH_BENCH}", counts, kernels)
        dis = runs[0]["dis"]
        pcfg = README_DEMO if name == "README_DEMO" else CEN_CS_PP
        if dis.shape != (1, 2, h, w):
            raise RuntimeError(f"sharded {name}: maps {dis.shape}")
        bad = bad1(dis[0], pair, pcfg.dis_scale)
        single = bf16_bads[name][0]
        ms = max(rn["ms"] for rn in runs)
        staged = sum(rn["host_bytes"] for rn in runs)
        print(f"sharded {name} {MESH_BENCH}: {ms:.1f} ms/pair (slowest "
              f"rank), {staged} bytes staged through the host (all ranks), "
              f"rerun bit-identical {all(rn['same'] for rn in runs)}; "
              f"bad-pixel @1px {bad:.4f} against one device's {single:.4f}; "
              f"digest {digest(dis)}; {card}")
        if (bad > BAD_PIXEL_MAX or abs(bad - single) > SHARDED_GAP_MAX
                or not all(rn["same"] for rn in runs)):
            raise RuntimeError(f"sharded {name}: bad-pixel {bad} (one "
                               f"device {single}) or a rerun differs")
        rec[f"sharded_{name}"] = dict(ms=ms, host_bytes=staged, bad=bad)

    # 10.3 a small pair on a (1, 2, 2) mesh: the card against the CPU, the
    # same draws
    on_card = spawn_ranks("small", MESH_SMALL, "cuda")
    on_cpu = spawn_ranks("small", MESH_SMALL, "cpu")
    for name, kernels in (("small", (*GRD_PATH, "wmf")),
                          ("small window-prescreen",
                           ("k1", "k3_volume", "grdv"))):
        counts = {key: sum(rk["runs"][name]["counts"][key] for rk in on_card)
                  for key in on_card[0]["runs"][name]["counts"]}
        paths[f"sharded {name} pair"] = counts
        check_counts(f"sharded {name} pair {MESH_SMALL}", counts, kernels)
        o_gpu = on_card[0]["runs"][name]["dis"]
        o_cpu = on_cpu[0]["runs"][name]["dis"]
        agree = float((np.abs(o_gpu.astype(int) - o_cpu.astype(int)) <= 1)
                      .mean())
        print(f"sharded {name} pair {MESH_SMALL} card vs CPU: {agree:.4f} of "
              f"u8 pixels within 1")
        if agree < SMALL_AGREE_MIN:
            raise RuntimeError(f"sharded {name} pair: card vs CPU agreement "
                               f"{agree} < {SMALL_AGREE_MIN}")

    # 10.4 a world of one rank (NCCL, the transport written for multi-card
    # hosts): the sequence batch and the no-volume data-only mesh, each
    # byte-equal to its per-pair run
    import torch.distributed as dist

    from crossscalepatchmatch_tpu_torch.parallel.mesh import (
        initialize_multihost)
    from crossscalepatchmatch_tpu_torch.parallel.tiled import (
        run_batch_sharded, run_sequence_batch)

    mesh1 = initialize_multihost()
    try:
        print(f"world of one: mesh {tuple(mesh1.shape)}, transport "
              f"{_comm.transport(mesh1)}")
        streams = [make_pair(h=48, w=64, max_dis=12, seed=s) for s in (3, 4)]
        frames = [(np.stack([p.left for p in streams]),
                   np.stack([p.right for p in streams]))] * 3
        scfg = CSPMConfig(**base)
        reset_counts()
        batched = [{k: v.cpu().numpy() for k, v in out.items()}
                   for out in run_sequence_batch(frames, scfg, mesh1, seed=7)]
        torch.cuda.synchronize()
        paths["sequence batch"] = read_counts()
        check_counts("sequence batch", paths["sequence batch"], GRD_PATH)
        same = True
        for b, p in enumerate(streams):
            solo = list(run_sequence_np([(p.left, p.right)] * 3, scfg,
                                        seed=7 + 1000003 * b))
            same &= all(np.array_equal(batched[t][k][b], solo[t][k])
                        for t in range(3) for k in ("dis", "abc"))
        fcfg_s = CSPMConfig(precompute_volume=False, **base)
        ls = np.stack([p.left for p in streams])
        rs = np.stack([p.right for p in streams])
        reset_counts()
        fly_dis = run_batch_sharded(ls, rs, [3, 5], fcfg_s, mesh1)
        torch.cuda.synchronize()
        paths["no-volume data mesh"] = read_counts()
        check_counts("no-volume data mesh", paths["no-volume data mesh"],
                     ("k5", "k3_fly"))
        same_fly = all(torch.equal(fly_dis[b], run_pair(
            ls[b], rs[b], seed, fcfg_s)["dis"])
            for b, seed in enumerate((3, 5)))
        print(f"world of one: run_sequence_batch (2 streams x 3 frames) == "
              f"run_sequence_np per stream {same}; no-volume data-only mesh "
              f"== run_pair per pair {same_fly}")
        if not (same and same_fly):
            raise RuntimeError("world of one: a batched run differs from "
                               "its per-pair run")
    finally:
        dist.destroy_process_group()

    # -- 11. accuracy parity against the native oracle ------------------------
    phase11(dev, card, paths, check_counts)

    # -- 12. the benchmark's readme_demo cell ---------------------------------
    import bench_torch

    cell = bench_torch.CELLS[0]
    reset_counts()
    res = bench_torch.run_cell(cell, dev, pairs=5)
    torch.cuda.synchronize()
    paths["bench readme_demo"] = read_counts()
    check_counts("bench readme_demo", paths["bench readme_demo"],
                 GRD_PATH)
    line = json.loads(json.dumps(bench_torch.result_line(
        {cell.name: res}, bench_torch.describe_device(dev))))
    keys = ("metric", "value", "unit", "vs_baseline")
    if (any(k not in line for k in keys)
            or line["metric"] != "stereo_pairs_per_second_per_chip"
            or not line["value"] > 0
            or line["cells"][cell.name]["bad_pixel"]["max"] > cell.gate):
        raise RuntimeError(f"phase 12: bad result line {line}")
    q = res["ms_pair"]
    print(f"phase 12: bench {cell.name} {q['median']:.1f} ms/pair "
          f"(quartiles {q['q1']:.1f} / {q['q3']:.1f}, 5 pairs), "
          f"{line['value']:.3f} pairs/s, vs_baseline "
          f"{line['vs_baseline']:.1f}, bad-pixel @1px max "
          f"{res['bad_pixel']['max']:.4f}, idle share "
          f"{res['profile']['idle_share']:.3f}")
    # the cell with post-processing at the bench shape: WMF on its path
    cell = next(c for c in bench_torch.CELLS if c.name == "cen_cs_pp")
    reset_counts()
    res = bench_torch.run_cell(cell, dev, pairs=3)
    torch.cuda.synchronize()
    paths["bench cen_cs_pp"] = read_counts()
    check_counts("bench cen_cs_pp", paths["bench cen_cs_pp"],
                 (*CEN_CS_PATH, "wmf"))
    by_name = {p["name"]: p for p in res["profile"]["phases"]}
    pp_phase, vb = by_name["postprocess"], by_name["volume_build"]
    print(f"phase 12: bench {cell.name} {res['ms_pair']['median']:.1f} "
          f"ms/pair (3 pairs), bad-pixel @1px max "
          f"{res['bad_pixel']['max']:.4f}; profiled pair's postprocess "
          f"{pp_phase['device_ms']:.1f} device ms, {pp_phase['launches']} "
          f"launches; volume_build {vb['host_ms']:.1f} host ms, "
          f"{vb['device_ms']:.2f} device ms, {vb['launches']} launches")

    # -- 13. the scaling bench under torchrun ---------------------------------
    import bench_scaling_torch

    # 13.1 the band forms of K1 and K2 against their plain band forms on
    # the tiles the scaling bench gives them at its default shape: the
    # whole image on the (1, 1, 1) mesh and both tiles of the (1, 2, 1)
    # mesh, rows extended by the half window (zeros past the image),
    # columns not; the same f32 inputs on the card for both sides
    t0 = time.perf_counter()
    sargs = bench_scaling_torch.parser().parse_args([])
    scfg = bench_scaling_torch.workload_cfg(sargs)
    sh, sw = sargs.h, sargs.w
    s_hw, s_md, s_gamma = scfg.half_wnd, scfg.max_dis, scfg.wgt_gamma
    s_stride = max(scfg.prescreen_stride, 1)
    spair = make_pair(h=sh, w=sw, max_dis=sargs.max_dis, seed=0)
    svd = build_volume_data(torch.as_tensor(spair.left, device=dev),
                            torch.as_tensor(spair.right, device=dev), scfg)
    s_imgs, s_vols, s_mc = (svd.imgs[0], svd.vols[0].float(),
                            svd.max_costs[0])
    del svd
    scaling_tiles = (("(1, 1, 1) whole image", 0, sh),
                     ("(1, 2, 1) tile ty=0", 0, sh // 2),
                     ("(1, 2, 1) tile ty=1", sh // 2, sh // 2))
    for tname, trow0, ths_s in scaling_tiles:
        t_imgs = _ext_from_full(s_imgs, trow0, ths_s, s_hw, 1).contiguous()
        t_vols = _ext_from_full(s_vols, trow0, ths_s, s_hw, 1).contiguous()
        t_bounds = (-trow0, sh - trow0, 0, sw)
        t_prep = window_cost.prepare_volumes(
            t_imgs, t_vols, s_mc, half_wnd=s_hw, max_dis=s_md, gamma=s_gamma,
            rows_extended=True, cols_extended=False)
        t_band = t_prep.plain_band(t_bounds)
        for k in (1, 2):
            full = test_planes(spair, s_md, k, gen, dev)[
                :, :, trow0:trow0 + ths_s]
            abc = torch.cat([full[..., :2], (full[..., 2] + full[..., 1]
                                             * trow0)[..., None]],
                            -1).contiguous()
            got = window_cost.window_cost_prepared(
                t_prep, abc, half_wnd=s_hw, max_dis=s_md, bounds=t_bounds)
            want = torch.stack([plane_cost.window_plane_cost(
                t_imgs[v], t_vols[v], s_mc[v], abc[v], half_wnd=s_hw,
                max_dis=s_md, gamma=s_gamma, **t_band) for v in range(2)])
            rec["k1_band"]["max_abs_err"] = max(
                rec["k1_band"]["max_abs_err"], check_bit_equal(
                    f"phase 13.1: K1 band form K={k}, {tname} of "
                    f"{sh}x{sw}", got, want))
            del full, abc, got, want
        got_b, got_w = quadrant_build.quadrant_volumes_prepared(
            t_prep, half_wnd=s_hw, gamma=s_gamma, stride=s_stride,
            bounds=t_bounds)
        rv, cv = cross_scale_cost.valid_vectors(
            t_prep.rect(t_bounds), t_prep.array_hw, dev)
        parts = [prescreen_volume.build_quadrant_volumes(
            t_imgs[v], t_vols[v], rv[:, None] & cv[None, :], half_wnd=s_hw,
            gamma=s_gamma, stride=s_stride) for v in range(2)]
        for i, (qname, got_q) in enumerate((("bq", got_b), ("wq", got_w))):
            want_q = torch.stack([p[i] for p in parts])[
                :, :, s_hw:s_hw + ths_s]
            rec["k2_band"]["max_abs_err"] = max(
                rec["k2_band"]["max_abs_err"], check_bit_equal(
                    f"phase 13.1: K2 band form {qname}, {tname} of "
                    f"{sh}x{sw}", got_q, want_q))
        del t_prep, t_imgs, t_vols, got_b, got_w, parts, want_q
    for key in ("k1_band", "k2_band"):
        rec[key]["scaling_tiles"] = [t[0] for t in scaling_tiles]
    del s_imgs, s_vols, s_mc
    torch.cuda.empty_cache()
    print(f"phase 13.1: K1 and K2 band forms bit-equal on the scaling "
          f"bench's tiles, {time.perf_counter() - t0:.1f} s")

    for nproc, backend, meshes in SCALING_RUNS:
        t0 = time.perf_counter()
        rows = run_scaling_bench(nproc)
        took = time.perf_counter() - t0
        if [row["mesh"] for row in rows] != meshes:
            raise RuntimeError(f"scaling bench, {nproc} ranks: meshes "
                               f"{[row['mesh'] for row in rows]}")
        for n, row in zip((1, nproc), rows):
            name = f"sharded scaling {row['mesh']} ({nproc} ranks)"
            paths[name] = row["launches"]
            check_counts(name, row["launches"], GRD_PATH)
            eff = row["value"] / (rows[0]["value"] * n)
            if (row["platform"] != "gpu" or row["world"] != nproc
                    or not row["transport"].startswith(backend)
                    or (row["note"] == "real devices") != (backend == "nccl")
                    or row["efficiency_vs_1dev"] != eff
                    or row["reps"] != SCALING_REPS
                    or row["bad_pixel"]["max"] > BAD_PIXEL_MAX):
                raise RuntimeError(f"scaling bench: bad line {row}")
            print(json.dumps(row))
        print(f"phase 13: scaling bench, {nproc} rank(s): {took:.1f} s with "
              f"the processes' start")

    wc = "crossscalepatchmatch_tpu/ops/pallas/window_cost.py"
    wmed = "crossscalepatchmatch_tpu/models/postprocess.py:151"
    grdv_src = "crossscalepatchmatch_tpu/ops/grad_cost.py:62"
    qrank_src = "crossscalepatchmatch_tpu/ops/prescreen_volume.py:114"
    cenv_src = "crossscalepatchmatch_tpu/ops/census.py:24"

    def entry(name, key, source, replaces, band=False):
        """A kernel's record; a band form's launches are those of the
        sharded paths (its tiles), the whole-image form's the others'."""
        counter = key[:-len("_band")] if band else key
        by_path = {p: c[counter] for p, c in paths.items()
                   if c[counter] and p.startswith("sharded ") == band}
        return dict(name=name, route="cuda", source=f"{pkg}/csrc/{source}",
                    replaces=replaces, launches=sum(by_path.values()),
                    library_ms=None, launches_by_path=by_path, **rec[key])

    kernels = [
        entry("window_cost (K1)", "k1", "cross_scale_cost.cu", f"{wc}:138"),
        entry("quadrant_build (K2)", "k2", "quadrant_build.cu",
              "crossscalepatchmatch_tpu/ops/pallas/quadrant_build.py:45"),
        entry("strided window, volume form (K3)", "k3_volume",
              "cross_scale_cost.cu", f"{wc}:331"),
        entry("strided window, fly form (K3)", "k3_fly", "fly_cost.cu",
              f"{wc}:331"),
        entry("cross_scale_cost (K4)", "k4", "cross_scale_cost.cu",
              f"{wc}:138"),
        entry("fly cost, cost lerp (K5)", "k5", "fly_cost.cu", f"{wc}:74"),
        entry("fly cost, image lerp (K6)", "k6", "fly_cost.cu", f"{wc}:50"),
        entry("fly cost, Lab weights (K7)", "k7", "fly_cost.cu", f"{wc}:316"),
        entry("window_cost band form (K1)", "k1_band", "cross_scale_cost.cu",
              f"{wc}:138", band=True),
        entry("strided window band form, volume (K3)", "k3_volume_band",
              "cross_scale_cost.cu", f"{wc}:331", band=True),
        entry("cross_scale_cost band form (K4)", "k4_band",
              "cross_scale_cost.cu", f"{wc}:138", band=True),
        entry("quadrant_build band form (K2)", "k2_band", "quadrant_build.cu",
              "crossscalepatchmatch_tpu/ops/pallas/quadrant_build.py:45",
              band=True),
        # not a TPU kernel: the JAX engine's device loop (lax.fori_loop over
        # the window offsets, :151, inside the 8-step bisection, :185)
        entry("weighted_median (WMF)", "wmf", "weighted_median.cu", wmed),
        entry("weighted_median band form (WMF)", "wmf_band",
              "weighted_median.cu", wmed, band=True),
        # not TPU kernels: stages XLA fuses under run_pair's jit (the GRD
        # volume's per-slice loop, the ranking's tent contractions)
        entry("grd_volume (GRDV)", "grdv", "grd_volume.cu", grdv_src),
        entry("quadrant_rank (QRANK)", "qrank", "quadrant_rank.cu",
              qrank_src),
        entry("grd_volume band form (GRDV)", "grdv_band", "grd_volume.cu",
              grdv_src, band=True),
        entry("quadrant_rank band form (QRANK)", "qrank_band",
              "quadrant_rank.cu", qrank_src, band=True),
        # not a TPU kernel: the census transform and the census volume's
        # per-slice loop (:77), which XLA fuses under run_pair's jit; one
        # call a level, two launches (codes, volumes)
        entry("census_volume (CENV)", "cenv", "census_volume.cu", cenv_src),
        # not a TPU kernel: the JAX engine's device loop over the window
        # offsets (lax.fori_loop), which XLA fuses under run_pair's jit
        entry("bilateral_volume (BFV)", "bfv", "bilateral_volume.cu",
              "crossscalepatchmatch_tpu/ops/filters.py:161"),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          "card check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        sys.exit(shard_worker(sys.argv[2:]))
    sys.exit(main())
