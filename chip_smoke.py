"""Smoke run of the PyTorch port (crossscalepatchmatch_tpu_torch) on one
NVIDIA GPU: every main path, every kernel against its plain version at the
paths' shapes, and the kernels' record, from one run.  It holds no check
of its own: it drives the GPU tier (tests/test_torch_kernels_gpu.py) and
tools/torch_kernel_ab.py.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels (timed);
  3. each main path of the GPU tier's MAIN_PATHS (README_DEMO, CEN_CS_PP,
     README_DEMO and KITTI without a volume, KITTI without a volume in
     image-lerp mode (K6), KITTI, the BOX, GF and BF aggregators) on its
     scene, seed 0, three runs: the `dis` digest, ms/pair, peak device
     memory and the launches of a pair (every launch counter reset just
     before the first run);
  4. the GPU tier's tests at the paths' shapes (SHAPE_TESTS, 98 of them:
     the bench and KITTI scenes, the bench tile's band forms, the main
     paths, the warm frame, the sharded paths, a call's launches): each
     kernel's wrapper against its plain version there, each path's
     launches a pair exactly, no plain version on a path, bad-pixel gates
     and bit-identical reruns;
  5. each case of torch_kernel_ab's CASES: the kernel's ms (CUDA events in
     turns), its bound (utils.roofline), its device time where the case
     reads one, and its plain version's ms, timed once.

The line before the last is the kernels' JSON record (per kernel key: its
cases' ms, bound_ms, device_ms and plain_ms, and its launches a pair by
path from phase 3), the last line {"ok": true, "device": ...}.
"""

import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GPU_TIER = os.path.join(REPO, "tests", "test_torch_kernels_gpu.py")
# pytest -k: the GPU tier's tests at the paths' shapes
SHAPE_TESTS = ("bench or kitti or readme_demo or coarse_level or 375x "
               "or 375- or main_path or warm_frame or launches_its_kernels "
               "or sharded")


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import pytest
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    ab = load("torch_kernel_ab", os.path.join(REPO, "tools",
                                              "torch_kernel_ab.py"))
    tier = load("test_torch_kernels_gpu_paths", GPU_TIER)
    dev = torch.device("cuda:0")
    print(f"{ab.card_name()} | torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    build_s = ab.build_kernels()

    # -- 3. the main paths ---------------------------------------------------
    ctx = ab.Ctx(dev)
    times, launches = {}, {}
    for name, (cfg, shape, *_) in tier.MAIN_PATHS.items():
        scene = ctx.bench if shape["w"] == ab.SHAPE["w"] else ctx.kitti
        _, launches[name] = ab.path_run(dev, name, cfg, scene, times)

    # -- 4. the GPU tier's checks at the paths' shapes -----------------------
    t0 = time.perf_counter()
    rc = pytest.main([GPU_TIER, "-m", "gpu", "--noconftest", "-q",
                      "-p", "no:cacheprovider", "-k", SHAPE_TESTS])
    print(f"GPU tier at the paths' shapes: exit {int(rc)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 0:
        return 1

    # -- 5. the kernels' times, bounds and plain versions --------------------
    recs = ab.time_cases(ctx, reps=5, plain=True)
    kernels = [dict(kernel=key, cases=cases,
                    launches_by_path={p: c[key] for p, c in launches.items()
                                      if c.get(key)})
               for key, cases in recs.items()]
    print(f"done {time.perf_counter() - t_start:.1f} s after the card "
          f"check (build {build_s:.1f} s)")
    print(json.dumps({"kernels": kernels, "paths_ms": times}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
