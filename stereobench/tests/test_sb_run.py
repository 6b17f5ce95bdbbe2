"""A run of a tiny cell on the CPU (the look for a card skipped): its
result line, the exit without a card, and nothing of JAX loaded."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from stereobench import run, workload

from .conftest import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
END_TO_END = {"pairs_per_s", "pair_ms_p95", "peak_mem_mib", "bad_px_pct",
              "setup_s"}


@pytest.mark.parametrize("name", ["kitti2015_grd_pp.pairs",
                                  "mb2003_cen_cs_pp.pairs",
                                  "kitti2015_grd_pp.video",
                                  "kitti2015_grd_pp_novol.pairs"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny_root, name, traced):
    cell = workload.load_cell(name, root=tiny_root)
    res = run.run_cell(cell, 2 ** 33 + 5, 1.0, traced, "cpu",
                       time.perf_counter())
    line = json.loads(json.dumps(run.finite(res)))
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= (2 if traced else 1)
    assert set(line["checks"]) == {"cost_gap", "dis_diff_px",
                                   "valid_diff_px", "bad_px_pct"}
    if traced:
        # no device ops on the CPU: no per-layer metric is reported
        assert line["metrics"] == {}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == END_TO_END
        assert all(line["metrics"][k]["value"] > 0
                   for k in ("pairs_per_s", "pair_ms_p95", "setup_s"))


def test_same_seed_same_inputs(tiny_root):
    cell = workload.load_cell("kitti2015_grd_pp.pairs", root=tiny_root)
    a = workload.Loop(cell, 77, "cpu")
    b = workload.Loop(cell, 77, "cpu")
    c = workload.Loop(cell, 78, "cpu")
    for i in range(5):
        assert all(bool((x == y).all())
                   for x, y in zip(a.pool.frame(i), b.pool.frame(i)))
    assert any(bool((x != y).any()) for i in range(4)
               for x, y in zip(a.pool.frame(i), c.pool.frame(i)))
    assert all(bool((x != y).any())
               for x, y in zip(a.pool.frame(0), a.pool.frame(1)))


def test_frames_pan_along_the_scene(tiny_root):
    """Frame k + 1 of a scene is frame k moved pan_px columns along it, its
    ground truth with it; a pixel whose match lies left of the frame's
    right view is not scored."""
    cell = workload.load_cell("kitti2015_grd_pp.video", root=tiny_root)
    cell.traffic["noise_sigma"] = 0.0
    pool = workload.Pool(cell.config, cell.traffic, 5, "cpu")
    p = pool.pan
    assert p > 0 and pool.fps >= 2
    xs = torch.arange(pool.w)[None, :]
    for k in range(pool.fps - 1):
        for a, b in zip(pool.frame(k), pool.frame(k + 1)):
            assert bool((a[:, p:] == b[:, :-p]).all())
        (da, va), (db, vb) = pool.truth(k), pool.truth(k + 1)
        assert bool((da[:, p:] == db[:, :-p]).all())
        assert not bool((vb & (torch.round(xs - db) < 0)).any())
        assert bool((vb[:, :-p] <= va[:, p:]).all())


def test_unpanned_truth_is_the_scenes(tiny_root):
    cell = workload.load_cell("mb2003_cen_cs_pp.pairs", root=tiny_root)
    scenes = workload.make_scenes(cell.config, cell.traffic)
    pool = workload.Pool(cell.config, cell.traffic, 6, "cpu", scenes)
    for i in range(len(scenes)):
        sc = scenes[pool.scene_of(i)]
        d, valid = pool.truth(i)
        assert bool((d == torch.as_tensor(sc.disp_left).double()).all())
        assert bool((valid == torch.as_tensor(sc.valid_left)).all())


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "stereobench.run", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_no_card_exits_without_a_result():
    p = _run(["--workload", "kitti2015_grd_pp.pairs", "--seed", "1",
              "--seconds", "1", "--trace", "0"], REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_exits_without_a_result(tmp_path):
    """A directory with only BENCHMARK.json and stereobench/ (no program)."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "stereobench"),
                    tmp_path / "stereobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "kitti2015_grd_pp.pairs", "--seed", "1",
              "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax(tiny_root):
    """In a fresh process, a tiny run leaves no module of JAX or of the JAX
    package loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from stereobench import run, workload\n"
        "cell = workload.load_cell('mb2003_cen_cs_pp.pairs', root=%r)\n"
        "run.run_cell(cell, 3, 0.5, False, 'cpu', 0.0)\n"
        "print(run.forbidden_modules())\n" % (REPO, tiny_root))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
