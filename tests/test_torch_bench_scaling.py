"""bench_scaling_torch.py (the port's scaling bench) on the CPU: the measured
mode under torchrun with two gloo ranks at 32x48 (wnd 7) and its gates,
the refusal without a card, and --project's arithmetic against JAX
bench_scaling.project's.

The measured rows must carry bench_scaling.py's keys and
efficiency_vs_1dev = value / (value at n = 1 * n) exactly; on the CPU the
path runs the kernels' plain versions and no kernel.  A tiny scene's
bad-pixel sits near 0.02-0.03 @1px, over the bench's per-call limit of
0.01 (BAD_PIXEL_MAX, met by the 384x448 bench scene on the card), and
its 1536 pixels move the mean by more than the full mesh's allowed gap
to n = 1 (GAP_MAX, 0.005) between two calls' draws.  So the two-rank runs
that must succeed go through a launcher that sets both limits for the
tiny scene (TINY_SCENE_MAX, TINY_SCENE_GAP), the in-process one
monkeypatches the per-call limit, and one two-rank run keeps the bench's
limits and must miss.  The projection must give JAX's rows
exactly (the same rounding) on JAX's own inputs, t1 1.05 s/pair and its
TPU v5e link figures, which appear here only as the reference's inputs.
"""

import argparse
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_scaling
import bench_scaling_torch as bst
from crossscalepatchmatch_tpu_torch.config import CostMethod, CSPMConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--h", "32", "--w", "48", "--max_dis", "12",
         "--wnd", "7", "--reps", "2"]
TINY_SCENE_MAX = 0.05       # the per-call limit for the 32x48 scene
TINY_SCENE_GAP = 0.025      # its full mesh's allowed gap to n = 1
# bench_scaling_torch.main under torchrun with the tiny scene's limits
LAUNCHER = '''import sys
sys.path.insert(0, {repo!r})
import bench_scaling_torch
bench_scaling_torch.BAD_PIXEL_MAX = {limit!r}
bench_scaling_torch.GAP_MAX = {gap!r}
sys.exit(bench_scaling_torch.main())
'''
JAX_KEYS = {"metric", "mesh", "value", "efficiency_vs_1dev", "platform",
            "note"}
# JAX bench_scaling.project's inputs: its default t1 and its TPU v5e link
# figures (bench_scaling.py:81-82), bytes/s
JAX_T1, JAX_ICI, JAX_DCN = 1.05, 50e9, 25e9 / 8


def torchrun(args, script="bench_scaling_torch.py", n=2):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", str(script), *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def tiny_scene_launcher(tmp_path):
    path = tmp_path / "launch_tiny.py"
    path.write_text(LAUNCHER.format(repo=REPO, limit=TINY_SCENE_MAX,
                                    gap=TINY_SCENE_GAP))
    return path


@pytest.mark.parametrize("batch,meshes", [(0, ["ty=1", "ty=2"]),
                                          (2, ["data=1", "data=2"])])
def test_measured_mode_under_torchrun(batch, meshes, tmp_path):
    """Two gloo ranks: one JSON line per mesh (n = 1 over rank 0, then the
    world), JAX's keys plus the device, transport, reps, quartiles,
    bad-pixel, staged bytes and launches; the efficiency exact."""
    res = torchrun(SMALL + ["--batch", str(batch)],
                   tiny_scene_launcher(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    rows = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [r["mesh"] for r in rows] == meshes
    base = rows[0]["value"]
    for n, row in zip((1, 2), rows):
        assert JAX_KEYS <= set(row)
        assert row["metric"] == "sharded_pairs_per_second"
        assert row["platform"] == "cpu" and "mechanism only" in row["note"]
        assert row["device"]["kind"] == "cpu" and row["world"] == 2
        assert row["transport"] == "gloo (host staged)"
        assert row["efficiency_vs_1dev"] == row["value"] / (base * n)
        q = row["s_per_call"]
        assert row["reps"] == 2 and 0 < q["q1"] <= q["median"] <= q["q3"]
        assert row["value"] == max(batch, 1) / q["median"]
        bad = row["bad_pixel"]
        assert 0 <= bad["mean"] <= bad["max"] <= bad["gate"]
        assert bad["gate"] == TINY_SCENE_MAX
        assert bad["gap_max"] == TINY_SCENE_GAP
        if n > 1:
            assert abs(bad["mean"] - rows[0]["bad_pixel"]["mean"]) <= (
                TINY_SCENE_GAP)
        assert row["host_bytes_per_call"] == 0        # CPU tensors
        launches = row["launches"]
        assert launches["k1_plain"] > 0 and launches["k2_plain"] > 0
        assert not any(v for k, v in launches.items()
                       if not k.endswith("_plain"))
    # each rank of a "ty" mesh builds its band of the pair: twice the
    # plain K2 builds of one rank's run; a "data" mesh splits the pairs
    assert rows[1]["launches"]["k2_plain"] == (
        (1 if batch else 2) * rows[0]["launches"]["k2_plain"])


def test_missed_gate_under_torchrun_prints_no_line():
    """Two gloo ranks at the bench's own per-call limit (0.01), which the
    32x48 scene misses: GateMissed on both ranks, a non-zero exit and no
    result line, with no rank left waiting."""
    assert bst.BAD_PIXEL_MAX == 0.01 and bst.GAP_MAX == 0.005
    res = torchrun(SMALL)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "GateMissed" in res.stderr and "timed call 1" in res.stderr


def test_missed_gate_exits_with_no_result_line(monkeypatch, capsys):
    """A timed call over the gate raises GateMissed (exit code 1 as a
    script) before any line is printed."""
    monkeypatch.setattr(bst, "bad_pixel_rate", lambda *a, **k: 0.5)
    with pytest.raises(bst.GateMissed, match="timed call 1"):
        bst.main(SMALL)
    assert capsys.readouterr().out == ""
    assert not torch.distributed.is_initialized()


def test_no_card_exits_nonzero(monkeypatch, capsys):
    """Without a card and without --device cpu: exit 1, nothing run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bst.main(["--reps", "1"]) == 1
    assert bst.main(["--project", "--host_link_gbs", "3"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not torch.distributed.is_initialized()


def jax_project(h, w, max_dis, wnd, t1):
    """JAX bench_scaling.project's printed record on these inputs."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_scaling.project(argparse.Namespace(h=h, w=w, max_dis=max_dis,
                                                 wnd=wnd, t1=t1))
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("h,w,max_dis,wnd,t1", [
    (384, 448, 60, 35, JAX_T1), (375, 450, 60, 35, 0.1154),
    (375, 1242, 128, 35, 0.569), (256, 832, 96, 19, 0.257)])
def test_projection_equals_jax_project(h, w, max_dis, wnd, t1):
    """project_rows on JAX's link figures gives JAX's rows, key for key;
    without a figure for a link its rows are left out and named."""
    cfg = CSPMConfig(max_dis=max_dis, dis_scale=4, wnd_size=wnd,
                     cost_method=CostMethod.GRD)
    want = jax_project(h, w, max_dis, wnd, t1)["rows"]
    rows, left_out = bst.project_rows(h, w, cfg, t1, JAX_ICI, JAX_DCN)
    assert rows == want and left_out == []
    rows, left_out = bst.project_rows(h, w, cfg, t1, None, JAX_DCN)
    assert rows == [r for r in want if "across" in r["mesh"]]
    assert left_out == [r["mesh"] for r in want if "across" not in r["mesh"]]
    rows, left_out = bst.project_rows(h, w, cfg, t1, JAX_ICI, None)
    assert rows == [r for r in want if "across" not in r["mesh"]]
    assert left_out == ["(ty=16 across hosts)", "(ty=32 across hosts)"]


def test_project_mode(monkeypatch, capsys):
    """--project on this host (no card-to-card link to measure): refused
    (exit 2) without --host_link_gbs; with it, the rows across hosts on a
    given t1, and on a t1 measured by the n = 1 run."""
    assert bst.main(["--project", "--device", "cpu"]) == 2
    assert "no link bandwidth" in capsys.readouterr().err
    assert bst.main(["--project", "--device", "cpu", "--t1", str(JAX_T1),
                     "--host_link_gbs", str(JAX_DCN / 1e9)]) == 0
    line = json.loads(capsys.readouterr().out)
    want = jax_project(384, 448, 60, 35, JAX_T1)
    assert {k: line[k] for k in ("metric", "workload", "target")} == {
        k: want[k] for k in ("metric", "workload", "target")}
    assert line["rows"] == [r for r in want["rows"] if "across" in r["mesh"]]
    assert len(line["left_out"]) == 4 and line["t1_source"] == "given (--t1)"
    assert "not measured" in line["model"]
    monkeypatch.setattr(bst, "BAD_PIXEL_MAX", TINY_SCENE_MAX)
    assert bst.main(["--project", "--host_link_gbs", "3"] + SMALL) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["t1_source"].startswith("measured: mesh ty=1")
    assert [r["mesh"] for r in line["rows"]] == [
        "(ty=16 across hosts)", "(ty=32 across hosts)"]
    assert not torch.distributed.is_initialized()
