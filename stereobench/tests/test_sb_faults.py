"""The check fails a run whose timed path is broken underneath: a run of a
tiny cell on the CPU (the look for a card skipped) with a fault planted in
the program, and the control (the plain reference in a lower precision
put in the program's place) read against the configuration's limits."""

import time

import pytest
import torch

from crossscalepatchmatch_tpu_torch.models import patchmatch, pipeline
from stereobench import check, run, workload

CELLS = ["kitti2015_grd_pp.pairs", "mb2003_cen_cs_pp.pairs",
         "kitti2015_grd_pp.video", "kitti2015_grd_pp_novol.pairs"]


def _alter(fn, change):
    def wrapped(*args, **kw):
        out = dict(fn(*args, **kw))
        change(out)
        return out
    return wrapped


def _right_view_left_out(out):
    for k in ("dis", "cost", "valid", "abc"):
        out[k] = torch.stack([out[k][0], out[k][0]])


def _one_disparity_altered(out):
    out["dis"] = out["dis"].clone()
    out["dis"][0, 5, 7] += 1


def _one_cost_altered(out):
    out["cost"] = out["cost"].clone()
    out["cost"][1, 9, 3] *= 1.01


FAULTS = {"right_view_left_out": _right_view_left_out,
          "one_disparity_altered": _one_disparity_altered,
          "one_cost_altered": _one_cost_altered}


def _run(root, name):
    cell = workload.load_cell(name, root=root)
    return run.run_cell(cell, 2 ** 32 + 9, 0.5, False, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state_fails(tiny_root, name, monkeypatch):
    monkeypatch.setattr(patchmatch, "iteration_step",
                        lambda state, *a, **k: state)
    res = _run(tiny_root, name)
    assert res["correct"] is False and res["failed"] >= 1
    # the search's number fails by itself
    bad = res["checks"]["bad_px_pct"]
    assert bad["value"] > bad["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_altered_output_fails(tiny_root, name, fault, monkeypatch):
    for entry in ("run_pair", "run_pair_warm"):
        monkeypatch.setattr(pipeline, entry, _alter(
            getattr(pipeline, entry), FAULTS[fault]))
    res = _run(tiny_root, name)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_passes_and_control_fails(tiny_root, name):
    cell = workload.load_cell(name, root=tiny_root)
    loop = workload.Loop(cell, 12345, "cpu")
    loop.step()
    win = loop.run(pairs=4)
    bad = win.bad_px(loop.pool)
    window = {"bad_px_pct": sum(bad) / len(bad)}
    controls = cell.reference.CONTROLS
    rows = check.judge(win.kept, loop.pool.frame, cell.config["engine"],
                       cell.reference, controls)
    limits = cell.config["limits"]
    assert check.verdict(rows["program"], window, limits)[0]
    assert len(controls) == 2
    for name in controls:
        assert not check.verdict(rows[name], window, limits)[0], name
