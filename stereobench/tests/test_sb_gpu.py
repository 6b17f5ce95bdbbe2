"""On the card (skipped here): each cell at its own size runs with correct
true, and the bf16 control fails its limits."""

import time

import pytest
import torch

from stereobench import check, run, workload

CELLS = ["kitti2015_grd_pp.pairs", "mb2003_cen_cs_pp.pairs",
         "kitti2015_grd_pp.video", "kitti2015_grd_pp_novol.pairs"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_and_control_fails(card, name):
    cell = workload.load_cell(name)
    res = run.run_cell(cell, 2 ** 31 + 17, 2.0, False, "cuda",
                       time.perf_counter())
    assert res["correct"], res["checks"]
    loop = workload.Loop(cell, 2 ** 31 + 18, "cuda")
    loop.step()
    win = loop.run(pairs=cell.traffic["trace_pairs"])
    bad = win.bad_px(loop.pool)
    window = {"bad_px_pct": sum(bad) / len(bad)}
    rows = check.judge(win.kept, loop.pool.frame, cell.config["engine"],
                       cell.reference,
                       {"bf16": cell.reference.CONTROLS["bf16"]})
    assert check.verdict(rows["program"], window, cell.config["limits"])[0]
    assert not check.verdict(rows["bf16"], window,
                             cell.config["limits"])[0]
