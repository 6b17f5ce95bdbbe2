"""bench_torch.py (the port's benchmark) and the profiled pair it shares
with tools/torch_profile_pair.py (utils.profiling), on the CPU at 32x48
with small windows (--device cpu).

The profiled pair must give run_pair's (run_pair_warm's) outputs bit for
bit: it is run_pair recorded by phase (utils/spans), and nothing but the
recording may differ.  The bench's cell table must be PERF.md section 4's, in order,
and every cell's config must pass the card's entry checks at its size.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import bench_torch
from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI, README_DEMO
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                            run_pair_warm)
from crossscalepatchmatch_tpu_torch.support import check_supported
from crossscalepatchmatch_tpu_torch.utils import profiling, spans

# One intra-op thread: the suite runs several pytest-xdist workers on a
# few cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_dis=12, dis_scale=16, wnd_size=7)
GRD = dataclasses.replace(README_DEMO, **SMALL)


def tiny_cell(name="readme_demo", cfg=GRD, **kw):
    return bench_torch.Cell(name, "small", cfg, 32, 48, 12,
                            **{"pairs": 1, "gate": 1.0, **kw})


@pytest.mark.parametrize("case", ["grd", "cen_cs_pp", "no_volume", "warm"])
def test_profiled_pair_equals_run_pair(case):
    cfg = {"grd": GRD,
           "cen_cs_pp": dataclasses.replace(CEN_CS_PP, scale_num=3,
                                            **SMALL),
           "no_volume": dataclasses.replace(KITTI, precompute_volume=False,
                                            **SMALL),
           "warm": GRD}[case]
    pair = make_pair(h=32, w=48, max_dis=12, seed=3)
    prior = None
    if case == "warm":
        prior = run_pair(pair.left, pair.right, 0, cfg, device="cpu")["abc"]
        want = run_pair_warm(pair.left, pair.right, 5, prior, cfg, 1,
                             device="cpu")
    else:
        want = run_pair(pair.left, pair.right, 5, cfg, device="cpu")
    got, summary, prof = profiling.profile_pair(
        pair.left, pair.right, 5, cfg, device="cpu", prior_abc=prior)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    names = [p["name"] for p in summary["phases"]]
    first = "volume_build" if cfg.precompute_volume else "fly_data"
    second = ["quadrant_build_K2"] if cfg.precompute_volume else []
    middle = (["warm_phase"] if case == "warm"
              else ["rank_phase", "exact_phase"])
    assert names == ([first] + second + middle + ["plane_to_disp"]
                     + (["postprocess"] if cfg.use_pp else []))
    # no device: no profiler, every device reading not measured
    assert prof is None
    assert summary["device_ms"] is None and summary["idle_share"] is None
    assert all(p["device_ms"] is None for p in summary["phases"])
    assert summary["wall_ms"] > 0


def _span(name, start_us, end_us, parent=-1, **attrs):
    sp = spans.Span(name, attrs)
    sp.start_ns, sp.end_ns, sp.parent = start_us * 1000, end_us * 1000, parent
    sp.seq = 0
    return sp


def test_summary_of_device_events():
    """The device readings of a profile (times in us): busy union, idle
    share, kernels by family, each op put down to the phase it was
    launched in, idle gaps named by the span the host was in."""
    rec = [_span("pair", 0, 200, entry="run_pair"),
           _span("volume_build", 0, 100, 0),
           _span("exact_phase", 100, 200, 0)]
    us = 1000
    ops = [("void cross_scale_kernel<float>(...)", 10, 30, 5),
           ("void quadrant_build_kernel<float>(...)", 20, 40, 8),
           ("elementwise_kernel", 150, 160, 148)]
    ops = [(a * us, b * us, n, t * us) for n, a, b, t in ops]
    s = profiling.summarize(rec, ops, 0.2, GRD)
    assert s["busy_ms"] == pytest.approx(0.04)
    assert s["device_ms"] == pytest.approx(0.05)
    assert s["idle_share"] == pytest.approx(0.8)
    assert s["launches"] == 3 and s["joined"] == 1.0
    assert s["kernels"] == {"K1": {"ms": pytest.approx(0.02), "launches": 1},
                            "K2": {"ms": pytest.approx(0.02), "launches": 1},
                            "other": {"ms": pytest.approx(0.01),
                                      "launches": 1}}
    assert [(p["name"], p["launches"]) for p in s["phases"]] == [
        ("volume_build", 2), ("exact_phase", 1)]
    assert s["phases"][0]["device_ms"] == pytest.approx(0.03)
    # each gap on the host's clock, ending at the launch of the op that
    # ends it: 0-5 us and 38-148 us, both mostly in the volume build
    gaps = [(g["span"], g["ms"], g["at_ms"]) for g in s["idle_gaps"]]
    assert gaps == [("volume_build", pytest.approx(0.11),
                     pytest.approx(0.038)),
                    ("volume_build", pytest.approx(0.005), 0.0)]
    assert s["idle_by_phase"] == {"volume_build": pytest.approx(0.115)}
    assert s["spans"]["volume_build"]["device_ms"] == pytest.approx(0.04)
    assert s["spans"]["pair"]["launches"] == 3
    assert s["layers"]["volume_build.device_ms"] == pytest.approx(0.04)
    assert s["layers"]["postprocess.device_ms"] is None
    assert profiling.kernel_family("void cross_scale_kernel<bf16>", CEN_CS_PP
                                   ) == "K4"
    assert profiling.kernel_family("fly_cost_kernel<false, false>", KITTI
                                   ) == "fly"
    assert profiling.kernel_family(
        "(anonymous namespace)::weighted_median_kernel(unsigned int const*)",
        KITTI) == "WMF"
    for prep in ("wmf_pack_count_kernel(unsigned char const*)",
                 "wmf_compact_kernel(unsigned char const*)"):
        assert profiling.kernel_family(
            f"(anonymous namespace)::{prep}", KITTI) == "WMF"
    assert profiling.kernel_family(
        "(anonymous namespace)::grd_volume_kernel(uint2 const*, float*)",
        KITTI) == "GRDV"
    assert profiling.kernel_family(
        "(anonymous namespace)::quadrant_rank_kernel(float const*)",
        CEN_CS_PP) == "QRANK"
    assert any("idle gaps" in line for line in profiling.format_profile(s))


def perf_md_cells():
    """The cell names of PERF.md section 4's first table."""
    with open(os.path.join(REPO, "PERF.md")) as f:
        text = f.read()
    section = text.split("\n## 4.")[1].split("\n## 5.")[0]
    table = section.split("\n| Cell |")[1].split("\n\n")[0]
    return re.findall(r"^\| `(\w+)` \|", table, re.M)


def test_cells_are_perf_md_cells_and_build():
    cells = bench_torch.CELLS
    assert [c.name for c in cells] == perf_md_cells() == [
        "readme_demo", "cen_cs_pp", "kitti", "kitti_anchor",
        "readme_demo_warm", "kitti_fly"]
    for c in cells:
        check_supported(c.cfg, (c.h, c.w), torch.device("cuda"))
        assert c.cfg.max_dis == c.max_dis
        kitti_size = c.w >= 832
        assert c.thresh == (3.0 if kitti_size else 1.0)
        assert c.pairs >= (10 if kitti_size else 30)
        assert c.gate == bench_torch.BAD_PIXEL_MAX == 0.01
    by = {c.name: c for c in cells}
    assert by["readme_demo"].cfg == README_DEMO
    assert by["cen_cs_pp"].cfg == CEN_CS_PP
    assert by["kitti"].cfg == KITTI
    assert by["kitti_fly"].cfg == dataclasses.replace(
        KITTI, precompute_volume=False)
    assert by["readme_demo_warm"].warm and by["kitti_anchor"].anchor
    a = bench_torch.ev.ANCHOR
    anc = by["kitti_anchor"]
    assert (anc.h, anc.w, anc.max_dis, anc.scene_seed, anc.cfg.dis_scale,
            anc.cfg.use_pp) == (a["h"], a["w"], a["max_dis"],
                                a["scene_seed"], a["dis_scale"], True)
    assert bench_torch.BASELINE_CPU_SECONDS_PER_PAIR == 282.1


def test_last_line_is_one_json_object(capsys):
    cells = (tiny_cell(), tiny_cell("readme_demo_warm", warm=True))
    assert bench_torch.main(["--device", "cpu", "--batch", "2"],
                            cells=cells) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[-1])
    assert line["metric"] == "stereo_pairs_per_second_per_chip"
    assert line["value"] == line["cells"]["readme_demo"]["pairs_per_s"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] * 282.1)
    assert "282s/pair" in line["unit"]
    assert line["device"] == {"kind": "cpu", "power_limit": None,
                              "count": 0}
    assert list(line["cells"]) == ["readme_demo", "readme_demo_warm"]
    for rec in line["cells"].values():
        q = rec["ms_pair"]
        assert q["min"] <= q["q1"] <= q["median"] <= q["q3"] <= q["max"]
        assert rec["pairs"] == len(rec["ms_pair_runs"]) == 1
        assert 0 <= rec["bad_pixel"]["mean"] <= rec["bad_pixel"]["max"]
        assert rec["peak_mib"] is None
    warm = line["cells"]["readme_demo_warm"]["profile"]["phases"]
    assert "warm_phase" in [p["name"] for p in warm]
    assert line["batch"]["batch"] == 2 and line["batch"]["ms_pair"] > 0


def test_one_cell_without_readme_demo_has_no_baseline(capsys):
    cells = (tiny_cell(), tiny_cell("other", thresh=3.0))
    assert bench_torch.main(["--device", "cpu", "--config", "other"],
                            cells=cells) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line["cells"]) == ["other"]
    assert line["vs_baseline"] is None and "other" in line["unit"]


def test_missed_gate_exits_nonzero(capsys):
    # the small scene's bad-pixel @1px is ~0.02, over a gate of 0
    assert bench_torch.main(["--device", "cpu"],
                            cells=(tiny_cell(gate=0.0),)) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "bad-pixel" in cap.err


class StubOracle:
    def __init__(self, scores):
        self.scores = scores

    def anchor_scores(self, key):
        if self.scores is None or key != "32x48_d12_GRD_pp":
            return None
        return self.scores, [1.0] * len(self.scores)


@pytest.mark.parametrize("scores,ok", [([0.5, 0.5], True),
                                       ([0.0, 0.0], False),
                                       (None, False)])
def test_anchor_gate(scores, ok):
    cell = tiny_cell("kitti_anchor", dataclasses.replace(GRD, use_pp=True),
                     anchor=True)
    run = lambda: bench_torch.run_cell(cell, "cpu",  # noqa: E731
                                       oracle=StubOracle(scores))
    if ok:
        rec = run()["anchor"]
        assert rec["delta"] == pytest.approx(rec["bad_engine"] - 0.5)
        assert rec["delta_ci95_hi"] <= 0.005
    else:
        with pytest.raises(bench_torch.GateMissed):
            run()


@pytest.mark.parametrize("argv", [[], ["--device", "cuda:0"]])
def test_no_card_exits_nonzero(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(argv) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err


def test_warm_frames_are_the_scene_with_fresh_noise():
    cell = tiny_cell(warm=True)
    gt, frames = bench_torch.cell_frames(cell, 3)
    assert len(frames) == 5
    clean = np.stack([gt.left, gt.right]).astype(int)
    for f in frames:
        d = np.stack(f).astype(int) - clean
        assert 0.3 < np.abs(d).mean() < 2.0
    assert not np.array_equal(frames[0][0], frames[1][0])
    cold, one = bench_torch.cell_frames(tiny_cell(), 3)
    assert len(one) == 1 and one[0][0] is cold.left


def test_spread_of_runs(tmp_path, capsys):
    """--spread reads earlier runs' last lines: medians across runs, their
    spread (max / min - 1) and 1.5 times it rounded up to 5 % (>= 5 %)."""
    paths = []
    for i, (a, b) in enumerate([(100.0, 500.0), (130.0, 505.0),
                                (110.0, 501.0)]):
        line = {"device": {"kind": "card", "power_limit": "700.00 W",
                           "count": 1},
                "cells": {"a": {"ms_pair": {"median": a}},
                          "b": {"ms_pair": {"median": b}}}}
        path = tmp_path / f"run{i}.out"
        path.write_text("log line\n" + json.dumps(line) + "\n")
        paths.append(str(path))
    assert bench_torch.main(["--spread"] + paths) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["cells"]["a"]["medians"] == [100.0, 130.0, 110.0]
    assert res["cells"]["a"]["spread"] == pytest.approx(0.3)
    assert res["cells"]["a"]["bound"] == pytest.approx(0.45)
    assert res["cells"]["b"]["spread"] == pytest.approx(0.01)
    assert res["cells"]["b"]["bound"] == pytest.approx(0.05)
    assert len(res["devices"]) == 3
