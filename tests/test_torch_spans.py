"""The port's spans (utils/spans) and the joins utils/profiling makes of
them, on the CPU at 32x48 with small windows; one case needs a CUDA card
(marked gpu; on the card: `python -m pytest tests/test_torch_spans.py -m
gpu --noconftest`).

Recording must change no output bit and launch nothing; off, a span is
one shared object and nothing is kept.  A pair's spans form the tree
utils/spans documents, phases in utils/profiling.PHASES's order.  The
joins are checked on hand-made spans and device ops: each op goes to the
innermost span open at its launch, idle gaps to the span open at their
middle.  The profiled pair (utils.profiling.profile_pair, which
tools/torch_profile_pair.py prints) must give run_pair's (run_pair_warm's)
outputs bit for bit: nothing but the recording may differ.
"""

import dataclasses
import json
import time
from collections import Counter

import pytest
import torch

from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI, README_DEMO
from crossscalepatchmatch_tpu_torch.config import Aggregator
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                            run_pair_warm)
from crossscalepatchmatch_tpu_torch.utils import profiling, spans

torch.set_num_threads(1)

SMALL = dict(max_dis=12, dis_scale=16, wnd_size=7)
GRD = dataclasses.replace(README_DEMO, **SMALL)
CONFIGS = {"grd": GRD,
           "cen_cs_pp": dataclasses.replace(CEN_CS_PP, scale_num=3, **SMALL),
           "no_volume": dataclasses.replace(KITTI, precompute_volume=False,
                                            **SMALL),
           "warm": GRD}


@pytest.fixture(scope="module")
def pair():
    return make_pair(h=32, w=48, max_dis=12, seed=3)


def call(case, pair, seed=5):
    cfg = CONFIGS[case]
    if case == "warm":
        prior = run_pair(pair.left, pair.right, 0, cfg, device="cpu")["abc"]
        return run_pair_warm(pair.left, pair.right, seed, prior, cfg, 1,
                             device="cpu")
    return run_pair(pair.left, pair.right, seed, cfg, device="cpu")


def test_off_keeps_nothing():
    a = spans.span("pair", entry="run_pair")
    b = spans.span("draws", view=1, round=2)
    assert a is b is spans.NO_SPAN
    with a as inside:
        assert inside is spans.NO_SPAN
    with spans.recording() as rec:
        pass
    assert rec == []
    with pytest.raises(RuntimeError):
        with spans.recording(), spans.recording():
            pass
    # a recording that ended leaves recording off
    assert spans.span("pair") is spans.NO_SPAN


@pytest.mark.parametrize("case", list(CONFIGS))
def test_outputs_bit_equal_with_recording_on_and_off(case, pair):
    want = call(case, pair)
    with spans.recording() as rec:
        got = call(case, pair)
    assert rec
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def phase_names(rec, root):
    return [sp.name for sp in rec if sp.parent == root]


@pytest.mark.parametrize("case", ["grd", "no_volume"])
def test_span_tree_of_a_cold_pair(case, pair):
    cfg = CONFIGS[case]
    with spans.recording() as rec:
        call(case, pair)
        call(case, pair, seed=6)
    roots = [i for i, sp in enumerate(rec) if sp.parent < 0]
    assert [rec[i].name for i in roots] == ["pair", "pair"]
    assert [rec[i].seq for i in roots] == [0, 1]
    assert rec[0].attrs == {"entry": "run_pair"}
    first = "volume_build" if cfg.precompute_volume else "fly_data"
    second = ["quadrant_build_K2"] if cfg.precompute_volume else []
    assert phase_names(rec, 0) == (
        [first] + second + ["rank_phase", "exact_phase", "plane_to_disp"]
        + (["postprocess"] if cfg.use_pp else []))
    assert [n for n in phase_names(rec, 0)] == sorted(
        phase_names(rec, 0), key=profiling.PHASES.index)
    for i, sp in enumerate(rec):
        assert sp.seq == (0 if i < roots[1] else 1)
        assert sp.start_ns <= sp.end_ns
        if sp.parent >= 0:
            up = rec[sp.parent]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
    one = Counter(sp.name for sp in rec[:roots[1]])
    rounds = len(cfg.refinement_schedule())
    # the init's draws, then one a refinement stage: its proposal, the
    # draws made inside it (utils.rng.TorchDraws.propose)
    assert one["draws"] == 1 + cfg.max_iter * cfg.refine_stages
    assert one["iteration"] == cfg.max_iter and one["init"] == 1
    assert one["sweep"] == cfg.max_iter * cfg.prop_sweeps
    assert one["refine"] == cfg.max_iter * cfg.refine_stages
    # KITTI's schedule: 10 rounds in 2 stages, 7 draws spans a pair
    assert len(KITTI.refinement_schedule()) == 10
    assert 1 + KITTI.max_iter * KITTI.refine_stages == 7
    paths = profiling.span_paths(rec)
    draws = [p for p, sp in zip(paths, rec) if sp.name == "draws"]
    assert draws[0] == "rank_phase/init/draws"
    assert draws[-1] == "exact_phase/iteration/refine/draws"
    last = [sp for sp in rec[:roots[1]] if sp.name == "draws"][-1]
    per = -(-rounds // cfg.refine_stages)
    first = per * (cfg.refine_stages - 1)
    assert last.attrs == {"round": first, "k": rounds - first}
    assert {sp.attrs["fused"] for sp in rec if sp.name == "refine"} == {
        False}
    sweeps = [sp.attrs for sp in rec[:roots[1]] if sp.name == "sweep"]
    assert sweeps[:2] == [{"s": 0, "k": 8}, {"s": 1, "k": 8}]


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("lerp", ["cost", "image"])
def test_fly_data_span_names_its_data_term(pair, lerp, levels):
    """Without a volume the fly_data span carries the data term (lerp:
    "cost" for K5, "image" for K6) and the levels it sums; with a volume
    there is none."""
    cfg = dataclasses.replace(CONFIGS["no_volume"], fly_lerp=lerp,
                              use_cs=levels > 1, scale_num=max(levels, 2),
                              reg_lambda=0.3)
    with spans.recording() as rec:
        run_pair(pair.left, pair.right, 5, cfg, device="cpu")
        run_pair(pair.left, pair.right, 5, GRD, device="cpu")
    got = [(sp.seq, sp.attrs) for sp in rec if sp.name == "fly_data"]
    assert got == [(0, {"lerp": lerp, "levels": levels})]


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("agg", ["BOX", "GF", "BF"])
def test_aggregate_span_a_level(pair, agg, levels):
    """With an aggregation filter each level's filter is an `aggregate`
    span under `volume_build` (filter, level, the inner slices it
    filters), on the CPU path too; without one there is none."""
    cfg = dataclasses.replace(GRD, aggregator=Aggregator(agg),
                              use_cs=levels > 1, scale_num=levels,
                              reg_lambda=0.3)
    with spans.recording() as rec:
        run_pair(pair.left, pair.right, 5, cfg, device="cpu")
        run_pair(pair.left, pair.right, 5, GRD, device="cpu")
    paths = profiling.span_paths(rec)
    second = [i for i, sp in enumerate(rec) if sp.parent < 0][1]
    got = [(paths[i], sp.seq, sp.attrs) for i, sp in enumerate(rec)
           if sp.name == "aggregate"]
    assert got == [("volume_build/aggregate", 0,
                    {"filter": agg, "level": s, "slices": (12 >> s) - 1})
                   for s in range(levels)]
    assert all(i < second for i, sp in enumerate(rec)
               if sp.name == "aggregate")


def test_span_tree_of_a_warm_pair(pair):
    cfg = CONFIGS["warm"]
    prior = run_pair(pair.left, pair.right, 0, cfg, device="cpu")["abc"]
    with spans.recording() as rec:
        run_pair_warm(pair.left, pair.right, 5, prior, cfg, 2, device="cpu")
    assert [sp.name for sp in rec if sp.parent < 0] == ["pair"]
    assert rec[0].attrs == {"entry": "run_pair_warm"}
    assert phase_names(rec, 0) == ["volume_build", "quadrant_build_K2",
                                   "warm_phase", "plane_to_disp"]
    n = Counter(sp.name for sp in rec)
    assert n["init"] == 0 and n["iteration"] == 2
    assert n["draws"] == 2 * cfg.refine_stages
    assert "warm_phase/iteration/refine/draws" in profiling.span_paths(rec)


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


def test_profiled_pair_on_the_cpu_times_phases_from_spans(pair):
    out, s, prof = profiling.profile_pair(pair.left, pair.right, 5,
                                          CONFIGS["cen_cs_pp"], device="cpu")
    assert prof is None and s["device_ms"] is None
    assert s["spans"]["pair"]["count"] == 1
    phases = {p["name"]: p["host_ms"] for p in s["phases"]}
    assert phases == {n: pytest.approx(s["spans"][n]["host_ms"])
                      for n in phases}
    assert sum(phases.values()) <= s["spans"]["pair"]["host_ms"]
    assert s["layers"]["draws.host_ms"] > 0
    assert s["layers"]["optimizer.host_ms"] > 0
    assert s["layers"]["volume_build.device_ms"] is None
    assert any(line.startswith("layers: ")
               for line in profiling.format_profile(s))


def mk(name, start, end, parent=-1, seq=0, **attrs):
    """A span over [start, end) us."""
    sp = spans.Span(name, attrs)
    sp.start_ns, sp.end_ns = start * 1000, end * 1000
    sp.parent, sp.seq = parent, seq
    return sp


def two_pairs():
    """Two recorded pairs (us): 0-80 and 120-200, each with a volume
    build, an exact phase of one iteration with a refinement and its two
    draws, and a post-processing."""
    rec = []
    for seq, t in ((0, 0), (1, 120)):
        root = len(rec)
        rec.append(mk("pair", t, t + 80, seq=seq, entry="run_pair"))
        rec.append(mk("volume_build", t, t + 10, root, seq))
        ph = len(rec)
        rec.append(mk("exact_phase", t + 10, t + 60, root, seq))
        it = len(rec)
        rec.append(mk("iteration", t + 10, t + 60, ph, seq, i=0))
        rf = len(rec)
        rec.append(mk("refine", t + 30, t + 60, it, seq, stage=0, k=2))
        rec.append(mk("draws", t + 30, t + 35, rf, seq, view=0, round=0))
        rec.append(mk("draws", t + 35, t + 40, rf, seq, view=1, round=0))
        rec.append(mk("postprocess", t + 60, t + 80, root, seq))
    return rec


def op(start, end, launch, name="k"):
    return (start * 1000, end * 1000, name,
            None if launch is None else launch * 1000)


def test_owner_is_the_innermost_span_open_at_the_launch():
    rec = two_pairs()
    got = profiling.owners([0, 5_000, 10_000, 32_000, 35_000, 40_000,
                            80_000, 110_000, 150_000, None], rec)
    # a span holds [start, end): at a shared bound the later span owns it
    assert [None if o is None else rec[o].name for o in got] == [
        "volume_build", "volume_build", "iteration", "draws", "draws",
        "refine", None, None, "draws", None]
    assert got[3] != got[4] and rec[got[8]].seq == 1


def test_join_of_device_ops_to_spans():
    rec = two_pairs()
    ops = [op(2, 6, 1), op(12, 20, 11), op(36, 50, 36), op(61, 90, 61),
           op(121, 125, 121), op(150, 160, 132), op(181, 185, 181),
           op(186, 190, None)]
    owner = profiling.owners([o[3] for o in ops], rec)
    t = profiling.span_table(rec, 2, rec, ops, owner)
    assert t["pair"]["count"] == 1 and t["draws"]["count"] == 2
    assert t["pair"]["host_ms"] == pytest.approx(0.080)
    # the pair's self time: what no phase covers
    assert t["pair"]["self_ms"] == pytest.approx(0.0)
    assert t["refine"]["self_ms"] == pytest.approx(0.020)
    assert t["iteration"]["self_ms"] == pytest.approx(0.020)
    assert t["volume_build"]["device_ms"] == pytest.approx(0.004)
    assert t["volume_build"]["launches"] == 1
    # an op belongs where it was launched, not where it ran: the first
    # pair's at 36 us to its second draws, the second pair's at 132 us,
    # which runs during that pair's draws, to its iteration
    assert t["draws"]["launches"] == 0.5
    assert t["draws"]["device_ms"] == pytest.approx(0.007)
    assert t["iteration"]["launches"] == 1.5
    assert t["exact_phase"]["device_ms"] == pytest.approx(0.016)
    assert t["postprocess"]["device_ms"] == pytest.approx(0.0165)
    # the op without a launch joins no span
    assert t["pair"]["launches"] == 3.5
    m = profiling.layer_metrics(t)
    assert m == {"draws.host_ms": pytest.approx(0.010),
                 "optimizer.host_ms": pytest.approx(0.040),
                 "volume_build.device_ms": pytest.approx(0.004),
                 "postprocess.device_ms": pytest.approx(0.0165)}
    host_only = profiling.layer_metrics(profiling.span_table(rec, 2))
    assert host_only["draws.host_ms"] == pytest.approx(0.010)
    assert host_only["volume_build.device_ms"] is None
    assert profiling.layer_metrics({}) == dict.fromkeys(m)


@pytest.mark.parametrize("skewed", [False, True])
def test_idle_gaps_are_placed_by_launch_and_named_by_span(skewed):
    """A gap ends when an op starts on an idle device, which is when the
    host launched it: the gap goes to the host's [launch - length, launch]
    and takes the span open at its middle.  The device's clock gives only
    lengths, so device times off by 300 us and drifting by 1,000 ppm name
    the same spans."""
    rec = two_pairs()
    ops = [op(2, 6, 1), op(12, 20, 11), op(36, 50, 35), op(61, 90, 60),
           op(121, 125, 121), op(152, 160, 152), op(181, 185, 181)]
    if skewed:
        def skew(v):
            return v + 300_000 + (v - 1_000) // 1000
        ops = [(skew(a), skew(b), n, t) for a, b, n, t in ops]
    gaps = profiling.idle_gaps(ops, rec)
    assert [g["span"] for g in gaps] == [
        "volume_build", "volume_build", "exact_phase/iteration",
        "exact_phase/iteration/refine", "between pairs",
        "exact_phase/iteration", "exact_phase/iteration/refine"]
    want = [(0.001, 0.0), (0.006, 0.005), (0.016, 0.019), (0.011, 0.049),
            (0.031, 0.090), (0.027, 0.125), (0.021, 0.160)]
    for g, (ms, at) in zip(gaps, want):
        assert g["ms"] == pytest.approx(ms, abs=1e-4)
        assert g["at_ms"] == pytest.approx(at, abs=1e-4)
    assert profiling.idle_gaps(ops, []) == []


def test_summary_of_device_events():
    """The device readings of a profile (times in us): busy union, idle
    share, kernels by family, each op put down to the phase it was
    launched in, idle gaps named by the span the host was in."""
    rec = [mk("pair", 0, 200, entry="run_pair"),
           mk("volume_build", 0, 100, 0),
           mk("exact_phase", 100, 200, 0)]
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


def test_chrome_trace_carries_the_spans(tmp_path, pair):
    with profiling.trace(str(tmp_path)):
        run_pair(pair.left, pair.right, 5, GRD, device="cpu")
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    marks = [e for e in events if e.get("cat") == "span"]
    names = Counter(e["name"] for e in marks)
    assert names["pair"] == 1 and names["iteration"] == GRD.max_iter
    pid = marks[0]["pid"]
    assert {e["pid"] for e in marks} == {pid}
    assert any(e.get("ph") == "M" and e["pid"] == pid
               and e["args"]["name"] == "spans" for e in events)
    # on the trace's time base: the pair's span holds the profiler's ops
    root = next(e for e in marks if e["name"] == "pair")
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == "aten::roll"]
    assert ops
    for e in ops:
        assert root["ts"] - 1 <= e["ts"] <= root["ts"] + root["dur"] + 1


@pytest.mark.gpu
def test_idle_gap_falls_inside_its_span_on_the_profilers_clock():
    """A host sleep of 20 ms inside a span between two launches: the
    device's idle gap, placed on the host's clock by idle_gaps, starts
    within 0.1 ms of the span, runs past its end to the next launch, and
    is named by it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            spans.recording() as rec:
        # a profile's first launches start late: not the ones measured
        for _ in range(3):
            x.add_(1)
        torch.cuda.synchronize()
        with spans.span("pair"):
            x.add_(1)
            with spans.span("sleep"):
                time.sleep(0.02)
            x.add_(1)
        torch.cuda.synchronize()
    pair, sleep = rec
    ops = profiling.device_ops(prof)
    inside = sorted(o for o in ops
                    if o[3] is not None and pair.start_ns <= o[3])
    assert len(inside) == 2, ops
    assert inside[0][3] < sleep.start_ns and inside[1][3] >= sleep.end_ns
    gaps = profiling.idle_gaps(ops, rec)
    longest = max(gaps, key=lambda g: g["ms"])
    start = pair.start_ns + longest["at_ms"] * 1e6
    end = start + longest["ms"] * 1e6
    info = (longest, sleep.start_ns - pair.start_ns,
            sleep.end_ns - pair.start_ns, inside[1][3] - pair.start_ns)
    assert longest["span"] == "sleep", info
    assert abs(start - sleep.start_ns) <= 100_000, info
    # the gap ends at the second launch, which follows the span's end
    assert sleep.end_ns <= end and abs(end - inside[1][3]) <= 1_000, info
