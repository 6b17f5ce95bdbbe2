"""Every cell of BENCHMARK.json loads: its configuration with every
CSPMConfig field given and a plain reference that covers it, its traffic
mix, a reader for each of its per-layer metrics; and the files keep to the
benchmark's layout."""

import dataclasses
import json
import os

import pytest

from crossscalepatchmatch_tpu_torch.config import (CEN_CS_PP, KITTI,
                                                   CSPMConfig)
from stereobench import families, reference, trace, workload

from .conftest import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = workload.load_cell(name)
    fields = {f.name for f in dataclasses.fields(CSPMConfig)}
    assert set(cell.config["engine"]) == fields
    cfg = workload.engine_config(cell.config)
    assert cfg.max_dis == cell.config["max_disparity"]
    assert cell.reference.__name__ == cell.config.get(
        "reference", workload.REFERENCE)
    cell.reference.check_engine(cell.config["engine"])
    assert set(cell.config["limits"]) == {"cost_gap", "dis_diff_px",
                                          "valid_diff_px", "bad_px_pct"}
    t = cell.traffic
    assert t["entry"] in workload.ENTRIES and t["loop"] == "closed"
    assert t["in_flight"] == 1 and t["pan_px"] >= 0
    assert cell.chips == 1
    for m in cell.per_layer:
        assert callable(trace.reader(m["name"]))


def test_configs_are_the_ports_presets():
    by = {c["name"]: workload.load_json(os.path.join(REPO, c["file"]))
          for c in BENCH["configs"]}
    assert workload.engine_config(by["kitti2015_grd_pp"]) == KITTI
    assert workload.engine_config(by["mb2003_cen_cs_pp"]) == CEN_CS_PP
    assert workload.engine_config(by["kitti2015_grd_pp_novol"]) == \
        dataclasses.replace(KITTI, precompute_volume=False)


def test_novol_is_kittis_file_with_its_reference():
    """The no-volume configuration is KITTI's file with precompute_volume
    false and its own reference, everything else as KITTI's but its name,
    source, method, deployment and what it assumes about fly_lerp."""
    kitti, novol = (workload.load_json(os.path.join(
        REPO, "stereobench", "configs", n + ".json"))
        for n in ("kitti2015_grd_pp", "kitti2015_grd_pp_novol"))
    assert novol["engine"] == dict(kitti["engine"], precompute_volume=False)
    assert novol["reference"] == "stereobench.reference_fly"
    assert novol["assumed"] == dict(kitti["assumed"],
                                    fly_lerp=novol["assumed"]["fly_lerp"])
    own = {"name", "source", "reference", "assumed", "deployment", "method",
           "engine", "limits"}
    assert set(novol) == set(kitti) | {"reference"}
    assert all(novol[k] == kitti[k] for k in set(kitti) - own)
    assert set(novol["limits"]) == set(kitti["limits"])


@pytest.mark.parametrize("name", ["kitti2015_grd_pp", "mb2003_cen_cs_pp"])
def test_volume_configs_resolve_to_the_volume_reference(name):
    config = workload.load_json(os.path.join(
        REPO, "stereobench", "configs", name + ".json"))
    assert "reference" not in config
    assert workload.reference_of(config) is reference


def test_reference_outside_the_harness_is_refused():
    with pytest.raises(ValueError, match="under stereobench"):
        workload.reference_of({"reference": "os.path"})


def test_names_and_layout():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert c["file"] == f"stereobench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(
            REPO, "stereobench", "traffic", w["traffic"] + ".json"))
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(
            REPO, "stereobench", "layers", m["name"] + ".py"))
        assert m["moves"] == "pairs_per_s"
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "pairs_per_s", "pair_ms_p95", "peak_mem_mib", "bad_px_pct",
        "setup_s"}


def test_kernel_families_are_the_programs():
    """The frozen name map agrees with the program's kernel_family."""
    from crossscalepatchmatch_tpu_torch.utils.profiling import kernel_family

    port = {"K1": "window_cost", "K4": "window_cost", "K2": "quadrant_build",
            "QRANK": "quadrant_rank", "GRDV": "grd_volume",
            "CENV": "census_volume", "WMF": "weighted_median",
            "fly": "fly_cost", "other": families.OTHER}
    names = ["void cross_scale_kernel<true, 1>(Args)",
             "void quadrant_build_kernel<float>(int)",
             "quadrant_rank_kernel(float const*)", "grd_volume_kernel",
             "census_codes_kernel<7>", "census_volume_kernel<7, 9>",
             "weighted_median_kernel", "wmf_pack_count_kernel",
             "wmf_compact_kernel", "fly_cost_kernel<1, 0>",
             "void at::native::vectorized_elementwise_kernel<4>",
             "Memcpy HtoD (Pageable -> Device)"]
    for use_cs in (False, True):
        cfg = CSPMConfig(use_cs=use_cs)
        for n in names:
            assert families.family_of(n) == port[kernel_family(n, cfg)], n


def test_counters_are_read():
    got = families.read_counters()
    assert set(got) == {f.name for f in families.FAMILIES}
    assert all(isinstance(v, int) for v in got.values())
