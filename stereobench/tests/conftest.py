"""Fixtures of the harness's CPU tests: a copy of the benchmark at a tiny
size (24 x 40 frames, 9 disparities, a 5 x 5 window, 3 pyramid levels,
the volume in f32 as the plain versions read it on the CPU)."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


# The window's bad-pixel limit at the tiny size, between what sound runs
# (at most 0.08 % GRD, 15.0 % census) and runs whose step returns its state
# (at least 19.8 % and 68.9 %) read on this size's scenes, seeds 1-3.
TINY_BAD_PX_LIMIT = {"GRD": 5.0, "CEN": 40.0}


def shrink(config: dict) -> dict:
    config = json.loads(json.dumps(config))
    config["frame"] = {"height": 24, "width": 40}
    config["max_disparity"] = 8
    config["scenes"] = config["scenes"][:2]
    config["engine"].update(max_dis=8, wnd_size=5, scale_num=3,
                            vol_dtype="f32")
    config["limits"]["bad_px_pct"] = TINY_BAD_PX_LIMIT[
        config["engine"]["cost_method"]]
    return config


@pytest.fixture
def tiny_root(tmp_path):
    """A directory laid out like a checkout, holding BENCHMARK.json and
    stereobench/ with its configurations shrunk."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "stereobench" / "configs")
    shutil.copytree(os.path.join(REPO, "stereobench", "traffic"),
                    tmp_path / "stereobench" / "traffic")
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            config = shrink(json.load(f))
        with open(tmp_path / c["file"], "w") as f:
            json.dump(config, f)
    for name in os.listdir(tmp_path / "stereobench" / "traffic"):
        path = tmp_path / "stereobench" / "traffic" / name
        with open(path) as f:
            traffic = json.load(f)
        traffic["trace_pairs"] = 2
        traffic["frames_per_scene"] = min(traffic["frames_per_scene"], 3)
        with open(path, "w") as f:
            json.dump(traffic, f)
    return str(tmp_path)


@pytest.fixture
def cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
