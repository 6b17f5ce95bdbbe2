"""The port's accuracy scoring (crossscalepatchmatch_tpu_torch.evaluation,
tools/torch_eval.py, tools/torch_kitti_anchor.py) against the repository's
eval.py and tools/kitti_anchor.py, on the CPU.

The tables and scene recipes must be eval.py's and kitti_anchor.py's (the
cached oracle scores belong to those scenes); the matrix's bootstrap is
eval.py's; scoring never writes the caches; and the port's row scorer,
given the JAX engine's draws, scores a reduced GRD row and a reduced
CEN+CS+PP row within the parity bound 0.005 of the same scorer over the
JAX engine.  The root scripts are loaded from their paths and not changed.
"""

import ast
import dataclasses
import hashlib
import importlib.util
import os
import zlib

import numpy as np
import pytest

from crossscalepatchmatch_tpu import config as jconfig
from crossscalepatchmatch_tpu import data as jdata
from crossscalepatchmatch_tpu.models import pipeline as jpipeline
from crossscalepatchmatch_tpu_torch import evaluation as ev

from jax_draws import JaxDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(relpath):
    name = "_loaded_" + relpath.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def eval_py():
    return load("eval.py")


def anchor_defaults():
    """tools/kitti_anchor.py's argparse defaults and its make_pair seed,
    read from its source (they live inside its main())."""
    with open(os.path.join(REPO, "tools", "kitti_anchor.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = getattr(node.func, "attr", getattr(node.func, "id", None))
        kw = {k.arg: k.value for k in node.keywords}
        if fn == "add_argument" and "default" in kw:
            flag = node.args[0].value.lstrip("-").replace("-", "_")
            out[flag] = ast.literal_eval(kw["default"])
        if fn == "make_pair":
            out["scene_seed"] = ast.literal_eval(kw["seed"])
    return out


def test_tables_are_evals(eval_py):
    assert ev.CONFIGS == eval_py.CONFIGS
    assert ev.QUICK == eval_py.QUICK
    assert ev.CS_SCENES == eval_py.CS_SCENES
    a = anchor_defaults()
    assert {k: ev.ANCHOR[k] for k in ("h", "w", "max_dis", "dis_scale",
                                      "cc", "thresh", "scene_seed")} == \
        {k: a[k] for k in ("h", "w", "max_dis", "dis_scale", "cc", "thresh",
                           "scene_seed")}
    assert ev.ANCHOR["engine_seeds"] == a["engine_seeds"]
    assert ev.ANCHOR["oracle_seeds"] == a["oracle_seeds"]
    assert ev.anchor_key(256, 832, 96, "GRD") == "256x832_d96_GRD_pp"


def jax_scene(name, h, w, max_dis, scene_kw):
    """eval.py's recipe (main() and cs_ablation()) on the JAX package."""
    cseed = zlib.crc32(name.encode()) % 1000
    scene_kw = dict(scene_kw)
    if scene_kw.pop("photo", False):
        photo = jdata.load_host_photo()
        if photo is None:
            return None
        scene_kw["textures"] = jdata.photo_textures(
            photo, 5, h, w + max_dis + 4, np.random.default_rng(cseed))
    return jdata.make_pair(h=h, w=w, max_dis=max_dis, seed=cseed, **scene_kw)


SCENES = ([("matrix", c[0]) for c in ev.CONFIGS]
          + [("ablation", s[0]) for s in ev.CS_SCENES] + [("anchor", "")])


def scenes_of(table, name):
    """(port scene, eval.py's scene) of a matrix row, an ablation scene or
    the anchor (kitti_anchor.py's recipe)."""
    if table == "anchor":
        a = ev.ANCHOR
        return ev.anchor_scene(), jdata.make_pair(
            h=a["h"], w=a["w"], max_dis=a["max_dis"], seed=7)
    rows = ev.CONFIGS if table == "matrix" else ev.CS_SCENES
    row = next(r for r in rows if r[0] == name)
    _, h, w, max_dis = row[:4]
    return (ev.make_scene(name, h, w, max_dis, row[-1]),
            jax_scene(name, h, w, max_dis, row[-1]))


class Recorder:
    """make_pair's stand-in: records its keyword arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(kw)
        return kw


def same_args(a, b):
    if set(a) != set(b):
        return False
    for k in a:
        if k == "textures":
            if len(a[k]) != len(b[k]) or any(
                    x.tobytes() != y.tobytes() for x, y in zip(a[k], b[k])):
                return False
        elif a[k] != b[k] or type(a[k]) is not type(b[k]):
            return False
    return True


@pytest.mark.parametrize("table,name", SCENES)
def test_scene_recipe_is_evals(monkeypatch, table, name):
    """Every row's scene is made by make_pair with eval.py's (kitti_anchor
    .py's) arguments: the crc32 seed, the row's keywords and, on a host with
    the photograph, the same photo textures (compared byte for byte).  With
    make_pair itself byte-equal to the JAX package's
    (test_scene_is_evals), the scenes are the cached scores' scenes."""
    port, jax = Recorder(), Recorder()
    monkeypatch.setattr(ev, "make_pair", port)
    monkeypatch.setattr(jdata, "make_pair", jax)
    got, want = scenes_of(table, name)
    assert (got is None) == (want is None)
    if got is not None:
        assert len(port.calls) == len(jax.calls) == 1
        assert same_args(port.calls[0], jax.calls[0])


def digest(pair):
    h = hashlib.sha256()
    for f in dataclasses.fields(pair):
        h.update(np.ascontiguousarray(getattr(pair, f.name)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("table,name", [
    ("matrix", "photo_cen_pp"), ("matrix", "rectjitter_cen_pp"),
    ("matrix", "exposure_grd_pp"), ("ablation", "noisy_lowtex")])
def test_scene_is_evals(table, name):
    """Byte for byte the scene eval.py scores, built by both packages
    (make_pair walks every pixel in Python: a few rows covering the
    photo, rectification, exposure, noise and contrast keywords)."""
    got, want = scenes_of(table, name)
    assert (got is None) == (want is None)
    if got is not None:
        assert digest(got) == digest(want)


def test_unpaired_bootstrap_is_evals():
    """eval.py:345-353 (and kitti_anchor.py's copy), inline."""
    rng = np.random.default_rng(11)
    for n_e, n_o in ((5, 5), (5, 2), (3, 4)):
        bads = list(rng.uniform(0.01, 0.05, n_e))
        bads_o = list(rng.uniform(0.01, 0.05, n_o))
        brng = np.random.default_rng(0)
        e_s = np.asarray(bads, np.float64)
        o_s = np.asarray(bads_o, np.float64)
        n_boot = 10000
        d_bs = (brng.choice(e_s, (n_boot, e_s.size)).mean(axis=1)
                - brng.choice(o_s, (n_boot, o_s.size)).mean(axis=1))
        ci_hi = float(np.quantile(d_bs, 0.975))
        assert ev.unpaired_ci_hi(bads, bads_o) == ci_hi


def test_paired_bootstrap():
    """Paired by seed, one generator a scene: a scene's interval does not
    depend on what ran before; a constant difference has a zero-width
    interval; a shared per-seed offset cancels."""
    rng = np.random.default_rng(3)
    ss = rng.uniform(0.05, 0.1, 5)
    cs = ss - 0.01 + rng.normal(0, 0.001, 5)
    first = ev.paired_ci(cs, ss, "lowtex")
    ev.paired_ci(ss, cs, "noisy")
    assert ev.paired_ci(cs, ss, "lowtex") == first
    assert first[0] <= float(np.mean(cs - ss)) <= first[1]
    lo, hi = ev.paired_ci(ss - 0.02, ss, "clean")
    assert lo == pytest.approx(-0.02) and hi == pytest.approx(-0.02)
    offset = rng.uniform(0, 0.5, 5)
    assert ev.paired_ci(cs + offset, ss + offset, "lowtex") == \
        pytest.approx(first)


def test_set_parsing_is_evals():
    assert ev.parse_set(["merge_view=true", "refine_stages=1",
                         "wgt_gamma=12.5", "prescreen_mode=window",
                         "use_pp=False"]) == dict(
        merge_view=True, refine_stages=1, wgt_gamma=12.5,
        prescreen_mode="window", use_pp=False)
    assert ev.overrides("exact", 1, 2, ["max_iter=4"]) == dict(
        adopt_mode="exact", exact_iters=1, refine_stages=2, max_iter=4)
    assert ev.overrides() == {}
    cfg = ev.row_config(24, 4, "CEN", True, True, adopt_mode="exact")
    assert (cfg.scale_num, cfg.reg_lambda, cfg.adopt_mode) == (3, 0.3,
                                                                 "exact")
    assert ev.row_config(16, 8, "GRD", False, False).scale_num == 5


def stub_engine(left, right, cfg, seed):
    return np.full((2,) + left.shape[:2], 4 * cfg.dis_scale + seed,
                   np.uint8)


def test_scoring_leaves_the_caches_as_they_are(monkeypatch, capsys):
    """tools/torch_eval.py (matrix, hit and miss; the ablation) and
    tools/torch_kitti_anchor.py with a stub engine: the JSON lines come
    out, a cache miss is computed in memory, and neither cache file
    changes."""
    torch_eval = load("tools/torch_eval.py")
    anchor = load("tools/torch_kitti_anchor.py")
    before = {p: open(p, "rb").read() for p in (ev.ORACLE_CACHE,
                                                ev.ANCHOR_CACHE)}
    calls = []
    monkeypatch.setattr(ev, "oracle_bad", lambda pair, seed, **kw: (
        calls.append(seed) or 0.02))
    import json

    scores = ev.OracleScores()
    rc = torch_eval.main(["--only", "cones_cen_pp,photo_grd", "--seeds", "2",
                          "--device", "cpu"], engine=stub_engine,
                         oracle=scores)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc in (0, 1) and res["metric"] == \
        "bad_pixel_delta_vs_oracle_worst" and res["device"] == "cpu"
    names = [r["config"] for r in res["rows"]] + res["skipped"]
    assert sorted(names) == ["cones_cen_pp", "photo_grd"]
    assert calls == [] and scores.computed == {}
    assert torch_eval.main(["--quick", "--seeds", "1", "--oracle_seeds",
                            "2", "--device", "cpu"], engine=stub_engine,
                           oracle=scores) in (0, 1)
    assert sorted(scores.computed) == ["readme_demo_grd/v2/2",
                                       "tsukuba_cen_pp/v2/2"]
    assert calls == [0, 1, 0, 1]
    capsys.readouterr()
    assert torch_eval.main(["--cs-ablation", "--only", "clean", "--seeds",
                            "2", "--device", "cpu"], engine=stub_engine,
                           oracle=scores) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metric"] == "cs_ablation_bad_pixel"
    row = res["rows"][0]
    assert row["scene"] == "clean" and set(row) == {"scene", "engine",
                                                    "oracle"}
    assert anchor.main(["--engine-seeds", "2", "--device", "cpu"],
                       engine=stub_engine, oracle=scores) in (0, 1)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["scene"] == "256x832_d96_GRD_pp"
    assert res["oracle_seeds"] == 2 and res["engine_seeds"] == 2
    assert anchor.main(["--h", "64", "--engine-seeds", "1", "--device",
                        "cpu"], engine=stub_engine, oracle=scores) == 1
    for path, data in before.items():
        assert open(path, "rb").read() == data


def jax_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["cost_method"] = jconfig.CostMethod(cfg.cost_method.value)
    kw["aggregator"] = jconfig.Aggregator(cfg.aggregator.value)
    return jconfig.CSPMConfig(**kw)


class FixedOracle(ev.OracleScores):
    """Oracle scores of a reduced row, not computed: the comparison here
    is the port's engine against the JAX engine through one scorer."""

    def row(self, name, pair, n, **kw):
        return [0.05] * n, 0.0


@pytest.mark.parametrize("row", [
    ("readme_demo_grd@32x48", 32, 48, 8, 16, "GRD", False, False, {}),
    ("teddy_cen_cs_pp@32x48", 32, 48, 8, 16, "CEN", True, True, {})])
def test_row_scorer_port_matches_jax(row):
    """The row scorer over the port (CPU, the JAX engine's draws) and over
    JAX run_pair_np: bad-pixel within the parity bound."""
    port = ev.engine_on("cpu", draws_for=lambda s, c: JaxDraws(s,
                                                                jax_cfg(c)))

    def jax_engine(left, right, cfg, seed):
        return jpipeline.run_pair_np(left, right, jax_cfg(cfg),
                                     seed=seed)["dis"]

    kw = dict(seeds=2, oracle_seeds=2, engine_kw=dict(wnd_size=7))
    got = ev.score_row(row, port, FixedOracle(), **kw)
    want = ev.score_row(row, jax_engine, FixedOracle(), **kw)
    assert got["config"] == want["config"] == row[0]
    assert abs(got["bad_engine"] - want["bad_engine"]) <= ev.BOUND, (
        got["engine_bads"], want["engine_bads"])
    assert all(abs(a - b) <= ev.BOUND for a, b in
               zip(got["engine_bads"], want["engine_bads"]))
