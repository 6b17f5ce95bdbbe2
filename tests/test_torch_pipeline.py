"""The port's whole slice (models.pipeline) against the JAX engine, on the
CPU, plus the package-level guarantees.

Tolerances: run_pair_np(device="cpu") fed the JAX engine's own draws
(JaxDraws) must give u8 disparity maps within 1 level of JAX run_pair_np on
>= 98 % of each view's pixels, and a bad-pixel(nonocc) @1px within 0.005
of the JAX engine's -- the window costs agree to ~1e-6 relative, so only
near-tie adoptions (and, with post-processing, the weighted median's
exp-ulp ties) may differ and the trajectories stay together.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models.pipeline import run_pair_np as j_run
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                            run_pair_np,
                                                            run_pairs)
from crossscalepatchmatch_tpu_torch.support import check_supported
from jax_draws import JaxDraws, config_pair

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them (a 3-worker
# run of these files took 13x longer with the default pool).
torch.set_num_threads(1)

SMALL = dict(h=48, w=64, max_dis=12, seed=3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfgs(**kw):
    """(JAX config, port config) of the small scene."""
    base = dict(max_dis=12, dis_scale=16, wnd_size=11, cost_method="GRD",
                use_cs=False, use_pp=False)
    base.update(kw)
    return config_pair(**base)


def small_cfg(**kw):
    """The port's config of the small scene."""
    return small_cfgs(**kw)[1]


def bad_rates(dis, pair, scale):
    return [bad_pixel_rate(dis[0] / scale, pair.disp_left, pair.valid_left),
            bad_pixel_rate(dis[1] / scale, pair.disp_right,
                           pair.valid_right)]


@pytest.mark.parametrize("kw", [
    dict(),                               # production: rank+exact, batched
    dict(adopt_mode="exact"),
    dict(adopt_mode="rank"),
    dict(batch_refine=False, adopt_mode="exact", prescreen_stride=1),
    # the census + cross-scale + post-processing slice (CEN_CS_PP, small)
    dict(cost_method="CEN", use_cs=True, use_pp=True, reg_lambda=0.3,
         scale_num=3),
    dict(cost_method="CEN", use_pp=True),
    dict(merge_view=True),                # view candidate in the last sweep
    dict(prop_sweeps=0),                  # no sweeps: no deferred entry
])
def test_run_pair_matches_jax(kw):
    jcfg, cfg = small_cfgs(**kw)
    pair = make_pair(**SMALL)
    want = j_run(pair.left, pair.right, jcfg, seed=0)
    got = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu",
                      draws=JaxDraws(0, jcfg))
    assert got["dis"].dtype == np.uint8 and got["dis"].shape == (2, 48, 64)
    for v in range(2):
        d = np.abs(got["dis"][v].astype(int) - want["dis"][v].astype(int))
        assert (d <= 1).mean() >= 0.98, (v, (d <= 1).mean())
    for b_got, b_want in zip(bad_rates(got["dis"], pair, cfg.dis_scale),
                             bad_rates(want["dis"], pair, cfg.dis_scale)):
        assert abs(b_got - b_want) <= 0.005
    if cfg.use_pp:
        assert (got["valid"] == want["valid"]).mean() >= 0.98


def test_run_pair_deterministic_and_converges():
    cfg = small_cfg()
    pair = make_pair(**SMALL)
    a = run_pair_np(pair.left, pair.right, cfg, seed=1, device="cpu")
    b = run_pair_np(pair.left, pair.right, cfg, seed=1, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["valid"].all() and a["abc"].shape == (2, 48, 64, 3)
    assert np.isfinite(a["cost"]).all()
    assert max(bad_rates(a["dis"], pair, cfg.dis_scale)) < 0.15


def test_run_pairs_is_a_loop_over_run_pair():
    cfg = small_cfg(max_iter=1, exact_iters=1)
    pairs = [make_pair(h=24, w=32, max_dis=12, seed=s) for s in (0, 1)]
    ls = torch.from_numpy(np.stack([p.left for p in pairs]))
    rs = torch.from_numpy(np.stack([p.right for p in pairs]))
    out = run_pairs(ls, rs, [4, 5], cfg, device="cpu")
    assert out["dis"].shape == (2, 2, 24, 32)
    for i, seed in enumerate((4, 5)):
        one = run_pair(ls[i], rs[i], seed, cfg, device="cpu")
        assert torch.equal(out["dis"][i], one["dis"])


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke, bench_scaling_torch and the
    port's tools (tools/torch_eval.py, tools/torch_kitti_anchor.py) import
    without jax and without any module of the JAX package; no source of the
    port, nor chip_smoke.py, bench_scaling_torch.py nor those tools,
    tools/torch_profile_pair.py and tools/torch_kernel_ab.py, names the JAX
    package in an import statement (imports inside functions that need a
    card never run here)."""
    code = (
        "import importlib, importlib.util, json, pkgutil, sys\n"
        "import crossscalepatchmatch_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in ('weighted_median', 'grd_volume', 'quadrant_rank'):\n"
        "    assert p.__name__ + '.ops.cuda.' + m in names\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, bench_scaling_torch\n"
        "for t in ('torch_eval', 'torch_kitti_anchor'):\n"
        "    spec = importlib.util.spec_from_file_location(t, "
        "'tools/' + t + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    try:\n"
        "        mod.main(['--help'])\n"
        "    except SystemExit:\n"
        "        pass\n"
        "ref = [k for k in sys.modules if k == 'crossscalepatchmatch_tpu' "
        "or k.startswith('crossscalepatchmatch_tpu.')]\n"
        "print(json.dumps([len(names), 'jax' in sys.modules, "
        "any(k.startswith('jax') for k in sys.modules), ref]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, has_jax, has_any, ref = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert n >= 20 and not has_jax and not has_any and ref == []

    pkg = os.path.join(REPO, "crossscalepatchmatch_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tools", "torch_eval.py"),
              os.path.join(REPO, "tools", "torch_kitti_anchor.py"),
              os.path.join(REPO, "bench_scaling_torch.py"),
              os.path.join(REPO, "tools", "torch_profile_pair.py"),
              os.path.join(REPO, "tools", "torch_kernel_ab.py")]
    assert len(files) >= 20
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "crossscalepatchmatch_tpu")]
    assert bad == []


@pytest.mark.parametrize("kw,limit", [
    (dict(wnd_size=131), "half_wnd <= 64"),
    (dict(precompute_volume=False, fly_lerp="image", max_dis=40),
     "max_dis < the image's width")])
def test_card_limits_refused_before_any_volume(monkeypatch, kw, limit):
    """A config the card's kernels cannot take is refused at entry, with
    the limit named, before the volume (or channel planes) is built and
    before anything moves to the card; the CPU does not refuse it, as the
    JAX engine does not (the plain image lerp at max_dis >= W is held
    against JAX in tests/test_torch_fly_pipeline.py)."""
    from crossscalepatchmatch_tpu_torch import checkpoint
    from crossscalepatchmatch_tpu_torch.models import pipeline

    cfg = small_cfg(**kw)
    pair = make_pair(h=24, w=40, max_dis=8, seed=1)

    def built(*a, **k):
        raise AssertionError("the volume was built")

    monkeypatch.setattr(pipeline, "build_volume_data", built)
    monkeypatch.setattr(pipeline, "build_fly_data", built)
    for run in (lambda: run_pair(pair.left, pair.right, 0, cfg,
                                 device="cuda"),
                lambda: pipeline.run_pair_warm(
                    pair.left, pair.right, 0, np.zeros((2, 24, 40, 3),
                                                       np.float32),
                    cfg, device="cuda"),
                lambda: checkpoint.run_pair_resumable(
                    pair.left, pair.right, cfg, "unused.npz",
                    device="cuda")):
        with pytest.raises(ValueError, match=limit):
            run()
    monkeypatch.undo()
    check_supported(cfg, (24, 40), "cpu")
