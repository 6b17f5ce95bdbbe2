"""The port's PatchMatch optimizer (models.patchmatch) against the JAX
engine's, on the CPU, on the same volumes (interop) and the same random
draws (JaxDraws replays the JAX key tree).

Tolerances, each with its reason:
  * cost and prescreen evaluators: |d| <= 2e-5 * max(1, |ref|) (exp and
    summation order differ);
  * view candidates: rtol 1e-6 / atol 1e-5 (plane algebra);
  * one sweep / refinement / iteration from the same state and draws:
    identical planes (within plane-algebra tolerance) on >= 99.9 % of the
    pixels -- a near-tie in cost may flip an adoption;
  * plane_to_disp u8: exact;  adoption on crafted ties: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models import patchmatch as jpm
from crossscalepatchmatch_tpu.ops.cost_volume import (
    build_volume_data as j_build_volume_data)
from crossscalepatchmatch_tpu_torch import interop
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.support import check_supported
from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws
from jax_draws import JaxDraws, config_pair

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them (a 3-worker
# run of these files took 13x longer with the default pool).
torch.set_num_threads(1)

SMALL = dict(h=48, w=64, max_dis=12, seed=3)
HW = (48, 64)


def small_cfgs(**kw):
    """(JAX config, port config) of the small scene."""
    base = dict(max_dis=12, dis_scale=16, wnd_size=11, cost_method="GRD",
                use_cs=False, use_pp=False)
    base.update(kw)
    return config_pair(**base)


def small_cfg(**kw):
    """The port's config of the small scene."""
    return small_cfgs(**kw)[1]


@pytest.fixture(scope="module")
def scene():
    """JAX volumes of the small scene, the same volumes in the port, and a
    partly converged JAX state (one rank iteration from random init)."""
    jcfg, cfg = small_cfgs()
    pair = make_pair(**SMALL)
    jvd = j_build_volume_data(jnp.asarray(pair.left),
                              jnp.asarray(pair.right), jcfg)
    tvd = interop.volume_data_from_numpy(jvd.imgs, jvd.vols, jvd.max_costs,
                                         device="cpu")
    jcost, jsparse = jpm.make_cost_fns(jcfg, jvd)
    key = jax.random.PRNGKey(7)
    k_init, _ = jax.random.split(key)
    st = jpm.init_state(k_init, HW, jsparse, jcfg)
    st = jpm.iteration_step(st, jpm.iteration_keys(key, jcfg)[0], jsparse,
                            jcfg)
    st = jpm.PMState(abc=st.abc, cost=jcost(st.abc[:, None])[:, 0])
    return dict(cfg=cfg, jcfg=jcfg, pair=pair, jvd=jvd, tvd=tvd,
                jcost=jcost, jsparse=jsparse, jstate=st)


def to_port(st):
    return interop.state_from_numpy(np.asarray(st.abc), np.asarray(st.cost),
                                    device="cpu")


def same_planes(got: pm.PMState, want, min_share=0.999):
    g = got.abc.numpy()
    w = np.asarray(want.abc)
    same = np.isclose(g, w, rtol=1e-6, atol=1e-5).all(-1)
    assert same.mean() >= min_share, same.mean()


def assert_rel(got, want, tol=2e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= tol


def test_interop_round_trip(scene):
    st = to_port(scene["jstate"])
    abc, cost = interop.state_to_numpy(st)
    np.testing.assert_array_equal(abc, np.asarray(scene["jstate"].abc))
    np.testing.assert_array_equal(cost, np.asarray(scene["jstate"].cost))
    np.testing.assert_array_equal(scene["tvd"].vols[0].numpy(),
                                  np.asarray(scene["jvd"].vols[0]))


def test_cost_and_sparse_fns(scene):
    cfg = scene["cfg"]
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, scene["tvd"])
    rng = np.random.default_rng(0)
    abc = np.asarray(scene["jstate"].abc)[:, None] + rng.uniform(
        -0.3, 0.3, (2, 3) + HW + (3,)).astype(np.float32)
    assert_rel(cost_fn(torch.from_numpy(abc)).numpy(),
               scene["jcost"](jnp.asarray(abc)))
    assert_rel(sparse_fn(torch.from_numpy(abc)).numpy(),
               scene["jsparse"](jnp.asarray(abc)))
    assert pm.make_cost_fns(small_cfg(prescreen_stride=1),
                            scene["tvd"])[1] is None


@pytest.mark.parametrize("mode", ["volume", "window"])
def test_cross_scale_cost_fns(mode):
    """The cross-scale branch: the exact evaluator is the scale-weighted
    pyramid cost; the volume prescreen ranks on the fine level, the window
    prescreen is absent on cross-scale runs (as in the JAX engine)."""
    jcfg, cfg = small_cfgs(cost_method="CEN", use_cs=True, scale_num=3,
                           wnd_size=7, reg_lambda=0.3, prescreen_mode=mode)
    pair = make_pair(h=24, w=32, max_dis=12, seed=4)
    # census volumes are integers: the jitted build (one XLA compile
    # instead of one per eager op) is the same
    jvd = jax.jit(functools.partial(j_build_volume_data, cfg=jcfg))(
        jnp.asarray(pair.left), jnp.asarray(pair.right))
    tvd = interop.volume_data_from_numpy(jvd.imgs, jvd.vols, jvd.max_costs,
                                         device="cpu")
    jcost, jsparse = jpm.make_cost_fns(jcfg, jvd)
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, tvd)
    rng = np.random.default_rng(8)
    abc = np.concatenate([rng.uniform(-0.2, 0.2, (2, 2, 24, 32, 2)),
                          rng.uniform(-2, 14, (2, 2, 24, 32, 1))],
                         -1).astype(np.float32)
    assert_rel(cost_fn(torch.from_numpy(abc)).numpy(),
               jcost(jnp.asarray(abc)))
    if mode == "volume":
        assert_rel(sparse_fn(torch.from_numpy(abc)).numpy(),
                   jsparse(jnp.asarray(abc)))
    else:
        assert sparse_fn is None and jsparse is None


def test_adopt_strict_and_first_index_on_ties():
    rng = np.random.default_rng(1)
    abc = rng.normal(size=(2, 3, 4, 5, 3)).astype(np.float32)
    cost = rng.integers(0, 3, (2, 3, 4, 5)).astype(np.float32)  # many ties
    held = jpm.PMState(abc=jnp.asarray(rng.normal(size=(2, 4, 5, 3)),
                                       jnp.float32),
                       cost=jnp.asarray(rng.integers(0, 3, (2, 4, 5)),
                                        jnp.float32))
    want = jpm._adopt(held, jnp.asarray(abc), jnp.asarray(cost))
    got = pm._adopt(to_port(held), torch.from_numpy(abc),
                    torch.from_numpy(cost))
    np.testing.assert_array_equal(got.abc.numpy(), np.asarray(want.abc))
    np.testing.assert_array_equal(got.cost.numpy(), np.asarray(want.cost))


def test_stencil():
    for jcfg, cfg in (small_cfgs(), small_cfgs(far_offsets=())):
        for sweep in range(3):
            assert pm._stencil(cfg, sweep) == jpm._stencil(jcfg, sweep)


@pytest.mark.parametrize("include_current,extra", [(False, False),
                                                   (True, True)])
def test_spatial_sweep(scene, include_current, extra):
    cfg, jcfg, jst = scene["cfg"], scene["jcfg"], scene["jstate"]
    if include_current:
        jst = jpm.PMState(abc=jst.abc, cost=jnp.full_like(jst.cost, jnp.inf))
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, scene["tvd"])
    jex = jpm.view_candidates(jst, jcfg) if extra else None
    want = jpm.spatial_sweep(jst, scene["jcost"], jcfg, sweep=1,
                             sparse_fn=scene["jsparse"], extra=jex,
                             include_current=include_current)
    st = to_port(jst)
    got = pm.spatial_sweep(st, cost_fn, cfg, sweep=1, sparse_fn=sparse_fn,
                           extra=pm.view_candidates(st, cfg) if extra
                           else None, include_current=include_current)
    same_planes(got, want)


def test_view_candidates_and_propagation(scene):
    cfg, jcfg, jst = scene["cfg"], scene["jcfg"], scene["jstate"]
    st = to_port(jst)
    np.testing.assert_allclose(pm.view_candidates(st, cfg).numpy(),
                               np.asarray(jpm.view_candidates(jst, jcfg)),
                               rtol=1e-6, atol=1e-5)
    cost_fn, _ = pm.make_cost_fns(cfg, scene["tvd"])
    same_planes(pm.view_propagation(st, cost_fn, cfg),
                jpm.view_propagation(jst, scene["jcost"], jcfg))


@pytest.mark.parametrize("batch", [True, False])
def test_plane_refinement(scene, batch):
    jcfg, cfg = small_cfgs(batch_refine=batch)
    jst = scene["jstate"]
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, scene["tvd"])
    jcost, jsparse = jpm.make_cost_fns(jcfg, scene["jvd"])
    key = jpm.iteration_keys(jax.random.PRNGKey(2), jcfg)[1]
    want = jpm.plane_refinement(jst, key, jcost, jcfg, sparse_fn=jsparse)
    got = pm.plane_refinement(to_port(jst), JaxDraws(2, jcfg), 1, cost_fn,
                              cfg, sparse_fn=sparse_fn)
    same_planes(got, want)


def test_iteration_step(scene):
    cfg, jcfg, jst = scene["cfg"], scene["jcfg"], scene["jstate"]
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, scene["tvd"])
    key = jpm.iteration_keys(jax.random.PRNGKey(3), jcfg)[2]
    want = jpm.iteration_step(jst, key, scene["jcost"], jcfg,
                              scene["jsparse"])
    got = pm.iteration_step(to_port(jst), JaxDraws(3, jcfg), 2, cost_fn, cfg,
                            sparse_fn)
    same_planes(got, want)


@pytest.mark.parametrize("defer", [False, True])
def test_init_state(scene, defer):
    cfg, jcfg = scene["cfg"], scene["jcfg"]
    cost_fn, _ = pm.make_cost_fns(cfg, scene["tvd"])
    k_init, _ = jax.random.split(jax.random.PRNGKey(4))
    want = jpm.init_state(k_init, HW, None if defer else scene["jcost"],
                          jcfg)
    got = pm.init_state(JaxDraws(4, jcfg), HW, None if defer else cost_fn,
                        cfg, device="cpu")
    np.testing.assert_allclose(got.abc.numpy(), np.asarray(want.abc),
                               rtol=1e-6, atol=1e-5)
    if defer:
        assert bool(torch.isinf(got.cost).all())
    else:
        assert_rel(got.cost.numpy(), want.cost)


def test_deferred_cost_entry_matches_refresh(scene):
    """Port twin of tests/test_engine.py::...deferred_cost_entry...: the
    deferred entry (+inf held cost, current plane prepended to the first
    exact sweep) reproduces the refresh entry plane for plane."""
    for mode in ("exact", "rank+exact"):
        cfg = small_cfg(adopt_mode=mode)
        cost_fn, sparse_fn = pm.make_cost_fns(cfg, scene["tvd"])
        draws = TorchDraws(5, "cpu")
        n_rank = cfg.rank_iters

        def rank_phase():
            st = pm.init_state(draws, HW, sparse_fn if n_rank else None, cfg,
                               device="cpu")
            for i in range(n_rank):
                st = pm.iteration_step(st, draws, i, sparse_fn, cfg)
            return st

        st_a = rank_phase()
        st_a = pm.PMState(abc=st_a.abc, cost=cost_fn(st_a.abc[:, None])[:, 0])
        for i in range(n_rank, cfg.max_iter):
            st_a = pm.iteration_step(st_a, draws, i, cost_fn, cfg, sparse_fn)
        st_b = rank_phase()
        st_b = pm.PMState(abc=st_b.abc,
                          cost=torch.full_like(st_b.cost, float("inf")))
        for i in range(n_rank, cfg.max_iter):
            st_b = pm.iteration_step(st_b, draws, i, cost_fn, cfg, sparse_fn,
                                     include_current=i == n_rank)
        assert torch.equal(st_a.abc, st_b.abc)
        torch.testing.assert_close(st_a.cost, st_b.cost, rtol=1e-5,
                                   atol=1e-5)


def test_plane_to_disp_exact():
    rng = np.random.default_rng(6)
    abc = np.zeros((2, 6, 8, 3), np.float32)
    # d * 4 lands on exact halves (round half to even) and past 0 / 255
    abc[..., 2] = rng.integers(-20, 300, (2, 6, 8)) / 8.0
    abc[0, 0, :, 0] = rng.uniform(-1, 1, 8)
    got = pm.plane_to_disp(torch.from_numpy(abc), 4)
    want = jpm.plane_to_disp(jnp.asarray(abc), 4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_draws_deterministic():
    a = TorchDraws(11, "cpu")
    b = TorchDraws(11, "cpu")
    for x, y in ((a.init((2, 4, 5), 12.0, 1e-8), b.init((2, 4, 5), 12.0,
                                                         1e-8)),
                 (a.refine(2, 1, 3, (4, 5), 1.5, 0.05),
                  b.refine(2, 1, 3, (4, 5), 1.5, 0.05))):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    # keyed, not call-ordered: another key differs, asking twice does not
    dz, _ = a.refine(2, 1, 3, (4, 5), 1.5, 0.05)
    assert torch.equal(dz, b.refine(2, 1, 3, (4, 5), 1.5, 0.05)[0])
    assert not torch.equal(dz, a.refine(2, 0, 3, (4, 5), 1.5, 0.05)[0])
    disp, _ = a.init((2, 4, 5), 12.0, 1e-8)
    assert float(disp.min()) >= 1e-8 and float(disp.max()) < 12.0
    assert float(dz.abs().max()) <= 1.5


@pytest.mark.parametrize("kw", [
    dict(aggregator="GF"), dict(aggregator="BF"),
    dict(aggregator="BOX", use_cs=True), dict(aggregator="GF", use_pp=True),
    dict(aggregator="BF", use_lab_weights=True), dict(aggregator="BOX"),
    dict(aggregator="GF", prescreen_mode="window", adopt_mode="exact")])
def test_unsupported_configs_raise(scene, kw):
    """The seven aggregator configs this test held to a refusal while the
    filters were unported now run: check_supported refuses none of them,
    on the CPU or for the card; the port's filtered volumes and saturation
    values equal the JAX engine's within 1e-5 * max(1, |ref|) (the box sums'
    cumsum order differs); and the optimizer's cost functions build on them
    and give finite costs.  tests/test_torch_filters.py holds the same
    seven configs' run_pair_np to JAX's."""
    jcfg, cfg = small_cfgs(**kw)
    pair = scene["pair"]
    for device in ("cpu", "cuda"):
        check_supported(cfg, HW, device)
    jvd = j_build_volume_data(jnp.asarray(pair.left),
                              jnp.asarray(pair.right), jcfg)
    tvd = build_volume_data(torch.from_numpy(pair.left),
                            torch.from_numpy(pair.right), cfg)
    assert len(tvd.vols) == len(jvd.vols) == (cfg.scale_num if cfg.use_cs
                                              else 1)
    for got, want in zip([*tvd.vols, *tvd.max_costs],
                         [*jvd.vols, *jvd.max_costs]):
        want = torch.from_numpy(np.asarray(want))
        assert got.shape == want.shape
        err = ((got.double() - want.double()).abs()
               / want.double().abs().clamp(min=1.0)).max().item()
        assert err <= 1e-5, err
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, tvd)
    abc = to_port(scene["jstate"]).abc[:, None]
    assert bool(torch.isfinite(cost_fn(abc)).all())
    assert sparse_fn is not None
