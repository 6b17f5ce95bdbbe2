"""The port's aggregation filters (ops.filters) and aggregated pipeline
against the JAX package's, on the CPU, on the same numpy inputs made from a
seed.

Tolerances, each with its reason:
  * box, gray-guided and bilateral filters and the aggregated volumes:
    |port - JAX| <= 1e-5 * max(1, |JAX|) (f32; the box sums' cumsum and
    the sums' order differ between torch and XLA);
  * the colour-guided filter: 1e-4 (its 3x3 inverse multiplies the window
    sums' f32 rounding by up to ~1 / (variance + eps), large where the
    guide is flat);
  * the median: exact u8;
  * run_pair_np with an aggregator, fed the JAX engine's draws: the bound
    of tests/test_torch_pipeline.py (u8 maps within 1 level on >= 98 % of
    each view's pixels, bad-pixel(nonocc) @1px within 0.005).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models.pipeline import run_pair_np as j_run
from crossscalepatchmatch_tpu.ops import filters as jf
from crossscalepatchmatch_tpu.ops.cost_volume import (
    build_volume_data as j_build_volume_data)
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np
from crossscalepatchmatch_tpu_torch.ops import filters as tf
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from jax_draws import JaxDraws, config_pair

torch.set_num_threads(1)

REL_TOL = 1e-5


def assert_close(got, want, tol=REL_TOL):
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()
    assert err <= tol, err


def both(fn_name, *arrays, **kw):
    """(port, JAX) results of the filter `fn_name` on the same arrays."""
    got = getattr(tf, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    want = getattr(jf, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    return got, np.asarray(want)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_box_filter_matches_jax(rng):
    x = rng.normal(size=(11, 13)).astype(np.float32)
    assert_close(*both("box_filter", x, radius=3))


def test_box_filter_batched_matches_jax(rng):
    x = rng.normal(size=(2, 9, 10)).astype(np.float32)
    got, want = both("box_filter", x, radius=2)
    assert_close(got, want)
    for b in range(2):       # a batch entry is the filter of that entry
        assert torch.equal(got[b], tf.box_filter(torch.from_numpy(x[b]), 2))


def test_guided_filter_gray_matches_jax(rng):
    guide = rng.uniform(size=(12, 14)).astype(np.float32)
    p = rng.uniform(size=(12, 14)).astype(np.float32)
    assert_close(*both("guided_filter", guide, p, radius=3))
    flat = np.full((12, 14), 0.5, np.float32)
    assert_close(*both("guided_filter", flat, p, radius=3))


def test_guided_filter_color_matches_jax(rng):
    """The colour guide's 3x3 inverse on a step edge (the edge stays sharp)
    and on a random guide."""
    h, w = 16, 24
    guide = np.zeros((h, w, 3), np.float32)
    guide[:, w // 2:] = 1.0
    p = guide[..., 0].copy()
    noisy = p + rng.normal(scale=0.05, size=p.shape).astype(np.float32)
    got, want = both("guided_filter", guide, noisy, radius=4, eps=1e-4)
    assert_close(got, want, tol=1e-4)
    edge_err = np.abs(got.numpy() - p)[:, w // 2 - 1:w // 2 + 1].mean()
    assert edge_err < 0.08, edge_err
    guide = rng.uniform(size=(h, w, 3)).astype(np.float32)
    assert_close(*both("guided_filter", guide, noisy, radius=4, eps=1e-4),
                 tol=1e-4)


def test_bilateral_filter_matches_jax(rng):
    guide = rng.uniform(size=(8, 9, 3)).astype(np.float32)
    p = rng.uniform(size=(8, 9)).astype(np.float32)
    assert_close(*both("bilateral_filter", guide, p, wnd=5))


def test_bilateral_gray_guide_matches_jax(rng):
    guide = rng.uniform(size=(7, 8)).astype(np.float32)
    p = rng.uniform(size=(7, 8)).astype(np.float32)
    assert_close(*both("bilateral_filter", guide, p, wnd=3))
    # wrap-around borders: a window wider than the image reads wrapped
    # pixels, as jnp.roll does
    assert_close(*both("bilateral_filter", guide, p, wnd=9))


def test_median_filter_matches_jax(rng):
    img = rng.integers(0, 256, size=(13, 17), dtype=np.uint8)
    got, want = both("median_filter_u8", img, radius=2)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_median_filter_channels_matches_jax(rng):
    img = rng.integers(0, 256, size=(6, 7, 3), dtype=np.uint8)
    got, want = both("median_filter_u8", img, radius=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_volume_aggregation_touches_inner_slices_only(rng):
    vol = rng.uniform(size=(10, 12, 6)).astype(np.float32)
    guide = rng.integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    for name, kw in (("box_filter_volume", dict(radius=1)),
                     ("guided_filter_volume", dict(radius=2)),
                     ("bilateral_filter_volume", dict(wnd=5))):
        arrays = (vol,) if name == "box_filter_volume" else (vol, guide)
        got, want = both(name, *arrays, **kw)
        assert_close(got, want)
        for d in (0, 5):
            np.testing.assert_array_equal(got[..., d].numpy(), vol[..., d])


@pytest.mark.parametrize("agg", ["BOX", "GF", "BF"])
def test_aggregated_volumes_match_jax(agg):
    """build_volume_data with an aggregator: each view's filtered volume,
    guided by its BGR image, and the saturation value of the filtered
    volume."""
    pair = make_pair(h=24, w=32, max_dis=6, seed=3)
    jcfg, cfg = config_pair(max_dis=6, dis_scale=16, wnd_size=7,
                            aggregator=agg)
    tvd = build_volume_data(torch.from_numpy(pair.left),
                            torch.from_numpy(pair.right), cfg)
    jvd = j_build_volume_data(jnp.asarray(pair.left),
                              jnp.asarray(pair.right), jcfg)
    assert tvd.vols[0].shape == (2, 24, 32, 7)
    assert_close(tvd.vols[0], jvd.vols[0])
    assert_close(tvd.max_costs[0], jvd.max_costs[0])


SMALL = dict(h=48, w=64, max_dis=12, seed=3)


@pytest.mark.parametrize("kw", [
    dict(aggregator="GF"), dict(aggregator="BF"),
    dict(aggregator="BOX", use_cs=True), dict(aggregator="GF", use_pp=True),
    dict(aggregator="BF", use_lab_weights=True), dict(aggregator="BOX"),
    dict(aggregator="GF", prescreen_mode="window", adopt_mode="exact")])
def test_aggregator_run_pair_matches_jax(kw):
    """The seven configs the port refused before the filters were ported,
    each through run_pair_np against JAX run_pair_np (two iterations, one
    of them exact, to keep the JAX compiles short)."""
    jcfg, cfg = config_pair(max_dis=12, dis_scale=16, wnd_size=11,
                            max_iter=2, exact_iters=1, **kw)
    pair = make_pair(**SMALL)
    want = j_run(pair.left, pair.right, jcfg, seed=0)
    got = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu",
                      draws=JaxDraws(0, jcfg))
    assert got["dis"].shape == (2, 48, 64)
    for v in range(2):
        d = np.abs(got["dis"][v].astype(int) - want["dis"][v].astype(int))
        assert (d <= 1).mean() >= 0.98, (v, (d <= 1).mean())
    for dis_g, dis_w, gt, ok in ((got["dis"][0], want["dis"][0],
                                  pair.disp_left, pair.valid_left),
                                 (got["dis"][1], want["dis"][1],
                                  pair.disp_right, pair.valid_right)):
        b_g = bad_pixel_rate(dis_g / cfg.dis_scale, gt, ok)
        b_w = bad_pixel_rate(dis_w / cfg.dis_scale, gt, ok)
        assert abs(b_g - b_w) <= 0.005, (b_g, b_w)
