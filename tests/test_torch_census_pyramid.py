"""The port's census, pyramid, scale-weight and multi-level volume ops, and
its own config / data / metrics modules, against the JAX package's, on the
CPU.

Every comparison here is exact (integer arithmetic, or float arithmetic
whose every intermediate is exactly representable), except the GRD
volumes, held to max |d| <= 1e-5 as in test_torch_ops.py (FMA contraction
may differ between XLA:CPU and PyTorch).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu import config as jconfig
from crossscalepatchmatch_tpu import data as jdata
from crossscalepatchmatch_tpu import metrics as jmetrics
from crossscalepatchmatch_tpu.ops import census as jcensus
from crossscalepatchmatch_tpu.ops import color as jcolor
from crossscalepatchmatch_tpu.ops import cost_volume as jcv
from crossscalepatchmatch_tpu.ops import pyramid as jpyr
from crossscalepatchmatch_tpu.ops import scale_weights as jsw
from crossscalepatchmatch_tpu_torch import config, data, metrics
from crossscalepatchmatch_tpu_torch.ops import census, color, cost_volume
from crossscalepatchmatch_tpu_torch.ops import pyramid, scale_weights
from jax_draws import config_pair

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them.
torch.set_num_threads(1)

SMALL = dict(h=48, w=64, max_dis=12, seed=3)


def t(x):
    return torch.from_numpy(np.array(x))


# -- the port's own config / data / metrics ----------------------------------

def test_config_fields_defaults_and_presets_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.CSPMConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(config.CSPMConfig)]
    assert tf == jf
    presets = [("README_DEMO", config.README_DEMO, jconfig.README_DEMO),
               ("KITTI", config.KITTI, jconfig.KITTI)]
    presets += [(k, config.MIDDLEBURY[k], jconfig.MIDDLEBURY[k])
                for k in jconfig.MIDDLEBURY]
    assert set(config.MIDDLEBURY) == set(jconfig.MIDDLEBURY)
    for name, got, want in presets:
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    jcs, tcs = config_pair(max_dis=60, dis_scale=4, cost_method="CEN",
                           use_cs=True, use_pp=True, reg_lambda=0.3)
    assert dataclasses.asdict(config.CEN_CS_PP) == dataclasses.asdict(tcs)
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    for cfg in (tcs, config.README_DEMO):
        j = jconfig.CSPMConfig(**dataclasses.asdict(cfg))
        assert (cfg.rank_iters, cfg.half_wnd, cfg.census_bit,
                cfg.refinement_schedule(), cfg.scale_max_dis(3),
                cfg.scale_shape((375, 450), 4)) == (
            j.rank_iters, j.half_wnd, j.census_bit, j.refinement_schedule(),
            j.scale_max_dis(3), j.scale_shape((375, 450), 4))


@pytest.mark.parametrize("kw", [
    dict(wnd_size=4), dict(census_wnd=8), dict(max_dis=0),
    dict(precompute_volume=False, cost_method="CEN"),
    dict(precompute_volume=False, aggregator="BOX"),
    dict(fly_lerp="x"), dict(vol_dtype="f16"), dict(prescreen_mode="x"),
    dict(adopt_mode="x"), dict(adopt_mode="rank", prescreen_stride=1),
    dict(exact_iters=0)])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError) as want:
        config_pair(**kw)
    jmsg = str(want.value)
    args = dict(kw)
    if "cost_method" in args:
        args["cost_method"] = config.CostMethod(args["cost_method"])
    if "aggregator" in args:
        args["aggregator"] = config.Aggregator(args["aggregator"])
    with pytest.raises(ValueError) as got:
        config.CSPMConfig(**args)
    assert str(got.value) == jmsg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_pair_identical(seed):
    kw = dict(h=30, w=44, max_dis=10, seed=seed, n_fg=seed + 2,
              rect_jitter=0.5 * seed, exposure_gain=1.0 + 0.1 * seed)
    if seed == 2:                           # caller-given layer textures
        kw.update(texture_contrast=0.5, textures=list(
            np.random.default_rng(9).uniform(0, 255, (2, 30, 58, 3))))
    got, want = data.make_pair(**kw), jdata.make_pair(**kw)
    for f in dataclasses.fields(jdata.StereoPair):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_metrics_identical():
    rng = np.random.default_rng(0)
    d, gt = rng.uniform(0, 9, (2, 20, 30))
    valid = rng.uniform(size=(20, 30)) < 0.7
    for th in (0.5, 1.0, 3.0):
        assert (metrics.bad_pixel_rate(d, gt, valid, th)
                == jmetrics.bad_pixel_rate(d, gt, valid, th))
    assert metrics.epe(d, gt, valid) == jmetrics.epe(d, gt, valid)
    assert metrics.epe(d, gt) == jmetrics.epe(d, gt)


# -- gray, census ------------------------------------------------------------

def test_rgb_to_gray_u8_exact():
    rgb = np.random.default_rng(1).integers(0, 256, (17, 23, 3), np.uint8)
    rgb[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 255]]
    got = color.rgb_to_gray_u8(t(rgb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcolor.rgb_to_gray_u8(rgb)))


def unpack_jax_bits(words, bits):
    w = np.asarray(words).astype(np.uint64)
    return np.stack([(w[..., b // 32] >> np.uint64(b % 32)) & np.uint64(1)
                     for b in range(bits)], -1).astype(np.uint8)


def unpack_port_bits(code, bits):
    c = code.numpy()
    return np.stack([(c[..., b // 8] >> (b % 8)) & 1 for b in range(bits)],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("shape,wnd", [((20, 27), 9), ((6, 5), 9),
                                       ((11, 13), 5)])
def test_census_transform_bits_exact(shape, wnd):
    """Including an image smaller than the window (the wrap goes around
    more than once)."""
    gray = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                      np.uint8)
    gray[0, 0] = gray[0, 1]                     # equal neighbours: bit 0
    bits = wnd * wnd - 1
    got = census.census_transform(t(gray), wnd)
    assert got.dtype == torch.uint8 and got.shape == (*shape, (bits + 7) // 8)
    np.testing.assert_array_equal(
        unpack_port_bits(got, bits),
        unpack_jax_bits(jax.jit(functools.partial(
            jcensus.census_transform, wnd=wnd))(jnp.asarray(gray)), bits))


def test_popcount_u8():
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = [bin(i).count("1") for i in range(256)]
    assert census.popcount_u8(x).tolist() == want


@pytest.mark.parametrize("right", [False, True])
def test_census_cost_volume_exact(right):
    pair = data.make_pair(**SMALL)
    lg = jcolor.rgb_to_gray_u8(jnp.asarray(pair.left[..., ::-1]))
    rg = jcolor.rgb_to_gray_u8(jnp.asarray(pair.right[..., ::-1]))
    got = census.census_cost_volume(t(lg), t(rg), 12, right=right)
    # jitted: one XLA compile instead of one per eager op
    want = jax.jit(functools.partial(jcensus.census_cost_volume, max_dis=12,
                                     right=right))(lg, rg)
    assert got.dtype == torch.float32 and got.shape == (48, 64, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- pyramid, scale weights --------------------------------------------------

@pytest.mark.parametrize("shape", [(13, 18, 3), (7, 4), (3, 5, 3)])
def test_pyr_down_exact(shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, np.uint8)
    got = pyramid.pyr_down(t(img))
    want = np.asarray(jpyr.pyr_down(jnp.asarray(img)))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    f = np.random.default_rng(7).uniform(0, 9, shape).astype(np.float32)
    np.testing.assert_array_equal(pyramid.pyr_down(t(f)).numpy(),
                                  np.asarray(jpyr.pyr_down(jnp.asarray(f))))


def test_build_pyramid_exact():
    img = data.make_pair(**SMALL).left
    got = pyramid.build_pyramid(t(img), 5)
    want = jax.jit(functools.partial(jpyr.build_pyramid, levels=5))(
        jnp.asarray(img))
    assert [tuple(g.shape) for g in got] == [(48, 64, 3), (24, 32, 3),
                                             (12, 16, 3), (6, 8, 3),
                                             (3, 4, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,lam", [(5, 0.3), (3, 0.0), (1, 0.5), (4, 2.0)])
def test_scale_weights_exact(n, lam):
    got = scale_weights.scale_weights(n, lam)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jsw.scale_weights(n, lam))


# -- multi-level volumes -----------------------------------------------------

@pytest.mark.parametrize("method,levels", [("CEN", 5), ("GRD", 3)])
def test_build_volume_data_multi_level(method, levels):
    pair = data.make_pair(**SMALL)
    jcfg, tcfg = config_pair(max_dis=12, dis_scale=16, wnd_size=11,
                             cost_method=method, use_cs=True,
                             scale_num=levels)
    got = cost_volume.build_volume_data(t(pair.left), t(pair.right), tcfg)
    l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
    if method == "CEN":
        # integer costs: a jitted reference (one XLA compile instead of
        # one per eager op) is exact too
        want = jax.jit(functools.partial(jcv.build_volume_data,
                                         cfg=jcfg))(l, r)
    else:
        # eager, the form the GRD tolerance of test_torch_ops.py holds
        want = jcv.build_volume_data(l, r, jcfg)
    # max_dis 12 -> 6 -> 3 -> 1 -> 0: the last level is one slice
    assert [v.shape[-1] for v in got.vols] == [13, 7, 4, 2, 1][:levels]
    assert len(got.imgs) == len(want.imgs) == levels
    for s in range(levels):
        np.testing.assert_array_equal(got.imgs[s].numpy(),
                                      np.asarray(want.imgs[s]))
        if method == "CEN":
            np.testing.assert_array_equal(got.vols[s].numpy(),
                                          np.asarray(want.vols[s]))
            np.testing.assert_array_equal(got.max_costs[s].numpy(),
                                          np.asarray(want.max_costs[s]))
        else:
            np.testing.assert_allclose(got.vols[s].numpy(),
                                       np.asarray(want.vols[s]), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(got.max_costs[s].numpy(),
                                       np.asarray(want.max_costs[s]),
                                       rtol=0, atol=1e-5)
