"""The port's no-volume slice (run_pair with precompute_volume=False)
against the JAX engine on the CPU, fed the JAX engine's own draws
(JaxDraws).

The port runs the JAX engine's fused-kernel semantics on every device, so
each mode is held against the JAX computation that has them on the CPU:

  * fly_lerp="image", prescreen_stride=1: JAX run_pair_np with
    precompute_volume=False, which on the CPU always takes the literal
    GrdPC / CSPC path (make_fly_cost_fn) without a prescreen;
  * fly_lerp="cost" with the strided prescreen (the defaults): JAX
    pm.patchmatch + _finalize driven by JAX make_cost_fns of the same
    config with precompute_volume=True, prescreen_mode="window" and every
    max_costs set to fly_sat_cost -- what the JAX engine's fused fly
    kernels compute on the TPU.

Tolerances (those of tests/test_torch_pipeline.py): u8 maps within 1 level
on >= 98 % of each view's pixels, bad-pixel(nonocc) @1px within 0.005.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models import patchmatch as jpm
from crossscalepatchmatch_tpu.models.pipeline import _finalize as j_finalize
from crossscalepatchmatch_tpu.models.pipeline import run_pair_np as j_run
from crossscalepatchmatch_tpu.ops.cost_volume import (
    build_volume_data as j_build_volume_data)
from crossscalepatchmatch_tpu.ops.pallas.window_cost import fly_sat_cost
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np
from jax_draws import JaxDraws, config_pair

# One intra-op thread (see tests/test_torch_pipeline.py).
torch.set_num_threads(1)

SMALL = dict(h=32, w=48, max_dis=12, seed=3)
HW = (32, 48)
BASE = dict(max_dis=12, dis_scale=16, wnd_size=7, cost_method="GRD",
            precompute_volume=False)


def assert_matches(got, want, pair, cfg):
    assert got["dis"].dtype == np.uint8 and got["dis"].shape == (2, *HW)
    for v, (disp, valid) in enumerate(((pair.disp_left, pair.valid_left),
                                       (pair.disp_right, pair.valid_right))):
        d = np.abs(got["dis"][v].astype(int) - want["dis"][v].astype(int))
        assert (d <= 1).mean() >= 0.98, (v, (d <= 1).mean())
        b_got = bad_pixel_rate(got["dis"][v] / cfg.dis_scale, disp, valid)
        b_want = bad_pixel_rate(want["dis"][v] / cfg.dis_scale, disp, valid)
        assert abs(b_got - b_want) <= 0.005, (v, b_got, b_want)
    if cfg.use_pp:
        assert (got["valid"] == want["valid"]).mean() >= 0.98


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_cs=True, scale_num=2, reg_lambda=0.3),
    dict(use_lab_weights=True),
    dict(use_pp=True),
    dict(max_dis=64, dis_scale=3),
])
def test_image_lerp_slice_matches_jax_literal_path(kw):
    """One iteration (half the JAX compile of three): the image mode
    changes the cost function and the finish, not the iteration, which
    test_cost_lerp_slice_matches_jax_fused_semantics runs in full.

    max_dis 64 > W 48 (a config the card refuses): taps fall past their one
    +-W wrap into the next row, and past the last row, where both plain
    lerps read NaN (jnp.take's fill)."""
    jcfg, cfg = config_pair(**{**BASE, "fly_lerp": "image",
                               "prescreen_stride": 1, "max_iter": 1, **kw})
    pair = make_pair(**SMALL)
    want = j_run(pair.left, pair.right, jcfg, seed=0)
    got = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu",
                      draws=JaxDraws(0, jcfg))
    assert_matches(got, want, pair, cfg)


def test_cost_lerp_slice_matches_jax_fused_semantics():
    jcfg, cfg = config_pair(**BASE)
    vcfg = config_pair(**{**BASE, "precompute_volume": True,
                          "prescreen_mode": "window"})[0]
    assert cfg.rank_iters == 0 and vcfg.rank_iters == 0
    pair = make_pair(**SMALL)

    @jax.jit
    def fused(l, r):
        # the JAX run_pair's body, on the window-prescreen volume path
        jvd = j_build_volume_data(l, r, vcfg)
        sat = jnp.float32(fly_sat_cost(vcfg.cost_alpha, vcfg.tau_clr,
                                       vcfg.tau_grd))
        jvd.max_costs = [jnp.stack([sat, sat]) for _ in jvd.max_costs]
        cost_fn, sparse_fn = jpm.make_cost_fns(vcfg, jvd)
        assert sparse_fn is not None
        state = jpm.patchmatch(jax.random.PRNGKey(0), HW, cost_fn, vcfg,
                               sparse_fn)
        return j_finalize(state, jvd.imgs[0], vcfg)

    want = {k: np.asarray(v) for k, v in fused(pair.left, pair.right).items()}
    got = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu",
                      draws=JaxDraws(0, jcfg))
    assert_matches(got, want, pair, cfg)
