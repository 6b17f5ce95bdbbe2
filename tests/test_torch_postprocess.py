"""The port's post-processing (models.postprocess) against the JAX
package's, on the CPU, on the same inputs.

Tolerances:
  * lr_check, fill_invalid: exact (integer and comparison arithmetic; the
    fill's plane extrapolation is the same f32 expression);
  * weighted_median and postprocess: exact when the port's weight table
    holds XLA:CPU's own exp values; with PyTorch's exp (which differs from
    XLA:CPU's in the last ulp at some of the 766 integer L1 distances) at
    most 1 level on at most 0.5 % of the replaced pixels, the one freedom
    allowed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models import postprocess as jpp
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import postprocess as pp
from crossscalepatchmatch_tpu_torch.models.patchmatch import plane_to_disp
from crossscalepatchmatch_tpu_torch.ops import plane
from crossscalepatchmatch_tpu_torch.ops.plane_cost import L1_MAX
from jax_draws import config_pair

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them.
torch.set_num_threads(1)

EXP_ULP_SHARE = 0.005


@pytest.fixture(scope="module")
def scene():
    """A noisy plane field around the ground truth of the small scene
    (with wrong patches, so the LR check invalidates a few percent of the
    pixels), its u8 maps and both configs."""
    pair = make_pair(h=40, w=56, max_dis=12, seed=5)
    jcfg, cfg = config_pair(max_dis=12, dis_scale=8, wnd_size=9,
                            cost_method="CEN", use_pp=True)
    rng = np.random.default_rng(1)
    h, w = 40, 56
    gt = np.stack([pair.disp_left, pair.disp_right])
    dc = gt + rng.normal(0, 0.3, gt.shape).astype(np.float32)
    wrong = rng.uniform(size=gt.shape) < 0.04
    dc[wrong] = rng.uniform(0, 12, wrong.sum())
    ab = rng.uniform(-0.05, 0.05, (2, h, w, 2)).astype(np.float32)
    xs, ys = plane.pixel_grid(h, w, "cpu")
    abc = plane.reanchor(torch.from_numpy(ab), xs, ys, torch.from_numpy(dc))
    dis = plane_to_disp(abc, cfg.dis_scale)
    imgs = torch.from_numpy(np.stack([pair.left, pair.right]))
    return dict(cfg=cfg, jcfg=jcfg, abc=abc, dis=dis, imgs=imgs)


def jnp_of(x):
    return jnp.asarray(x.numpy())


def xla_exp_lut(gamma, device):
    """The weights XLA:CPU computes, exp(-l1 * f32(1/gamma)), at every
    integer L1 distance."""
    l1 = jnp.arange(L1_MAX + 1, dtype=jnp.float32)
    lut = jnp.exp(-l1 * jnp.float32(1.0 / gamma))
    return torch.from_numpy(np.array(lut)).to(device)


def test_lr_check_exact(scene):
    got = pp.lr_check(scene["dis"], scene["cfg"])
    want = np.asarray(jpp.lr_check(jnp_of(scene["dis"]), scene["jcfg"]))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # the scene exercises both outcomes
    assert 0.005 < 1 - want.mean() < 0.5


def test_fill_invalid_exact(scene):
    valid = pp.lr_check(scene["dis"], scene["cfg"])
    valid[:, 3, :] = False                  # a row with no valid pixel
    valid[:, 5, 20:] = False                # valid on the left side only
    valid[:, 6, :30] = False                # valid on the right side only
    got = pp.fill_invalid(scene["dis"], scene["abc"], valid, scene["cfg"])
    want = jpp.fill_invalid(jnp_of(scene["dis"]), jnp_of(scene["abc"]),
                            jnp_of(valid), scene["jcfg"])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def median_inputs(scene):
    valid = pp.lr_check(scene["dis"], scene["cfg"])
    dis = pp.fill_invalid(scene["dis"], scene["abc"], valid, scene["cfg"])
    valid[:, :, :4] = False                 # invalid pixels at the border
    return dis, valid


def test_weighted_median_exact_given_the_same_weights(scene, monkeypatch):
    dis, valid = median_inputs(scene)
    want = np.asarray(jpp.weighted_median(
        jnp_of(dis), jnp_of(scene["imgs"]), jnp_of(valid), scene["jcfg"]))
    monkeypatch.setattr(pp, "asw_lut", xla_exp_lut)
    got = pp.weighted_median(dis, scene["imgs"], valid, scene["cfg"])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != dis.numpy()).mean() > 0.01       # it replaced pixels


def test_weighted_median_torch_exp(scene):
    dis, valid = median_inputs(scene)
    want = np.asarray(jpp.weighted_median(
        jnp_of(dis), jnp_of(scene["imgs"]), jnp_of(valid), scene["jcfg"]))
    got = pp.weighted_median(dis, scene["imgs"], valid, scene["cfg"]).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    replaced = ~valid.numpy()
    assert diff.max() <= 1
    assert (diff[replaced] > 0).mean() <= EXP_ULP_SHARE
    assert not diff[~replaced].any()


@pytest.mark.parametrize("xla_weights", [True, False])
def test_postprocess(scene, monkeypatch, xla_weights):
    want_dis, want_valid = jax.jit(jpp.postprocess, static_argnums=3)(
        jnp_of(scene["dis"]), jnp_of(scene["abc"]), jnp_of(scene["imgs"]),
        scene["jcfg"])
    if xla_weights:
        monkeypatch.setattr(pp, "asw_lut", xla_exp_lut)
    got_dis, got_valid = pp.postprocess(scene["dis"], scene["abc"],
                                        scene["imgs"], scene["cfg"])
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    diff = np.abs(got_dis.numpy().astype(int)
                  - np.asarray(want_dis).astype(int))
    if xla_weights:
        assert not diff.any()
    else:
        assert diff.max() <= 1
        assert (diff > 0).sum() <= EXP_ULP_SHARE * (~got_valid).sum()
