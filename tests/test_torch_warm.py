"""The port's warm start (models.pipeline.run_pair_warm, run_sequence_np)
against the JAX engine's, on the CPU, on the volume path and on the
no-volume path.

The port is fed the JAX engine's draws: JaxDraws for a cold frame and
JaxWarmDraws (the warm key tree, split(PRNGKey(seed), warm_iters)) for a
warm one.  The JAX engine on the CPU runs the no-volume path's literal
image lerp without a prescreen, so that path is held at fly_lerp="image",
prescreen_stride=1 (as tests/test_torch_fly_pipeline.py holds it).

Bound (tests/test_torch_pipeline.py's): u8 maps within 1 level on >= 98 %
of each view's pixels and bad-pixel(nonocc) @1px within 0.005 of JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.models import pipeline as jpipe
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair_np,
                                                            run_pair_warm,
                                                            run_sequence_np)
from crossscalepatchmatch_tpu_torch.utils.rng import PHASE_WARM, TorchDraws
from jax_draws import JaxDraws, JaxWarmDraws, config_pair

torch.set_num_threads(1)

SMALL = dict(h=48, w=64, max_dis=12, seed=3)
WARM_ITERS = 2
PATHS = {
    "volume": dict(),
    "fly-image": dict(precompute_volume=False, fly_lerp="image",
                      prescreen_stride=1),
}


def cfgs(path):
    return config_pair(max_dis=12, dis_scale=16, wnd_size=11, max_iter=2,
                       **PATHS[path])


def frames():
    """A static scene's frames: the same geometry, new sensor noise."""
    return [(p.left, p.right) for p in (
        make_pair(**SMALL), make_pair(**SMALL, noise_sigma=2.0),
        make_pair(**SMALL, noise_sigma=1.5))]


def assert_within_bound(got, want, pair, scale):
    for v in range(2):
        d = np.abs(got[v].astype(int) - want[v].astype(int))
        assert (d <= 1).mean() >= 0.98, (v, (d <= 1).mean())
    for v, gt, ok in ((0, pair.disp_left, pair.valid_left),
                      (1, pair.disp_right, pair.valid_right)):
        b_g = bad_pixel_rate(got[v] / scale, gt, ok)
        b_w = bad_pixel_rate(want[v] / scale, gt, ok)
        assert abs(b_g - b_w) <= 0.005, (v, b_g, b_w)


@pytest.mark.parametrize("path", list(PATHS))
def test_run_pair_warm_matches_jax(path):
    jcfg, cfg = cfgs(path)
    (l0, r0), (l1, r1), _ = frames()
    prior = jpipe.run_pair_np(l0, r0, jcfg, seed=0)["abc"]
    want = jpipe.run_pair_warm(jnp.asarray(l1), jnp.asarray(r1),
                               jnp.int32(5), jnp.asarray(prior), jcfg,
                               warm_iters=WARM_ITERS)
    got = run_pair_warm(l1, r1, 5, prior, cfg, WARM_ITERS, device="cpu",
                        draws=JaxWarmDraws(5, jcfg, WARM_ITERS))
    assert got["dis"].shape == (2, 48, 64) and got["dis"].dtype == torch.uint8
    assert bool(torch.isfinite(got["cost"]).all())
    assert_within_bound(got["dis"].numpy(), np.asarray(want["dis"]),
                        make_pair(**SMALL), cfg.dis_scale)


@pytest.mark.parametrize("path", list(PATHS))
def test_run_sequence_matches_jax(path):
    """A cold frame, then warm frames seeded seed + i."""
    jcfg, cfg = cfgs(path)
    fr = frames()
    want = list(jpipe.run_sequence_np(fr, jcfg, seed=2,
                                      warm_iters=WARM_ITERS))

    def draws(i, seed):
        assert seed == 2 + i
        return (JaxDraws(seed, jcfg) if i == 0
                else JaxWarmDraws(seed, jcfg, WARM_ITERS))

    got = list(run_sequence_np(fr, cfg, seed=2, warm_iters=WARM_ITERS,
                               device="cpu", draws=draws))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_within_bound(g["dis"], w["dis"], make_pair(**SMALL),
                            cfg.dis_scale)


def test_warm_start_cost_never_worse():
    """Strict-improvement adoption: a warm start on the same frame keeps
    every pixel's cost at or below the cold run's."""
    _, cfg = cfgs("volume")
    pair = make_pair(**SMALL)
    cold = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu")
    warm = run_pair_warm(pair.left, pair.right, 1, cold["abc"], cfg, 1,
                         device="cpu")
    assert (warm["cost"].numpy() <= cold["cost"] + 1e-5).all()


def test_sequence_warm_start_holds_quality():
    """A static scene's warm frames hold the cold frame's quality; the
    same seed gives the same frames bit for bit."""
    _, cfg = cfgs("volume")
    pair = make_pair(**SMALL)
    fr = [(pair.left, pair.right)] * 3
    outs = list(run_sequence_np(fr, cfg, seed=0, warm_iters=1,
                                device="cpu"))
    bads = [bad_pixel_rate(o["dis"][0] / cfg.dis_scale, pair.disp_left,
                           pair.valid_left, 1.0) for o in outs]
    assert bads[1] <= bads[0] + 0.005, bads
    assert bads[2] <= bads[0] + 0.005, bads
    again = list(run_sequence_np(fr, cfg, seed=0, warm_iters=1,
                                 device="cpu"))
    for a, b in zip(outs, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_warm_draws_are_numbered_apart():
    """A warm iteration's refinement draws are keyed by PHASE_WARM: warm
    iteration i does not repeat cold iteration i's draws."""
    cold = TorchDraws(3, "cpu")
    warm = TorchDraws(3, "cpu", refine_phase=PHASE_WARM)
    a = cold.refine(0, 0, 0, (4, 5), 1.5, 0.05)[0]
    b = warm.refine(0, 0, 0, (4, 5), 1.5, 0.05)[0]
    assert not torch.equal(a, b)
    assert torch.equal(b, TorchDraws(3, "cpu", refine_phase=PHASE_WARM)
                       .refine(0, 0, 0, (4, 5), 1.5, 0.05)[0])
