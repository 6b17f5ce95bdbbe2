"""The port's no-volume path (ops.onthefly_cost, the fly cost functions of
models.patchmatch, Lab weights) against the JAX engine, on the CPU.

The port computes the JAX engine's fused-kernel semantics on every device,
so each mode is held against the JAX function that is its authority:

  * fly_lerp="image": JAX ops.onthefly_cost.grd_fly_cost / cs_fly_cost
    (the literal GrdPC / CSPC path the JAX engine runs on the CPU), held
    against the port's fly_plane_cost(lerp="image");
  * fly_lerp="cost" (and its strided prescreen): the JAX fly Pallas kernel
    under pltpu.force_tpu_interpret_mode() (fly_plane_cost_prepared /
    cross_scale_fly_cost_prepared, as tests/test_pallas.py runs it), and
    the JAX window cost over the GRD volume saturating at fly_sat_cost.

Tolerances, each with its reason:
  * image lerp vs grd_fly_cost / cs_fly_cost: atol 1e-4, rtol 1e-5
    (measured max |d| 7e-6: the plane evaluation and the exp differ by an
    ulp between XLA:CPU and torch, and the image-space lerp multiplies that
    by 0..255 channel values);
  * plain K5 vs the interpret-mode kernel: <= 2e-5 * max(1, |ref|)
    (measured 2.2e-7: the TPU kernel's tent contraction and the two-tap
    lerp round differently);
  * bgr_to_lab_u8: at most one u8 step, on <= 1e-4 of the values
    (measured 1 of 786,432 on a random 512x512 image: torch has no cbrt,
    the port takes it in f64);
  * gray_gradient: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from crossscalepatchmatch_tpu.models import patchmatch as jpm
from crossscalepatchmatch_tpu.ops import onthefly_cost as jfly
from crossscalepatchmatch_tpu.ops.color import bgr_to_lab_u8 as j_lab
from crossscalepatchmatch_tpu.ops.cost_volume import (
    build_volume_data as j_build_volume_data)
from crossscalepatchmatch_tpu.ops.pallas import window_cost as jwc
from crossscalepatchmatch_tpu.ops.plane_cost import (
    window_plane_cost as j_window_plane_cost)
from crossscalepatchmatch_tpu.ops.pyramid import build_pyramid as j_pyramid
from crossscalepatchmatch_tpu_torch import CostMethod, CSPMConfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
from crossscalepatchmatch_tpu_torch.ops import onthefly_cost as fly
from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_lab_u8
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.ops.cuda import fly_cost as cuda_fly
from crossscalepatchmatch_tpu_torch.ops.cuda.fly_cost import fly_cost
from crossscalepatchmatch_tpu_torch.support import check_supported
from jax_draws import config_pair

# One intra-op thread (see tests/test_torch_pipeline.py).
torch.set_num_threads(1)

GAMMA = 10.0
WGTS = (0.6, 0.4)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_rel(got, want, tol=2e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()
    assert err <= tol, err


def random_imgs(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (2, h, w, 3),
                                                dtype=np.uint8)


def random_planes(k, h, w, d, seed, spread=1.0):
    """Candidates over the whole disparity range with slopes up to
    `spread`: in-range warps, saturation, and warps past either border."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-spread, spread, (2, k, h, w, 2)).astype(np.float32)
    dc = rng.uniform(0, d, (2, k, h, w)).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return np.concatenate([ab, c[..., None]], axis=-1)


def test_bgr_to_lab_u8_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    # every 15th level of each channel, so both cube-root branches and the
    # saturating corners are in
    g = np.arange(0, 256, 15, dtype=np.uint8)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 1, 3)
    for im in (img, grid):
        got = bgr_to_lab_u8(torch.from_numpy(im)).numpy()
        want = np.asarray(j_lab(jnp.asarray(im)))
        assert got.dtype == np.uint8 and got.shape == want.shape
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(),
                                                          (d > 0).mean())


def test_gray_gradient_exact():
    imgs = random_imgs(12, 20, 1)
    np.testing.assert_array_equal(
        fly.gray_gradient(torch.from_numpy(imgs)).numpy(),
        np.asarray(jfly.gray_gradient(jnp.asarray(imgs))))


def test_handle_border():
    x = torch.tensor([-7, -1, 0, 6, 7, 13])
    np.testing.assert_array_equal(
        fly._handle_border(x, 7).numpy(),
        np.asarray(jfly._handle_border(jnp.asarray(x.numpy()), 7)))


def image_fly_data(pyrs, grds, wgts):
    """FlyData of the JAX package's per-view level lists, both views
    stacked per level."""
    def stack(xs):
        return [torch.stack([t(xs[0][s]), t(xs[1][s])])
                for s in range(len(xs[0]))]
    return fly.FlyData(imgs=stack(pyrs), grds=stack(grds),
                       wimgs=None if wgts is None else stack(wgts))


@pytest.mark.parametrize("lab", [False, True])
def test_grd_fly_cost_matches_jax(lab):
    """fly_plane_cost(lerp="image") on one level (the plain K6, K7 with Lab)
    against JAX grd_fly_cost, per view."""
    h, w, d, hw = 24, 40, 8, 2
    imgs = random_imgs(h, w, 11)
    abc = random_planes(3, h, w, d, 12)
    grd = jfly.gray_gradient(jnp.asarray(imgs))
    wgt = np.asarray(j_lab(jnp.asarray(imgs))) if lab else None
    kw = dict(half_wnd=hw, max_dis=d, gamma=GAMMA)
    fd = image_fly_data([[imgs[0]], [imgs[1]]], [[grd[0]], [grd[1]]],
                        None if wgt is None else [[wgt[0]], [wgt[1]]])
    got = fly.fly_plane_cost(fd, None, t(abc), lerp="image", **kw)
    for v in range(2):
        want = jfly.grd_fly_cost(
            imgs[v], imgs[1 - v], grd[v], grd[1 - v], abc[v],
            sign=2 * v - 1, ref_wgt=None if wgt is None else wgt[v], **kw)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lab", [False, True])
def test_cs_fly_cost_matches_jax(lab):
    """fly_plane_cost(lerp="image") over two levels (the plain cross-scale
    K6) against JAX cs_fly_cost, per view (level 0 has the shapes of
    test_grd_fly_cost_matches_jax, so the eager JAX ops compiled there are
    reused)."""
    h, w, d, hw = 24, 40, 8, 2
    imgs = random_imgs(h, w, 13)
    abc = random_planes(3, h, w, d, 14, spread=0.5)
    pyr = [j_pyramid(jnp.asarray(imgs[v]), 2) for v in range(2)]
    grd = [[jfly.gray_gradient(im) for im in p] for p in pyr]
    wgt = [[j_lab(im) for im in p] for p in pyr] if lab else None
    kw = dict(half_wnd=hw, max_dis=d, gamma=GAMMA)
    got = fly.fly_plane_cost(image_fly_data(pyr, grd, wgt), WGTS, t(abc),
                             lerp="image", **kw)
    for v in range(2):
        want = jfly.cs_fly_cost(
            pyr[v], pyr[1 - v], grd[v], grd[1 - v], WGTS, abc[v],
            sign=2 * v - 1, pyr_wgt_ref=None if wgt is None else wgt[v], **kw)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def fly_data(imgs, levels, lab):
    cfg = CSPMConfig(max_dis=8, use_cs=levels > 1, scale_num=max(levels, 2),
                     use_lab_weights=lab, precompute_volume=False)
    return fly.build_fly_data(t(imgs[0]), t(imgs[1]), cfg)


@pytest.mark.parametrize("stride,lab", [(1, False), (2, False), (2, True)])
def test_plain_k5_matches_fly_kernel_interpret(stride, lab):
    """The plain version of K5 (K3 at stride 2, K7 with Lab) against the
    JAX fly kernel itself, one level."""
    h, w, d, hw = 16, 40, 8, 2
    imgs = random_imgs(h, w, 20 + stride)
    abc = random_planes(2, h, w, d, 30 + stride)
    def jax_fly(imgs, abc, wimgs):
        prep = jwc.prepare_fly(imgs, half_wnd=hw, max_dis=d, th=8, tw=128,
                               wgt_imgs_u8=wimgs)
        return jwc.fly_plane_cost_prepared(
            prep, abc, half_wnd=hw, max_dis=d, gamma=GAMMA, th=8, tw=128,
            wnd_stride=stride)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax_fly)(jnp.asarray(imgs), jnp.asarray(abc),
                                j_lab(jnp.asarray(imgs)) if lab else None)
    got = fly.fly_plane_cost(fly_data(imgs, 1, lab), None, t(abc),
                             half_wnd=hw, max_dis=d, gamma=GAMMA,
                             wnd_stride=stride)
    assert_rel(got.numpy(), want)


@pytest.mark.parametrize("lab", [False, True])
def test_plain_cross_scale_k5_matches_fly_kernel_interpret(lab):
    h, w, d, hw = 24, 48, 12, 2
    imgs = random_imgs(h, w, 40)
    abc = random_planes(1, h, w, d, 41, spread=0.5)
    pyr = [j_pyramid(jnp.asarray(imgs[v]), 2) for v in range(2)]
    ims = [jnp.stack([pyr[0][s], pyr[1][s]]) for s in range(2)]
    def jax_fly(ims, abc, wimgs):
        preps = jwc.prepare_cross_scale_fly(
            ims, half_wnd=hw, max_dis=d, th=8, tw=128, vd_wgt_imgs=wimgs)
        return jwc.cross_scale_fly_cost_prepared(
            preps, WGTS, abc, half_wnd=hw, max_dis=d, gamma=GAMMA, th=8,
            tw=128)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax_fly)(ims, jnp.asarray(abc),
                                [j_lab(im) for im in ims] if lab else None)
    cfg = CSPMConfig(max_dis=d, use_cs=True, scale_num=2,
                     use_lab_weights=lab, precompute_volume=False)
    fd = fly.build_fly_data(t(imgs[0]), t(imgs[1]), cfg)
    got = fly.fly_plane_cost(fd, WGTS, t(abc), half_wnd=hw, max_dis=d,
                             gamma=GAMMA)
    assert_rel(got.numpy(), want)


def test_flat_scene_saturates_at_fly_sat_cost():
    """Identical flat views: every in-image GRD volume entry is 0, so
    max(volume) would not saturate there (0 < 2.8); the fly path saturates
    at alpha*tau_clr + (1-alpha)*tau_grd.  Out-of-range planes then cost
    (window pixels in the image) x fly_sat_cost exactly."""
    h, w, d, hw = 10, 16, 6, 2
    imgs = np.full((2, h, w, 3), 77, np.uint8)
    abc = np.zeros((2, 2, h, w, 3), np.float32)
    abc[:, 0, ..., 2] = -3.0          # dq < 1 everywhere: saturates
    abc[:, 1, ..., 2] = 2.5           # in range everywhere
    sat = fly.fly_sat_cost(0.1, 10.0, 2.0)
    assert sat == pytest.approx(2.8)
    got = fly.fly_plane_cost(fly_data(imgs, 1, False), None, t(abc),
                             half_wnd=hw, max_dis=d, gamma=GAMMA).numpy()
    ny = np.array([min(h, y + hw + 1) - max(0, y - hw) for y in range(h)])
    nx = np.array([min(w, x + hw + 1) - max(0, x - hw) for x in range(w)])
    np.testing.assert_allclose(got[:, 0], np.broadcast_to(
        np.float32(sat) * (ny[:, None] * nx[None, :]), (2, h, w)), rtol=1e-6)
    # in range: 0 wherever the shifted column stays inside the image (the
    # border pseudo-cost stands in beyond it)
    assert (got[0, 1][:, hw + 3:] == 0).all()
    assert (got[1, 1][:, :w - hw - 3] == 0).all()
    assert (got[0, 1][:, :3] > 0).all()
    # the JAX volume window cost agrees only when handed fly_sat_cost
    jcfg = config_pair(max_dis=d, wnd_size=2 * hw + 1)[0]

    @jax.jit
    def jax_flat(l, r, abc):
        jvd = j_build_volume_data(l, r, jcfg)
        return (jnp.max(jvd.vols[0][0][:, d:]),
                j_window_plane_cost(jvd.imgs[0][0], jvd.vols[0][0],
                                    jnp.float32(sat), abc, half_wnd=hw,
                                    max_dis=d, gamma=GAMMA))

    vol_max, want = jax_flat(imgs[0], imgs[1], abc[0])
    # columns x >= d see the other view at every disparity: cost 0 there
    assert float(vol_max) == 0.0
    assert_rel(got[0], want)


@pytest.mark.parametrize("lab", [False, True])
def test_fly_cost_fns_match_jax_window_path(lab):
    """make_fly_cost_fns (cost mode) against the JAX engine's volume path
    with the window prescreen and max_costs set to fly_sat_cost: the
    function the JAX engine's fused fly kernels compute, exact and strided
    (K5 and K3)."""
    kw = dict(max_dis=12, dis_scale=16, wnd_size=7, use_lab_weights=lab)
    jcfg = config_pair(prescreen_mode="window", **kw)[0]
    cfg = config_pair(precompute_volume=False, **kw)[1]
    pair = make_pair(h=24, w=32, max_dis=12, seed=4)

    @jax.jit
    def jax_costs(l, r, abc):
        jvd = j_build_volume_data(l, r, jcfg)
        sat = jnp.float32(jwc.fly_sat_cost(0.1, 10.0, 2.0))
        jvd.max_costs = [jnp.stack([sat, sat]) for _ in jvd.max_costs]
        jcost, jsparse = jpm.make_cost_fns(jcfg, jvd)
        return jcost(abc), jsparse(abc)

    fd = fly.build_fly_data(t(pair.left), t(pair.right), cfg)
    cost_fn, sparse_fn = pm.make_fly_cost_fns(cfg, fd)
    abc = random_planes(3, 24, 32, 12, 5, spread=0.3)
    want_cost, want_sparse = jax_costs(pair.left, pair.right, abc)
    assert_rel(cost_fn(t(abc)).numpy(), want_cost)
    assert_rel(sparse_fn(t(abc)).numpy(), want_sparse)


@pytest.mark.parametrize("lab", [False, True])
def test_volume_window_prescreen_matches_jax(lab):
    """prescreen_mode="window" on the volume path: the sparse evaluator is
    the window cost at stride prescreen_stride (K3's volume form), with
    the Lab weight images when use_lab_weights."""
    jcfg, cfg = config_pair(max_dis=12, dis_scale=16, wnd_size=7,
                            prescreen_mode="window", use_lab_weights=lab)
    pair = make_pair(h=24, w=32, max_dis=12, seed=6)

    @jax.jit
    def jax_costs(l, r, abc):
        jcost, jsparse = jpm.make_cost_fns(
            jcfg, j_build_volume_data(l, r, jcfg))
        return jcost(abc), jsparse(abc)

    vd = build_volume_data(t(pair.left), t(pair.right), cfg)
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
    abc = random_planes(3, 24, 32, 12, 7, spread=0.3)
    want_cost, want_sparse = jax_costs(pair.left, pair.right, abc)
    assert_rel(cost_fn(t(abc)).numpy(), want_cost)
    assert_rel(sparse_fn(t(abc)).numpy(), want_sparse)


def test_fly_cost_fns_options():
    """sparse_fn exists for single-scale prescreen_stride > 1 only, and the
    no-volume run is all-exact (no quadrant ranking without a volume)."""
    pair = make_pair(h=16, w=24, max_dis=8, seed=0)
    l, r = t(pair.left), t(pair.right)
    for kw, has_sparse in ((dict(), True), (dict(prescreen_stride=1), False),
                           (dict(use_cs=True, scale_num=2), False)):
        cfg = CSPMConfig(max_dis=8, precompute_volume=False, **kw)
        assert cfg.rank_iters == 0
        _, sparse_fn = pm.make_fly_cost_fns(cfg, fly.build_fly_data(l, r, cfg))
        assert (sparse_fn is not None) == has_sparse


def test_fly_launch_count_by_variant():
    """The fly kernel's one counter, keyed (lerp, lab, strided), read per
    kernel: K5 cost lerp, K6 image lerp, K7 Lab, K3 strided."""
    saved = cuda_fly.launches.copy()
    try:
        cuda_fly.launches.clear()
        cuda_fly.launches.update({("cost", False, False): 3,
                                  ("cost", True, True): 2,
                                  ("image", True, False): 1})
        assert cuda_fly.count() == 6
        assert cuda_fly.count(lerp="cost") == 5
        assert cuda_fly.count(lerp="image") == 1
        assert cuda_fly.count(lab=True) == 3
        assert cuda_fly.count(strided=True) == 2
        assert cuda_fly.count(lerp="image", strided=True) == 0
    finally:
        cuda_fly.launches.clear()
        cuda_fly.launches.update(saved)


def test_fly_cost_wrapper_takes_the_plain_version_on_the_cpu():
    h, w, d, hw = 12, 24, 6, 1
    imgs = random_imgs(h, w, 50)
    abc = t(random_planes(2, h, w, d, 51))
    fd = fly_data(imgs, 1, True)
    kw = dict(half_wnd=hw, max_dis=d, gamma=GAMMA, alpha=0.1, tau_clr=10.0,
              tau_grd=2.0, border_thres=3.0)
    for lerp in ("cost", "image"):
        n = fly.launches
        got = fly_cost(fd, None, abc, lerp=lerp, wnd_stride=2, **kw)
        assert fly.launches == n + 1
        assert torch.equal(got, fly.fly_plane_cost(fd, None, abc, lerp=lerp,
                                                   wnd_stride=2, **kw))
    with pytest.raises(ValueError):
        fly.fly_plane_cost(fd, None, abc, lerp="tent", **kw)


def test_volume_data_lab_weight_images():
    pair = make_pair(h=16, w=24, max_dis=8, seed=1)
    cfg = CSPMConfig(max_dis=8, use_cs=True, scale_num=2,
                     use_lab_weights=True)
    vd = build_volume_data(t(pair.left), t(pair.right), cfg)
    assert len(vd.wimgs) == 2 and vd.weight_imgs is vd.wimgs
    for s in range(2):
        torch.testing.assert_close(vd.wimgs[s], bgr_to_lab_u8(vd.imgs[s]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    dict(precompute_volume=False),
    dict(precompute_volume=False, use_cs=True),
    dict(precompute_volume=False, fly_lerp="image", use_lab_weights=True),
    dict(use_lab_weights=True),
    dict(prescreen_mode="window", adopt_mode="exact"),
    dict(prescreen_mode="window", use_cs=True, cost_method=CostMethod.CEN),
])
def test_check_supported_accepts_the_no_volume_slice(kw):
    # the card's limits, checked without a card: a CUDA device is named,
    # nothing runs there
    check_supported(CSPMConfig(**kw), (375, 450), "cuda")
