"""The PyTorch port's ops against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(on the CPU always the jnp authority) and its port.  Tolerances, each with
its reason:
  * bgr_to_rgb: exact (a channel swap);
  * gray, Sobel and the GRD volume: max |d| <= 1e-5 (FMA contraction may
    differ between XLA:CPU and PyTorch);
  * plane algebra on the same draws: rtol 1e-6 / atol 1e-5 (divisions by
    max(|nz|, eps) amplify last-ulp differences);
  * window cost, cross-scale window cost, quadrant build and quadrant
    ranking: |d| <= 2e-5 * max(1, |ref|) (exp and the summation order
    differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.ops import color as jcolor
from crossscalepatchmatch_tpu.ops import cost_volume as jcv
from crossscalepatchmatch_tpu.ops import gradient as jgrad
from crossscalepatchmatch_tpu.ops import grad_cost as jgc
from crossscalepatchmatch_tpu.ops import plane as jplane
from crossscalepatchmatch_tpu.ops import plane_cost as jpc
from crossscalepatchmatch_tpu.ops import prescreen_volume as jpv
from crossscalepatchmatch_tpu.ops import scale_weights as jsw
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.ops import color, cost_volume, gradient
from crossscalepatchmatch_tpu_torch.ops import grad_cost, plane, plane_cost
from crossscalepatchmatch_tpu_torch.ops import prescreen_volume
from crossscalepatchmatch_tpu_torch.ops.cuda import cross_scale_cost
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_build
from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost
from jax_draws import config_pair

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them (a 3-worker
# run of these files took 13x longer with the default pool).
torch.set_num_threads(1)

SMALL = dict(h=48, w=64, max_dis=12, seed=3)
REL = 2e-5


def t(x):
    return torch.from_numpy(np.array(x))


def assert_rel(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


def assert_abs(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


# -- image primitives and the GRD volume --------------------------------------

def test_bgr_to_rgb_exact():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(color.bgr_to_rgb(t(img)).numpy(),
                                  np.asarray(jcolor.bgr_to_rgb(img)))


def test_gray_and_sobel():
    rgb = np.random.default_rng(1).integers(0, 256, (9, 13, 3)).astype(
        np.float32)
    g = color.rgb_to_gray_f32(t(rgb))
    assert_abs(g.numpy(), jcolor.rgb_to_gray_f32(jnp.asarray(rgb)))
    assert_abs(gradient.sobel_x_k1(g).numpy(),
               jgrad.sobel_x_k1(jcolor.rgb_to_gray_f32(jnp.asarray(rgb))))


@pytest.mark.parametrize("right", [False, True])
def test_grd_cost_volume(right):
    pair = make_pair(**SMALL)
    l_rgb = pair.left[..., ::-1].astype(np.float32)
    r_rgb = pair.right[..., ::-1].astype(np.float32)
    got = grad_cost.grd_cost_volume(t(l_rgb), t(r_rgb), 12, right=right)
    want = jgc.grd_cost_volume(jnp.asarray(l_rgb), jnp.asarray(r_rgb), 12,
                               right=right)
    assert got.dtype == torch.float32
    assert_abs(got.numpy(), want)


def test_build_volume_data():
    pair = make_pair(**SMALL)
    jcfg, cfg = config_pair(max_dis=12, dis_scale=16, wnd_size=11)
    got = cost_volume.build_volume_data(t(pair.left), t(pair.right), cfg)
    want = jcv.build_volume_data(jnp.asarray(pair.left),
                                 jnp.asarray(pair.right), jcfg)
    assert len(got.vols) == 1 and got.weight_imgs is got.imgs
    np.testing.assert_array_equal(got.imgs[0].numpy(),
                                  np.asarray(want.imgs[0]))
    assert_abs(got.vols[0].numpy(), want.vols[0])
    assert_abs(got.max_costs[0].numpy(), want.max_costs[0])


# -- plane algebra ---------------------------------------------------------------

def plane_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-5)


def test_plane_algebra():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(6, 7, 3)).astype(np.float32)
    n[0, :3, 2] = [1e-12, -1e-12, 0.0]          # |nz| below eps
    p = rng.uniform(0, 50, (6, 7, 3)).astype(np.float32)
    abc = jplane.params_from_normal_point(jnp.asarray(n), jnp.asarray(p))
    plane_close(plane.params_from_normal_point(t(n), t(p)), abc)
    abc_np = np.asarray(abc)
    small = abc_np.copy()
    small[0] = rng.uniform(-2, 2, (7, 3))
    plane_close(plane.normal_from_params(t(small)),
                jplane.normal_from_params(jnp.asarray(small)))
    x = rng.uniform(0, 60, (6, 7)).astype(np.float32)
    y = rng.uniform(0, 40, (6, 7)).astype(np.float32)
    d = rng.uniform(0, 12, (6, 7)).astype(np.float32)
    plane_close(plane.disparity_at(t(small), t(x), t(y)),
                jplane.disparity_at(jnp.asarray(small), x, y))
    plane_close(plane.reanchor(t(small), t(x), t(y), t(d)),
                jplane.reanchor(jnp.asarray(small), x, y, d))


def test_random_and_perturbed_planes_same_draws():
    key = jax.random.PRNGKey(4)
    shape = (2, 10, 12)
    want = jplane.random_planes(key, shape, 12.0)
    kd, kn = jax.random.split(key)
    disp = jax.random.uniform(kd, shape, jnp.float32, 1e-8, 12.0)
    normal = jax.random.normal(kn, (*shape, 3), jnp.float32)
    got = plane.random_planes(t(disp), t(normal))
    plane_close(got, want)

    k2 = jax.random.PRNGKey(9)
    z, nm = jnp.float32(3.0), jnp.float32(0.1)
    want_p = np.asarray(jplane.perturb_planes(k2, want, z, nm))
    kd, kn = jax.random.split(k2)
    dz = jax.random.uniform(kd, shape, jnp.float32, -z, z)
    dn = jax.random.uniform(kn, (*shape, 3), jnp.float32, -nm, nm)
    got_p = plane.perturb_planes(t(want), t(dz), t(dn)).numpy()
    # XLA:CPU's rsqrt is not correctly rounded (PyTorch's is), so the
    # reconstructed normals may differ by one ulp; a = -nx/nz, b = -ny/nz
    # and c amplify that by 1/|nz| of the perturbed normal.  Pixels with
    # |nz| >= 0.05 are held to the plane-algebra tolerance, the rest to
    # the same tolerance scaled by 0.05/|nz|.
    nz = np.abs(np.asarray(jplane.normal_from_params(want_p))[..., 2:])
    scale = np.maximum(1.0, 0.05 / nz)
    err = np.abs(got_p - want_p) - (1e-5 + 1e-6 * np.abs(want_p)) * scale
    assert err.max() <= 0.0, err.max()


# -- window cost (the plain version of K1) ---------------------------------------

def random_scene(h, w, d, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    vol = rng.uniform(0, 1, (h, w, d + 1)).astype(np.float32)
    return img, vol, vol.max()


def planes_from(ab, dc):
    h, w = dc.shape[-2:]
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return np.concatenate([ab, c[..., None]], axis=-1).astype(np.float32)


def check_window_cost(img, vol, mc, abc, hw, d, stride=1):
    got = plane_cost.window_plane_cost(
        t(img), t(vol), torch.tensor(mc), t(abc), half_wnd=hw, max_dis=d,
        gamma=10.0, wnd_stride=stride)
    want = jpc.window_plane_cost(
        jnp.asarray(img), jnp.asarray(vol), jnp.float32(mc),
        jnp.asarray(abc), half_wnd=hw, max_dis=d, gamma=10.0,
        wnd_stride=stride)
    assert_rel(got.numpy(), want)


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (2, 2)])
def test_window_plane_cost(k, stride):
    h, w, d, hw = 24, 40, 8, 3
    img, vol, mc = random_scene(h, w, d, seed=k)
    rng = np.random.default_rng(10 + k)
    abc = planes_from(rng.uniform(-1, 1, (k, h, w, 2)).astype(np.float32),
                      rng.uniform(0, d, (k, h, w)).astype(np.float32))
    check_window_cost(img, vol, mc, abc, hw, d, stride)


def test_window_plane_cost_slanted_plus_wild():
    """Port of tests/test_pallas.py::test_kernel_slanted_plus_wild...: a
    converged slanted field plus a whole-volume candidate, and near-zero-nz
    planes whose |dq| is far beyond the int32 range."""
    h, w, d, hw = 24, 96, 32, 2
    rng = np.random.default_rng(11)
    img, vol, mc = random_scene(h, w, d, seed=11)
    xs = np.arange(w, dtype=np.float32)
    a0 = 0.25 + rng.uniform(-0.02, 0.02, (1, h, w))
    b0 = rng.uniform(-0.03, 0.03, (1, h, w))
    dc0 = 4.0 + 0.25 * xs + rng.uniform(-0.5, 0.5, (1, h, w))
    ab1 = rng.uniform(-1, 1, (1, h, w, 2))
    dc1 = rng.uniform(0, d, (1, h, w))
    ab = np.concatenate([np.stack([a0, b0], -1), ab1]).astype(np.float32)
    dc = np.concatenate([dc0, dc1]).astype(np.float32)
    wild = rng.uniform(size=(2, h, w)) < 0.1
    ab[wild] *= np.float32(1e8)                    # nz ~ 1e-8 planes
    abc = planes_from(ab, dc)
    assert np.abs(abc[..., 0]).max() * w > 2.0 ** 31
    check_window_cost(img, vol, mc, abc, hw, d)


def test_stride_start():
    assert plane_cost.stride_start(17, 2) == jpc.stride_start(17, 2) == -17


# -- cross-scale window cost (the plain version of K4) -----------------------

def random_pyramid(h, w, max_dis, levels, seed):
    """Per-level random u8 images, f32 volumes with (max_dis >> s) + 1
    slices and their maxima, at the ceil-halved level shapes."""
    rng = np.random.default_rng(seed)
    imgs, vols, mcs = [], [], []
    for s in range(levels):
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        imgs.append(rng.integers(0, 256, (hs, ws, 3), dtype=np.uint8))
        vols.append(rng.uniform(0, 1, (hs, ws, (max_dis >> s) + 1))
                    .astype(np.float32))
        mcs.append(vols[-1].max())
    return imgs, vols, mcs


def cross_scale_planes(k, h, w, d, seed):
    """Slanted candidates over the whole disparity range plus wild
    near-zero-nz planes (|dq| far beyond int32) on a tenth of the pixels."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-1, 1, (k, h, w, 2)).astype(np.float32)
    wild = rng.uniform(size=(k, h, w)) < 0.1
    ab[wild] *= np.float32(1e8)
    return planes_from(ab, rng.uniform(-1, d + 1, (k, h, w))
                       .astype(np.float32))


@pytest.mark.parametrize("k,h,w,max_dis,levels,lam", [
    (1, 21, 27, 12, 5, 0.3),    # 12 6 3 1 0: max_dis_s <= 1 and D_s = 1
    (2, 24, 32, 6, 3, 0.3),     # 6 3 1
    (2, 17, 19, 12, 3, 0.0),    # weights (1, 0, 0)
])
def test_cross_scale_plane_cost(k, h, w, max_dis, levels, lam):
    hw = 3
    imgs, vols, mcs = random_pyramid(h, w, max_dis, levels, seed=h)
    wgts = jsw.scale_weights(levels, lam)
    abc = cross_scale_planes(k, h, w, max_dis, seed=w)
    got = plane_cost.cross_scale_plane_cost(
        [t(x) for x in imgs], [t(x) for x in vols],
        [torch.tensor(x) for x in mcs], wgts, t(abc), half_wnd=hw,
        max_dis=max_dis, gamma=10.0)
    want = jpc.cross_scale_plane_cost(
        [jnp.asarray(x) for x in imgs], [jnp.asarray(x) for x in vols],
        [jnp.float32(x) for x in mcs], wgts, jnp.asarray(abc), half_wnd=hw,
        max_dis=max_dis, gamma=10.0)
    assert got.shape == (k, h, w)
    assert_rel(got.numpy(), want)


def test_level_plane_cost_at_scale_zero_is_the_window_cost():
    img, vol, mc = random_scene(16, 20, 6, seed=4)
    abc = cross_scale_planes(2, 16, 20, 6, seed=5)
    args = (t(img), t(vol), torch.tensor(mc), t(abc))
    kw = dict(half_wnd=2, max_dis=6, gamma=10.0)
    assert torch.equal(plane_cost.level_plane_cost(*args, scale=0, **kw),
                       plane_cost.window_plane_cost(*args, **kw))


# -- quadrant volumes (the plain version of K2) and the ranking cost ------------

@pytest.mark.parametrize("stride", [1, 2])
def test_build_quadrant_volumes(stride):
    img, vol, _ = random_scene(20, 28, 6, seed=stride)
    bq, wq = prescreen_volume.build_quadrant_volumes(
        t(img), t(vol), half_wnd=3, gamma=10.0, stride=stride)
    jb, jw = jpv.build_quadrant_volumes(jnp.asarray(img), jnp.asarray(vol),
                                        half_wnd=3, gamma=10.0,
                                        stride=stride)
    assert_rel(bq.numpy(), jb)
    assert_rel(wq.numpy(), jw)


def test_quadrant_offsets_and_anchors():
    neg, pos = prescreen_volume.quadrant_offsets(17, 2)
    assert (len(neg), len(pos)) == (9, 9) and 17 not in pos
    assert prescreen_volume.quadrant_anchors(17) == jpv.quadrant_anchors(17)


def test_quadrant_prescreen_cost():
    h, w, d, hw = 20, 28, 10, 3
    img, vol, mc = random_scene(h, w, d, seed=5)
    jb, jw = jpv.build_quadrant_volumes(jnp.asarray(img), jnp.asarray(vol),
                                        half_wnd=hw, gamma=10.0, stride=2)
    rng = np.random.default_rng(6)
    abc = planes_from(rng.uniform(-0.5, 0.5, (3, h, w, 2)).astype(np.float32),
                      rng.uniform(-2, d + 2, (3, h, w)).astype(np.float32))
    got = prescreen_volume.quadrant_prescreen_cost(
        t(jb), t(jw), torch.tensor(mc), t(abc), half_wnd=hw, max_dis=d)
    want = jpv.quadrant_prescreen_cost(jb, jw, jnp.float32(mc),
                                       jnp.asarray(abc), half_wnd=hw,
                                       max_dis=d)
    assert_rel(got.numpy(), want)


# -- the kernel wrappers' dispatch ----------------------------------------------

def test_cpu_tensor_reaches_the_plain_versions():
    img, vol, mc = random_scene(12, 16, 6, seed=8)
    imgs = t(np.stack([img, img[::-1].copy()]))
    vols = t(np.stack([vol, vol[::-1].copy()]))
    mcs = vols.amax(dim=(1, 2, 3))
    abc = t(planes_from(np.zeros((2, 1, 12, 16, 2), np.float32),
                        np.full((2, 1, 12, 16), 3.5, np.float32)))
    k1_kernel, k1_plain = window_cost.launches, plane_cost.launches
    out = window_cost.window_cost(imgs, vols, mcs, abc, half_wnd=2,
                                  max_dis=6, gamma=10.0)
    assert out.shape == (2, 1, 12, 16)
    assert plane_cost.launches == k1_plain + 2
    assert window_cost.launches == k1_kernel
    k2_kernel, k2_plain = quadrant_build.launches, prescreen_volume.launches
    bq, wq = quadrant_build.quadrant_volumes(imgs, vols, half_wnd=2,
                                             gamma=10.0, stride=2)
    assert bq.shape == (2, 4, 12, 16, 7) and wq.shape == (2, 4, 12, 16)
    assert prescreen_volume.launches == k2_plain + 2
    assert quadrant_build.launches == k2_kernel
    k4_kernel, k4_plain = (cross_scale_cost.launches,
                           plane_cost.cross_scale_launches)
    out = cross_scale_cost.cross_scale_cost(
        [imgs, imgs[:, ::2, ::2].contiguous()],
        [vols, vols[:, ::2, ::2, :4].contiguous()], [mcs, mcs], [0.7, 0.3],
        abc, half_wnd=2, max_dis=6, gamma=10.0)
    assert out.shape == (2, 1, 12, 16)
    assert plane_cost.cross_scale_launches == k4_plain + 2
    assert cross_scale_cost.launches == k4_kernel


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises; here (no CUDA
    device, a meta tensor) it must raise, not fall back."""
    meta = dict(device="meta")
    imgs = torch.empty((2, 8, 8, 3), dtype=torch.uint8, **meta)
    vols = torch.empty((2, 8, 8, 5), **meta)
    abc = torch.empty((2, 1, 8, 8, 3), **meta)
    before = (plane_cost.launches, prescreen_volume.launches,
              plane_cost.cross_scale_launches)
    with pytest.raises(ValueError):
        window_cost.window_cost(imgs, vols, torch.empty(2, **meta), abc,
                                half_wnd=1, max_dis=4, gamma=10.0)
    with pytest.raises(ValueError):
        quadrant_build.quadrant_volumes(imgs, vols, half_wnd=1, gamma=10.0,
                                        stride=1)
    with pytest.raises(ValueError):
        cross_scale_cost.cross_scale_cost(
            [imgs], [vols], [torch.empty(2, **meta)], [1.0], abc,
            half_wnd=1, max_dis=4, gamma=10.0)
    assert (plane_cost.launches, prescreen_volume.launches,
            plane_cost.cross_scale_launches) == before
