"""The port's post-processing (models.postprocess) against the JAX
package's, on the CPU, on the same inputs.

Tolerances:
  * lr_check, fill_invalid: exact (integer and comparison arithmetic; the
    fill's plane extrapolation is the same f32 expression);
  * weighted_median and postprocess: exact when the port's weight table
    holds XLA:CPU's own exp values; with PyTorch's exp (which differs from
    XLA:CPU's in the last ulp at some of the 766 integer L1 distances) at
    most 1 level on at most 0.5 % of the replaced pixels, the one freedom
    allowed;
  * kernel WMF's order (the 16-ary search of sequential sums;
    csrc/weighted_median.cu), and the bisection it replaced, against the
    plain weighted median, both in plain torch: exact (u8), ties included.
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


# -- the weighted-median kernel's order (csrc/weighted_median.cu), on the CPU

# the kernel's search: 16 thresholds a pass (csrc/weighted_median.cu
# kArity); "bisection" is the order of the kernel's first form (a total,
# then 8 single-threshold passes)
SEARCHES = ["bisection", 16]


def kernel_order_median(dis, imgs, valid, cfg, search=16, center_row0=0,
                        out_h=None, center_col0=0, out_w=None):
    """The weighted median in kernel WMF's order, in plain torch.  Every
    S(t) is one sequential f32 sum over the window in dy-major order,
    adding lut[L1] only where q lies in the array, is valid and has dis_q
    <= t (an invalid q carries key 256).  search="bisection": one pass
    forms the total S(255), then 8 bisection passes each form S(mid).
    search=m: pass 1 forms S(t) at the m bucket ends 256/m - 1, ...,
    255 (S(255) gives half); each later pass forms the m - 1 sums inside
    the first bucket whose end reaches half, until the bucket is one
    level wide."""
    _, h, w = dis.shape
    oh = h if out_h is None else out_h
    ow = w if out_w is None else out_w
    hw = cfg.wnd_size // 2
    lut = pp.asw_lut(cfg.wmf_gamma, "cpu")
    key = torch.where(valid, dis.to(torch.int64), 256)
    img = imgs.to(torch.int64)
    out = dis[:, center_row0:center_row0 + oh,
              center_col0:center_col0 + ow].clone()
    for v in range(2):
        ys, xs = torch.nonzero(~valid[v, center_row0:center_row0 + oh,
                                      center_col0:center_col0 + ow],
                               as_tuple=True)
        py, px = ys + center_row0, xs + center_col0
        center = img[v, py, px]

        def window_sum(t):
            s = torch.zeros(len(py), dtype=torch.float32)
            for dy in range(-hw, hw + 1):
                for dx in range(-hw, hw + 1):
                    qy, qx = py + dy, px + dx
                    inside = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
                    qy, qx = qy.clamp(0, h - 1), qx.clamp(0, w - 1)
                    take = inside & (key[v, qy, qx] <= t)
                    l1 = (img[v, qy, qx] - center).abs().sum(-1)
                    s = torch.where(take, s + lut[l1], s)
            return s

        if search == "bisection":
            half = window_sum(torch.full((len(py),), 255)) * 0.5
            lo = torch.zeros(len(py), dtype=torch.int64)
            hi = torch.full((len(py),), 255)
            for _ in range(8):
                mid = (lo + hi) >> 1
                ge = window_sum(mid) >= half
                lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid,
                                                                    hi)
        else:
            width = 256 // search
            ends = [window_sum(torch.full((len(py),), (j + 1) * width - 1))
                    for j in range(search)]
            half = ends[-1] * 0.5
            # the first bucket whose end reaches half (the last one does)
            lo = torch.full((len(py),), (search - 1) * width)
            for j in reversed(range(search - 1)):
                lo = torch.where(ends[j] >= half, j * width, lo)
            while width > 1:
                sub = width // search
                sums = [window_sum(lo + (m + 1) * sub - 1)
                        for m in range(search - 1)]
                step = torch.full((len(py),), search - 1)
                for m in reversed(range(search - 1)):
                    step = torch.where(sums[m] >= half, m, step)
                lo, width = lo + step * sub, sub
        rep = half > 0
        out[v, ys[rep], xs[rep]] = lo[rep].to(torch.uint8)
    return out


def tie_scene(h, w, seed, invalid_share, levels=4, colours=2):
    """u8 maps of a few disparity levels over images of a few colours, so
    that many weights are equal and S(t) often lands exactly on half the
    total; `invalid_share` of the pixels invalid."""
    rng = np.random.default_rng(seed)
    dis = rng.integers(0, levels, (2, h, w)).astype(np.uint8) * 60
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    imgs = palette[rng.integers(0, colours, (2, h, w))]
    valid = rng.uniform(size=(2, h, w)) >= invalid_share
    return (torch.from_numpy(dis), torch.from_numpy(np.ascontiguousarray(
        imgs)), torch.from_numpy(valid))


def median_cfg(wnd):
    return config_pair(max_dis=12, dis_scale=8, wnd_size=wnd)[1]


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("wnd", [3, 11, 35])
@pytest.mark.parametrize("kind", ["ties", "random"])
def test_kernel_order_equals_plain_weighted_median(wnd, kind, search):
    """The kernel's order (the 16-ary search of sequential sums, and the
    bisection it replaced) picks the plain version's t at every pixel, on
    scenes with many exact ties of S(t) and on random ones."""
    if kind == "ties":
        dis, imgs, valid = tie_scene(18, 22, wnd, 0.4)
    else:
        rng = np.random.default_rng(wnd)
        dis = torch.from_numpy(rng.integers(0, 256, (2, 18, 22),
                                            dtype=np.uint8))
        imgs = torch.from_numpy(rng.integers(0, 256, (2, 18, 22, 3),
                                             dtype=np.uint8))
        valid = torch.from_numpy(rng.uniform(size=(2, 18, 22)) >= 0.3)
    cfg = median_cfg(wnd)
    want = pp.weighted_median_plain(dis, imgs, valid, cfg)
    got = kernel_order_median(dis, imgs, valid, cfg, search)
    assert torch.equal(got, want)
    assert torch.equal(pp.weighted_median(dis, imgs, valid, cfg), want)
    assert (want != dis).any()                 # it replaced pixels


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("case", ["none_invalid", "all_invalid",
                                  "zero_total"])
def test_kernel_order_edge_masks(case, search):
    """No invalid pixel (nothing replaced), every pixel invalid (every total
    0: nothing replaced) and invalid pixels whose window holds no valid
    pixel (a zero total: kept) beside replaced ones."""
    dis, imgs, valid = tie_scene(16, 20, 7, 0.3)
    if case == "none_invalid":
        valid[:] = True
    elif case == "all_invalid":
        valid[:] = False
    else:
        valid[:, :7, :7] = False               # a 3x3 window sees none
    cfg = median_cfg(3)
    want = pp.weighted_median_plain(dis, imgs, valid, cfg)
    assert torch.equal(kernel_order_median(dis, imgs, valid, cfg, search),
                       want)
    if case == "zero_total":
        assert torch.equal(want[:, 1:6, 1:6], dis[:, 1:6, 1:6])
        assert (want != dis).any()
    else:
        assert torch.equal(want, dis)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("wnd", [3, 11])
def test_kernel_order_band_form(wnd, search):
    """The band arguments as parallel.tiled passes them: a tile's block with
    its half-window halo, rows above the global image invalid, the output
    the block's centre (odd origin, columns extended too)."""
    hw, hs, ws = wnd // 2, 9, 13
    dis, imgs, valid = tie_scene(hs + 2 * hw, ws + 2 * hw, 11, 0.35)
    valid[:, :hw] = False                      # rows past the global image
    kw = dict(center_row0=hw, out_h=hs, center_col0=hw, out_w=ws)
    cfg = median_cfg(wnd)
    want = pp.weighted_median_plain(dis, imgs, valid, cfg, **kw)
    assert want.shape == (2, hs, ws)
    assert torch.equal(kernel_order_median(dis, imgs, valid, cfg, search,
                                           **kw), want)
    assert torch.equal(pp.weighted_median(dis, imgs, valid, cfg, **kw), want)


def test_cpu_run_never_calls_the_kernel(scene):
    """Post-processing on CPU tensors takes the plain weighted median: the
    kernel's counter stays 0."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median
    from crossscalepatchmatch_tpu_torch.utils import profiling

    profiling.reset_launch_counts()
    pp.postprocess(scene["dis"], scene["abc"], scene["imgs"], scene["cfg"])
    counts = profiling.launch_counts()
    assert counts["wmf"] == weighted_median.launches == 0
    assert counts["wmf_plain"] == pp.plain_launches == 1


def test_wmf_wrapper_checks_without_a_card():
    """The kernel's wrapper raises on a dtype, a shape or an output window
    it does not take, and on tensors off the card, before any launch."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median as wmf

    dis, imgs, valid = tie_scene(8, 10, 1, 0.3)
    lut = pp.asw_lut(10.0, "cpu")
    n = wmf.launches
    cases = [
        ((dis.to(torch.int32), imgs, valid, lut), {}, "dis: dtype"),
        ((dis, imgs.float(), valid, lut), {}, "imgs: dtype"),
        ((dis, imgs, valid.to(torch.uint8), lut), {}, "valid: dtype"),
        ((dis, imgs, valid, lut.double()), {}, "lut: dtype"),
        ((dis[0], imgs, valid, lut), {}, "dis: shape"),
        ((dis, imgs[:, :, :9], valid, lut), {}, "imgs: shape"),
        ((dis, imgs, valid[:1], lut), {}, "valid: shape"),
        ((dis, imgs, valid, lut[:10]), {}, "lut: shape"),
        ((dis, imgs, valid, lut), dict(half_wnd=-1), "half_wnd"),
        ((dis, imgs, valid, lut), dict(center_row0=2, out_h=7),
         "output window"),
        ((dis, imgs, valid, lut), dict(center_col0=-1, out_w=4),
         "output window"),
        ((dis, imgs, valid, lut), {}, "expected a CUDA tensor"),
    ]
    for args, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            wmf.weighted_median_cuda(*args, **{"half_wnd": 1, **kw})
    # the dispatcher sends a tensor on neither the CPU nor the card there
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pp.weighted_median(dis.to("meta"), imgs.to("meta"),
                           valid.to("meta"), median_cfg(3))
    assert wmf.launches == n
