"""The port's CUDA kernels K1 (window cost), K2 (quadrant build), K3 (the
strided window, volume and fly forms), K4 (cross-scale window cost), K5
(the no-volume fly cost), K6 (its image-space lerp) and K7 (its Lab
weights) against their plain PyTorch versions, on the card; and the entry
points (the command line, a warm start, checkpoint and resume, the
up-front refusal of a window the kernels do not take) running through
them.

Run on a machine with a CUDA device:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because tests/conftest.py imports jax, which this file does
not need.)  Whether a card is present is decided inside the `cuda` fixture,
so every worker collects the same tests; without one they skip.

Tolerances: f32 volumes |kernel - plain| <= 2e-5 * max(1, |plain|) (the
kernel keeps the plain version's rounding order, so the margin covers only
the exp/sum-order freedom the contract allows); a bf16 volume is compared
with the plain version on the same bf16-rounded values widened to f32, at
the same tolerance.  K4 is held tighter: bit-equal in f32, and bit-equal
with bf16 census volumes (integer costs, exact in bf16).  The fly kernel
(f32 throughout) is held at the f32 tolerance.
"""

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu_torch import CEN_CS_PP, README_DEMO, CSPMConfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
from crossscalepatchmatch_tpu_torch.ops import onthefly_cost, plane_cost
from crossscalepatchmatch_tpu_torch.ops import prescreen_volume
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.ops.cuda import cross_scale_cost
from crossscalepatchmatch_tpu_torch.ops.cuda import fly_cost
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_build
from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost
from crossscalepatchmatch_tpu_torch.ops.scale_weights import scale_weights

pytestmark = pytest.mark.gpu

REL_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def assert_close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
    assert err <= REL_TOL, err


def random_scene(h, w, d, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    vols = rng.uniform(0, 1, (2, h, w, d + 1)).astype(np.float32)
    return imgs, vols, vols.max(axis=(1, 2, 3))


def random_planes(k, h, w, d, seed, wild=True):
    """Candidates spanning the whole volume; with `wild`, near-zero-nz
    planes (|dq| far beyond int32) on a tenth of the pixels."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-1, 1, (2, k, h, w, 2)).astype(np.float32)
    dc = rng.uniform(0, d, (2, k, h, w)).astype(np.float32)
    if wild:
        m = rng.uniform(size=(2, k, h, w)) < 0.1
        ab[m] *= np.float32(1e8)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return np.concatenate([ab, c[..., None]], axis=-1)


def k1_both(imgs, vols, mc, abc, hw, d, dtype):
    kvols = vols.to(dtype)
    got = window_cost.window_cost_cuda(imgs, kvols, mc, abc, half_wnd=hw,
                                       max_dis=d, gamma=10.0)
    want = torch.stack([plane_cost.window_plane_cost(
        imgs[v], kvols[v].float(), mc[v], abc[v], half_wnd=hw, max_dis=d,
        gamma=10.0) for v in range(2)])
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
def test_k1_small(cuda, k, dtype):
    h, w, d, hw = 24, 40, 8, 2
    imgs, vols, mc = (torch.as_tensor(x, device=cuda)
                      for x in random_scene(h, w, d, seed=k))
    abc = torch.as_tensor(random_planes(k, h, w, d, seed=10 + k),
                          device=cuda)
    assert_close(*k1_both(imgs, vols, mc, abc, hw, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_bench_shape(cuda, dtype):
    cfg = README_DEMO
    pair = make_pair(h=375, w=450, max_dis=cfg.max_dis, seed=0)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    abc = torch.as_tensor(random_planes(2, 375, 450, cfg.max_dis, seed=5),
                          device=cuda)
    assert_close(*k1_both(vd.imgs[0], vd.vols[0], vd.max_costs[0], abc,
                          cfg.half_wnd, cfg.max_dis, dtype))


def k2_both(imgs, vols, hw, stride, dtype):
    kvols = vols.to(dtype)
    got = quadrant_build.quadrant_volumes_cuda(imgs, kvols, half_wnd=hw,
                                               gamma=10.0, stride=stride)
    parts = [prescreen_volume.build_quadrant_volumes(
        imgs[v], kvols[v].float(), half_wnd=hw, gamma=10.0, stride=stride)
        for v in range(2)]
    return got, tuple(torch.stack([p[i] for p in parts]) for i in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,stride", [(8, 1), (40, 2), (70, 2), (128, 2),
                                      (199, 2)])
def test_k2_small(cuda, d, stride, dtype):
    imgs, vols, _ = (torch.as_tensor(x, device=cuda)
                     for x in random_scene(20, 28, d, seed=d))
    (gb, gw), (wb, ww) = k2_both(imgs, vols, 3, stride, dtype)
    assert_close(gb, wb)
    assert_close(gw, ww)


def test_k2_bench_shape(cuda):
    cfg = README_DEMO
    pair = make_pair(h=375, w=450, max_dis=cfg.max_dis, seed=0)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    (gb, gw), (wb, ww) = k2_both(vd.imgs[0], vd.vols[0], cfg.half_wnd,
                                 cfg.prescreen_stride, torch.bfloat16)
    assert_close(gb, wb)
    assert_close(gw, ww)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    imgs, vols, mc = (torch.as_tensor(x, device=cuda)
                      for x in random_scene(8, 12, 4, seed=0))
    abc = torch.as_tensor(random_planes(1, 8, 12, 4, seed=0), device=cuda)
    kw = dict(half_wnd=1, max_dis=4, gamma=10.0)
    with pytest.raises(ValueError):        # non-contiguous planes
        window_cost.window_cost_cuda(imgs, vols, mc,
                                     abc.transpose(2, 3).contiguous()
                                     .transpose(2, 3), **kw)
    with pytest.raises(ValueError):        # depth != max_dis + 1
        window_cost.window_cost_cuda(imgs, vols, mc, abc, half_wnd=1,
                                     max_dis=5, gamma=10.0)
    with pytest.raises(ValueError):        # f64 volume
        window_cost.window_cost_cuda(imgs, vols.double(), mc, abc, **kw)
    with pytest.raises(ValueError):        # a window past the kernels' 64
        quadrant_build.quadrant_volumes_cuda(
            imgs, vols, half_wnd=65, gamma=10.0, stride=1)
    with pytest.raises(ValueError):        # stride 0
        window_cost.window_cost_cuda(imgs, vols, mc, abc, wnd_stride=0, **kw)


@pytest.mark.parametrize("k,stride", [(1, 2), (3, 3)])
def test_k3_volume_form(cuda, k, stride):
    h, w, d, hw = 24, 40, 8, 3
    imgs, vols, mc = (torch.as_tensor(x, device=cuda)
                      for x in random_scene(h, w, d, seed=k))
    abc = torch.as_tensor(random_planes(k, h, w, d, seed=60 + k),
                          device=cuda)
    n = window_cost.strided_launches
    got = window_cost.window_cost_cuda(imgs, vols, mc, abc, half_wnd=hw,
                                       max_dis=d, gamma=10.0,
                                       wnd_stride=stride)
    assert window_cost.strided_launches == n + 1
    want = torch.stack([plane_cost.window_plane_cost(
        imgs[v], vols[v], mc[v], abc[v], half_wnd=hw, max_dis=d, gamma=10.0,
        wnd_stride=stride) for v in range(2)])
    assert_close(got, want)


def k4_both(imgs, vols, mcs, wgts, abc, hw, d, dtype):
    kvols = [v.to(dtype) for v in vols]
    got = cross_scale_cost.cross_scale_cost_cuda(
        imgs, kvols, mcs, wgts, abc, half_wnd=hw, max_dis=d, gamma=10.0)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in imgs], [vo[v].float() for vo in kvols],
        [m[v] for m in mcs], wgts, abc[v], half_wnd=hw, max_dis=d,
        gamma=10.0) for v in range(2)])
    return got, want


def cen_levels(h, w, d, levels, cuda):
    cfg = CSPMConfig(max_dis=d, dis_scale=4, cost_method=CEN_CS_PP.cost_method,
                     use_cs=True, scale_num=levels, reg_lambda=0.3)
    pair = make_pair(h=h, w=w, max_dis=d, seed=1)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    return vd, [float(x) for x in scale_weights(levels, 0.3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2])
def test_k4_cen_bit_equal(cuda, k, dtype):
    """f32, and bf16 census volumes, bit-equal to the plain version; the
    5-level pyramid of d=12 has max_dis_s 12, 6, 3, 1, 0 (D_s = 1)."""
    h, w, d = 40, 56, 12
    vd, wgts = cen_levels(h, w, d, 5, cuda)
    abc = torch.as_tensor(random_planes(k, h, w, d, seed=20 + k),
                          device=cuda)
    got, want = k4_both(vd.imgs, vd.vols, vd.max_costs, wgts, abc, 3, d,
                        dtype)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_k4_ragged_levels(cuda):
    """An odd-sized image: every coarse level is ceil-halved, so the last
    row and column of a level serve a single fine row or column."""
    h, w, d = 37, 53, 12
    vd, wgts = cen_levels(h, w, d, 4, cuda)
    assert [tuple(v.shape[1:3]) for v in vd.vols] == [(37, 53), (19, 27),
                                                      (10, 14), (5, 7)]
    abc = torch.as_tensor(random_planes(2, h, w, d, seed=31), device=cuda)
    got, want = k4_both(vd.imgs, vd.vols, vd.max_costs, wgts, abc, 5, d,
                        torch.float32)
    assert torch.equal(got, want)


def test_k4_grd_bf16(cuda):
    """GRD volumes round in bf16; the kernel on bf16 volumes matches the
    plain version on the same rounded values, and the f32 plain version
    within bf16 rounding."""
    h, w, d = 32, 48, 12
    cfg = CSPMConfig(max_dis=d, dis_scale=4, use_cs=True, scale_num=3,
                     reg_lambda=0.3)
    pair = make_pair(h=h, w=w, max_dis=d, seed=2)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    wgts = [float(x) for x in scale_weights(3, 0.3)]
    abc = torch.as_tensor(random_planes(1, h, w, d, seed=40, wild=False),
                          device=cuda)
    got, want = k4_both(vd.imgs, vd.vols, vd.max_costs, wgts, abc, 4, d,
                        torch.bfloat16)
    assert_close(got, want)
    f32, _ = k4_both(vd.imgs, vd.vols, vd.max_costs, wgts, abc, 4, d,
                     torch.float32)
    rel = ((got - f32).abs() / f32.abs().clamp(min=1.0)).max().item()
    assert rel <= 1e-2, rel


def test_k4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    vd, wgts = cen_levels(24, 32, 12, 3, cuda)
    abc = torch.as_tensor(random_planes(1, 24, 32, 12, seed=0), device=cuda)
    kw = dict(half_wnd=2, max_dis=12, gamma=10.0)
    with pytest.raises(ValueError):        # a level's depth off by one
        cross_scale_cost.cross_scale_cost_cuda(
            vd.imgs, vd.vols, vd.max_costs, wgts, abc, half_wnd=2,
            max_dis=14, gamma=10.0)
    with pytest.raises(ValueError):        # mixed volume dtypes
        cross_scale_cost.cross_scale_cost_cuda(
            vd.imgs, [vd.vols[0].bfloat16()] + vd.vols[1:], vd.max_costs,
            wgts, abc, **kw)
    with pytest.raises(ValueError):        # one weight short
        cross_scale_cost.cross_scale_cost_cuda(
            vd.imgs, vd.vols, vd.max_costs, wgts[:2], abc, **kw)
    with pytest.raises(ValueError):        # nine levels
        cross_scale_cost.cross_scale_cost_cuda(
            vd.imgs * 3, vd.vols * 3, vd.max_costs * 3, wgts * 3, abc, **kw)


FLY_KW = dict(gamma=10.0, alpha=0.1, tau_clr=10.0, tau_grd=2.0,
              border_thres=3.0)


def fly_scene(h, w, d, levels, lab, seed, cuda):
    cfg = CSPMConfig(max_dis=d, use_cs=levels > 1, scale_num=max(levels, 2),
                     use_lab_weights=lab, precompute_volume=False)
    pair = make_pair(h=h, w=w, max_dis=d, seed=seed)
    fd = onthefly_cost.build_fly_data(torch.as_tensor(pair.left, device=cuda),
                                      torch.as_tensor(pair.right, device=cuda),
                                      cfg)
    wgts = ([float(x) for x in scale_weights(levels, 0.3)] if levels > 1
            else None)
    return fd, wgts


def fly_both(fd, wgts, abc, hw, d, lerp, stride):
    kw = dict(half_wnd=hw, max_dis=d, lerp=lerp, wnd_stride=stride, **FLY_KW)
    got = fly_cost.fly_cost_cuda(fd, wgts, abc, **kw)
    want = onthefly_cost.fly_plane_cost(fd, wgts, abc, **kw)
    return got, want


@pytest.mark.parametrize("lerp", ["cost", "image"])
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (4, 2)])
def test_fly_kernel_one_level(cuda, lerp, lab, k, stride):
    """K5 (cost), K6 (image), K7 (Lab) and K3's fly form (stride 2) on one
    level, with candidates that leave the range, warp past either border
    and (wild) overflow int32."""
    h, w, d, hw = 28, 44, 12, 3
    fd, _ = fly_scene(h, w, d, 1, lab, 5, cuda)
    abc = torch.as_tensor(random_planes(k, h, w, d, seed=70 + k), device=cuda)
    assert_close(*fly_both(fd, None, abc, hw, d, lerp, stride))


@pytest.mark.parametrize("lerp,lab", [("cost", False), ("image", True)])
def test_fly_kernel_cross_scale(cuda, lerp, lab):
    """All levels in one launch on a ragged image (ceil-halved levels);
    levels 3 and 4 have max_dis 2 and 1."""
    h, w, d, hw = 37, 53, 16, 2
    fd, wgts = fly_scene(h, w, d, 5, lab, 6, cuda)
    abc = torch.as_tensor(random_planes(2, h, w, d, seed=80), device=cuda)
    assert_close(*fly_both(fd, wgts, abc, hw, d, lerp, 1))


def test_fly_kernel_bench_shape(cuda):
    cfg = README_DEMO
    fd, _ = fly_scene(375, 450, cfg.max_dis, 1, False, 0, cuda)
    abc = torch.as_tensor(random_planes(2, 375, 450, cfg.max_dis, seed=5),
                          device=cuda)
    assert_close(*fly_both(fd, None, abc, cfg.half_wnd, cfg.max_dis, "cost",
                           1))


def test_fly_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    fd, _ = fly_scene(16, 24, 8, 1, False, 0, cuda)
    abc = torch.as_tensor(random_planes(1, 16, 24, 8, seed=0), device=cuda)
    kw = dict(half_wnd=2, max_dis=8, **FLY_KW)
    with pytest.raises(ValueError):        # image lerp with max_dis >= W
        fly_cost.fly_cost_cuda(fd, None, abc, half_wnd=2, max_dis=30,
                               lerp="image", **FLY_KW)
    with pytest.raises(ValueError):        # unknown lerp mode
        fly_cost.fly_cost_cuda(fd, None, abc, lerp="tent", **kw)
    with pytest.raises(ValueError):        # stride 0
        fly_cost.fly_cost_cuda(fd, None, abc, lerp="cost", wnd_stride=0,
                               **kw)
    with pytest.raises(ValueError):        # weights given for one level
        fly_cost.fly_cost_cuda(fd, [1.0], abc, lerp="cost", **kw)
    with pytest.raises(ValueError):        # gradients of the wrong dtype
        bad = onthefly_cost.FlyData(fd.imgs, [g.double() for g in fd.grds])
        fly_cost.fly_cost_cuda(bad, None, abc, lerp="cost", **kw)
    with pytest.raises(RuntimeError):      # over the shared-memory limit
        fly_cost.fly_cost_cuda(fd, None, abc, half_wnd=64, max_dis=8000,
                               lerp="cost", **FLY_KW)


def nan_planes(k, h, w, d, seed):
    """random_planes (out-of-range and wild candidates included) with a NaN
    plane on about 2 % of the pixels of every candidate."""
    abc = random_planes(k, h, w, d, seed)
    m = np.random.default_rng(seed + 1).uniform(size=abc.shape[:-1]) < 0.02
    abc[m] = np.nan
    return abc


MANY_KS = [1, 2, 3, 5, 8]       # candidate counts of the optimizer's batches


@pytest.mark.parametrize("levels", [1, 5])
@pytest.mark.parametrize("hw", [3, 17])
@pytest.mark.parametrize("k", MANY_KS)
def test_k4_candidates_windows_levels(cuda, k, hw, levels):
    """1 to 8 candidates, the production window and a small one, 1 and 5
    levels on a ragged image (not a multiple of the 32 x 16 tile), planes
    with NaN, out-of-range and wild dq: bit-equal to the plain version, and
    the same on a rerun."""
    h, w, d = 37, 53, 12
    vd, wgts = cen_levels(h, w, d, max(levels, 2), cuda)
    imgs, vols, mcs = (x[:levels] for x in (vd.imgs, vd.vols, vd.max_costs))
    wgts = wgts[:levels]
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=100 + k), device=cuda)
    got, want = k4_both(imgs, vols, mcs, wgts, abc, hw, d, torch.float32)
    assert_close(got, want)
    assert torch.equal(got, want)
    again, _ = k4_both(imgs, vols, mcs, wgts, abc, hw, d, torch.float32)
    assert torch.equal(got, again)


def test_pair_volume_on_the_card(cuda):
    vol = torch.rand((2, 5, 7, 9), device=cuda).to(torch.bfloat16)
    pv = cross_scale_cost.pair_volume(vol)
    assert pv.shape == (2, 5, 7, 9, 2) and pv.dtype == vol.dtype
    assert torch.equal(pv[..., 0], vol)
    assert torch.equal(pv[..., :-1, 1], vol[..., 1:])


# (half_wnd, stride, levels): the production window and a small one at
# strides 1-3, 1 and 5 levels
FLY_WINDOWS = [(3, 1, 1), (3, 2, 5), (3, 3, 1), (17, 1, 5), (17, 2, 1),
               (17, 3, 1)]
FLY_CASES = [
    (lerp, lab, k, *FLY_WINDOWS[(2 * (2 * li + bi) + 5 * ki + j) % 6])
    for li, lerp in enumerate(["cost", "image"])
    for bi, lab in enumerate([False, True])
    for ki, k in enumerate(MANY_KS) for j in (0, 3)]


@pytest.mark.parametrize("lerp,lab,k,hw,stride,levels", FLY_CASES)
def test_fly_candidates_windows_levels(cuda, lerp, lab, k, hw, stride,
                                        levels):
    """Each fly template (K5 cost, K6 image, K7 Lab) at 1 to 8 candidates,
    two window sizes, strides 1-3, 1 and 5 levels on a ragged image, planes
    with NaN, out-of-range and wild dq: within 2e-5 of the plain version,
    and the same bits on a rerun."""
    h, w, d = 37, 53, 16
    fd, wgts = fly_scene(h, w, d, levels, lab, 6, cuda)
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=200 + k), device=cuda)
    got, want = fly_both(fd, wgts, abc, hw, d, lerp, stride)
    assert_close(got, want)
    again, _ = fly_both(fd, wgts, abc, hw, d, lerp, stride)
    assert torch.equal(got, again)


def test_fly_cases_cover_the_grid():
    for i, name in enumerate(("lerp", "lab", "k", "hw", "stride", "levels")):
        seen = {c[i] for c in FLY_CASES}
        want = {"lerp": {"cost", "image"}, "lab": {False, True},
                "k": set(MANY_KS), "hw": {3, 17}, "stride": {1, 2, 3},
                "levels": {1, 5}}[name]
        assert seen == want, name
    for lerp in ("cost", "image"):
        for lab in (False, True):
            assert {c[2] for c in FLY_CASES
                    if c[:2] == (lerp, lab)} == set(MANY_KS)


@pytest.mark.parametrize("lerp,lab,hw", [("cost", False, 36),
                                         ("image", True, 32)])
def test_fly_eight_row_tile(cuda, lerp, lab, hw):
    """At max_dis 128, half_wnd 36 (32 with the Lab word): 16 tile rows of
    staging pass a block's 227 KB of shared memory, 8 rows fit, so the
    launch takes the 8-row tile."""
    h, w, d = 20, 150, 128
    fd, _ = fly_scene(h, w, d, 1, lab, 8, cuda)
    abc = torch.as_tensor(nan_planes(2, h, w, d, seed=9), device=cuda)
    assert_close(*fly_both(fd, None, abc, hw, d, lerp, 2))


def test_prepared_objects_raise_on_a_mismatch(cuda):
    fd, _ = fly_scene(16, 24, 8, 1, False, 0, cuda)
    abc = torch.as_tensor(random_planes(1, 16, 24, 8, seed=0), device=cuda)
    prep = fly_cost.prepare_fly(fd, None, half_wnd=2, max_dis=8, lerp="cost",
                                **FLY_KW)
    ok = dict(half_wnd=2, max_dis=8, levels=1)
    assert fly_cost.fly_cost_prepared(prep, abc, **ok).shape == (2, 1, 16, 24)
    for bad in (dict(ok, half_wnd=3), dict(ok, max_dis=9),
                dict(ok, levels=2)):
        with pytest.raises(ValueError):
            fly_cost.fly_cost_prepared(prep, abc, **bad)
    with pytest.raises(ValueError):        # planes of another image size
        fly_cost.fly_cost_prepared(prep, abc[:, :, :8].contiguous(), **ok)
    with pytest.raises(ValueError):        # planes on the CPU
        fly_cost.fly_cost_prepared(prep, abc.cpu(), **ok)
    vd, wgts = cen_levels(24, 32, 12, 3, cuda)
    abc = torch.as_tensor(random_planes(1, 24, 32, 12, seed=0), device=cuda)
    prep = cross_scale_cost.prepare_cross_scale(
        vd.imgs, vd.vols, vd.max_costs, wgts, half_wnd=2, max_dis=12,
        gamma=10.0)
    ok = dict(half_wnd=2, max_dis=12, levels=3)
    assert cross_scale_cost.cross_scale_cost_prepared(
        prep, abc, **ok).shape == (2, 1, 24, 32)
    for bad in (dict(ok, half_wnd=3), dict(ok, max_dis=6),
                dict(ok, levels=2)):
        with pytest.raises(ValueError):
            cross_scale_cost.cross_scale_cost_prepared(prep, abc, **bad)
    with pytest.raises(ValueError):
        cross_scale_cost.cross_scale_cost_prepared(
            prep, abc[:, :, :, :16].contiguous(), **ok)


def random_levels(h, w, d, levels, seed, cuda):
    """Per-level random u8 images, f32 volumes, the images' gray gradients
    and saturation values on ceil-halved level shapes (max_dis halves down
    to 0)."""
    rng = np.random.default_rng(seed)
    imgs, vols, mcs = [], [], []
    md = d
    for s in range(levels):
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        imgs.append(rng.integers(0, 256, (2, hs, ws, 3), dtype=np.uint8))
        vols.append(rng.uniform(0, 1, (2, hs, ws, md + 1)).astype(np.float32))
        mcs.append(vols[-1].max(axis=(1, 2, 3)))
        md //= 2
    imgs, vols, mcs = ([torch.as_tensor(x, device=cuda) for x in xs]
                       for xs in (imgs, vols, mcs))
    # the cost-lerp plain version takes the gradient from the images
    grds = [onthefly_cost.gray_gradient(im) for im in imgs]
    return imgs, vols, grds, mcs


@pytest.mark.parametrize("hw,levels,k", [(0, 1, 1), (40, 2, 1), (2, 8, 2),
                                         (1, 1, 40)])
def test_k4_edge_shapes(cuda, hw, levels, k):
    """The window of one pixel, a window wider than the image, eight levels
    down to 2 x 3 pixels and max_dis 0, and 40 candidates."""
    h, w, d = (150, 260, 12) if levels == 8 else (20, 30, 12)
    imgs, vols, _, mcs = random_levels(h, w, d, levels, 3, cuda)
    wgts = [0.5 ** (s + 1) for s in range(levels)]
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=300 + hw), device=cuda)
    got, want = k4_both(imgs, vols, mcs, wgts, abc, hw, d, torch.float32)
    assert_close(got, want)


@pytest.mark.parametrize("lerp,hw,stride,levels,k,d", [
    ("cost", 0, 1, 1, 1, 12), ("cost", 2, 7, 1, 2, 12),
    ("cost", 48, 1, 1, 1, 4), ("cost", 2, 1, 8, 2, 12),
    ("image", 2, 2, 4, 1, 12), ("image", 1, 1, 1, 40, 12)])
def test_fly_edge_shapes(cuda, lerp, hw, stride, levels, k, d):
    """The window of one pixel, a stride past the window, half_wnd 48 (only
    the 8-row tile's staging fits a block), eight levels down to 2 x 3
    pixels and max_dis 0 (four in image mode, which needs max_dis below the
    level's width), and 40 candidates."""
    h, w = (150, 260) if levels == 8 else (20, 30)
    imgs, _, grds, _ = random_levels(h, w, d, levels, 4, cuda)
    fd = onthefly_cost.FlyData(imgs=imgs, grds=grds)
    wgts = [0.5 ** (s + 1) for s in range(levels)] if levels > 1 else None
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=400 + hw), device=cuda)
    assert_close(*fly_both(fd, wgts, abc, hw, d, lerp, stride))


# (half_wnd, stride) of K1 / K3 on prepared pairs: windows of one pixel,
# a small one, the presets' and one wider than the edge images, strides 1-3
VOLUME_WINDOWS = [(0, 1), (3, 2), (17, 1), (40, 3), (3, 3), (17, 2),
                  (40, 1), (0, 2), (3, 1), (17, 3), (40, 2), (0, 3)]
VOLUME_CASES = [(k, dtype, *VOLUME_WINDOWS[(2 * ki + di + 5 * j) % 12])
                for ki, k in enumerate(MANY_KS)
                for di, dtype in enumerate(["f32", "bf16"]) for j in (0, 1)]


def prepared_scene(h, w, d, hw, dtype, seed, cuda):
    imgs, vols, mc = (torch.as_tensor(x, device=cuda)
                      for x in random_scene(h, w, d, seed))
    kvols = vols.to(dtype)
    prep = window_cost.prepare_volumes(imgs, kvols, mc, half_wnd=hw,
                                       max_dis=d, gamma=10.0)
    # the plain version on the same (bf16-rounded) values
    return prep, imgs, kvols.float(), mc


def k1_prepared_both(prep, imgs, vols, mc, abc, hw, d, stride):
    got = window_cost.window_cost_prepared(prep, abc, half_wnd=hw, max_dis=d,
                                           wnd_stride=stride)
    want = torch.stack([plane_cost.window_plane_cost(
        imgs[v], vols[v], mc[v], abc[v], half_wnd=hw, max_dis=d, gamma=10.0,
        wnd_stride=stride) for v in range(2)])
    return got, want


@pytest.mark.parametrize("k,dtype,hw,stride", VOLUME_CASES)
def test_k1_k3_prepared(cuda, k, dtype, hw, stride):
    """K1 and K3's volume form on a prepared pair at 1 to 8 candidates,
    half_wnd 0 to 40, strides 1-3, f32 and bf16 volumes, on a ragged image
    (not a multiple of the 32 x 16 tile), planes with NaN, out-of-range and
    wild dq: f32 bit-equal to the plain version, bf16 within 2e-5 of it on
    the same rounded values, the same bits on a rerun; the launch counters
    tell K1 from K3."""
    h, w, d = 37, 53, 12
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    prep, imgs, vols, mc = prepared_scene(h, w, d, hw, dt, k, cuda)
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=500 + k), device=cuda)
    n, n_strided = window_cost.launches, window_cost.strided_launches
    got, want = k1_prepared_both(prep, imgs, vols, mc, abc, hw, d, stride)
    assert window_cost.launches == n + 1
    assert window_cost.strided_launches == n_strided + (stride > 1)
    assert_close(got, want)
    if dtype == "f32":
        assert torch.equal(got, want)
    again, _ = k1_prepared_both(prep, imgs, vols, mc, abc, hw, d, stride)
    assert torch.equal(got, again)


def test_volume_cases_cover_the_grid():
    for i, name in enumerate(("k", "dtype", "hw", "stride")):
        seen = {c[i] for c in VOLUME_CASES}
        want = {"k": set(MANY_KS), "dtype": {"f32", "bf16"},
                "hw": {0, 3, 17, 40}, "stride": {1, 2, 3}}[name]
        assert seen == want, name
    for dtype in ("f32", "bf16"):
        assert {c[0] for c in VOLUME_CASES if c[1] == dtype} == set(MANY_KS)
        assert {c[2] for c in VOLUME_CASES if c[1] == dtype} == {0, 3, 17, 40}


@pytest.mark.parametrize("h,w,hw,stride,k", [
    (10, 20, 3, 1, 2),      # W < 32 and H < 16: one partial tile
    (7, 300, 17, 2, 1),     # a single partial tile row
    (100, 5, 17, 1, 3),     # W < half_wnd
    (45, 33, 2, 3, 5)])     # H not a multiple of 16, W one past a tile
def test_k1_k3_edge_shapes(cuda, h, w, hw, stride, k):
    d = 12
    prep, imgs, vols, mc = prepared_scene(h, w, d, hw, torch.float32, h,
                                          cuda)
    abc = torch.as_tensor(nan_planes(k, h, w, d, seed=600 + h), device=cuda)
    got, want = k1_prepared_both(prep, imgs, vols, mc, abc, hw, d, stride)
    assert_close(got, want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d,h,w,hw,stride", [
    (1, 20, 28, 3, 2),      # one slice (max_dis 0)
    (8, 12, 20, 17, 2),     # a tile and a window wider than the image
    (61, 40, 70, 17, 2),    # the bench depth, not a multiple of 16
    (129, 24, 40, 17, 2),   # KITTI's depth: one slice past 8 chunks
    (256, 17, 35, 3, 1),    # sixteen full chunks
    (257, 17, 35, 3, 1),    # one slice past them: any depth runs
    (300, 12, 20, 5, 2),
    (40, 30, 50, 4, 3),     # stride 3
    (24, 20, 30, 64, 3)])   # the widest window: half_wnd 64
def test_k2_prepared(cuda, d, h, w, hw, stride):
    """K2 on a prepared pair, f32: bit-equal to the plain version (bq and
    wq), and on bf16 volumes within 2e-5 of it on the same rounded values."""
    for dtype in (torch.float32, torch.bfloat16):
        prep, imgs, vols, _ = prepared_scene(h, w, d - 1, hw, dtype, d, cuda)
        n = quadrant_build.launches
        gb, gw = quadrant_build.quadrant_volumes_prepared(
            prep, half_wnd=hw, gamma=10.0, stride=stride)
        assert quadrant_build.launches == n + 1
        parts = [prescreen_volume.build_quadrant_volumes(
            imgs[v], vols[v], half_wnd=hw, gamma=10.0, stride=stride)
            for v in range(2)]
        wb, ww = (torch.stack([p[i] for p in parts]) for i in range(2))
        assert_close(gb, wb)
        assert_close(gw, ww)
        if dtype == torch.float32:
            assert torch.equal(gb, wb) and torch.equal(gw, ww)


def test_prepared_volumes_reject_what_the_kernels_do_not_take(cuda):
    imgs, vols, mc = (torch.as_tensor(x, device=cuda)
                      for x in random_scene(8, 12, 4, seed=0))
    abc = torch.as_tensor(random_planes(1, 8, 12, 4, seed=0), device=cuda)
    kw = dict(half_wnd=1, max_dis=4, gamma=10.0)
    prep = window_cost.prepare_volumes(imgs, vols, mc, **kw)
    ok = dict(half_wnd=1, max_dis=4)
    assert window_cost.window_cost_prepared(prep, abc, **ok).shape == (
        2, 1, 8, 12)
    with pytest.raises(ValueError):        # half_wnd beyond the kernels' 64
        window_cost.prepare_volumes(imgs, vols, mc, half_wnd=65, max_dis=4,
                                    gamma=10.0)
    with pytest.raises(ValueError):        # depth != max_dis + 1
        window_cost.prepare_volumes(imgs, vols, mc, half_wnd=1, max_dis=5,
                                    gamma=10.0)
    with pytest.raises(ValueError):        # f64 volume
        window_cost.prepare_volumes(imgs, vols.double(), mc, **kw)
    with pytest.raises(ValueError):        # images of another size
        window_cost.prepare_volumes(imgs[:, :4].contiguous(), vols, mc, **kw)
    for bad in (dict(ok, half_wnd=2), dict(ok, max_dis=3),
                dict(ok, wnd_stride=0)):
        with pytest.raises(ValueError):
            window_cost.window_cost_prepared(prep, abc, **bad)
    for other in (abc[:, :, :4].contiguous(), abc.cpu(),
                  abc.transpose(2, 3).contiguous().transpose(2, 3)):
        with pytest.raises(ValueError):
            window_cost.window_cost_prepared(prep, other, **ok)
    with pytest.raises(ValueError):        # f64 planes
        window_cost.window_cost_prepared(prep, abc.double(), **ok)
    qkw = dict(half_wnd=1, gamma=10.0, stride=2)
    for bad in (dict(qkw, half_wnd=2), dict(qkw, gamma=9.0),
                dict(qkw, stride=0)):
        with pytest.raises(ValueError):
            quadrant_build.quadrant_volumes_prepared(prep, **bad)
    deep = window_cost.prepare_volumes(
        imgs, torch.zeros((2, 8, 12, 257), device=cuda), None, half_wnd=1,
        max_dis=256, gamma=10.0)
    gb, gw = quadrant_build.quadrant_volumes_prepared(deep, **qkw)
    assert gb.shape == (2, 4, 8, 12, 257) and gw.shape == (2, 4, 8, 12)
    with pytest.raises(ValueError):        # prepared without max_costs
        window_cost.window_cost_prepared(deep, abc, half_wnd=1, max_dis=256)


def reset_counts():
    window_cost.launches = quadrant_build.launches = 0
    window_cost.strided_launches = 0
    cross_scale_cost.launches = 0
    fly_cost.launches.clear()
    plane_cost.launches = prescreen_volume.launches = 0
    plane_cost.cross_scale_launches = onthefly_cost.launches = 0


def test_pipeline_runs_through_the_kernels(cuda):
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11)
    reset_counts()
    out = run_pair(pair.left, pair.right, 0, cfg, device=cuda)
    torch.cuda.synchronize()
    assert out["dis"].shape == (2, 48, 64)
    assert window_cost.launches == 10 and quadrant_build.launches == 1
    assert plane_cost.launches == 0 and prescreen_volume.launches == 0


def test_cross_scale_pipeline_runs_through_the_kernels(cuda):
    """CEN + CS + PP on the default device: every exact evaluation is one
    K4 launch, the ranking one K2 build, no plain version."""
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11,
                     cost_method=CEN_CS_PP.cost_method, use_cs=True,
                     use_pp=True, reg_lambda=0.3, scale_num=3)
    reset_counts()
    out = run_pair(pair.left, pair.right, 0, cfg)
    torch.cuda.synchronize()
    assert out["dis"].device.type == "cuda"
    assert out["dis"].shape == (2, 48, 64) and out["valid"].dtype == torch.bool
    assert cross_scale_cost.launches == 10 and quadrant_build.launches == 1
    assert window_cost.launches == 0
    assert (plane_cost.launches, plane_cost.cross_scale_launches,
            prescreen_volume.launches) == (0, 0, 0)


@pytest.mark.parametrize("kw,n_fly,n_strided", [
    (dict(), 27, 12),
    (dict(use_cs=True, scale_num=3, reg_lambda=0.3, fly_lerp="image",
          use_lab_weights=True, use_pp=True), 15, 0),
])
def test_no_volume_pipeline_runs_through_the_kernels(cuda, kw, n_fly,
                                                     n_strided):
    """precompute_volume=False on the default device: 15 exact evaluations
    per pair, 12 strided prescreens single-scale (none cross-scale), all
    on the fly kernel, no plain version, no volume kernel."""
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11,
                     precompute_volume=False, **kw)
    reset_counts()
    out = run_pair(pair.left, pair.right, 0, cfg)
    torch.cuda.synchronize()
    assert out["dis"].device.type == "cuda" and out["dis"].shape == (2, 48, 64)
    assert fly_cost.count() == n_fly
    assert fly_cost.count(strided=True) == n_strided
    assert fly_cost.count(lab=True) == (n_fly if cfg.use_lab_weights else 0)
    assert (window_cost.launches, quadrant_build.launches,
            cross_scale_cost.launches) == (0, 0, 0)
    assert onthefly_cost.launches == 0 and plane_cost.launches == 0


def no_plain_version_ran():
    return (plane_cost.launches, plane_cost.cross_scale_launches,
            prescreen_volume.launches, onthefly_cost.launches) == (0, 0, 0, 0)


def test_cli_runs_on_the_card(cuda, tmp_path):
    """python -m crossscalepatchmatch_tpu_torch's main on the default
    device: K1 and K2 launch, and the maps are run_pair_np's."""
    from PIL import Image

    from crossscalepatchmatch_tpu_torch import io as cspm_io
    from crossscalepatchmatch_tpu_torch.cli import main
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np

    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    cspm_io.write_bgr(lp, pair.left)
    cspm_io.write_bgr(rp, pair.right)
    reset_counts()
    assert main([f"--l_img_file={lp}", f"--r_img_file={rp}",
                 f"--l_dis_file={tmp_path}/ld.png",
                 f"--r_dis_file={tmp_path}/rd.png", "--max_dis=12",
                 "--dis_scale=16", "--wnd_size=11"]) == 0
    assert window_cost.launches == 10 and quadrant_build.launches == 1
    assert no_plain_version_ran()
    want = run_pair_np(pair.left, pair.right,
                       CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "ld.png")), want["dis"][0])


def test_warm_start_runs_on_the_card(cuda):
    """run_pair_warm from a cold frame's planes: every evaluation on the
    kernels (no rank phase: K2 once, K1 for the rest), the cost never worse
    than the cold run's, the same seed bit-identical."""
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_warm

    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11, vol_dtype="f32")
    cold = run_pair(pair.left, pair.right, 0, cfg)
    reset_counts()
    warm = run_pair_warm(pair.left, pair.right, 1, cold["abc"], cfg, 2)
    torch.cuda.synchronize()
    assert quadrant_build.launches == 1 and window_cost.launches > 0
    assert no_plain_version_ran()
    assert bool((warm["cost"] <= cold["cost"] + 1e-5).all())
    again = run_pair_warm(pair.left, pair.right, 1, cold["abc"], cfg, 2)
    assert all(torch.equal(warm[k], again[k]) for k in warm)


def test_resume_runs_on_the_card(cuda, tmp_path):
    """run_pair_resumable on the card: uninterrupted equal to run_pair,
    and rewound to iteration 1, resumed bit-equal."""
    import crossscalepatchmatch_tpu_torch.checkpoint as ck

    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11)
    path = str(tmp_path / "state.npz")
    saved = {}
    orig = ck.save_state

    def spy(p, state, iteration, cfg2, seed):
        saved[iteration] = state
        orig(p, state, iteration, cfg2, seed)

    reset_counts()
    ck.save_state = spy
    try:
        full = ck.run_pair_resumable(pair.left, pair.right, cfg, path)
    finally:
        ck.save_state = orig
    assert window_cost.launches == 10 and quadrant_build.launches == 1
    assert no_plain_version_ran()
    plain = run_pair(pair.left, pair.right, 0, cfg)
    for k in full:
        np.testing.assert_array_equal(full[k], plain[k].cpu().numpy())
    ck.save_state(path, saved[1], 1, cfg, 0)
    resumed = ck.run_pair_resumable(pair.left, pair.right, cfg, path)
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k])


def test_card_limits_refused_before_any_work(cuda):
    """half_wnd past the kernels' 64 is refused at entry on the card."""
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    reset_counts()
    with pytest.raises(ValueError, match="half_wnd <= 64"):
        run_pair(pair.left, pair.right, 0,
                 CSPMConfig(max_dis=12, dis_scale=16, wnd_size=131))
    assert (window_cost.launches, quadrant_build.launches) == (0, 0)
