"""The port's CUDA kernels K1 (window cost), K2 (quadrant build), K3 (the
strided window, volume and fly forms), K4 (cross-scale window cost), K5
(the no-volume fly cost), K6 (its image-space lerp) and K7 (its Lab
weights) against their plain PyTorch versions, on the card.

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
    with pytest.raises(ValueError):        # depth beyond the kernel's 256
        quadrant_build.quadrant_volumes_cuda(
            imgs, torch.zeros((2, 8, 12, 257), device=cuda), half_wnd=1,
            gamma=10.0, stride=1)
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
