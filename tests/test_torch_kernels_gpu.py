"""The port's CUDA kernels K1 (window cost), K2 (quadrant build), K3 (the
strided window, volume and fly forms), K4 (cross-scale window cost), K5
(the no-volume fly cost), K6 (its image-space lerp), K7 (its Lab
weights), WMF (the weighted median of post-processing), GRDV (the GRD
cost volume), CENV (the census volume), QRANK (the quadrant ranking),
RPROP (a refinement stage's proposal) and BFV (the bilateral volume
filter) against their plain PyTorch versions, on the card, at small
shapes and at the bench and KITTI ones, whole and in band form (a
kernel's tests carry its key in their names, `fly` for K5, K3's fly form,
K6 and K7); the launches of a call (a CUDA graph's nodes); the main paths
at their real size (bad-pixel gates, bit-identical reruns, each kernel's
launches a pair exactly and no plain version);
small pairs on the card against the CPU; and the entry points (the
command line, a warm start, checkpoint and resume, the up-front refusal
of a window the kernels do not take, the sharded paths on one rank and
on six gloo ranks sharing the card) running through them.  The kernels'
times and bounds are tools/torch_kernel_ab.py's, and so is the bench
tile the band forms are held on (bench_tile).

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
(f32 throughout) is held at the f32 tolerance.  WMF's u8 maps are held
equal to its plain version's, pixel for pixel; GRDV's and CENV's volumes and
QRANK's costs to their plain versions' on the card, element for element;
RPROP's candidates likewise, bit for bit (NaN where both are NaN).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu_torch import (CEN_CS_PP, KITTI, README_DEMO,
                                            CSPMConfig)
from crossscalepatchmatch_tpu_torch.config import Aggregator, CostMethod
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models import postprocess
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
from crossscalepatchmatch_tpu_torch.ops import census, grad_cost, onthefly_cost
from crossscalepatchmatch_tpu_torch.ops import plane_cost, prescreen_volume
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.ops.cuda import census_volume
from crossscalepatchmatch_tpu_torch.ops.cuda import cross_scale_cost
from crossscalepatchmatch_tpu_torch.ops.cuda import fly_cost, grd_volume
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_build
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_rank
from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median as wmf
from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost
from crossscalepatchmatch_tpu_torch.ops.scale_weights import scale_weights
from crossscalepatchmatch_tpu_torch.utils.profiling import (
    launch_counts, reset_launch_counts as reset_counts)

pytestmark = pytest.mark.gpu

_spec = importlib.util.spec_from_file_location(
    "torch_kernel_ab", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_kernel_ab.py"))
kernel_ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_ab)     # at import: nothing of the package
bench_tile = kernel_ab.bench_tile

REL_TOL = 2e-5
BENCH = dict(h=375, w=450, max_dis=60)          # the bench scene
KITTI_SCENE = dict(h=375, w=1242, max_dis=128)
BAD_PIXEL_MAX = 0.01        # left view, non-occluded, a main path's seed

# The kernels a path launches: GRD volumes (GRDV) ranked on the quadrant
# volumes (K2, QRANK) with K1 exact; census volumes (CENV) with K4
GRD_PATH = ("k1", "k2", "grdv", "qrank")
CEN_CS_PATH = ("k4", "k2", "qrank", "cenv")
# a main path's launches a pair by kernel (utils.profiling.launch_counts();
# "fly" every fly launch): 10 exact evaluations, the ranking's one K2 build
# and 14 QRANK calls, one volume call a level, 6 refinement stages, one
# median with post-processing; without a volume 27 fly evaluations and 12
# strided prescreens, in cost-lerp mode (K5) or PatchMatch Stereo's image
# lerp (K6, at stride 2 its own prescreen)
GRD_LAUNCHES = dict(k1=10, k2=1, grdv=1, qrank=14, rprop=6)
CEN_CS_PP_LAUNCHES = dict(k4=10, k2=1, qrank=14, cenv=5, rprop=6, wmf=1)
FLY_LAUNCHES = dict(k5=27, fly=27, k3_fly=12, rprop=6)
FLY_IMAGE_LAUNCHES = dict(k6=27, fly=27, k3_fly=12, rprop=6)


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


def assert_path_launched(counts, kernels):
    """Every kernel of a path launched, and RPROP (every path refines), and
    no plain version (launch_counts()' *_plain keys)."""
    assert all(counts[k] > 0 for k in (*kernels, "rprop")), counts
    assert not any(n for k, n in counts.items() if k.endswith("_plain")), \
        counts


def assert_launches(counts, per_pair, pairs):
    """Each kernel launched exactly per_pair[k] times a pair, and nothing
    else: no other kernel, no plain version."""
    assert counts == {k: per_pair.get(k, 0) * pairs for k in counts}, counts


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_kitti_shape(cuda, dtype):
    """K1 (K = 1) and K2 on the KITTI scene's 129 slices (375 x 1242,
    max_dis 128), against their plain versions on the same (rounded)
    volume."""
    pair = make_pair(seed=0, **KITTI_SCENE)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), KITTI)
    abc = torch.as_tensor(random_planes(1, 375, 1242, 128, seed=9),
                          device=cuda)
    assert_close(*k1_both(vd.imgs[0], vd.vols[0], vd.max_costs[0], abc,
                          KITTI.half_wnd, 128, dtype))
    (gb, gw), (wb, ww) = k2_both(vd.imgs[0], vd.vols[0], KITTI.half_wnd,
                                 KITTI.prescreen_stride, dtype)
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


def test_k4_bench_shape(cuda):
    """K4 over the bench scene's 5 CEN_CS_PP census levels, against one
    plain call on 8 candidates (the plain version takes each candidate on
    its own, so its first k costs are a K = k call's): the first 1, 2, 3,
    5 and 8 within 2e-5 on f32 volumes, the first 2 on bf16 census volumes
    (integers, exact in bf16) bit-equal to the f32 plain costs."""
    cfg = CEN_CS_PP
    pair = make_pair(seed=0, **BENCH)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    wgts = [float(x) for x in scale_weights(cfg.scale_num, cfg.reg_lambda)]
    abc = torch.as_tensor(random_planes(8, 375, 450, 60, seed=8),
                          device=cuda)
    kw = dict(half_wnd=cfg.half_wnd, max_dis=60, gamma=cfg.wgt_gamma)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in vd.imgs], [vo[v] for vo in vd.vols],
        [m[v] for m in vd.max_costs], wgts, abc[v], **kw) for v in range(2)])
    for k in MANY_KS:
        assert_close(cross_scale_cost.cross_scale_cost_cuda(
            vd.imgs, vd.vols, vd.max_costs, wgts, abc[:, :k].contiguous(),
            **kw), want[:, :k])
    got = cross_scale_cost.cross_scale_cost_cuda(
        vd.imgs, [v.bfloat16() for v in vd.vols], vd.max_costs, wgts,
        abc[:, :2].contiguous(), **kw)
    assert torch.equal(got, want[:, :2])


@pytest.mark.parametrize("k,stride", [(1, 1), (8, 2)])
def test_fly_kernel_kitti_shape(cuda, k, stride):
    """K5 (K = 1) and K3's fly form (stride 2, K = 8) on the KITTI scene
    (375 x 1242, max_dis 128: the other view's staged span is a tile plus
    128 columns wide), against the plain version."""
    fd, _ = fly_scene(375, 1242, 128, 1, False, 0, cuda)
    abc = torch.as_tensor(random_planes(k, 375, 1242, 128, seed=k),
                          device=cuda)
    assert_close(*fly_both(fd, None, abc, KITTI.half_wnd, 128, "cost",
                           stride))


@pytest.mark.parametrize("k,stride", [(1, 1), (8, 2)])
def test_fly_image_kitti_shape(cuda, k, stride):
    """K6 (K = 1) and its stride-2 form (K = 8), PatchMatch Stereo's image
    lerp, on the KITTI scene (375 x 1242, max_dis 128), both views, through
    the shared-row design (a ring of 17 tile rows: 65,088 bytes of shared
    memory a block, tests/test_torch_fly_plan.py), planes that leave the
    range and wrap past either border: within REL_TOL of the plain version,
    and the same bits on a rerun."""
    fd, _ = fly_scene(375, 1242, 128, 1, False, 0, cuda)
    abc = torch.as_tensor(random_planes(k, 375, 1242, 128, seed=600 + k),
                          device=cuda)
    kw = dict(half_wnd=KITTI.half_wnd, max_dis=128, lerp="image",
              wnd_stride=stride, **FLY_KW)
    before = sum(fly_cost.shared_launches.values())
    got = fly_cost.fly_cost_cuda(fd, None, abc, **kw)
    assert_close(got, onthefly_cost.fly_plane_cost(fd, None, abc, **kw))
    assert torch.equal(got, fly_cost.fly_cost_cuda(fd, None, abc, **kw))
    assert sum(fly_cost.shared_launches.values()) == before + 2


# The shared-row design (csrc/fly_cost.cu) at every (K, stride) the
# no-volume schedule launches, on planes over the whole slice range, on
# planes of nearly one slice (a warp's lanes on neighbouring columns at one
# slice: the bank-conflict case) and on far planes whose taps leave both
# image edges (the border pseudo-cost in the row buffer)
FLY_ROW_RUNS = [(1, 1), (2, 1), (5, 2), (8, 2)]


@pytest.fixture(scope="module")
def kitti_fly_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return fly_scene(375, 1242, 128, 1, False, 0, torch.device("cuda:0"))[0]


def kitti_fly_planes(kind, k, seed):
    h, w, d = 375, 1242, 128
    if kind == "random":
        return random_planes(k, h, w, d, seed)
    rng = np.random.default_rng(seed)
    if kind == "flat":
        ab = rng.uniform(-1e-4, 1e-4, (2, k, h, w, 2))
        dc = 37.25 + rng.uniform(-0.02, 0.02, (2, k, h, w))
    else:
        ab = rng.uniform(-0.05, 0.05, (2, k, h, w, 2))
        dc = rng.uniform(90.0, 127.0, (2, k, h, w))
    ab, dc = ab.astype(np.float32), dc.astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return np.concatenate([ab, c[..., None]], axis=-1)


@pytest.mark.parametrize("kind", ["random", "flat", "edges"])
@pytest.mark.parametrize("k,stride", FLY_ROW_RUNS)
def test_fly_rows_bit_equal_at_kitti(kitti_fly_scene, kind, k, stride):
    """K5 and K3's fly form on the KITTI scene (375 x 1242, max_dis 128),
    both views, through the shared-row design: the f32 costs equal the
    plain version's bit for bit."""
    fd = kitti_fly_scene
    assert fly_cost.launch_plan(k, 375, 1242, KITTI.half_wnd, 128, stride,
                                1, False, False).rows
    abc = torch.as_tensor(kitti_fly_planes(kind, k, seed=500 + k),
                          device=fd.imgs[0].device)
    before = sum(fly_cost.shared_launches.values())
    got, want = fly_both(fd, None, abc, KITTI.half_wnd, 128, "cost", stride)
    assert sum(fly_cost.shared_launches.values()) == before + 1
    assert torch.equal(got, want)


def one_sample_at_a_time(k, h, w, half_wnd, max_dis, stride, levels, lab,
                         image):
    """fly_cost.launch_plan's stand-in that sends every launch to the one
    sample at a time design (its fallback)."""
    return fly_cost.sample_plan(k, h, w, half_wnd, max_dis, lab)


@pytest.mark.parametrize("kind", ["random", "flat", "edges"])
@pytest.mark.parametrize("k,stride", FLY_ROW_RUNS)
def test_fly_image_rows_bit_equal_at_kitti(kitti_fly_scene, monkeypatch,
                                           kind, k, stride):
    """K6 and its stride-2 form on the KITTI scene (375 x 1242, max_dis
    128), both views, through the shared-row design: the f32 costs equal
    the one-sample-at-a-time K6's on the same inputs bit for bit (the same
    rounding steps in the same order), and lie within REL_TOL of the plain
    version; random planes leave the range, flat ones sit on one disparity
    (neighbouring lanes' taps on neighbouring columns), edge ones reach
    past both borders, where the taps wrap."""
    fd = kitti_fly_scene
    assert fly_cost.launch_plan(k, 375, 1242, KITTI.half_wnd, 128, stride,
                                1, False, True).rows
    abc = torch.as_tensor(kitti_fly_planes(kind, k, seed=700 + k),
                          device=fd.imgs[0].device)
    kw = dict(half_wnd=KITTI.half_wnd, max_dis=128, lerp="image",
              wnd_stride=stride, **FLY_KW)
    before = sum(fly_cost.shared_launches.values())
    got = fly_cost.fly_cost_cuda(fd, None, abc, **kw)
    assert sum(fly_cost.shared_launches.values()) == before + 1
    with monkeypatch.context() as m:
        m.setattr(fly_cost, "launch_plan", one_sample_at_a_time)
        sample = fly_cost.fly_cost_cuda(fd, None, abc, **kw)
    assert sum(fly_cost.shared_launches.values()) == before + 1
    assert torch.equal(got, sample)
    assert_close(got, onthefly_cost.fly_plane_cost(fd, None, abc, **kw))


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


@pytest.mark.parametrize("lerp,lab,hw", [("cost", False, 3),
                                         ("image", True, 3)])
def test_fly_eight_row_tile(cuda, lerp, lab, hw):
    """At max_dis 1500, half_wnd 3: the shared rows pass a block's 227 KB
    of shared memory, so the launch computes one sample at a time, where 8
    tile rows keep more warps resident than 16 (tests/test_torch_fly_plan
    .py test_sample_design_keeps_its_tile_rule)."""
    h, w, d = 20, 1600, 1500
    p = fly_cost.launch_plan(2, h, w, hw, d, 2, 1, lab, lerp == "image")
    assert not p.rows and p.tile_rows == 8
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


@pytest.mark.parametrize("use_pp", [False, True])
def test_pipeline_runs_through_the_kernels(cuda, use_pp):
    """K1 for every exact evaluation, K2 once, GRDV once a pair, QRANK
    once a ranking call; with use_pp the weighted median is one WMF launch;
    never a plain version."""
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11, use_pp=use_pp)
    reset_counts()
    out = run_pair(pair.left, pair.right, 0, cfg, device=cuda)
    torch.cuda.synchronize()
    assert out["dis"].shape == (2, 48, 64)
    assert window_cost.launches == 10 and quadrant_build.launches == 1
    assert plane_cost.launches == 0 and prescreen_volume.launches == 0
    assert wmf.launches == int(use_pp) and postprocess.plain_launches == 0
    # GRDV and QRANK once a call for both views
    assert grd_volume.launches == 1 and quadrant_rank.launches == 14
    assert grad_cost.launches == 0 and prescreen_volume.rank_launches == 0


def test_cross_scale_pipeline_runs_through_the_kernels(cuda):
    """CEN + CS + PP on the default device: the census volumes one CENV
    call a level, every exact evaluation one K4 launch, the ranking one K2
    build, no plain version."""
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
    assert quadrant_rank.launches == 14 and grd_volume.launches == 0
    assert census_volume.launches == 3 and census.launches == 0
    assert (plane_cost.launches, plane_cost.cross_scale_launches,
            prescreen_volume.launches, prescreen_volume.rank_launches) == (
        0, 0, 0, 0)


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
    # either lerp takes the shared-row design on every launch
    assert sum(fly_cost.shared_launches.values()) == n_fly
    assert (window_cost.launches, quadrant_build.launches,
            cross_scale_cost.launches) == (0, 0, 0)
    assert onthefly_cost.launches == 0 and plane_cost.launches == 0


def no_plain_version_ran():
    return (plane_cost.launches, plane_cost.cross_scale_launches,
            prescreen_volume.launches, onthefly_cost.launches,
            prescreen_volume.rank_launches, grad_cost.launches,
            census.launches) == (0, 0, 0, 0, 0, 0, 0)


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
    and rewound to iterations 1 and 2, resumed bit-equal."""
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
    for rewind in (1, 2):
        ck.save_state(path, saved[rewind], rewind, cfg, 0)
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


# -- the main paths and the entry points at their real size ----------------

# name: (config, scene, the bad-pixel threshold in px (None: not gated,
# the aggregators, which no cell or bound holds), the seeds (seed 0 run
# again at the end), the launches a pair)
MAIN_PATHS = {
    "README_DEMO": (README_DEMO, BENCH, 1.0, (0, 1, 2), GRD_LAUNCHES),
    "CEN_CS_PP": (CEN_CS_PP, BENCH, 1.0, (0, 1, 2), CEN_CS_PP_LAUNCHES),
    "README_DEMO-fly": (dataclasses.replace(
        README_DEMO, precompute_volume=False), BENCH, 1.0, (0, 1, 2),
        FLY_LAUNCHES),
    "KITTI-fly": (dataclasses.replace(KITTI, precompute_volume=False),
                  KITTI_SCENE, 3.0, (0,), dict(FLY_LAUNCHES, wmf=1)),
    "KITTI-fly-image": (dataclasses.replace(
        KITTI, precompute_volume=False, fly_lerp="image"), KITTI_SCENE, 3.0,
        (0,), dict(FLY_IMAGE_LAUNCHES, wmf=1)),
    "KITTI": (KITTI, KITTI_SCENE, 3.0, (0,), dict(GRD_LAUNCHES, wmf=1)),
    **{f"README_DEMO-{agg.value}": (
        dataclasses.replace(README_DEMO, aggregator=agg), BENCH, None, (0,),
        dict(GRD_LAUNCHES, **({"bfv": 1} if agg == Aggregator.BF else {})))
       for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF)},
}


@pytest.mark.parametrize("path", list(MAIN_PATHS))
def test_main_path_on_the_card(cuda, path):
    """A main path at its real size, seed 0 run again at the end: each
    seed's left bad-pixel (non-occluded) at the path's threshold <= 0.01,
    finite costs, seed 0 bit-identical on the rerun; each kernel's launches
    a pair exactly the path's, and no plain version.  With
    post-processing: postprocess
    alone on the seed-0 planes gives the pipeline's map, and WMF on the
    pipeline's own inputs (the filled maps, the LR mask) is u8-equal to
    its plain version and to that map."""
    from crossscalepatchmatch_tpu_torch.models.patchmatch import plane_to_disp

    cfg, shape, px, seeds, launches = MAIN_PATHS[path]
    pair = make_pair(seed=0, **shape)
    l, r = (torch.as_tensor(x, device=cuda) for x in (pair.left, pair.right))
    reset_counts()
    outs = {}
    for seed in (*seeds, 0):
        out = run_pair(l, r, seed, cfg, device=cuda)
        if seed in outs:
            for k in out:
                assert torch.equal(out[k], outs[seed][k]), k
            continue
        outs[seed] = out
        assert out["dis"].shape == (2, shape["h"], shape["w"])
        assert bool(torch.isfinite(out["cost"]).all())
        if px is not None:
            bad = bad_pixel_rate(out["dis"][0].cpu().numpy() / cfg.dis_scale,
                                 pair.disp_left, pair.valid_left, px)
            assert bad <= BAD_PIXEL_MAX, (seed, bad)
    torch.cuda.synchronize()
    assert_launches(launch_counts(), launches, len(seeds) + 1)
    # every fly launch takes the shared-row design, K6's too
    assert sum(fly_cost.shared_launches.values()) == fly_cost.count()
    if cfg.use_pp:
        out, imgs = outs[0], torch.stack([l, r])
        dis = plane_to_disp(out["abc"], cfg.dis_scale)
        assert torch.equal(postprocess.postprocess(dis, out["abc"], imgs,
                                                   cfg)[0], out["dis"])
        filled = postprocess.fill_invalid(dis, out["abc"], out["valid"], cfg)
        got = wmf.weighted_median_cuda(
            filled, imgs, out["valid"], plane_cost.asw_lut(cfg.wmf_gamma,
                                                           cuda),
            half_wnd=cfg.half_wnd)
        assert torch.equal(got, postprocess.weighted_median_plain(
            filled, imgs, out["valid"], cfg))
        assert torch.equal(got, out["dis"])


def test_warm_frame_on_the_card(cuda):
    """run_sequence_np with README_DEMO on the bench scene: a cold frame,
    then a warm one (the same geometry, the next frame's sensor noise):
    the warm frame's bad-pixel @1px <= 0.01, the GRD path's kernels
    launched and no plain version, the sequence bit-identical on a
    rerun."""
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_sequence_np

    pair = make_pair(seed=0, **BENCH)
    nxt = make_pair(seed=0, noise_sigma=2.0, **BENCH)
    frames = [(pair.left, pair.right), (nxt.left, nxt.right)]
    reset_counts()
    seq = list(run_sequence_np(frames, README_DEMO, seed=0))
    torch.cuda.synchronize()
    assert_path_launched(launch_counts(), GRD_PATH)
    again = list(run_sequence_np(frames, README_DEMO, seed=0))
    for a, b in zip(seq, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bad = bad_pixel_rate(seq[1]["dis"][0] / README_DEMO.dis_scale,
                         nxt.disp_left, nxt.valid_left, 1.0)
    assert bad <= BAD_PIXEL_MAX, bad


SMALL = dict(max_dis=12, dis_scale=16, wnd_size=11, vol_dtype="f32")
CS3 = dict(use_cs=True, reg_lambda=0.3, scale_num=3)
# name: (config fields over SMALL, the kernels the card's run launches)
SMALL_PAIRS = {
    "README_DEMO-like": ({}, GRD_PATH),
    "CEN_CS_PP-like": (dict(cost_method=CostMethod.CEN, use_pp=True, **CS3),
                       (*CEN_CS_PATH, "wmf")),
    "window-prescreen": (dict(prescreen_mode="window"),
                         ("k1", "k3_volume", "grdv")),
    "fly-cost": (dict(precompute_volume=False), ("k5", "k3_fly")),
    "fly-image-CS": (dict(precompute_volume=False, fly_lerp="image",
                          wnd_size=7, **CS3), ("k6",)),
    "fly-Lab": (dict(precompute_volume=False, use_lab_weights=True),
                ("k5", "k7", "k3_fly")),
    "BOX": (dict(aggregator=Aggregator.BOX), GRD_PATH),
    "GF": (dict(aggregator=Aggregator.GF), GRD_PATH),
    "BF": (dict(aggregator=Aggregator.BF), (*GRD_PATH, "bfv")),
    "CEN+CS+BOX": (dict(cost_method=CostMethod.CEN,
                        aggregator=Aggregator.BOX, **CS3), CEN_CS_PATH),
    "warm": ({}, GRD_PATH),
}
SMALL_AGREE_MIN = 0.98      # share of u8 pixels within 1 level


@pytest.mark.parametrize("name", list(SMALL_PAIRS))
def test_small_pair_card_against_cpu(cuda, name):
    """A 48 x 64 pair on the card (the kernels) and on the CPU (the plain
    versions) from the same draws: at least 98 % of the u8 map pixels
    within one level; the card's run launches the config's kernels and no
    plain version.  `warm`: a warm frame from the CPU's cold planes, with
    the same warm draws on both."""
    from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair_np,
                                                                run_pair_warm)
    from crossscalepatchmatch_tpu_torch.utils.rng import (PHASE_WARM,
                                                          TorchDraws)

    fields, kernels = SMALL_PAIRS[name]
    cfg = CSPMConfig(**{**SMALL, **fields})
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    if name == "warm":
        prior = run_pair_np(pair.left, pair.right, cfg, device="cpu",
                            draws=TorchDraws(0, "cpu"))["abc"]

    def run(device):
        if name == "warm":
            return run_pair_warm(
                pair.left, pair.right, 1, prior, cfg, device=device,
                draws=TorchDraws(1, "cpu", refine_phase=PHASE_WARM))[
                    "dis"].cpu().numpy()
        return run_pair_np(pair.left, pair.right, cfg, device=device,
                           draws=TorchDraws(0, "cpu"))["dis"]

    reset_counts()
    on_card = run(cuda)
    torch.cuda.synchronize()
    assert_path_launched(launch_counts(), kernels)
    on_cpu = run(torch.device("cpu"))
    agree = float((np.abs(on_card.astype(int) - on_cpu.astype(int)) <= 1)
                  .mean())
    assert agree >= SMALL_AGREE_MIN, agree


def test_cli_input_list_on_the_card(cuda, tmp_path):
    """python -m crossscalepatchmatch_tpu_torch in a process of its own,
    with the README demo's flags and --input_list of two runs (seeds 0
    and 1) on PNGs of the bench scene: two runs, seed 0's maps
    run_pair_np's byte for byte, seed 1's other maps within the bad-pixel
    gate @1px."""
    import pathlib
    import subprocess
    import sys

    from PIL import Image

    from crossscalepatchmatch_tpu_torch import cli
    from crossscalepatchmatch_tpu_torch import io as cspm_io
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np

    pair = make_pair(seed=0, **BENCH)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    cspm_io.write_bgr(lp, pair.left)
    cspm_io.write_bgr(rp, pair.right)

    def flags(seed):
        return [f"--l_img_file={lp}", f"--r_img_file={rp}",
                f"--l_dis_file={tmp_path}/s{seed}_l.png",
                f"--r_dis_file={tmp_path}/s{seed}_r.png", "--max_dis=60",
                "--dis_scale=4", "--cc_name=GRD", "--use_cs=false",
                "--use_pp=false", "--reg_lambda=0.0", f"--seed={seed}"]

    lst = tmp_path / "input.txt"
    lst.write_text("".join(f"cspm {' '.join(flags(seed))}\n"
                           for seed in (0, 1)))
    res = subprocess.run(
        [sys.executable, "-m", "crossscalepatchmatch_tpu_torch",
         f"--input_list={lst}"], capture_output=True, text=True, timeout=600,
        cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stderr
    assert sum(ln.startswith("Total Time:")
               for ln in res.stdout.splitlines()) == 2
    maps = [np.stack([np.asarray(Image.open(tmp_path / f"s{seed}_{v}.png"))
                      for v in "lr"]) for seed in (0, 1)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(flags(0)))
    want = run_pair_np(pair.left, pair.right, cfg, seed=0)["dis"]
    np.testing.assert_array_equal(maps[0], want)
    assert not np.array_equal(maps[1], want)
    assert bad_pixel_rate(maps[1][0] / 4, pair.disp_left, pair.valid_left,
                          1.0) <= BAD_PIXEL_MAX


@pytest.mark.parametrize("cc", ["GRD", "CEN"])
def test_volumes_on_the_card_match_the_oracle(cuda, cc):
    """build_volumes on the card (GRDV, CENV) against the native oracle's
    cost_volume (csrc/cspm_oracle.cc, built with g++) on a 64 x 96 d = 12
    scene, both views, within 1e-4."""
    import shutil

    from crossscalepatchmatch_tpu_torch import oracle
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volumes

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    p = make_pair(h=64, w=96, max_dis=12, seed=11)
    both = build_volumes(
        bgr_to_rgb(torch.as_tensor(p.left, device=cuda)),
        bgr_to_rgb(torch.as_tensor(p.right, device=cuda)), 12,
        CSPMConfig(max_dis=12, dis_scale=16, cost_method=CostMethod[cc]))
    both = both.double().cpu().numpy()
    for right in (False, True):
        want = oracle.cost_volume(p.left, p.right, max_dis=12, cc_name=cc,
                                  right=right)
        np.testing.assert_allclose(np.moveaxis(both[int(right)], -1, 0),
                                   want, rtol=1e-4, atol=1e-4)


# -- band forms (a spatial tile of parallel.tiled: kernel_ab.bench_tile) ------


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (8, 2)])
def test_k1_k3_band_form_bench_tile(cuda, k, stride):
    """K1 (K = 1, 2) and K3's volume form (stride 2, K = 8) on the bench
    tile's extended block, f32: bit-equal to the plain band form."""
    cfg = README_DEMO
    t = bench_tile(cfg, cuda)
    hw, md = cfg.half_wnd, cfg.max_dis
    prep = window_cost.prepare_volumes(
        t["imgs"][0], t["vols"][0], t["mcs"][0], half_wnd=hw, max_dis=md,
        gamma=cfg.wgt_gamma, rows_extended=True, cols_extended=True)
    assert prep.hw == (t["hs"], t["ws"])
    abc = torch.as_tensor(random_planes(k, t["hs"], t["ws"], md, seed=k,
                                        wild=False), device=cuda)
    n = window_cost.launches
    got = window_cost.window_cost_prepared(prep, abc, half_wnd=hw,
                                           max_dis=md, wnd_stride=stride,
                                           bounds=t["bounds"][0])
    assert window_cost.launches == n + 1
    rv, cv = t["valid"]
    want = torch.stack([plane_cost.window_plane_cost(
        t["imgs"][0][v], t["vols"][0][v], t["mcs"][0][v], abc[v],
        half_wnd=hw, max_dis=md, gamma=cfg.wgt_gamma, center_row0=hw,
        row_valid=rv, center_col0=hw, col_valid=cv, wnd_stride=stride)
        for v in range(2)])
    assert torch.equal(got, want)


def test_k2_band_form_bench_tile(cuda):
    """K2 over the bench tile's own pixels, window pixels inside the global
    image: bit-equal to the plain build over the extended block, sliced."""
    cfg = README_DEMO
    t = bench_tile(cfg, cuda)
    hw, hs, ws = cfg.half_wnd, t["hs"], t["ws"]
    prep = window_cost.prepare_volumes(
        t["imgs"][0], t["vols"][0], None, half_wnd=hw, max_dis=cfg.max_dis,
        gamma=cfg.wgt_gamma, rows_extended=True, cols_extended=True)
    gb, gw = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=hw, gamma=cfg.wgt_gamma, stride=cfg.prescreen_stride,
        bounds=t["bounds"][0])
    rv, cv = t["valid"]
    parts = [prescreen_volume.build_quadrant_volumes(
        t["imgs"][0][v], t["vols"][0][v], rv[:, None] & cv[None, :],
        half_wnd=hw, gamma=cfg.wgt_gamma, stride=cfg.prescreen_stride)
        for v in range(2)]
    wb, ww = (torch.stack([p[i] for p in parts])[:, :, hw:hw + hs,
                                                   hw:hw + ws]
              for i in range(2))
    assert gb.shape == (2, 4, hs, ws, cfg.max_dis + 1)
    assert torch.equal(gb, wb) and torch.equal(gw, ww)


@pytest.mark.parametrize("row0,rows", [(0, 384), (0, 192), (192, 192)],
                         ids=["whole", "ty0", "ty1"])
def test_k1_k2_row_band_forms(cuda, row0, rows):
    """K1 (K = 1, 2) and K2 on the tiles bench_scaling_torch.py's default
    workload hands them (384 x 448, d = 60, wnd 35, GRD): the whole image
    of the (1, 1, 1) mesh and both row bands of the (1, 2, 1) mesh, rows
    extended by the half window (zeros past the image), columns not: f32
    bit-equal to their plain band forms."""
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full

    h, w, md = 384, 448, 60
    cfg = CSPMConfig(max_dis=md, dis_scale=4, wnd_size=35)
    hw, gamma, stride = cfg.half_wnd, cfg.wgt_gamma, cfg.prescreen_stride
    pair = make_pair(h=h, w=w, max_dis=md, seed=0)
    vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                           torch.as_tensor(pair.right, device=cuda), cfg)
    imgs, vols = (_ext_from_full(x, row0, rows, hw, 1).contiguous()
                  for x in (vd.imgs[0], vd.vols[0].float()))
    mc = vd.max_costs[0]
    bounds = (-row0, h - row0, 0, w)
    prep = window_cost.prepare_volumes(
        imgs, vols, mc, half_wnd=hw, max_dis=md, gamma=gamma,
        rows_extended=True, cols_extended=False)
    band = prep.plain_band(bounds)
    for k in (1, 2):
        abc = torch.as_tensor(random_planes(k, rows, w, md, seed=row0 + k),
                              device=cuda)
        got = window_cost.window_cost_prepared(prep, abc, half_wnd=hw,
                                               max_dis=md, bounds=bounds)
        want = torch.stack([plane_cost.window_plane_cost(
            imgs[v], vols[v], mc[v], abc[v], half_wnd=hw, max_dis=md,
            gamma=gamma, **band) for v in range(2)])
        assert torch.equal(got, want), k
    gb, gw = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=hw, gamma=gamma, stride=stride, bounds=bounds)
    rv, cv = cross_scale_cost.valid_vectors(prep.rect(bounds), prep.array_hw,
                                            cuda)
    parts = [prescreen_volume.build_quadrant_volumes(
        imgs[v], vols[v], rv[:, None] & cv[None, :], half_wnd=hw,
        gamma=gamma, stride=stride) for v in range(2)]
    wb, ww = (torch.stack([p[i] for p in parts])[:, :, hw:hw + rows]
              for i in range(2))
    assert torch.equal(gb, wb) and torch.equal(gw, ww)


def test_k4_band_form_bench_tile(cuda):
    """K4 over the 5-level census pyramid on the bench tile (level 0 the
    extended block, levels 1-4 whole, the odd origin (125, 225)): f32, and
    bf16 census volumes (integers, exact in bf16), bit-equal to the plain
    band form."""
    cfg = CEN_CS_PP
    t = bench_tile(cfg, cuda)
    hw = cfg.half_wnd
    wgts = [float(x) for x in scale_weights(cfg.scale_num, cfg.reg_lambda)]
    abc = torch.as_tensor(random_planes(2, t["hs"], t["ws"], cfg.max_dis,
                                        seed=7, wild=False), device=cuda)
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        prep = cross_scale_cost.prepare_cross_scale(
            t["imgs"], [v.to(dtype) for v in t["vols"]], t["mcs"], wgts,
            half_wnd=hw, max_dis=cfg.max_dis, gamma=cfg.wgt_gamma,
            rows_extended=True, cols_extended=True, origin=t["origin"],
            bounds=t["bounds"])
        got[dtype] = cross_scale_cost.cross_scale_cost_prepared(
            prep, abc, half_wnd=hw, max_dis=cfg.max_dis,
            levels=cfg.scale_num)
    rv, cv = t["valid"]
    origins = [(hw, hw)] + [t["origin"]] * (cfg.scale_num - 1)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in t["imgs"]], [vo[v] for vo in t["vols"]],
        [mc[v] for mc in t["mcs"]], wgts, abc[v], half_wnd=hw,
        max_dis=cfg.max_dis, gamma=cfg.wgt_gamma, origins=origins,
        row_valids=[rv] + [None] * 4, col_valids=[cv] + [None] * 4)
        for v in range(2)])
    assert torch.equal(got[torch.float32], want)
    assert torch.equal(got[torch.bfloat16], want)


@pytest.mark.parametrize("row0,col0,levels", [(7, 9, 3), (13, 5, 4)])
def test_k4_band_form_odd_origins(cuda, row0, col0, levels):
    """K4's band form on small tiles at odd origins, a ragged block, with
    NaN and wild planes, the halo partly past the global image: f32
    bit-equal to the plain band form (the coarse center is (y + row0) >>
    s, not (y >> s) + (row0 >> s))."""
    hw, hs, ws, d = 9, 19, 37, 12
    h_glob, w_glob = row0 + hs + 11, col0 + ws + 6
    rng = np.random.default_rng(row0)
    imgs, vols, mcs, bounds = [], [], [], []
    md = d
    for s in range(levels):
        hl = (((h_glob - 1) >> s) + 1) if s else hs + 2 * hw
        wl = (((w_glob - 1) >> s) + 1) if s else ws + 2 * hw
        imgs.append(torch.as_tensor(rng.integers(0, 256, (2, hl, wl, 3),
                                                 dtype=np.uint8), device=cuda))
        vols.append(torch.as_tensor(rng.uniform(0, 2, (2, hl, wl, md + 1))
                                    .astype(np.float32), device=cuda))
        mcs.append(vols[-1].amax(dim=(1, 2, 3)))
        bounds.append((-row0, (hl << s) - row0, -col0, (wl << s) - col0)
                      if s else (-row0, h_glob - row0, -col0, w_glob - col0))
        md //= 2
    wgts = [1.0 / levels] * levels
    prep = cross_scale_cost.prepare_cross_scale(
        imgs, vols, mcs, wgts, half_wnd=hw, max_dis=d, gamma=10.0,
        rows_extended=True, cols_extended=True, origin=(row0, col0),
        bounds=bounds)
    abc = torch.as_tensor(nan_planes(2, hs, ws, d, seed=row0), device=cuda)
    got = cross_scale_cost.cross_scale_cost_prepared(prep, abc, half_wnd=hw,
                                                     max_dis=d, levels=levels)
    g_row = row0 + torch.arange(-hw, hs + hw, device=cuda)
    g_col = col0 + torch.arange(-hw, ws + hw, device=cuda)
    origins = [(hw, hw)] + [(row0, col0)] * (levels - 1)
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in imgs], [vo[v] for vo in vols],
        [mc[v] for mc in mcs], wgts, abc[v], half_wnd=hw, max_dis=d,
        gamma=10.0, origins=origins,
        row_valids=[(g_row >= 0) & (g_row < h_glob)] + [None] * (levels - 1),
        col_valids=[(g_col >= 0) & (g_col < w_glob)] + [None] * (levels - 1))
        for v in range(2)])
    assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))


def test_sharded_pipeline_on_the_card(cuda, tmp_path):
    """On a world of one rank on the card (a (1, 1, 1) mesh, the
    in-process group; NCCL): run_batch_sharded launches the band forms and
    no plain version and gives finite maps of the right shape;
    run_sequence_batch (2 streams x 3 frames) equals run_sequence_np on
    each stream, and the no-volume data-only mesh run_pair on each pair,
    byte for byte."""
    import subprocess
    import sys

    code = (
        "import torch, numpy as np\n"
        "from crossscalepatchmatch_tpu_torch import CSPMConfig\n"
        "from crossscalepatchmatch_tpu_torch.data import make_pair\n"
        "from crossscalepatchmatch_tpu_torch.models.pipeline import (\n"
        "    run_pair, run_sequence_np)\n"
        "from crossscalepatchmatch_tpu_torch.ops import plane_cost, "
        "prescreen_volume\n"
        "from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost, "
        "quadrant_build\n"
        "from crossscalepatchmatch_tpu_torch.parallel.mesh import "
        "initialize_multihost\n"
        "from crossscalepatchmatch_tpu_torch.parallel.tiled import (\n"
        "    run_batch_sharded, run_sequence_batch)\n"
        "from crossscalepatchmatch_tpu_torch.utils.profiling import (\n"
        "    launch_counts, reset_launch_counts)\n"
        "mesh = initialize_multihost()\n"
        "p = make_pair(h=48, w=64, max_dis=12, seed=3)\n"
        "cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11)\n"
        "dis = run_batch_sharded(p.left[None], p.right[None], [0], cfg,\n"
        "                        mesh)\n"
        "assert dis.shape == (1, 2, 48, 64) and dis.is_cuda\n"
        "assert window_cost.launches > 0 and quadrant_build.launches == 1\n"
        "assert plane_cost.launches == prescreen_volume.launches == 0\n"
        "streams = [make_pair(h=48, w=64, max_dis=12, seed=s)\n"
        "           for s in (3, 4)]\n"
        "ls = np.stack([q.left for q in streams])\n"
        "rs = np.stack([q.right for q in streams])\n"
        "seq = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11,\n"
        "                 vol_dtype='f32')\n"
        "batched = [{k: v.cpu().numpy() for k, v in o.items()} for o in\n"
        "           run_sequence_batch([(ls, rs)] * 3, seq, mesh, seed=7)]\n"
        "for b, q in enumerate(streams):\n"
        "    solo = list(run_sequence_np([(q.left, q.right)] * 3, seq,\n"
        "                                seed=7 + 1000003 * b))\n"
        "    for t in range(3):\n"
        "        for k in ('dis', 'abc'):\n"
        "            assert np.array_equal(batched[t][k][b], solo[t][k])\n"
        "fly = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11,\n"
        "                 vol_dtype='f32', precompute_volume=False)\n"
        "reset_launch_counts()\n"
        "fly_dis = run_batch_sharded(ls, rs, [3, 5], fly, mesh)\n"
        "c = launch_counts()\n"
        "assert c['k5'] and c['k3_fly'] and c['rprop']\n"
        "assert not any(n for k, n in c.items() if k.endswith('_plain'))\n"
        "for b, seed in enumerate((3, 5)):\n"
        "    assert torch.equal(fly_dis[b], run_pair(ls[b], rs[b], seed,\n"
        "                                            fly)['dis'])\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_gloo_mesh_on_one_card(cuda, tmp_path):
    """Ranks sharing the one card over gloo (halos staged through the
    host; tests/torch_sharded_worker.py): on a (1, 3, 2) mesh of six,
    README_DEMO and CEN_CS_PP on the bench scene through the band forms,
    the left bad-pixel @1px <= 0.01 and within 0.005 of one device's run,
    the path's kernels launched on the ranks and no plain version, a rerun
    bit-identical; and a 48 x 64 pair on a (1, 2, 2) mesh of four, on the
    card against the same mesh on the CPU with the same draws (at least
    98 % of the u8 pixels within one level)."""
    from torch_sharded_worker import spawn

    def ranks(device, mesh, pair, runs, reps, cpu_draws):
        tmp = tmp_path / f"{device}-{len(runs)}-{mesh[1]}"
        tmp.mkdir()
        out = spawn(dict(job="card_mesh", device=device, mesh=mesh,
                         reps=reps, cpu_draws=cpu_draws,
                         l=pair.left[None], r=pair.right[None], seeds=[0],
                         runs={n: dataclasses.asdict(c)
                               for n, (c, _) in runs.items()}),
                    mesh[0] * mesh[1] * mesh[2], str(tmp))
        for name, (_, kernels) in runs.items():
            got = [rk[name] for rk in out]
            assert_path_launched({k: sum(g["counts"][k] for g in got)
                                  for k in got[0]["counts"]}, kernels)
            assert all(g["same"] for g in got)
        return out

    pair = make_pair(seed=0, **BENCH)
    runs = {"README_DEMO": (README_DEMO, GRD_PATH),
            "CEN_CS_PP": (CEN_CS_PP, (*CEN_CS_PATH, "wmf"))}
    out = ranks("cuda", (1, 3, 2), pair, runs, 2, False)
    for name, (cfg, _) in runs.items():
        dis = out[0][name]["dis"]
        assert dis.shape == (1, 2, 375, 450)
        one = run_pair(pair.left, pair.right, 0, cfg, device=cuda)["dis"]
        bad, single = (bad_pixel_rate(d / cfg.dis_scale, pair.disp_left,
                                      pair.valid_left, 1.0)
                       for d in (dis[0, 0], one[0].cpu().numpy()))
        assert bad <= BAD_PIXEL_MAX and abs(bad - single) <= 0.005, (
            name, bad, single)
    small = make_pair(h=48, w=64, max_dis=12, seed=3)
    runs = {"small": (CSPMConfig(use_pp=True, **SMALL), (*GRD_PATH, "wmf")),
            "window-prescreen": (CSPMConfig(prescreen_mode="window",
                                            **SMALL),
                                 ("k1", "k3_volume", "grdv"))}
    on_card = ranks("cuda", (1, 2, 2), small, runs, 1, True)
    on_cpu = spawn(dict(job="card_mesh", device="cpu", mesh=(1, 2, 2),
                        reps=1, cpu_draws=True, l=small.left[None],
                        r=small.right[None], seeds=[0],
                        runs={n: dataclasses.asdict(c)
                              for n, (c, _) in runs.items()}),
                   4, str(tmp_path))
    for name in runs:
        a, b = (x[0][name]["dis"].astype(int) for x in (on_card, on_cpu))
        agree = float((np.abs(a - b) <= 1).mean())
        assert agree >= SMALL_AGREE_MIN, (name, agree)


@pytest.mark.parametrize("m,c,iters", [(1.0, 1.0, 8), (0.75, 0.5, 8),
                                       (0.9999999, 1e-7, 64)])
def test_f32_peak_chain(cuda, m, c, iters):
    """The f32 ceiling's FMA-chain kernel (csrc/f32_peak.cu) against its
    plain version on the card, within 1e-5 relative (m = c = 1 on integers
    is exact: every element gains one a step)."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import f32_peak

    x = torch.rand(4 * f32_peak.BLOCK_ELEMS, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    n = f32_peak.launches
    got = f32_peak.fma_chain(x, iters, m, c)
    want = f32_peak.fma_chain_plain(x, iters, m, c)
    assert f32_peak.launches == n + 1
    err = ((got.double() - want.double()).abs()
           / want.double().abs().clamp(min=1.0)).max().item()
    assert err <= 1e-5, err
    if (m, c) == (1.0, 1.0):
        xi = torch.floor(x * 1000)
        assert torch.equal(f32_peak.fma_chain(xi, iters, m, c),
                           xi + iters * f32_peak.UNROLL)
    with pytest.raises(ValueError):
        f32_peak.fma_chain(x[:100], 1, m, c)


def test_f32_ceiling(cuda):
    """The measured f32 ceiling is positive and under 1.05x the H100 data
    sheet's 67 TFLOP/s (measure_f32_peak itself raises unless every element
    of its timed launches equals its step count)."""
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        F32_FLOP_PER_S, measure_f32_peak)

    peak = measure_f32_peak(cuda)
    assert 0 < peak < 1.05 * F32_FLOP_PER_S, peak


# -- WMF, the weighted median ---------------------------------------------

def wmf_scene(h, w, seed, invalid_share, cuda, levels=256, colours=None):
    """u8 maps, images and a validity mask with `invalid_share` of the
    pixels invalid; `levels` / `colours` few: many ties of S(t)."""
    rng = np.random.default_rng(seed)
    dis = (rng.integers(0, levels, (2, h, w)) * (255 // max(levels - 1, 1))
           ).astype(np.uint8)
    if colours:
        palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
        imgs = palette[rng.integers(0, colours, (2, h, w))]
    else:
        imgs = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    valid = rng.uniform(size=(2, h, w)) >= invalid_share
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in (dis, imgs, valid))


def wmf_both(dis, imgs, valid, wnd, **kw):
    """(kernel, plain) on the same CUDA tensors; the kernel launched once."""
    cfg = CSPMConfig(max_dis=12, dis_scale=8, wnd_size=wnd)
    n = wmf.launches
    got = postprocess.weighted_median(dis, imgs, valid, cfg, **kw)
    torch.cuda.synchronize()
    assert wmf.launches == n + 1
    want = postprocess.weighted_median_plain(dis, imgs, valid, cfg, **kw)
    assert got.dtype == torch.uint8 and got.device == dis.device
    return got, want


@pytest.mark.parametrize("wnd", [3, 11, 35])
@pytest.mark.parametrize("share", [0.0, 0.002, 0.3, 1.0])
@pytest.mark.parametrize("ties", [False, True])
def test_wmf_equals_plain(cuda, wnd, share, ties):
    """u8-equal to the plain version with no, a few, many and all pixels
    invalid, on random scenes and on scenes with many ties of S(t)."""
    kw = dict(levels=4, colours=2) if ties else {}
    dis, imgs, valid = wmf_scene(40, 56, wnd, share, cuda, **kw)
    got, want = wmf_both(dis, imgs, valid, wnd)
    assert torch.equal(got, want)
    if share == 0.3:
        assert (got != dis).any()
    elif share in (0.0, 1.0):
        assert torch.equal(got, dis)


def test_wmf_zero_total_pixels(cuda):
    """Invalid pixels whose window holds no valid pixel keep dis."""
    dis, imgs, valid = wmf_scene(30, 40, 5, 0.2, cuda, levels=4, colours=2)
    valid[:, 5:20, 5:25] = False
    got, want = wmf_both(dis, imgs, valid, 5)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 7:18, 7:23], dis[:, 7:18, 7:23])


@pytest.mark.parametrize("wnd,hs,ws", [(11, 37, 51), (35, 125, 225)])
def test_wmf_band_form(cuda, wnd, hs, ws):
    """The band arguments as parallel.tiled passes them: a block with its
    half-window halo, rows and columns past the global image invalid."""
    hw = wnd // 2
    dis, imgs, valid = wmf_scene(hs + 2 * hw, ws + 2 * hw, wnd, 0.1, cuda)
    valid[:, :hw] = False
    valid[:, :, -hw:] = False
    kw = dict(center_row0=hw, out_h=hs, center_col0=hw, out_w=ws)
    got, want = wmf_both(dis, imgs, valid, wnd, **kw)
    assert got.shape == (2, hs, ws)
    assert torch.equal(got, want)
    # the block's centre with the halo as rows only (columns whole)
    kw = dict(center_row0=hw, out_h=hs)
    got, want = wmf_both(dis[:, :, hw:-hw].contiguous(),
                         imgs[:, :, hw:-hw].contiguous(),
                         valid[:, :, hw:-hw].contiguous(), wnd, **kw)
    assert torch.equal(got, want)


def test_wmf_band_form_is_the_whole_image_tile(cuda):
    """The band form on the bench tile of a (1, 3, 2) mesh, its block
    extended by the half window (zeros, so invalid, past the image) as
    parallel.tiled passes it: u8-equal to its plain band form and to the
    whole image's weighted median cut to the tile."""
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full

    hw, hs, ws = 17, 125, 225
    dis, imgs, valid = wmf_scene(375, 450, 7, 0.2, cuda)
    whole, want = wmf_both(dis, imgs, valid, 2 * hw + 1)
    assert torch.equal(whole, want)

    def ext(x):
        return _ext_from_full(_ext_from_full(x, hs, hs, hw, 1), ws, ws, hw,
                              2).contiguous()

    got, want = wmf_both(ext(dis), ext(imgs), ext(valid.to(torch.uint8))
                         .bool(), 2 * hw + 1, center_row0=hw, out_h=hs,
                         center_col0=hw, out_w=ws)
    assert torch.equal(got, want)
    assert torch.equal(got, whole[:, hs:2 * hs, ws:2 * ws])


def test_wmf_kitti_shape(cuda):
    """At KITTI's 375 x 1242, wnd 35, on the LR-invalid mask of a noisy
    plane field around the scene's ground truth."""
    from crossscalepatchmatch_tpu_torch import KITTI
    from crossscalepatchmatch_tpu_torch.models.patchmatch import plane_to_disp
    from crossscalepatchmatch_tpu_torch.ops import plane

    pair = make_pair(h=375, w=1242, max_dis=128, seed=0)
    rng = np.random.default_rng(0)
    gt = np.stack([pair.disp_left, pair.disp_right])
    dc = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    wrong = rng.uniform(size=gt.shape) < 0.05
    dc[wrong] = rng.uniform(0, 128, wrong.sum())
    xs, ys = plane.pixel_grid(375, 1242, cuda)
    abc = plane.reanchor(torch.zeros((2, 375, 1242, 2), device=cuda), xs, ys,
                         torch.from_numpy(dc).to(cuda))
    dis = plane_to_disp(abc, KITTI.dis_scale)
    valid = postprocess.lr_check(dis, KITTI)
    dis = postprocess.fill_invalid(dis, abc, valid, KITTI)
    imgs = torch.from_numpy(np.stack([pair.left, pair.right])).to(cuda)
    got, want = wmf_both(dis, imgs, valid, KITTI.wnd_size)
    assert 0.01 < float((~valid).float().mean()) < 0.5
    assert torch.equal(got, want)


@pytest.mark.parametrize("band", [False, True])
def test_wmf_prepare_lists_the_invalid_pixels(cuda, band):
    """The wrapper's preparation (two launches): the packed words (colour,
    key dis or 256), the output window of dis, and the invalid output
    pixels in view-major raster order with their count on the device,
    across many chunks of the compaction (~20 % invalid, 2 x 125 x 225
    output pixels), whole image and band form."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import pack_bgr

    dis, imgs, valid = wmf_scene(159, 259, 3, 0.2, cuda)
    kw = dict(center_row0=17, out_h=125, center_col0=17, out_w=225) if band \
        else dict(center_row0=0, out_h=159, center_col0=0, out_w=259)
    r0, oh, c0, ow = (kw[k] for k in ("center_row0", "out_h", "center_col0",
                                      "out_w"))
    packed, idx, n, out, origin = wmf.prepare_median(dis, imgs, valid, r0,
                                                     oh, c0, ow)
    torch.cuda.synchronize()
    assert origin == (r0, c0)
    assert torch.equal(packed[..., 0], pack_bgr(imgs))
    assert torch.equal(packed[..., 1],
                       torch.where(valid, dis.int(), 256).int())
    region = (slice(None), slice(r0, r0 + oh), slice(c0, c0 + ow))
    assert torch.equal(out, dis[region])
    want = torch.nonzero((~valid[region]).reshape(-1))[:, 0].int()
    assert int(n[0]) == want.numel() > 8 * 1024
    assert torch.equal(idx[:want.numel()], want)


def test_wmf_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dis, imgs, valid = wmf_scene(12, 16, 1, 0.3, cuda)
    lut = plane_cost.asw_lut(10.0, cuda)
    n = wmf.launches
    bad = [
        ((dis.float(), imgs, valid, lut), {}),
        ((dis, imgs.to(torch.int32), valid, lut), {}),
        ((dis, imgs, valid.to(torch.uint8), lut), {}),
        ((dis, imgs, valid, lut.half()), {}),
        ((dis[:1], imgs[:1], valid[:1], lut), {}),
        ((dis, imgs[..., :2], valid, lut), {}),
        ((dis, imgs, valid, lut[:-1]), {}),
        ((dis, imgs, valid, torch.stack([lut, lut], 1)[:, 0]), {}),
        ((dis, imgs.cpu(), valid, lut), {}),
        ((dis, imgs, valid, lut.cpu()), {}),
        ((dis.cpu(), imgs.cpu(), valid.cpu(), lut.cpu()), {}),
        ((dis, imgs, valid, lut), dict(half_wnd=-1)),
        ((dis, imgs, valid, lut), dict(center_row0=1, out_h=12)),
        ((dis, imgs, valid, lut), dict(center_col0=4, out_w=13)),
    ]
    for args, kw in bad:
        with pytest.raises(ValueError):
            wmf.weighted_median_cuda(*args, **{"half_wnd": 2, **kw})
    assert wmf.launches == n


# -- GRDV, the GRD cost volume, and QRANK, the quadrant ranking ----------

def grd_views(h, w, max_dis, cuda, rows=None):
    """The scene's u8 RGB views on the card (rows: a full-width band);
    random views where the scene would be narrower than 16 pixels or than
    max_dis."""
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb

    if w < 16 or max_dis >= w:
        rng = np.random.default_rng(h * w + max_dis)
        return (torch.as_tensor(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8), device=cuda)
                for _ in range(2))
    pair = make_pair(h=h, w=w, max_dis=max_dis, seed=0)
    l, r = (bgr_to_rgb(torch.as_tensor(x, device=cuda))
            for x in (pair.left, pair.right))
    if rows is not None:
        l, r = l[rows], r[rows]
    return l, r


@pytest.mark.parametrize("h,w,max_dis,rows", [
    (375, 450, 12, None), (375, 450, 60, None), (375, 1242, 128, None),
    (375, 450, 60, slice(125, 250)), (6, 1, 3, None), (6, 2, 5, None),
    (9, 3, 40, None), (2, 6200, 6000, None)])
def test_grdv_bit_equal_on_the_card(cuda, h, w, max_dis, rows):
    """Both views' GRDV volumes equal the plain version on the same CUDA
    tensors, element for element, at d = 12, 60 (bench) and 128 (KITTI),
    on a tile's full-width band (rows 125-250, as parallel.tiled builds a
    GRD tile's volumes), at widths 1, 2 and 3 (border columns' gradient
    0) and at a depth whose other-view columns take more than 48 KB of
    shared memory a block; one launch for both views, pack_views never
    called."""
    l, r = grd_views(h, w, max_dis, cuda, rows)
    n = grd_volume.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grd_volume, "pack_views", None)
        got = grd_volume.grd_volumes(l, r, max_dis)
    torch.cuda.synchronize()
    assert grd_volume.launches == n + 1
    assert got.shape == (2, l.shape[0], w, max_dis + 1)
    for right in (False, True):
        want = grad_cost.grd_cost_volume(l, r, max_dis, right=right)
        assert int((got[int(right)] != want).sum()) == 0


def test_grdv_takes_views_of_any_strides(cuda):
    """GRDV reads the views with their strides: a column slice, a
    column-major layout, every other row and a crop give the plain
    version's volumes on contiguous copies."""
    l, r = grd_views(64, 120, 20, cuda)
    lt = l.transpose(0, 1).contiguous().transpose(0, 1)
    views = [(l[:, 10:90], r[:, 10:90]), (lt, r),
             (l[::2], r[::2]), (l[5:50, 7:], r[5:50, 7:])]
    for lv, rv in views:
        assert not lv.is_contiguous()
        got = grd_volume.grd_volumes(lv, rv, 20)
        want = grd_volume.grd_volumes_plain(lv.contiguous(),
                                            rv.contiguous(), 20)
        assert torch.equal(got, want)


def cenv_both(l, r, max_dis, wnd):
    """(kernel, plain) census volumes of both views on the same CUDA
    tensors; one CENV call."""
    n = census_volume.launches
    got = census_volume.census_volumes(l, r, max_dis, wnd)
    torch.cuda.synchronize()
    assert census_volume.launches == n + 1
    return got, census_volume.census_volumes_plain(l, r, max_dis, wnd)


@pytest.mark.parametrize("scene", ["bench", "kitti", "small"])
def test_cenv_equal_on_the_card(cuda, scene):
    """CENV against the plain census volumes (both views) on the card,
    element for element, at every level of a pyramid: the bench scene's 5
    CEN_CS_PP levels (D = 61, 31, 16, 8, 4), a KITTI-size level (375 x 1242,
    d = 128) and a 6 x 5 scene's 3 levels (6 x 5, 3 x 3, 2 x 2, the most
    its pyramid takes), narrower and lower than the census window (it
    wraps more than once)."""
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.pyramid import build_pyramid

    h, w, d, levels = {"bench": (375, 450, 60, 5),
                       "kitti": (375, 1242, 128, 1),
                       "small": (6, 5, 8, 3)}[scene]
    if scene == "small":
        rng = np.random.default_rng(5)
        l, r = (torch.as_tensor(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8), device=cuda)
                for _ in range(2))
    else:
        pair = make_pair(h=h, w=w, max_dis=d, seed=0)
        l, r = (torch.as_tensor(x, device=cuda)
                for x in (pair.left, pair.right))
    lp, rp = build_pyramid(l, levels), build_pyramid(r, levels)
    for s in range(levels):
        got, want = cenv_both(bgr_to_rgb(lp[s]), bgr_to_rgb(rp[s]), d >> s,
                              CEN_CS_PP.census_wnd)
        assert got.shape == want.shape == (2, *lp[s].shape[:2],
                                           (d >> s) + 1)
        assert int((got != want).sum()) == 0


@pytest.mark.parametrize("wnd", [1, 3, 5, 7, 11, 13, 15])
def test_cenv_windows_on_the_card(cuda, wnd):
    """Every census window the kernel takes (1 to 15: 0 to 7 words of
    code) on a small scene and on a 6 x 5 one, equal to the plain
    version."""
    for h, w, d in ((24, 40, 12), (6, 5, 7)):
        rng = np.random.default_rng(wnd + w)
        l, r = (torch.as_tensor(rng.integers(0, 256, (h, w, 3),
                                             dtype=np.uint8), device=cuda)
                for _ in range(2))
        got, want = cenv_both(l, r, d, wnd)
        assert int((got != want).sum()) == 0


def test_cenv_strides_and_wide_blocks_on_the_card(cuda):
    """CENV reads views of any strides (a column slice, a column-major
    layout, every other row), and takes a depth whose blocks stage more
    than 48 KB of codes (wnd 15, 1,700 columns at max_dis 1,600)."""
    l, r = grd_views(64, 120, 20, cuda)
    lt = l.transpose(0, 1).contiguous().transpose(0, 1)
    for lv, rv in ((l[:, 10:90], r[:, 10:90]), (lt, r), (l[::2], r[::2])):
        got, want = cenv_both(lv, rv, 20, 9)
        assert torch.equal(got, want)
    rng = np.random.default_rng(9)
    l, r = (torch.as_tensor(rng.integers(0, 256, (2, 1700, 3),
                                         dtype=np.uint8), device=cuda)
            for _ in range(2))
    got, want = cenv_both(l, r, 1600, 15)
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("kernel", ["grdv", "cenv"])
def test_volume_kernels_refuse_blocks_past_the_shared_memory(cuda, kernel):
    """A depth whose block would stage more shared memory than the card
    has (GRDV at max_dis 29,000, CENV's 15-window codes at 7,200): the C
    entry refuses the launch, the wrapper raises RuntimeError and counts
    nothing, and the next call runs (the refusal is not left as the
    runtime's last error) and equals the plain version."""
    mod, call, w, md = {
        "grdv": (grd_volume, lambda a, b, m: grd_volume.grd_volumes(a, b, m),
                 29200, 29000),
        "cenv": (census_volume,
                 lambda a, b, m: census_volume.census_volumes(a, b, m, 15),
                 7300, 7200)}[kernel]
    rng = np.random.default_rng(3)
    l, r = (torch.as_tensor(rng.integers(0, 256, (1, w, 3), dtype=np.uint8),
                            device=cuda) for _ in range(2))
    n = mod.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        call(l, r, md)
    assert mod.launches == n
    ls, rs = l[:, :300], r[:, :300]
    got = call(ls, rs, 40)
    torch.cuda.synchronize()
    assert mod.launches == n + 1
    want = (grd_volume.grd_volumes_plain(ls, rs, 40) if kernel == "grdv"
            else census_volume.census_volumes_plain(ls, rs, 40, 15))
    assert torch.equal(got, want)


def test_cenv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """Windows past 15, even windows, views on two devices, CPU views:
    ValueError, nothing launched; census_wnd 17 refused by run_pair at
    entry."""
    l, r = grd_views(8, 20, 4, cuda)
    n = census_volume.launches
    for lv, rv, wnd in ((l, r, 17), (l, r, 8), (l, r.cpu(), 9),
                        (l.cpu(), r.cpu(), 9), (l.float(), r, 9)):
        with pytest.raises(ValueError):
            census_volume.census_volumes_cuda(lv, rv, 4, wnd)
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    with pytest.raises(ValueError, match="census_wnd"):
        run_pair(pair.left, pair.right, 0,
                 CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11,
                            cost_method=CEN_CS_PP.cost_method,
                            census_wnd=17))
    assert census_volume.launches == n


def test_grd_plain_card_against_cpu(cuda):
    """The 1/3 decision: the plain GRD volume on the card against the same
    plain volume on the CPU.  PyTorch's CUDA division by the scalar 3.0 is
    a multiply by f32(1/3), which rounds some colour sums one ulp away from
    the CPU's true division, so the two differ on some elements, each by
    at most alpha times one ulp of the truncated colour term; GRDV
    multiplies by f32(1/3) too and is bit-equal to the card's plain
    version (test_grdv_bit_equal_on_the_card)."""
    l, r = grd_views(375, 450, 60, cuda)
    counts = []
    for right in (False, True):
        card = grad_cost.grd_cost_volume(l, r, 60, right=right).cpu()
        cpu = grad_cost.grd_cost_volume(l.cpu(), r.cpu(), 60, right=right)
        counts.append(int((card != cpu).sum()))
        assert float((card - cpu).abs().max()) <= 2e-6
    print(f"plain GRD volume, card vs CPU: {counts} differing elements of "
          f"{375 * 450 * 61} a view")
    assert all(c > 0 for c in counts)


def rank_inputs(cfg, h, w, cuda, band=False):
    """K2's real output on a seed-0 scene (the bench tile's band form with
    band=True), the saturation values, and the scene's (h, w)."""
    if band:
        t = bench_tile(cfg, cuda)
        prep = window_cost.prepare_volumes(
            t["imgs"][0], t["vols"][0], t["mcs"][0], half_wnd=cfg.half_wnd,
            max_dis=cfg.max_dis, gamma=cfg.wgt_gamma, rows_extended=True,
            cols_extended=True)
        bounds, (h, w) = t["bounds"][0], (t["hs"], t["ws"])
    else:
        pair = make_pair(h=h, w=w, max_dis=cfg.max_dis, seed=0)
        vd = build_volume_data(torch.as_tensor(pair.left, device=cuda),
                               torch.as_tensor(pair.right, device=cuda), cfg)
        prep = window_cost.prepare_volumes(
            vd.imgs[0], vd.vols[0], vd.max_costs[0], half_wnd=cfg.half_wnd,
            max_dis=cfg.max_dis, gamma=cfg.wgt_gamma)
        bounds = None
    bq, wq = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
        stride=cfg.prescreen_stride, bounds=bounds)
    return bq, wq, prep.max_costs, h, w


def clustered_planes(k, h, w, d, cuda):
    """f32[2, K, H, W, 3] clustered in disparity as the pipeline's
    candidates are: the current plane of a smooth field over [1, d) and
    the propagation stencil's 8 neighbours of it (README_DEMO's first
    sweep), then perturbations of the current plane as the refinement's
    (its disparity moved by up to d / 4, halved each step, its slopes by
    up to 0.05), the first K of these; a few flat planes with taps at
    max_dis - 1 = d - 1."""
    from crossscalepatchmatch_tpu_torch.models.patchmatch import (
        _stencil, stencil_candidates)

    rng = np.random.default_rng(k)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    a = 0.06 * np.sin(ys / 17) + rng.uniform(-0.01, 0.01, (2, h, w))
    b = 0.04 * np.cos(xs / 23) + rng.uniform(-0.01, 0.01, (2, h, w))
    dc = (1 + (d - 2) * (0.5 + 0.45 * np.sin(xs / 41 + ys / 29))
          + rng.uniform(-0.5, 0.5, (2, h, w)))
    field = np.stack([a, b, dc - a * xs - b * ys], -1).astype(np.float32)
    field[:, ::97, ::89] = (0, 0, d - 0.75)
    field = torch.as_tensor(field, device=cuda)
    cands = [field[:, None], stencil_candidates(field,
                                                _stencil(README_DEMO, 0))]
    gen = torch.Generator(device=cuda).manual_seed(k)
    pix = torch.stack(torch.broadcast_tensors(
        torch.as_tensor(xs, device=cuda), torch.as_tensor(ys, device=cuda)),
        -1)
    for j in range(max(0, k - 9)):
        u = torch.rand((2, h, w, 3), generator=gen, device=cuda) * 2 - 1
        dab = 0.05 * 0.5 ** j * u[..., :2]
        ddc = d / 4 * 0.5 ** j * u[..., 2]
        dcv = ddc - (dab * pix).sum(-1)
        cands.append((field + torch.cat([dab, dcv[..., None]], -1))[:, None])
    return torch.cat(cands, 1)[:, :k].contiguous()


@pytest.mark.parametrize("planes", ["random", "clustered"])
@pytest.mark.parametrize("scene,k", [
    ("bench", 1), ("bench", 2), ("bench", 5), ("bench", 8), ("bench", 9),
    ("kitti", 1), ("kitti", 8), ("kitti", 9),
    ("band", 1), ("band", 2), ("band", 5), ("band", 8), ("band", 9),
    ("bench", 16), ("bench", 17), ("bench", 33),
    ("band", 16), ("band", 17), ("band", 33)])
def test_qrank_bit_equal_on_the_card(cuda, scene, k, planes):
    """QRANK on K2's real output (seed-0 README_DEMO pair, KITTI pair with
    D = 129, and the bench tile's band-form bq), random and wild planes or
    candidates clustered like the pipeline's: bit-equal to the plain
    ranking of each view on the same CUDA tensors; one launch for both
    views.  K = 8 and 9 are the stencil's sizes; at K = 5 a pixel's
    (candidate, quadrant) items straddle two warps; 16 is one whole chunk
    of the kernel's 16 candidates, 17 and 33 end on a chunk of one after
    one or two whole ones.  Each view's last tile of 64 pixels is partial
    at the bench and KITTI shapes (46 and 22 pixels), so its items are no
    multiple of the block's 128 lanes."""
    from crossscalepatchmatch_tpu_torch import KITTI

    cfg = KITTI if scene == "kitti" else README_DEMO
    w = 1242 if scene == "kitti" else 450
    bq, wq, mc, h, w = rank_inputs(cfg, 375, w, cuda, band=scene == "band")
    if planes == "random":
        abc = torch.as_tensor(random_planes(k, h, w, cfg.max_dis, seed=k),
                              device=cuda)
    else:
        abc = clustered_planes(k, h, w, cfg.max_dis, cuda)
    n = quadrant_rank.launches
    got = quadrant_rank.quadrant_rank(bq, wq, mc, abc, half_wnd=cfg.half_wnd,
                                      max_dis=cfg.max_dis)
    torch.cuda.synchronize()
    assert quadrant_rank.launches == n + 1
    want = torch.stack([prescreen_volume.quadrant_prescreen_cost(
        bq[v], wq[v], mc[v], abc[v], half_wnd=cfg.half_wnd,
        max_dis=cfg.max_dis) for v in range(2)])
    assert got.shape == (2, k, h, w)
    assert int((got != want).sum()) == 0


def test_grdv_qrank_wrappers_reject_what_the_kernels_do_not_take(cuda):
    l, r = grd_views(8, 20, 4, cuda)
    kw = dict(alpha=0.1, tau_clr=10.0, tau_grd=2.0, border_thres=3.0)
    n = grd_volume.launches
    for lv, rv, md in ((l.float(), r, 4), (l, r[..., :2], 4), (l, r[:7], 4),
                       (l, r.cpu(), 4), (l.cpu(), r.cpu(), 4), (l, r, -1)):
        with pytest.raises(ValueError):
            grd_volume.grd_volumes_cuda(lv, rv, md, **kw)
    assert grd_volume.launches == n
    bq = torch.zeros((2, 4, 5, 6, 9), device=cuda)
    wq = torch.zeros((2, 4, 5, 6), device=cuda)
    mc = torch.ones(2, device=cuda)
    abc = torch.zeros((2, 3, 5, 6, 3), device=cuda)
    n = quadrant_rank.launches
    for args in ((bq.double(), wq, mc, abc),
                 (bq.permute(0, 2, 3, 1, 4).contiguous(), wq, mc, abc),
                 (bq, wq, mc, abc.transpose(2, 3).contiguous()
                  .transpose(2, 3)),
                 (bq, wq.cpu(), mc, abc), (bq, wq, mc.cpu(), abc),
                 (bq.cpu(), wq.cpu(), mc.cpu(), abc.cpu())):
        with pytest.raises(ValueError):
            quadrant_rank.quadrant_rank_cuda(*args, half_wnd=1, max_dis=8)
    with pytest.raises(ValueError):        # taps past the depth
        quadrant_rank.quadrant_rank_cuda(bq, wq, mc, abc, half_wnd=1,
                                         max_dis=9)
    assert quadrant_rank.launches == n
    out = quadrant_rank.quadrant_rank_cuda(bq, wq, mc, abc, half_wnd=1,
                                           max_dis=8)
    assert quadrant_rank.launches == n + 1 and out.shape == (2, 3, 5, 6)


# -- RPROP: a refinement stage's proposal -----------------------------------

def rprop_planes(h, w, seed, device):
    """Both views' planes as the optimizer holds them: slants in [-1, 1]
    (a tenth near-vertical, up to 1e3), disparities in [0, 128), and a
    flat plane through 0 at the origin."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-1, 1, (2, h, w, 2)).astype(np.float32)
    ab[rng.uniform(size=(2, h, w)) < 0.1] *= np.float32(1e3)
    d = rng.uniform(0, 128, (2, h, w)).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    c = d - ab[..., 0] * xs - ab[..., 1] * ys
    abc = np.concatenate([ab, c[..., None]], -1)
    abc[:, 0, 0] = 0.0
    return torch.as_tensor(abc, device=device)


def ulp_gap(got, want) -> int:
    """The largest distance in units in the last place between two f32
    tensors of finite values."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(got) - ordered(want)).abs().max())


class RefineOnly:
    """A draw source's init and refine draws without its propose method:
    the optimizer then proposes through perturb_planes (the generic
    path)."""

    def __init__(self, draws):
        self.draws = draws

    def init(self, *a):
        return self.draws.init(*a)

    def refine(self, *a):
        return self.draws.refine(*a)


def test_cuda_sum_of_three_is_the_order_rprop_follows(cuda):
    """The premise of RPROP's three-term sums: PyTorch's CUDA sum over a
    last axis of 3 adds elements 0 and 2, then 1 (and +0)."""
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (200_000, 3)).astype(np.float32) * 1e3, device=cuda)
    want = ((v[:, 0] + v[:, 2]) + v[:, 1]) + 0.0
    assert torch.equal(v.sum(-1), want)


@pytest.mark.parametrize("hw", [(375, 450), (375, 1242), (125, 225),
                                (1, 1), (1, 7), (7, 1), (2, 64), (1, 129),
                                (3, 5), (17, 129)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", [1, 4, 5, 10])
def test_rprop_bit_equal_on_the_card(cuda, hw, k):
    """RPROP against its plain version on the same CUDA tensors (the plain
    Philox's draws, on the card, fed to perturb_planes): every candidate
    bit-equal, for both views; cold and warm phases, with and without a
    tile, rounds from 0 and from the middle of a schedule.  The plain
    Philox on the card equals the CPU's.  The shapes: the bench and KITTI
    frames, the bench's band tile, tiny and odd frames, a view of exactly
    one block of 128 pixels and one of 129."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose as rp
    from crossscalepatchmatch_tpu_torch.utils.rng import (PHASE_WARM,
                                                          TorchDraws)

    h, w = hw
    abc = rprop_planes(h, w, seed=k + h, device=cuda)
    zs = (64.0 / 2.0 ** np.arange(12)).astype(np.float32)
    ns = zs / zs[0]
    for draws, first in ((TorchDraws(2 ** 31 + 5, cuda), 0),
                         (TorchDraws(7, cuda, tile=3), 12 - k),
                         (TorchDraws(7, cuda, refine_phase=PHASE_WARM), 1)):
        rounds = range(first, first + k) if first + k <= 12 else range(k)
        n = rp.launches
        got = draws.propose(abc, 2, rounds, zs, ns, 1e-8)
        torch.cuda.synchronize()
        assert rp.launches == n + 1
        want = rp.refine_propose_plain(
            abc, draws.key, phase=draws.refine_phase, iteration=2,
            rounds=rounds, zs=zs, ns=ns, eps=1e-8)
        assert got.shape == (2, k, h, w, 3)
        # a large jitter of the normal can make a plane of NaNs: both
        # paths then hold NaN there
        bad = (got != want) & ~(got.isnan() & want.isnan())
        diff = int(bad.sum())
        fin = bad & got.isfinite() & want.isfinite()
        gap = ulp_gap(got[fin], want[fin]) if fin.any() else 0
        assert diff == 0, (f"{diff} differ ({int(fin.sum())} of them "
                           f"finite, at most {gap} ulp); by component "
                           f"{bad.sum((0, 1, 2, 3)).tolist()}")
    cpu = rp.refine_draws(draws.key, PHASE_WARM, 2, 1, 3, (h, w), 1.5,
                          0.25, "cpu")
    card = rp.refine_draws(draws.key, PHASE_WARM, 2, 1, 3, (h, w), 1.5,
                           0.25, cuda)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("preset", ["README_DEMO", "KITTI", "CEN_CS_PP",
                                    "warm", "sequential"])
def test_rprop_pair_maps_equal_to_the_generic_path(cuda, preset):
    """A pipeline pair on the card through RPROP gives the same maps and
    planes as through perturb_planes fed the same draws; one launch a
    stage, and every refine span `fused`."""
    import dataclasses

    from crossscalepatchmatch_tpu_torch import KITTI
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_warm
    from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose as rp
    from crossscalepatchmatch_tpu_torch.utils import spans
    from crossscalepatchmatch_tpu_torch.utils.rng import (PHASE_WARM,
                                                          TorchDraws)

    cfg = {"README_DEMO": README_DEMO, "KITTI": KITTI,
           "CEN_CS_PP": CEN_CS_PP, "warm": README_DEMO,
           "sequential": dataclasses.replace(README_DEMO,
                                             batch_refine=False)}[preset]
    pair = make_pair(h=96, w=160, max_dis=cfg.max_dis, seed=3)
    l, r = (torch.as_tensor(x, device=cuda) for x in (pair.left,
                                                      pair.right))
    if preset == "warm":
        prior = run_pair(l, r, 0, cfg, device=cuda)["abc"]

        def call(d):
            return run_pair_warm(l, r, 5, prior, cfg, 1, device=cuda,
                                 draws=d)
        draws = TorchDraws(5, cuda, refine_phase=PHASE_WARM)
        stages = cfg.refine_stages
    else:
        def call(d):
            return run_pair(l, r, 5, cfg, device=cuda, draws=d)
        draws = TorchDraws(5, cuda)
        stages = cfg.max_iter * (cfg.refine_stages if cfg.batch_refine
                                 else len(cfg.refinement_schedule()))
    n = rp.launches
    with spans.recording() as rec:
        got = call(draws)
    torch.cuda.synchronize()
    assert rp.launches == n + stages
    assert [sp.attrs["fused"] for sp in rec if sp.name == "refine"] == [
        True] * stages
    want = call(RefineOnly(draws))
    assert rp.launches == n + stages
    for key in ("dis", "abc"):
        assert torch.equal(got[key], want[key]), key


def test_rprop_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose as rp

    abc = rprop_planes(5, 6, seed=0, device=cuda)
    zs = np.ones(20, np.float32)
    kw = dict(key=(1, 2), phase=1, iteration=0, zs=zs, ns=zs, eps=1e-8)
    n = rp.launches
    for a, rounds in ((abc.cpu(), range(4)), (abc.double(), range(4)),
                      (abc.transpose(1, 2), range(4)),
                      (abc[..., :2].contiguous(), range(4)),
                      (abc, range(17)), (abc, range(0)),
                      (abc, range(0, 8, 2))):
        with pytest.raises(ValueError):
            rp.refine_propose_cuda(a, rounds=rounds, **kw)
    assert rp.launches == n
    out = rp.refine_propose_cuda(abc, rounds=range(16), **kw)
    assert rp.launches == n + 1 and out.shape == (2, 16, 5, 6, 3)


# -- BFV: the bilateral volume filter (the BF aggregator) --------------------

def bfv_scene(h, w, max_dis, cuda, seed=0):
    """Both views' GRD volumes f32[2, H, W, D] of a synthetic pair (the
    kernel GRDV's, equal to the plain version's) and their BGR guides."""
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb

    p = make_pair(h=h, w=w, max_dis=max(min(max_dis, w // 4), 1),
                  seed=seed)
    l, r = (torch.as_tensor(v, device=cuda) for v in (p.left, p.right))
    vols = grd_volume.grd_volumes(bgr_to_rgb(l), bgr_to_rgb(r), max_dis)
    return vols, torch.stack([l, r])


@pytest.mark.parametrize("h,w,max_dis,wnd,block", [
    (375, 450, 60, 35, None), (375, 1242, 128, 35, None),
    (24, 29, 15, 35, None), (6, 8, 3, 35, None), (47, 57, 7, 35, None),
    (40, 64, 300, 7, None), (30, 40, 20, 34, None), (9, 11, 31, 1, None),
    (20, 30, 10, 129, None), (30, 70, 127, 35, None),
    (30, 70, 129, 35, None), (30, 70, 130, 35, None),
    (20, 133, 128, 35, (4, 2)), (3, 100, 60, 35, (4, 2)),
    (24, 72, 40, 35, (4, 2))],
    ids=["readme_demo", "kitti", "coarse_level", "tiny_level",
         "narrower_than_window", "three_chunks", "even_window", "one_tap",
         "widest_window", "d128", "d130", "d131", "partial_last_block",
         "height_below_block_rows", "wrap_in_segment"])
def test_bfv_bit_equal_on_the_card(cuda, h, w, max_dis, wnd, block):
    """BFV against filters.bilateral_filter_volume on the same CUDA
    tensors, both views, element for element: README_DEMO's level (375 x
    450, D 61), KITTI's (375 x 1242, D 129), a 5-level pyramid's coarse
    levels narrower and lower than the window (its borders wrap several
    times), more inner slices than one block holds (three chunks), an even
    window, a window of one and the widest window (129, past 48 KB of
    shared memory a block); D 128, 130 and 131 beside 129, so a pixel's
    slices start at every 4-byte phase of 16 (130 and 131 in two chunks);
    and, in blocks of 4 x 2 warps (32 pixels of 4 rows, forced through the
    launch plan), a width whose last block holds 5 pixels, a height of 3
    rows under the block's 4, a width of 72 whose blocks' staged columns
    wrap at both edges.  One launch, slices 0 and D - 1 the input's."""
    from crossscalepatchmatch_tpu_torch.ops import filters
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume

    vols, guides = bfv_scene(h, w, max_dis, cuda)
    n = bilateral_volume.launches
    with pytest.MonkeyPatch.context() as mp:
        if block is not None:
            plan = bilateral_volume.launch_plan
            wx, wy = block
            mp.setattr(bilateral_volume, "launch_plan",
                       lambda *shape: plan(*shape)._replace(
                           wx=wx, wy=wy, smem=bilateral_volume.smem_bytes(
                               plan(*shape).dc, wx, wy, wnd)))
        got = bilateral_volume.bilateral_volumes(vols, guides, wnd)
    torch.cuda.synchronize()
    assert bilateral_volume.launches == n + 1
    assert got.shape == vols.shape
    assert torch.equal(got[..., 0], vols[..., 0])
    assert torch.equal(got[..., -1], vols[..., -1])
    for v in range(2):
        want = filters.bilateral_filter_volume(vols[v], guides[v], wnd=wnd)
        bad = got[v] != want
        assert int(bad.sum()) == 0, (
            f"view {v}: {int(bad.sum())} differ, at most "
            f"{ulp_gap(got[v][bad], want[bad])} ulp")


def test_bfv_one_launch_a_level_in_run_pair(cuda):
    """run_pair with the BF aggregator over a 3-level pyramid on the card:
    one BFV launch and one `aggregate` span a level, the plain filter
    never called, and the maps those of the same pair with the plain
    filter put in the kernel's place."""
    import dataclasses

    from crossscalepatchmatch_tpu_torch.config import Aggregator
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume
    from crossscalepatchmatch_tpu_torch.utils import spans

    cfg = dataclasses.replace(README_DEMO, max_dis=16, wnd_size=9,
                              use_cs=True, scale_num=3, reg_lambda=0.3,
                              aggregator=Aggregator.BF)
    p = make_pair(h=64, w=96, max_dis=16, seed=2)
    l, r = (torch.as_tensor(v, device=cuda) for v in (p.left, p.right))
    reset_counts()
    with spans.recording() as rec:
        got = run_pair(l, r, 3, cfg, device=cuda)
    torch.cuda.synchronize()
    assert bilateral_volume.launches == 3
    assert bilateral_volume.plain_launches == 0
    agg = [sp.attrs for sp in rec if sp.name == "aggregate"]
    assert agg == [{"filter": "BF", "level": s, "slices": (16 >> s) - 1}
                   for s in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bilateral_volume, "bilateral_volumes_cuda",
                   bilateral_volume.bilateral_volumes_plain)
        want = run_pair(l, r, 3, cfg, device=cuda)
    assert bilateral_volume.launches == 3
    for key in ("dis", "valid", "cost", "abc"):
        assert torch.equal(got[key], want[key]), key


def test_bfv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume

    vols, guides = bfv_scene(12, 16, 6, cuda)
    n = bilateral_volume.launches
    for v, g, wnd in ((vols.cpu(), guides, 5), (vols.double(), guides, 5),
                      (vols.transpose(1, 2), guides, 5),
                      (vols, guides[..., :2].contiguous(), 5),
                      (vols, guides.float(), 5), (vols, guides[:1], 5),
                      (vols, guides, 0), (vols, guides, 130),
                      (vols[0], guides[0], 5)):
        with pytest.raises(ValueError):
            bilateral_volume.bilateral_volumes_cuda(v, g, wnd)
    assert bilateral_volume.launches == n
    two = vols[..., :2].contiguous()
    assert bilateral_volume.bilateral_volumes(two, guides, 5) is two
    assert bilateral_volume.launches == n


def test_cuda_mean_of_three_is_the_order_bfv_follows(cuda):
    """The premise of BFV's colour term: PyTorch's CUDA mean over a last
    axis of 3 adds elements 0 and 2, then 1, and multiplies by f32(1/3)."""
    v = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, (375, 1242, 3)).astype(np.float32), device=cuda)
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=cuda)
    want = ((v[..., 0] + v[..., 2]) + v[..., 1]) * third
    assert torch.equal(v.mean(-1), want)


def test_cuda_addcmul_rounds_once_as_bfv_does(cuda):
    """The premise of BFV's slice sums: addcmul_ on CUDA tensors rounds
    s + w * p once (the kernel's fmaf), not the product and then the sum.
    The f64 product of two f32 values is exact, so f32(s + w * p) in f64
    is the single rounding but for double rounding, which these draws do
    not meet."""
    rng = np.random.default_rng(3)
    s, w, p = (torch.as_tensor(rng.uniform(0, 1, 200_000).astype(
        np.float32), device=cuda) for _ in range(3))
    fused = (s.double() + w.double() * p.double()).float()
    assert not torch.equal(fused, s + w * p)    # the draws tell them apart
    assert torch.equal(s.clone().addcmul_(w, p), fused)


# -- one call: its kernels and nothing else --------------------------------

def graph_node_types(fn):
    """The node types of the CUDA graph that capturing one call of fn
    records, after a warm-up call: every kernel or copy fn puts on the
    stream is a node, an allocation from PyTorch's caching allocator
    none; type 0 is a kernel (CU_GRAPH_NODE_TYPE_KERNEL)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    g.reset()
    return kinds


@pytest.mark.parametrize("kernel", ["grdv", "cenv", "rprop", "bfv"])
def test_a_call_launches_its_kernels_and_nothing_else(cuda, kernel):
    """The CUDA graph that capturing one call of a wrapper records holds
    its kernels and no other node, on the bench scene: GRDV one kernel for
    both views (nothing packed before it), CENV two a level (the codes,
    then both views' volumes) over CEN_CS_PP's 5 levels, RPROP one for a
    stage of 4 rounds, BFV one for README_DEMO's level."""
    from crossscalepatchmatch_tpu_torch.models.patchmatch import (
        refinement_magnitudes)
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume
    from crossscalepatchmatch_tpu_torch.ops.pyramid import build_pyramid
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws

    pair = make_pair(seed=0, **BENCH)
    l, r = (torch.as_tensor(x, device=cuda) for x in (pair.left, pair.right))
    if kernel == "grdv":
        lv, rv = bgr_to_rgb(l), bgr_to_rgb(r)

        def call():
            return grd_volume.grd_volumes(lv, rv, 60)
        want = 1
    elif kernel == "cenv":
        lp, rp = build_pyramid(l, 5), build_pyramid(r, 5)
        lvs = [(bgr_to_rgb(lp[s]), bgr_to_rgb(rp[s]), 60 >> s)
               for s in range(5)]

        def call():
            return [census_volume.census_volumes(a, b, m,
                                                 CEN_CS_PP.census_wnd)
                    for a, b, m in lvs]
        want = 2 * len(lvs)
    elif kernel == "rprop":
        abc = rprop_planes(375, 450, seed=1, device=cuda)
        zs, ns = refinement_magnitudes(CEN_CS_PP)
        draws = TorchDraws(0, cuda)

        def call():
            return draws.propose(abc, 1, range(5, 9), zs, ns, CEN_CS_PP.eps)
        want = 1
    else:
        vols, guides = bfv_scene(375, 450, 60, cuda)

        def call():
            return bilateral_volume.bilateral_volumes_cuda(vols, guides, 35)
        want = 1
    assert graph_node_types(call) == [0] * want
