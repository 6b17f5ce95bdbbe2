"""The port's CUDA kernels K1 (window cost) and K2 (quadrant build) against
their plain PyTorch versions, on the card.

Run on a machine with a CUDA device:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because tests/conftest.py imports jax, which this file does
not need.)  Whether a card is present is decided inside the `cuda` fixture,
so every worker collects the same tests; without one they skip.

Tolerances: f32 volumes |kernel - plain| <= 2e-5 * max(1, |plain|) (the
kernel keeps the plain version's rounding order, so the margin covers only
the exp/sum-order freedom the contract allows); a bf16 volume is compared
with the plain version on the same bf16-rounded values widened to f32, at
the same tolerance.
"""

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.data import make_pair
from crossscalepatchmatch_tpu_torch import README_DEMO, CSPMConfig
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
from crossscalepatchmatch_tpu_torch.ops import plane_cost
from crossscalepatchmatch_tpu_torch.ops import prescreen_volume
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_build
from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost

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
@pytest.mark.parametrize("d,stride", [(8, 1), (40, 2), (70, 2)])
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
    with pytest.raises(ValueError):        # depth beyond the kernel's 128
        quadrant_build.quadrant_volumes_cuda(
            imgs, torch.zeros((2, 8, 12, 129), device=cuda), half_wnd=1,
            gamma=10.0, stride=1)


def test_pipeline_runs_through_the_kernels(cuda):
    pair = make_pair(h=48, w=64, max_dis=12, seed=3)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=11)
    window_cost.launches = quadrant_build.launches = 0
    plane_cost.launches = prescreen_volume.launches = 0
    out = run_pair(pair.left, pair.right, 0, cfg, device=cuda)
    torch.cuda.synchronize()
    assert out["dis"].shape == (2, 48, 64)
    assert window_cost.launches == 10 and quadrant_build.launches == 1
    assert plane_cost.launches == 0 and prescreen_volume.launches == 0
