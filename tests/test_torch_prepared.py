"""The prepared-pair objects of the port's K1/K3/K2, K4 and fly wrappers
(ops.cuda.window_cost.prepare_volumes, ops.cuda.cross_scale_cost.
prepare_cross_scale, ops.cuda.fly_cost.prepare_fly) on the CPU, where they route to the plain versions: a prepared
evaluation equals the unprepared one bit for bit, a call that restates
another geometry raises, the optimizer's cost functions prepare once per
pair, and the kernel layouts (the pair-layout volume, the interleaved
colour + gradient image) index to the values the plain layout holds.

Small shapes, no JAX: the parity of the plain versions with the JAX package
is held in test_torch_ops.py and test_torch_onthefly.py.
"""

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu_torch import CostMethod, CSPMConfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
from crossscalepatchmatch_tpu_torch.ops import cuda as cuda_ops
from crossscalepatchmatch_tpu_torch.ops import (onthefly_cost, plane_cost,
                                                prescreen_volume)
from crossscalepatchmatch_tpu_torch.ops.cost_volume import (VolumeData,
                                                            build_volume_data)
from crossscalepatchmatch_tpu_torch.ops.cuda import (cross_scale_cost,
                                                     fly_cost, quadrant_build,
                                                     window_cost)
from crossscalepatchmatch_tpu_torch.ops.scale_weights import scale_weights

torch.set_num_threads(1)

H, W, D, HW = 12, 20, 6, 2
FLY_KW = dict(gamma=10.0, alpha=0.1, tau_clr=10.0, tau_grd=2.0,
              border_thres=3.0)


def planes(k, seed):
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-0.4, 0.4, (2, k, H, W, 2)).astype(np.float32)
    dc = rng.uniform(0, D, (2, k, H, W)).astype(np.float32)
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return torch.from_numpy(np.concatenate([ab, c[..., None]], axis=-1))


def scene(levels, lab=False, volume=False):
    cfg = CSPMConfig(max_dis=D, wnd_size=2 * HW + 1, use_cs=levels > 1,
                     scale_num=max(levels, 2), reg_lambda=0.3,
                     use_lab_weights=lab, precompute_volume=volume,
                     cost_method=CostMethod.CEN if volume else CostMethod.GRD)
    pair = make_pair(h=H, w=W, max_dis=D, seed=levels)
    l, r = torch.from_numpy(pair.left), torch.from_numpy(pair.right)
    wgts = ([float(x) for x in scale_weights(levels, 0.3)] if levels > 1
            else None)
    if volume:
        return cfg, build_volume_data(l, r, cfg), wgts
    return cfg, onthefly_cost.build_fly_data(l, r, cfg), wgts


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("levels", [1, 3])
def test_prepared_fly_equals_unprepared(levels, lab, stride, k):
    _, fd, wgts = scene(levels, lab)
    abc = planes(k, seed=10 * levels + k)
    for lerp in ("cost", "image"):
        kw = dict(half_wnd=HW, max_dis=D, lerp=lerp, **FLY_KW)
        prep = fly_cost.prepare_fly(fd, wgts, **kw)
        n = onthefly_cost.launches
        got = fly_cost.fly_cost_prepared(prep, abc, half_wnd=HW, max_dis=D,
                                         levels=levels, wnd_stride=stride)
        assert onthefly_cost.launches == n + 1
        want = onthefly_cost.fly_plane_cost(fd, wgts, abc, wnd_stride=stride,
                                            **kw)
        assert got.shape == (2, k, H, W) and torch.equal(got, want)
        assert torch.equal(fly_cost.fly_cost(fd, wgts, abc,
                                             wnd_stride=stride, **kw), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("levels", [1, 3])
def test_prepared_cross_scale_equals_unprepared(levels, k):
    _, vd, wgts = scene(max(levels, 2), volume=True)
    imgs, vols, mcs = (x[:levels] for x in (vd.imgs, vd.vols, vd.max_costs))
    wgts = wgts[:levels]
    abc = planes(k, seed=20 * levels + k)
    kw = dict(half_wnd=HW, max_dis=D, gamma=10.0)
    prep = cross_scale_cost.prepare_cross_scale(imgs, vols, mcs, wgts, **kw)
    n = plane_cost.cross_scale_launches
    got = cross_scale_cost.cross_scale_cost_prepared(
        prep, abc, half_wnd=HW, max_dis=D, levels=levels)
    assert plane_cost.cross_scale_launches == n + 2      # one per view
    want = torch.stack([plane_cost.cross_scale_plane_cost(
        [im[v] for im in imgs], [vo[v] for vo in vols],
        [m[v] for m in mcs], wgts, abc[v], **kw) for v in range(2)])
    assert got.shape == (2, k, H, W) and torch.equal(got, want)
    assert torch.equal(cross_scale_cost.cross_scale_cost(
        imgs, vols, mcs, wgts, abc, **kw), want)
    # on the CPU the volumes are read as they are: no pair-layout copy
    assert prep.vols is vols


def single_scale(seed=0):
    """A GRD single-scale volume pair: (imgs, vols, max_costs)."""
    cfg = CSPMConfig(max_dis=D, wnd_size=2 * HW + 1)
    pair = make_pair(h=H, w=W, max_dis=D, seed=seed)
    vd = build_volume_data(torch.from_numpy(pair.left),
                           torch.from_numpy(pair.right), cfg)
    return vd.imgs[0], vd.vols[0], vd.max_costs[0]


VOL_KW = dict(half_wnd=HW, max_dis=D, gamma=10.0)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_prepared_window_cost_equals_unprepared(stride, k):
    imgs, vols, mcs = single_scale()
    abc = planes(k, seed=30 + k)
    prep = window_cost.prepare_volumes(imgs, vols, mcs, **VOL_KW)
    n = plane_cost.launches
    got = window_cost.window_cost_prepared(prep, abc, half_wnd=HW, max_dis=D,
                                           wnd_stride=stride)
    assert plane_cost.launches == n + 2                  # one per view
    want = torch.stack([plane_cost.window_plane_cost(
        imgs[v], vols[v], mcs[v], abc[v], wnd_stride=stride, **VOL_KW)
        for v in range(2)])
    assert got.shape == (2, k, H, W) and torch.equal(got, want)
    assert torch.equal(window_cost.window_cost(imgs, vols, mcs, abc,
                                               wnd_stride=stride, **VOL_KW),
                       want)
    # on the CPU the volume is read as it is: no pair-layout copy
    assert prep.vols is vols and prep.pvols is None


@pytest.mark.parametrize("stride", [1, 2])
def test_prepared_quadrant_volumes_equal_unprepared(stride):
    imgs, vols, mcs = single_scale(1)
    prep = window_cost.prepare_volumes(imgs, vols, mcs, **VOL_KW)
    n = prescreen_volume.launches
    bq, wq = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=HW, gamma=10.0, stride=stride)
    assert prescreen_volume.launches == n + 2
    parts = [prescreen_volume.build_quadrant_volumes(
        imgs[v], vols[v], half_wnd=HW, gamma=10.0, stride=stride)
        for v in range(2)]
    assert bq.shape == (2, 4, H, W, D + 1) and wq.shape == (2, 4, H, W)
    assert torch.equal(bq, torch.stack([p[0] for p in parts]))
    assert torch.equal(wq, torch.stack([p[1] for p in parts]))
    ub, uw = quadrant_build.quadrant_volumes(imgs, vols, half_wnd=HW,
                                             gamma=10.0, stride=stride)
    assert torch.equal(ub, bq) and torch.equal(uw, wq)


@pytest.mark.parametrize("bad", [dict(half_wnd=HW + 1), dict(max_dis=D + 1),
                                 dict(wnd_stride=0)])
def test_prepared_window_cost_raises_on_a_mismatch(bad):
    imgs, vols, mcs = single_scale()
    prep = window_cost.prepare_volumes(imgs, vols, mcs, **VOL_KW)
    ok = dict(half_wnd=HW, max_dis=D)
    n = plane_cost.launches
    with pytest.raises(ValueError):
        window_cost.window_cost_prepared(prep, planes(1, 0), **{**ok, **bad})
    assert plane_cost.launches == n


@pytest.mark.parametrize("bad", [dict(half_wnd=HW - 1), dict(gamma=11.0),
                                 dict(stride=0)])
def test_prepared_quadrant_volumes_raise_on_a_mismatch(bad):
    """The ROADMAP fault of the JAX quadrant_volumes_prepared (another
    half_wnd silently accepted) does not carry over."""
    imgs, vols, mcs = single_scale()
    prep = window_cost.prepare_volumes(imgs, vols, mcs, **VOL_KW)
    ok = dict(half_wnd=HW, gamma=10.0, stride=2)
    n = prescreen_volume.launches
    with pytest.raises(ValueError):
        quadrant_build.quadrant_volumes_prepared(prep, **{**ok, **bad})
    assert prescreen_volume.launches == n


def test_prepared_volumes_raise_on_other_planes():
    imgs, vols, mcs = single_scale()
    prep = window_cost.prepare_volumes(imgs, vols, mcs, **VOL_KW)
    ok = dict(half_wnd=HW, max_dis=D)
    abc = planes(1, 0)
    for other in (abc[:, :, :H - 1], abc[:, :, :, :W - 2], abc[0],
                  abc.to("meta")):
        with pytest.raises(ValueError):
            window_cost.window_cost_prepared(prep, other, **ok)
    # K2's pair carries no saturation values: no window cost on it
    k2_only = window_cost.prepare_volumes(imgs, vols, None, **VOL_KW)
    with pytest.raises(ValueError):
        window_cost.window_cost_prepared(k2_only, abc, **ok)
    with pytest.raises(ValueError):        # half_wnd past the kernels' 64
        window_cost.prepare_volumes(imgs, vols, mcs, half_wnd=65, max_dis=D,
                                    gamma=10.0)
    with pytest.raises(ValueError):        # planes on another device
        window_cost.window_cost(imgs, vols, mcs, abc.to("meta"), **VOL_KW)


@pytest.mark.parametrize("bad", [dict(half_wnd=HW + 1), dict(max_dis=D + 1),
                                 dict(levels=2), dict(wnd_stride=0)])
def test_prepared_fly_raises_on_a_mismatch(bad):
    _, fd, wgts = scene(3)
    prep = fly_cost.prepare_fly(fd, wgts, half_wnd=HW, max_dis=D,
                                lerp="cost", **FLY_KW)
    ok = dict(half_wnd=HW, max_dis=D, levels=3)
    n = onthefly_cost.launches
    with pytest.raises(ValueError):
        fly_cost.fly_cost_prepared(prep, planes(1, 0), **{**ok, **bad})
    assert onthefly_cost.launches == n


def test_prepared_objects_raise_on_other_planes():
    _, fd, wgts = scene(1)
    prep = fly_cost.prepare_fly(fd, wgts, half_wnd=HW, max_dis=D,
                                lerp="cost", **FLY_KW)
    ok = dict(half_wnd=HW, max_dis=D, levels=1)
    abc = planes(1, 0)
    for other in (abc[:, :, :H - 1], abc[:, :, :, :W - 2], abc[0],
                  abc.to("meta")):
        with pytest.raises(ValueError):
            fly_cost.fly_cost_prepared(prep, other, **ok)
    _, vd, cwgts = scene(2, volume=True)
    cprep = cross_scale_cost.prepare_cross_scale(
        vd.imgs, vd.vols, vd.max_costs, cwgts, half_wnd=HW, max_dis=D,
        gamma=10.0)
    cok = dict(half_wnd=HW, max_dis=D, levels=2)
    for other in (abc[:, :, :H - 1], abc[0], abc.to("meta")):
        with pytest.raises(ValueError):
            cross_scale_cost.cross_scale_cost_prepared(cprep, other, **cok)
    for bad in (dict(half_wnd=HW - 1), dict(max_dis=D // 2),
                dict(levels=3)):
        with pytest.raises(ValueError):
            cross_scale_cost.cross_scale_cost_prepared(cprep, abc,
                                                       **{**cok, **bad})


def test_prepare_rejects_inconsistent_levels():
    _, fd, wgts = scene(3)
    kw = dict(half_wnd=HW, max_dis=D, lerp="cost", **FLY_KW)
    with pytest.raises(ValueError):        # one weight short
        fly_cost.prepare_fly(fd, wgts[:2], **kw)
    with pytest.raises(ValueError):        # weights missing
        fly_cost.prepare_fly(fd, None, **kw)
    with pytest.raises(ValueError):
        fly_cost.prepare_fly(fd, wgts, **{**kw, "half_wnd": 65})
    with pytest.raises(ValueError):
        fly_cost.prepare_fly(fd, wgts, **{**kw, "lerp": "tent"})
    with pytest.raises(ValueError):
        fly_cost.prepare_fly(fd, wgts, **{**kw, "max_dis": 1 << 22})
    _, vd, cwgts = scene(3, volume=True)
    ckw = dict(half_wnd=HW, max_dis=D, gamma=10.0)
    with pytest.raises(ValueError):        # a level of images missing
        cross_scale_cost.prepare_cross_scale(vd.imgs[:2], vd.vols,
                                             vd.max_costs, cwgts, **ckw)
    with pytest.raises(ValueError):        # nine levels
        cross_scale_cost.prepare_cross_scale(vd.imgs * 3, vd.vols * 3,
                                             vd.max_costs * 3, cwgts * 3,
                                             **ckw)
    with pytest.raises(ValueError):        # f64 volumes
        cross_scale_cost.prepare_cross_scale(
            vd.imgs, [v.double() for v in vd.vols], vd.max_costs, cwgts,
            **ckw)


def counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("levels,lab", [(1, False), (1, True), (3, False)])
def test_fly_cost_fns_prepare_once_per_pair(monkeypatch, levels, lab):
    """make_fly_cost_fns packs the images and builds the weight table once;
    the cost functions add no packing however often they run."""
    packs = counting(monkeypatch, fly_cost, "pack_bgr")
    luts = counting(monkeypatch, plane_cost, "asw_lut")
    cfg, fd, _ = scene(levels, lab)
    cost_fn, sparse_fn = pm.make_fly_cost_fns(cfg, fd)
    assert len(packs) == levels * (2 if lab else 1) and len(luts) == 1
    abc = planes(2, 3)
    n = onthefly_cost.launches
    for _ in range(3):
        out = cost_fn(abc)
    if sparse_fn is not None:
        assert sparse_fn(abc).shape == out.shape
    assert onthefly_cost.launches == n + 3 + (sparse_fn is not None)
    assert len(packs) == levels * (2 if lab else 1) and len(luts) == 1


def test_cross_scale_cost_fns_prepare_once_per_pair(monkeypatch):
    cfg, vd, _ = scene(3, volume=True)
    packs = counting(monkeypatch, cross_scale_cost, "pack_bgr")
    cost_fn, _ = pm.make_cost_fns(cfg, vd)
    assert len(packs) == 3
    abc = planes(2, 4)
    n = plane_cost.cross_scale_launches
    for _ in range(3):
        cost_fn(abc)
    assert plane_cost.cross_scale_launches == n + 6
    assert len(packs) == 3


@pytest.mark.parametrize("mode", ["volume", "window"])
def test_single_scale_cost_fns_prepare_once_per_pair(monkeypatch, mode):
    """make_cost_fns prepares the fine level once; the exact evaluations
    (K1), the strided prescreen (K3) and the quadrant build (K2) run on that
    one prepared pair."""
    preps = counting(monkeypatch, pm, "prepare_volumes")
    cfg = CSPMConfig(max_dis=D, wnd_size=2 * HW + 1, prescreen_mode=mode)
    imgs, vols, mcs = single_scale(2)
    vd = VolumeData(imgs=[imgs], vols=[vols], max_costs=[mcs])
    k2 = prescreen_volume.launches
    cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
    assert len(preps) == 1
    assert prescreen_volume.launches == k2 + 2 * (mode == "volume")
    abc = planes(2, 5)
    n = plane_cost.launches
    for _ in range(3):
        out = cost_fn(abc)
    assert sparse_fn(abc).shape == out.shape
    assert plane_cost.launches == n + 2 * (3 + (mode == "window"))
    assert len(preps) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_volume_indexes_the_plain_layout_taps(dtype):
    """take_pair on the pair layout reads what take_depth reads at f and
    f + 1 on the plain layout, for every in-range f (1 <= f <= D - 1 of a
    D + 1 slice volume) and at the clamped last slice."""
    rng = np.random.default_rng(0)
    h, w, d = 5, 7, 9
    vol = torch.from_numpy(rng.uniform(0, 1, (h, w, d)).astype(np.float32)
                           ).to(dtype)
    pvol = cross_scale_cost.pair_volume(vol)
    assert pvol.shape == (h, w, d, 2) and pvol.dtype == dtype
    assert pvol.is_contiguous()
    pos = torch.from_numpy(rng.integers(0, h * w, (4, 50)))
    f = torch.from_numpy(rng.integers(0, d, (4, 50)))
    t0, t1 = cross_scale_cost.take_pair(pvol, pos, f)
    assert torch.equal(t0, plane_cost.take_depth(vol, pos, f))
    assert torch.equal(t1, plane_cost.take_depth(
        vol, pos, torch.clamp(f + 1, max=d - 1)))
    # both views and the levels' leading axes ride along
    both = cross_scale_cost.pair_volume(torch.stack([vol, vol]))
    assert torch.equal(both[1], pvol)


def test_interleaved_reference_image():
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.integers(0, 256, (2, 6, 8, 3), dtype=np.uint8))
    grd = torch.from_numpy(rng.normal(size=(2, 6, 8)).astype(np.float32))
    ref = fly_cost.interleave_ref(img, grd)
    assert ref.shape == (2, 6, 8, 2) and ref.dtype == torch.int32
    assert ref.is_contiguous()
    assert torch.equal(ref[..., 0], cuda_ops.pack_bgr(img))
    assert torch.equal(ref[..., 1].contiguous().view(torch.float32), grd)
