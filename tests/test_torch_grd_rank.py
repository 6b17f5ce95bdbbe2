"""Kernels GRDV (the GRD cost volume, ops.cuda.grd_volume) and QRANK (the
quadrant ranking, ops.cuda.quadrant_rank) on the CPU: a numpy f32 form of
each kernel's order of operations against the port's plain version, the
wrappers' CPU dispatch and input checks, and the JAX parity of what the
wrappers compute.

Tolerances, each with its reason:
  * QRANK's order (csrc/quadrant_rank.cu) is the plain version's, so the
    numpy form is held bit-equal to it;
  * GRDV's order with the mean's true division (the plain version on the
    CPU, and the JAX engine) is held bit-equal to the plain version; with
    the multiply by f32(1/3) the kernel does (what PyTorch's CUDA division
    by the scalar 3.0 computes) its colour term is within one ulp of the
    division's, and the volumes differ only where the colour sum is one
    of the integers whose two roundings differ (5, 7, 10, ... below the
    truncation);
  * against JAX: the GRD volume within 1e-5 absolute (FMA contraction may
    differ between XLA:CPU and PyTorch in the gray image), the ranking
    within 2e-5 relative (the JAX tent against the port's two-tap lerp).
The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.ops import grad_cost as jgc
from crossscalepatchmatch_tpu.ops import prescreen_volume as jpv
from crossscalepatchmatch_tpu_torch import README_DEMO
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.patchmatch import (
    _stencil, stencil_candidates)
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
from crossscalepatchmatch_tpu_torch.ops import grad_cost, prescreen_volume
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volume_data
from crossscalepatchmatch_tpu_torch.ops.cuda import grd_volume
from crossscalepatchmatch_tpu_torch.ops.cuda import quadrant_rank as qrank
from crossscalepatchmatch_tpu_torch.utils.profiling import (launch_counts,
                                                             reset_launch_counts)

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them.
torch.set_num_threads(1)

F32 = np.float32
# colour sums s below 3 * tau_clr where f32(s * f32(1/3)) != f32(s / 3)
THIRD_SPLITS = (5, 7, 10, 14, 17, 20, 23, 25, 28)


def views(h, w, seed):
    """Two u8[H, W, 3] RGB views: a scene's, or random where w is narrow."""
    if w >= 16:
        pair = make_pair(h=h, w=w, max_dis=12, seed=seed)
        return (np.ascontiguousarray(pair.left[..., ::-1]),
                np.ascontiguousarray(pair.right[..., ::-1]))
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                 for _ in range(2))


def grd_model(pix, max_dis, right, third, alpha=0.1, tau_clr=10.0,
              tau_grd=2.0, border=3.0):
    """GRDV's order in numpy f32 on the kernel's input (pack_views'
    i32[2, H, W, 2]): the integer colour sum, times f32(1/3) (third=True)
    or divided by 3, the two truncations and the alpha mix.  Returns
    (volume, colour term, colour sum), each f32[H, W, D]."""
    pix = pix.astype(np.int64)
    ref, oth = (pix[1], pix[0]) if right else (pix[0], pix[1])
    h, w, _ = ref.shape
    chans = lambda p: np.stack([(p[..., 0] >> (8 * c)) & 0xff
                                for c in range(3)], -1)
    grad = lambda p: p[..., 1].astype(np.uint32).view(F32)
    r_c, o_c, r_g, o_g = chans(ref), chans(oth), grad(ref), grad(oth)
    a, b = F32(alpha), F32(1.0 - alpha)
    mean = ((lambda s: s * F32(1.0 / 3.0)) if third
            else (lambda s: s / F32(3.0)))
    bd = F32(border)
    x = np.arange(w)
    vol = np.empty((h, w, max_dis + 1), F32)
    clr_t = np.empty_like(vol)
    sum_t = np.empty_like(vol)
    for d in range(max_dis + 1):
        ox = x + d if right else x - d
        ok = (ox >= 0) & (ox < w)
        oc = o_c[:, np.clip(ox, 0, w - 1)]
        og = o_g[:, np.clip(ox, 0, w - 1)]
        s_in = np.abs(r_c - oc).sum(-1).astype(F32)
        rcf = r_c.astype(F32)
        s_out = ((np.abs(rcf[..., 0] - bd) + np.abs(rcf[..., 1] - bd))
                 + np.abs(rcf[..., 2] - bd))
        clr = np.where(ok, mean(s_in), mean(s_out))
        grd = np.where(ok, np.abs(r_g - og), np.abs(r_g - bd))
        clr_t[..., d] = clr
        sum_t[..., d] = np.where(ok, s_in, s_out)
        vol[..., d] = (a * np.minimum(clr, F32(tau_clr))
                       + b * np.minimum(grd, F32(tau_grd)))
    return vol, clr_t, sum_t


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("h,w,max_dis", [(24, 40, 12), (10, 8, 12),
                                         (12, 64, 60), (6, 1, 3), (6, 2, 5)])
def test_grd_order_equals_plain(h, w, max_dis, right):
    """The division form is the plain version bit for bit; the f32(1/3)
    form's colour term is within one ulp of it, and its volume differs
    only at the colour sums whose two roundings differ, on a few percent
    of the elements (d = 12 and 60, a width with columns x -+ d outside
    the image, one narrower than max_dis)."""
    l, r = views(h, w, seed=h + w)
    lt, rt = torch.from_numpy(l), torch.from_numpy(r)
    plain = grad_cost.grd_cost_volume(lt, rt, max_dis, right=right).numpy()
    pix = grd_volume.pack_views(lt, rt).numpy()
    div, clr_div, sums = grd_model(pix, max_dis, right, third=False)
    np.testing.assert_array_equal(div, plain)
    mul, clr_mul, _ = grd_model(pix, max_dis, right, third=True)
    assert np.all(np.abs(clr_mul - clr_div) <= np.spacing(clr_div))
    split = np.isin(sums, THIRD_SPLITS)
    np.testing.assert_array_equal((clr_mul != clr_div) & (sums < 30), split)
    differ = mul != plain
    assert not (differ & ~split).any()
    if (h, w) == (24, 40):
        assert 0 < differ.sum() < differ.size // 20, differ.sum()


def test_pack_views_layout():
    """pack_views holds each view's RGB bytes (R | G << 8 | B << 16) and
    the plain gradient's f32 bits, whatever the views' strides."""
    from crossscalepatchmatch_tpu_torch.ops.color import rgb_to_gray_f32
    from crossscalepatchmatch_tpu_torch.ops.gradient import sobel_x_k1

    l, r = views(20, 32, seed=4)
    lt = torch.from_numpy(np.ascontiguousarray(l.transpose(1, 0, 2))
                          ).transpose(0, 1)             # strided
    assert not lt.is_contiguous()
    rt = torch.from_numpy(r)
    pix = grd_volume.pack_views(lt, rt)
    assert pix.dtype == torch.int32 and pix.shape == (2, 20, 32, 2)
    assert pix.is_contiguous()
    for v, img in enumerate((l, r)):
        p = pix[v, ..., 0].numpy()
        for c in range(3):
            np.testing.assert_array_equal((p >> (8 * c)) & 0xff,
                                          img[..., c])
        assert (p >> 24 == 0).all()
        want = sobel_x_k1(rgb_to_gray_f32(torch.from_numpy(img)))
        assert torch.equal(pix[v, ..., 1].view(torch.float32), want)


def prologue_model(rgb):
    """GRDV's prologue in numpy from a u8[H, W, 3] RGB view: the packed
    RGB (R | G << 8 | B << 16) and the f32 gradient, gray = (0.299f R +
    0.587f G) + 0.114f B one rounded operation at a time, then g(x) =
    gray(x + 1) - gray(x - 1), 0 in the first and last column."""
    c = rgb.astype(F32)
    gray = (c[..., 0] * F32(0.299) + c[..., 1] * F32(0.587)) \
        + c[..., 2] * F32(0.114)
    grad = np.zeros_like(gray)
    if gray.shape[-1] > 2:
        grad[..., 1:-1] = gray[..., 2:] - gray[..., :-2]
    p = rgb.astype(np.int64)
    return p[..., 0] | p[..., 1] << 8 | p[..., 2] << 16, grad


@pytest.mark.parametrize("h,w", [(5, 1), (4, 2), (6, 3), (24, 40)])
def test_grdv_prologue_equals_pack_views(h, w):
    """What GRDV's prologue forms in shared memory from the u8 views
    equals pack_views (the plain functions) bit for bit: the packed RGB
    and the gradient's f32 bits, at widths 1, 2 (every column a border
    column: gradient 0) and 3, and on a scene."""
    l, r = views(h, w, seed=w)
    pix = grd_volume.pack_views(torch.from_numpy(l), torch.from_numpy(r))
    assert pix.shape == (2, h, w, 2)
    for v, img in enumerate((l, r)):
        packed, grad = prologue_model(img)
        np.testing.assert_array_equal(pix[v, ..., 0].numpy(), packed)
        np.testing.assert_array_equal(pix[v, ..., 1].numpy(),
                                      grad.view(np.int32))
        if w <= 2:
            assert not grad.any()


@pytest.mark.parametrize("w", [1, 2, 3, 9])
def test_sobel_x_k1_departs_from_jax_only_at_width_one(w):
    """The port's sobel_x_k1 equals the JAX package's bit for bit from
    width 2 on.  At width 1 it returns one column of 0 (the column is the
    first and the last, 0 under OpenCV's reflect-101 border), as GRDV's
    prologue forms it; the JAX package's returns two columns of 0
    there."""
    from crossscalepatchmatch_tpu.ops.gradient import sobel_x_k1 as jsobel
    from crossscalepatchmatch_tpu_torch.ops.gradient import sobel_x_k1

    gray = np.random.default_rng(w).uniform(0, 255, (2, 5, w)).astype(F32)
    got = sobel_x_k1(torch.from_numpy(gray)).numpy()
    want = np.asarray(jsobel(jnp.asarray(gray)))
    assert got.shape == gray.shape
    if w == 1:
        assert want.shape == (2, 5, 2)
        assert not got.any() and not want.any()
    else:
        np.testing.assert_array_equal(got, want)


def rank_model(bq, wq, mc, abc, half_wnd, max_dis):
    """QRANK's order in numpy f32 on K2's layout (bq f32[2, 4, H, W, D],
    wq f32[2, 4, H, W]) for both views: f32[2, K, H, W]."""
    _, k, h, w, _ = abc.shape
    xs = np.arange(w, dtype=F32)[None, None, :]
    ys = np.arange(h, dtype=F32)[None, :, None]
    lo, hi = F32(-(half_wnd + 1) / 2.0), F32(half_wnd / 2.0)
    pos = np.arange(h * w).reshape(h, w)
    out = np.empty((2, k, h, w), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for v in range(2):
            a, b, c = abc[v, ..., 0], abc[v, ..., 1], abc[v, ..., 2]
            dc = (a * xs + b * ys) + c
            total = np.zeros((k, h, w), F32)
            for q, (ay, ax) in enumerate(((lo, lo), (lo, hi), (hi, lo),
                                          (hi, hi))):
                dq = (dc + a * ax) + b * ay
                ok = (dq >= F32(1)) & (dq < F32(max_dis))
                f = np.trunc(np.where(ok, dq, F32(0)))
                t = dq - f
                flat = bq[v, q].reshape(h * w, -1)
                fi = f.astype(np.int64)
                t0, t1 = flat[pos, fi], flat[pos, fi + 1]
                val = (F32(1) - t) * t0 + t * t1
                total = total + np.where(ok, val, wq[v, q] * mc[v])
            out[v] = total
    return out


def rank_planes(k, h, w, d, seed):
    """f32[2, K, H, W, 3]: random slanted planes over [-2, d + 2), and on
    the first candidate flat planes whose dq sits below 1, at 1, inside,
    at max_dis - 1 (and just above), at and above max_dis, and NaN / inf."""
    rng = np.random.default_rng(seed)
    ab = rng.uniform(-0.4, 0.4, (2, k, h, w, 2)).astype(F32)
    dc = rng.uniform(-2, d + 2, (2, k, h, w)).astype(F32)
    xs = np.arange(w, dtype=F32)
    ys = np.arange(h, dtype=F32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    abc = np.concatenate([ab, c[..., None]], -1)
    marks = np.array([0.5, 0.999, 1.0, 3.25, d - 1, d - 0.75, d - 1e-4, d,
                      d + 0.5, d + 7, -1.0, np.nan, np.inf, -np.inf], F32)
    flat = abc[:, 0].reshape(2, -1, 3)
    n = min(flat.shape[1], 4 * len(marks))
    flat[:, :n, :2] = 0.0
    flat[:, :n, 2] = np.resize(marks, n)
    abc[:, 0] = flat.reshape(2, h, w, 3)
    return np.ascontiguousarray(abc)


def clustered_planes(k, h, w, d, seed):
    """f32[2, K, H, W, 3]: the propagation stencil's candidates
    (stencil_candidates, README_DEMO's first sweep: the 4-neighbours and
    the far ring at 5) of a smooth plane field over [1, d), so that a
    pixel's candidates cluster in disparity as on the pipeline's path; the
    first candidate of three pixels a view is a flat plane whose taps
    start at max_dis - 1 = d - 1 (the last pair of the row) or at a
    sector's last float of the view's quadrant-0 row (the pair straddles
    two 32-byte sectors)."""
    rng = np.random.default_rng(seed)
    xs = np.arange(w, dtype=F32)
    ys = np.arange(h, dtype=F32)[:, None]
    ab = np.stack(np.broadcast_arrays(
        F32(0.08) * np.sin(ys / 3) + rng.uniform(-0.01, 0.01, (2, h, w)),
        F32(0.05) * np.cos(xs / 4) + rng.uniform(-0.01, 0.01, (2, h, w))),
        -1).astype(F32)
    dc = (1 + (d - 2) * (0.5 + 0.45 * np.sin(xs / 5 + ys / 7))
          + rng.uniform(-0.3, 0.3, (2, h, w))).astype(F32)
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    field = torch.from_numpy(np.concatenate([ab, c[..., None]], -1))
    cands = stencil_candidates(field, _stencil(README_DEMO, 0)).numpy()
    cands = np.ascontiguousarray(np.resize(cands.transpose(1, 0, 2, 3, 4),
                                           (k, 2, h, w, 3)
                                           ).transpose(1, 0, 2, 3, 4))
    for v in range(2):
        first = cands[v, 0]
        first[1, 1] = (0, 0, d - 1 + 0.25)
        for y, x in ((2, 3), (h - 2, w - 3)):
            row = 4 * v * h * w + y * w + x
            f = next(f for f in range(1, d - 1)
                     if (row * (d + 1) + f) % 8 == 7)
            first[y, x] = (0, 0, f + 0.5)
    return cands


@pytest.mark.parametrize("planes", ["random", "clustered"])
@pytest.mark.parametrize("d", [13, 61])
@pytest.mark.parametrize("k", [1, 8])
def test_rank_order_equals_plain(k, d, planes):
    """The numpy form of QRANK's order is the plain ranking bit for bit
    (both views, K = 1 and 8, D = 13 and 61), on K2's plain outputs and on
    random quadrant volumes, for random candidates and for the clustered
    ones of the propagation stencil."""
    h, w, hw, max_dis = 14, 20, 3, d - 1
    rng = np.random.default_rng(k + d)
    img = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    vol = torch.from_numpy(rng.uniform(0, 3, (2, h, w, d)).astype(F32))
    parts = [prescreen_volume.build_quadrant_volumes(
        img[v], vol[v], half_wnd=hw, gamma=10.0, stride=2) for v in range(2)]
    built = (torch.stack([p[0] for p in parts]),
             torch.stack([p[1] for p in parts]))
    rand = (torch.from_numpy(rng.uniform(0, 9, (2, 4, h, w, d)).astype(F32)),
            torch.from_numpy(rng.uniform(0, 2, (2, 4, h, w)).astype(F32)))
    mc = vol.amax(dim=(1, 2, 3))
    make = rank_planes if planes == "random" else clustered_planes
    abc = torch.from_numpy(make(k, h, w, max_dis, seed=d))
    for bq, wq in (built, rand):
        got = qrank.quadrant_rank(bq, wq, mc, abc, half_wnd=hw,
                                  max_dis=max_dis).numpy()
        want = rank_model(bq.numpy(), wq.numpy(), mc.numpy(), abc.numpy(),
                          hw, max_dis)
        assert got.shape == (2, k, h, w) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_cpu_paths_never_call_the_kernels():
    """On the CPU, build_volume_data (GRD) and a README_DEMO-shaped small
    run_pair take the plain versions: the GRDV and QRANK counters stay 0,
    the plain counters move (a GRD volume per view; 14 ranking calls of
    two views a pair)."""
    pair = make_pair(h=32, w=40, max_dis=8, seed=1)
    cfg = dataclasses.replace(README_DEMO, max_dis=8, wnd_size=7)
    reset_launch_counts()
    build_volume_data(torch.from_numpy(pair.left),
                      torch.from_numpy(pair.right), cfg)
    counts = launch_counts()
    assert counts["grdv"] == grd_volume.launches == 0
    assert counts["grdv_plain"] == grad_cost.launches == 2
    assert counts["qrank"] == counts["qrank_plain"] == 0
    reset_launch_counts()
    out = run_pair(pair.left, pair.right, 0, cfg, device="cpu")
    counts = launch_counts()
    assert out["dis"].shape == (2, 32, 40)
    assert counts["grdv"] == counts["qrank"] == 0
    assert counts["grdv_plain"] == 2
    assert counts["qrank_plain"] == prescreen_volume.rank_launches == 28
    assert counts["k2_plain"] == 2 and counts["k1_plain"] > 0


def test_wrappers_check_inputs_without_a_card():
    """The card entries raise ValueError on what the kernels do not take
    (dtype, shape, K2's layout, strides, range bound), checked before the
    device, and on CPU tensors; nothing launches."""
    l, r = (torch.from_numpy(x) for x in views(6, 20, seed=2))
    kw = dict(alpha=0.1, tau_clr=10.0, tau_grd=2.0, border_thres=3.0)
    bad_views = [(l.float(), r, 4), (l, r[..., :2], 4), (l, r[:5], 4),
                 (l[None], r[None], 4), (l, r, -1), (l, r, 4)]
    for lv, rv, md in bad_views:
        with pytest.raises(ValueError):
            grd_volume.grd_volumes_cuda(lv, rv, md, **kw)
    k, h, w, d = 2, 5, 6, 9
    bq = torch.zeros((2, 4, h, w, d))
    wq = torch.zeros((2, 4, h, w))
    mc = torch.ones(2)
    abc = torch.zeros((2, k, h, w, 3))
    ok = (bq, wq, mc, abc)
    bad = [
        (bq.double(), wq, mc, abc), (bq, wq.half(), mc, abc),
        (bq, wq, mc.double(), abc), (bq, wq, mc, abc.double()),
        (bq.permute(0, 2, 3, 1, 4).contiguous(), wq, mc, abc),   # layout
        (bq[:1], wq[:1], mc, abc), (bq, wq[:, :3], mc, abc),
        (bq, wq, mc[:1], abc), (bq, wq, mc, abc[..., :2]),
        (bq, wq, mc, abc[:, :, :4]),
        (bq.transpose(2, 3).contiguous().transpose(2, 3), wq, mc, abc),
        (bq, wq, mc, abc.transpose(2, 3).contiguous().transpose(2, 3)),
        (bq, wq, mc, abc[:, :0]),
    ]
    n = qrank.launches
    for args in bad:
        with pytest.raises(ValueError):
            qrank.quadrant_rank_cuda(*args, half_wnd=1, max_dis=d - 1)
    for kwb in (dict(half_wnd=1, max_dis=d), dict(half_wnd=1, max_dis=0),
                dict(half_wnd=-1, max_dis=d - 1)):
        with pytest.raises(ValueError):
            qrank.quadrant_rank_cuda(*ok, **kwb)
    with pytest.raises(ValueError, match="CUDA"):
        qrank.quadrant_rank_cuda(*ok, half_wnd=1, max_dis=d - 1)
    assert qrank.launches == n and grd_volume.launches == 0


@pytest.mark.parametrize("right", [False, True])
def test_grd_volume_against_jax(right):
    """What build_volumes computes for GRD (grd_volumes on u8 views)
    against the JAX engine's grd_cost_volume, view by view."""
    l, r = views(24, 40, seed=9)
    got = grd_volume.grd_volumes(torch.from_numpy(l), torch.from_numpy(r),
                                 12)[int(right)]
    want = jgc.grd_cost_volume(jnp.asarray(l, jnp.float32),
                               jnp.asarray(r, jnp.float32), 12, right=right)
    assert got.dtype == torch.float32 and got.shape == (24, 40, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_quadrant_rank_against_jax():
    """Both views' ranking in one call against the JAX engine's per-view
    quadrant_prescreen_cost on the JAX quadrant volumes."""
    h, w, d, hw, k = 16, 22, 10, 3, 4
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    vol = rng.uniform(0, 1, (2, h, w, d + 1)).astype(F32)
    mc = vol.max(axis=(1, 2, 3))
    jq = [jpv.build_quadrant_volumes(jnp.asarray(img[v]), jnp.asarray(vol[v]),
                                     half_wnd=hw, gamma=10.0, stride=2)
          for v in range(2)]
    abc = rank_planes(k, h, w, d, seed=3)
    abc[:, 0] = np.nan_to_num(abc[:, 0], nan=-5.0, posinf=99.0,
                              neginf=-99.0)
    got = qrank.quadrant_rank(
        torch.from_numpy(np.stack([np.asarray(q[0]) for q in jq])),
        torch.from_numpy(np.stack([np.asarray(q[1]) for q in jq])),
        torch.from_numpy(mc), torch.from_numpy(abc), half_wnd=hw,
        max_dis=d).numpy()
    want = np.stack([np.asarray(jpv.quadrant_prescreen_cost(
        jq[v][0], jq[v][1], jnp.float32(mc[v]), jnp.asarray(abc[v]),
        half_wnd=hw, max_dis=d)) for v in range(2)])
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2e-5, err.max()
