"""Kernel CENV (the census-Hamming cost volumes, ops.cuda.census_volume)
and the block layout it shares with GRDV (csrc/volume_walk.cuh) on the
CPU: a numpy form of CENV's order against the port's plain census volume
and the JAX engine's, the split of a level's volume into blocks, the CPU
dispatch, the wrapper's input checks and the card's up-front refusal of a
census window the kernel does not take.

Every comparison is exact: the census volume is integers throughout (the
fixed-point gray image, the comparison bits, their Hamming distances, the
out-of-range cost wnd^2 - 1), exact in f32.  The kernel itself runs only on
the card (tests/test_torch_kernels_gpu.py).
"""

import dataclasses
import functools
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu.ops import census as jcensus
from crossscalepatchmatch_tpu.ops import color as jcolor
from crossscalepatchmatch_tpu_torch import CEN_CS_PP, README_DEMO
from crossscalepatchmatch_tpu_torch.config import CostMethod
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.ops import census
from crossscalepatchmatch_tpu_torch.ops.cost_volume import (build_volume_data,
                                                            build_volumes)
from crossscalepatchmatch_tpu_torch.ops.cuda import (MAX_CENSUS_WND,
                                                     census_volume)
from crossscalepatchmatch_tpu_torch.support import check_supported
from crossscalepatchmatch_tpu_torch.utils.profiling import (launch_counts,
                                                             reset_launch_counts)

# One intra-op thread: the suite runs several pytest-xdist workers on
# a few cores, and per-worker OpenMP pools oversubscribe them.
torch.set_num_threads(1)


def rgb_views(h, w, seed):
    """Two u8[H, W, 3] RGB views: a scene's where it is wide enough,
    random otherwise; a few equal neighbours (comparison bit 0)."""
    if w >= 16 and h >= 16:
        pair = make_pair(h=h, w=w, max_dis=8, seed=seed)
        l, r = (np.ascontiguousarray(x[..., ::-1])
                for x in (pair.left, pair.right))
    else:
        rng = np.random.default_rng(seed)
        l, r = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for _ in range(2))
    l[0, 1] = l[0, 0]
    return l, r


def cenv_model(l_rgb, r_rgb, max_dis, wnd):
    """CENV's order in numpy: the fixed-point gray image, the codes as u32
    words (bit b of word b // 32, window offsets row-major without the
    centre, neighbours taken at a true modulo of the height and width),
    then per view and d the popcount of the XOR of the words, wnd^2 - 1
    where x -+ d leaves the image.  f32[2, H, W, max_dis + 1]."""
    half, bits = wnd // 2, wnd * wnd - 1
    words = (bits + 31) // 32

    def codes(rgb):
        p = rgb.astype(np.int64)
        g = (p[..., 0] * 4899 + p[..., 1] * 9617 + p[..., 2] * 1868
             + (1 << 13)) >> 14
        h, w = g.shape
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        out = np.zeros((words, h, w), np.uint32)
        b = 0
        for wy in range(-half, half + 1):
            for wx in range(-half, half + 1):
                if wy == 0 and wx == 0:
                    continue
                nb = g[(ys + wy) % h, (xs + wx) % w]
                out[b // 32] |= (g > nb).astype(np.uint32) << np.uint32(
                    b % 32)
                b += 1
        return out

    cl, cr = codes(l_rgb), codes(r_rgb)
    _, h, w = cl.shape
    x = np.arange(w)
    vol = np.empty((2, h, w, max_dis + 1), np.float32)
    for v, (ref, oth) in enumerate(((cl, cr), (cr, cl))):
        for d in range(max_dis + 1):
            ox = x + d if v else x - d
            ok = (ox >= 0) & (ox < w)
            o = oth[:, :, np.clip(ox, 0, w - 1)]
            n = np.bitwise_count(ref ^ o).astype(np.int64).sum(0)
            vol[v, ..., d] = np.where(ok, n, bits)
    return vol


@pytest.mark.parametrize("h,w,max_dis,wnd", [
    (20, 27, 12, 9),      # a small scene
    (6, 5, 3, 9),         # the window wraps more than once both ways
    (9, 14, 6, 3),
    (11, 13, 7, 11),
    (7, 10, 16, 5)])      # narrower than max_dis
def test_cenv_order_equals_plain_and_jax(h, w, max_dis, wnd):
    """The numpy form of CENV's order equals the port's plain census
    volume (census_volumes_plain: both views) and the JAX engine's
    census_cost_volume, element for element, left and right reference."""
    l, r = rgb_views(h, w, seed=h * w + wnd)
    got = cenv_model(l, r, max_dis, wnd)
    plain = census_volume.census_volumes_plain(torch.from_numpy(l),
                                               torch.from_numpy(r), max_dis,
                                               wnd)
    np.testing.assert_array_equal(got, plain.numpy())
    lg, rg = jcolor.rgb_to_gray_u8(l), jcolor.rgb_to_gray_u8(r)
    for v in range(2):
        want = jax.jit(functools.partial(
            jcensus.census_cost_volume, max_dis=max_dis, wnd=wnd,
            right=bool(v)))(lg, rg)
        np.testing.assert_array_equal(got[v], np.asarray(want))


WALK_H = (pathlib.Path(census_volume.__file__).parents[2] / "csrc"
          / "volume_walk.cuh")


@functools.lru_cache(maxsize=None)
def walk_constants():
    """The block constants of csrc/volume_walk.cuh (kThreads, kSegMax,
    kSegCols), read from the header, so that the split below is the one
    the kernels are built with."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 WALK_H.read_text()):
        consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    return consts


def seg_len(d):
    """volume_walk.cuh's seg_len: a block's run of outputs at depth d."""
    c = walk_constants()
    return (c["kSegMax"] if d >= c["kSegMax"] // c["kSegCols"]
            else d * c["kSegCols"])


def staged_columns(w, d):
    """volume_walk.cuh's ref_cols_max and oth_cols_max: the reference and
    other-view columns a block stages at most."""
    cols = walk_constants()["kSegCols"]
    return min(w, cols + 2), min(w, cols + 1 + d)


def test_walk_constants_are_the_built_ones():
    """The header's constants as the split below reads them: 256 threads,
    a run of 32 outputs a thread (8,192), 128 reference columns; the run
    is the whole 8,192 from depth 64 on and D * 128 below it."""
    assert walk_constants() == dict(kThreads=256, kSegMax=8192,
                                    kSegCols=128)
    assert [seg_len(d) for d in (1, 32, 61, 63, 64, 129)] == [
        128, 4096, 7808, 8064, 8192, 8192]


def spans(w, d, right):
    """csrc/volume_walk.cuh's split of one row of W * D outputs into
    blocks, in Python: per block (e_lo, e_hi, x_lo, x_hi, o_lo, o_hi)."""
    seg = seg_len(d)
    out = []
    for e_lo in range(0, w * d, seg):
        e_hi = min(e_lo + seg, w * d)
        x_lo, x_hi = e_lo // d, (e_hi - 1) // d
        o_lo = x_lo if right else max(0, x_lo - (d - 1))
        o_hi = min(w - 1, x_hi + d - 1) if right else x_hi
        out.append((e_lo, e_hi, x_lo, x_hi, o_lo, o_hi))
    return out


@pytest.mark.parametrize("w,d", [(1, 1), (2, 7), (5, 61), (450, 61),
                                 (450, 4), (1242, 129), (90, 201),
                                 (700, 8), (3, 5000), (450, 32),
                                 (300, 63), (300, 64), (1000, 100)])
def test_volume_blocks_cover_each_output_once(w, d):
    """The volume kernels' blocks (GRDV and CENV) write every output of a
    row once; every in-range tap (x -+ d inside the image) of a block lies
    in the other-view columns it stages; the columns it stages stay within
    staged_columns, which the C entries' shared memory counts; the
    walk's first element lies at most 31 before a block's run and the
    walk reaches every element of the run."""
    n_ref, n_oth = staged_columns(w, d)
    for right in (False, True):
        seen = np.zeros(w * d, np.int64)
        for e_lo, e_hi, x_lo, x_hi, o_lo, o_hi in spans(w, d, right):
            seen[e_lo:e_hi] += 1
            assert x_hi - x_lo + 1 <= n_ref and o_hi - o_lo + 1 <= n_oth
            e = np.arange(e_lo, e_hi)
            x, dd = e // d, e % d
            assert x.min() == x_lo and x.max() == x_hi
            ox = x + dd if right else x - dd
            ok = (ox >= 0) & (ox < w)
            assert ((ox[ok] >= o_lo) & (ox[ok] <= o_hi)).all()
            # the walk of a row whose first global index is `base`:
            # kThreads threads, each from its first (x, d) by one
            # division, then stepping by kThreads with an add and one
            # compare
            nt = walk_constants()["kThreads"]
            for base in (0, 7, 31 * w * d + 5):
                first = ((base + e_lo) & ~31) - base
                assert e_lo - 31 <= first <= e_lo
                e = first + np.arange(nt)
                x = np.where(e >= 0, e // d, -1 - (-e - 1) // d)
                dd = e - x * d
                sx, sd = nt // d, nt % d
                written = []
                while (e < e_hi).any():
                    assert (x * d + dd == e).all() and (dd < d).all()
                    written.append(e[(e >= e_lo) & (e < e_hi)])
                    e, x, dd = e + nt, x + sx, dd + sd
                    x, dd = np.where(dd >= d, x + 1, x), np.where(
                        dd >= d, dd - d, dd)
                np.testing.assert_array_equal(
                    np.sort(np.concatenate(written)), np.arange(e_lo, e_hi))
        assert (seen == 1).all()


def test_cpu_dispatch_never_calls_the_kernel():
    """On the CPU, build_volume_data (CEN_CS_PP's 5 census levels) and
    build_volumes take the plain census: the CENV counter stays 0, the
    plain one counts a view a level; the volumes equal census_volumes'."""
    pair = make_pair(h=40, w=48, max_dis=8, seed=2)
    cfg = dataclasses.replace(CEN_CS_PP, max_dis=8)
    reset_launch_counts()
    vd = build_volume_data(torch.from_numpy(pair.left),
                           torch.from_numpy(pair.right), cfg)
    counts = launch_counts()
    assert counts["cenv"] == census_volume.launches == 0
    assert counts["cenv_plain"] == census.launches == 2 * cfg.scale_num
    assert counts["grdv"] == counts["grdv_plain"] == 0
    l = torch.from_numpy(np.ascontiguousarray(pair.left[..., ::-1]))
    r = torch.from_numpy(np.ascontiguousarray(pair.right[..., ::-1]))
    assert torch.equal(vd.vols[0], build_volumes(l, r, 8, cfg))
    assert torch.equal(vd.vols[0],
                       census_volume.census_volumes(l, r, 8, cfg.census_wnd))
    assert census_volume.launches == 0


def test_cenv_wrapper_checks_inputs_without_a_card():
    """census_volumes_cuda raises ValueError on what the kernel does not
    take (dtype, shape, depth, window), checked before the device, and on
    CPU tensors; nothing launches."""
    l, r = (torch.from_numpy(x) for x in rgb_views(6, 20, seed=2))
    bad = [(l.float(), r, 4, 9), (l, r[..., :2], 4, 9), (l, r[:5], 4, 9),
           (l[None], r[None], 4, 9), (l, r, -1, 9), (l, r, 4, 17),
           (l, r, 4, 8), (l, r, 4, -1), (l, r, 4, 9)]
    for lv, rv, md, wnd in bad:
        with pytest.raises(ValueError):
            census_volume.census_volumes_cuda(lv, rv, md, wnd)
    with pytest.raises(ValueError, match="CUDA"):
        census_volume.census_volumes_cuda(l, r, 4, MAX_CENSUS_WND)
    assert census_volume.launches == 0


@pytest.mark.parametrize("wnd,refused", [(9, False), (15, False),
                                         (17, True), (21, True)])
def test_card_refuses_census_windows_past_the_kernel(wnd, refused):
    """check_supported refuses a census window above CENV's limit on a
    CUDA device, at entry, and never on the CPU; GRD configs do not use
    the census window."""
    cen = dataclasses.replace(CEN_CS_PP, census_wnd=wnd)
    grd = dataclasses.replace(README_DEMO, census_wnd=wnd)
    assert grd.cost_method == CostMethod.GRD
    check_supported(cen, (64, 80), "cpu")
    check_supported(grd, (64, 80), "cuda")
    if refused:
        with pytest.raises(ValueError, match="census_wnd"):
            check_supported(cen, (64, 80), torch.device("cuda"))
    else:
        check_supported(cen, (64, 80), torch.device("cuda"))
