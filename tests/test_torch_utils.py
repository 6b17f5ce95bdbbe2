"""The port's utils/ (profiling, roofline, debug) against the JAX package's,
on the CPU.

roofline.count_plane_cost_work must give the JAX launch model's dict for
every config, and the port's optimizer must launch what it counts;
pipeline_flops' semantic count is the JAX formula; the card's bound helpers
(tools/torch_kernel_ab.py's bounds) keep their pinned values.  debug's
functions give the same text, dicts and pixels as JAX's.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from crossscalepatchmatch_tpu import config as jconfig
from crossscalepatchmatch_tpu.utils import debug as jdebug
from crossscalepatchmatch_tpu.utils import roofline as jroofline
from crossscalepatchmatch_tpu_torch import config as tconfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np
from crossscalepatchmatch_tpu_torch.ops import plane_cost
from crossscalepatchmatch_tpu_torch.ops.cuda import f32_peak
from crossscalepatchmatch_tpu_torch.utils import debug, profiling, roofline

SCHEDULES = {
    "default": {},
    "exact": dict(adopt_mode="exact"),
    "merge_view": dict(merge_view=True),
    "no_sweeps": dict(prop_sweeps=0),
    "sequential_refine": dict(batch_refine=False),
    "window_prescreen": dict(prescreen_mode="window"),
    "cross_scale": dict(use_cs=True, scale_num=3, reg_lambda=0.3),
    "no_far_rings": dict(far_offsets=()),
    "no_prescreen": dict(adopt_mode="exact", prescreen_stride=1),
    "cross_scale_window": dict(use_cs=True, prescreen_mode="window"),
    "rank_only": dict(adopt_mode="rank", refine_stages=1),
}


def both(**kw):
    return jconfig.CSPMConfig(**kw), tconfig.CSPMConfig(**kw)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_count_plane_cost_work_matches_jax(name):
    jcfg, tcfg = both(**SCHEDULES[name])
    assert roofline.count_plane_cost_work(tcfg) == \
        jroofline.count_plane_cost_work(jcfg)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_semantic_flops_match_jax(name):
    jcfg, tcfg = both(**SCHEDULES[name])
    got = roofline.pipeline_flops(tcfg, 375, 450)
    want = jroofline.pipeline_flops(jcfg, 375, 450)
    assert set(got) == set(want)
    assert got["semantic_flops"] == want["semantic_flops"]
    assert got["transcendentals"] == want["transcendentals"]
    assert got["executed"] > 0 and got["hbm_bytes"] > 0


def test_executed_counts_follow_the_schedule_and_the_volume_type():
    """More exact launches execute more; bf16 kernel volumes read half the
    f32 pair-layout bytes; the executed count of the default schedule is
    its window samples (exact border counts) plus the ranking and K2."""
    cfg = tconfig.CSPMConfig()
    dflt = roofline.pipeline_flops(cfg, 375, 450)
    exact = roofline.pipeline_flops(tconfig.CSPMConfig(adopt_mode="exact"),
                                    375, 450)
    f32 = roofline.pipeline_flops(tconfig.CSPMConfig(vol_dtype="f32"),
                                  375, 450)
    assert exact["executed"] > dflt["executed"]
    assert f32["hbm_bytes"] > dflt["hbm_bytes"]
    assert f32["executed"] == dflt["executed"]
    c = roofline.count_plane_cost_work(cfg)
    hw, d = cfg.half_wnd, cfg.max_dis + 1
    window = 2 * roofline.axis_count(375, hw, 1, 0) * roofline.axis_count(
        450, hw, 1, 0)
    k_total = 11          # the launches' candidates (JAX test_roofline)
    want = (k_total * window * (roofline.FLOPS_IN_IMAGE
                                + roofline.FLOPS_IN_RANGE)
            + c["rank_cands"] * 375 * 450 * 2 * (
                roofline.RANK_FLOPS_CENTER
                + 4 * roofline.RANK_FLOPS_PER_QUADRANT)
            + roofline.quadrant_build_samples(375, 450, hw, 2) * (2 * d + 1))
    assert dflt["executed"] == want
    assert dflt["kernel_launches"] == c["launches"] + 1


@pytest.mark.parametrize("name", ["default", "exact", "merge_view",
                                  "no_sweeps", "window_prescreen",
                                  "cross_scale"])
def test_port_launches_what_the_model_counts(name):
    """A 32x48 CPU run of the port: one plain window-cost call (cross-scale
    or single-scale, window prescreen included) per view and launch of
    the model."""
    kw = dict(SCHEDULES[name])
    if kw.get("use_cs"):
        kw["scale_num"] = 2
    cfg = tconfig.CSPMConfig(max_dis=8, dis_scale=16, wnd_size=7, **kw)
    pair = make_pair(h=32, w=48, max_dis=8, seed=1)
    plane_cost.launches = plane_cost.cross_scale_launches = 0
    run_pair_np(pair.left, pair.right, cfg, device="cpu")
    plain = (plane_cost.cross_scale_launches if cfg.use_cs
             else plane_cost.launches)
    assert plain == 2 * roofline.count_plane_cost_work(cfg)["launches"]


def pinned_planes():
    rng = np.random.default_rng(5)
    return torch.as_tensor(np.stack([
        rng.uniform(-0.3, 0.3, (2, 2, 9, 13)),
        rng.uniform(-0.3, 0.3, (2, 2, 9, 13)),
        rng.uniform(-2, 14, (2, 2, 9, 13))], -1).astype(np.float32))


def test_bound_helpers_keep_their_values():
    """The values the card's bound helpers have given since they were
    written (tools/torch_kernel_ab.py's bounds)."""
    assert [roofline.axis_count(13, 3, 1, 0), roofline.axis_count(13, 3, 2, 0),
            roofline.axis_count(13, 3, 1, 1),
            roofline.axis_count(9, 2, 1, 2, 1, 0, 3),
            roofline.axis_count(375, 17, 1, 0),
            roofline.axis_count(1242, 17, 2, 0)] == \
        [79, 44, 70, 27, 12819, 22194]
    abc = pinned_planes()
    assert roofline.window_samples(abc, 1, 3, 12) == (16116, 11235)
    assert roofline.window_samples(abc, 1, 3, 12, 2) == (4928, 3438)
    assert roofline.window_samples(abc, 3, 2, 12) == (21980, 13946)
    assert roofline.window_samples(
        abc, 2, 2, 12, 1, [((2, 3), (0, 5, 1, 7)),
                           ((2, 3), (0, 3, 0, 4))]) == (2928, 1930)
    assert roofline.bound(1e6, 1e6) == (1e6 / 3.35e12 * 1e3, "bytes")
    assert roofline.bound(1e6, 1e9) == (1e9 / 67e12 * 1e3, "operations")
    assert roofline.bound(12345678, 3.3e9)[1] == "operations"
    assert roofline.nbytes(abc, torch.zeros(3, 5, dtype=torch.bfloat16)) \
        == 5646


def test_quadrant_build_samples():
    """K2's in-image samples, counted directly over the offsets; the band
    form at origin 0 over the whole image is the plain count."""
    h, w, hw, s = 11, 14, 4, 2
    neg, pos = list(range(-hw, 0, s)), list(range(0, hw + 1, s))
    want = 2 * sum(
        1 for offs_y in (neg, pos) for offs_x in (neg, pos)
        for y in range(h) for x in range(w) for oy in offs_y for ox in offs_x
        if 0 <= y + oy < h and 0 <= x + ox < w)
    assert roofline.quadrant_build_samples(h, w, hw, s) == want
    assert roofline.quadrant_build_samples(h, w, hw, s, (0, 0),
                                           (0, h, 0, w)) == want
    assert roofline.quadrant_build_samples(h, w, hw, s, (2, 3),
                                           (0, h + 4, 0, w + 6)) > want


@pytest.mark.parametrize("h,w,hw,band", [
    (9, 11, 2, {}),
    (14, 15, 3, dict(center_row0=3, out_h=8, center_col0=3, out_w=9)),
    (6, 7, 5, dict(center_row0=1, out_h=4))])
def test_median_samples(h, w, hw, band):
    """WMF's window samples, counted directly: at each invalid output pixel
    its in-array window pixels, 1 pass, or 9 where one of them is valid."""
    valid = torch.from_numpy(
        np.random.default_rng(h).uniform(size=(2, h, w)) > 0.6)
    valid[:, :2, :3] = False
    r0, c0 = band.get("center_row0", 0), band.get("center_col0", 0)
    oh, ow = band.get("out_h", h), band.get("out_w", w)
    want = 0
    for v in range(2):
        for y in range(r0, r0 + oh):
            for x in range(c0, c0 + ow):
                if valid[v, y, x]:
                    continue
                win = [(qy, qx) for qy in range(y - hw, y + hw + 1)
                       for qx in range(x - hw, x + hw + 1)
                       if 0 <= qy < h and 0 <= qx < w]
                held = any(valid[v, qy, qx] for qy, qx in win)
                want += len(win) * (9 if held else 1)
    assert roofline.median_samples(valid, hw, **band) == want


def test_median_least_ops():
    """The least work of an exact weighted median, pinned on a small mask:
    each in-array window pixel of each invalid output pixel once, 7
    operations each, and a scan of the 256 levels (2 operations a level)
    where the window holds a valid pixel."""
    valid = torch.ones((2, 4, 5), dtype=torch.bool)
    valid[0, 0, 0] = valid[0, 2, 3] = False
    valid[1] = False
    # view 0: (0, 0) sees rows 0-1 x cols 0-1 (4 pixels, 3 valid), (2, 3)
    # rows 1-3 x cols 2-4 (9 pixels); view 1: 20 invalid pixels, no valid
    # one in any window, so no scan
    win1 = sum((min(y + 1, 3) - max(y - 1, 0) + 1)
               * (min(x + 1, 4) - max(x - 1, 0) + 1)
               for y in range(4) for x in range(5))
    want = 7 * (4 + 9 + win1) + 2 * 256 * 2
    assert roofline.median_least_ops(valid, 1) == want
    assert win1 == (2 + 3 + 3 + 2) * (2 + 3 + 3 + 3 + 2)
    # the band form: output rows 1-2 of view 0 only see (2, 3)
    band = dict(center_row0=1, out_h=2)
    assert roofline.median_least_ops(valid[:1], 1, **band) == 7 * 9 + 512


def test_census_volume_work():
    """CENV's bytes (both u8 RGB views of each level read, both f32
    volumes written) and operations over the bench's 5 CEN_CS_PP levels
    (375x450 d=60: D = 61, 31, 16, 8, 4) and at one level; bound by
    bytes, 0.0286 ms at 3.35 TB/s."""
    b, o = roofline.census_volume_work(375, 450, 60, levels=1)
    assert b == 2 * 375 * 450 * 3 + 2 * 4 * 375 * 450 * 61
    assert o == 3 * 3 * 2 * 375 * 450 * 61 + 2 * 80 * 2 * 375 * 450
    sizes = [(375, 450, 61), (188, 225, 31), (94, 113, 16), (47, 57, 8),
             (24, 29, 4)]
    b5, o5 = roofline.census_volume_work(375, 450, 60, levels=5)
    assert b5 == sum(2 * h * w * 3 + 8 * h * w * d for h, w, d in sizes)
    assert round(roofline.bound(b5, o5)[0], 4) == 0.0286
    assert roofline.bound(b5, o5)[1] == "bytes"
    b, o = roofline.census_volume_work(6, 5, 3, levels=3, wnd=15)
    assert o == sum(3 * 7 * 2 * h * w * d + 2 * 224 * 2 * h * w
                    for h, w, d in ((6, 5, 4), (3, 3, 2), (2, 2, 1)))


def test_grd_volume_work():
    """A pair's GRDV bytes (two u8 RGB views read, both views' f32 volumes
    written: one launch, no packed input) and operations (8 an element)
    at the bench and KITTI shapes; bound by bytes."""
    assert roofline.grd_volume_work(375, 450, 60) == (
        2 * 375 * 450 * 3 + 2 * 375 * 450 * 61 * 4, 2 * 8 * 375 * 450 * 61)
    b, f = roofline.grd_volume_work(375, 1242, 128)
    assert b == 2 * 375 * 1242 * 3 + 2 * 4 * 375 * 1242 * 129
    assert roofline.bound(b, f)[1] == "bytes"


def test_quadrant_rank_work():
    """QRANK's in-range quadrants counted directly on the planes (the
    plain ranking's range test at each anchor), the (view, quadrant,
    pixel) slots whose weight some out-of-range candidate reads, and the
    bytes and operations they give."""
    rng = np.random.default_rng(3)
    k, h, w, hw, md = 3, 7, 9, 3, 10
    abc = torch.from_numpy(np.concatenate([
        rng.uniform(-0.6, 0.6, (2, k, h, w, 2)),
        rng.uniform(-3, 14, (2, k, h, w, 1))], -1).astype(np.float32))
    lo, hi = -(hw + 1) / 2.0, hw / 2.0
    n_rng = 0
    wq_read = set()
    for v, kk, y, x in np.ndindex(2, k, h, w):
        a, b, c = (float(t) for t in abc[v, kk, y, x])
        dc = np.float32(np.float32(np.float32(a) * np.float32(x))
                        + np.float32(np.float32(b) * np.float32(y)))
        dc = np.float32(dc + np.float32(c))
        for q, (ay, ax) in enumerate(((lo, lo), (lo, hi), (hi, lo),
                                      (hi, hi))):
            dq = np.float32(np.float32(dc + np.float32(np.float32(a) * ax))
                            + np.float32(np.float32(b) * ay))
            n_rng += int(1.0 <= dq < md)
            if not 1.0 <= dq < md:
                wq_read.add((v, q, y, x))
    n = 2 * k * h * w
    assert 0 < n_rng < 4 * n
    assert 0 < len(wq_read) < 2 * 4 * h * w
    assert roofline.quadrant_rank_work(abc, hw, md) == (
        n * 12 + 8 + 8 * n_rng + 4 * len(wq_read) + n * 4,
        4 * n + 10 * n_rng + 6 * (4 * n - n_rng))


def rank_rows_brute_force():
    """Planes for the QRANK tap counts and a brute-force count of their
    taps: candidates clustered around one plane (most taps of a row in a
    sector or two), random ones, and flat planes whose first tap is a
    sector's last float (the pair straddles two sectors) or max_dis - 1.

    Returns (abc, d, half_wnd, max_dis, the distinct 32-byte sectors and
    the distinct floats of bq that the in-range taps touch, each counted
    per (view, quadrant, pixel) row, the in-range tap pairs)."""
    rng = np.random.default_rng(5)
    k, h, w, hw, d = 5, 6, 9, 3, 13
    md = d - 1
    base = np.concatenate([rng.uniform(-0.2, 0.2, (2, 1, h, w, 2)),
                           rng.uniform(2, 10, (2, 1, h, w, 1))], -1)
    jitter = np.concatenate([rng.uniform(-0.02, 0.02, (2, 3, h, w, 2)),
                             rng.uniform(-0.6, 0.6, (2, 3, h, w, 1))], -1)
    wild = np.concatenate([rng.uniform(-0.6, 0.6, (2, 1, h, w, 2)),
                           rng.uniform(-3, 16, (2, 1, h, w, 1))], -1)
    abc = np.concatenate([base, base + jitter, wild], 1).astype(np.float32)
    # flat planes on the last candidate: dq = f + 0.5 at every anchor, f
    # max_dis - 1 at one pixel, at the others the sector's last float of
    # the view's quadrant-0 row
    for v, (y, x) in enumerate(((1, 2), (4, 7))):
        row = (4 * v) * h * w + y * w + x
        f = next(f for f in range(1, md) if (row * d + f) % 8 == 7)
        abc[v, -1, y, x] = (0.0, 0.0, f + 0.5)
        abc[v, -1, y, x + 1] = (0.0, 0.0, md - 0.5)
    abc = torch.from_numpy(abc)
    lo, hi = -(hw + 1) / 2.0, hw / 2.0
    sectors = floats = pairs = 0
    f32 = np.float32
    for v, y, x in np.ndindex(2, h, w):
        for q, (ay, ax) in enumerate(((lo, lo), (lo, hi), (hi, lo),
                                      (hi, hi))):
            row = (4 * v + q) * h * w + y * w + x
            taps = set()
            for kk in range(k):
                a, b, c = (f32(t) for t in abc[v, kk, y, x])
                dc = f32(f32(f32(a * f32(x)) + f32(b * f32(y))) + c)
                dq = f32(f32(dc + f32(a * f32(ax))) + f32(b * f32(ay)))
                if 1.0 <= dq < md:
                    pairs += 1
                    g = row * d + int(np.trunc(dq))
                    taps |= {g, g + 1}
            sectors += len({g // 8 for g in taps})
            floats += len(taps)
    return abc, d, hw, md, sectors, floats, pairs


def test_quadrant_rank_sectors():
    """The distinct 32-byte sectors of bq that a QRANK launch's in-range
    taps touch, per (view, quadrant, pixel) row, against a brute-force
    count (rank_rows_brute_force)."""
    abc, d, hw, md, want, _, pairs = rank_rows_brute_force()
    got = roofline.quadrant_rank_sectors(abc, d, hw, md)
    assert got == want
    # the clustered rows share sectors: fewer than one a tap pair
    assert 0 < got < pairs


def test_quadrant_rank_row_work():
    """quadrant_rank_row_work: quadrant_rank_work's bytes with each distinct
    float of a row that the in-range taps read counted once (4 bytes)
    instead of 8 bytes a tap pair, against a brute-force count; the same
    operations.  On clustered candidates it is below quadrant_rank_work,
    on one candidate (no row shared) equal to it."""
    abc, _, hw, md, _, floats, pairs = rank_rows_brute_force()
    work_bytes, work_ops = roofline.quadrant_rank_work(abc, hw, md)
    got_bytes, got_ops = roofline.quadrant_rank_row_work(abc, hw, md)
    assert got_ops == work_ops
    assert got_bytes == work_bytes - 8 * pairs + 4 * floats
    assert got_bytes < work_bytes
    one = abc[:, :1].contiguous()
    assert (roofline.quadrant_rank_row_work(one, hw, md)
            == roofline.quadrant_rank_work(one, hw, md))


def test_fma_chain_plain_and_no_cpu_ceiling():
    """On the CPU the chain is its plain version: with m = c = 1 every
    element gains exactly one per step; measure_f32_peak has no CPU
    figure."""
    x = torch.arange(f32_peak.BLOCK_ELEMS, dtype=torch.float32)
    n = f32_peak.launches
    out = f32_peak.fma_chain(x, 3, 1.0, 1.0)
    assert torch.equal(out, x + 3 * f32_peak.UNROLL)
    assert f32_peak.launches == n
    got = f32_peak.fma_chain(x[:8], 2, 0.5, 1.0)
    want = x[:8].double()
    for _ in range(2 * f32_peak.UNROLL):
        want = want * 0.5 + 1.0
    assert torch.allclose(got.double(), want, rtol=1e-6)
    with pytest.raises(RuntimeError):
        roofline.measure_f32_peak("cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    d = tmp_path / "prof"
    with profiling.trace(str(d)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = d / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "traceEvents" in path.read_text()


def debug_out(h=8, w=10):
    return {
        "abc": np.random.default_rng(0).normal(size=(2, h, w, 3)).astype(
            np.float32),
        "cost": np.random.default_rng(1).random((2, h, w)).astype(
            np.float32),
        "dis": (np.random.default_rng(2).random((2, h, w)) * 60).astype(
            np.uint8),
        "valid": np.random.default_rng(3).random((2, h, w)) < 0.8,
    }


@pytest.mark.parametrize("max_val", [None, 60, 255])
def test_disparity_to_color_matches_jax(max_val):
    dis = np.random.default_rng(7).integers(0, 256, (2, 17, 23),
                                            dtype=np.uint8)
    for v in range(2):
        want = jdebug.disparity_to_color(dis[v], max_val)
        got = debug.disparity_to_color(dis[v], max_val)
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
        assert debug.disparity_to_color(torch.as_tensor(dis[v]),
                                        max_val).tobytes() == want.tobytes()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pixel_info_and_print_array_match_jax(as_tensor):
    out = debug_out()
    port_out = ({k: torch.as_tensor(v) for k, v in out.items()}
                if as_tensor else out)
    for x, y, scale in ((3, 4, 1), (9, 7, 4)):
        want_txt, got_txt = io.StringIO(), io.StringIO()
        want = jdebug.pixel_info(out, x, y, scale, file=want_txt)
        got = debug.pixel_info(port_out, x, y, scale, file=got_txt)
        assert got == want and got_txt.getvalue() == want_txt.getvalue()
    no_valid = {k: v for k, v in out.items() if k != "valid"}
    want_txt, got_txt = io.StringIO(), io.StringIO()
    assert debug.pixel_info(no_valid, 1, 2, file=got_txt) == \
        jdebug.pixel_info(no_valid, 1, 2, file=want_txt)
    assert got_txt.getvalue() == want_txt.getvalue()
    for name, arr in (("cost", out["cost"]), ("abc", out["abc"][0, :2])):
        want_txt, got_txt = io.StringIO(), io.StringIO()
        jdebug.print_array(name, arr, file=want_txt)
        debug.print_array(name, torch.as_tensor(arr) if as_tensor else arr,
                          file=got_txt)
        assert got_txt.getvalue() == want_txt.getvalue()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_save_debug_dumps_match_jax(tmp_path, as_tensor):
    out = debug_out()
    port_out = ({k: torch.as_tensor(v) for k, v in out.items()}
                if as_tensor else out)
    want = jdebug.save_debug_dumps(out, str(tmp_path / "jax"))
    got = debug.save_debug_dumps(port_out, str(tmp_path / "port"))
    assert len(got) == 6
    assert [os.path.basename(p)[len("port"):] for p in got] == \
        [os.path.basename(p)[len("jax"):] for p in want]
    for g, w in zip(got, want):
        a, b = Image.open(g), Image.open(w)
        assert a.mode == b.mode
        assert np.array_equal(np.asarray(a), np.asarray(b))
