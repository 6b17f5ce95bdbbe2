"""The plain reference of the BF configuration (stereobench.reference_bf)
against the port's plain path with the BF aggregator (ops.filters through
ops.cost_volume) on the CPU at 24 x 40, max_dis 8, a 7 x 7 window, single
scale and over a 3-level pyramid: the cost, the maps and the validity of
seeded run_pair calls, held to the configuration's limits; the same
reference without the filter, with the filter's window one ring smaller
and in bf16 arithmetic failing them; what the reference refuses; the
frozen count of stereobench/roofline_bf against utils/roofline's; the
configuration file, its cell and its per-layer reader.  The volume is read
in f32 here, as the plain path reads it on the CPU."""

import dataclasses
import json
import os

import pytest
import torch

from crossscalepatchmatch_tpu_torch.config import KITTI, Aggregator
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
from crossscalepatchmatch_tpu_torch.ops import cost_volume, filters
from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume
from crossscalepatchmatch_tpu_torch.utils import roofline
from stereobench import check, reference, reference_bf, roofline_bf
from stereobench import trace as tracing
from stereobench import workload

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "kitti2015_grd_bf_pp.pairs"
with open(os.path.join(REPO, "stereobench", "configs",
                       "kitti2015_grd_bf_pp.json")) as _f:
    CONFIG = json.load(_f)
LIMITS = CONFIG["limits"]
H, W, MAX_DIS = 24, 40, 8
BF = dataclasses.replace(KITTI, aggregator=Aggregator.BF, max_dis=MAX_DIS,
                         wnd_size=7, vol_dtype="f32")
CS = dataclasses.replace(BF, use_cs=True, scale_num=3, reg_lambda=0.3)
CFGS = {"one_level": BF, "use_cs": CS}


def engine(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (v.value if hasattr(v, "value") else
                       list(v) if isinstance(v, tuple) else v)
    return out


def views(seed):
    p = make_pair(h=H, w=W, max_dis=MAX_DIS, seed=seed)
    return torch.as_tensor(p.left), torch.as_tensor(p.right)


def fails(numbers) -> bool:
    return any(numbers[n] > LIMITS[n] for n in check.NUMBERS)


@pytest.fixture(scope="module")
def runs():
    """The program's outputs of two seeded pairs a configuration."""
    out = {}
    for name, cfg in CFGS.items():
        for seed in (1, 2):
            l, r = views(seed)
            out[name, seed] = (l, r, run_pair(l, r, 10 + seed, cfg,
                                              device="cpu"))
    return out


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", list(CFGS))
def test_program_holds_to_the_reference(runs, name, seed):
    """A seeded run_pair of the port's plain BF path: its cost within the
    configuration's cost_gap of the reference's, its maps and validity
    equal (both filters sum a window in the same order from f32
    constants; the exponent's, the colour mean's and each product-and-sum's
    rounding may differ)."""
    l, r, out = runs[name, seed]
    want = reference_bf.outputs(l, r, out["abc"], engine(CFGS[name]))
    numbers = check.compare(out, want)
    assert not fails(numbers), numbers
    assert not bool(want["valid"].all())    # the post-processing ran


@pytest.mark.parametrize("variant", ["no_filter", "narrower_window",
                                     "bf16_arithmetic"])
@pytest.mark.parametrize("name", list(CFGS))
def test_reference_variants_fail_the_limits(runs, monkeypatch, name,
                                            variant):
    """Put in the program's place, the reference without the filter, with
    the filter's window one ring smaller (5 in place of 7, the plane
    cost's window unchanged) or in bf16 arithmetic (the bf16 control)
    fails the configuration's limits on every seeded pair."""
    e = engine(CFGS[name])
    for seed in (1, 2):
        l, r, out = runs[name, seed]
        want = reference_bf.outputs(l, r, out["abc"], e)
        if variant == "no_filter":
            got = reference.outputs(l, r, out["abc"],
                                    dict(e, aggregator="NONE"))
        elif variant == "narrower_window":
            narrow = reference_bf.bilateral_filter_volume
            with monkeypatch.context() as mp:
                mp.setattr(reference_bf, "bilateral_filter_volume",
                           lambda vol, g, wnd, dt: narrow(vol, g, wnd - 2,
                                                          dt))
                got = reference_bf.outputs(l, r, out["abc"], e)
        else:
            got = reference_bf.outputs(l, r, out["abc"], e,
                                       *reference_bf.CONTROLS["bf16"])
        numbers = check.compare(dict(got, abc=out["abc"]), want)
        assert fails(numbers), (seed, numbers)


@pytest.mark.parametrize("change", [
    {"aggregator": "NONE"}, {"aggregator": "GF"}, {"aggregator": "BOX"},
    {"precompute_volume": False}, {"use_lab_weights": True}])
def test_reference_refuses_what_it_does_not_cover(change):
    with pytest.raises(ValueError):
        reference_bf.check_engine(dict(engine(BF), **change))


def test_filter_against_the_ports_plain_filter():
    """The reference's filter of one view's volume within f32 rounding of
    ops.filters.bilateral_filter_volume, slices 0 and D - 1 equal, at an
    odd and an even window and on a level narrower than the window."""
    g = torch.Generator().manual_seed(5)
    for h, w, d, wnd in ((12, 20, 9, 7), (10, 6, 5, 9), (9, 14, 6, 4)):
        vol = torch.rand((h, w, d), generator=g) * 3
        guide = torch.randint(0, 256, (h, w, 3), generator=g,
                              dtype=torch.uint8)
        got = reference_bf.bilateral_filter_volume(vol, guide, wnd,
                                                   torch.float32)
        want = filters.bilateral_filter_volume(vol, guide, wnd=wnd)
        assert torch.equal(got[..., 0], vol[..., 0])
        assert torch.equal(got[..., -1], vol[..., -1])
        assert float(((got - want).abs() / want.abs()).max()) < 2e-6


@pytest.mark.parametrize("h,w,d,wnd", [(375, 1242, 129, 35),
                                       (375, 450, 61, 35), (24, 40, 9, 7),
                                       (6, 8, 2, 35), (12, 15, 4, 34)])
def test_roofline_bf_is_the_programs_count(h, w, d, wnd):
    assert roofline_bf.bilateral_volume_work(h, w, d, wnd) == \
        roofline.bilateral_volume_work(h, w, d, wnd)
    assert roofline_bf.BF_FLOPS_PER_WEIGHT == roofline.BF_FLOPS_PER_WEIGHT


def test_bilateral_seconds_at_kitti():
    """KITTI's one level: ~3.0e11 operations a pair, 4.53 ms at 67 TFLOP/s,
    bound by operations; none without the BF aggregator or a volume."""
    e = CONFIG["engine"]
    least = roofline_bf.bilateral_seconds(e, 375, 1242)
    _, flops = roofline_bf.bilateral_volume_work(375, 1242, 129, 35)
    assert flops == pytest.approx(3.035e11, rel=1e-3)
    assert least == pytest.approx(flops / 67e12)
    assert roofline_bf.bilateral_seconds(dict(e, aggregator="NONE"), 375,
                                         1242) is None
    assert roofline_bf.bilateral_seconds(dict(e, precompute_volume=False),
                                         375, 1242) is None
    cs = dict(e, use_cs=True, scale_num=3)
    assert roofline_bf.bilateral_seconds(cs, 375, 1242) > least


def test_configuration_is_kittis_with_the_bf_filter():
    """The configuration differs from kitti2015_grd_pp's by the
    aggregator, names its reference, and builds the program's config."""
    with open(os.path.join(REPO, "stereobench", "configs",
                           "kitti2015_grd_pp.json")) as f:
        kitti = json.load(f)
    assert CONFIG["engine"] == dict(kitti["engine"], aggregator="BF")
    assert CONFIG["frame"] == kitti["frame"]
    assert CONFIG["scenes"] == kitti["scenes"]
    assert CONFIG["reduced"] == []
    cell = workload.load_cell(CELL)
    assert cell.reference is reference_bf and cell.chips == 1
    assert workload.engine_config(cell.config).aggregator == Aggregator.BF
    with pytest.raises(ValueError):
        reference.check_engine(CONFIG["engine"])


def test_layer_reader_reads_the_kernels_time():
    """bilateral.roofline_pct: the least time of the traced pairs' filter
    over the device time of the ops named bilateral_volume_kernel; None
    without such an op or without the BF aggregator."""
    read = tracing.reader("bilateral.roofline_pct")
    e = CONFIG["engine"]
    least = roofline_bf.bilateral_seconds(e, 375, 1242)
    ops = [(0.0, 0.010, "void (anonymous namespace)::bilateral_volume_"
            "kernel<4, true>(float const*, unsigned char const*, float*, "
            "(anonymous namespace)::Geom)", "other"),
           (0.010, 0.050, "void cross_scale_kernel<true>(...)",
            "window_cost"),
           (0.050, 0.060, "bilateral_volume_kernel<4, true>", "other")]
    tr = tracing.Trace(ops=ops, pairs=2, window_s=0.1, untraced_s=0.1,
                       engine=e, frame=(375, 1242), warm_iters=None)
    assert read(tr) == pytest.approx(100.0 * 2 * least / 0.020)
    tr.ops = ops[1:2]
    assert read(tr) is None
    tr.ops, tr.engine = ops, dict(e, aggregator="NONE")
    assert read(tr) is None


def test_plain_dispatch_and_the_card_wrappers_checks():
    """CPU tensors take the plain filter (its counter, not the kernel's),
    aggregate_volumes on one view equals the two views' call's view, and
    the card's entry refuses CPU tensors."""
    g = torch.Generator().manual_seed(1)
    vols = torch.rand((2, 10, 12, 6), generator=g)
    guides = torch.randint(0, 256, (2, 10, 12, 3), generator=g,
                           dtype=torch.uint8)
    n, m = bilateral_volume.launches, bilateral_volume.plain_launches
    both = cost_volume.aggregate_volumes(vols, guides, BF)
    one = cost_volume.aggregate_volumes(vols[1:], guides[1:], BF)[0]
    assert bilateral_volume.launches == n
    assert bilateral_volume.plain_launches == m + 2
    assert torch.equal(both[1], one)
    assert torch.equal(both[0], filters.bilateral_filter_volume(
        vols[0], guides[0], wnd=BF.wnd_size))
    with pytest.raises(ValueError):
        bilateral_volume.bilateral_volumes_cuda(vols, guides, 7)
