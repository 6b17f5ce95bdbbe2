"""The reference of PatchMatch Stereo's own data term without a volume
(stereobench.reference_fly_image) against the program's plain no-volume
path in image-lerp mode (ops.onthefly_cost, fly_lerp "image") on the CPU
at 48 x 64, max_dis 16, a 9 x 9 window, one level and 3 levels: the cost
of seeded random planes, of planes whose matches fall past either border
(the wrap) and of a seeded run_pair's planes, and that run's maps and
validity; the cost lerp's reference and both controls failing the
configuration's cost_gap limit on those planes; what the reference
refuses; its imports; the configuration, the frozen count of
stereobench/roofline_fly_image and its per-layer reader."""

import ast
import dataclasses
import json
import os

import pytest
import torch

from crossscalepatchmatch_tpu_torch.config import KITTI
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import pipeline
from crossscalepatchmatch_tpu_torch.ops import onthefly_cost
from crossscalepatchmatch_tpu_torch.ops.scale_weights import scale_weights
from crossscalepatchmatch_tpu_torch.utils import roofline as port_roofline
from stereobench import (check, reference, reference_fly,
                         reference_fly_image, roofline, roofline_fly_image,
                         workload)
from stereobench import trace as tracing

from .conftest import REPO
from .test_sb_roofline import engine

torch.set_num_threads(1)

CELL = "kitti2015_grd_pp_novol_img.pairs"
with open(os.path.join(REPO, "stereobench", "configs",
                       "kitti2015_grd_pp_novol_img.json")) as _f:
    CONFIG = json.load(_f)
LIMIT = CONFIG["limits"]["cost_gap"]
H, W, MAX_DIS = 48, 64, 16
IMG = dataclasses.replace(KITTI, precompute_volume=False, fly_lerp="image",
                          max_dis=MAX_DIS, wnd_size=9)
CS = dataclasses.replace(IMG, use_cs=True, scale_num=3, reg_lambda=0.3)
CFGS = {"one_level": IMG, "use_cs": CS}
# Both sides lerp the same two taps and sum the same f32 products of the 81
# window samples in another order (the reference a window row at a time,
# the program sample by sample) and weigh them by exp(-l1 * (1 / gamma))
# against exp(-l1 / gamma): each within a few ulps, so the sums within
# ~81 * 2^-24 = 4.8e-6 of their magnitude; doubled for the levels'
# weighted sum.  (Read: 5e-7-7e-7.)
COST_GAP = 1e-5


def views(seed):
    p = make_pair(h=H, w=W, max_dis=MAX_DIS, seed=seed)
    return torch.as_tensor(p.left), torch.as_tensor(p.right)


def gap(got, want):
    scale = torch.maximum(want.abs(), want.abs().median())
    return float(((got - want).abs() / scale).max())


def programs_cost(l, r, abc, cfg):
    fd = onthefly_cost.build_fly_data(l, r, cfg)
    wgts = scale_weights(cfg.scale_num, cfg.reg_lambda) if cfg.use_cs \
        else None
    return onthefly_cost.fly_plane_cost(
        fd, wgts, abc[:, None], half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
        gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
        tau_grd=cfg.tau_grd, border_thres=cfg.border_thres,
        lerp="image")[:, 0]


def random_planes(seed):
    """Slanted planes whose disparities run past both ends of the range, so
    the saturation is read too."""
    g = torch.Generator().manual_seed(seed)
    abc = torch.empty((2, H, W, 3))
    abc[..., :2] = (torch.rand((2, H, W, 2), generator=g) - 0.5) * 0.6
    abc[..., 2] = torch.rand((2, H, W), generator=g) * (MAX_DIS + 20) - 10
    return abc


def border_planes():
    """Gently slanted planes of disparity 9.5-14.5 in range everywhere:
    the left view's windows near column 0 match left of it and the right
    view's near the last column right of it, so their taps wrap."""
    abc = torch.zeros((2, H, W, 3))
    abc[..., 0] = 0.02
    abc[..., 1] = -0.03
    xs = torch.arange(W, dtype=torch.float32)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    abc[..., 2] = 12.0 - 0.02 * xs + 0.03 * ys + 2.5 * torch.sin(xs / 7.0)
    return abc


@pytest.fixture(scope="module")
def runs():
    """A seeded run_pair of the program's no-volume image path on the CPU
    for each configuration: (views, outputs)."""
    out = {}
    for name, cfg in CFGS.items():
        l, r = views(3)
        out[name] = (l, r, pipeline.run_pair(l, r, 7, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("seed", [1, 2])
def test_cost_of_random_planes(name, seed):
    cfg = CFGS[name]
    l, r = views(seed)
    abc = random_planes(seed)
    got = reference_fly_image.plane_cost(l, r, abc, engine(cfg),
                                         torch.float32)
    assert gap(got, programs_cost(l, r, abc, cfg)) <= COST_GAP


@pytest.mark.parametrize("name", list(CFGS))
def test_cost_where_matches_wrap(name, monkeypatch):
    """Matches past the border: within COST_GAP of the program, and not
    within it with the taps clamped to the image in place of GrdPC's
    wrap, so the wrap is what is held."""
    cfg = CFGS[name]
    l, r = views(4)
    abc = border_planes()
    e = engine(cfg)
    got = reference_fly_image.plane_cost(l, r, abc, e, torch.float32)
    assert gap(got, programs_cost(l, r, abc, cfg)) <= COST_GAP
    monkeypatch.setattr(reference_fly_image, "handle_border",
                        lambda x, n: x.clamp(0, n - 1))
    clamped = reference_fly_image.plane_cost(l, r, abc, e, torch.float32)
    assert gap(clamped, got) > 100 * COST_GAP


@pytest.mark.parametrize("name", list(CFGS))
def test_outputs_of_a_run(runs, name):
    """The run's cost within COST_GAP, its maps and validity equal."""
    l, r, out = runs[name]
    got = reference_fly_image.outputs(l, r, out["abc"], engine(CFGS[name]))
    assert gap(out["cost"], got["cost"]) <= COST_GAP
    assert torch.equal(out["dis"], got["dis"])
    assert torch.equal(out["valid"], got["valid"])
    assert not bool(got["valid"].all())    # the post-processing ran


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("variant", ["cost_lerp", *reference_fly_image.
                                     CONTROLS])
def test_what_must_fail_the_limit(runs, name, variant):
    """On the run's own planes, the cost lerp's reference (a program that
    ran K5 in K6's place) and both controls (bf16 arithmetic, f32 with
    bf16 taps) read a cost_gap over the configuration's limit."""
    l, r, out = runs[name]
    e = engine(CFGS[name])
    want = reference_fly_image.outputs(l, r, out["abc"], e)
    if variant == "cost_lerp":
        got = reference_fly.outputs(l, r, out["abc"], dict(e, fly_lerp="cost"))
    else:
        got = reference_fly_image.outputs(
            l, r, out["abc"], e, *reference_fly_image.CONTROLS[variant])
    numbers = check.compare(dict(got, abc=out["abc"]), want)
    assert numbers["cost_gap"] > 10 * LIMIT, numbers


def test_saturation_is_grds_constant():
    e = engine(IMG)
    assert reference_fly_image.saturation(e) == onthefly_cost.fly_sat_cost(
        IMG.cost_alpha, IMG.tau_clr, IMG.tau_grd)


@pytest.mark.parametrize("change", [
    {"precompute_volume": True}, {"fly_lerp": "cost"},
    {"cost_method": "CEN"}, {"aggregator": "BOX"}, {"aggregator": "BF"},
    {"use_lab_weights": True}])
def test_refuses_what_it_does_not_cover(change):
    with pytest.raises(ValueError):
        reference_fly_image.check_engine(dict(engine(IMG), **change))


def test_other_references_refuse_the_image_lerp():
    for ref in (reference, reference_fly):
        with pytest.raises(ValueError):
            ref.check_engine(CONFIG["engine"])


def test_imports_torch_and_the_shared_reference_only():
    path = os.path.join(REPO, "stereobench", "reference_fly_image.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            got |= {"." * node.level + (node.module or "") + ":" + a.name
                    for a in node.names}
    assert got <= {"__future__:annotations", "torch", ".:reference"}, got
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_configuration_is_the_novol_file_with_the_image_lerp():
    """The configuration is kitti2015_grd_pp_novol's with fly_lerp "image"
    and its own reference, everything else as the novol file's but its
    name, source, method, deployment, limits and what it assumes about
    fly_lerp; the cell builds the port's KITTI without a volume in
    image-lerp mode."""
    with open(os.path.join(REPO, "stereobench", "configs",
                           "kitti2015_grd_pp_novol.json")) as f:
        novol = json.load(f)
    assert CONFIG["engine"] == dict(novol["engine"], fly_lerp="image")
    assert CONFIG["reference"] == "stereobench.reference_fly_image"
    assert CONFIG["assumed"] == {k: v for k, v in novol["assumed"].items()
                                 if k != "fly_lerp"}
    assert CONFIG["reduced"] == []
    own = {"name", "source", "reference", "assumed", "deployment", "method",
           "engine", "limits"}
    assert set(CONFIG) == set(novol)
    assert all(CONFIG[k] == novol[k] for k in set(novol) - own)
    assert CONFIG["limits"]["dis_diff_px"] == 0
    assert CONFIG["limits"]["valid_diff_px"] == 0
    cell = workload.load_cell(CELL)
    assert cell.reference is reference_fly_image and cell.chips == 1
    assert workload.engine_config(cell.config) == dataclasses.replace(
        KITTI, precompute_volume=False, fly_lerp="image")


def test_frozen_count_is_the_programs():
    assert roofline_fly_image.FLY_IMAGE_FLOPS_IN_RANGE == \
        port_roofline.FLY_FLOPS_IN_RANGE["image"] == 31
    assert roofline.FLOPS_IN_IMAGE == port_roofline.FLOPS_IN_IMAGE
    assert roofline.FLY_PLANE_BYTES == 3 + 4


def test_fly_image_seconds_at_kitti():
    """KITTI's 27 fly launches (15 exact, 12 at stride 2) at 5 + 31
    operations an in-image sample: ~21.8 ms a pair, bound by operations,
    36 / 26 of the cost lerp's count on the same launches; none with a
    volume or in cost-lerp mode."""
    e = CONFIG["engine"]
    least = roofline_fly_image.fly_image_seconds(e, 375, 1242)
    assert least == pytest.approx(21.77e-3, rel=1e-3)
    assert least == pytest.approx(
        roofline.fly_cost_seconds(e, 375, 1242) * 36 / 26, rel=1e-9)
    assert len(roofline.fly_plan(e)) == 27
    assert roofline_fly_image.fly_image_seconds(
        dict(e, fly_lerp="cost"), 375, 1242) is None
    assert roofline_fly_image.fly_image_seconds(
        dict(e, precompute_volume=True), 375, 1242) is None


def test_layer_reader_reads_the_fly_family():
    """fly_image.roofline_pct: the least time of the traced pairs' K6 work
    over the fly family's device time; None without a fly op, in
    cost-lerp mode or with a volume."""
    read = tracing.reader("fly_image.roofline_pct")
    e = CONFIG["engine"]
    least = roofline_fly_image.fly_image_seconds(e, 375, 1242)
    ops = [(0.0, 0.040, "fly_cost_kernel<true, false>", "fly_cost"),
           (0.040, 0.045, "at::native::roll", "other"),
           (0.045, 0.100, "fly_cost_kernel<true, false>", "fly_cost")]
    tr = tracing.Trace(ops=ops, pairs=2, window_s=0.2, untraced_s=0.2,
                       engine=e, frame=(375, 1242), warm_iters=None)
    assert read(tr) == pytest.approx(100.0 * 2 * least / 0.095)
    tr.ops = ops[1:2]
    assert read(tr) is None
    tr.ops = ops
    for change in ({"fly_lerp": "cost"}, {"precompute_volume": True}):
        tr.engine = dict(e, **change)
        assert read(tr) is None


def test_the_cell_judges_through_its_reference(tiny_root):
    """The cell at the harness's tiny size on the CPU: each kept pair's
    numbers are the reference's outputs compared directly, the program
    within its limits, and the bf16-taps control over them."""
    cell = workload.load_cell(CELL, root=tiny_root)
    assert cell.reference is reference_fly_image
    loop = workload.Loop(cell, 2 ** 31 + 11, "cpu")
    win = loop.run(pairs=2)
    e = cell.config["engine"]
    rows = check.judge(win.kept, loop.pool.frame, e, cell.reference,
                       reference_fly_image.CONTROLS)
    for i, k in enumerate(win.kept):
        l, r = loop.pool.frame(k.index)
        want = reference_fly_image.outputs(l, r, k.out["abc"], e)
        assert rows["program"][i] == check.compare(k.out, want)
    limits = cell.config["limits"]
    assert all(r[n] <= limits[n] for r in rows["program"]
               for n in check.NUMBERS)
    assert all(r["cost_gap"] > limits["cost_gap"]
               for r in rows["bf16_taps"])
