"""The no-volume reference (stereobench.reference_fly) against the
program's plain no-volume path (ops.onthefly_cost, fly_lerp "cost") on the
CPU at 48 x 64, max_dis 16: the cost of seeded random planes and of a
seeded run_pair's planes, and that run's maps and validity; what the
reference refuses; and the volume cells judged as before the check took
the reference as an argument."""

import dataclasses

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu_torch.config import KITTI
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import pipeline
from crossscalepatchmatch_tpu_torch.ops import onthefly_cost
from crossscalepatchmatch_tpu_torch.ops.scale_weights import scale_weights
from stereobench import check, reference, reference_fly, workload

from .test_sb_roofline import engine

H, W, MAX_DIS = 48, 64, 16
NOVOL = dataclasses.replace(KITTI, precompute_volume=False, max_dis=MAX_DIS,
                            wnd_size=9)
CS = dataclasses.replace(NOVOL, use_cs=True, scale_num=3, reg_lambda=0.3)
# Both sides sum the same f32 products of the 81 window samples in another
# order (the reference a window row at a time, the program sample by
# sample) and weigh them by exp(-l1 * (1 / gamma)) against exp(-l1 /
# gamma): each within a few ulps, so the sums within ~81 * 2^-24 = 4.8e-6 of
# their magnitude; doubled for the levels' weighted sum.
COST_GAP = 1e-5


def _views(seed):
    p = make_pair(h=H, w=W, max_dis=MAX_DIS, seed=seed)
    return torch.as_tensor(p.left), torch.as_tensor(p.right)


def _gap(got, want):
    scale = torch.maximum(want.abs(), want.abs().median())
    return float(((got - want).abs() / scale).max())


def _programs_cost(l, r, abc, cfg):
    fd = onthefly_cost.build_fly_data(l, r, cfg)
    wgts = scale_weights(cfg.scale_num, cfg.reg_lambda) if cfg.use_cs \
        else None
    return onthefly_cost.fly_plane_cost(
        fd, wgts, abc[:, None], half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
        gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
        tau_grd=cfg.tau_grd, border_thres=cfg.border_thres,
        lerp="cost")[:, 0]


@pytest.mark.parametrize("cfg", [NOVOL, CS], ids=["one_level", "use_cs"])
@pytest.mark.parametrize("seed", [1, 2])
def test_cost_of_random_planes(cfg, seed):
    """Slanted random planes whose disparities run past both ends of the
    range, so the saturation is read too."""
    l, r = _views(seed)
    g = torch.Generator().manual_seed(seed)
    abc = torch.empty((2, H, W, 3))
    abc[..., :2] = (torch.rand((2, H, W, 2), generator=g) - 0.5) * 0.6
    abc[..., 2] = torch.rand((2, H, W), generator=g) * (MAX_DIS + 20) - 10
    got = reference_fly.plane_cost(l, r, abc, engine(cfg), torch.float32)
    want = _programs_cost(l, r, abc, cfg)
    assert _gap(got, want) <= COST_GAP


@pytest.mark.parametrize("cfg", [NOVOL, CS], ids=["one_level", "use_cs"])
def test_outputs_of_a_run(cfg):
    """A seeded run_pair of the program's no-volume path on the CPU: its
    cost within COST_GAP, its maps and validity equal."""
    l, r = _views(3)
    out = pipeline.run_pair(l, r, 7, cfg, device="cpu")
    got = reference_fly.outputs(l, r, out["abc"], engine(cfg))
    assert _gap(out["cost"], got["cost"]) <= COST_GAP
    assert torch.equal(out["dis"], got["dis"])
    assert torch.equal(out["valid"], got["valid"])
    assert not bool(got["valid"].all())    # the post-processing ran


def test_saturation_is_grds_constant():
    e = engine(NOVOL)
    assert reference_fly.saturation(e) == onthefly_cost.fly_sat_cost(
        NOVOL.cost_alpha, NOVOL.tau_clr, NOVOL.tau_grd)
    assert reference_fly.saturation(e) == pytest.approx(2.8)


def test_bf16_slices_move_the_cost_only():
    """The control that rounds each slice cost to bf16 moves the cost by
    far more than COST_GAP and the maps not at all."""
    l, r = _views(4)
    out = pipeline.run_pair(l, r, 8, NOVOL, device="cpu")
    e = engine(NOVOL)
    ref = reference_fly.outputs(l, r, out["abc"], e)
    got = reference_fly.outputs(l, r, out["abc"], e,
                                *reference_fly.CONTROLS["bf16_slices"])
    assert _gap(got["cost"], ref["cost"]) > 20 * COST_GAP
    assert torch.equal(got["dis"], ref["dis"])


@pytest.mark.parametrize("change", [
    {"precompute_volume": True}, {"fly_lerp": "image"},
    {"cost_method": "CEN"}, {"aggregator": "BOX"},
    {"use_lab_weights": True}])
def test_refuses_what_it_does_not_cover(change):
    with pytest.raises(ValueError):
        reference_fly.check_engine(dict(engine(NOVOL), **change))


def test_volume_reference_refuses_no_volume():
    with pytest.raises(ValueError):
        reference.check_engine(engine(NOVOL))


@pytest.mark.parametrize("name", ["kitti2015_grd_pp.pairs",
                                  "mb2003_cen_cs_pp.pairs"])
def test_volume_cells_judge_as_before(tiny_root, name):
    """The volume cells' reference is stereobench.reference, and judging
    through the cell gives each kept pair the numbers that the reference's
    outputs, compared directly, give."""
    cell = workload.load_cell(name, root=tiny_root)
    assert cell.reference is reference
    loop = workload.Loop(cell, 2 ** 31 + 5, "cpu")
    win = loop.run(pairs=3)
    e = cell.config["engine"]
    rows = check.judge(win.kept, loop.pool.frame, e, cell.reference,
                       reference.CONTROLS)
    for i, k in enumerate(win.kept):
        l, r = loop.pool.frame(k.index)
        want = reference.outputs(l, r, k.out["abc"], e)
        assert rows["program"][i] == check.compare(k.out, want)
        got = reference.outputs(l, r, k.out["abc"], e, torch.bfloat16,
                                torch.bfloat16)
        assert rows["bf16"][i] == check.compare(
            dict(got, abc=k.out["abc"]), want)
    assert np.isfinite([r["cost_gap"] for r in rows["program"]]).all()
