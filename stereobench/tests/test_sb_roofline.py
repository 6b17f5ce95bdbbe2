"""The frozen work counts give the program's utils/roofline totals, and the
launch plan the launches the program makes."""

import dataclasses

import pytest
import torch

from crossscalepatchmatch_tpu_torch.config import (CEN_CS_PP, KITTI,
                                                   README_DEMO)
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import pipeline
from crossscalepatchmatch_tpu_torch.ops import onthefly_cost, plane_cost
from crossscalepatchmatch_tpu_torch.utils import roofline as port
from stereobench import roofline


def engine(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (v.value if hasattr(v, "value") else
                       list(v) if isinstance(v, tuple) else v)
    return out


CONFIGS = [README_DEMO, CEN_CS_PP, KITTI,
           dataclasses.replace(README_DEMO, prescreen_mode="window"),
           dataclasses.replace(README_DEMO, merge_view=True),
           dataclasses.replace(KITTI, batch_refine=False),
           dataclasses.replace(KITTI, adopt_mode="exact"),
           dataclasses.replace(CEN_CS_PP, adopt_mode="rank", max_iter=2),
           dataclasses.replace(README_DEMO, prop_sweeps=0),
           dataclasses.replace(README_DEMO, precompute_volume=False)]
NOVOL = dataclasses.replace(KITTI, precompute_volume=False)
FLY_CONFIGS = [NOVOL, dataclasses.replace(README_DEMO,
                                          precompute_volume=False),
               dataclasses.replace(NOVOL, batch_refine=False),
               dataclasses.replace(NOVOL, prescreen_stride=1),
               dataclasses.replace(NOVOL, prop_sweeps=0),
               dataclasses.replace(NOVOL, use_cs=True, reg_lambda=0.3)]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_plan_is_the_programs(cfg):
    launches, rank_cands = roofline.plan(engine(cfg))
    want = port.count_plane_cost_work(cfg)
    assert (len(launches), rank_cands) == (want["launches"],
                                           want["rank_cands"])
    assert roofline.rank_iters(engine(cfg)) == cfg.rank_iters
    assert roofline.refinement_rounds(engine(cfg)) == len(
        cfg.refinement_schedule())


@pytest.mark.parametrize("h, w, hw, stride, levels", [
    (7, 9, 2, 1, 1), (13, 11, 3, 2, 1), (12, 17, 2, 1, 3), (9, 10, 4, 1, 4)])
def test_in_image_samples_are_the_programs(h, w, hw, stride, levels):
    e = engine(dataclasses.replace(CEN_CS_PP, wnd_size=2 * hw + 1,
                                   scale_num=levels, use_cs=levels > 1))
    abc = torch.rand((2, 1, h, w, 3))
    n_img, _ = port.window_samples(abc, levels, hw, 8, stride)
    assert roofline.in_image_samples(e, h, w, stride) == n_img


@pytest.mark.parametrize("h, w, hw, stride", [
    (7, 9, 2, 2), (13, 11, 3, 2), (10, 10, 4, 3), (5, 6, 1, 1)])
def test_quadrant_build_samples_are_the_programs(h, w, hw, stride):
    assert roofline.quadrant_build_samples(h, w, hw, stride) == \
        port.quadrant_build_samples(h, w, hw, stride)


@pytest.mark.parametrize("cfg", [KITTI, CEN_CS_PP])
def test_least_times_use_the_peaks(cfg):
    e = engine(cfg)
    h, w = 12, 20
    launches, _ = roofline.plan(e)
    k = sum(kk for kk, _ in launches)
    ops = k * roofline.in_image_samples(e, h, w, 1) * 10
    assert roofline.window_cost_seconds(e, h, w) >= \
        ops / roofline.F32_FLOP_PER_S
    d = cfg.max_dis + 1
    ops = roofline.quadrant_build_samples(h, w, cfg.half_wnd, 2) * (2 * d + 1)
    assert roofline.quadrant_build_seconds(e, h, w) >= \
        ops / roofline.F32_FLOP_PER_S
    assert roofline.quadrant_build_seconds(
        dict(e, prescreen_mode="window"), h, w) is None


@pytest.mark.parametrize("warm", [False, True])
def test_plan_counts_the_launches_of_a_run(warm):
    """The plain window cost's calls in a tiny run on the CPU, cold and warm
    started, are the plan's launches (one call a view)."""
    cfg = dataclasses.replace(KITTI, max_dis=8, wnd_size=5)
    p = make_pair(h=16, w=24, max_dis=8, seed=1)
    prior = pipeline.run_pair(p.left, p.right, 0, cfg, device="cpu")["abc"]
    plane_cost.launches = 0
    if warm:
        pipeline.run_pair_warm(p.left, p.right, 1, prior, cfg, 1,
                               device="cpu")
        e = roofline.warm_engine(engine(cfg), 1)
    else:
        pipeline.run_pair(p.left, p.right, 1, cfg, device="cpu")
        e = engine(cfg)
    assert plane_cost.launches == 2 * len(roofline.plan(e)[0])


@pytest.mark.parametrize("cfg", FLY_CONFIGS)
def test_fly_plan_is_the_programs_window_prescreen(cfg):
    """Without a volume the program prescreens with the fly kernel at the
    stride: its plan under prescreen_mode "window"."""
    want, rank_cands = port._plan(
        dataclasses.replace(cfg, prescreen_mode="window"))
    assert roofline.fly_plan(engine(cfg)) == want and rank_cands == 0


def test_fly_plan_of_the_novol_config():
    """27 launches a KITTI pair without a volume, 12 of them strided; none
    with a volume."""
    launches = roofline.fly_plan(engine(NOVOL))
    assert len(launches) == 27
    assert sum(s > 1 for _, s in launches) == 12
    assert {s for _, s in launches} == {1, NOVOL.prescreen_stride}
    assert roofline.fly_plan(engine(KITTI)) == []
    assert roofline.fly_cost_seconds(engine(KITTI), 12, 20) is None


@pytest.mark.parametrize("use_cs, warm", [(False, False), (True, False),
                                          (False, True)])
def test_fly_plan_counts_the_launches_of_a_run(use_cs, warm):
    """The plain fly cost's calls (one a launch, both views) in a tiny
    no-volume run on the CPU, cold and warm started, are the fly plan's
    launches."""
    cfg = dataclasses.replace(NOVOL, max_dis=8, wnd_size=5, use_cs=use_cs,
                              scale_num=3, reg_lambda=0.3 if use_cs else 0.0)
    p = make_pair(h=16, w=24, max_dis=8, seed=2)
    prior = pipeline.run_pair(p.left, p.right, 0, cfg, device="cpu")["abc"]
    onthefly_cost.launches = 0
    if warm:
        pipeline.run_pair_warm(p.left, p.right, 1, prior, cfg, 1,
                               device="cpu")
        e = roofline.warm_engine(engine(cfg), 1)
    else:
        pipeline.run_pair(p.left, p.right, 1, cfg, device="cpu")
        e = engine(cfg)
    assert onthefly_cost.launches == len(roofline.fly_plan(e))


def test_fly_least_time_uses_the_peaks():
    e = engine(NOVOL)
    h, w = 12, 20
    launches = roofline.fly_plan(e)
    ops = sum(k * roofline.in_image_samples(e, h, w, s)
              for k, s in launches) * 26
    assert roofline.FLOPS_IN_IMAGE + roofline.FLY_FLOPS_IN_RANGE == \
        port.FLOPS_IN_IMAGE + port.FLY_FLOPS_IN_RANGE["cost"] == 26
    least = roofline.fly_cost_seconds(e, h, w)
    assert least >= ops / roofline.F32_FLOP_PER_S
    assert least >= len(launches) * 2 * h * w * 7 / roofline.HBM_BYTES_PER_S
