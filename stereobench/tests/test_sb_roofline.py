"""The frozen work counts give the program's utils/roofline totals, and the
launch plan the launches the program makes."""

import dataclasses

import pytest
import torch

from crossscalepatchmatch_tpu_torch.config import (CEN_CS_PP, KITTI,
                                                   README_DEMO)
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models import pipeline
from crossscalepatchmatch_tpu_torch.ops import plane_cost
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
