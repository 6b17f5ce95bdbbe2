"""Cost-volume construction (port of crossscalepatchmatch_tpu.ops.cost_volume).

Left- and right-referenced GRD or census volumes at one level, or at
scale_num pyramid levels for cross-scale runs (max_dis halves per level),
each optionally filtered by cfg.aggregator (ops.filters), with each
level's per-view saturation value max(volume) of the filtered volume, and
per level the Lab weight images when cfg.use_lab_weights.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..config import Aggregator, CostMethod, CSPMConfig
from ..support import check_supported
from . import filters
from .census import census_cost_volume
from .color import bgr_to_lab_u8, bgr_to_rgb, rgb_to_gray_u8
from .grad_cost import grd_cost_volume
from .pyramid import build_pyramid


@dataclasses.dataclass
class VolumeData:
    """Per-view precomputed data for plane-cost evaluation.

    imgs[s]: u8[2, Hs, Ws, 3] per-view level-s images (original channel order)
    vols[s]: f32[2, Hs, Ws, Ds] per-view level-s cost volumes
    max_costs[s]: f32[2] per-view saturation values max(volume)
    wimgs[s]: optional u8[2, Hs, Ws, 3] ASW weight images (the level's Lab
      conversions with cfg.use_lab_weights; None: weights read imgs)
    """

    imgs: List[torch.Tensor]
    vols: List[torch.Tensor]
    max_costs: List[torch.Tensor]
    wimgs: List[torch.Tensor] | None = None

    @property
    def weight_imgs(self) -> List[torch.Tensor]:
        return self.imgs if self.wimgs is None else self.wimgs


def build_volume(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                 max_dis: int, cfg: CSPMConfig, right: bool) -> torch.Tensor:
    """One reference view's cost volume at one level: f32[H, W, max_dis+1].
    Census re-quantizes to u8 gray (cen_cc.cc:12-17)."""
    if cfg.cost_method == CostMethod.GRD:
        return grd_cost_volume(
            l_rgb_u8, r_rgb_u8, max_dis, alpha=cfg.cost_alpha,
            tau_clr=cfg.tau_clr, tau_grd=cfg.tau_grd,
            border_thres=cfg.border_thres, right=right)
    if cfg.cost_method == CostMethod.CEN:
        return census_cost_volume(
            rgb_to_gray_u8(l_rgb_u8), rgb_to_gray_u8(r_rgb_u8), max_dis,
            wnd=cfg.census_wnd, right=right)
    raise ValueError(f"unknown cost method {cfg.cost_method}")


def aggregate_volume(vol: torch.Tensor, guide_u8: torch.Tensor,
                     cfg: CSPMConfig) -> torch.Tensor:
    """One view's volume [H, W, D] filtered by cfg.aggregator: BOX (radius
    3), GF (radius 9, eps 1e-4) or BF (cfg.wnd_size), each guided by the
    view's u8[H, W, 3] image; NONE returns it as it is."""
    if cfg.aggregator == Aggregator.NONE:
        return vol
    if cfg.aggregator == Aggregator.BOX:
        return filters.box_filter_volume(vol, radius=3)
    if cfg.aggregator == Aggregator.GF:
        return filters.guided_filter_volume(vol, guide_u8, radius=9,
                                            eps=1e-4)
    if cfg.aggregator == Aggregator.BF:
        return filters.bilateral_filter_volume(vol, guide_u8,
                                               wnd=cfg.wnd_size)
    raise ValueError(f"unknown aggregator {cfg.aggregator}")


def build_volume_data(l_bgr_u8: torch.Tensor, r_bgr_u8: torch.Tensor,
                      cfg: CSPMConfig) -> VolumeData:
    """All per-level per-view volumes of one pair: scale_num levels when
    cfg.use_cs, else one.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[H, W, 3] views in the loader's BGR order, on
        the device the volumes should live on.

    The aggregation filter (cfg.aggregator) runs per view and level, guided
    by the level's BGR image, before the saturation value is taken.
    """
    check_supported(cfg, tuple(l_bgr_u8.shape[:2]), l_bgr_u8.device)
    levels = cfg.scale_num if cfg.use_cs else 1
    l_pyr = build_pyramid(l_bgr_u8, levels)
    r_pyr = build_pyramid(r_bgr_u8, levels)
    imgs, vols, max_costs = [], [], []
    wimgs = [] if cfg.use_lab_weights else None
    md = cfg.max_dis
    for s in range(levels):
        l_rgb = bgr_to_rgb(l_pyr[s])
        r_rgb = bgr_to_rgb(r_pyr[s])
        vol_l = build_volume(l_rgb, r_rgb, md, cfg, right=False)
        vol_r = build_volume(l_rgb, r_rgb, md, cfg, right=True)
        vol_l = aggregate_volume(vol_l, l_pyr[s], cfg)
        vol_r = aggregate_volume(vol_r, r_pyr[s], cfg)
        imgs.append(torch.stack([l_pyr[s], r_pyr[s]]))
        vols.append(torch.stack([vol_l, vol_r]))
        max_costs.append(torch.stack([vol_l.max(), vol_r.max()]))
        if wimgs is not None:
            # per-level Lab like CSPC's per-level conversion (cspc.cc:48-49)
            wimgs.append(bgr_to_lab_u8(imgs[-1]))
        md //= 2
    return VolumeData(imgs=imgs, vols=vols, max_costs=max_costs,
                      wimgs=wimgs)
