"""Cost-volume construction (port of crossscalepatchmatch_tpu.ops.cost_volume).

Left- and right-referenced GRD or census volumes at one level, or at
scale_num pyramid levels for cross-scale runs (max_dis halves per level),
each optionally filtered by cfg.aggregator (ops.filters; BF on the card
by kernel BFV, ops.cuda.bilateral_volume), with each
level's per-view saturation value max(volume) of the filtered volume, and
per level the Lab weight images when cfg.use_lab_weights.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..config import Aggregator, CostMethod, CSPMConfig
from ..support import check_supported
from ..utils.spans import span
from . import filters
from .color import bgr_to_lab_u8, bgr_to_rgb
from .cuda.bilateral_volume import bilateral_volumes
from .cuda.census_volume import census_volumes
from .cuda.grd_volume import grd_volumes
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


def build_volumes(l_rgb_u8: torch.Tensor, r_rgb_u8: torch.Tensor,
                  max_dis: int, cfg: CSPMConfig) -> torch.Tensor:
    """Both reference views' cost volumes at one level: f32[2, H, W,
    max_dis+1], the left-referenced one at 0.  GRD: kernel GRDV for CUDA
    tensors, its plain version (grad_cost.grd_cost_volume) for CPU tensors
    (ops.cuda.grd_volume.grd_volumes).  Census (re-quantized to u8 gray,
    cen_cc.cc:12-17): kernel CENV for CUDA tensors, its plain version
    (census.census_cost_volume) for CPU tensors
    (ops.cuda.census_volume.census_volumes)."""
    if cfg.cost_method == CostMethod.GRD:
        return grd_volumes(
            l_rgb_u8, r_rgb_u8, max_dis, alpha=cfg.cost_alpha,
            tau_clr=cfg.tau_clr, tau_grd=cfg.tau_grd,
            border_thres=cfg.border_thres)
    if cfg.cost_method == CostMethod.CEN:
        return census_volumes(l_rgb_u8, r_rgb_u8, max_dis, cfg.census_wnd)
    raise ValueError(f"unknown cost method {cfg.cost_method}")


def aggregate_volumes(vols: torch.Tensor, guides_u8: torch.Tensor,
                      cfg: CSPMConfig) -> torch.Tensor:
    """The views' volumes [V, H, W, D] filtered by cfg.aggregator, each
    guided by its view's u8 image in guides_u8 [V, H, W, 3]: BOX (radius
    3) and GF (radius 9, eps 1e-4) view by view, BF (cfg.wnd_size) on all
    views in one call (ops.cuda.bilateral_volume: on the card one BFV
    launch); NONE returns them as they are."""
    if cfg.aggregator == Aggregator.NONE:
        return vols
    if cfg.aggregator == Aggregator.BF:
        return bilateral_volumes(vols, guides_u8, cfg.wnd_size)
    if cfg.aggregator == Aggregator.BOX:
        return torch.stack([filters.box_filter_volume(vol, radius=3)
                            for vol in vols])
    if cfg.aggregator == Aggregator.GF:
        return torch.stack([filters.guided_filter_volume(
            vol, guide, radius=9, eps=1e-4)
            for vol, guide in zip(vols, guides_u8)])
    raise ValueError(f"unknown aggregator {cfg.aggregator}")


def build_volume_data(l_bgr_u8: torch.Tensor, r_bgr_u8: torch.Tensor,
                      cfg: CSPMConfig) -> VolumeData:
    """All per-level per-view volumes of one pair: scale_num levels when
    cfg.use_cs, else one.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[H, W, 3] views in the loader's BGR order, on
        the device the volumes should live on.

    The aggregation filter (cfg.aggregator) runs per level on both views,
    guided by the level's BGR images, before the saturation value is
    taken; each level's filter is an `aggregate` span (filter, level,
    slices: the inner slices it filters).
    """
    check_supported(cfg, tuple(l_bgr_u8.shape[:2]), l_bgr_u8.device)
    levels = cfg.scale_num if cfg.use_cs else 1
    l_pyr = build_pyramid(l_bgr_u8, levels)
    r_pyr = build_pyramid(r_bgr_u8, levels)
    imgs, vols, max_costs = [], [], []
    wimgs = [] if cfg.use_lab_weights else None
    md = cfg.max_dis
    for s in range(levels):
        imgs.append(torch.stack([l_pyr[s], r_pyr[s]]))
        vol = build_volumes(bgr_to_rgb(l_pyr[s]), bgr_to_rgb(r_pyr[s]), md,
                            cfg)
        if cfg.aggregator == Aggregator.NONE:
            vols.append(vol)
        else:
            with span("aggregate", filter=cfg.aggregator.value, level=s,
                      slices=max(md - 1, 0)):
                vols.append(aggregate_volumes(vol, imgs[-1], cfg))
        max_costs.append(vols[-1].amax(dim=(1, 2, 3)))
        if wimgs is not None:
            # per-level Lab like CSPC's per-level conversion (cspc.cc:48-49)
            wimgs.append(bgr_to_lab_u8(imgs[-1]))
        md //= 2
    return VolumeData(imgs=imgs, vols=vols, max_costs=max_costs,
                      wimgs=wimgs)
