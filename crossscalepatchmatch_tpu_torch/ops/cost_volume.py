"""Cost-volume construction (port of the single-level GRD branch of
crossscalepatchmatch_tpu.ops.cost_volume).

build_pyramid(img, 1) is just [img], so no pyramid is built here; the
cross-scale levels come with ROADMAP queue 1 step 9.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from crossscalepatchmatch_tpu.config import CSPMConfig

from ..support import check_supported
from .color import bgr_to_rgb
from .grad_cost import grd_cost_volume


@dataclasses.dataclass
class VolumeData:
    """Per-view precomputed data for plane-cost evaluation.

    imgs[s]: u8[2, Hs, Ws, 3] per-view level-s images (original channel order)
    vols[s]: f32[2, Hs, Ws, Ds] per-view level-s cost volumes
    max_costs[s]: f32[2] per-view saturation values max(volume)
    wimgs[s]: optional ASW weight images (None: weights read imgs)
    """

    imgs: List[torch.Tensor]
    vols: List[torch.Tensor]
    max_costs: List[torch.Tensor]
    wimgs: List[torch.Tensor] | None = None

    @property
    def weight_imgs(self) -> List[torch.Tensor]:
        return self.imgs if self.wimgs is None else self.wimgs


def build_volume_data(l_bgr_u8: torch.Tensor, r_bgr_u8: torch.Tensor,
                      cfg: CSPMConfig) -> VolumeData:
    """Left- and right-referenced GRD volumes of one pair at one level.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[H, W, 3] views in the loader's BGR order, on
        the device the volumes should live on.
    """
    check_supported(cfg)
    l_rgb = bgr_to_rgb(l_bgr_u8)
    r_rgb = bgr_to_rgb(r_bgr_u8)
    kw = dict(alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
              tau_grd=cfg.tau_grd, border_thres=cfg.border_thres)
    vol_l = grd_cost_volume(l_rgb, r_rgb, cfg.max_dis, right=False, **kw)
    vol_r = grd_cost_volume(l_rgb, r_rgb, cfg.max_dis, right=True, **kw)
    return VolumeData(imgs=[torch.stack([l_bgr_u8, r_bgr_u8])],
                      vols=[torch.stack([vol_l, vol_r])],
                      max_costs=[torch.stack([vol_l.max(), vol_r.max()])])
