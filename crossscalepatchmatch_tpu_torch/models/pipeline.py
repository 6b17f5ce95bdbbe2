"""End-to-end stereo pipeline: images -> u8 disparity maps
(port of crossscalepatchmatch_tpu.models.pipeline).

Build the volumes (one level, or the pyramid's when cfg.use_cs), or with
cfg.precompute_volume=False only the views' O(H*W) channel planes (the
no-volume path), run the PatchMatch optimizer, convert planes to scaled u8
disparity, and post-process when cfg.use_pp.  The run happens on `device` ("cuda" unless
the caller asks for another); the inputs are moved there and every tensor
of the run lives there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import CSPMConfig
from ..ops.cost_volume import build_volume_data
from ..ops.onthefly_cost import build_fly_data
from ..utils.rng import TorchDraws
from . import patchmatch as pm
from .postprocess import postprocess


def _make_cost_fns(l: torch.Tensor, r: torch.Tensor, cfg: CSPMConfig):
    """Bind the configured plane-cost backend: (cost_fn, sparse_fn,
    pp_imgs), pp_imgs the fine-level u8[2, H, W, 3] views.  The no-volume
    path follows the JAX engine's fused-kernel semantics on every device
    (models.patchmatch.make_fly_cost_fns)."""
    if cfg.precompute_volume:
        vd = build_volume_data(l, r, cfg)
        return (*pm.make_cost_fns(cfg, vd), vd.imgs[0])
    fd = build_fly_data(l, r, cfg)
    return (*pm.make_fly_cost_fns(cfg, fd), fd.imgs[0])


def _finalize(state: pm.PMState, pp_imgs: torch.Tensor,
              cfg: CSPMConfig) -> Dict[str, torch.Tensor]:
    """Planes -> scaled u8 disparity (+ post-processing on the fine-level
    images pp_imgs, u8[2, H, W, 3], when cfg.use_pp)."""
    _, h, w = state.cost.shape
    dis = pm.plane_to_disp(state.abc, cfg.dis_scale)
    if cfg.use_pp:
        dis, valid = postprocess(dis, state.abc, pp_imgs, cfg)
    else:
        valid = torch.ones((2, h, w), dtype=torch.bool,
                           device=state.abc.device)
    return {"dis": dis, "abc": state.abc, "cost": state.cost,
            "valid": valid}


def run_pair(l_bgr_u8, r_bgr_u8, seed: int, cfg: CSPMConfig, *,
             device="cuda", draws=None) -> Dict[str, torch.Tensor]:
    """Compute left/right disparity for one rectified pair.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[H, W, 3] views (tensors or arrays).
      seed: RNG seed of the default draw source.
      device: where the run happens ("cuda" by default, "cuda:1", "cpu",
        ...).
      draws: draw source (utils.rng); TorchDraws(seed, device) if None.

    Returns:
      dict with "dis" u8[2, H, W] scaled disparity maps, "abc"
      f32[2, H, W, 3] plane fields, "cost" f32[2, H, W] final costs and
      "valid" bool[2, H, W] LR-check mask (all true when not cfg.use_pp).
    """
    device = torch.device(device)
    l = torch.as_tensor(l_bgr_u8).to(device)
    r = torch.as_tensor(r_bgr_u8).to(device)
    if draws is None:
        draws = TorchDraws(seed, device)
    h, w, _ = l.shape
    cost_fn, sparse_fn, pp_imgs = _make_cost_fns(l, r, cfg)
    state = pm.patchmatch(draws, (h, w), cost_fn, cfg, sparse_fn,
                          device=device)
    return _finalize(state, pp_imgs, cfg)


def run_pair_np(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig, seed: int = 0, *,
                device="cuda", draws=None) -> Dict[str, np.ndarray]:
    """run_pair taking and returning NumPy arrays."""
    out = run_pair(np.asarray(l_bgr_u8), np.asarray(r_bgr_u8), seed, cfg,
                   device=device, draws=draws)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_pairs(l_bgr_u8, r_bgr_u8, seeds, cfg: CSPMConfig, *,
              device="cuda") -> Dict[str, torch.Tensor]:
    """B pairs one after another (u8[B, H, W, 3] views, B seeds); returns
    run_pair's dict with a leading batch axis on every entry."""
    outs = [run_pair(l_bgr_u8[i], r_bgr_u8[i], int(seeds[i]), cfg,
                     device=device) for i in range(len(seeds))]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
