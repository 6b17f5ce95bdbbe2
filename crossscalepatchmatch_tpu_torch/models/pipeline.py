"""End-to-end stereo pipeline: images -> u8 disparity maps
(port of crossscalepatchmatch_tpu.models.pipeline).

Build the volumes (one level, or the pyramid's when cfg.use_cs), or with
cfg.precompute_volume=False only the views' O(H*W) channel planes (the
no-volume path), run the PatchMatch optimizer, convert planes to scaled u8
disparity, and post-process when cfg.use_pp.  The run happens on `device`
("cuda" unless the caller asks for another); the inputs are moved there and
every tensor of the run lives there.  A config the card's kernels do not
take is refused at entry (support.check_supported), before any work.

Video: run_pair_warm starts the optimizer from a prior plane field (the
previous frame's) and runs a few iterations; run_sequence_np runs a cold
first frame and warm frames after it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import CSPMConfig
from ..ops.cost_volume import build_volume_data
from ..ops.onthefly_cost import build_fly_data
from ..support import check_supported
from ..utils.rng import PHASE_WARM, TorchDraws
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


def _on_device(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig, device):
    """(device, l, r): the config checked for the device (before anything
    runs), then the views moved there."""
    device = torch.device(device)
    l = torch.as_tensor(l_bgr_u8)
    check_supported(cfg, tuple(l.shape[:2]), device)
    return device, l.to(device), torch.as_tensor(r_bgr_u8).to(device)


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
    device, l, r = _on_device(l_bgr_u8, r_bgr_u8, cfg, device)
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


def run_pair_warm(l_bgr_u8, r_bgr_u8, seed: int, init_abc, cfg: CSPMConfig,
                  warm_iters: int = 1, *, device="cuda",
                  draws=None) -> Dict[str, torch.Tensor]:
    """run_pair started from a prior solution's plane field (video).

    The prior field's costs are taken against this pair's volumes (or
    channel planes), and `warm_iters` outer iterations run instead of
    cfg.max_iter, all adopting exactly with the prescreen, no rank phase.
    With prop_sweeps > 0 the held cost starts at +inf and the first
    iteration's first sweep evaluates the prior plane as a prepended
    candidate; otherwise one K=1 evaluation seeds the cost.

    Args:
      init_abc: f32[2, H, W, 3] plane field, e.g. run_pair's "abc" for the
        previous frame (a tensor on any device, or an array).
      draws: draw source whose refine(i, ...) gives warm iteration i's
        draws; TorchDraws(seed, device, refine_phase=PHASE_WARM) if None.

    Returns:
      run_pair's dict.
    """
    device, l, r = _on_device(l_bgr_u8, r_bgr_u8, cfg, device)
    if draws is None:
        draws = TorchDraws(seed, device, refine_phase=PHASE_WARM)
    cost_fn, sparse_fn, pp_imgs = _make_cost_fns(l, r, cfg)
    if not torch.is_tensor(init_abc):
        init_abc = torch.from_numpy(np.array(init_abc, np.float32))
    abc = init_abc.to(device=device, dtype=torch.float32)
    if cfg.prop_sweeps > 0 and warm_iters > 0:
        cost = torch.full(abc.shape[:-1], float("inf"), device=device)
    else:
        cost = cost_fn(abc[:, None])[:, 0]
    state = pm.iterate(pm.PMState(abc=abc, cost=cost), 0, warm_iters, draws,
                       cost_fn, cfg, sparse_fn)
    return _finalize(state, pp_imgs, cfg)


def run_sequence_np(frames, cfg: CSPMConfig, seed: int = 0,
                    warm_iters: int = 1, *, device="cuda", draws=None):
    """Sequence stereo: a cold first pair, then warm starts, each from the
    previous frame's plane field; frame i (i >= 1) takes seed + i.

    Args:
      frames: iterable of (left u8[H, W, 3], right u8[H, W, 3]) pairs.
      draws: optional callable (frame index, frame seed) -> draw source
        (frame 0 cold, the others warm); the default sources if None.

    Yields one run_pair_np-style dict per frame.
    """
    abc = None
    for i, (l, r) in enumerate(frames):
        s = seed if abc is None else seed + i
        src = None if draws is None else draws(i, s)
        if abc is None:
            out = run_pair(np.asarray(l), np.asarray(r), s, cfg,
                           device=device, draws=src)
        else:
            out = run_pair_warm(np.asarray(l), np.asarray(r), s, abc, cfg,
                                warm_iters, device=device, draws=src)
        abc = out["abc"]
        yield {k: v.cpu().numpy() for k, v in out.items()}
