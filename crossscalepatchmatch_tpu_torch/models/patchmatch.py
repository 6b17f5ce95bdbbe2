"""PatchMatch optimizer over slanted-plane fields
(port of crossscalepatchmatch_tpu.models.patchmatch).

Random init, then max_iter outer iterations of {dense propagation sweeps,
view propagation, randomized plane refinement}, every phase funnelling into
per-pixel plane-cost evaluations through a CostFn:

    CostFn: f32[2, K, H, W, 3] candidate planes -> f32[2, K, H, W] costs

On the volume path the exact CostFn is kernel K1 (ops.cuda.window_cost),
or K4 (ops.cuda.cross_scale_cost) on cross-scale runs, on a CUDA tensor and
its plain version on a CPU tensor; the prescreen/rank CostFn is kernel
QRANK (ops.cuda.quadrant_rank, or its plain version) on the quadrant
volumes of the fine level that kernel K2 (or its plain version) builds
once per pair, or is K1 at a window stride (K3,
prescreen_mode="window").  On the no-volume path (make_fly_cost_fns) both
are the fly kernel (ops.cuda.fly_cost: K5/K6/K7, K3 strided).  Random draws come from an explicit draw source (utils.rng) keyed by
(phase, iteration, view, round); with utils.rng.TorchDraws on the card a
refinement stage's candidates, draws included, are one launch of kernel
RPROP (ops.cuda.refine_propose).  The JAX jit/scan structure becomes plain
Python control flow.

A spatial tile (parallel.tiled) runs the same optimizer on its block: it
binds the band forms of the kernels (make_cost_fns(band=...)) and hands in
how a sweep finds its neighbours' planes (`neighbours`, across the tile's
halos) and how view propagation finds the other view's (`view`).

The optimizer's layers are spans (utils/spans): rank_phase (with init)
and exact_phase in patchmatch, iteration, sweep, view and refine.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..config import CSPMConfig
from ..ops import plane
from ..ops.cost_volume import VolumeData
from ..ops.cuda.cross_scale_cost import (cross_scale_cost_prepared,
                                         prepare_cross_scale)
from ..ops.cuda.fly_cost import fly_cost_prepared, prepare_fly
from ..ops.cuda.quadrant_build import quadrant_volumes_prepared
from ..ops.cuda.quadrant_rank import quadrant_rank
from ..ops.cuda.window_cost import (PreparedVolumes, prepare_volumes,
                                    window_cost_prepared)
from ..ops.onthefly_cost import FlyData
from ..ops.scale_weights import scale_weights
from ..support import check_supported
from ..utils.spans import span

CostFn = Callable[[torch.Tensor], torch.Tensor]
Offsets = List[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Band:
    """Where a spatial tile's volume data sit (parallel.tiled): level 0 is
    the tile's block with a half_wnd halo on its extended axes, a coarser
    level the whole level; `origin` is the block's global fine (row, col)
    and `bounds` per level the validity interval (ylo, yhi, xlo, xhi) in
    the block's coordinates (ops.cuda.cross_scale_cost.band_rect)."""

    rows_extended: bool
    cols_extended: bool
    origin: Tuple[int, int]
    bounds: Tuple[Tuple[int, int, int, int], ...]


@dataclasses.dataclass
class PMState:
    """Optimizer state: per-view plane field and its current best cost."""

    abc: torch.Tensor    # f32[2, H, W, 3]
    cost: torch.Tensor   # f32[2, H, W]


def kernel_volumes(cfg: CSPMConfig, vols: torch.Tensor) -> torch.Tensor:
    """The volume the kernels read: stored in cfg.vol_dtype on the card.

    The plain versions (CPU tensors) always read the f32 volume, like the
    JAX engine's jnp authority; the saturation values stay those of the f32
    volume either way.
    """
    if vols.device.type == "cuda" and cfg.vol_dtype == "bf16":
        return vols.to(torch.bfloat16)
    return vols


def _volume_sparse_fn(cfg: CSPMConfig, prep: PreparedVolumes,
                      bounds=None) -> CostFn:
    """Quadrant-volume prescreen evaluator (prescreen_mode="volume"): the
    quadrant volumes are built once (K2) on the prepared fine level, then
    every call ranks both views' candidates on them (QRANK on the card,
    one launch; the plain ranking per view on the CPU)."""
    bq, wq = quadrant_volumes_prepared(prep, half_wnd=cfg.half_wnd,
                                       gamma=cfg.wgt_gamma,
                                       stride=max(cfg.prescreen_stride, 1),
                                       bounds=bounds)
    max_costs = prep.max_costs

    def sparse_fn(abc2: torch.Tensor) -> torch.Tensor:
        return quadrant_rank(bq, wq, max_costs, abc2, half_wnd=cfg.half_wnd,
                             max_dis=cfg.max_dis)

    return sparse_fn


def make_cost_fns(cfg: CSPMConfig, vd: VolumeData,
                  band: Band | None = None) -> Tuple[CostFn, CostFn | None]:
    """Bind the per-view volume data into (cost_fn, sparse_fn): the exact
    window-cost evaluator (single-scale, or the scale-weighted sum over the
    pyramid when cfg.use_cs) and the prescreen (None when prescreening is
    off): the quadrant ranking (prescreen_mode="volume"), or, single-scale
    only, the window cost at stride prescreen_stride ("window", K3).
    Cross-scale runs rank on the fine level's quadrant volumes, a ranking
    heuristic like the prescreen itself; their exact costs are the
    cross-scale ones.  Which code runs follows the tensors' device.

    Packed images, kernel-layout volumes and the weight table are made once
    per pair (prepare_volumes / prepare_cross_scale); an evaluation only
    launches.  On the card the functions hold the pair-layout volumes and
    the quadrant volumes, not vd's volumes or their cfg.vol_dtype copies.

    band: a spatial tile's geometry (Band): every evaluator is then the
    kernels' band form on vd's tile data, its output the tile's block."""
    check_supported(cfg, tuple(vd.imgs[0].shape[1:3]), vd.imgs[0].device)
    volume_mode = cfg.prescreen_stride > 1 and cfg.prescreen_mode == "volume"
    window_mode = (cfg.prescreen_stride > 1 and cfg.prescreen_mode == "window"
                   and not cfg.use_cs)
    kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
              gamma=cfg.wgt_gamma)
    ext, cs_band, bounds0 = {}, {}, None
    if band is not None:
        ext = dict(rows_extended=band.rows_extended,
                   cols_extended=band.cols_extended)
        cs_band = dict(origin=band.origin, bounds=band.bounds)
        bounds0 = band.bounds[0]
    # the fine level, prepared for K1 and K3 (single-scale) and K2
    fine = (prepare_volumes(vd.weight_imgs[0],
                            kernel_volumes(cfg, vd.vols[0]),
                            vd.max_costs[0], **kw, **ext)
            if volume_mode or not cfg.use_cs else None)
    sparse_fn = _volume_sparse_fn(cfg, fine, bounds0) if volume_mode else None
    if cfg.use_cs:
        fine = None  # K2 has run: its copy of the fine level is not held
        prep = prepare_cross_scale(
            vd.weight_imgs, [kernel_volumes(cfg, v) for v in vd.vols],
            vd.max_costs, scale_weights(cfg.scale_num, cfg.reg_lambda), **kw,
            **ext, **cs_band)

        def cost_fn(abc2: torch.Tensor) -> torch.Tensor:
            return cross_scale_cost_prepared(
                prep, abc2, half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
                levels=cfg.scale_num)
    else:
        def cost_fn(abc2: torch.Tensor,
                    stride: int = 1) -> torch.Tensor:
            return window_cost_prepared(fine, abc2, half_wnd=cfg.half_wnd,
                                        max_dis=cfg.max_dis,
                                        wnd_stride=stride, bounds=bounds0)

    if window_mode:
        sparse_fn = functools.partial(cost_fn, stride=cfg.prescreen_stride)
    return cost_fn, sparse_fn


def make_fly_cost_fns(cfg: CSPMConfig,
                      fd: FlyData) -> Tuple[CostFn, CostFn | None]:
    """No-volume (cost_fn, sparse_fn), the semantics of the JAX engine's
    fused kernel path (make_fused_fly_cost_fns) on every device: the exact
    evaluator is the fly cost over one level, or the scale-weighted sum
    over the pyramid when cfg.use_cs, in cfg.fly_lerp's mode, with the Lab
    weights per level when cfg.use_lab_weights; sparse_fn is the same cost
    at stride prescreen_stride (K3) when prescreen_stride > 1 and not
    cfg.use_cs, else None.  There is no quadrant ranking (it needs a
    volume), so rank adoption is off and the run is all-exact."""
    check_supported(cfg, tuple(fd.imgs[0].shape[1:3]), fd.imgs[0].device)
    # packed images and the weight table are made once per pair; an
    # evaluation only launches
    prep = prepare_fly(
        fd, scale_weights(cfg.scale_num, cfg.reg_lambda) if cfg.use_cs
        else None, half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
        gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
        tau_grd=cfg.tau_grd, border_thres=cfg.border_thres,
        lerp=cfg.fly_lerp)
    levels = cfg.scale_num if cfg.use_cs else 1

    def cost_fn(abc2: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return fly_cost_prepared(prep, abc2, half_wnd=cfg.half_wnd,
                                 max_dis=cfg.max_dis, levels=levels,
                                 wnd_stride=stride)

    sparse_fn = (functools.partial(cost_fn, stride=cfg.prescreen_stride)
                 if cfg.prescreen_stride > 1 and not cfg.use_cs else None)
    return cost_fn, sparse_fn


def _prescreen(cand_abc: torch.Tensor,
               sparse_fn: CostFn | None) -> torch.Tensor:
    """Narrow a K-candidate batch to its per-pixel sparse-cost winner."""
    if sparse_fn is None or cand_abc.shape[1] == 1:
        return cand_abc
    best_k = torch.argmin(sparse_fn(cand_abc), dim=1)
    return _take_k(cand_abc, best_k)


def _take_k(cand_abc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """cand_abc[v, k[v, y, x], y, x, :] as f32[2, 1, H, W, 3]."""
    idx = k[:, None, :, :, None].expand(-1, 1, -1, -1, 3)
    return torch.gather(cand_abc, 1, idx)


def _adopt(state: PMState, cand_abc: torch.Tensor,
           cand_cost: torch.Tensor) -> PMState:
    """Adopt, per pixel, the best candidate iff it strictly improves
    (cs_patchmatch.cc:201,209,270,335); argmin picks the first index of a
    tie."""
    best_k = torch.argmin(cand_cost, dim=1)                     # [2, H, W]
    best_cost = torch.gather(cand_cost, 1, best_k[:, None])[:, 0]
    best_abc = _take_k(cand_abc, best_k)[:, 0]
    improve = best_cost < state.cost
    return PMState(abc=torch.where(improve[..., None], best_abc, state.abc),
                   cost=torch.where(improve, best_cost, state.cost))


def _stencil(cfg: CSPMConfig, sweep: int = 0) -> List[Tuple[int, int]]:
    """Candidate offsets of one sweep: the 4-adjacent ring plus one far
    ring; consecutive sweeps cycle through cfg.far_offsets."""
    offsets = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if cfg.far_offsets:
        f = cfg.far_offsets[sweep % len(cfg.far_offsets)]
        offsets += [(0, f), (0, -f), (f, 0), (-f, 0)]
    return offsets


def stencil_candidates(abc: torch.Tensor, offsets: Offsets) -> torch.Tensor:
    """f32[2, n, H, W, 3]: for each stencil offset (dy, dx), every pixel's
    neighbour's plane abc[v, y - dy, x - dx] (rolled: the image wraps)."""
    return torch.stack([torch.roll(abc, (dy, dx), dims=(1, 2))
                        for dy, dx in offsets], dim=1)


def spatial_sweep(state: PMState, cost_fn: CostFn, cfg: CSPMConfig,
                  sweep: int = 0, sparse_fn: CostFn | None = None,
                  extra: torch.Tensor | None = None,
                  include_current: bool = False,
                  neighbours=stencil_candidates) -> PMState:
    """One dense propagation sweep: every pixel tests its stencil's planes.

    `extra` ([2, E, H, W, 3]) joins the batch after the prescreen.
    `include_current` PREPENDS the current plane (deferred-cost entry), so
    a tie keeps the current plane.  `neighbours(abc, offsets)` gives the
    stencil's candidate planes (stencil_candidates on one device).
    """
    offsets = _stencil(cfg, sweep)
    with span("sweep", s=sweep, k=len(offsets)):
        cand_abc = _prescreen(neighbours(state.abc, offsets), sparse_fn)
        if include_current:
            cand_abc = torch.cat([state.abc[:, None], cand_abc], dim=1)
        if extra is not None:
            cand_abc = torch.cat([cand_abc, extra], dim=1)
        return _adopt(state, cand_abc, cost_fn(cand_abc))


def view_candidates(state: PMState, cfg: CSPMConfig) -> torch.Tensor:
    """Cross-view plane-transfer candidates as a gather: warp by the
    pixel's own clamped disparity to the other view (wrapping by +-W,
    HandleBorder), read that plane, clamp its disparity to [0, max_dis-1]
    and re-anchor it at (x, y).  Returns f32[2, 1, H, W, 3]."""
    _, h, w, _ = state.abc.shape
    dev = state.abc.device
    xs, ys = plane.pixel_grid(h, w, dev)
    xi = torch.arange(w, device=dev)[None, :]
    hi = cfg.max_dis - 1.0

    def per_view(abc_v, abc_other, sign):
        d_own = torch.clamp(plane.disparity_at(abc_v, xs, ys), 0.0, hi)
        # round half to even like jnp.rint; remainder (not fmod) wraps
        # negative warps to the far side like the reference's % w
        xw = torch.remainder(xi + sign * torch.round(d_own).to(torch.int64),
                             w)
        src = torch.gather(abc_other, 1, xw[..., None].expand(h, w, 3))
        d_src = torch.clamp(plane.disparity_at(src, xw.to(torch.float32), ys),
                            0.0, hi)
        return plane.reanchor(src, xs, ys, d_src)

    cand_l = per_view(state.abc[0], state.abc[1], -1)
    cand_r = per_view(state.abc[1], state.abc[0], +1)
    return torch.stack([cand_l, cand_r])[:, None]


def view_propagation(state: PMState, cost_fn: CostFn, cfg: CSPMConfig,
                     view=None) -> PMState:
    """Standalone view-propagation step (see view_candidates; `view(state)`
    gives the candidates instead where set)."""
    with span("view"):
        cand_abc = view(state) if view else view_candidates(state, cfg)
        return _adopt(state, cand_abc, cost_fn(cand_abc))


def refinement_magnitudes(cfg: CSPMConfig):
    """(z, n) per refinement round, in f32 like the JAX engine: z halves
    from max_dis/2, n = max_norm * z / z[0]."""
    zs = np.asarray(cfg.refinement_schedule(), np.float32)
    ns = np.float32(cfg.max_norm) * zs / zs[0]
    return zs, ns


def propose_generic(draws, abc: torch.Tensor, iteration: int,
                    rounds: range, zs, ns, eps: float) -> torch.Tensor:
    """A refinement stage's candidates from any draw source,
    f32[2, K, H, W, 3]: perturb_planes of abc[v] on the source's refine
    draws of (iteration, v, i), for each view v and round i in rounds."""
    _, h, w, _ = abc.shape
    dev = abc.device

    def one(v, i):
        dz, dn = draws.refine(iteration, v, i, (h, w), float(zs[i]),
                              float(ns[i]))
        return plane.perturb_planes(abc[v], dz.to(dev), dn.to(dev), eps)

    return torch.stack([torch.stack([one(v, i) for i in rounds])
                        for v in range(2)])


def plane_refinement(state: PMState, draws, iteration: int, cost_fn: CostFn,
                     cfg: CSPMConfig,
                     sparse_fn: CostFn | None = None) -> PMState:
    """Randomized refinement with the halving perturbation schedule.

    batch_refine=True: the rounds are split into refine_stages groups; each
    group's perturbations are proposed from the plane held at the group's
    start and adopted as one candidate batch (after the prescreen).
    batch_refine=False: the reference's loop, each round perturbing the
    currently adopted plane.

    A draw source with a propose method (utils.rng.TorchDraws) proposes
    each stage itself: on a CUDA tensor in one launch of kernel RPROP (the
    refine span's `fused`), on the CPU in its plain version; any other
    source's draws go through propose_generic.  Both give the same bits on
    the same draws.
    """
    zs, ns = refinement_magnitudes(cfg)
    r = len(zs)
    own = getattr(draws, "propose", None)
    fused = own is not None and state.abc.device.type == "cuda"

    def propose(abc, rounds):
        if own is not None:
            return own(abc, iteration, rounds, zs, ns, cfg.eps)
        return propose_generic(draws, abc, iteration, rounds, zs, ns,
                               cfg.eps)

    if cfg.batch_refine:
        stages = max(1, min(cfg.refine_stages, r))
        per = -(-r // stages)
        for s0 in range(0, r, per):
            rounds = range(s0, min(s0 + per, r))
            with span("refine", stage=s0 // per, k=len(rounds), fused=fused):
                cand_abc = _prescreen(propose(state.abc, rounds), sparse_fn)
                state = _adopt(state, cand_abc, cost_fn(cand_abc))
        return state

    for i in range(r):
        with span("refine", stage=i, k=1, fused=fused):
            cand_abc = propose(state.abc, range(i, i + 1))
            state = _adopt(state, cand_abc, cost_fn(cand_abc))
    return state


def init_state(draws, hw: Tuple[int, int], cost_fn: CostFn | None,
               cfg: CSPMConfig, *, device) -> PMState:
    """Random plane init + initial cost (cs_patchmatch.cc:115-148).
    cost_fn=None defers the evaluation: the held cost is +inf."""
    h, w = hw
    with span("init"):
        disp, normal = draws.init((2, h, w), float(cfg.max_dis), cfg.eps)
        abc = plane.random_planes(disp.to(device), normal.to(device),
                                  cfg.eps)
        if cost_fn is None:
            return PMState(abc=abc, cost=torch.full(
                (2, h, w), float("inf"), device=device))
        return PMState(abc=abc, cost=cost_fn(abc[:, None])[:, 0])


def iteration_step(state: PMState, draws, iteration: int, cost_fn: CostFn,
                   cfg: CSPMConfig, sparse_fn: CostFn | None = None,
                   include_current: bool = False,
                   neighbours=stencil_candidates, view=None) -> PMState:
    """One outer iteration (number `iteration`): propagation sweeps, view
    propagation, refinement.  `include_current` goes to the first sweep;
    `neighbours` to every sweep; `view(state)`, where set, gives the view
    candidates (view_candidates on one device)."""
    view = view or functools.partial(view_candidates, cfg=cfg)
    for i in range(cfg.prop_sweeps):
        merge = cfg.merge_view and i == cfg.prop_sweeps - 1
        state = spatial_sweep(
            state, cost_fn, cfg, sweep=i, sparse_fn=sparse_fn,
            extra=view(state) if merge else None,
            include_current=include_current and i == 0,
            neighbours=neighbours)
    if not (cfg.merge_view and cfg.prop_sweeps > 0):
        state = view_propagation(state, cost_fn, cfg, view)
    return plane_refinement(state, draws, iteration, cost_fn, cfg,
                            sparse_fn=sparse_fn)


def iterate(state: PMState, first: int, stop: int, draws, cost_fn: CostFn,
            cfg: CSPMConfig, sparse_fn: CostFn | None = None, *,
            n_rank: int = 0,
            on_iteration: Callable[[PMState, int], None] | None = None,
            neighbours=stencil_candidates, view=None) -> PMState:
    """Outer iterations first..stop-1 of the schedule, from `state` (the
    state after `first` iterations).

    Iterations below n_rank adopt on the ranking costs (sparse_fn, no
    prescreen); the others adopt on cost_fn with sparse_fn as the
    prescreen.  Iteration n_rank is the entry into the exact phase: with
    prop_sweeps > 0 the held cost becomes +inf and the first sweep
    evaluates the current plane as a prepended candidate (the deferred
    entry); otherwise a held rank-unit cost (n_rank > 0) is replaced by a
    K=1 exact evaluation.  A state entering at iteration 0 with n_rank = 0
    and prop_sweeps = 0 must hold exact costs.

    Args:
      on_iteration: called as on_iteration(state, i + 1) after iteration i.
      neighbours / view: iteration_step's.
    """
    defer = cfg.prop_sweeps > 0
    for it in range(first, stop):
        with span("iteration", i=it):
            if it == n_rank and defer:
                state = PMState(abc=state.abc, cost=torch.full_like(
                    state.cost, float("inf")))
            elif it == n_rank and n_rank:
                # the rank-unit cost is not comparable to exact costs
                state = PMState(abc=state.abc,
                                cost=cost_fn(state.abc[:, None])[:, 0])
            cf, sf = ((sparse_fn, None) if it < n_rank
                      else (cost_fn, sparse_fn))
            state = iteration_step(state, draws, it, cf, cfg, sf,
                                   include_current=defer and it == n_rank,
                                   neighbours=neighbours, view=view)
        if on_iteration is not None:
            on_iteration(state, it + 1)
    return state


def patchmatch(draws, hw: Tuple[int, int], cost_fn: CostFn, cfg: CSPMConfig,
               sparse_fn: CostFn | None = None, *, device,
               start: Tuple[PMState, int] | None = None,
               stop: int | None = None,
               on_iteration: Callable[[PMState, int], None] | None = None,
               neighbours=stencil_candidates, view=None) -> PMState:
    """Full optimizer: init + max_iter outer iterations (see iterate).

    cfg.adopt_mode: "exact" adopts on cost_fn throughout; "rank" on the
    quadrant ranking (sparse_fn); "rank+exact" ranks for the first
    max_iter - exact_iters iterations, then adopts exactly.

    Args:
      start: (state, i), the state after i iterations, to continue from
        instead of a fresh init (a resumed run).
      stop: the state after `stop` iterations is returned (cfg.max_iter if
        None): a run in slices composes to the whole run.
      on_iteration: called as on_iteration(state, i) with the state after
        i iterations: after a fresh init (i = 0) and after each iteration.
      neighbours / view: iteration_step's (a spatial tile's halos).
    """
    n_rank = cfg.rank_iters if sparse_fn is not None else 0
    stop = cfg.max_iter if stop is None else stop
    run = functools.partial(iterate, draws=draws, cost_fn=cost_fn, cfg=cfg,
                            sparse_fn=sparse_fn, n_rank=n_rank,
                            on_iteration=on_iteration,
                            neighbours=neighbours, view=view)
    # the rank phase: the init and the iterations below n_rank; then the
    # exact phase
    state, first = start or (None, 0)
    rank_stop = max(first, min(stop, n_rank))
    if start is None or first < rank_stop:
        with span("rank_phase"):
            if start is None:
                defer = cfg.prop_sweeps > 0 and cfg.max_iter > n_rank
                init_fn = sparse_fn if n_rank else (None if defer
                                                    else cost_fn)
                state = init_state(draws, hw, init_fn, cfg, device=device)
                if on_iteration is not None:
                    on_iteration(state, 0)
            state = run(state, first, rank_stop)
        first = rank_stop
    if first < stop:
        with span("exact_phase"):
            state = run(state, first, stop)
    return state


def plane_to_disp(abc: torch.Tensor, dis_scale: int) -> torch.Tensor:
    """u8 disparity maps: saturate(round(d * dis_scale)), round half to
    even (cs_patchmatch.cc:590-602)."""
    _, h, w, _ = abc.shape
    xs, ys = plane.pixel_grid(h, w, abc.device)
    d = plane.disparity_at(abc, xs, ys)
    return torch.clamp(torch.round(d * dis_scale), 0, 255).to(torch.uint8)
