"""Spatially tiled + data-parallel PatchMatch over a (data, ty, tx) mesh
(port of crossscalepatchmatch_tpu.parallel.tiled on torch.distributed).

Layout (parallel.mesh): "data" shards independent pairs; "ty" shards each
pair's rows into bands and "tx" its columns into blocks, with halo
exchange between neighbouring ranks, multi-hop for halos taller than a
block (parallel._comm):
  - image and cost-volume halos: half_wnd pixels, once after the build;
  - plane-state halos: max(far_offsets) pixels before every propagation
    sweep (rows and columns apart: the stencil is axis-aligned, so corners
    are never needed);
  - disparity, validity and image halos for the weighted median, once.
Both views of a pair stay on one rank.  Row-wide stages (view
propagation's warp, the LR check, the scanline fill) run on full-width
rows gathered along "tx" (u8 maps and plane rows: small) and slice the
block back out.

Coordinates: a rank keeps planes in block-local (x, y) (d = a*x + b*y +
c); a plane crossing a block boundary in a halo exchange or a full-width
gather is re-anchored (c +- b*j*Hs rows, c +- a*j*Ws columns).

The GRD volume is built on full-width row bands (it is row-local); the
census volume (9x9 windows wrapping at the global borders), the
aggregation filters and the cross-scale pyramid need the whole image, so
for those the views are gathered once and the coarse levels are built
whole on every rank (they cost a geometrically shrinking share of the fine
level).  The cost functions are the kernels' band forms on the tile
(models.patchmatch.make_cost_fns with a Band): K1 / K3 / K4 on the
halo-extended block with the validity interval of the global image, K2
over the block's own pixels; on CPU tensors their plain band forms.

API: every rank of the mesh calls an entry point with the same global
u8[B, H, W, 3] batch (what the JAX single controller sees), computes its
block and gets the global u8[B, 2, H, W] maps back (the maps are small;
gathered at the end along "tx", "ty" and "data" in turn).  B must divide
by the "data" size, H by "ty" and W by "tx".  A mesh may span the first n
ranks of a larger process group (parallel.mesh.make_mesh): a rank outside
it gets None from every entry point at once and takes part in none of the
mesh's collectives, which run on the mesh's own axis groups only.

NCCL asks that the first point-to-point call on a group include every
rank of the group.  A halo exchange (parallel._comm.extend_axis) skips a
rank with no neighbour at some hop distance, so a tile's first
communication on each axis is a collective every rank of the axis joins:
the images' gather along "tx", and along "ty" the gather of the full
images or the max of the volumes (_TilePair), before any halo exchange.

Draws: `draws(seed, tile)` makes a tile's draw source (utils.rng), tile =
ty * n_tx + tx; by default TorchDraws keyed by (seed, tile).  A test may
hand in sources that replay the JAX engine's fold_in(PRNGKey(seed), tile)
tree, so the port follows the JAX trajectory tile by tile.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import Aggregator, CostMethod, CSPMConfig
from ..models import patchmatch as pm
from ..models import postprocess as pp
from ..ops.color import bgr_to_lab_u8, bgr_to_rgb
from ..ops.cost_volume import VolumeData, aggregate_volumes, build_volumes
from ..ops.pyramid import build_pyramid
from ..support import check_supported
from ..utils.rng import TorchDraws
from . import _comm
from ._comm import Axis, all_gather, all_max

DrawFactory = Callable[[int, int], object]


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on.  "cuda" without an index is card
    LOCAL_RANK % device_count (one rank a process; ranks share a card where
    the host has fewer cards than ranks; a mesh over the first n ranks of
    a larger group keeps each rank on its own card); anything else is
    taken as given.  Raises RuntimeError for "cuda" on a host without a
    card."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda': this host has no CUDA device")
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % n)


# -- halo exchange ----------------------------------------------------------

def extend_axis(x: torch.Tensor, halo: int, dim: int, mesh: DeviceMesh,
                axis_name: str) -> torch.Tensor:
    """Prepend / append `halo` slices along `dim` from the mesh neighbours
    on `axis_name` (multi-hop; zeros past the global image)."""
    return _comm.extend_axis(x, halo, dim, _comm.axis(mesh, axis_name))


def extend_rows(x: torch.Tensor, halo: int, mesh: DeviceMesh,
                dim: int = 0) -> torch.Tensor:
    """extend_axis along "ty" (the rows, tensor dimension `dim`)."""
    return extend_axis(x, halo, dim, mesh, "ty")


def extend_cols(x: torch.Tensor, halo: int, mesh: DeviceMesh,
                dim: int = 1) -> torch.Tensor:
    """extend_axis along "tx" (the columns, tensor dimension `dim`)."""
    return extend_axis(x, halo, dim, mesh, "tx")


def _reanchored(ext: torch.Tensor, halo: int, size: int, dim: int,
                coef: int) -> torch.Tensor:
    """c re-anchored on the halos of a plane field [..., 3] extended along
    `dim`: a plane from the block j away before carried coordinate
    x + j*size, so c += ab * j*size there (minus after), ab being a
    (coef 0, columns) or b (coef 1, rows)."""
    e = torch.arange(halo, device=ext.device)
    j_lo = ((halo - e + size - 1) // size).to(ext.dtype) * size
    j_hi = (e // size + 1).to(ext.dtype) * size
    shape = [1] * (ext.dim() - 1)
    shape[dim] = halo
    lo = ext.narrow(dim, 0, halo)
    mid = ext.narrow(dim, halo, size)
    hi = ext.narrow(dim, halo + size, halo)
    lo = torch.cat([lo[..., :2], (lo[..., 2] + lo[..., coef]
                                  * j_lo.reshape(shape))[..., None]], -1)
    hi = torch.cat([hi[..., :2], (hi[..., 2] + (-hi[..., coef])
                                  * j_hi.reshape(shape))[..., None]], -1)
    return torch.cat([lo, mid, hi], dim=dim)


def _extend_planes(abc: torch.Tensor, halo: int, hs: int,
                   mesh: DeviceMesh) -> torch.Tensor:
    """Plane state [..., Hs, Ws, 3] extended by `halo` rows from the "ty"
    neighbours, c re-anchored into local rows (JAX tiled.py:98-114)."""
    return _reanchored(extend_rows(abc, halo, mesh, dim=-3), halo, hs,
                       abc.dim() - 3, 1)


def _extend_planes_cols(abc: torch.Tensor, halo: int, ws: int,
                        mesh: DeviceMesh) -> torch.Tensor:
    """The column analogue of _extend_planes (JAX tiled.py:117-130)."""
    return _reanchored(extend_cols(abc, halo, mesh, dim=-2), halo, ws,
                       abc.dim() - 2, 0)


def _ext_from_full(full: torch.Tensor, start: int, size: int, halo: int,
                   dim: int = 0) -> torch.Tensor:
    """Slices [start - halo, start + size + halo) of an array every rank
    holds whole, zeros outside the global image (JAX tiled.py:133-143)."""
    pad = [0, 0] * full.dim()
    pad[2 * (full.dim() - 1 - dim % full.dim())] = halo
    pad[2 * (full.dim() - 1 - dim % full.dim()) + 1] = halo
    return torch.nn.functional.pad(full, pad).narrow(dim, start,
                                                     size + 2 * halo)


# -- one pair on one tile ---------------------------------------------------

@dataclasses.dataclass
class _Ctx:
    """This rank's place in the mesh and the run's constants."""

    mesh: DeviceMesh
    cfg: CSPMConfig
    device: torch.device
    n_data: int
    n_ty: int
    n_tx: int
    d: int
    ty: int
    tx: int
    ax_data: Axis
    ax_ty: Axis
    ax_tx: Axis

    @property
    def spatial(self) -> List[Axis]:
        return [self.ax_ty, self.ax_tx]

    @property
    def tile(self) -> int:
        return self.ty * self.n_tx + self.tx


def _context(mesh: DeviceMesh, cfg: CSPMConfig, device) -> Optional[_Ctx]:
    """This rank's context, or None on a rank outside the mesh."""
    if tuple(mesh.mesh_dim_names or ()) != ("data", "ty", "tx"):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}: expected "
                         "('data', 'ty', 'tx') (parallel.mesh.make_mesh)")
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    n_data, n_ty, n_tx = mesh.shape
    d, ty, tx = coord
    return _Ctx(mesh, cfg, rank_device(device), n_data, n_ty, n_tx, d, ty,
                tx, *(_comm.axis(mesh, name) for name in mesh.mesh_dim_names))


class _TilePair:
    """One pair's tile on this rank (JAX tiled.py:152-583): the volume data
    and the band-form cost functions, built once, the tile's draws and the
    optimizer's halo-aware neighbour and view candidates."""

    def __init__(self, ctx: _Ctx, l_loc: torch.Tensor, r_loc: torch.Tensor,
                 draws):
        cfg = ctx.cfg
        self.ctx, self.cfg, self.draws = ctx, cfg, draws
        hs, ws, _ = l_loc.shape
        hw = cfg.half_wnd
        n_ty, n_tx = ctx.n_ty, ctx.n_tx
        self.hs, self.ws, self.hw = hs, ws, hw
        # far rings taller than the block come by multi-hop exchange, so
        # the stencil is the single-device one on any block size
        self.far = max(max(cfg.far_offsets, default=0), 1)
        self.row0, self.col0 = ctx.ty * hs, ctx.tx * ws
        self.h_glob, self.w_glob = n_ty * hs, n_tx * ws
        row0, col0 = self.row0, self.col0
        levels = cfg.scale_num if cfg.use_cs else 1
        aggregated = cfg.aggregator != Aggregator.NONE
        need_full = (cfg.use_cs or cfg.cost_method != CostMethod.GRD
                     or aggregated)

        imgs = torch.stack([l_loc, r_loc])
        # full-width row bands [2, Hs, W, 3]
        imgs_roww = all_gather(imgs, 2, ctx.ax_tx)
        if need_full:
            full_imgs = all_gather(imgs_roww, 1, ctx.ax_ty)

        def col_block(x, halo):
            """Columns [col0 - halo, col0 + ws + halo) of full-width rows
            [2, R, W, ...]."""
            return x if n_tx == 1 else _ext_from_full(x, col0, ws, halo, 2)

        # fine-level volumes and the global saturation values
        if cfg.cost_method == CostMethod.GRD and not aggregated:
            # row-local GRD: built on the full-width band, the column
            # block cut out, the row halos exchanged (after the max: the
            # axis's first communication is a collective, module note)
            l_rgb, r_rgb = bgr_to_rgb(imgs_roww[0]), bgr_to_rgb(imgs_roww[1])
            vols_cb = col_block(
                build_volumes(l_rgb, r_rgb, cfg.max_dis, cfg), hw)
            vols = vols_cb[:, :, hw:hw + ws] if n_tx > 1 else vols_cb
            max_cost = all_max(vols.amax(dim=(1, 2, 3)), ctx.spatial)
            ext_vols = extend_rows(vols_cb, hw, ctx.mesh, dim=1)
        else:
            lf, rf = bgr_to_rgb(full_imgs[0]), bgr_to_rgb(full_imgs[1])
            vols_full = aggregate_volumes(
                build_volumes(lf, rf, cfg.max_dis, cfg), full_imgs, cfg)
            ext_vols = col_block(_ext_from_full(vols_full, row0, hs, hw, 1),
                                 hw)
            vols = (ext_vols[:, hw:hw + hs, hw:hw + ws] if n_tx > 1
                    else ext_vols[:, hw:hw + hs])
            max_cost = all_max(vols.amax(dim=(1, 2, 3)), ctx.spatial)
        del vols

        # image halos and the validity of the extended rows / columns
        self.ext_imgs = extend_rows(col_block(imgs_roww, hw), hw, ctx.mesh,
                                    dim=1)
        dev = l_loc.device
        g_row = row0 + torch.arange(-hw, hs + hw, device=dev)
        self.row_valid = (g_row >= 0) & (g_row < self.h_glob)
        g_col = col0 + torch.arange(-hw, ws + hw, device=dev)
        self.col_valid = (g_col >= 0) & (g_col < self.w_glob)

        vd = VolumeData(imgs=[self.ext_imgs], vols=[ext_vols],
                        max_costs=[max_cost],
                        wimgs=[bgr_to_lab_u8(self.ext_imgs)]
                        if cfg.use_lab_weights else None)
        bounds = [(-row0, self.h_glob - row0, -col0, self.w_glob - col0)]
        if cfg.use_cs:
            # the coarse levels, whole on every rank
            l_pyr = build_pyramid(full_imgs[0], levels)
            r_pyr = build_pyramid(full_imgs[1], levels)
            md = cfg.max_dis
            for s in range(1, levels):
                md //= 2
                ls, rs = bgr_to_rgb(l_pyr[s]), bgr_to_rgb(r_pyr[s])
                vd.imgs.append(torch.stack([l_pyr[s], r_pyr[s]]))
                v_s = aggregate_volumes(build_volumes(ls, rs, md, cfg),
                                        vd.imgs[-1], cfg)
                vd.vols.append(v_s)
                vd.max_costs.append(v_s.amax(dim=(1, 2, 3)))
                if vd.wimgs is not None:
                    vd.wimgs.append(bgr_to_lab_u8(vd.imgs[-1]))
                hs_s, ws_s = v_s.shape[1:3]
                bounds.append((-row0, (hs_s << s) - row0, -col0,
                               (ws_s << s) - col0))
        band = pm.Band(rows_extended=True, cols_extended=n_tx > 1,
                       origin=(row0, col0), bounds=tuple(bounds))
        self.cost_fn, self.sparse_fn = pm.make_cost_fns(cfg, vd, band)

    # -- the optimizer's view of the halos ---------------------------------

    def neighbours(self, abc: torch.Tensor, offsets) -> torch.Tensor:
        """The stencil's candidate planes across the tile's halos (rows
        from the row-extended field, columns from the column-extended one
        when columns are sharded)."""
        mesh, far, hs, ws = self.ctx.mesh, self.far, self.hs, self.ws
        ext_r = _extend_planes(abc, far, hs, mesh)
        if self.ctx.n_tx > 1:
            ext_c = _extend_planes_cols(abc, far, ws, mesh)
        cands = []
        for dy, dx in offsets:
            if dx != 0 and self.ctx.n_tx > 1:
                cands.append(torch.roll(ext_c, dx, dims=2)[:, :,
                                                           far:far + ws])
            else:
                cands.append(torch.roll(ext_r, (dy, dx),
                                        dims=(1, 2))[:, far:far + hs])
        return torch.stack(cands, dim=1)

    def _abc_global_x(self, abc: torch.Tensor) -> torch.Tensor:
        """Full-width plane rows gathered along "tx", re-anchored to global
        x: c_glob = c - a * (block * Ws)."""
        g = all_gather(abc, 2, self.ctx.ax_tx)
        xoff = ((torch.arange(self.w_glob, device=abc.device) // self.ws)
                * self.ws).to(torch.float32)
        return torch.cat([g[..., :2],
                          (g[..., 2] + (-g[..., 0]) * xoff)[..., None]], -1)

    def view(self, state: pm.PMState) -> torch.Tensor:
        """View-propagation candidates with columns sharded: the warp runs
        on full-width global-x rows, the block is sliced back out and
        re-anchored to local x (JAX tiled.py:482-506)."""
        abc_g = self._abc_global_x(state.abc)
        cand = pm.view_candidates(pm.PMState(abc=abc_g, cost=None),
                                  self.cfg)[:, :, :, self.col0:
                                            self.col0 + self.ws]
        return torch.cat([cand[..., :2], (cand[..., 2] + cand[..., 0]
                                          * self.col0)[..., None]], -1)

    def run(self, start: Optional[Tuple[pm.PMState, int]] = None,
            stop: Optional[int] = None, on_iteration=None) -> pm.PMState:
        """The optimizer on the tile: a fresh init (start None) or the
        state after start[1] iterations, to the state after `stop`."""
        return pm.patchmatch(
            self.draws, (self.hs, self.ws), self.cost_fn, self.cfg,
            self.sparse_fn, device=self.ctx.device, start=start, stop=stop,
            on_iteration=on_iteration, neighbours=self.neighbours,
            view=self.view if self.ctx.n_tx > 1 else None)

    def finalize(self, state: pm.PMState) -> torch.Tensor:
        """Planes -> u8[2, Hs, Ws] maps, post-processed when cfg.use_pp
        (JAX tiled.py:554-583)."""
        cfg, ctx, hw = self.cfg, self.ctx, self.hw
        dis = pm.plane_to_disp(state.abc, cfg.dis_scale)
        if not cfg.use_pp:
            return dis
        n_tx, col0, ws = ctx.n_tx, self.col0, self.ws
        if n_tx > 1:
            # the LR check and the fill are row-wide: full-width rows
            dis_w = all_gather(dis, 2, ctx.ax_tx)
            valid_w = pp.lr_check(dis_w, cfg)
            dis_w = pp.fill_invalid(dis_w, self._abc_global_x(state.abc),
                                    valid_w, cfg)
            dis = dis_w[:, :, col0:col0 + ws]
            valid = valid_w[:, :, col0:col0 + ws]
        else:
            valid = pp.lr_check(dis, cfg)
            dis = pp.fill_invalid(dis, state.abc, valid, cfg)

        def ext_hw(x):
            if n_tx > 1:
                x = extend_cols(x, hw, ctx.mesh, dim=2)
            return extend_rows(x, hw, ctx.mesh, dim=1)

        ext_valid = ext_hw(valid) & self.row_valid[None, :, None]
        if n_tx > 1:
            ext_valid = ext_valid & self.col_valid[None, None, :]
        return pp.weighted_median(ext_hw(dis), self.ext_imgs, ext_valid, cfg,
                                  center_row0=hw, out_h=self.hs,
                                  center_col0=hw if n_tx > 1 else 0,
                                  out_w=ws if n_tx > 1 else None)


# -- the entry points -------------------------------------------------------

def _batch(l_bgr, r_bgr, seeds, ctx: _Ctx):
    """(l, r, seeds) of the global batch as tensors, checked against the
    mesh; ValueError for a batch, height or width the mesh does not
    divide."""
    l = torch.as_tensor(np.asarray(l_bgr) if not torch.is_tensor(l_bgr)
                        else l_bgr)
    r = torch.as_tensor(np.asarray(r_bgr) if not torch.is_tensor(r_bgr)
                        else r_bgr)
    seeds = [int(s) for s in np.asarray(
        seeds.cpu() if torch.is_tensor(seeds) else seeds).reshape(-1)]
    if l.dim() != 4 or l.shape != r.shape or l.shape[-1] != 3:
        raise ValueError(f"views {tuple(l.shape)} / {tuple(r.shape)}: "
                         "expected u8[B, H, W, 3] each")
    b, h, w, _ = l.shape
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} pairs")
    for n, size, what in ((ctx.n_data, b, "batch"), (ctx.n_ty, h, "height"),
                          (ctx.n_tx, w, "width")):
        if size % n:
            raise ValueError(f"{what} {size} does not divide by the mesh's "
                             f"{n}")
    check_supported(ctx.cfg, (h, w), ctx.device)
    return l, r, seeds


def _my_pairs(b: int, ctx: _Ctx) -> range:
    per = b // ctx.n_data
    return range(ctx.d * per, (ctx.d + 1) * per)


def _block(x: torch.Tensor, ctx: _Ctx) -> torch.Tensor:
    """This rank's spatial block of one pair's [H, W, ...] array, on the
    rank's device."""
    hs, ws = x.shape[0] // ctx.n_ty, x.shape[1] // ctx.n_tx
    return x[ctx.ty * hs:(ctx.ty + 1) * hs,
             ctx.tx * ws:(ctx.tx + 1) * ws].to(ctx.device)


def _assemble(blk: torch.Tensor, ctx: _Ctx, row_dim: int) -> torch.Tensor:
    """Every rank's [B/n_data, ..., Hs, Ws, ...] block (rows at `row_dim`,
    columns after) gathered into the global [B, ..., H, W, ...] on every
    rank of the mesh: along "tx", then "ty", then "data", each in its
    axis's order (the mesh's own groups)."""
    rows = all_gather(blk, row_dim + 1, ctx.ax_tx)
    pair = all_gather(rows, row_dim, ctx.ax_ty)
    return all_gather(pair, 0, ctx.ax_data)


def _default_draws(ctx: _Ctx) -> DrawFactory:
    return lambda seed, tile: TorchDraws(seed, ctx.device, tile=tile)


def _tiles(l, r, seeds, ctx: _Ctx, draws: DrawFactory | None):
    """This rank's _TilePair of each of its pairs (volumes built)."""
    draws = draws or _default_draws(ctx)
    return [_TilePair(ctx, _block(l[b], ctx), _block(r[b], ctx),
                      draws(seeds[b], ctx.tile))
            for b in _my_pairs(l.shape[0], ctx)]


def run_batch_sharded(l_bgr, r_bgr, seeds, cfg: CSPMConfig,
                      mesh: DeviceMesh, *, device="cuda",
                      draws: DrawFactory | None = None) -> torch.Tensor:
    """Batched sharded pipeline (JAX tiled.py:586-644).

    Args:
      l_bgr / r_bgr: u8[B, H, W, 3], the same global batch on every rank;
        B divisible by the mesh's "data", H by "ty", W by "tx".
      seeds: B ints.
      device: where this rank computes (rank_device).
      draws: draws(seed, tile) -> draw source (see the module note).

    Returns:
      u8[B, 2, H, W] scaled disparity maps, on every rank of the mesh (on
      its device); None at once on a rank outside the mesh.

    Without a volume (precompute_volume=False) the mesh must be data-only:
    each pair then runs whole, models.pipeline.run_pair with its seed.
    """
    ctx = _context(mesh, cfg, device)
    if ctx is None:
        return None
    l, r, seeds = _batch(l_bgr, r_bgr, seeds, ctx)
    if not cfg.precompute_volume:
        if ctx.n_ty > 1 or ctx.n_tx > 1:
            raise NotImplementedError(
                "the no-volume cost supports batch data parallelism only "
                "(the fly kernel has no halo form); use a (data, 1, 1) mesh "
                "or precompute_volume")
        from ..models.pipeline import run_pair

        dis = [run_pair(l[b], r[b], seeds[b], cfg, device=ctx.device)["dis"]
               for b in _my_pairs(l.shape[0], ctx)]
        return _assemble(torch.stack(dis), ctx, 2)
    dis = [t.finalize(t.run()) for t in _tiles(l, r, seeds, ctx, draws)]
    return _assemble(torch.stack(dis), ctx, 2)


def run_batch_sharded_steps(l_bgr, r_bgr, seeds, cfg: CSPMConfig,
                            mesh: DeviceMesh, state=None, it_lo: int = 0,
                            it_hi: int | None = None, finalize: bool = False,
                            *, device="cuda",
                            draws: DrawFactory | None = None,
                            on_iteration=None):
    """Outer iterations [it_lo, it_hi) of the sharded pipeline (JAX
    tiled.py:647-698), for checkpoint and resume drivers.

    Starts from `state`, the global (abc f32[B, 2, H, W, 3], cost
    f32[B, 2, H, W]) after it_lo iterations, of which a rank reads only its
    own blocks, or from a fresh init (state None, it_lo 0); returns the
    global state after it_hi (cfg.max_iter if None) iterations, or with
    finalize=True the maps as run_batch_sharded does.  The volumes are
    built once a call and the rank's pairs advance an iteration at a time
    together: on_iteration(states, i), if given, is called after the init
    (i = 0) and after every iteration i with this rank's block states (a
    models.patchmatch.PMState of [2, Hs, Ws] each of its pairs).  The draws
    are keyed by iteration, so calls over [0, a) then [a, b) compose to the
    uninterrupted run bit for bit.  A rank outside the mesh gets None at
    once.
    """
    if not cfg.precompute_volume:
        raise NotImplementedError(
            "the sharded checkpoint/resume path supports precomputed "
            "volumes only (the no-volume path runs via run_batch_sharded "
            "on a data-only mesh, without iteration slicing)")
    if state is None and it_lo:
        raise ValueError(f"no state to start from at iteration {it_lo}")
    ctx = _context(mesh, cfg, device)
    if ctx is None:
        return None
    l, r, seeds = _batch(l_bgr, r_bgr, seeds, ctx)
    tiles = _tiles(l, r, seeds, ctx, draws)
    if state is None:
        states = [t.run(stop=0) for t in tiles]
        if on_iteration is not None:
            on_iteration(states, 0)
    else:
        def block(x, b):
            return _block(torch.as_tensor(x[b]).movedim(0, 2),
                          ctx).movedim(2, 0)

        states = [pm.PMState(abc=block(state[0], b), cost=block(state[1], b))
                  for b in _my_pairs(l.shape[0], ctx)]
    for it in range(it_lo, cfg.max_iter if it_hi is None else it_hi):
        states = [t.run((st, it), it + 1) for t, st in zip(tiles, states)]
        if on_iteration is not None:
            on_iteration(states, it + 1)
    if finalize:
        return _assemble(torch.stack([t.finalize(st) for t, st in
                                      zip(tiles, states)]), ctx, 2)
    return (_assemble(torch.stack([st.abc for st in states]), ctx, 2),
            _assemble(torch.stack([st.cost for st in states]), ctx, 2))


def run_sequence_batch(frames, cfg: CSPMConfig, mesh: DeviceMesh,
                       seed: int = 0, warm_iters: int = 1, *,
                       device="cuda"):
    """Batched video: B independent streams over a data-only mesh (JAX
    tiled.py:706-763).

    Frame 0 of every stream starts cold, each later frame warm from its own
    stream's previous planes; stream b's frame t takes seed + t +
    1000003 * b, so stream b equals models.pipeline.run_sequence_np(seed +
    1000003 * b) byte for byte.

    Args:
      frames: iterable of (left u8[B, H, W, 3], right u8[B, H, W, 3]).
      mesh: a (data, 1, 1) mesh.

    Yields per frame: {"dis": u8[B, 2, H, W], "abc": f32[B, 2, H, W, 3]} on
    every rank of the mesh; nothing on a rank outside it.
    """
    ctx = _context(mesh, cfg, device)
    if ctx is None:
        return
    if ctx.n_ty > 1 or ctx.n_tx > 1:
        raise NotImplementedError(
            "run_sequence_batch shards streams over 'data' only; use a "
            "(data, 1, 1) mesh")
    from ..models.pipeline import run_pair, run_pair_warm

    abc = None
    for t, (l_bgr, r_bgr) in enumerate(frames):
        b = np.asarray(l_bgr).shape[0]
        seeds = [seed + t + 1000003 * i for i in range(b)]
        l, r, seeds = _batch(l_bgr, r_bgr, seeds, ctx)
        outs = []
        for k, i in enumerate(_my_pairs(b, ctx)):
            if abc is None:
                outs.append(run_pair(l[i], r[i], seeds[i], cfg,
                                     device=ctx.device))
            else:
                outs.append(run_pair_warm(l[i], r[i], seeds[i], abc[k], cfg,
                                          warm_iters, device=ctx.device))
        abc = [o["abc"] for o in outs]
        yield {"dis": _assemble(torch.stack([o["dis"] for o in outs]),
                                ctx, 2),
               "abc": _assemble(torch.stack(abc), ctx, 2)}
