"""Time the port's kernels on a CUDA card beside their bounds, and the
seed-0 paths' output digests, ms/pair and peak device memory, optionally
against another checkout of the repository.

    python tools/torch_kernel_ab.py [--parent DIR] [--reps 5]

The kernels' correctness on the card is the GPU tier's
(tests/test_torch_kernels_gpu.py); this tool times them.  First it runs
README_DEMO and CEN_CS_PP on the bench scene (SHAPE: 375x450, max_dis 60)
and KITTI (with its volumes) on the KITTI scene (KITTI_SHAPE: 375x1242,
max_dis 128), seed 0, three times each: the seed-0 `dis` digest, the
ms/pair of each run, the peak device memory and the launches of a pair
(utils.profiling.launch_counts()).  Then it times every case
of CASES, a table keyed by the kernel keys of
utils.profiling.launch_counts(): K1 / K3's volume form / K2 / QRANK on the
bench and KITTI scenes' GRD volumes and in band form on the bench scene's
middle tile of a (1, 3, 2) mesh (125 + 34 rows x 225 + 34 columns); K4 on
the bench scene's 5 CEN_CS_PP levels, whole and in band form; the fly
kernel variant by variant (K5, K3's fly form, K6 and its stride-2 form,
K7, the 5-level cross-scale fly) on the bench and KITTI scenes; QRANK on
random planes (test_planes) and on the pipeline's candidates (the
propagation stencil's neighbours of the seed-0 run_pair output's final
planes); WMF on the seed-0
CEN_CS_PP and KITTI pairs' inputs and in band form on the bench tile (the
wrapper and the kernel's launch alone); GRDV on both scenes and the bench
tile's full-width rows; CENV at each CEN_CS_PP level, all 5 and a KITTI-size
level; RPROP a KITTI and a bench refinement stage on the seed-0 planes; BFV
on README_DEMO's, KITTI's and a 5-level pyramid's coarsest level.

Every time is CUDA events around `reps` calls after a warm-up, on prepared
inputs (packing and layout copies outside the timed region); GRDV, CENV,
RPROP and BFV also their device time a call (queued_ms: the calls queued
behind a spinning kernel, so the host's launch cost drops out).  Beside
each time: the kernel's bound on these inputs
(utils.roofline.bound: the larger of the bytes over the HBM rate and the
f32 operations over the data sheet's f32 peak; utils.roofline counts both)
and the time's share of it; QRANK also the floor a gather of its taps can
reach (the distinct 32-byte sectors of bq they touch), WMF the bisection's
count (median_samples) beside the least work of an exact search.  Each
case also names its plain version (the one a CPU tensor takes, here on
the card's tensors; f32), which the card smoke at the repository's root
times once (time_cases' `plain`): seconds a call at these shapes, too
slow for an A/B.

--parent DIR: a checkout of another commit (`git archive` of it unpacked
under build/); its kernels are built and timed in a process of their own
before and after this checkout's, so the order is parent, change, parent
on one card.  Each process imports nothing from the checkout it times but
the package.  Prints one JSON line per process with every time in ms.
"""

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

SHAPE = dict(h=375, w=450, max_dis=60)          # the bench scene
KITTI_SHAPE = dict(h=375, w=1242, max_dis=128)  # the KITTI scene
MESH_TILE = (3, 2)           # the band forms' (ty, tx) mesh, tile (1, 1)


@dataclasses.dataclass
class Case:
    name: str
    fn: object
    work: tuple                     # (bytes, f32 operations) of one call
    device: bool = False            # also the device time a call
    beside: dict = dataclasses.field(default_factory=dict)  # more (bytes, ops)
    plain: object = None            # the plain version on the same inputs


def time_turns(fns, reps):
    """ms per call of each fn, CUDA events, in turns a, b, ..., ..., b, a
    after one warm-up call of each."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    acc = {n: [] for n in names}
    for n in names + names[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps[n]):
            fns[n]()
        end.record()
        torch.cuda.synchronize()
        acc[n].append(start.elapsed_time(end) / reps[n])
    return {n: sum(v) / len(v) for n, v in acc.items()}


def test_planes(pair, max_dis, k, gen, device):
    """f32[2, K, H, W, 3] on the scene `pair`: candidate 0 converged-like
    (ground truth plus jitter, small slopes), the others random init planes
    over [0, max_dis); ~0.1% of the pixels of the last candidate get a wild
    near-zero-nz plane."""
    import numpy as np
    import torch

    from crossscalepatchmatch_tpu_torch.ops import plane

    h, w = pair.disp_left.shape
    xs, ys = plane.pixel_grid(h, w, device)
    gt = torch.as_tensor(np.stack([pair.disp_left, pair.disp_right]),
                         device=device)
    md = float(max_dis)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    ab = u(2, h, w, 2, lo=-0.05, hi=0.05)
    dc = gt + u(2, h, w, lo=-0.5, hi=0.5)
    cands = [plane.reanchor(ab, xs, ys, dc)]
    for _ in range(k - 1):
        cands.append(plane.random_planes(
            u(2, h, w, lo=1e-8, hi=md),
            torch.randn((2, h, w, 3), generator=gen, device=device)))
    wild_n = torch.cat([u(2, h, w, 2), torch.full((2, h, w, 1), 1e-9,
                                                   device=device)], -1)
    wild = plane.random_planes(u(2, h, w, lo=1e-8, hi=md), wild_n)
    pick = torch.rand((2, h, w), generator=gen, device=device) < 1e-3
    cands[-1] = torch.where(pick[..., None], wild, cands[-1])
    return torch.stack(cands, dim=1).contiguous()


class Ctx:
    """The scenes on the card and the planes' generator."""

    def __init__(self, dev):
        import torch

        from crossscalepatchmatch_tpu_torch.data import make_pair

        def scene(shape):
            pair = make_pair(seed=0, **shape)
            return (pair, torch.as_tensor(pair.left, device=dev),
                    torch.as_tensor(pair.right, device=dev))

        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.bench, self.kitti = scene(SHAPE), scene(KITTI_SHAPE)

    def planes(self, scene, max_dis, k):
        return test_planes(scene[0], max_dis, k, self.gen, self.dev)


def window_work(abc, inputs, levels, half_wnd, max_dis, stride=1,
                geoms=None, lerp=None):
    """(bytes, operations) of one K1 / K3 / K4 / fly launch on these
    planes: the inputs (images, volumes or gradients, saturation values)
    and the planes read once, the f32[2, K, H, W] costs written once;
    FLOPS_IN_IMAGE an in-image sample, FLOPS_IN_RANGE (the fly kernel's
    FLY_FLOPS_IN_RANGE[lerp]) an in-range one."""
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        FLOPS_IN_IMAGE, FLOPS_IN_RANGE, FLY_FLOPS_IN_RANGE, nbytes,
        window_samples)

    n_img, n_rng = window_samples(abc, levels, half_wnd, max_dis, stride,
                                  geoms)
    per = FLY_FLOPS_IN_RANGE[lerp] if lerp else FLOPS_IN_RANGE
    return (nbytes(*inputs, abc) + 4 * abc[..., 0].numel(),
            FLOPS_IN_IMAGE * n_img + per * n_rng)


def quadrant_work(imgs, vols, half_wnd, stride, out_hw, origin=(0, 0),
                  rect=None):
    """(bytes, operations) of one K2 launch: the images and volume read,
    bq f32[2, 4, H, W, D] and wq f32[2, 4, H, W] written; 2 D + 1
    operations an in-image sample."""
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        nbytes, quadrant_build_samples)

    h, w = out_hw
    d = vols.shape[-1]
    samples = quadrant_build_samples(h, w, half_wnd, stride, origin, rect)
    return (nbytes(imgs, vols) + 2 * 4 * h * w * (d + 1) * 4,
            samples * (2 * d + 1))


def bench_tile(cfg, dev):
    """The bench scene's middle tile of a (1, 3, 2) mesh (rows [125, 250),
    columns [225, 450): an odd origin), as parallel.tiled hands it to the
    band forms: level 0 the block with its half_wnd halo on both axes (125
    + 34 rows x 225 + 34 columns, zeros past the image), the coarser levels
    whole, the saturation values; per level the validity interval in the
    block's coordinates, the origin and the valid rectangle; and the
    block's (rows, columns) inside the image."""
    import torch

    from crossscalepatchmatch_tpu_torch.data import make_pair
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import cross_scale_cost
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full

    pair = make_pair(seed=0, **SHAPE)
    vd = build_volume_data(torch.as_tensor(pair.left, device=dev),
                           torch.as_tensor(pair.right, device=dev), cfg)
    h, w, hw = SHAPE["h"], SHAPE["w"], cfg.half_wnd
    hs, ws = h // MESH_TILE[0], w // MESH_TILE[1]
    row0, col0 = hs, ws

    def ext(x):
        return _ext_from_full(_ext_from_full(x, row0, hs, hw, 1), col0, ws,
                              hw, 2).contiguous()

    bounds = [(-row0, h - row0, -col0, w - col0)] + [
        (-row0, (im.shape[1] << s) - row0, -col0, (im.shape[2] << s) - col0)
        for s, im in enumerate(vd.imgs) if s]
    origins = [(hw, hw)] + [(row0, col0)] * (len(vd.imgs) - 1)
    imgs = [ext(vd.imgs[0])] + vd.imgs[1:]
    rects = [cross_scale_cost.band_rect(im.shape[1:3], s, o, (hs, ws), b)
             for s, (im, o, b) in enumerate(zip(imgs, origins, bounds))]
    g_row = row0 + torch.arange(-hw, hs + hw, device=dev)
    g_col = col0 + torch.arange(-hw, ws + hw, device=dev)
    valid = ((g_row >= 0) & (g_row < h), (g_col >= 0) & (g_col < w))
    return dict(pair=pair, imgs=imgs, vols=[ext(vd.vols[0])] + vd.vols[1:],
                mcs=vd.max_costs, bounds=bounds, origins=origins,
                rects=rects, hs=hs, ws=ws, origin=(row0, col0), valid=valid)


def tile_planes(ctx, tile, max_dis, k):
    """test_planes on the bench scene, cut to the tile and re-anchored to
    its local coordinates."""
    import torch

    (row0, col0), hs, ws = tile["origin"], tile["hs"], tile["ws"]
    full = ctx.planes(ctx.bench, max_dis, k)[:, :, row0:row0 + hs,
                                             col0:col0 + ws]
    c = full[..., 2] + full[..., 0] * col0 + full[..., 1] * row0
    return torch.cat([full[..., :2], c[..., None]], -1).contiguous()


def _dtypes():
    import torch

    return (("bf16", torch.bfloat16), ("f32", torch.float32))


def fine_level(ctx, tag, band=False):
    """What K1, K3's volume form, K2 and QRANK read: the fine-level GRD
    volume of the KITTI scene (KITTI's config) or the bench scene
    (README_DEMO's), or in band form the bench tile's block; with
    prepare_volumes' band flags, the kernels' bounds, the window counts'
    geometry, the output's (H, W), planes(k) on it and the plain
    versions' band arguments."""
    import types

    from crossscalepatchmatch_tpu_torch import KITTI, README_DEMO
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)

    cfg = KITTI if tag == "KITTI" else README_DEMO
    if band:
        t = bench_tile(cfg, ctx.dev)
        rv, cv = t["valid"]
        return types.SimpleNamespace(
            cfg=cfg, imgs=t["imgs"][0], vols=t["vols"][0], mc=t["mcs"][0],
            ext=dict(rows_extended=True, cols_extended=True),
            bounds=t["bounds"][0], geoms=[(t["origins"][0], t["rects"][0])],
            origin=t["origins"][0], rect=t["rects"][0],
            hw=(t["hs"], t["ws"]),
            planes=lambda k: tile_planes(ctx, t, cfg.max_dis, k),
            plain_band=dict(center_row0=cfg.half_wnd, row_valid=rv,
                            center_col0=cfg.half_wnd, col_valid=cv),
            mask=rv[:, None] & cv[None, :], tag="band (bench tile)")
    scene = ctx.kitti if tag == "KITTI" else ctx.bench
    vd = build_volume_data(scene[1], scene[2], cfg)
    return types.SimpleNamespace(
        cfg=cfg, imgs=vd.imgs[0], vols=vd.vols[0], mc=vd.max_costs[0],
        ext={}, bounds=None, geoms=None, origin=(0, 0), rect=None,
        hw=tuple(vd.imgs[0].shape[1:3]),
        planes=lambda k: ctx.planes(scene, cfg.max_dis, k), plain_band={},
        mask=None, tag=tag)


def both_views(fn, *args, **kw):
    """fn on each view's slice of the tensor arguments (lists of tensors
    sliced element by element), stacked; a tuple result stacked part by
    part."""
    import torch

    def view(x, v):
        if isinstance(x, list):
            return [view(e, v) for e in x]
        return x[v] if isinstance(x, torch.Tensor) and x.dim() else x

    outs = [fn(*(view(a, v) for a in args), **kw) for v in range(2)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def window_cases(ctx, tag, runs, band=False):
    """K1 (stride 1) and K3's volume form (stride > 1) on a fine level,
    bf16 and f32, at each (K, stride) of runs; the plain version
    (plane_cost.window_plane_cost, each view) on the f32 volume."""
    from crossscalepatchmatch_tpu_torch.ops import plane_cost
    from crossscalepatchmatch_tpu_torch.ops.cuda import window_cost

    f = fine_level(ctx, tag, band)
    kw = dict(half_wnd=f.cfg.half_wnd, max_dis=f.cfg.max_dis)
    vols = {dt: f.vols.to(dtype).contiguous() for dt, dtype in _dtypes()}
    preps = {dt: window_cost.prepare_volumes(f.imgs, v, f.mc,
                                             gamma=f.cfg.wgt_gamma, **kw,
                                             **f.ext)
             for dt, v in vols.items()}
    for k, stride in runs:
        abc = f.planes(k)
        kind = f"K3 volume stride {stride}" if stride > 1 else "K1"
        for dt, prep in preps.items():
            plain = (functools.partial(
                both_views, plane_cost.window_plane_cost, f.imgs, f.vols,
                f.mc, abc, gamma=f.cfg.wgt_gamma, wnd_stride=stride, **kw,
                **f.plain_band) if dt == "f32" else None)
            yield Case(f"{kind} {f.tag} {dt} K={k}", functools.partial(
                window_cost.window_cost_prepared, prep, abc,
                wnd_stride=stride, bounds=f.bounds, **kw), window_work(
                abc, [f.imgs, vols[dt], f.mc], 1, f.cfg.half_wnd,
                f.cfg.max_dis, stride, f.geoms), plain=plain)


def quadrant_cases(ctx, tag, band=False):
    """K2 on a fine level, bf16 and f32; the plain version
    (prescreen_volume.build_quadrant_volumes, each view, over the whole
    block in band form) on the f32 volume."""
    from crossscalepatchmatch_tpu_torch.ops import prescreen_volume
    from crossscalepatchmatch_tpu_torch.ops.cuda import (quadrant_build,
                                                         window_cost)

    f = fine_level(ctx, tag, band)
    cfg = f.cfg
    qkw = dict(half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
               stride=cfg.prescreen_stride)
    for dt, dtype in _dtypes():
        vols = f.vols.to(dtype).contiguous()
        prep = window_cost.prepare_volumes(
            f.imgs, vols, None, half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
            gamma=cfg.wgt_gamma, **f.ext)
        plain = (functools.partial(
            both_views, prescreen_volume.build_quadrant_volumes, f.imgs,
            f.vols, valid=f.mask, **qkw)
            if dt == "f32" else None)
        yield Case(f"K2 {f.tag} {dt}", functools.partial(
            quadrant_build.quadrant_volumes_prepared, prep,
            bounds=f.bounds, **qkw), quadrant_work(
            f.imgs, vols, cfg.half_wnd, cfg.prescreen_stride, f.hw,
            f.origin, f.rect), plain=plain)
        del prep


def cross_scale_cases(ctx, band=False):
    """K4 over the bench scene's 5 CEN_CS_PP census levels (band: on the
    bench tile), bf16 and f32 volumes; the plain version
    (plane_cost.cross_scale_plane_cost, each view) on the f32 volumes."""
    from crossscalepatchmatch_tpu_torch import CEN_CS_PP
    from crossscalepatchmatch_tpu_torch.ops import plane_cost
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import cross_scale_cost
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)

    cfg = CEN_CS_PP
    wgts = [float(x) for x in scale_weights(cfg.scale_num, cfg.reg_lambda)]
    kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis)
    if band:
        t = bench_tile(cfg, ctx.dev)
        imgs, vols, mcs = t["imgs"], t["vols"], t["mcs"]
        extra = dict(rows_extended=True, cols_extended=True,
                     origin=t["origin"], bounds=t["bounds"])
        rv, cv = t["valid"]
        n = len(vols)
        plain_band = dict(origins=[(cfg.half_wnd,) * 2]
                          + [t["origin"]] * (n - 1),
                          row_valids=[rv] + [None] * (n - 1),
                          col_valids=[cv] + [None] * (n - 1))
        geoms, tag = list(zip(t["origins"], t["rects"])), "band (bench tile)"
    else:
        vd = build_volume_data(ctx.bench[1], ctx.bench[2], cfg)
        imgs, vols, mcs = vd.imgs, vd.vols, vd.max_costs
        extra, plain_band, geoms, tag = {}, {}, None, "bench"
    kvols = {dt: [v.to(dtype) for v in vols] for dt, dtype in _dtypes()}
    preps = {dt: cross_scale_cost.prepare_cross_scale(
        imgs, v, mcs, wgts, gamma=cfg.wgt_gamma, **kw, **extra)
        for dt, v in kvols.items()}
    for k in ((1, 2) if band else (1, 2, 3)):
        abc = (tile_planes(ctx, t, cfg.max_dis, k) if band
               else ctx.planes(ctx.bench, cfg.max_dis, k))
        for dt, prep in preps.items():
            plain = (functools.partial(
                both_views, plane_cost.cross_scale_plane_cost, imgs, vols,
                mcs, wgts, abc, gamma=cfg.wgt_gamma, **kw, **plain_band)
                if dt == "f32" else None)
            yield Case(f"K4 {tag} {dt} K={k}", functools.partial(
                cross_scale_cost.cross_scale_cost_prepared, prep, abc,
                levels=len(vols), **kw), window_work(
                abc, [*imgs, *kvols[dt], *mcs], len(vols), cfg.half_wnd,
                cfg.max_dis, geoms=geoms), plain=plain)


# the fly kernel's variants: config fields on README_DEMO / KITTI without a
# volume
FLY_VARIANTS = {"K5": {}, "K6": dict(fly_lerp="image"),
                "K7": dict(use_lab_weights=True),
                "K5 cross-scale": dict(use_cs=True, reg_lambda=0.3)}


def fly_cases(ctx, tag, variant, runs):
    """The fly kernel's variant (FLY_VARIANTS) on the KITTI or bench scene,
    at each (K, stride) of runs; stride > 1 is K3's fly form (K6's own at
    stride 2: "K6 <tag> K=<k> stride <stride>").  The plain version:
    onthefly_cost.fly_plane_cost."""
    from crossscalepatchmatch_tpu_torch import KITTI, README_DEMO
    from crossscalepatchmatch_tpu_torch.ops import onthefly_cost
    from crossscalepatchmatch_tpu_torch.ops.cuda import fly_cost
    from crossscalepatchmatch_tpu_torch.ops.scale_weights import (
        scale_weights)

    scene = ctx.kitti if tag == "KITTI" else ctx.bench
    cfg = dataclasses.replace(KITTI if tag == "KITTI" else README_DEMO,
                              precompute_volume=False,
                              **FLY_VARIANTS[variant])
    fd = onthefly_cost.build_fly_data(scene[1], scene[2], cfg)
    levels = len(fd.imgs)
    wg = ([float(x) for x in scale_weights(cfg.scale_num, cfg.reg_lambda)]
          if levels > 1 else None)
    fkw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
               lerp=cfg.fly_lerp, gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha,
               tau_clr=cfg.tau_clr, tau_grd=cfg.tau_grd,
               border_thres=cfg.border_thres)
    prep = fly_cost.prepare_fly(fd, wg, **fkw)
    for k, stride in runs:
        abc = ctx.planes(scene, cfg.max_dis, k)
        name = (f"K3 fly stride {stride} {tag} K={k}"
                if stride > 1 and variant == "K5" else
                f"{variant} {tag} K={k}"
                + (f" stride {stride}" if stride > 1 else ""))
        yield Case(name, functools.partial(
            fly_cost.fly_cost_prepared, prep, abc, half_wnd=cfg.half_wnd,
            max_dis=cfg.max_dis, levels=levels, wnd_stride=stride),
            window_work(abc, [*fd.imgs, *fd.grds, *(fd.wimgs or [])],
                        levels, cfg.half_wnd, cfg.max_dis, stride,
                        lerp=cfg.fly_lerp), plain=functools.partial(
                onthefly_cost.fly_plane_cost, fd, wg, abc,
                wnd_stride=stride, **fkw))


def rank_cases(ctx, tag, band=False):
    """QRANK on K2's output over a fine level's f32 GRD volume, both
    views: K = 8 and 1 on random planes, and (whole image) the pipeline's
    candidates, the propagation stencil's neighbours of the seed-0
    run_pair output's final planes; the plain version
    prescreen_volume.quadrant_prescreen_cost, each view.  The bound counts
    8 bytes a tap pair
    on random planes (quadrant_rank_work) and each distinct tap float of a
    row once (quadrant_rank_row_work) on candidates that share taps."""
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.ops import prescreen_volume
    from crossscalepatchmatch_tpu_torch.ops.cuda import (quadrant_build,
                                                         quadrant_rank,
                                                         window_cost)
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        quadrant_rank_row_work, quadrant_rank_sectors, quadrant_rank_work)

    f = fine_level(ctx, tag, band)
    cfg = f.cfg
    kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis)
    prep = window_cost.prepare_volumes(f.imgs, f.vols, f.mc,
                                       gamma=cfg.wgt_gamma, **kw, **f.ext)
    bq, wq = quadrant_build.quadrant_volumes_prepared(
        prep, half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
        stride=cfg.prescreen_stride, bounds=f.bounds)
    mc = prep.max_costs
    del prep
    cases = [(f"random K={k}", f.planes(k), quadrant_rank_work)
             for k in (8, 1)]
    if not band:
        scene = ctx.kitti if tag == "KITTI" else ctx.bench
        abc = pm.stencil_candidates(run_pair(
            scene[1], scene[2], 0, cfg, device=ctx.dev)["abc"],
            pm._stencil(cfg, 0)).contiguous()
        cases.append((f"pipeline K={abc.shape[1]}", abc,
                      quadrant_rank_row_work))
    for name, abc, work in cases:
        sectors = quadrant_rank_sectors(abc, bq.shape[-1], cfg.half_wnd,
                                        cfg.max_dis)
        yield Case(f"QRANK {f.tag} {name}", functools.partial(
            quadrant_rank.quadrant_rank_cuda, bq, wq, mc, abc, **kw),
            work(abc, cfg.half_wnd, cfg.max_dis),
            beside={f"gather floor ({sectors} sectors)": (32 * sectors, 0)},
            plain=functools.partial(
                both_views, prescreen_volume.quadrant_prescreen_cost, bq, wq,
                mc, abc, **kw))


def wmf_inputs(cfg, scene, dev):
    """The weighted median's inputs in postprocess, from the seed-0
    run_pair output: the filled maps, the images, the LR mask."""
    import torch

    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models import postprocess as pp_mod
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair

    _, l, r = scene
    out = run_pair(l, r, 0, cfg, device=dev)
    valid = out["valid"]
    dis = pp_mod.fill_invalid(pm.plane_to_disp(out["abc"], cfg.dis_scale),
                              out["abc"], valid, cfg)
    return dis, torch.stack([l, r]), valid


def median_cases(ctx):
    """WMF on the seed-0 CEN_CS_PP and KITTI inputs and in band form on the
    bench tile (the CEN_CS_PP inputs with the half-window halo, zeros past
    the image, as parallel.tiled passes them): the wrapper (its two
    preparing launches and the kernel's), then the kernel's launch alone
    on prepared inputs; the plain version postprocess
    .weighted_median_plain beside the wrapper.  The bound is the least work
    of an exact search (median_least_ops), the bisection's count
    (median_samples) beside it."""
    import torch

    from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI
    from crossscalepatchmatch_tpu_torch.models import postprocess
    from crossscalepatchmatch_tpu_torch.ops import plane_cost
    from crossscalepatchmatch_tpu_torch.ops.cuda import weighted_median as wmf
    from crossscalepatchmatch_tpu_torch.parallel.tiled import _ext_from_full
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        WMF_OPS_PER_SAMPLE, median_least_ops, median_samples, nbytes)

    cs_in = wmf_inputs(CEN_CS_PP, ctx.bench, ctx.dev)
    hw = CEN_CS_PP.half_wnd
    hs, ws = SHAPE["h"] // MESH_TILE[0], SHAPE["w"] // MESH_TILE[1]

    def ext(x):
        return _ext_from_full(_ext_from_full(x, hs, hs, hw, 1), ws, ws, hw,
                              2).contiguous()

    dis, imgs, valid = cs_in
    band_in = (ext(dis), ext(imgs), ext(valid.to(torch.uint8)).bool())
    for tag, cfg, inputs, band in (
            ("CEN_CS_PP", CEN_CS_PP, cs_in, {}),
            ("KITTI", KITTI, wmf_inputs(KITTI, ctx.kitti, ctx.dev), {}),
            ("band (bench tile)", CEN_CS_PP, band_in,
             dict(center_row0=hw, out_h=hs, center_col0=hw, out_w=ws))):
        dis, imgs, valid = inputs
        lut = plane_cost.asw_lut(cfg.wmf_gamma, ctx.dev)
        r0, c0 = band.get("center_row0", 0), band.get("center_col0", 0)
        oh, ow = band.get("out_h", dis.shape[1]), band.get("out_w",
                                                            dis.shape[2])
        w_bytes = nbytes(dis, imgs, valid, lut) + 2 * oh * ow
        work = (w_bytes, median_least_ops(valid, cfg.half_wnd, **band))
        bisection = {"the bisection's count": (w_bytes, WMF_OPS_PER_SAMPLE
                                               * median_samples(
                                                   valid, cfg.half_wnd,
                                                   **band))}
        yield Case(f"WMF {tag} wrapper", functools.partial(
            wmf.weighted_median_cuda, dis, imgs, valid, lut,
            half_wnd=cfg.half_wnd, **band), work, beside=bisection,
            plain=functools.partial(postprocess.weighted_median_plain, dis,
                                    imgs, valid, cfg, **band))
        prep = wmf.prepare_median(dis, imgs, valid, r0, oh, c0, ow)
        yield Case(f"WMF {tag} launch alone", functools.partial(
            wmf.weighted_median_prepared, prep, lut, half_wnd=cfg.half_wnd),
            work, beside=bisection)


def grd_volume_cases(ctx):
    """GRDV (both views, the wrapper) on the bench and KITTI scenes and the
    bench tile's full-width rows, as parallel.tiled builds a GRD tile's
    volumes; the plain version grd_volume.grd_volumes_plain."""
    from crossscalepatchmatch_tpu_torch import KITTI, README_DEMO
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cuda import grd_volume
    from crossscalepatchmatch_tpu_torch.utils.roofline import grd_volume_work

    hs = SHAPE["h"] // MESH_TILE[0]
    for tag, (_, l, r), cfg, rows in (
            ("bench", ctx.bench, README_DEMO, slice(None)),
            ("KITTI", ctx.kitti, KITTI, slice(None)),
            (f"band (bench tile rows {hs}-{2 * hs})", ctx.bench,
             README_DEMO, slice(hs, 2 * hs))):
        lv, rv = bgr_to_rgb(l[rows]), bgr_to_rgb(r[rows])
        gkw = dict(alpha=cfg.cost_alpha, tau_clr=cfg.tau_clr,
                   tau_grd=cfg.tau_grd, border_thres=cfg.border_thres)
        yield Case(f"GRDV {tag}", functools.partial(
            grd_volume.grd_volumes, lv, rv, cfg.max_dis, **gkw),
            grd_volume_work(*lv.shape[:2], cfg.max_dis), device=True,
            plain=functools.partial(grd_volume.grd_volumes_plain,
                                    lv.contiguous(), rv.contiguous(),
                                    cfg.max_dis, **gkw))


def census_volume_cases(ctx):
    """CENV (both views, one call a level) at each of the bench scene's 5
    CEN_CS_PP levels, all 5 together, and a KITTI-size level; the plain
    version census_volume.census_volumes_plain."""
    from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI
    from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
    from crossscalepatchmatch_tpu_torch.ops.cuda import census_volume
    from crossscalepatchmatch_tpu_torch.ops.pyramid import build_pyramid
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        census_volume_work)

    wnd = CEN_CS_PP.census_wnd
    for tag, (_, l, r), md, levels in (
            ("bench", ctx.bench, CEN_CS_PP.max_dis, CEN_CS_PP.scale_num),
            ("KITTI", ctx.kitti, KITTI.max_dis, 1)):
        lp, rp = build_pyramid(l, levels), build_pyramid(r, levels)
        lvs = [(bgr_to_rgb(lp[s]), bgr_to_rgb(rp[s]), md >> s)
               for s in range(levels)]
        if levels > 1:
            for s, (a, b, m) in enumerate(lvs):
                yield Case(f"CENV {tag} level {s}", functools.partial(
                    census_volume.census_volumes, a, b, m, wnd),
                    census_volume_work(*a.shape[:2], m, 1, wnd), device=True)
        yield Case(f"CENV {tag} all {levels} level(s)", lambda lvs=lvs: [
            census_volume.census_volumes(a, b, m, wnd) for a, b, m in lvs],
            census_volume_work(*l.shape[:2], md, levels, wnd), device=True,
            plain=lambda lvs=lvs: [census_volume.census_volumes_plain(
                a.contiguous(), b.contiguous(), m, wnd) for a, b, m in lvs])


def refine_propose_cases(ctx):
    """RPROP on the seed-0 pipeline's final planes: a KITTI stage (5 of its
    10 rounds) and a bench CEN_CS_PP stage (Middlebury's 9 rounds: 5, then
    these 4); the plain version refine_propose.refine_propose_plain (the
    plain Philox's draws fed to perturb_planes)."""
    from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI
    from crossscalepatchmatch_tpu_torch.models import patchmatch as pm
    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.ops.cuda import refine_propose
    from crossscalepatchmatch_tpu_torch.utils.rng import TorchDraws
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        refine_propose_work)

    for tag, (_, l, r), cfg, rounds in (
            ("KITTI", ctx.kitti, KITTI, range(5)),
            ("bench", ctx.bench, CEN_CS_PP, range(5, 9))):
        abc = run_pair(l, r, 0, cfg, device=ctx.dev)["abc"].contiguous()
        zs, ns = pm.refinement_magnitudes(cfg)
        draws = TorchDraws(0, ctx.dev)
        yield Case(f"RPROP {tag} stage K={len(rounds)}", functools.partial(
            draws.propose, abc, 1, rounds, zs, ns, cfg.eps),
            refine_propose_work(len(rounds), *abc.shape[1:3]), device=True,
            plain=functools.partial(
                refine_propose.refine_propose_plain, abc, draws.key,
                phase=draws.refine_phase, iteration=1, rounds=rounds, zs=zs,
                ns=ns, eps=cfg.eps))


def bilateral_volume_cases(ctx):
    """BFV (both views, wnd 35) on README_DEMO-BF's level (375x450, D 61),
    KITTI-BF's (375x1242, D 129) and the coarsest level of a 5-level
    README_DEMO pyramid (24x29, D 4: narrower than the window); the plain
    version bilateral_volume.bilateral_volumes_plain."""
    from crossscalepatchmatch_tpu_torch import KITTI, README_DEMO
    from crossscalepatchmatch_tpu_torch.ops.cost_volume import (
        build_volume_data)
    from crossscalepatchmatch_tpu_torch.ops.cuda import bilateral_volume
    from crossscalepatchmatch_tpu_torch.utils.roofline import (
        bilateral_volume_work)

    for tag, (_, l, r), cfg, level in (
            ("README_DEMO level", ctx.bench, README_DEMO, 0),
            ("KITTI level", ctx.kitti, KITTI, 0),
            ("README_DEMO 5-level pyramid, level 4", ctx.bench,
             dataclasses.replace(README_DEMO, use_cs=True, scale_num=5), 4)):
        vd = build_volume_data(l, r, cfg)
        vols, guides = vd.vols[level], vd.imgs[level]
        del vd
        yield Case(f"BFV {tag}", functools.partial(
            bilateral_volume.bilateral_volumes_cuda, vols, guides,
            cfg.wnd_size), bilateral_volume_work(*vols.shape[1:],
                                                 cfg.wnd_size), device=True,
            plain=functools.partial(bilateral_volume.bilateral_volumes_plain,
                                    vols, guides, cfg.wnd_size))


# The timed cases by the kernel keys of utils.profiling.launch_counts():
# each builds its inputs when it runs.
CASES = {
    "k1": [lambda c: window_cases(c, "bench", [(1, 1), (2, 1)]),
           lambda c: window_cases(c, "KITTI", [(1, 1)]),
           lambda c: window_cases(c, "bench", [(1, 1), (2, 1)], band=True)],
    "k3_volume": [lambda c: window_cases(c, "bench", [(8, 2)]),
                  lambda c: window_cases(c, "bench", [(8, 2)], band=True)],
    "k2": [lambda c: quadrant_cases(c, "bench"),
           lambda c: quadrant_cases(c, "KITTI"),
           lambda c: quadrant_cases(c, "bench", band=True)],
    "k4": [cross_scale_cases, lambda c: cross_scale_cases(c, band=True)],
    "k5": [lambda c: fly_cases(c, "bench", "K5", [(1, 1), (2, 1), (3, 1)]),
           lambda c: fly_cases(c, "bench", "K5 cross-scale", [(1, 1)]),
           lambda c: fly_cases(c, "KITTI", "K5", [(1, 1), (2, 1)])],
    "k3_fly": [lambda c: fly_cases(c, "bench", "K5", [(8, 2), (5, 2)]),
               lambda c: fly_cases(c, "KITTI", "K5", [(8, 2), (5, 2)])],
    "k6": [lambda c: fly_cases(c, "bench", "K6", [(1, 1), (2, 1)]),
           lambda c: fly_cases(c, "KITTI", "K6", [(1, 1), (8, 2)])],
    "k7": [lambda c: fly_cases(c, "bench", "K7", [(1, 1)])],
    "wmf": [median_cases],
    "grdv": [grd_volume_cases],
    "qrank": [lambda c: rank_cases(c, "bench"),
              lambda c: rank_cases(c, "KITTI"),
              lambda c: rank_cases(c, "bench", band=True)],
    "cenv": [census_volume_cases],
    "rprop": [refine_propose_cases],
    "bfv": [bilateral_volume_cases],
}


def queued_ms(fn, reps):
    """fn's device time a call, in ms: `reps` calls queued behind a
    spinning kernel (torch.cuda._sleep, ~10 ms), so that they run back to
    back on the device whatever the host's launch cost, between CUDA
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """ms of one call of fn, CUDA events (the plain versions: seconds a
    call at these shapes)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def path_run(dev, name, cfg, scene, times, runs=3):
    """run_pair on a scene `runs` times, seed 0: the `dis` digest, each
    run's ms, the peak device memory and the launches of the first run
    (utils.profiling.launch_counts(), reset just before it); returns the
    digest and those launches."""
    import torch

    from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair
    from crossscalepatchmatch_tpu_torch.utils.profiling import (
        launch_counts, reset_launch_counts)

    _, l, r = scene
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(runs):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_pair(l, r, 0, cfg, device=dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = {k: n for k, n in launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    digest = hashlib.sha256(out["dis"].cpu().numpy().tobytes()).hexdigest()[
        :16]
    times[f"{name} ms/pair"] = ms
    times[f"{name} peak MiB"] = peak
    print(f"{name}: seed 0 dis digest {digest}, ms/pair {ms}, peak "
          f"{peak:.1f} MiB, launches a pair {launches}", flush=True)
    return digest, launches


def time_cases(ctx, reps, plain=False):
    """Time every case of CASES (and with `plain` its plain version once)
    and print a line each; returns {kernel key: [record, ...]}, a record
    the case's name, ms, bound_ms, bound_by and, where measured,
    device_ms and plain_ms."""
    import torch

    from crossscalepatchmatch_tpu_torch.utils.roofline import bound

    recs = {}
    for key, makers in CASES.items():
        for make in makers:
            for case in make(ctx):
                t = time_turns({"k": case.fn}, {"k": reps})["k"]
                b_ms, b_by = bound(*case.work)
                rec = dict(name=case.name, ms=t, bound_ms=b_ms, bound_by=b_by)
                line = (f"[{key}] {case.name}: {t:.3f} ms | bound "
                        f"{b_ms:.4f} ms ({b_by}), {b_ms / t:.1%} of it")
                if case.device:
                    rec["device_ms"] = d_ms = queued_ms(case.fn, reps)
                    line += (f" | on the device {d_ms:.4f} ms, "
                             f"{b_ms / d_ms:.1%} of it")
                for what, work in case.beside.items():
                    x_ms, x_by = bound(*work)
                    line += f" | {what} {x_ms:.4f} ms ({x_by})"
                if plain and case.plain is not None:
                    rec["plain_ms"] = p_ms = timed_once(case.plain)
                    line += f" | plain {p_ms:.1f} ms"
                recs.setdefault(key, []).append(rec)
                print(line, flush=True)
            torch.cuda.empty_cache()
    return recs


def card_name():
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_kernels():
    """Build and load the port's kernels; seconds taken."""
    from crossscalepatchmatch_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    return build_s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import and time")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.parent:
        me = os.path.abspath(__file__)
        steps = [[sys.executable, me, "--root", args.parent],
                 [sys.executable, me],
                 [sys.executable, me, "--root", args.parent]]
        for cmd in steps:
            cmd += ["--reps", str(args.reps)]
            print("+", " ".join(cmd), flush=True)
            rc = subprocess.run(cmd).returncode
            if rc:
                return rc
        return 0

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from crossscalepatchmatch_tpu_torch import CEN_CS_PP, KITTI, README_DEMO

    dev = torch.device("cuda:0")
    card = card_name()
    print(f"{card} | root {args.root}")
    build_s = build_kernels()
    ctx = Ctx(dev)
    times, digests, launches = {}, {}, {}
    for name, cfg, scene in (("README_DEMO", README_DEMO, ctx.bench),
                             ("CEN_CS_PP", CEN_CS_PP, ctx.bench),
                             ("KITTI", KITTI, ctx.kitti)):
        digests[name], launches[name] = path_run(dev, name, cfg, scene,
                                                 times)
    recs = time_cases(ctx, args.reps)
    for key_recs in recs.values():
        for rec in key_recs:
            times[rec["name"]] = rec["ms"]
            if "device_ms" in rec:
                times[f"{rec['name']} device"] = rec["device_ms"]
    print(json.dumps({
        "card": card, "root": args.root, "build_s": build_s,
        "digests": digests, "launches": launches, "ms": times,
        "bound_ms": {r["name"]: r["bound_ms"]
                     for rs in recs.values() for r in rs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
