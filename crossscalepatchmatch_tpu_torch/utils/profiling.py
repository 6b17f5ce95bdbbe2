"""Profiling and observability (the port's crossscalepatchmatch_tpu
utils/profiling.py, on torch).

The reference's only instrumentation is getTickCount around the whole run
and cout progress lines (main.cc:92,122-125).  Here:

  * PhaseTimer: named per-phase wall timers that wait for the card at a
    phase's end, printable as a table and exportable as a dict (for JSON
    metric lines);
  * trace(): a torch.profiler trace of a block, written as Chrome trace
    JSON;
  * throughput(): the stereo pairs/s/card metric of a timed run;
  * run_pair_phases() / profile_pair(): one pair (or warm frame) run
    phase by phase, under torch.profiler, and its per-phase summary (host
    and device ms, launches, the device's idle share and where the host
    held it idle, device time per kernel), which bench_torch.py and
    tools/torch_profile_pair.py print;
  * reset_launch_counts() / launch_counts(): the kernels' and plain
    versions' launch counters (chip_smoke.py, bench_scaling_torch.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def _last_cuda_device(obj) -> Optional[torch.device]:
    """The device of the last CUDA tensor in obj, walking dicts, lists and
    tuples as jax.block_until_ready walks a pytree; None if it holds none."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for item in reversed(obj):
            dev = _last_cuda_device(item)
            if dev is not None:
                return dev
    return None


class PhaseTimer:
    """Accumulating named wall-clock phase timers.

    Each phase() waits at its exit for the card's work, so times are of
    execution, not of enqueueing.  Use one instance per run:

        t = PhaseTimer()
        with t.phase("volumes") as held:
            held.append(build_volume_data(...))
        with t.phase("optimize") as held:
            held.append(run_pair(...))
        print(t.report())

    At exit, with sync: the device of the last CUDA tensor in the last
    object put in the holder is synchronised; with an empty holder the
    current CUDA device, if CUDA is initialised (every stream of it: the
    counterpart of jax.effects_barrier).  CPU work needs no wait.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        result_holder = []
        try:
            yield result_holder
        finally:
            if sync:
                if result_holder:
                    dev = _last_cuda_device(result_holder[-1])
                    if dev is not None:
                        torch.cuda.synchronize(dev)
                elif torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.seconds.values()) or 1.0
        lines = [f"{'phase':<20} {'calls':>5} {'sec':>9} {'%':>6}"]
        for name, sec in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<20} {self.counts[name]:>5} {sec:>9.3f} "
                         f"{100.0 * sec / total:>5.1f}%")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU activity, and the card's
    when CUDA is available), written to log_dir/trace.json; a no-op when
    log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput(pairs: int, seconds: float,
               n_chips: Optional[int] = None) -> Dict[str, float]:
    """Stereo pairs/s (/card) metric dict for JSON metric lines; n_chips
    defaults to the visible CUDA devices, 1 without CUDA."""
    n = n_chips if n_chips is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)
    pps = pairs / seconds if seconds > 0 else 0.0
    return {"pairs_per_s": pps, "pairs_per_s_per_chip": pps / max(n, 1),
            "n_chips": n}


# run_pair's phases, in order: the volume build (without a volume, the
# channel planes' build), the cost functions (the K2 build on the volume
# path), the rank phase (the init only without a rank phase), the exact
# phase (a warm frame's iterations: warm_phase), planes to disparity and
# the post-processing
PHASES = ("volume_build", "fly_data", "quadrant_build_K2", "rank_phase",
          "exact_phase", "warm_phase", "plane_to_disp", "postprocess")


def run_pair_phases(l_bgr_u8, r_bgr_u8, seed: int, cfg, *, device="cuda",
                    prior_abc=None, warm_iters: int = 1, phase=None):
    """models.pipeline.run_pair, or with prior_abc run_pair_warm, split into
    the named PHASES, each run as phase(name, fn) (fn() when phase is
    None); returns run_pair's dict, equal to the unsplit call's."""
    from ..models import patchmatch as pm
    from ..models.pipeline import _on_device
    from ..models.postprocess import postprocess
    from ..ops.cost_volume import build_volume_data
    from ..ops.onthefly_cost import build_fly_data
    from .rng import PHASE_WARM, TorchDraws

    run = phase or (lambda name, fn: fn())
    device, l, r = _on_device(l_bgr_u8, r_bgr_u8, cfg, device)
    hw = tuple(l.shape[:2])
    if cfg.precompute_volume:
        vd = run("volume_build", lambda: build_volume_data(l, r, cfg))
        cost_fn, sparse_fn = run("quadrant_build_K2",
                                 lambda: pm.make_cost_fns(cfg, vd))
        pp_imgs = vd.imgs[0]
    else:
        fd = run("fly_data", lambda: build_fly_data(l, r, cfg))
        cost_fn, sparse_fn = pm.make_fly_cost_fns(cfg, fd)
        pp_imgs = fd.imgs[0]
    if prior_abc is None:
        draws = TorchDraws(seed, device)
        n_rank = cfg.rank_iters if sparse_fn is not None else 0
        st = run("rank_phase", lambda: pm.patchmatch(
            draws, hw, cost_fn, cfg, sparse_fn, device=device, stop=n_rank))
        st = run("exact_phase", lambda: pm.patchmatch(
            draws, hw, cost_fn, cfg, sparse_fn, device=device,
            start=(st, n_rank)))
    else:
        draws = TorchDraws(seed, device, refine_phase=PHASE_WARM)

        def warm():
            abc = torch.as_tensor(prior_abc).to(device=device,
                                                dtype=torch.float32)
            if cfg.prop_sweeps > 0 and warm_iters > 0:
                cost = torch.full(abc.shape[:-1], float("inf"),
                                  device=device)
            else:
                cost = cost_fn(abc[:, None])[:, 0]
            return pm.iterate(pm.PMState(abc=abc, cost=cost), 0, warm_iters,
                              draws, cost_fn, cfg, sparse_fn)

        st = run("warm_phase", warm)
    dis = run("plane_to_disp", lambda: pm.plane_to_disp(st.abc,
                                                        cfg.dis_scale))
    if cfg.use_pp:
        dis, valid = run("postprocess",
                         lambda: postprocess(dis, st.abc, pp_imgs, cfg))
    else:
        valid = torch.ones((2, *hw), dtype=torch.bool, device=device)
    return {"dis": dis, "abc": st.abc, "cost": st.cost, "valid": valid}


def reset_launch_counts() -> None:
    """Every kernel's and plain version's launch counter to 0."""
    from ..models import postprocess
    from ..ops import (census, grad_cost, onthefly_cost, plane_cost,
                       prescreen_volume)
    from ..ops.cuda import (census_volume, cross_scale_cost, fly_cost,
                            grd_volume, quadrant_build, quadrant_rank,
                            weighted_median, window_cost)

    window_cost.launches = window_cost.strided_launches = 0
    quadrant_build.launches = cross_scale_cost.launches = 0
    fly_cost.launches.clear()
    weighted_median.launches = postprocess.plain_launches = 0
    grd_volume.launches = quadrant_rank.launches = 0
    plane_cost.launches = prescreen_volume.launches = 0
    plane_cost.cross_scale_launches = onthefly_cost.launches = 0
    grad_cost.launches = prescreen_volume.rank_launches = 0
    census_volume.launches = census.launches = 0


def launch_counts() -> Dict[str, int]:
    """The launch counters, by kernel (plain versions: *_plain)."""
    from ..models import postprocess
    from ..ops import (census, grad_cost, onthefly_cost, plane_cost,
                       prescreen_volume)
    from ..ops.cuda import (census_volume, cross_scale_cost, fly_cost,
                            grd_volume, quadrant_build, quadrant_rank,
                            weighted_median, window_cost)

    return {"k1": window_cost.launches - window_cost.strided_launches,
            "k3_volume": window_cost.strided_launches,
            "k2": quadrant_build.launches,
            "k4": cross_scale_cost.launches,
            "k3_fly": fly_cost.count(strided=True),
            "k5": fly_cost.count(lerp="cost"),
            "k6": fly_cost.count(lerp="image"),
            "k7": fly_cost.count(lab=True),
            "fly": fly_cost.count(),
            "wmf": weighted_median.launches,
            "grdv": grd_volume.launches,
            "qrank": quadrant_rank.launches,
            "cenv": census_volume.launches,
            "k1_plain": plane_cost.launches,
            "k2_plain": prescreen_volume.launches,
            "k4_plain": plane_cost.cross_scale_launches,
            "fly_plain": onthefly_cost.launches,
            "wmf_plain": postprocess.plain_launches,
            "grdv_plain": grad_cost.launches,
            "qrank_plain": prescreen_volume.rank_launches,
            "cenv_plain": census.launches}


def busy_union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_family(name: str, cfg) -> str:
    """The port's kernel a device op is (K1 / K4: the window-cost kernel at
    one level or over the pyramid; K2; fly: the no-volume kernel, K5 / K3;
    WMF: the weighted median and its two preparation kernels; GRDV: the
    GRD cost volume; QRANK: the quadrant ranking; CENV: the census codes
    and volume), "other" for PyTorch's own ops."""
    if "cross_scale_kernel" in name:
        return "K4" if cfg.use_cs else "K1"
    if "quadrant_build_kernel" in name:
        return "K2"
    if "fly_cost_kernel" in name:
        return "fly"
    if any(k in name for k in ("weighted_median_kernel",
                               "wmf_pack_count_kernel",
                               "wmf_compact_kernel")):
        return "WMF"
    if "grd_volume_kernel" in name:
        return "GRDV"
    if "quadrant_rank_kernel" in name:
        return "QRANK"
    if "census_codes_kernel" in name or "census_volume_kernel" in name:
        return "CENV"
    return "other"


def profile_pair(l_bgr_u8, r_bgr_u8, seed: int, cfg, *, device="cuda",
                 prior_abc=None, warm_iters: int = 1, top: int = 10):
    """run_pair_phases under torch.profiler, a synchronise at each phase's
    end (so a phase's kernels run inside its host range).

    Returns (run_pair's dict, summary, the profiler).  The summary: the
    pair's host wall ms; per phase its host ms, device busy ms and kernel
    launches; and on a CUDA device the device's kernel ms, busy ms (the
    union of kernel intervals), idle share (1 - busy / wall), kernel ms and
    launches per kernel_family, the `top` device ops by time (names cut
    to 120 characters), the idle ms by the phase the host was in, and the
    `top` longest idle gaps.  On another device there is no profiler
    (None): the phases are timed on the host clock and every device entry
    is None (not measured).
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device(device)
    if dev.type != "cuda":
        timer = PhaseTimer()

        def timed(name, fn):
            with timer.phase(name, sync=False):
                return fn()

        t0 = time.perf_counter()
        out = run_pair_phases(l_bgr_u8, r_bgr_u8, seed, cfg, device=dev,
                              prior_abc=prior_abc, warm_iters=warm_iters,
                              phase=timed)
        wall_ms = (time.perf_counter() - t0) * 1e3
        phases = [dict(name=n, host_ms=sec * 1e3, device_ms=None,
                       launches=None) for n, sec in timer.seconds.items()]
        return out, _summary(wall_ms, phases), None

    def phase(name, fn):
        with record_function(name):
            out = fn()
            torch.cuda.synchronize(dev)
        return out

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_pair_phases(l_bgr_u8, r_bgr_u8, seed, cfg, device=dev,
                              prior_abc=prior_abc, warm_iters=warm_iters,
                              phase=phase)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, summarize(prof.events(), wall_ms, cfg, top), prof


def _summary(wall_ms: float, phases: List[dict], **device) -> dict:
    keys = ("device_ms", "busy_ms", "idle_share", "launches", "kernels",
            "top_ops", "idle_by_phase", "idle_gaps")
    return dict(wall_ms=wall_ms, phases=phases,
                **{k: device.get(k) for k in keys})


def summarize(events, wall_ms: float, cfg, top: int = 10) -> dict:
    """profile_pair's summary of a CUDA run's profiler events (times in
    ms)."""
    ranges = sorted((e for e in events if e.name in PHASES
                     and e.device_type.name == "CPU"),
                    key=lambda e: e.time_range.start)
    # the phase ranges also appear on the device timeline as annotations;
    # they are not kernels
    kernels = [(e.time_range.start, e.time_range.end, e.name)
               for e in events
               if e.device_type.name == "CUDA" and e.name not in PHASES]
    phases = []
    for i, rg in enumerate(ranges):
        s = rg.time_range.start
        nxt = (ranges[i + 1].time_range.start if i + 1 < len(ranges)
               else float("inf"))
        inside = [(a, b) for a, b, _ in kernels if s <= a < nxt]
        phases.append(dict(
            name=rg.name, host_ms=(rg.time_range.end - s) / 1e3,
            device_ms=busy_union(inside) / 1e3, launches=len(inside)))
    busy_us = busy_union([(a, b) for a, b, _ in kernels])
    families: Dict[str, dict] = {}
    ops: Dict[str, dict] = {}
    for a, b, name in kernels:
        for table, key in ((families, kernel_family(name, cfg)),
                           (ops, name)):
            row = table.setdefault(key, {"ms": 0.0, "launches": 0})
            row["ms"] += (b - a) / 1e3
            row["launches"] += 1
    gaps = idle_gaps(kernels, ranges)
    by_phase: Dict[str, float] = {}
    for g in gaps:
        by_phase[g["phase"]] = by_phase.get(g["phase"], 0.0) + g["ms"]
    return _summary(
        wall_ms, phases, device_ms=sum(b - a for a, b, _ in kernels) / 1e3,
        busy_ms=busy_us / 1e3, idle_share=1 - busy_us / 1e3 / wall_ms,
        launches=len(kernels), kernels=families,
        top_ops=[dict(name=n[:120], **v) for n, v in sorted(
            ops.items(), key=lambda kv: -kv[1]["ms"])[:top]],
        idle_by_phase=by_phase,
        idle_gaps=sorted(gaps, key=lambda g: -g["ms"])[:top])


def idle_gaps(kernels, ranges) -> List[dict]:
    """The device's idle gaps between the first phase's start and the last
    phase's end (profiler times, us): each with its ms, its start in ms
    from the first phase's start, and the phase the host was in at its
    middle."""
    if not ranges:
        return []
    t0 = ranges[0].time_range.start
    t1 = max(rg.time_range.end for rg in ranges)
    gaps, end = [], t0
    for a, b, _ in sorted(kernels) + [(t1, t1, "")]:
        if a > end:
            mid = (end + a) / 2
            host = [rg.name for rg in ranges
                    if rg.time_range.start <= mid < rg.time_range.end]
            gaps.append(dict(ms=(a - end) / 1e3, at_ms=(end - t0) / 1e3,
                             phase=host[0] if host else "between phases"))
        end = max(end, b)
    return gaps


def format_profile(summary: dict) -> List[str]:
    """profile_pair's summary as printable lines."""
    s = summary
    if s["device_ms"] is None:
        lines = [f"profiled pair: wall {s['wall_ms']:.1f} ms (device time "
                 "not measured: no CUDA device)"]
    else:
        lines = [f"profiled pair: wall {s['wall_ms']:.1f} ms, device kernel "
                 f"time {s['device_ms']:.1f} ms, device busy "
                 f"{s['busy_ms']:.1f} ms, idle share {s['idle_share']:.3f}, "
                 f"{s['launches']} kernel launches"]
        if not s["launches"]:
            lines.append("the profiler recorded no device kernels")
    for p in s["phases"]:
        dev = ("" if p["device_ms"] is None else
               f", device busy {p['device_ms']:.1f} ms, {p['launches']} "
               "kernel launches")
        lines.append(f"phase {p['name']}: host {p['host_ms']:.1f} ms{dev}")
    if s["device_ms"] is None:
        return lines
    lines.append("device ms / launches by kernel: " + ", ".join(
        f"{k} {v['ms']:.1f} / {v['launches']}"
        for k, v in sorted(s["kernels"].items())))
    lines.append("idle ms by host phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(s["idle_by_phase"].items(),
                                          key=lambda kv: -kv[1])))
    lines.append("longest idle gaps: " + ", ".join(
        f"{g['ms']:.2f} ms at {g['at_ms']:.1f} ({g['phase']})"
        for g in s["idle_gaps"]))
    lines.append("top device ops:")
    lines += [f"  {o['ms']:8.2f} ms {o['launches']:6d}x  {o['name']}"
              for o in s["top_ops"]]
    return lines
