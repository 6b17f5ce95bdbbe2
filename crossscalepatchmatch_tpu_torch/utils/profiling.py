"""Profiling and observability (the port's crossscalepatchmatch_tpu
utils/profiling.py, on torch).

The reference's only instrumentation is getTickCount around the whole run
and cout progress lines (main.cc:92,122-125).  Here, on the spans the
pipeline records (utils/spans):

  * trace(): a torch.profiler trace of a block, written as Chrome trace
    JSON with the block's spans as a track of their own;
  * device_ops(): the device ops of a torch.profiler profile, each with
    the host time of its launch; owners(): the innermost span open at
    each launch; span_table(), idle_gaps() and layer_metrics(): host and
    device time by span, the device's idle gaps by the span the host was
    in, and the per-layer readings (draws.host_ms, optimizer.host_ms,
    volume_build.device_ms, postprocess.device_ms); fused_share(): the
    share of refinement stages that kernel RPROP proposed;
  * profile_pair(): one run_pair (or run_pair_warm) call recorded, under
    torch.profiler on a card, and its per-phase summary (host and device
    ms, launches, the device's idle share and where the host held it
    idle, device time per kernel), which tools/torch_profile_pair.py
    prints;
  * reset_launch_counts() / launch_counts(): the kernels' and plain
    versions' launch counters (the GPU tier, bench_scaling_torch.py).
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import spans as span_rec

# a device op: (start ns, end ns, name, launch ns or None): the launch on
# the spans' clock (utils/spans), start and end on the device's as the
# profiler maps it (device_ops)
Op = Tuple[int, int, str, Optional[int]]

# run_pair's phases, in order, each a span directly under the pair's:
# the volume build (without a volume, the channel planes' build), the cost
# functions (the K2 build on the volume path), the rank phase (the init
# only without a rank phase), the exact phase (a warm frame's iterations:
# warm_phase), planes to disparity and the post-processing
PHASES = ("volume_build", "fly_data", "quadrant_build_K2", "rank_phase",
          "exact_phase", "warm_phase", "plane_to_disp", "postprocess")
# the spans whose self time is the optimizer's launch stream
OPTIMIZER_SPANS = ("iteration", "sweep", "view", "refine")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU activity, and the card's
    when CUDA is available), written to log_dir/trace.json with the
    block's spans; a no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, span_rec.recording() as rec:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    export_chrome_trace(prof, rec, os.path.join(log_dir, "trace.json"))


def export_chrome_trace(prof, spans: Sequence[span_rec.Span],
                        path: str) -> None:
    """prof's Chrome trace written to path (gzipped where it ends in .gz)
    with the spans added as a process of their own, "spans", on the
    trace's time base, so a viewer shows each span above the kernels
    launched inside it."""
    prof.export_chrome_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = doc.get("baseTimeNanoseconds", 0)
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "spans"}})
    for sp in spans:
        events.append({"ph": "X", "cat": "span", "name": sp.name,
                       "pid": pid, "tid": 0,
                       "ts": (sp.start_ns - base) / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3,
                       "args": {"seq": sp.seq, **sp.attrs}})
    with opener(path, "wt") as f:
        json.dump(doc, f)


def device_ops(prof) -> List[Op]:
    """The device ops (kernels, copies, fills) a torch.profiler profile
    recorded, in its order, each (start ns, end ns, name, launch ns).
    launch is the start of the runtime call (cudaLaunchKernel,
    cudaMemcpyAsync, ...) that carries the op's correlation id, None where
    the profile has none: on the host's Unix-epoch clock, the spans'.  The
    start and end are on the device's clock as the profiler maps it to the
    host's, good for lengths and order only (idle_gaps)."""
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type().name == "CPU"
                and e.name().startswith("cu")}
    return [(e.start_ns(), e.end_ns(), e.name(),
             launches.get(e.correlation_id()))
            for e in events if e.device_type().name == "CUDA"]


def owners(times: Sequence[Optional[int]],
           spans: Sequence[span_rec.Span]) -> List[Optional[int]]:
    """For each time (ns, or None), the index of the innermost span open
    at it (a span holds [start, end)); None where no span is."""
    bounds = sorted(
        [(sp.start_ns, 1, i) for i, sp in enumerate(spans)
         if sp.end_ns > sp.start_ns]
        + [(sp.end_ns, 0, i) for i, sp in enumerate(spans)
           if sp.end_ns > sp.start_ns])
    out: List[Optional[int]] = [None] * len(times)
    open_: List[int] = []
    j = 0
    for n in sorted((n for n, t in enumerate(times) if t is not None),
                    key=times.__getitem__):
        while j < len(bounds) and bounds[j][0] <= times[n]:
            _, starts, i = bounds[j]
            if starts:
                open_.append(i)
            else:
                open_.remove(i)
            j += 1
        out[n] = open_[-1] if open_ else None
    return out


def span_paths(spans: Sequence[span_rec.Span]) -> List[str]:
    """Each span's path of names from below its pair span, such as
    "exact_phase/iteration/refine/draws" ("pair" for the pair span; a
    root of another name starts its path)."""
    paths: List[str] = []
    for sp in spans:
        up = sp.parent
        if up < 0 or (spans[up].parent < 0 and spans[up].name == "pair"):
            paths.append(sp.name)
        else:
            paths.append(paths[up] + "/" + sp.name)
    return paths


def _ancestors(spans, i: int):
    while i >= 0:
        yield i
        i = spans[i].parent


def span_table(host_spans: Sequence[span_rec.Span], pairs: int,
               spans: Sequence[span_rec.Span] | None = None,
               ops: Sequence[Op] | None = None,
               owner: Sequence[Optional[int]] | None = None) -> Dict[str,
                                                                     dict]:
    """Per span name, per pair: count, host ms and self ms (the part its
    children do not cover) of host_spans, a recording of `pairs` pairs;
    with a profiled recording (spans, its ops and their owners), device
    ms and launches of the ops launched inside a span of that name (its
    children's included), else None."""
    rows: Dict[str, dict] = {}

    def row(name):
        return rows.setdefault(name, dict(count=0, host_ms=0.0,
                                          self_ms=0.0, device_ms=None,
                                          launches=None))

    for sp in host_spans:
        r = row(sp.name)
        r["count"] += 1
        r["host_ms"] += sp.ms
        r["self_ms"] += sp.ms
        if sp.parent >= 0:
            row(host_spans[sp.parent].name)["self_ms"] -= sp.ms
    if ops is not None:
        for sp in spans:
            r = row(sp.name)
            r["device_ms"], r["launches"] = 0.0, 0
        for (a, b, _, _), o in zip(ops, owner):
            if o is None:
                continue
            for name in {spans[i].name for i in _ancestors(spans, o)}:
                rows[name]["device_ms"] += (b - a) * 1e-6
                rows[name]["launches"] += 1
    for r in rows.values():
        for k in ("count", "host_ms", "self_ms", "device_ms", "launches"):
            if r[k] is not None:
                r[k] /= pairs
    return rows


def idle_gaps(ops: Sequence[Op], spans: Sequence[span_rec.Span],
              paths: Sequence[str] | None = None) -> List[dict]:
    """The device's idle gaps inside the root spans' window (the first
    root's start to the last root's end), on the host's clock: a gap ends
    when an op starts on an idle device, which is when the host launched
    it, so a gap of length L that ends at an op launched at t is the host's
    [t - L, t] (from the window's start for the first op).  Each gap: its
    ms, its start in ms from the window's start, and the path (span_paths)
    of the innermost span open at its middle, "between pairs" where none
    is.  Ops without a launch end no gap, nor does the window's end.

    The device's own clock gives only the lengths: the profiler maps it
    onto the host's with an error that reached ms and drifted by hundreds
    of ppm on the H100 host, while the launches share the spans' clock.
    """
    roots = [sp for sp in spans if sp.parent < 0]
    if not roots:
        return []
    paths = paths or span_paths(spans)
    t0 = min(sp.start_ns for sp in roots)
    t1 = max(sp.end_ns for sp in roots)
    gaps, end = [], None
    for a, b, _, t in sorted(ops):
        if t is not None and t0 <= t <= t1:
            length = t - t0 if end is None else a - end
            if length > 0:
                gaps.append((max(t - length, t0), t))
        end = b if end is None else max(end, b)
    own = owners([(a + b) // 2 for a, b in gaps], spans)
    return [dict(ms=(b - a) * 1e-6, at_ms=(a - t0) * 1e-6,
                 span="between pairs" if o is None else paths[o])
            for (a, b), o in zip(gaps, own)]


def layer_metrics(table: Dict[str, dict]) -> Dict[str, Optional[float]]:
    """The per-layer readings of a span_table, ms a pair; None where the
    spans they read are missing (device readings: where the table has no
    device times).

      draws.host_ms: host ms inside the draws spans (utils/rng);
      optimizer.host_ms: self ms of the iteration, sweep, view and refine
        spans (models/patchmatch's launch stream, without the draws);
      volume_build.device_ms, postprocess.device_ms: device ms of the ops
        launched inside the volume_build (ops/cost_volume) and postprocess
        (models/postprocess) spans.
    """
    def get(name, key):
        return table[name][key] if name in table else None

    opt = [table[n]["self_ms"] for n in OPTIMIZER_SPANS if n in table]
    return {"draws.host_ms": get("draws", "host_ms"),
            "optimizer.host_ms": sum(opt) if opt else None,
            "volume_build.device_ms": get("volume_build", "device_ms"),
            "postprocess.device_ms": get("postprocess", "device_ms")}


def fused_share(spans: Sequence[span_rec.Span]) -> Optional[float]:
    """The share of the recording's refine spans whose stage kernel RPROP
    proposed (their `fused` attribute); None without refine spans."""
    refine = [sp for sp in spans if sp.name == "refine"]
    if not refine:
        return None
    return sum(bool(sp.attrs.get("fused")) for sp in refine) / len(refine)


def reset_launch_counts() -> None:
    """Every kernel's and plain version's launch counter to 0."""
    from ..models import postprocess
    from ..ops import (census, grad_cost, onthefly_cost, plane_cost,
                       prescreen_volume)
    from ..ops.cuda import (bilateral_volume, census_volume,
                            cross_scale_cost, fly_cost, grd_volume,
                            quadrant_build, quadrant_rank, refine_propose,
                            weighted_median, window_cost)

    window_cost.launches = window_cost.strided_launches = 0
    quadrant_build.launches = cross_scale_cost.launches = 0
    fly_cost.launches.clear()
    fly_cost.shared_launches.clear()
    weighted_median.launches = postprocess.plain_launches = 0
    grd_volume.launches = quadrant_rank.launches = 0
    plane_cost.launches = prescreen_volume.launches = 0
    plane_cost.cross_scale_launches = onthefly_cost.launches = 0
    grad_cost.launches = prescreen_volume.rank_launches = 0
    census_volume.launches = census.launches = 0
    refine_propose.launches = 0
    bilateral_volume.launches = bilateral_volume.plain_launches = 0


def launch_counts() -> Dict[str, int]:
    """The launch counters, by kernel (plain versions: *_plain)."""
    from ..models import postprocess
    from ..ops import (census, grad_cost, onthefly_cost, plane_cost,
                       prescreen_volume)
    from ..ops.cuda import (bilateral_volume, census_volume,
                            cross_scale_cost, fly_cost, grd_volume,
                            quadrant_build, quadrant_rank, refine_propose,
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
            "rprop": refine_propose.launches,
            "bfv": bilateral_volume.launches,
            "k1_plain": plane_cost.launches,
            "k2_plain": prescreen_volume.launches,
            "k4_plain": plane_cost.cross_scale_launches,
            "fly_plain": onthefly_cost.launches,
            "wmf_plain": postprocess.plain_launches,
            "grdv_plain": grad_cost.launches,
            "qrank_plain": prescreen_volume.rank_launches,
            "cenv_plain": census.launches,
            "bfv_plain": bilateral_volume.plain_launches}


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
    and volume; RPROP: a refinement stage's proposal; BFV: the bilateral
    volume filter), "other" for PyTorch's own ops."""
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
    if "refine_propose_kernel" in name:
        return "RPROP"
    if "bilateral_volume_kernel" in name:
        return "BFV"
    return "other"


def profile_pair(l_bgr_u8, r_bgr_u8, seed: int, cfg, *, device="cuda",
                 prior_abc=None, warm_iters: int = 1, top: int = 10):
    """models.pipeline.run_pair (with prior_abc run_pair_warm) recorded
    (utils/spans), under torch.profiler's device activity on a CUDA
    device; nothing synchronises inside the pair.

    Returns (run_pair's dict, summary, the profiler).  The summary (see
    summarize): the pair's host wall ms; per phase its host ms, device busy
    ms and launches; host, self and device ms by span; and on a CUDA
    device the device's kernel ms, busy ms (the union of kernel
    intervals), idle share (1 - busy / wall), kernel ms and launches per
    kernel_family, the `top` device ops by time, the idle ms by the phase
    the host was in, and the `top` longest idle gaps with the span the
    host was in.  On another device there is no profiler (None): every
    device entry is None (not measured).
    """
    from torch.profiler import ProfilerActivity, profile

    from ..models.pipeline import run_pair, run_pair_warm

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    prof = None
    with contextlib.ExitStack() as stack:
        if on_card:
            torch.cuda.synchronize(dev)
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
        rec = stack.enter_context(span_rec.recording())
        t0 = time.perf_counter()
        if prior_abc is None:
            out = run_pair(l_bgr_u8, r_bgr_u8, seed, cfg, device=dev)
        else:
            out = run_pair_warm(l_bgr_u8, r_bgr_u8, seed, prior_abc, cfg,
                                warm_iters, device=dev)
        if on_card:
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = device_ops(prof) if prof is not None else None
    return out, summarize(rec, ops, wall_ms, cfg, top), prof


def summarize(spans: Sequence[span_rec.Span], ops: Sequence[Op] | None,
              wall_ms: float, cfg, top: int = 10) -> dict:
    """profile_pair's summary of one recorded pair: its spans and, from a
    profile, its device ops (device_ops; None without one).  Phases are
    the PHASES spans right under the pair's; an op belongs to the span
    open at its launch."""
    paths = span_paths(spans)
    # each span's phase: the PHASES span it is, or lies under
    phase_of: List[Optional[int]] = []
    for i, sp in enumerate(spans):
        if sp.name in PHASES and "/" not in paths[i]:
            phase_of.append(i)
        else:
            phase_of.append(phase_of[sp.parent] if sp.parent >= 0
                            else None)
    phase_idx = [i for i, p in enumerate(phase_of) if p == i]
    owner = (owners([op[3] for op in ops], spans) if ops is not None
             else None)
    table = span_table(spans, 1, spans, ops, owner)
    phases = []
    for i in phase_idx:
        p = dict(name=spans[i].name, host_ms=spans[i].ms, device_ms=None,
                 launches=None)
        if ops is not None:
            inside = [(a, b) for (a, b, _, _), o in zip(ops, owner)
                      if o is not None and phase_of[o] == i]
            p.update(device_ms=busy_union(inside) * 1e-6,
                     launches=len(inside))
        phases.append(p)
    s = dict(wall_ms=wall_ms, phases=phases, spans=table,
             layers=layer_metrics(table), fused_share=fused_share(spans),
             device_ms=None, busy_ms=None,
             idle_share=None, launches=None, joined=None, kernels=None,
             top_ops=None, idle_by_phase=None, idle_gaps=None)
    if ops is None:
        return s
    busy_ms = busy_union([(a, b) for a, b, _, _ in ops]) * 1e-6
    families: Dict[str, dict] = {}
    by_op: Dict[str, dict] = {}
    for a, b, name, _ in ops:
        for rows, key in ((families, kernel_family(name, cfg)),
                          (by_op, name)):
            r = rows.setdefault(key, {"ms": 0.0, "launches": 0})
            r["ms"] += (b - a) * 1e-6
            r["launches"] += 1
    gaps = idle_gaps(ops, spans, paths)
    by_phase: Dict[str, float] = {}
    for g in gaps:
        head = g["span"].split("/")[0]
        key = (head if head in PHASES
               else "between phases" if head == "pair" else g["span"])
        by_phase[key] = by_phase.get(key, 0.0) + g["ms"]
    s.update(
        device_ms=sum(b - a for a, b, _, _ in ops) * 1e-6, busy_ms=busy_ms,
        idle_share=1 - busy_ms / wall_ms, launches=len(ops),
        joined=(sum(o is not None for o in owner) / len(ops) if ops
                else None),
        kernels=families,
        top_ops=[dict(name=n[:120], **v) for n, v in sorted(
            by_op.items(), key=lambda kv: -kv[1]["ms"])[:top]],
        idle_by_phase=by_phase,
        idle_gaps=sorted(gaps, key=lambda g: -g["ms"])[:top])
    return s


def _num(v, fmt: str = ".2f") -> str:
    return "not measured" if v is None else format(v, fmt)


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
                 f"{s['launches']} kernel launches, "
                 f"{100 * s['joined']:.1f} % joined to a span"
                 if s["launches"] else
                 "the profiler recorded no device kernels"]
    for p in s["phases"]:
        dev = ("" if p["device_ms"] is None else
               f", device busy {p['device_ms']:.1f} ms, {p['launches']} "
               "kernel launches")
        lines.append(f"phase {p['name']}: host {p['host_ms']:.1f} ms{dev}")
    lines.append("by span (count, host ms, self ms, device ms, launches): "
                 + ", ".join(
                     f"{k} {v['count']:g} / {v['host_ms']:.2f} / "
                     f"{v['self_ms']:.2f} / {_num(v['device_ms'])} / "
                     f"{_num(v['launches'], 'g')}"
                     for k, v in s["spans"].items()))
    lines.append("layers: " + ", ".join(
        f"{k} {_num(v)}" for k, v in s["layers"].items())
        + f"; refinement stages fused {_num(s['fused_share'])}")
    if s["device_ms"] is None:
        return lines
    lines.append("device ms / launches by kernel: " + ", ".join(
        f"{k} {v['ms']:.1f} / {v['launches']}"
        for k, v in sorted(s["kernels"].items())))
    lines.append("idle ms by host phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(s["idle_by_phase"].items(),
                                          key=lambda kv: -kv[1])))
    lines.append("longest idle gaps: " + ", ".join(
        f"{g['ms']:.2f} ms at {g['at_ms']:.1f} ({g['span']})"
        for g in s["idle_gaps"]))
    lines.append("top device ops:")
    lines += [f"  {o['ms']:8.2f} ms {o['launches']:6d}x  {o['name']}"
              for o in s["top_ops"]]
    return lines
