"""The traced run: the same closed loop under torch.profiler (device
activity only, so the host pays no per-op recording), reduced to the device
ops of the traced pairs, which the per-layer readers under
stereobench/layers/ read.

The trace is held against the program's own launch counters: for each
hand-written kernel family the profiler has to have recorded as many
launches as the counters went up by.  A trace that dropped events gives no
per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Dict, List, Optional, Tuple

from . import families

LAYERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layers")


@dataclasses.dataclass
class Trace:
    """The device ops of `pairs` traced pairs: (start s, end s, name,
    family) on the device's clock; the host's wall seconds from the first
    traced pair's call to the last one's synchronise (window_s), and the
    same for as many pairs run just before without the profiler
    (untraced_s), which the profiler's own cost does not lengthen."""
    ops: List[Tuple[float, float, str, str]]
    pairs: int
    window_s: float
    untraced_s: float
    engine: dict
    frame: Tuple[int, int]
    warm_iters: Optional[int]     # None for cold pairs (run_pair)
    window: object = None         # the workload.Window of the traced pairs
    complete: bool = True
    mismatches: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def family_s(self, name: str) -> float:
        return sum(b - a for a, b, _, f in self.ops if f == name)

    def count(self, name: str) -> int:
        return sum(f == name for _, _, _, f in self.ops)

    def busy_s(self) -> float:
        """The union of the device ops' intervals."""
        total, end = 0.0, None
        for a, b, _, _ in sorted(self.ops):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total


def short(name: str) -> str:
    """A device op's name without its return type and argument list, cut
    to 160 characters."""
    name = name.strip()
    if name.startswith(("Memcpy", "Memset")):
        return name
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:160]


def record(loop, pairs: int, engine: dict) -> Trace:
    """Run `pairs` pairs of the loop, then `pairs` more under the profiler;
    the Trace.  The traced pairs' maps are kept where the program left
    them, so the harness launches nothing of its own under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    untraced = loop.run(pairs=pairs, maps=None)
    before = families.read_counters()
    loop.sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        win = loop.run(pairs=pairs, maps="device")
        loop.sync()
    after = families.read_counters()
    ops = []
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        ops.append((a, b, ev.name, families.family_of(ev.name)))
    tr = Trace(ops=ops, pairs=len(win.ms), window_s=win.seconds,
               untraced_s=untraced.seconds, engine=engine, frame=(loop.pool.h, loop.pool.w),
               warm_iters=loop.warm_iters if loop.warm else None,
               window=win)
    for f in families.FAMILIES:
        if before[f.name] is None or after[f.name] is None:
            continue
        seen = sum(f.counted in name for _, _, name, _ in ops)
        if seen != after[f.name] - before[f.name]:
            tr.mismatches[f.name] = (seen, after[f.name] - before[f.name])
    tr.complete = bool(ops) and not tr.mismatches
    return tr


def reader(metric: str):
    """The read(trace) function of stereobench/layers/<metric>.py."""
    path = os.path.join(LAYERS, metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "stereobench.layers." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(trace: Trace, metrics: list) -> Dict[str, dict]:
    """Each per-layer metric that its reader finds in the trace."""
    out = {}
    if not trace.complete:
        return out
    for m in metrics:
        value = reader(m["name"])(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, by kernel, and the device's
    idle time between ops by the op the host launched next."""
    by_op: Dict[str, float] = {}
    for a, b, name, _ in trace.ops:
        by_op[short(name)] = by_op.get(short(name), 0.0) + (b - a)
    gaps: Dict[str, float] = {}
    end = None
    for a, b, name, _ in sorted(trace.ops):
        if end is not None and a > end:
            key = "before " + short(name)
            gaps[key] = gaps.get(key, 0.0) + (a - end)
        end = b if end is None else max(end, b)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(gaps)}
