"""Profiling and observability (the port's crossscalepatchmatch_tpu
utils/profiling.py, on torch).

The reference's only instrumentation is getTickCount around the whole run
and cout progress lines (main.cc:92,122-125).  Here:

  * PhaseTimer: named per-phase wall timers that wait for the card at a
    phase's end, printable as a table and exportable as a dict (for JSON
    metric lines);
  * trace(): a torch.profiler trace of a block, written as Chrome trace
    JSON;
  * throughput(): the stereo pairs/s/card metric of a timed run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

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
