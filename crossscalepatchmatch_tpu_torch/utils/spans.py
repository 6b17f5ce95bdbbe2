"""Spans: where a pair's host time goes, layer by layer.

The pipeline opens a span at each layer boundary of a pair (models/pipeline,
models/patchmatch, models/postprocess, utils/rng):

    pair (entry=run_pair|run_pair_warm)
    ├─ volume_build | fly_data (lerp: the data term, "cost" or "image";
    │                           levels)
    │  └─ aggregate (filter, level, slices: one a level with an
    │                aggregation filter)
    ├─ quadrant_build_K2
    ├─ rank_phase | exact_phase | warm_phase
    │  ├─ init
    │  │  └─ draws
    │  └─ iteration (i)
    │     ├─ sweep (s, k)
    │     ├─ view
    │     └─ refine (stage, k, fused)
    │        └─ draws (round, k: a stage's proposal; view, round: one
    │                  draw of a source without its own proposal)
    ├─ plane_to_disp
    └─ postprocess
       └─ lr_check, fill, weighted_median

Recording is off by default: span() then checks one flag and returns a
shared object that does nothing, and allocates nothing.  Inside
`with recording() as spans:` every span that opens is kept, in the order
the spans opened, as a Span: its name, its start and end in ns, the index
in the list of the span it opened inside (-1 for a root), its root's
ordinal (`seq`, shared by every span of one run_pair or run_pair_warm
call, as a request id) and its attributes (small ints and strings from
Python values and shapes).  The list is the caller's to read once the
block has ended; nothing is written out while it runs.

A span never launches device work, never synchronises and never reads a
tensor's value, so device work is not moved by recording.  Its times are
on time.time_ns's clock, the Unix epoch's, on which torch.profiler stamps
the host's runtime calls (kineto's start_ns(), cudaLaunchKernel and the
like): a span and the launches inside it compare with no offset to
estimate (utils/profiling).  The device's own times come mapped from
another clock and serve for lengths only.  Spans are recorded for one
thread at a time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

_now = time.time_ns


class Span:
    """One span: name, start_ns, end_ns (None while open), parent (index
    of the enclosing span in the recording, -1 for a root), seq (the
    root's ordinal in the recording) and attrs."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "seq", "attrs")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = None
        self.parent = -1
        self.seq = -1

    def __enter__(self) -> "Span":
        rec = _recorder
        if rec is not None:
            rec.open(self)
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _now()
        rec = _recorder
        if rec is not None and rec.stack and \
                rec.spans[rec.stack[-1]] is self:
            rec.stack.pop()

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, parent={self.parent}, seq={self.seq}, "
                f"attrs={self.attrs})")


class _NoSpan:
    """What span() returns while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.roots = 0

    def open(self, sp: Span) -> None:
        if self.stack:
            sp.parent = self.stack[-1]
            sp.seq = self.spans[sp.parent].seq
        else:
            sp.seq = self.roots
            self.roots += 1
        self.stack.append(len(self.spans))
        self.spans.append(sp)
        sp.start_ns = _now()


_recorder: Optional[_Recorder] = None     # the recording, while one runs


def span(name: str, *, entry: str | None = None, i: int | None = None,
         s: int | None = None, k: int | None = None,
         stage: int | None = None, view: int | None = None,
         round: int | None = None,  # noqa: A002 (the attribute's name)
         fused: bool | None = None,
         filter: str | None = None,  # noqa: A002 (the attribute's name)
         level: int | None = None, slices: int | None = None,
         lerp: str | None = None, levels: int | None = None):
    """A context manager around one layer's work: a Span while recording,
    else the shared NO_SPAN.  The keywords are the span's attributes:
    entry (the pair's entry point), i (iteration), s (sweep), k
    (candidates a pixel proposed), stage (refinement stage), view and
    round (a draw's key), fused (a refinement stage proposed by kernel
    RPROP), filter, level and slices (an aggregation filter, the pyramid
    level it runs on and the inner slices it filters), lerp and levels (the
    no-volume data term, "cost" or "image", and the pyramid levels it
    sums); only those given are kept."""
    if _recorder is None:
        return NO_SPAN
    attrs = {key: v for key, v in (("entry", entry), ("i", i), ("s", s),
                                   ("k", k), ("stage", stage),
                                   ("view", view), ("round", round),
                                   ("fused", fused), ("filter", filter),
                                   ("level", level), ("slices", slices),
                                   ("lerp", lerp), ("levels", levels))
             if v is not None}
    return Span(name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span opened in the block; yields the list they are
    kept in (in the order they opened), complete once the block ends.
    Recordings do not nest (RuntimeError)."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _recorder = _Recorder()
    try:
        yield rec.spans
    finally:
        _recorder = None
