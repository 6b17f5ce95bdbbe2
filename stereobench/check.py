"""Whether what the timed path produced is correct: the outputs of a sample
of the window's pairs held against the configuration's plain reference
(stereobench.reference, or the module its file names) worked out again
from the same u8 views and the planes the program returned, and what the
search found over the whole window held against the scenes' exact
ground truth.

Numbers compared (each against the configuration's "limits"):
  cost_gap       the widest gap between the program's cost of a pixel's
                 plane and the reference's, over the larger of the
                 reference's cost there and its median over the pair;
  dis_diff_px    pixels of the two u8 maps that differ from the
                 reference's (plane to disparity, then with use_pp the
                 left-right check, the fill and the weighted median);
  valid_diff_px  pixels whose left-right validity differs;
  bad_px_pct     the mean over every pair of the window of its left map's
                 share of non-occluded pixels off by more than the
                 configuration's threshold, in %: the planes the search
                 (the volume build, K2, the ranking, the draws and the
                 adoption) settled on, which the other numbers take as
                 given.
The first three are the worst over the sampled pairs.  A pair whose
outputs have another shape or type, or a cost that is not finite, reads
an infinite cost_gap.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

NUMBERS = ("cost_gap", "dis_diff_px", "valid_diff_px")   # sampled pairs
WINDOW_NUMBERS = ("bad_px_pct",)                          # every pair


def _shapes_ok(out: dict, h: int, w: int) -> bool:
    want = {"dis": ((2, h, w), torch.uint8), "valid": ((2, h, w), torch.bool),
            "cost": ((2, h, w), torch.float32),
            "abc": ((2, h, w, 3), torch.float32)}
    return all(k in out and tuple(out[k].shape) == s and out[k].dtype == t
               for k, (s, t) in want.items())


def compare(out: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one pair: the program's outputs `out` against the
    reference's `ref` (the same keys)."""
    h, w = ref["dis"].shape[1:]
    if not _shapes_ok(out, h, w) or not bool(torch.isfinite(out["cost"]).all()):
        return {"cost_gap": math.inf, "dis_diff_px": math.inf,
                "valid_diff_px": math.inf}
    rc = ref["cost"].abs()
    scale = torch.maximum(rc, rc.median())
    gap = ((out["cost"] - ref["cost"]).abs() / scale).max()
    return {"cost_gap": float(gap),
            "dis_diff_px": int((out["dis"] != ref["dis"]).sum()),
            "valid_diff_px": int((out["valid"] != ref["valid"]).sum())}


def judge(kept: list, frames, engine: dict, reference,
          controls: Dict[str, tuple] | None = None) -> Dict[str, list]:
    """Each kept pair's numbers: under "program" the program's outputs
    against the float32 `reference` (the cell's reference module); under
    each name of `controls` (name -> (compute dtype, store dtype)) the
    reference computed in those dtypes, put in the program's place (a
    control, which has to fail).  `frames(i)` gives pair i's (left, right)
    views."""
    rows: Dict[str, list] = {"program": []}
    for name in controls or {}:
        rows[name] = []
    for k in kept:
        l, r = frames(k.index)
        ref = reference.outputs(l, r, k.out["abc"], engine)
        rows["program"].append(compare(k.out, ref))
        for name, (compute, store) in (controls or {}).items():
            got = reference.outputs(l, r, k.out["abc"], engine,
                                    compute=compute, store=store)
            rows[name].append(compare(dict(got, abc=k.out["abc"]), ref))
        del ref
    return rows


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {n: max((r[n] for r in rows), default=math.inf) for n in NUMBERS}


def verdict(rows: List[Dict[str, float]], window: Dict[str, float],
            limits: dict) -> tuple:
    """(correct, the sampled pairs that failed, whether the window's numbers
    held, the numbers compared): correct when at least one pair was
    compared, every number of every sampled pair is within its limit and so
    is each of the window's numbers (`window`, by name)."""
    failed = sum(any(r[n] > limits[n] for n in NUMBERS) for r in rows)
    numbers = dict(worst(rows), **window)
    window_ok = all(window[n] <= limits[n] for n in WINDOW_NUMBERS)
    return (bool(rows) and failed == 0 and window_ok, failed, window_ok,
            numbers)
