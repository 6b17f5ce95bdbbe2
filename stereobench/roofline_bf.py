"""The least time the H100 could take for a pair's bilateral volume filter
(the BF aggregator), counted from the configuration and the frame's shape
alone: a frozen copy of the program's utils/roofline.bilateral_volume_work,
the same count whatever implements the filter.  The peaks are
stereobench.roofline's.
"""

from __future__ import annotations

from typing import Tuple

from . import roofline

# per (pixel, window offset): the weight (three subtracts and absolute
# values, two adds and the 1/3 of the colour mean, its square and scale,
# the spatial term's subtract, the exp counted as one, the weight sum's
# add) once, and a multiply and an add for each of the D - 2 inner slices
BF_FLOPS_PER_WEIGHT = 12


def bilateral_volume_work(h: int, w: int, d: int,
                          wnd: int) -> Tuple[int, int]:
    """(bytes, f32 operations) of the wnd x wnd bilateral filter of both
    views' H x W x D volumes on one level.  The borders wrap, so every
    window offset of every pixel is in the image: 2 (D - 2) +
    BF_FLOPS_PER_WEIGHT operations a (pixel, offset); the f32 volumes read
    once, their D - 2 filtered inner slices written once and the u8 guides
    read once."""
    n = 2 * h * w
    inner = max(d - 2, 0)
    return (n * (4 * d + 4 * inner + 3),
            n * wnd * wnd * (2 * inner + BF_FLOPS_PER_WEIGHT))


def bilateral_seconds(e: dict, h: int, w: int) -> float | None:
    """The least time of one pair's bilateral filter over every level the
    volume path builds (roofline.level_shapes), None unless the
    configuration's aggregator is BF on the volume path: each level's
    filter at the larger of its operations over F32_FLOP_PER_S and its
    bytes over HBM_BYTES_PER_S."""
    if e["aggregator"] != "BF" or not e["precompute_volume"]:
        return None
    return sum(roofline.least_seconds(*bilateral_volume_work(
        hs, ws, ds, e["wnd_size"])) for hs, ws, ds in
        roofline.level_shapes(e, h, w))
