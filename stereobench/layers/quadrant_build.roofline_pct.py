"""quadrant_build.roofline_pct: the least time the H100 needs for the
quadrant build's work of the traced pairs (one build a pair,
stereobench.roofline) over the device time of kernel K2, in %."""

from stereobench import roofline


def read(trace):
    measured = trace.family_s("quadrant_build")
    least = roofline.quadrant_build_seconds(trace.engine, *trace.frame)
    if measured <= 0 or least is None:
        return None
    return 100.0 * trace.pairs * least / measured
