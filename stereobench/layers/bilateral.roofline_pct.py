"""bilateral.roofline_pct: the least time the H100 needs for the bilateral
volume filter of the traced pairs (stereobench.roofline_bf.bilateral_seconds:
every level's filter, counted from the configuration and the frame) over
the device time of the program's bilateral filter kernel (BFV, picked out
of the trace by its kernel name), in %."""

from stereobench import roofline_bf

KERNEL = "bilateral_volume_kernel"


def read(trace):
    measured = sum(b - a for a, b, name, _ in trace.ops if KERNEL in name)
    if measured <= 0 or not trace.pairs:
        return None
    least = roofline_bf.bilateral_seconds(trace.engine, *trace.frame)
    if least is None:
        return None
    return 100.0 * trace.pairs * least / measured
