"""fly_cost.roofline_pct: the least time the H100 needs for the fly kernel's
work of the traced pairs (stereobench.roofline.fly_cost_seconds: the
no-volume schedule's launches, counted from the configuration and the
frame) over the device time of the fly kernel (K5 and K3-fly), in %."""

from stereobench import roofline


def read(trace):
    measured = trace.family_s("fly_cost")
    if measured <= 0:
        return None
    e = trace.engine
    if trace.warm_iters is not None:
        e = roofline.warm_engine(e, trace.warm_iters)
    least = roofline.fly_cost_seconds(e, *trace.frame)
    if least is None:
        return None
    return 100.0 * trace.pairs * least / measured
