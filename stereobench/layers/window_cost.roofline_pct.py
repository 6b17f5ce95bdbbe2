"""window_cost.roofline_pct: the least time the H100 needs for the window
cost's work of the traced pairs (stereobench.roofline: the schedule's
launches, counted from the configuration and the frame) over the device
time of the window-cost kernels (K1 on one level, K4 over the pyramid),
in %."""

from stereobench import roofline


def read(trace):
    measured = trace.family_s("window_cost")
    if measured <= 0:
        return None
    e = trace.engine
    if trace.warm_iters is not None:
        e = roofline.warm_engine(e, trace.warm_iters)
    h, w = trace.frame
    return 100.0 * trace.pairs * roofline.window_cost_seconds(e, h, w) \
        / measured
