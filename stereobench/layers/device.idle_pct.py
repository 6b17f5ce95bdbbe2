"""device.idle_pct: the share of the loop's wall time in which no op runs
on the device, in %: 1 - (the traced pairs' device busy seconds, the union
of their ops' intervals) / (the host's wall seconds of as many pairs run
just before without the profiler, whose recording lengthens the traced
pairs' wall time but not the device's)."""


def read(trace):
    if not trace.ops or trace.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.untraced_s)
