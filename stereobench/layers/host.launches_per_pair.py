"""host.launches_per_pair: device ops (kernels, copies, fills) the
profiler recorded, per traced pair: the host's launch stream."""


def read(trace):
    if not trace.ops or not trace.pairs:
        return None
    return len(trace.ops) / trace.pairs
