"""torch_ops.device_ms: device ms per pair of the ops outside the
program's hand-written kernel families: PyTorch's own kernels, copies and
fills (the optimizer's glue, the pyramid, the left-right check and fill)."""

from stereobench.families import OTHER


def read(trace):
    if not trace.pairs or not trace.count(OTHER):
        return None
    return 1e3 * trace.family_s(OTHER) / trace.pairs
