"""quadrant_rank.device_ms: device ms per pair of the quadrant ranking
(kernel QRANK)."""


def read(trace):
    if not trace.pairs or not trace.count("quadrant_rank"):
        return None
    return 1e3 * trace.family_s("quadrant_rank") / trace.pairs
