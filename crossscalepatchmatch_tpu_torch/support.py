"""What this port covers so far, and where the rest is planned.

A config outside the ported slice raises NotImplementedError naming the
ROADMAP step that brings it; such a config is never run approximately.
"""

from __future__ import annotations

from .config import Aggregator, CSPMConfig


def check_supported(cfg: CSPMConfig) -> None:
    """Raise NotImplementedError for any config outside the ported slice
    (GRD or CEN precomputed volumes or the GRD no-volume path, single- or
    cross-scale, quadrant-volume, window or no prescreen, Lab weights,
    optional post-processing): only the aggregation filters remain."""
    if cfg.aggregator != Aggregator.NONE:
        raise NotImplementedError(
            "not yet ported to crossscalepatchmatch_tpu_torch: "
            f"aggregator={cfg.aggregator.value} (ROADMAP queue 1 step 12: "
            "filters)")
