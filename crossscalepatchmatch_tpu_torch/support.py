"""What this port covers so far, and where the rest is planned.

A config outside the ported slice raises NotImplementedError naming the
ROADMAP step that brings it; such a config is never run approximately.
"""

from __future__ import annotations

from .config import Aggregator, CSPMConfig


def check_supported(cfg: CSPMConfig) -> None:
    """Raise NotImplementedError for any config outside the ported slice
    (GRD or CEN precomputed volumes, single- or cross-scale, quadrant-volume
    or no prescreen, optional post-processing)."""
    missing = []
    if not cfg.precompute_volume:
        missing.append("precompute_volume=False (ROADMAP queue 1 step 11: "
                       "no-volume path, kernels K5-K7)")
    if cfg.use_lab_weights:
        missing.append("use_lab_weights (ROADMAP queue 1 step 12)")
    if cfg.aggregator != Aggregator.NONE:
        missing.append(f"aggregator={cfg.aggregator.value} "
                       "(ROADMAP queue 1 step 12: filters)")
    # cross-scale runs have no window prescreen (they rank on the fine
    # level's quadrant volumes or not at all), so only single-scale runs
    # need kernel K3
    if (cfg.prescreen_mode == "window" and cfg.prescreen_stride > 1
            and not cfg.use_cs):
        missing.append("prescreen_mode='window' (ROADMAP kernel K3: "
                       "strided-window prescreen)")
    if missing:
        raise NotImplementedError(
            "not yet ported to crossscalepatchmatch_tpu_torch: "
            + "; ".join(missing))
