"""What this port covers so far, and where the rest is planned.

A config outside the ported slice raises NotImplementedError naming the
ROADMAP step that brings it; such a config is never run approximately.
"""

from __future__ import annotations

from crossscalepatchmatch_tpu.config import (Aggregator, CostMethod,
                                             CSPMConfig)


def check_supported(cfg: CSPMConfig) -> None:
    """Raise NotImplementedError for any config outside the ported slice
    (single-level GRD volume, quadrant-volume or no prescreen, no
    post-processing)."""
    missing = []
    if cfg.cost_method != CostMethod.GRD:
        missing.append(f"cost_method={cfg.cost_method.value} "
                       "(ROADMAP queue 1 step 8: census)")
    if cfg.use_cs:
        missing.append("use_cs (ROADMAP queue 1 step 9: cross-scale, "
                       "kernel K4)")
    if cfg.use_pp:
        missing.append("use_pp (ROADMAP queue 1 step 7: post-processing)")
    if not cfg.precompute_volume:
        missing.append("precompute_volume=False (ROADMAP queue 1 step 11: "
                       "no-volume path, kernels K5-K7)")
    if cfg.use_lab_weights:
        missing.append("use_lab_weights (ROADMAP queue 1 step 12)")
    if cfg.aggregator != Aggregator.NONE:
        missing.append(f"aggregator={cfg.aggregator.value} "
                       "(ROADMAP queue 1 step 12: filters)")
    if cfg.prescreen_mode == "window" and cfg.prescreen_stride > 1:
        missing.append("prescreen_mode='window' (ROADMAP kernel K3: "
                       "strided-window prescreen)")
    if missing:
        raise NotImplementedError(
            "not yet ported to crossscalepatchmatch_tpu_torch: "
            + "; ".join(missing))
