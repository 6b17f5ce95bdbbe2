"""Typed configuration of the stereo engine (the port's own copy of
crossscalepatchmatch_tpu.config: the same fields, defaults and validation).

One frozen dataclass holds the reference's runtime flags (CSPM/main.cc:23-34)
and its compile-time constants.  The optimizer-schedule fields
(prop_sweeps ... merge_view) and the backend fields are the JAX engine's;
the port reads them with the same meaning, except use_pallas, which it
ignores: a tensor's device decides whether the CUDA kernels run.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class CostMethod(str, enum.Enum):
    """Matching cost: "GRD" truncated colour + gradient difference
    (cc/grd_cc.cpp), "CEN" 9x9 / 80-bit census Hamming (cc/cen_cc.cc)."""

    GRD = "GRD"
    CEN = "CEN"


class Aggregator(str, enum.Enum):
    """Optional per-slice cost-volume aggregation filter
    (CSPM/ca_filter/{BoxCA,GFCA,BFCA}.cpp); NONE is the reference binary."""

    NONE = "NONE"
    BOX = "BOX"
    GF = "GF"
    BF = "BF"


@dataclasses.dataclass(frozen=True)
class CSPMConfig:
    """All engine parameters; the defaults reproduce the reference binary
    plus the JAX engine's production optimizer schedule."""

    # --- problem shape -----------------------------------------------------
    max_dis: int = 60           # max disparity (slices d in [0, max_dis])
    dis_scale: int = 4          # uint8 output scaling factor

    # --- method selection --------------------------------------------------
    cost_method: CostMethod = CostMethod.GRD
    use_cs: bool = False        # cross-scale aggregation over scale_num levels
    use_pp: bool = False        # LR check, fill, weighted median
    reg_lambda: float = 0.0     # inter-scale regularization strength
    aggregator: Aggregator = Aggregator.NONE

    # --- optimizer ---------------------------------------------------------
    max_iter: int = 3           # outer PatchMatch iterations
    wnd_size: int = 35          # support-window size (odd)
    scale_num: int = 5          # pyramid levels when use_cs
    max_norm: float = 1.0       # initial normal perturbation magnitude
    z_stop_thres: float = 0.1   # refinement stop threshold
    prop_sweeps: int = 2        # dense propagation sweeps per iteration
    far_offsets: Tuple[int, ...] = (5, 25)   # far rings, cycled per sweep
    batch_refine: bool = True   # propose a stage's perturbations at once
    refine_stages: int = 2      # adopt-between groups of the batched schedule
    prescreen_stride: int = 2   # prescreen window subsampling (1: off)
    prescreen_mode: str = "volume"   # "volume" (quadrant ranking) | "window"
    adopt_mode: str = "rank+exact"   # "exact" | "rank" | "rank+exact"
    exact_iters: int = 2        # trailing exact iterations of rank+exact
    merge_view: bool = False    # fold view propagation into the last sweep

    use_lab_weights: bool = False    # ASW weights on CIE Lab (USE_LAB_WGT)

    # --- cost model constants ---------------------------------------------
    cost_alpha: float = 0.1     # color/gradient mixing weight
    tau_clr: float = 10.0       # color truncation
    tau_grd: float = 2.0        # gradient truncation
    border_thres: float = 3.0   # out-of-border GRD pseudo-intensity
    wgt_gamma: float = 10.0     # adaptive-support-weight color bandwidth
    census_wnd: int = 9         # census window (odd)
    wmf_gamma: float = 10.0     # weighted-median color bandwidth

    # --- post-processing ---------------------------------------------------
    lr_check_thres: float = 0.5  # max |d_l - d_r| for a pixel to be valid

    # --- plane-cost backend --------------------------------------------------
    precompute_volume: bool = True   # False: on-the-fly GRD cost (no volume)
    fly_lerp: str = "cost"           # on-the-fly lerp: "cost" | "image"

    # --- numerics / runtime ------------------------------------------------
    seed: int = 0
    eps: float = 1e-8           # kDoubleEps analogue (commfunc.h:25)
    use_pallas: bool = True     # the JAX engine's switch; ignored here
    vol_dtype: str = "bf16"     # kernel-read volume storage: "f32" | "bf16"

    def __post_init__(self):
        if self.wnd_size % 2 != 1:
            raise ValueError(f"wnd_size must be odd, got {self.wnd_size}")
        if self.census_wnd % 2 != 1:
            raise ValueError(f"census_wnd must be odd, got {self.census_wnd}")
        if self.max_dis < 1:
            raise ValueError(f"max_dis must be >= 1, got {self.max_dis}")
        if not self.precompute_volume and self.cost_method != CostMethod.GRD:
            raise ValueError(
                "the on-the-fly plane cost exists only for GRD "
                "(grd_pc.cc/cspc.cc have no census variant)")
        if not self.precompute_volume and self.aggregator != Aggregator.NONE:
            raise ValueError(
                "aggregation filters need a precomputed volume to filter "
                "(ca_method.h operates on volume slices)")
        if self.fly_lerp not in ("cost", "image"):
            raise ValueError(
                f"fly_lerp must be 'cost' or 'image', got "
                f"{self.fly_lerp!r}")
        if self.vol_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"vol_dtype must be 'f32' or 'bf16', got "
                f"{self.vol_dtype!r}")
        if self.prescreen_mode not in ("window", "volume"):
            raise ValueError(
                f"prescreen_mode must be 'window' or 'volume', got "
                f"{self.prescreen_mode!r}")
        if self.adopt_mode not in ("exact", "rank", "rank+exact"):
            raise ValueError(
                f"adopt_mode must be 'exact', 'rank' or 'rank+exact', "
                f"got {self.adopt_mode!r}")
        if self.adopt_mode == "rank" and not self.rank_enabled:
            raise ValueError(
                "rank adoption requires the quadrant-volume prescreen "
                "(prescreen_mode='volume', prescreen_stride>1, "
                "precompute_volume=True)")
        if not 1 <= self.exact_iters:
            raise ValueError(
                f"exact_iters must be >= 1, got {self.exact_iters}")

    @property
    def rank_enabled(self) -> bool:
        """Rank adoption needs the quadrant-volume ranking; configs
        without it run "rank+exact" as all-exact."""
        return (self.adopt_mode != "exact"
                and self.prescreen_mode == "volume"
                and self.prescreen_stride > 1 and self.precompute_volume)

    @property
    def rank_iters(self) -> int:
        """Leading optimizer iterations that adopt on ranking costs."""
        if not self.rank_enabled:
            return 0
        if self.adopt_mode == "rank":
            return self.max_iter
        return max(0, self.max_iter - self.exact_iters)

    @property
    def half_wnd(self) -> int:
        return self.wnd_size // 2

    @property
    def census_bit(self) -> int:
        return self.census_wnd * self.census_wnd - 1

    @property
    def num_slices(self) -> int:
        """Cost-volume slices: d in [0, max_dis] (pre_ss_pc.cc:40-42)."""
        return self.max_dis + 1

    def scale_max_dis(self, scale: int) -> int:
        """Per-level max disparity, halved per level (pre_cs_pc.cc:48)."""
        d = self.max_dis
        for _ in range(scale):
            d //= 2
        return d

    def scale_shape(self, hw: Tuple[int, int], scale: int) -> Tuple[int, int]:
        """Per-level image shape, ceil-halved per level
        (pre_cs_pc.cc:46-47)."""
        h, w = hw
        for _ in range(scale):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h, w

    def refinement_schedule(self) -> Tuple[float, ...]:
        """Halving disparity-perturbation magnitudes z: max_dis/2, /4, ...
        while z >= z_stop_thres (cs_patchmatch.cc:292-345)."""
        out = []
        z = self.max_dis / 2.0
        while z >= self.z_stop_thres:
            out.append(z)
            z /= 2.0
        return tuple(out)


# Workload configs of the reference's input.txt and README
# (CSPM/input.txt:1-20, README.md:12-14).
README_DEMO = CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.GRD,
                         use_cs=False, use_pp=False, reg_lambda=0.0)

# The README's library example: census cost, cross-scale aggregation over
# the 5-level pyramid with lambda = 0.3, and post-processing.
CEN_CS_PP = CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                       use_cs=True, use_pp=True, reg_lambda=0.3)

# KITTI-size frames (1242x375, 128 disparities, scored at 3 px).
KITTI = CSPMConfig(max_dis=128, dis_scale=1, cost_method=CostMethod.GRD,
                   use_pp=True)

MIDDLEBURY = {
    "tsukuba": CSPMConfig(max_dis=16, dis_scale=16, cost_method=CostMethod.CEN,
                          use_pp=True),
    "venus": CSPMConfig(max_dis=20, dis_scale=8, cost_method=CostMethod.CEN,
                        use_pp=True),
    "cones": CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                        use_pp=True),
    "teddy": CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                        use_pp=True),
    "reindeer": CSPMConfig(max_dis=80, dis_scale=3, cost_method=CostMethod.CEN,
                           use_pp=True),
}
