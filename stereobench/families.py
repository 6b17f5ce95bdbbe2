"""Which hand-written kernel family a device op of the program belongs to,
by its kernel name, and the program's launch counter that each family's
launches can be held against (a frozen copy of the program's
utils/profiling.kernel_family and launch_counts)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

_CUDA = "crossscalepatchmatch_tpu_torch.ops.cuda."


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    kernels: Tuple[str, ...]      # substrings of the family's kernel names
    counted: str                  # the kernel launched once a counted call
    counters: Tuple[str, ...]     # module.attribute of the launch counters


FAMILIES = (
    # K1 (one level) and K4 (the pyramid) run one kernel
    Family("window_cost", ("cross_scale_kernel",), "cross_scale_kernel",
           (_CUDA + "window_cost.launches",
            _CUDA + "cross_scale_cost.launches")),
    Family("quadrant_build", ("quadrant_build_kernel",),
           "quadrant_build_kernel", (_CUDA + "quadrant_build.launches",)),
    Family("quadrant_rank", ("quadrant_rank_kernel",), "quadrant_rank_kernel",
           (_CUDA + "quadrant_rank.launches",)),
    Family("grd_volume", ("grd_volume_kernel",), "grd_volume_kernel",
           (_CUDA + "grd_volume.launches",)),
    Family("census_volume", ("census_codes_kernel", "census_volume_kernel"),
           "census_volume_kernel", (_CUDA + "census_volume.launches",)),
    Family("weighted_median", ("weighted_median_kernel",
                               "wmf_pack_count_kernel", "wmf_compact_kernel"),
           "weighted_median_kernel", (_CUDA + "weighted_median.launches",)),
    Family("fly_cost", ("fly_cost_kernel",), "fly_cost_kernel",
           (_CUDA + "fly_cost.launches",)),
)
OTHER = "other"


def family_of(kernel: str) -> str:
    """The family of a device op by its name; OTHER for PyTorch's own ops
    (and copies and fills)."""
    for f in FAMILIES:
        if any(k in kernel for k in f.kernels):
            return f.name
    return OTHER


def read_counters() -> Dict[str, Optional[int]]:
    """Each family's launch count so far by the program's counters; None
    where a counter is missing from the program."""
    out: Dict[str, Optional[int]] = {}
    for f in FAMILIES:
        total = 0
        for path in f.counters:
            mod, attr = path.rsplit(".", 1)
            try:
                value = getattr(importlib.import_module(mod), attr)
            except (ImportError, AttributeError):
                total = None
                break
            total += sum(value.values()) if isinstance(value, dict) \
                else int(value)
        out[f.name] = total
    return out
