"""The configs a run on the card cannot take, refused before any work.

The port runs every config the JAX engine accepts.  On the CPU (the plain
versions) nothing is refused.  On the card a few configs lie outside what
the hand-written kernels take; check_supported refuses them at entry, with
the limit named, before any volume is built, instead of letting a kernel
wrapper raise halfway through a pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import CSPMConfig
from .ops.cuda import MAX_HALF_WND


def check_supported(cfg: CSPMConfig, hw: Tuple[int, int], device) -> None:
    """Raise ValueError for a config the card's kernels do not take.

    Args:
      hw: the fine level's (H, W).
      device: where the run happens; only a CUDA device is checked.

    The limits: every kernel takes half_wnd <= 64; the image-lerp fly
    kernel (K6: precompute_volume=False, fly_lerp="image") needs max_dis
    below the image's width (it wraps a tap modulo the width, the plain
    version's HandleBorder by one +-W: the two agree while max_dis < W;
    each coarser level then holds it too, floor(max_dis / 2^s) < ceil(W /
    2^s)).
    """
    if torch.device(device).type != "cuda":
        return
    if cfg.half_wnd > MAX_HALF_WND:
        raise ValueError(
            f"wnd_size {cfg.wnd_size}: the card's kernels take half_wnd <= "
            f"{MAX_HALF_WND}, this config has {cfg.half_wnd}")
    if (not cfg.precompute_volume
            and cfg.fly_lerp == "image" and cfg.max_dis > 1
            and cfg.max_dis >= hw[1]):
        raise ValueError(
            f"fly_lerp='image' on the card needs max_dis < the image's "
            f"width: max_dis {cfg.max_dis}, width {hw[1]}")
