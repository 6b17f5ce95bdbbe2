"""The engine's state carried across from and to NumPy.

The system has no learned weights; what the two packages share is state:
the plane field and costs (PMState) and the volumes (VolumeData).  These
helpers take the JAX package's arrays as NumPy, so a test can put the same
state and volumes into both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .models.patchmatch import PMState
from .ops.cost_volume import VolumeData


def state_from_numpy(abc: np.ndarray, cost: np.ndarray, *,
                     device) -> PMState:
    """PMState from f32[2, H, W, 3] planes and f32[2, H, W] costs."""
    return PMState(
        abc=torch.as_tensor(np.array(abc, np.float32)).to(device),
        cost=torch.as_tensor(np.array(cost, np.float32)).to(device))


def state_to_numpy(state: PMState) -> Tuple[np.ndarray, np.ndarray]:
    """(abc, cost) as NumPy arrays."""
    return state.abc.cpu().numpy(), state.cost.cpu().numpy()


def volume_data_from_numpy(imgs: Sequence[np.ndarray],
                           vols: Sequence[np.ndarray],
                           max_costs: Sequence[np.ndarray], *,
                           device) -> VolumeData:
    """VolumeData from per-level u8[2, Hs, Ws, 3] images, f32[2, Hs, Ws, Ds]
    volumes and f32[2] saturation values."""
    def put(xs, dtype):
        return [torch.as_tensor(np.array(x, dtype)).to(device) for x in xs]

    return VolumeData(imgs=put(imgs, np.uint8), vols=put(vols, np.float32),
                      max_costs=put(max_costs, np.float32))
