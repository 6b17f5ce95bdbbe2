"""Inter-scale regularization weights for cross-scale aggregation
(port of crossscalepatchmatch_tpu.ops.scale_weights; NumPy).

The closed-form solution of the CVPR'14 cross-scale objective: row 0 of the
inverse of the scale_num x scale_num tridiagonal (I + lambda*L), diagonal
1+lambda at the ends and 1+2*lambda inside, -lambda off the diagonal
(pre_cs_pc.cc:88-109).
"""

from __future__ import annotations

import numpy as np


def scale_weights(scale_num: int, reg_lambda: float) -> np.ndarray:
    """Row 0 of (I + lambda*L)^-1 for the path-graph Laplacian over scales.

    Returns:
      f32[scale_num] weights; [1, 0, ..., 0] when reg_lambda == 0.
    """
    m = np.zeros((scale_num, scale_num), np.float64)
    for s in range(scale_num):
        ends = s == 0 or s == scale_num - 1
        m[s, s] = 1.0 + (reg_lambda if ends else 2.0 * reg_lambda)
        if s > 0:
            m[s, s - 1] = -reg_lambda
        if s < scale_num - 1:
            m[s, s + 1] = -reg_lambda
    inv = np.linalg.inv(m)
    return inv[0].astype(np.float32)
