"""x-gradient with OpenCV Sobel(dx=1, ksize=1) semantics
(port of crossscalepatchmatch_tpu.ops.gradient).

Written as a slice difference, not a convolution, so no cuDNN (and no TF32)
is on the path.
"""

from __future__ import annotations

import torch


def sobel_x_k1(gray: torch.Tensor) -> torch.Tensor:
    """dst(x) = gray(x+1) - gray(x-1), 0 at the first/last column.

    Args:
      gray: f32[..., H, W].

    Returns:
      f32[..., H, W]; all 0 at W = 1 (the one column is the first and the
      last, as OpenCV's reflect-101 border gives), where the JAX package's
      sobel_x_k1 returns two columns of 0.
    """
    gray = gray.to(torch.float32)
    if gray.shape[-1] == 1:
        return torch.zeros_like(gray)
    interior = gray[..., :, 2:] - gray[..., :, :-2]
    zeros = torch.zeros_like(gray[..., :, :1])
    return torch.cat([zeros, interior, zeros], dim=-1)
