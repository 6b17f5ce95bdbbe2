"""Color conversions (port of crossscalepatchmatch_tpu.ops.color).

Only the two the GRD volume needs: the BGR->RGB channel swap and the float
BT.601 grayscale that feeds the Sobel gradient (cc/grd_cc.cpp:70-77).
"""

from __future__ import annotations

import torch

# BT.601 luma weights (OpenCV RGB2GRAY).
_R, _G, _B = 0.299, 0.587, 0.114


def rgb_to_gray_f32(rgb: torch.Tensor) -> torch.Tensor:
    """Float grayscale of an RGB image with 0..255-scaled values."""
    rgb = rgb.to(torch.float32)
    return _R * rgb[..., 0] + _G * rgb[..., 1] + _B * rgb[..., 2]


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Channel swap (the loader is BGR; volumes are built on RGB)."""
    return img.flip(-1)
