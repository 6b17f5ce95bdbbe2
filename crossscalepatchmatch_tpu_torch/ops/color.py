"""Color conversions (port of crossscalepatchmatch_tpu.ops.color).

The BGR->RGB channel swap, the float BT.601 grayscale that feeds the Sobel
gradient (cc/grd_cc.cpp:70-77), and OpenCV's 8-bit fixed-point grayscale
that feeds the census transform (cc/cen_cc.cc:12-17).
"""

from __future__ import annotations

import torch

# BT.601 luma weights (OpenCV RGB2GRAY).
_R, _G, _B = 0.299, 0.587, 0.114
# OpenCV's fixed-point representation: round(w * 2^14).
_R14, _G14, _B14 = 4899, 9617, 1868


def rgb_to_gray_f32(rgb: torch.Tensor) -> torch.Tensor:
    """Float grayscale of an RGB image with 0..255-scaled values."""
    rgb = rgb.to(torch.float32)
    return _R * rgb[..., 0] + _G * rgb[..., 1] + _B * rgb[..., 2]


def rgb_to_gray_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 grayscale, bit-exact with OpenCV's CV_8U RGB2GRAY:
    (R*4899 + G*9617 + B*1868 + 2^13) >> 14 on integers."""
    p = rgb_u8.to(torch.int32)
    gray = (p[..., 0] * _R14 + p[..., 1] * _G14 + p[..., 2] * _B14
            + (1 << 13)) >> 14
    return gray.to(torch.uint8)


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Channel swap (the loader is BGR; volumes are built on RGB)."""
    return img.flip(-1)
