"""Color conversions (port of crossscalepatchmatch_tpu.ops.color).

The BGR->RGB channel swap, the float BT.601 grayscale that feeds the Sobel
gradient (cc/grd_cc.cpp:70-77), OpenCV's 8-bit fixed-point grayscale that
feeds the census transform (cc/cen_cc.cc:12-17), and the 8-bit CIE Lab
conversion of the Lab-weight variant (grd_pc.cc:31-35).
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


# CIE Lab conversion constants (OpenCV cvtColor CV_BGR2Lab semantics for
# CV_8U inputs, per the imgproc documentation): linear sRGB-primaries
# RGB -> XYZ matrix, D65 white point, the 0.008856 cube-root threshold.
_XYZ_M = ((0.412453, 0.357580, 0.180423),
          (0.212671, 0.715160, 0.072169),
          (0.019334, 0.119193, 0.950227))
_XN, _ZN = 0.950456, 1.088754
_LAB_T = 0.008856


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative f32 tensor, taken in f64 and rounded to
    f32 (torch has no cbrt; a f32 pow(t, 1/3) can miss by an ulp more)."""
    return torch.pow(t.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def bgr_to_lab_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """u8 BGR -> u8 CIE Lab with OpenCV's 8-bit scaling (inputs scaled to
    [0, 1] without gamma, L stored as L*255/100, a/b offset by +128,
    saturated to u8), the weight image of cfg.use_lab_weights.  f32
    arithmetic in the JAX engine's order; only the cube root is taken in
    f64, so a value next to a rounding boundary may land one u8 step away
    from the JAX engine's (tests/test_torch_onthefly.py states how often).
    """
    rgb = bgr_to_rgb(bgr_u8).to(torch.float32) * (1.0 / 255.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    x = (_XYZ_M[0][0] * r + _XYZ_M[0][1] * g + _XYZ_M[0][2] * b) / _XN
    y = _XYZ_M[1][0] * r + _XYZ_M[1][1] * g + _XYZ_M[1][2] * b
    z = (_XYZ_M[2][0] * r + _XYZ_M[2][1] * g + _XYZ_M[2][2] * b) / _ZN

    def f(t):
        return torch.where(t > _LAB_T, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    el = torch.where(y > _LAB_T, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    a = 500.0 * (f(x) - f(y)) + 128.0
    bb = 200.0 * (f(y) - f(z)) + 128.0
    lab = torch.stack([el * (255.0 / 100.0), a, bb], dim=-1)
    return torch.clamp(torch.round(lab), 0, 255).to(torch.uint8)
