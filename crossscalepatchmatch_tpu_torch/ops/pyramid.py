"""Gaussian pyramid with OpenCV pyrDown semantics
(port of crossscalepatchmatch_tpu.ops.pyramid).

pyrDown (pre_cs_pc.cc:42-49): the separable 5-tap (1,4,6,4,1)/16 blur with
BORDER_REFLECT_101, then the even rows and columns, so a side n becomes
(n+1)//2.  u8 inputs are blurred in f32 and rounded half to even back.
"""

from __future__ import annotations

from typing import List

import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of a BORDER_REFLECT_101 padded axis:
    gfedcb|abcdefgh|gfedcba."""
    idx = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def _blur1d(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    xp = x.index_select(dim, _reflect101_index(n, 2, x.device))
    out = torch.zeros_like(x, dtype=torch.float32)
    for i, k in enumerate(_K5):
        out = out + k * xp.narrow(dim, i, n)
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyrDown step: 5x5 Gaussian blur + even-index decimation.

    Args:
      img: [H, W] or [H, W, C], u8 (blurred in f32, rounded back) or float.

    Returns:
      [(H+1)//2, (W+1)//2, ...] image of the input dtype.
    """
    orig_dtype = img.dtype
    x = _blur1d(img.to(torch.float32), dim=0)
    x = _blur1d(x, dim=1)
    x = x[::2, ::2]
    if not orig_dtype.is_floating_point:
        info = torch.iinfo(orig_dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(orig_dtype).contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[level 0 = input, level s = pyr_down^s(input)]."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out
