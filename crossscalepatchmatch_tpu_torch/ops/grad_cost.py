"""Truncated absolute-difference color + gradient (GRD) cost volume
(port of crossscalepatchmatch_tpu.ops.grad_cost).

cost(x, d) = alpha * min(mean_c |ref_c(x) - oth_c(x -+ d)|, tau_clr)
           + (1 - alpha) * min(|ref_g(x) - oth_g(x -+ d)|, tau_grd),
with the constant pseudo-intensity border_thres standing in for the other
view where x -+ d leaves the image (cc/grd_cc.cpp:7-35,110-154).

grd_cost_volume is the plain version of kernel GRDV (ops.cuda.grd_volume,
which ops.cost_volume.build_volumes takes for CUDA tensors) and the volume
of the plain fly cost (ops.onthefly_cost) on every device.
"""

from __future__ import annotations

import torch

from .color import rgb_to_gray_f32
from .gradient import sobel_x_k1

# Calls of the plain GRD volume (a plain count; the GPU tier reads it to
# show the card's main paths never came through here).
launches = 0


def grd_cost_volume(l_rgb: torch.Tensor, r_rgb: torch.Tensor, max_dis: int,
                    alpha: float = 0.1, tau_clr: float = 10.0,
                    tau_grd: float = 2.0, border_thres: float = 3.0,
                    right: bool = False) -> torch.Tensor:
    """TAD color+gradient cost volume with d in [0, max_dis] inclusive.

    Args:
      l_rgb / r_rgb: [H, W, 3] RGB views with 0..255 values.
      right: build the right-referenced volume (other view at x + d).

    Returns:
      f32[H, W, max_dis+1].
    """
    global launches
    launches += 1
    l_rgb = l_rgb.to(torch.float32)
    r_rgb = r_rgb.to(torch.float32)
    l_grd = sobel_x_k1(rgb_to_gray_f32(l_rgb))
    r_grd = sobel_x_k1(rgb_to_gray_f32(r_rgb))

    def mix(clr, grd):
        clr = torch.clamp(clr, max=tau_clr)
        grd = torch.clamp(grd, max=tau_grd)
        return alpha * clr + (1.0 - alpha) * grd

    if right:
        ref_rgb, ref_grd, oth_rgb, oth_grd = r_rgb, r_grd, l_rgb, l_grd
    else:
        ref_rgb, ref_grd, oth_rgb, oth_grd = l_rgb, l_grd, r_rgb, r_grd

    w = ref_grd.shape[1]
    x = torch.arange(w, device=ref_grd.device)[None, :]
    # jnp.mean is sum / n; keep that form so the f32 rounding matches
    border_clr = (ref_rgb - border_thres).abs().sum(-1) / 3.0
    border_cost = mix(border_clr, (ref_grd - border_thres).abs())

    slices = []
    for d in range(max_dis + 1):
        shift = -d if right else d
        oth_rgb_d = torch.roll(oth_rgb, shift, dims=1)
        oth_grd_d = torch.roll(oth_grd, shift, dims=1)
        clr = (ref_rgb - oth_rgb_d).abs().sum(-1) / 3.0
        cost = mix(clr, (ref_grd - oth_grd_d).abs())
        in_range = (x + d < w) if right else (x - d >= 0)
        slices.append(torch.where(in_range, cost, border_cost))
    return torch.stack(slices, dim=-1)
