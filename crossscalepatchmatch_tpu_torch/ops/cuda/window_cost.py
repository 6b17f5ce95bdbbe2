"""Kernel K1: the slanted-plane window cost of both views, and at
wnd_stride > 1 kernel K3's volume form, the strided-window prescreen.

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel`
(volume form, scale 0).  Its plain version is
ops.plane_cost.window_plane_cost.  The kernel is K4's
(csrc/cross_scale_cost.cu) at one level with weight 1 and the window
stride: at level 0 its level term is the window cost bit for bit
(d0 * 2^0 and 1 * cost are exact), and K1 / K3 keep launch counters of
their own.  On the card the volume may be f32 or bf16 (cfg.vol_dtype); the
kernel accumulates in f32 either way.

`prepare_volumes` does once per pair what does not depend on the
candidates (the JAX package's `prepare_volumes`): it checks the shapes,
packs the images, lays the volume out for the kernels (`pair_volume`) and
builds the weight table; `window_cost_prepared` (K1, K3) and
`quadrant_build.quadrant_volumes_prepared` (K2) then only launch.  On CPU
tensors the same object routes to the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import plane_cost
from . import (_build, check_half_wnd, check_tensor, pack_bgr,
               pair_volume)
from .cross_scale_cost import MAX_DIS_LIMIT, check_candidates, level_args

# Kernel launches (plain counts; chip_smoke resets and reads them): all,
# and those at wnd_stride > 1 (K3).
launches = 0
strided_launches = 0


@dataclasses.dataclass
class PreparedVolumes:
    """One view pair's single-scale volume data as the kernels read it (see
    prepare_volumes)."""

    imgs_u8: torch.Tensor               # u8[2, H, W, 3] weight images
    # f32 or bf16 [2, H, W, D]: read by the plain versions (CPU); None on
    # the card, where the kernels read `pvols`
    vols: torch.Tensor | None
    max_costs: torch.Tensor | None      # f32[2]; None: K2 only
    half_wnd: int
    max_dis: int
    gamma: float
    hw: Tuple[int, int]
    device: torch.device
    # the kernels' side (the card only): packed images i32[2, H, W], the
    # pair-layout volume [2, H, W, D, 2], the weight table, and K1's
    # one-level arguments of cspm_cross_scale_cost (with max_costs)
    img: torch.Tensor | None = None
    pvols: torch.Tensor | None = None
    lut: torch.Tensor | None = None
    args: tuple = ()


def prepare_volumes(imgs_u8: torch.Tensor, vols: torch.Tensor,
                    max_costs: torch.Tensor | None, *, half_wnd: int,
                    max_dis: int, gamma: float) -> PreparedVolumes:
    """Everything of K1, K3 and K2 that does not depend on the candidates.

    Args:
      imgs_u8: u8[2, H, W, 3] weight images.
      vols: f32 or bf16 [2, H, W, D], D = max_dis + 1.
      max_costs: f32[2] per-view saturation values (None where only the
        quadrant build runs).

    On the card the volume is copied into the kernels' pair layout
    (pair_volume: twice its memory) and the caller's is not held; the plain
    versions read it as it is (any window).  Raises ValueError on inputs
    the kernels do not take.
    """
    if vols.dim() != 4:
        raise ValueError(f"vols shape {tuple(vols.shape)} is not [2, H, W, D]")
    check_half_wnd(half_wnd, vols.device)
    if not 0 <= max_dis < MAX_DIS_LIMIT:
        raise ValueError(f"max_dis {max_dis} outside [0, {MAX_DIS_LIMIT})")
    _, h, w, _ = vols.shape
    dev = vols.device
    prep = PreparedVolumes(imgs_u8=imgs_u8, vols=vols, max_costs=max_costs,
                           half_wnd=half_wnd, max_dis=max_dis, gamma=gamma,
                           hw=(h, w), device=dev)
    if dev.type == "cpu":
        return prep
    d = max_dis + 1
    check_tensor("vols", vols, (torch.float32, torch.bfloat16), (2, h, w, d))
    check_tensor("imgs_u8", imgs_u8, (torch.uint8,), (2, h, w, 3))
    if max_costs is not None:
        check_tensor("max_costs", max_costs, (torch.float32,), (2,))
    if h * w * d >= 1 << 31:
        raise ValueError(f"vols: {h * w * d} elements a view, the kernels' "
                         "offsets are 32-bit")
    prep.img = pack_bgr(imgs_u8)
    prep.pvols = pair_volume(vols)
    prep.lut = plane_cost.asw_lut(gamma, dev)
    if max_costs is not None:
        prep.args = level_args([prep.img], [prep.pvols], [max_costs],
                               [(h, w, d, max_dis)], [1.0])
    prep.vols = None  # the kernels read the copy
    return prep


def window_cost_prepared(prep: PreparedVolumes, abc: torch.Tensor, *,
                         half_wnd: int, max_dis: int,
                         wnd_stride: int = 1) -> torch.Tensor:
    """Window plane cost of K candidate plane fields in both views on a
    prepared pair.  The caller restates the geometry it assumes (half_wnd,
    max_dis); a mismatch with the prepared object, a wnd_stride below 1, or
    planes of another shape or device, raises ValueError.

    Args:
      abc: f32[2, K, H, W, 3] candidate planes.
      wnd_stride: every wnd_stride-th window offset per axis from
        -half_wnd (the strided prescreen, K3); 1 for the exact cost.

    Returns:
      f32[2, K, H, W].  A pair prepared from CPU tensors takes the plain
      version, one from CUDA tensors the kernel.
    """
    global launches, strided_launches
    if (half_wnd, max_dis) != (prep.half_wnd, prep.max_dis):
        raise ValueError(
            f"call with half_wnd={half_wnd}, max_dis={max_dis} on a pair "
            f"prepared for half_wnd={prep.half_wnd}, max_dis={prep.max_dis}")
    if wnd_stride < 1:
        raise ValueError(f"wnd_stride {wnd_stride} < 1")
    if prep.max_costs is None:
        raise ValueError("the pair was prepared without saturation values")
    if abc.device != prep.device:
        raise ValueError(f"abc on {abc.device}, the pair on {prep.device}")
    if abc.dim() != 5 or tuple(abc.shape[2:4]) != prep.hw:
        raise ValueError(f"abc shape {tuple(abc.shape)} does not match the "
                         f"prepared (H, W) = {prep.hw}")
    if prep.device.type == "cpu":
        return torch.stack([plane_cost.window_plane_cost(
            prep.imgs_u8[v], prep.vols[v], prep.max_costs[v], abc[v],
            half_wnd=half_wnd, max_dis=max_dis, gamma=prep.gamma,
            wnd_stride=wnd_stride) for v in range(2)])
    k = abc.shape[1]
    h, w = prep.hw
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    check_candidates(k, h, w)
    lib = _build.load()
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    err = lib.cspm_cross_scale_cost(
        *prep.args, abc.data_ptr(), prep.lut.data_ptr(), out.data_ptr(), k,
        h, w, half_wnd, wnd_stride, _build.stream_of(abc))
    _build.check(err, "cspm_cross_scale_cost (K1)")
    launches += 1
    strided_launches += wnd_stride > 1
    return out


def window_cost(imgs_u8: torch.Tensor, vols: torch.Tensor,
                max_costs: torch.Tensor, abc: torch.Tensor, *,
                half_wnd: int, max_dis: int, gamma: float,
                wnd_stride: int = 1) -> torch.Tensor:
    """One evaluation on an unprepared pair: prepare_volumes, then
    window_cost_prepared (a caller with several evaluations per pair
    prepares once itself).

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    if abc.device != vols.device:
        raise ValueError(f"abc on {abc.device}, the volume on {vols.device}")
    prep = prepare_volumes(imgs_u8, vols, max_costs, half_wnd=half_wnd,
                           max_dis=max_dis, gamma=gamma)
    return window_cost_prepared(prep, abc, half_wnd=half_wnd,
                                max_dis=max_dis, wnd_stride=wnd_stride)


def window_cost_cuda(imgs_u8: torch.Tensor, vols: torch.Tensor,
                     max_costs: torch.Tensor, abc: torch.Tensor,
                     **kw) -> torch.Tensor:
    """window_cost for CUDA tensors only: launches K1 (K3 at wnd_stride >
    1), raises on anything it does not take."""
    check_tensor("abc", abc, (torch.float32,), abc.shape)
    check_tensor("vols", vols, (torch.float32, torch.bfloat16), vols.shape)
    return window_cost(imgs_u8, vols, max_costs, abc, **kw)
