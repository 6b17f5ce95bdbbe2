"""Kernels K5, K3 (fly form), K6 and K7: the no-volume window cost of both
views, every pyramid level in one launch (csrc/fly_cost.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel` on
its fly path (`_fly_build`, the strided window, `_fly_build_image` with the
`image_lerp` branch, the Lab weight slab).  Its plain version is
ops.onthefly_cost.fly_plane_cost.  The kernel reads O(H*W) inputs per level
(packed BGR, the f32 gradient, packed Lab) and never builds a volume.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from .. import onthefly_cost, plane_cost
from . import _build, check_tensor, pack_bgr

# Kernel launches by variant, keyed (lerp, lab, strided): lerp "cost" is
# K5, "image" K6, lab the Lab weight slab of K7, strided the window of K3.
# chip_smoke clears and reads it.
launches: collections.Counter = collections.Counter()


def count(lerp: str | None = None, lab: bool | None = None,
          strided: bool | None = None) -> int:
    """Launches whose variant matches every part given: count(lerp="cost")
    for K5, count(lerp="image") K6, count(lab=True) K7, count(strided=True)
    K3; count() all."""
    want = (lerp, lab, strided)
    return sum(n for key, n in launches.items()
               if all(w is None or w == k for w, k in zip(want, key)))

MAX_LEVELS = 8


def fly_cost(fd: onthefly_cost.FlyData, scale_wgts: Sequence[float] | None,
             abc: torch.Tensor, *, half_wnd: int, max_dis: int, gamma: float,
             alpha: float, tau_clr: float, tau_grd: float,
             border_thres: float, lerp: str,
             wnd_stride: int = 1) -> torch.Tensor:
    """No-volume plane cost of K candidate plane fields in both views (see
    ops.onthefly_cost.fly_plane_cost for the arguments).

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    kw = dict(half_wnd=half_wnd, max_dis=max_dis, gamma=gamma, alpha=alpha,
              tau_clr=tau_clr, tau_grd=tau_grd, border_thres=border_thres,
              lerp=lerp, wnd_stride=wnd_stride)
    if abc.device.type == "cpu":
        return onthefly_cost.fly_plane_cost(fd, scale_wgts, abc, **kw)
    return fly_cost_cuda(fd, scale_wgts, abc, **kw)


def fly_cost_cuda(fd: onthefly_cost.FlyData,
                  scale_wgts: Sequence[float] | None, abc: torch.Tensor, *,
                  half_wnd: int, max_dis: int, gamma: float, alpha: float,
                  tau_clr: float, tau_grd: float, border_thres: float,
                  lerp: str, wnd_stride: int = 1) -> torch.Tensor:
    """Launch the fly kernel (see fly_cost); raises ValueError on inputs it
    does not take, RuntimeError on a launch it refuses (more shared memory
    than a block has, for a large half_wnd + max_dis)."""
    _, k, h, w, _ = abc.shape
    n = len(fd.imgs)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{n} levels outside the kernel's [1, {MAX_LEVELS}]")
    if (scale_wgts is None) != (n == 1) or (
            scale_wgts is not None and len(scale_wgts) != n):
        raise ValueError("scale_wgts must be None for one level and hold "
                         "one weight per level for several")
    if len(fd.grds) != n or (fd.wimgs is not None and len(fd.wimgs) != n):
        raise ValueError("imgs, grds and wimgs must have one entry per level")
    if lerp not in ("cost", "image"):
        raise ValueError(f"lerp must be 'cost' or 'image', got {lerp!r}")
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    if not 0 <= half_wnd <= 64:
        raise ValueError(f"half_wnd {half_wnd} outside the kernel's [0, 64]")
    if wnd_stride < 1:
        raise ValueError(f"wnd_stride {wnd_stride} < 1")
    if not 1 <= 2 * k <= 65535:
        raise ValueError(f"K={k} outside the kernel's grid")
    lab = fd.wimgs is not None
    md, shapes = max_dis, []
    for s in range(n):
        # ceil-halved per level, so every fine pixel's center (y >> s,
        # x >> s) lies inside level s
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        check_tensor(f"imgs[{s}]", fd.imgs[s], (torch.uint8,), (2, hs, ws, 3))
        check_tensor(f"grds[{s}]", fd.grds[s], (torch.float32,), (2, hs, ws))
        if lab:
            check_tensor(f"wimgs[{s}]", fd.wimgs[s], (torch.uint8,),
                         (2, hs, ws, 3))
        if lerp == "image" and md > 1 and md >= ws:
            # the kernel wraps a tap modulo the width, HandleBorder by one
            # +-W: the two agree while max_dis < W
            raise ValueError(f"image lerp needs max_dis {md} < width {ws} "
                             f"at level {s}")
        shapes.append((hs, ws, md))
        md //= 2
    lib = _build.load()
    cols = [pack_bgr(im) for im in fd.imgs]
    wgts = [pack_bgr(im) for im in fd.wimgs] if lab else cols
    lut = plane_cost.asw_lut(gamma, abc.device)
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    sat = onthefly_cost.fly_sat_cost(alpha, tau_clr, tau_grd)
    coef = (ctypes.c_float * 6)(alpha, 1.0 - alpha, tau_clr, tau_grd,
                                border_thres, sat)

    def arr(ctype, xs):
        return (ctype * n)(*xs)

    err = lib.cspm_fly_cost(
        arr(ctypes.c_void_p, [c.data_ptr() for c in cols]),
        arr(ctypes.c_void_p, [g.data_ptr() for g in fd.grds]),
        arr(ctypes.c_void_p, [g.data_ptr() for g in wgts]),
        arr(ctypes.c_int, [sh[0] for sh in shapes]),
        arr(ctypes.c_int, [sh[1] for sh in shapes]),
        arr(ctypes.c_int, [sh[2] for sh in shapes]),
        arr(ctypes.c_float, [1.0] if scale_wgts is None
            else [float(x) for x in scale_wgts]),
        n, int(lerp == "image"), int(lab), coef, abc.data_ptr(),
        lut.data_ptr(), out.data_ptr(), k, h, w, half_wnd, wnd_stride,
        _build.stream_of(abc))
    _build.check(err, "cspm_fly_cost")
    launches[(lerp, lab, wnd_stride > 1)] += 1
    return out
