"""Kernels K5, K3 (fly form), K6 and K7: the no-volume window cost of both
views, every pyramid level in one launch (csrc/fly_cost.cu).

Replaces crossscalepatchmatch_tpu/ops/pallas/window_cost.py `_kernel` on
its fly path (`_fly_build`, the strided window, `_fly_build_image` with the
`image_lerp` branch, the Lab weight slab).  Its plain version is
ops.onthefly_cost.fly_plane_cost.  The kernel reads O(H*W) inputs per level
(packed BGR interleaved with the f32 gradient, packed Lab) and never builds
a volume.

`prepare_fly` does once per pair what does not depend on the candidates
(the JAX package's `prepare_fly`): it checks the levels, packs the images
into the kernel's layout, builds the weight table and the per-level
argument arrays; `fly_cost_prepared` then only launches.  On CPU tensors
the same object routes to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from .. import onthefly_cost, plane_cost
from . import _build, check_half_wnd, check_tensor, pack_bgr

# Kernel launches by variant, keyed (lerp, lab, strided): lerp "cost" is
# K5, "image" K6, lab the Lab weight slab of K7, strided the window of K3.
# The GPU tier clears and reads it.
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
# trunc(dq) is read from the mantissa of dq + 2^23 (csrc/window_common.cuh)
MAX_DIS_LIMIT = 1 << 22


def interleave_ref(img_u8: torch.Tensor, grd: torch.Tensor) -> torch.Tensor:
    """u8[..., 3] BGR and f32[...] gradient -> i32[..., 2]: per pixel the
    packed colour word and the gradient's bits, the 8 bytes the kernel
    stages with one load."""
    return torch.stack([pack_bgr(img_u8), grd.contiguous().view(torch.int32)],
                       dim=-1).contiguous()


@dataclasses.dataclass
class PreparedFly:
    """What the fly cost needs per pair (see prepare_fly)."""

    fd: onthefly_cost.FlyData
    scale_wgts: Tuple[float, ...] | None
    half_wnd: int
    max_dis: int
    kw: dict    # gamma, alpha, tau_clr, tau_grd, border_thres, lerp
    hw: Tuple[int, int]            # fine-level (H, W)
    device: torch.device
    # the kernel's side: the tensors its argument arrays point into (the
    # weight table last), and the arrays
    tensors: List[torch.Tensor] = dataclasses.field(default_factory=list)
    args: tuple = ()

    @property
    def levels(self) -> int:
        return len(self.fd.imgs)


def prepare_fly(fd: onthefly_cost.FlyData,
                scale_wgts: Sequence[float] | None, *, half_wnd: int,
                max_dis: int, gamma: float, alpha: float, tau_clr: float,
                tau_grd: float, border_thres: float,
                lerp: str) -> PreparedFly:
    """Everything of the fly cost that does not depend on the candidates
    (see ops.onthefly_cost.fly_plane_cost for the arguments); raises
    ValueError on inputs the kernel does not take."""
    n = len(fd.imgs)
    dev = fd.imgs[0].device
    h, w = fd.imgs[0].shape[1:3]
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
    check_half_wnd(half_wnd, dev)
    if not 0 <= max_dis < MAX_DIS_LIMIT:
        raise ValueError(f"max_dis {max_dis} outside [0, {MAX_DIS_LIMIT})")
    prep = PreparedFly(
        fd=fd, scale_wgts=(None if scale_wgts is None
                           else tuple(float(x) for x in scale_wgts)),
        half_wnd=half_wnd, max_dis=max_dis,
        kw=dict(gamma=gamma, alpha=alpha, tau_clr=tau_clr, tau_grd=tau_grd,
                border_thres=border_thres, lerp=lerp),
        hw=(h, w), device=dev)
    lab = fd.wimgs is not None
    md, shapes = max_dis, []
    for s in range(n):
        # ceil-halved per level, so every fine pixel's center (y >> s,
        # x >> s) lies inside level s
        hs, ws = ((h - 1) >> s) + 1, ((w - 1) >> s) + 1
        if dev.type != "cpu":
            check_tensor(f"imgs[{s}]", fd.imgs[s], (torch.uint8,),
                         (2, hs, ws, 3))
            check_tensor(f"grds[{s}]", fd.grds[s], (torch.float32,),
                         (2, hs, ws))
            if lab:
                check_tensor(f"wimgs[{s}]", fd.wimgs[s], (torch.uint8,),
                             (2, hs, ws, 3))
        if dev.type != "cpu" and lerp == "image" and md > 1 and md >= ws:
            # the kernel wraps a tap modulo the width, HandleBorder by one
            # +-W: the two agree while max_dis < W
            raise ValueError(f"image lerp needs max_dis {md} < width {ws} "
                             f"at level {s}")
        shapes.append((hs, ws, md))
        md //= 2
    refs = [interleave_ref(im, g) for im, g in zip(fd.imgs, fd.grds)]
    wgts = [pack_bgr(im) for im in fd.wimgs] if lab else refs
    lut = plane_cost.asw_lut(gamma, dev)
    sat = onthefly_cost.fly_sat_cost(alpha, tau_clr, tau_grd)

    def arr(ctype, xs):
        return (ctype * n)(*xs)

    prep.tensors = [*refs, *wgts, lut]
    prep.args = (
        arr(ctypes.c_void_p, [t.data_ptr() for t in refs]),
        arr(ctypes.c_void_p, [t.data_ptr() for t in wgts]),
        arr(ctypes.c_int, [sh[0] for sh in shapes]),
        arr(ctypes.c_int, [sh[1] for sh in shapes]),
        arr(ctypes.c_int, [sh[2] for sh in shapes]),
        arr(ctypes.c_float, prep.scale_wgts or [1.0]),
        n, int(lerp == "image"), int(lab),
        (ctypes.c_float * 6)(alpha, 1.0 - alpha, tau_clr, tau_grd,
                             border_thres, sat))
    return prep


def fly_cost_prepared(prep: PreparedFly, abc: torch.Tensor, *, half_wnd: int,
                      max_dis: int, levels: int,
                      wnd_stride: int = 1) -> torch.Tensor:
    """No-volume plane cost of K candidate plane fields in both views on a
    prepared pair.  The caller restates the geometry it assumes (half_wnd,
    max_dis, the level count); a mismatch with the prepared object, or
    planes of another shape or device, raises ValueError.

    Returns:
      f32[2, K, H, W].  A pair prepared from CPU tensors takes the plain
      version, one from CUDA tensors the kernel.
    """
    if (half_wnd, max_dis, levels) != (prep.half_wnd, prep.max_dis,
                                       prep.levels):
        raise ValueError(
            f"call with half_wnd={half_wnd}, max_dis={max_dis}, "
            f"levels={levels} on a pair prepared for "
            f"half_wnd={prep.half_wnd}, max_dis={prep.max_dis}, "
            f"levels={prep.levels}")
    if abc.device != prep.device:
        raise ValueError(f"abc on {abc.device}, the pair on {prep.device}")
    if abc.dim() != 5 or tuple(abc.shape[2:4]) != prep.hw:
        raise ValueError(f"abc shape {tuple(abc.shape)} does not match the "
                         f"prepared (H, W) = {prep.hw}")
    if wnd_stride < 1:
        raise ValueError(f"wnd_stride {wnd_stride} < 1")
    if prep.device.type == "cpu":
        return onthefly_cost.fly_plane_cost(
            prep.fd, prep.scale_wgts, abc, half_wnd=half_wnd,
            max_dis=max_dis, wnd_stride=wnd_stride, **prep.kw)
    k = abc.shape[1]
    h, w = prep.hw
    check_tensor("abc", abc, (torch.float32,), (2, k, h, w, 3))
    if not 1 <= 2 * k <= 65535:
        raise ValueError(f"K={k} outside the kernel's grid")
    lib = _build.load()
    out = torch.empty((2, k, h, w), dtype=torch.float32, device=abc.device)
    lab = prep.fd.wimgs is not None
    err = lib.cspm_fly_cost(
        *prep.args, abc.data_ptr(), prep.tensors[-1].data_ptr(),
        out.data_ptr(), k, h, w, half_wnd, wnd_stride, _build.stream_of(abc))
    _build.check(err, "cspm_fly_cost")
    launches[(prep.kw["lerp"], lab, wnd_stride > 1)] += 1
    return out


def fly_cost(fd: onthefly_cost.FlyData, scale_wgts: Sequence[float] | None,
             abc: torch.Tensor, *, half_wnd: int, max_dis: int, gamma: float,
             alpha: float, tau_clr: float, tau_grd: float,
             border_thres: float, lerp: str,
             wnd_stride: int = 1) -> torch.Tensor:
    """One evaluation on an unprepared pair: prepare_fly, then
    fly_cost_prepared (a caller with several evaluations per pair prepares
    once itself).

    Returns:
      f32[2, K, H, W].  CPU tensors take the plain version, CUDA tensors
      the kernel.
    """
    prep = prepare_fly(fd, scale_wgts, half_wnd=half_wnd, max_dis=max_dis,
                       gamma=gamma, alpha=alpha, tau_clr=tau_clr,
                       tau_grd=tau_grd, border_thres=border_thres, lerp=lerp)
    return fly_cost_prepared(prep, abc, half_wnd=half_wnd, max_dis=max_dis,
                             levels=prep.levels, wnd_stride=wnd_stride)


def fly_cost_cuda(fd: onthefly_cost.FlyData,
                  scale_wgts: Sequence[float] | None, abc: torch.Tensor,
                  **kw) -> torch.Tensor:
    """fly_cost for CUDA tensors only: launches the kernel, raises
    ValueError on inputs it does not take, RuntimeError on a launch it
    refuses (more shared memory than a block has, for a large half_wnd +
    max_dis)."""
    check_tensor("abc", abc, (torch.float32,), abc.shape)
    check_tensor("imgs[0]", fd.imgs[0], (torch.uint8,), fd.imgs[0].shape)
    return fly_cost(fd, scale_wgts, abc, **kw)
