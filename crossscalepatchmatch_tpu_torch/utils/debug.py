"""Debug and introspection utilities (the port's crossscalepatchmatch_tpu
utils/debug.py, in numpy).

The reference gates visual and per-pixel debugging behind MY_DEBUG:
ViewDisp shows the current disparity map, PrintPixelInfo dumps one
pixel's plane and cost (cs_patchmatch.h:25-53, call sites
cs_patchmatch.cc:56-101), PrintMat dumps a matrix (commfunc.h:91-104),
and VIEW_PP dumps post-processing intermediates (cs_patchmatch.cc:
518-540).  The analogues below take run_pair's output dict (tensors, on
any device) or run_pair_np's (arrays).
"""

from __future__ import annotations

import sys

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out_np(out: dict) -> dict:
    return {k: _np(v) for k, v in out.items()}


def print_array(name: str, arr, file=sys.stderr) -> None:
    """PrintMat analogue: shape/dtype/range summary plus small-array dump."""
    a = _np(arr)
    print(f"{name}: shape={a.shape} dtype={a.dtype} "
          f"min={a.min():.6g} max={a.max():.6g} mean={a.mean():.6g}",
          file=file)
    if a.size <= 400:
        print(np.array2string(a, precision=4, suppress_small=True),
              file=file)


def pixel_info(out: dict, x: int, y: int, dis_scale: int = 1,
               file=sys.stderr) -> dict:
    """PrintPixelInfo analogue: one pixel's plane, disparity, and cost.

    Args:
      out: run_pair's or run_pair_np's output dict ("abc", "cost", "dis",
        optionally "valid").
      dis_scale: the config's output scale, so the plane disparity can be
        printed in the same scaled units as the u8 map for comparison.
    """
    out = _out_np(out)
    info = {}
    for v, view in enumerate(("left", "right")):
        a, b, c = (float(t) for t in out["abc"][v, y, x])
        d = a * x + b * y + c
        info[view] = {
            "abc": (a, b, c),
            "disparity": d,
            "dis_scaled": d * dis_scale,
            "dis_u8": int(out["dis"][v, y, x]),
            "min_cost": float(out["cost"][v, y, x]),
        }
        if "valid" in out:
            info[view]["valid"] = bool(out["valid"][v, y, x])
        print(f"({x},{y}) {view}: d={d:.4f} (x{dis_scale} = "
              f"{d * dis_scale:.2f}, map u8 = {info[view]['dis_u8']}) "
              f"plane=({a:.4f},{b:.4f},{c:.4f})"
              f" cost={info[view]['min_cost']:.6g}"
              + (f" valid={info[view].get('valid')}" if "valid" in out
                 else ""),
              file=file)
    return info


def disparity_to_color(dis, max_val: int | None = None) -> np.ndarray:
    """ViewDisp analogue: u8 disparity map -> u8[H, W, 3] RGB turbo-ish
    colormap (near = warm, far = cold), for visual inspection dumps."""
    d = _np(dis).astype(np.float32)
    mx = float(max_val if max_val is not None else max(d.max(), 1.0))
    t = np.clip(d / mx, 0.0, 1.0)
    # compact 4-stop gradient: dark blue -> cyan -> yellow -> red
    stops = np.array([[0, 0, 96], [0, 208, 208], [240, 240, 0],
                      [224, 0, 0]], np.float32)
    pos = t * 3.0
    i = np.clip(pos.astype(np.int32), 0, 2)
    f = (pos - i)[..., None]
    rgb = stops[i] * (1.0 - f) + stops[i + 1] * f
    return rgb.astype(np.uint8)


def save_debug_dumps(out: dict, prefix: str) -> list:
    """VIEW_PP analogue: write disparity (gray + color) and validity maps
    through the port's io.

    Returns the list of files written ("<prefix>_{l,r}_{dis,color,valid}.png").
    """
    from .. import io as cio

    out = _out_np(out)
    written = []
    dis = out["dis"]
    for v, tag in enumerate(("l", "r")):
        p = f"{prefix}_{tag}_dis.png"
        cio.write_gray(p, dis[v])
        written.append(p)
        pc = f"{prefix}_{tag}_color.png"
        # io writes BGR; the colour map is RGB
        cio.write_bgr(pc, disparity_to_color(dis[v])[..., ::-1])
        written.append(pc)
        if "valid" in out:
            pv = f"{prefix}_{tag}_valid.png"
            cio.write_gray(pv, out["valid"][v].astype(np.uint8) * 255)
            written.append(pv)
    return written
