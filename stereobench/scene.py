"""Synthetic rectified stereo scenes with exact ground truth: a frozen,
vectorised copy of the port's `data.make_pair` (same arguments, same
arrays, for the arguments kept here).

A scene is a slanted background plane and `n_fg` fronto-parallel boxes,
each layer textured with its own multi-octave value noise.  The left view
samples each layer's texture at x + 2; the right view is the forward warp
of the left layers (a z-buffer on disparity, the first column winning a
tie), occluded right pixels showing the background's texture; sensor noise
of `noise_sigma` is added to each view before it is cut to u8.  The loops
of the original over pixels are array operations here: the random draws,
their order and the floating-point steps are the original's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scene:
    left: np.ndarray        # u8[H, W, 3] (BGR, as the engine reads it)
    right: np.ndarray       # u8[H, W, 3]
    disp_left: np.ndarray   # f32[H, W] ground-truth left disparity
    disp_right: np.ndarray  # f32[H, W] ground-truth right disparity
    valid_left: np.ndarray  # bool[H, W] non-occluded in the left view
    valid_right: np.ndarray


def _smooth_noise(rng: np.random.Generator, h: int, w: int,
                  octaves: int = 4) -> np.ndarray:
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        step = 1 << (octaves - o)
        gh, gw = h // step + 2, w // step + 2
        grid = rng.random((gh, gw), np.float32)
        ys = np.arange(h) / step
        xs = np.arange(w) / step
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
             + grid[y0 + 1][:, x0] * fy * (1 - fx)
             + grid[y0][:, x0 + 1] * (1 - fy) * fx
             + grid[y0 + 1][:, x0 + 1] * fy * fx)
        out += amp * g
        amp *= 0.5
    return (out - out.min()) / max(float(np.ptp(out)), 1e-6)


def make_scene(h: int, w: int, max_dis: int, seed: int, n_fg: int = 2,
               noise_sigma: float = 1.0) -> Scene:
    """The port's data.make_pair(h, w, max_dis, seed, slanted=True, n_fg,
    noise_sigma=noise_sigma) with its other arguments at their defaults.
    Disparities lie in [1, max_dis - 1]."""
    rng = np.random.default_rng(seed)
    tex_w = w + max_dis + 4
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]

    lo, hi = 1.0, max_dis - 1.0
    span = hi - lo
    bg = lo + 0.15 * span + 0.25 * span * (xs / w) + 0.10 * span * (ys / h)
    disp_left = np.broadcast_to(bg, (h, w)).copy()
    boxes = [
        (h // 5, h // 2 + h // 8, w // 6, w // 2, 0.6),
        (h // 2, h - h // 6, w // 2, w - w // 8, 0.9),
        (h // 8, h // 3, w // 2 + w // 8, w - w // 12, 0.75),
        (h // 2 + h // 8, h - h // 8, w // 12, w // 3, 0.95),
    ][:max(1, min(n_fg, 4))]
    label = np.zeros((h, w), np.int8)
    for i, (y0, y1, x0, x1, dep) in enumerate(boxes, start=1):
        disp_left[y0:y1, x0:x1] = np.float32(lo + dep * span)
        label[y0:y1, x0:x1] = i

    texs = []
    for _ in range(len(boxes) + 1):
        base = np.stack([_smooth_noise(rng, h, tex_w) for _ in range(3)], -1)
        tint = rng.uniform(0.4, 1.0, (1, 1, 3))
        texs.append(np.clip(base * tint * 255.0, 0, 255))

    left = np.zeros((h, w, 3), np.float32)
    for lab, tex in enumerate(texs):
        m = label == lab
        left[m] = tex[:, 2:w + 2][m]

    # forward warp: each left pixel lands at round(x - d) in the right view;
    # per target the largest disparity wins, the first column on a tie
    x_i = np.arange(w)
    xr = np.rint(x_i.astype(np.float32)[None, :] - disp_left).astype(np.int64)
    yy, xx = np.nonzero((xr >= 0) & (xr < w))
    tgt = yy * w + xr[yy, xx]
    order = np.lexsort((xx, -disp_left[yy, xx], tgt))
    first = np.ones(order.size, bool)
    first[1:] = tgt[order[1:]] != tgt[order[:-1]]
    win = order[first]
    src_of = np.full(h * w, -1, np.int64)
    src_of[tgt[win]] = xx[win]
    src_of = src_of.reshape(h, w)

    right = np.zeros((h, w, 3), np.float32)
    disp_right = np.full((h, w), -1.0, np.float32)
    ry, rx = np.nonzero(src_of >= 0)
    sx = src_of[ry, rx]
    d = disp_left[ry, sx]
    tx = (sx + 2) - (d.astype(np.float64) - (sx - rx))
    tx = np.clip(tx, 0, tex_w - 2)
    t0 = np.floor(tx).astype(np.int64)
    f = (tx - t0)[:, None]
    lab = label[ry, sx]
    for k, tex in enumerate(texs):
        m = lab == k
        right[ry[m], rx[m]] = ((1 - f[m]) * tex[ry[m], t0[m]]
                               + f[m] * tex[ry[m], t0[m] + 1])
    disp_right[ry, rx] = d
    oy, ox = np.nonzero(src_of < 0)
    right[oy, ox] = texs[0][oy, ox]

    valid_left = np.zeros((h, w), bool)
    valid_left[ry, sx] = True
    valid_right = disp_right >= 0
    disp_right = np.where(valid_right, disp_right, 0.0)

    noise = rng.normal(0, noise_sigma, (h, w, 3))
    left = np.clip(left + noise, 0, 255).astype(np.uint8)
    right = np.clip(right + rng.normal(0, noise_sigma, (h, w, 3)), 0,
                    255).astype(np.uint8)
    return Scene(left=left, right=right,
                 disp_left=disp_left.astype(np.float32),
                 disp_right=disp_right.astype(np.float32),
                 valid_left=valid_left, valid_right=valid_right)
