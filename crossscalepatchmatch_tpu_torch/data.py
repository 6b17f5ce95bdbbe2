"""Synthetic rectified stereo pairs with ground-truth disparity (the port's
own copy of crossscalepatchmatch_tpu.data; pure NumPy, the same arrays for
the same arguments).

Textured fronto-parallel / slanted layers composited with correct occlusion
handling, so bad-pixel rates can be scored against exact ground truth.
Layers are defined in left-view coordinates with per-pixel disparity d
(x_left = x_right + d, grd_cc.cpp:94-96); the right view samples the same
texture shifted by d with nearer (larger-d) layers winning, and the
right-view disparity and occlusion maps come from forward-warping.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StereoPair:
    left: np.ndarray        # u8[H, W, 3]
    right: np.ndarray       # u8[H, W, 3]
    disp_left: np.ndarray   # f32[H, W] ground-truth left disparity
    disp_right: np.ndarray  # f32[H, W] ground-truth right disparity
    valid_left: np.ndarray  # bool[H, W] non-occluded in left view
    valid_right: np.ndarray


def _smooth_noise(rng: np.random.Generator, h: int, w: int,
                  octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [0, 1] for natural-ish texture."""
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


def make_pair(h: int = 96, w: int = 128, max_dis: int = 16,
              seed: int = 0, slanted: bool = True, n_fg: int = 2,
              texture_contrast: float = 1.0,
              noise_sigma: float = 1.0,
              exposure_gain: float = 1.0,
              exposure_bias: float = 0.0,
              rect_jitter: float = 0.0,
              textures: list | None = None) -> StereoPair:
    """Layered synthetic scene: background plane + n_fg foreground objects.

    Disparities stay within [1, max_dis - 1] so every non-occluded pixel is
    recoverable.

    Args:
      n_fg: foreground object count (1-4; more gives more occlusions).
      texture_contrast: scales texture contrast around its mean (~0.3 gives
        low-texture scenes).
      noise_sigma: std-dev of the Gaussian sensor noise added to each view.
      exposure_gain / exposure_bias: photometric mismatch of the RIGHT view
        only (right' = right * gain + bias).
      rect_jitter: peak vertical rectification error in pixels (the right
        view is resampled at y + jitter(x); the ground truth stays ideal).
      textures: optional per-layer textures, each f32[h, w + max_dis + 4, 3];
        None keeps the procedural value noise.
    """
    rng = np.random.default_rng(seed)
    tex_w = w + max_dis + 4

    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]

    # --- layer disparity fields in left coordinates -----------------------
    lo, hi = 1.0, max_dis - 1.0
    span = hi - lo
    if slanted:
        bg = lo + 0.15 * span + 0.25 * span * (xs / w) + 0.10 * span * (ys / h)
        bg = np.broadcast_to(bg, (h, w)).copy()
    else:
        bg = np.full((h, w), lo + 0.25 * span, np.float32)
    layer_disps = [None]                      # bg handled separately
    layer_masks = [None]
    boxes = [                                 # (y0, y1, x0, x1, depth)
        (h // 5, h // 2 + h // 8, w // 6, w // 2, 0.6),
        (h // 2, h - h // 6, w // 2, w - w // 8, 0.9),
        (h // 8, h // 3, w // 2 + w // 8, w - w // 12, 0.75),
        (h // 2 + h // 8, h - h // 8, w // 12, w // 3, 0.95),
    ][:max(1, min(n_fg, 4))]
    for (y0, y1, x0, x1, dep) in boxes:
        m = np.zeros((h, w), bool)
        m[y0:y1, x0:x1] = True
        layer_masks.append(m)
        layer_disps.append(np.full((h, w), lo + dep * span, np.float32))

    disp_left = bg.copy()
    for m, dsp in zip(layer_masks[1:], layer_disps[1:]):
        disp_left[m] = dsp[m]
    if not slanted:
        disp_left = np.rint(disp_left)

    # --- per-layer textures (layers carry their own texture) --------------
    def layer_tex(k):
        if textures is not None:
            tex = np.asarray(textures[k % len(textures)], np.float32)
            if tex.shape[0] < h or tex.shape[1] < tex_w:
                raise ValueError(
                    f"texture {tex.shape} smaller than ({h}, {tex_w})")
            tex = tex[:h, :tex_w]
        else:
            base = np.stack([_smooth_noise(rng, h, tex_w)
                             for _ in range(3)], -1)
            tint = rng.uniform(0.4, 1.0, (1, 1, 3))
            tex = np.clip(base * tint * 255.0, 0, 255)
        if texture_contrast != 1.0:
            tex = np.clip(tex.mean()
                          + (tex - tex.mean()) * texture_contrast, 0, 255)
        return tex

    texs = [layer_tex(k) for k in range(len(layer_masks))]

    label = np.zeros((h, w), np.int8)
    for i, m in enumerate(layer_masks[1:], start=1):
        label[m] = i

    xs_i = np.arange(w)

    # Left view: each layer's texture at x + 2 (a fixed offset keeps the
    # sampling in-bounds for both views).
    left = np.zeros((h, w, 3), np.float32)
    for y in range(h):
        for lab in range(len(texs)):
            m = label[y] == lab
            left[y, m] = texs[lab][y, xs_i[m] + 2]

    # Right view + right disparity by forward warp (z-buffer on disparity).
    right = np.zeros((h, w, 3), np.float32)
    disp_right = np.full((h, w), -1.0, np.float32)
    zbuf = np.full((h, w), -1e9, np.float32)
    src_of = np.full((h, w), -1, np.int64)
    for y in range(h):
        for x in range(w):
            d = disp_left[y, x]
            xr = int(round(x - d))
            if 0 <= xr < w and d > zbuf[y, xr]:
                zbuf[y, xr] = d
                src_of[y, xr] = x
    for y in range(h):
        for xr in range(w):
            x = src_of[y, xr]
            if x >= 0:
                lab = label[y, x]
                d = disp_left[y, x]
                # sub-pixel texture sample for slanted surfaces
                tx = x + 2 - (d - (x - xr))
                tx = np.clip(tx, 0, tex_w - 2)
                t0 = int(np.floor(tx))
                f = tx - t0
                right[y, xr] = ((1 - f) * texs[lab][y, t0]
                                + f * texs[lab][y, t0 + 1])
                disp_right[y, xr] = d
            else:
                # occluded in right view: fill with background texture
                right[y, xr] = texs[0][y, xr]

    # Left-view occlusion: a left pixel is valid iff it wins the z-buffer.
    valid_left = np.zeros((h, w), bool)
    for y in range(h):
        for xr in range(w):
            if src_of[y, xr] >= 0:
                valid_left[y, src_of[y, xr]] = True
    valid_right = disp_right >= 0
    disp_right = np.where(valid_right, disp_right, 0.0)

    if rect_jitter != 0.0:
        # vertical mis-rectification: resample right rows at y + off(x),
        # smooth across columns, zero-mean; edge rows clamp.
        off = rect_jitter * np.sin(
            2.0 * np.pi * np.arange(w, dtype=np.float32) / w)
        yq = np.clip(ys + off[None, :], 0.0, h - 1.0)
        y0 = np.floor(yq).astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        fy = (yq - y0)[..., None]
        cols = np.broadcast_to(xs_i[None, :], (h, w))
        right = ((1.0 - fy) * right[y0, cols]
                 + fy * right[y1, cols])
    if exposure_gain != 1.0 or exposure_bias != 0.0:
        right = right * exposure_gain + exposure_bias

    noise = rng.normal(0, noise_sigma, (h, w, 3))
    left = np.clip(left + noise, 0, 255).astype(np.uint8)
    right = np.clip(right + rng.normal(0, noise_sigma, (h, w, 3)), 0,
                    255).astype(np.uint8)
    return StereoPair(left=left, right=right,
                      disp_left=disp_left.astype(np.float32),
                      disp_right=disp_right.astype(np.float32),
                      valid_left=valid_left, valid_right=valid_right)
