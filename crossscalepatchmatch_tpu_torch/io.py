"""Image I/O: PNG read and write of views and u8 disparity maps (port of
crossscalepatchmatch_tpu.io).

PIL loads RGB; the engine keeps the reference's OpenCV BGR order, so loads
are swapped to BGR and colour writes swapped back.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def read_bgr(path: str) -> np.ndarray:
    """u8[H, W, 3] BGR image."""
    img = np.asarray(Image.open(path).convert("RGB"))
    return img[..., ::-1].copy()


def write_gray(path: str, img_u8: np.ndarray) -> None:
    """Write a u8[H, W] map (e.g. scaled disparity) as an 8-bit PNG."""
    Image.fromarray(np.asarray(img_u8, np.uint8), mode="L").save(path)


def write_bgr(path: str, img_u8: np.ndarray) -> None:
    """Write a u8[H, W, 3] BGR image."""
    rgb = np.ascontiguousarray(np.asarray(img_u8, np.uint8)[..., ::-1])
    Image.fromarray(rgb, mode="RGB").save(path)
