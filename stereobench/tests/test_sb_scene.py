"""The frozen scene generator gives the program's data.make_pair arrays."""

import numpy as np
import pytest

from crossscalepatchmatch_tpu_torch.data import make_pair
from stereobench.scene import make_scene

FIELDS = ("left", "right", "disp_left", "disp_right", "valid_left",
          "valid_right")


@pytest.mark.parametrize("h, w, max_dis, seed, n_fg, sigma", [
    (40, 57, 16, 3, 2, 1.0), (96, 128, 16, 0, 2, 1.0),
    (61, 90, 30, 7, 4, 0.0), (50, 70, 12, 2 ** 40 + 5, 1, 1.0),
    (33, 31, 8, 11, 3, 2.5), (120, 160, 60, 2 ** 33 + 1, 2, 0.0)])
def test_scene_equals_make_pair(h, w, max_dis, seed, n_fg, sigma):
    a = make_scene(h, w, max_dis, seed, n_fg, noise_sigma=sigma)
    b = make_pair(h=h, w=w, max_dis=max_dis, seed=seed, n_fg=n_fg,
                  noise_sigma=sigma)
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
