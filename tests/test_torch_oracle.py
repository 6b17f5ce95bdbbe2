"""The port's binding of the native oracle (csrc/cspm_oracle.cc) against the
JAX package's, and the port's CPU volumes and pipeline against the oracle
(the counterparts of tests/test_oracle_native.py).

The oracle implements the reference's sequential semantics: cost volumes
must agree with the port's to f32 rounding (rtol 1e-4, as the JAX test
holds the JAX engine), the end-to-end bad-pixel within the parity bound
0.005.  Skips without g++ (decided in a fixture).
"""

import shutil

import numpy as np
import pytest
import torch

from crossscalepatchmatch_tpu import oracle as joracle
from crossscalepatchmatch_tpu_torch import CostMethod, CSPMConfig, oracle
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np
from crossscalepatchmatch_tpu_torch.ops.color import bgr_to_rgb
from crossscalepatchmatch_tpu_torch.ops.cost_volume import build_volumes


@pytest.fixture(scope="module")
def pair():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return make_pair(h=64, w=96, max_dis=12, seed=11)


@pytest.mark.parametrize("cc", ["GRD", "CEN"])
@pytest.mark.parametrize("right", [False, True])
def test_cost_volume_equals_jax_binding(pair, cc, right):
    got = oracle.cost_volume(pair.left, pair.right, max_dis=12, cc_name=cc,
                             right=right)
    want = joracle.cost_volume(pair.left, pair.right, max_dis=12,
                               cc_name=cc, right=right)
    assert got.dtype == np.float64 and got.shape == (13, 64, 96)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cc", ["GRD", "CEN"])
@pytest.mark.parametrize("right", [False, True])
def test_port_volume_matches_oracle(pair, cc, right):
    want = oracle.cost_volume(pair.left, pair.right, max_dis=12, cc_name=cc,
                              right=right)                 # [D+1, H, W]
    cfg = CSPMConfig(max_dis=12, dis_scale=16, cost_method=CostMethod[cc])
    got = build_volumes(bgr_to_rgb(torch.as_tensor(pair.left)),
                        bgr_to_rgb(torch.as_tensor(pair.right)), 12,
                        cfg)[int(right)]                   # [H, W, D+1]
    got = np.moveaxis(got.double().numpy(), -1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # f32


def test_cost_volume_rejects_mismatched_views(pair):
    with pytest.raises(ValueError):
        oracle.cost_volume(pair.left, pair.right[:, :-1], max_dis=12)


def test_end_to_end_vs_oracle(pair):
    """The port (CPU, its own draws) and the oracle solve the same scene to
    within the parity bound."""
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=15,
                     cost_method=CostMethod.GRD, use_pp=True)
    ours = run_pair_np(pair.left, pair.right, cfg, seed=0, device="cpu")
    oracle_dis = oracle.run_pair(pair.left, pair.right, max_dis=12,
                                 dis_scale=16, cc_name="GRD", use_pp=True,
                                 wnd_size=15, seed=0)
    bad_ours = bad_pixel_rate(ours["dis"][0].astype(np.float32) / 16.0,
                              pair.disp_left, pair.valid_left)
    bad_orc = bad_pixel_rate(oracle_dis[0].astype(np.float32) / 16.0,
                             pair.disp_left, pair.valid_left)
    assert bad_ours <= bad_orc + 0.005, (bad_ours, bad_orc)
    assert bad_orc < 0.15, bad_orc


def test_library_path_keyed_by_host_target(monkeypatch):
    """A library built with -march=native on one host is not taken on a host
    whose g++ resolves -march=native to other target options."""
    here = oracle.library_path()
    assert here == oracle.library_path()
    monkeypatch.setattr(oracle, "_host_target", lambda: "x86_64\n-march= other")
    assert oracle.library_path() != here
