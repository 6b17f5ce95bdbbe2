"""The port's checkpoint and resume (checkpoint.run_pair_resumable) on the
CPU: a killed run resumes bit for bit, a checkpoint of another config or
seed is ignored, and an uninterrupted resumable run equals run_pair bit
for bit (same seed, the same draws).  Twins of tests/test_checkpoint.py's
single-device cases, at its shapes; no JAX is needed: the claim is the
port's own bit-exactness.
"""

import numpy as np
import pytest
import torch

import crossscalepatchmatch_tpu_torch.checkpoint as ck
from crossscalepatchmatch_tpu_torch import CSPMConfig
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.models.pipeline import run_pair_np

torch.set_num_threads(1)


def _pair():
    return make_pair(h=40, w=56, max_dis=8, seed=2)


def _cfg():
    return CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9, max_iter=2,
                      use_pp=True)


def run_saving(pair, cfg, path, seed):
    """run_pair_resumable, keeping each state it checkpoints."""
    saved = {}
    orig = ck.save_state

    def spy(p, state, iteration, cfg2, seed2):
        saved[iteration] = state
        orig(p, state, iteration, cfg2, seed2)

    ck.save_state = spy
    try:
        out = ck.run_pair_resumable(pair.left, pair.right, cfg, path,
                                    seed=seed, device="cpu")
    finally:
        ck.save_state = orig
    return out, saved


@pytest.mark.parametrize("kw", [
    dict(),                                        # rank+exact, deferred
    dict(prop_sweeps=0),                           # rank+exact, refreshed
    dict(adopt_mode="exact"),                      # deferred init
    dict(precompute_volume=False)])                # the no-volume path
def test_uninterrupted_resumable_equals_run_pair(tmp_path, kw):
    pair = _pair()
    cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9, max_iter=3,
                     exact_iters=1, **kw)
    got = ck.run_pair_resumable(pair.left, pair.right, cfg,
                                str(tmp_path / "a.npz"), seed=3,
                                device="cpu")
    want = run_pair_np(pair.left, pair.right, cfg, seed=3, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_resume_rank_exact_bit_exact(tmp_path):
    """Resume across the rank->exact adoption boundary: a checkpoint saved
    inside the rank phase holds rank-unit costs; the boundary's deferred
    entry replays at loop index n_rank, so the resumed run is bit-exact."""
    pair = _pair()
    cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9, max_iter=3,
                     adopt_mode="rank+exact", exact_iters=1)  # it 0, 1 rank
    full = ck.run_pair_resumable(pair.left, pair.right, cfg,
                                 str(tmp_path / "a.npz"), seed=3,
                                 device="cpu")
    p2 = str(tmp_path / "b.npz")
    _, saved = run_saving(pair, cfg, p2, 3)
    assert set(saved) == {0, 1, 2, 3}
    # rewind to iteration 1 (inside the rank phase), then to iteration 2
    # (the boundary itself, rank units), and resume
    for rewind in (1, 2):
        ck.save_state(p2, saved[rewind], rewind, cfg, 3)
        resumed = ck.run_pair_resumable(pair.left, pair.right, cfg, p2,
                                        seed=3, device="cpu")
        for k in ("dis", "abc", "cost"):
            np.testing.assert_array_equal(full[k], resumed[k])


def test_stale_checkpoint_rejected(tmp_path):
    pair = _pair()
    cfg = _cfg()
    p = str(tmp_path / "c.npz")
    ck.run_pair_resumable(pair.left, pair.right, cfg, p, seed=3,
                          device="cpu")
    # a different seed: ignored
    assert ck.load_state(p, cfg, seed=4, device="cpu") is None
    # a different config: ignored
    cfg2 = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=11, max_iter=2)
    assert ck.load_state(p, cfg2, seed=3, device="cpu") is None
    # matching: accepted at the final iteration
    st = ck.load_state(p, cfg, seed=3, device="cpu")
    assert st is not None and st[1] == cfg.max_iter
    assert st[0].abc.shape == (2, 40, 56, 3) and st[0].abc.device.type == "cpu"
    assert ck.load_state(str(tmp_path / "none.npz"), cfg, 3,
                         device="cpu") is None
