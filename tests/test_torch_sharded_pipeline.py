"""The port's sharded pipeline (crossscalepatchmatch_tpu_torch.parallel)
against the JAX engine's (crossscalepatchmatch_tpu.parallel.tiled), on the
CPU.

The port runs in spawned processes, one rank each, joined by gloo through
a file store (tests/torch_sharded_worker.py); the JAX engine runs on the
conftest's 8 virtual CPU devices with a mesh of the same shape.  The
port's ranks get the JAX engine's draws of their tile
(fold_in(PRNGKey(seed), ty * n_tx + tx), JAX tiled.py:193) as numpy
arrays.

Tolerances (the single-device parity bound, tests/test_torch_pipeline.py):
u8 maps within 1 level on >= 98 % of each view's pixels and bad-pixel
(nonocc) @1px within 0.005 of the JAX engine's: the window costs agree to
~1e-6 relative, so only near-tie adoptions (and the weighted median's
exp-ulp ties) may differ.  The data-only no-volume mesh, the sequence
batch and a resumed run are held byte for byte against the port's own
unsharded or uninterrupted runs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crossscalepatchmatch_tpu.parallel.mesh import make_mesh as j_make_mesh
from crossscalepatchmatch_tpu.parallel.tiled import jit_run_batch_sharded
from crossscalepatchmatch_tpu_torch.data import make_pair
from crossscalepatchmatch_tpu_torch.metrics import bad_pixel_rate
from crossscalepatchmatch_tpu_torch.models.pipeline import (run_pair,
                                                            run_sequence_np)
from crossscalepatchmatch_tpu_torch.models.patchmatch import (
    refinement_magnitudes)
from jax_draws import JaxDraws, config_pair
from torch_sharded_worker import spawn

torch.set_num_threads(1)


def small_kw(**kw):
    base = dict(max_dis=12, dis_scale=16, wnd_size=11, cost_method="GRD",
                use_cs=False, use_pp=False)
    base.update(kw)
    return base


def tile_draws(seed, tile, hw, jcfg, cfg):
    """Everything the port's tile draws on the JAX engine's tile key, as
    numpy arrays (the workers import no JAX)."""
    d = JaxDraws(seed, jcfg)
    d.key = jax.random.fold_in(jax.random.PRNGKey(seed), tile)
    d.iter_keys = jax.random.split(jax.random.split(d.key)[1],
                                   jcfg.max_iter)
    disp, normal = d.init((2, *hw), float(cfg.max_dis), cfg.eps)
    zs, ns = refinement_magnitudes(cfg)
    refine = {}
    for it in range(cfg.max_iter):
        for v in range(2):
            for i in range(len(zs)):
                dz, dn = d.refine(it, v, i, hw, float(zs[i]), float(ns[i]))
                refine[(it, v, i)] = (dz.numpy(), dn.numpy(), zs[i], ns[i])
    return {"init": (disp.numpy(), normal.numpy()), "refine": refine}


def run_both(tmp_path, mesh, kw, pairs, seeds):
    """(port maps, JAX maps), u8[B, 2, H, W] each."""
    jcfg, cfg = config_pair(**kw)
    n_data, n_ty, n_tx = mesh
    l = np.stack([p.left for p in pairs])
    r = np.stack([p.right for p in pairs])
    h, w = l.shape[1:3]
    hw = (h // n_ty, w // n_tx)
    draws = {(s, t): tile_draws(s, t, hw, jcfg, cfg)
             for s in set(seeds) for t in range(n_ty * n_tx)}
    case = dict(job="run_batch_sharded", mesh=mesh, cfg=kw, l=l, r=r,
                seeds=list(seeds), draws=draws)
    got = spawn(case, n_data * n_ty * n_tx, str(tmp_path))
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    jmesh = j_make_mesh(n_data, n_ty, n_tx,
                        devices=jax.devices()[:n_data * n_ty * n_tx])
    want = np.asarray(jit_run_batch_sharded(jcfg, jmesh)(
        jnp.asarray(l), jnp.asarray(r), jnp.asarray(seeds, jnp.int32)))
    return got[0], want, cfg


def assert_parity(got, want, pairs, cfg):
    assert got.shape == want.shape and got.dtype == np.uint8
    for b, p in enumerate(pairs):
        for v in range(2):
            d = np.abs(got[b, v].astype(int) - want[b, v].astype(int))
            assert (d <= 1).mean() >= 0.98, (b, v, (d <= 1).mean())
        truth = ((p.disp_left, p.valid_left), (p.disp_right, p.valid_right))
        for v, (disp, valid) in enumerate(truth):
            bad_got = bad_pixel_rate(got[b, v] / cfg.dis_scale, disp, valid)
            bad_want = bad_pixel_rate(want[b, v] / cfg.dis_scale, disp, valid)
            assert abs(bad_got - bad_want) <= 0.005, (b, v, bad_got,
                                                      bad_want)


@pytest.mark.parametrize("mesh,kw,shape", [
    # 8-row bands: the window halo (9) and the far ring (25) are multi-hop
    ((1, 4, 1), small_kw(wnd_size=19, max_iter=2), (32, 48)),
    ((1, 2, 2), small_kw(use_pp=True, max_iter=2), (32, 48)),
    ((1, 2, 2), small_kw(cost_method="CEN", use_cs=True, use_pp=True,
                         reg_lambda=0.3, scale_num=3), (32, 48)),
    ((2, 2, 1), small_kw(max_iter=2), (32, 48)),
], ids=["1x4x1-multihop", "1x2x2-GRD-PP", "1x2x2-CEN-CS-PP", "2x2x1"])
def test_run_batch_sharded_matches_jax(tmp_path, mesh, kw, shape):
    n_pairs = mesh[0]
    pairs = [make_pair(h=shape[0], w=shape[1], max_dis=12, seed=5 + i)
             for i in range(n_pairs)]
    seeds = [3 + i for i in range(n_pairs)]
    got, want, cfg = run_both(tmp_path, mesh, kw, pairs, seeds)
    assert_parity(got, want, pairs, cfg)


def test_no_volume_data_mesh_equals_run_pair(tmp_path):
    """precompute_volume=False on a data-only mesh runs each pair whole:
    byte-equal to the port's run_pair per pair (JAX
    tests/test_sharded.py:272-289)."""
    kw = small_kw(precompute_volume=False, max_iter=2)
    _, cfg = config_pair(**kw)
    pairs = [make_pair(h=24, w=32, max_dis=12, seed=s) for s in (4, 9)]
    l = np.stack([p.left for p in pairs])
    r = np.stack([p.right for p in pairs])
    got = spawn(dict(job="run_batch_sharded", mesh=(2, 1, 1), cfg=kw, l=l,
                     r=r, seeds=[3, 5]), 2, str(tmp_path))
    assert got[0].shape == (2, 2, 24, 32)
    for b, seed in enumerate((3, 5)):
        ref = run_pair(l[b], r[b], seed, cfg, device="cpu")["dis"].numpy()
        np.testing.assert_array_equal(got[0][b], ref)
        np.testing.assert_array_equal(got[1][b], ref)


def test_sequence_batch_equals_run_sequence_np(tmp_path):
    """Each stream of run_sequence_batch equals run_sequence_np(seed +
    1000003 * b) byte for byte, cold and warm frames (JAX
    tests/test_sharded.py:248-270)."""
    kw = small_kw(max_iter=2)
    _, cfg = config_pair(**kw)
    pairs = [make_pair(h=24, w=32, max_dis=12, seed=s) for s in (4, 9)]
    frames = [(np.stack([p.left for p in pairs]),
               np.stack([p.right for p in pairs]))] * 3
    got = spawn(dict(job="sequence", mesh=(2, 1, 1), cfg=kw, frames=frames,
                     seed=7), 2, str(tmp_path))
    for b, p in enumerate(pairs):
        solo = list(run_sequence_np([(p.left, p.right)] * 3, cfg,
                                    seed=7 + 1000003 * b, device="cpu"))
        for t in range(3):
            for k in ("dis", "abc"):
                np.testing.assert_array_equal(got[0][t][k][b], solo[t][k])
                np.testing.assert_array_equal(got[1][t][k][b], solo[t][k])


def test_resume_is_bit_exact_and_refuses_another_mesh(tmp_path):
    """run_batch_sharded_steps in slices and run_batch_sharded_resumable,
    fresh and rewound to iteration 1, equal the uninterrupted run bit for
    bit; a checkpoint of another mesh is refused.  A (1, 2, 2) mesh with
    the production schedule (rank iteration, then exact ones)."""
    kw = small_kw(use_pp=True)
    pair = make_pair(h=32, w=48, max_dis=12, seed=6)
    case = dict(job="resume", mesh=(1, 2, 2), cfg=kw, l=pair.left[None],
                r=pair.right[None], seeds=[2], slices=[(0, 0), (0, 1),
                                                       (1, 3)],
                rewind=1, ckpt=str(tmp_path / "ck"))
    got = spawn(case, 4, str(tmp_path))
    for res in got:
        assert res["iterations"] == [0, 1, 2, 3]
        for k in ("sliced", "fresh", "resumed"):
            np.testing.assert_array_equal(res[k], res["full"])
        assert res["refused"] is not None and "mesh" in res["refused"]
