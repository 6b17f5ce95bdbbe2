"""Iteration-level checkpoint and resume of the optimizer state, on one
device or on a (data, ty, tx) mesh (port of
crossscalepatchmatch_tpu.checkpoint).

The (plane, cost) state is saved after every outer iteration, and a killed
run resumes bit for bit: the port's draws are keyed by iteration
(utils.rng), so iterations i..N draw the same numbers whether or not the
process restarted.

Format: one .npz per checkpoint (abc, cost, iteration, seed and a config
fingerprint, the JSON of dataclasses.asdict), written to a temporary file
and renamed over the old one, so a reader never sees half a file.  On a
mesh each rank writes its own file of its blocks' state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from .config import CSPMConfig
from .models import patchmatch as pm
from .models.pipeline import _finalize, _make_cost_fns, _on_device
from .utils.rng import TorchDraws


def _fingerprint(cfg: CSPMConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), default=str, sort_keys=True)


def save_state(path: str, state: pm.PMState, iteration: int,
               cfg: CSPMConfig, seed: int) -> None:
    """Atomically write (state, iteration, seed, config fingerprint)."""
    _save(path, abc=state.abc.cpu().numpy(), cost=state.cost.cpu().numpy(),
          iteration=np.int64(iteration), seed=np.int64(seed),
          cfg=np.bytes_(_fingerprint(cfg).encode()))


def _save(path: str, **arrays) -> None:
    """Write an .npz to a temporary file and rename it over `path`."""
    tmp_fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
    os.close(tmp_fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, cfg: CSPMConfig, seed: int, *,
               device="cuda") -> Optional[Tuple[pm.PMState, int]]:
    """(state on `device`, iteration) of a checkpoint; None if the file is
    absent or from another config or seed."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if (z["cfg"].item().decode() != _fingerprint(cfg)
                or int(z["seed"]) != seed):
            return None
        state = pm.PMState(abc=torch.from_numpy(z["abc"]).to(device),
                           cost=torch.from_numpy(z["cost"]).to(device))
        return state, int(z["iteration"])


def run_pair_resumable(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig, ckpt_path: str,
                       seed: int = 0, *, device="cuda", draws=None):
    """run_pair with a checkpoint after every iteration, resuming from
    `ckpt_path` when it holds this config's and seed's state.

    The volumes (or channel planes) are built and prepared once, and the
    optimizer (models.patchmatch.patchmatch) continues from the saved
    iteration; the entry into the exact phase after rank adoption happens
    at its iteration whether or not the process restarted in between, so a
    resumed run equals the uninterrupted one bit for bit.

    Args:
      draws: draw source (utils.rng); TorchDraws(seed, device) if None.

    Returns:
      run_pair's dict as NumPy arrays.
    """
    device, l, r = _on_device(l_bgr_u8, r_bgr_u8, cfg, device)
    if draws is None:
        draws = TorchDraws(seed, device)
    h, w, _ = l.shape
    cost_fn, sparse_fn, pp_imgs = _make_cost_fns(l, r, cfg)
    state = pm.patchmatch(
        draws, (h, w), cost_fn, cfg, sparse_fn, device=device,
        start=load_state(ckpt_path, cfg, seed, device=device),
        on_iteration=lambda st, i: save_state(ckpt_path, st, i, cfg, seed))
    out = _finalize(state, pp_imgs, cfg)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_batch_sharded_resumable(l_bgr, r_bgr, seeds, cfg: CSPMConfig, mesh,
                                ckpt_path: str, *, device="cuda",
                                draws=None):
    """parallel.tiled.run_batch_sharded with a checkpoint after every
    iteration, resuming bit for bit (JAX checkpoint.py:62-162).

    Each rank writes `{ckpt_path}.rank{r}` with its blocks' (abc, cost) of
    each of its pairs, the iteration, the config fingerprint, the mesh
    shape and the seeds; a rerun on the same mesh reloads the rank's own
    file.  A file of another config, mesh or batch raises ValueError.  One
    call of parallel.tiled.run_batch_sharded_steps runs the rest of the
    schedule (the volumes built once) and saves after each iteration.

    Returns u8[B, 2, H, W] like run_batch_sharded; None at once on a rank
    outside the mesh (which reads and writes no file).
    """
    import torch.distributed as dist

    from .parallel.tiled import run_batch_sharded_steps

    if mesh.get_coordinate() is None:
        return None
    path = f"{ckpt_path}.rank{dist.get_rank()}"
    meta = dict(cfg=np.bytes_(_fingerprint(cfg).encode()),
                mesh=np.asarray(mesh.shape, np.int64),
                seeds=np.asarray(torch.as_tensor(seeds).cpu(),
                                 np.int64).reshape(-1))
    state, start = None, 0
    if os.path.exists(path):
        with np.load(path) as z:
            for key, want in meta.items():
                if not np.array_equal(z[key], want):
                    raise ValueError(f"{path}: a checkpoint of another "
                                     f"{key} ({z[key]} != {want})")
            start = int(z["iteration"])
            state = _global_state(z["abc"], z["cost"], np.shape(l_bgr)[1:3],
                                  mesh)

    def save(states, iteration):
        _save(path, abc=np.stack([st.abc.cpu().numpy() for st in states]),
              cost=np.stack([st.cost.cpu().numpy() for st in states]),
              iteration=np.int64(iteration), **meta)

    return run_batch_sharded_steps(l_bgr, r_bgr, seeds, cfg, mesh, state,
                                   start, finalize=True, device=device,
                                   draws=draws, on_iteration=save)


def _global_state(abc: np.ndarray, cost: np.ndarray, hw, mesh):
    """A rank's saved blocks (f32[P, 2, Hs, Ws, ...], P its pairs) placed
    in global (abc, cost) arrays, zeros elsewhere (a rank reads only its
    own blocks); rank = (d * n_ty + ty) * n_tx + tx, parallel.mesh."""
    n_data, n_ty, n_tx = mesh.shape
    d, ty, tx = mesh.get_coordinate()
    per, _, hs, ws = cost.shape
    out = []
    for a in (abc, cost):
        g = np.zeros((per * n_data, 2, *hw, *a.shape[4:]), a.dtype)
        g[d * per:(d + 1) * per, :, ty * hs:(ty + 1) * hs,
          tx * ws:(tx + 1) * ws] = a
        out.append(g)
    return tuple(out)
