"""Iteration-level checkpoint and resume of the optimizer state, one device
(port of crossscalepatchmatch_tpu.checkpoint without the sharded parts).

The (plane, cost) state is saved after every outer iteration, and a killed
run resumes bit for bit: the port's draws are keyed by iteration
(utils.rng), so iterations i..N draw the same numbers whether or not the
process restarted.

Format: one .npz per checkpoint (abc, cost, iteration, seed and a config
fingerprint, the JSON of dataclasses.asdict), written to a temporary file
and renamed over the old one, so a reader never sees half a file.
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
    tmp_fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
    os.close(tmp_fd)
    np.savez(tmp, abc=state.abc.cpu().numpy(), cost=state.cost.cpu().numpy(),
             iteration=np.int64(iteration), seed=np.int64(seed),
             cfg=np.bytes_(_fingerprint(cfg).encode()))
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
