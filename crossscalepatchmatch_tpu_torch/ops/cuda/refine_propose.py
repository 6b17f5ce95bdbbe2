"""Kernel RPROP: a refinement stage's candidate planes for both views, the
random draws made inside the kernel (csrc/refine_propose.cu, one launch a
stage).

Replaces no TPU kernel: the JAX engine's refinement proposal
(crossscalepatchmatch_tpu/ops/plane.py perturb_planes on
jax.random.uniform draws) is fused by XLA under run_pair's jit.  Its plain
version is refine_propose_plain, which refine_propose takes for CPU
tensors: ops.plane.perturb_planes on the draws of refine_draws, stacked;
on the card the kernel's candidates are bit-equal to it (see the source's
note).

The draws are a counter-based Philox4x32-10 (Salmon et al., SC'11), keyed
and never call-ordered: under a 64-bit key (k0, k1), the draw of view v,
round i and pixel p (its flat index in the view) is the block of counter
(p, i | v << 16, iteration, phase); word 0 gives dz, words 1-3 dn, each
word w the uniform (w >> 8) * 2^-24 in [0, 1).  philox4x32 computes the
blocks in plain torch (int64 arithmetic, any device), so refine_draws
gives the kernel's draws bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from . import _build
from .. import plane

# Kernel launches, one a stage (a plain count; the GPU tier resets and
# reads it).
launches = 0

# The most rounds one launch proposes (csrc/refine_propose.cu kMaxRounds).
MAX_ROUNDS = 16
# Philox4x32's multipliers and key increments (Salmon et al., SC'11)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK = 0xFFFFFFFF

Key = Tuple[int, int]


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x, for x int64 in [0, 2^32): the
    product is formed from 16-bit halves of x, so no int64 overflows."""
    p_lo, p_hi = (x & 0xFFFF) * m, (x >> 16) * m
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK


def philox4x32(counter: torch.Tensor, key: Key) -> torch.Tensor:
    """Philox4x32-10 of int64[..., 4] counters (each word in [0, 2^32))
    under the key (k0, k1): int64[..., 4] words in [0, 2^32)."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK, (k1 + PHILOX_W[1]) & _MASK
    return torch.stack([c0, c1, c2, c3], -1)


def counters(phase: int, iteration: int, view: int, rnd: int, n: int,
             device) -> torch.Tensor:
    """int64[n, 4]: the counters of pixels 0..n-1 of (phase, iteration,
    view, round), the fields packed without overlap; raises ValueError on
    a field outside its width."""
    if not (0 <= rnd < 1 << 16 and view in (0, 1) and 0 <= iteration < 1 << 32
            and 0 <= phase < 1 << 32 and 0 < n <= 1 << 32):
        raise ValueError(f"counter fields outside their widths: phase "
                         f"{phase}, iteration {iteration}, view {view}, round "
                         f"{rnd}, {n} pixels")
    p = torch.arange(n, dtype=torch.int64, device=device)
    rest = torch.tensor([rnd | view << 16, iteration, phase],
                        dtype=torch.int64, device=device)
    return torch.cat([p[:, None], rest.expand(n, 3)], 1)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * u


def refine_draws(key: Key, phase: int, iteration: int, view: int, rnd: int,
                 shape: Sequence[int], z_mag: float, n_mag: float, device):
    """(dz f32[*shape] ~ U(-z_mag, z_mag), dn f32[*shape, 3] ~ U(-n_mag,
    n_mag)): the draws of (phase, iteration, view, rnd) under `key`, the
    pixels of `shape` in row-major order, on `device`."""
    n = math.prod(shape)
    words = philox4x32(counters(phase, iteration, view, rnd, n, device), key)
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    return (_uniform(u[:, 0].reshape(shape), -z_mag, z_mag),
            _uniform(u[:, 1:].reshape(*shape, 3), -n_mag, n_mag))


def refine_propose_plain(abc: torch.Tensor, key: Key, *, phase: int,
                         iteration: int, rounds: range, zs, ns,
                         eps: float) -> torch.Tensor:
    """The plain version of refine_propose, on any device: each (view,
    round)'s perturb_planes on its refine_draws, stacked."""
    _, h, w, _ = abc.shape
    return torch.stack([torch.stack([plane.perturb_planes(
        abc[v], *refine_draws(key, phase, iteration, v, i, (h, w),
                              float(zs[i]), float(ns[i]), abc.device), eps)
        for i in rounds]) for v in range(2)])


def _check_inputs(abc: torch.Tensor, key: Key, phase: int, iteration: int,
                  rounds: range) -> Tuple[int, int, int]:
    """(K, H, W); raises ValueError on what the kernel does not take, on
    any device (the device is checked after)."""
    if abc.dtype != torch.float32:
        raise ValueError(f"abc: dtype {abc.dtype}, expected torch.float32")
    if abc.dim() != 4 or abc.shape[0] != 2 or abc.shape[-1] != 3:
        raise ValueError(f"abc: shape {tuple(abc.shape)}, expected "
                         f"[2, H, W, 3]")
    if not abc.is_contiguous():
        raise ValueError("abc: must be contiguous")
    _, h, w, _ = abc.shape
    k = len(rounds)
    if rounds.step != 1 or not 1 <= k <= MAX_ROUNDS:
        raise ValueError(f"rounds {rounds}: expected 1 to {MAX_ROUNDS} "
                         f"consecutive rounds")
    if not (0 <= rounds.start and rounds.stop <= 1 << 16
            and 0 <= iteration < 1 << 32 and 0 <= phase < 1 << 32
            and all(0 <= x <= _MASK for x in key)):
        raise ValueError(f"key {key}, phase {phase}, iteration {iteration} "
                         f"or rounds {rounds} outside the counter's words")
    if h * w == 0 or h * w >= 1 << 31:
        raise ValueError(f"abc: {h} x {w} pixels a view, outside the "
                         f"kernel's [1, 2^31)")
    return k, h, w


def refine_propose_cuda(abc: torch.Tensor, key: Key, *, phase: int,
                        iteration: int, rounds: range, zs, ns,
                        eps: float) -> torch.Tensor:
    """refine_propose on the card: one RPROP launch for both views and
    every round; raises ValueError on anything it does not take (CPU
    tensors included)."""
    global launches
    k, h, w = _check_inputs(abc, key, phase, iteration, rounds)
    if abc.device.type != "cuda":
        raise ValueError(f"abc: expected a CUDA tensor, got {abc.device}")
    # each round's draw bounds as the plain version's _uniform forms them:
    # lo and hi - lo, each rounded to f32 once
    z = [float(zs[i]) for i in rounds]
    n = [float(ns[i]) for i in rounds]
    mags = (ctypes.c_float * (4 * k))(
        *[-x for x in z], *[x + x for x in z], *[-x for x in n],
        *[x + x for x in n])
    out = torch.empty((2, k, h, w, 3), dtype=torch.float32,
                      device=abc.device)
    err = _build.load().cspm_refine_propose(
        abc.data_ptr(), out.data_ptr(), k, h, w, rounds.start, iteration,
        phase, key[0], key[1], eps, mags, _build.stream_of(out))
    _build.check(err, "cspm_refine_propose")
    launches += 1
    return out


def refine_propose(abc: torch.Tensor, key: Key, *, phase: int,
                   iteration: int, rounds: range, zs, ns,
                   eps: float) -> torch.Tensor:
    """A refinement stage's candidates, f32[2, K, H, W, 3]: candidate k of
    view v is abc[v]'s planes perturbed by the draws of round
    rounds[k] (perturb_planes on refine_draws).  CPU tensors take the plain
    version, CUDA tensors the kernel (refine_propose_cuda, one launch).

    Args:
      abc: f32[2, H, W, 3] the stage's starting planes.
      key: the Philox key (k0, k1), two 32-bit words.
      phase / iteration: the draws' refinement phase and iteration.
      rounds: the stage's consecutive rounds (at most MAX_ROUNDS on the
        card); zs / ns: each round's dz and dn magnitude, by round.
    """
    fn = (refine_propose_plain if abc.device.type == "cpu"
          else refine_propose_cuda)
    return fn(abc, key, phase=phase, iteration=iteration, rounds=rounds,
              zs=zs, ns=ns, eps=eps)
