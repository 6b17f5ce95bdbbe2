"""Injectable random-draw source for the optimizer.

Every random tensor the optimizer uses comes from one draw-source object,
keyed by (phase, iteration, view, round) and never by call order, so a run
resumed at iteration i draws what the uninterrupted run drew there.  The
draws are the init disparities and normals (ops.plane.random_planes) and the
per-round refinement jitter (ops.plane.perturb_planes).

A draw source has two methods:

    init(shape, max_dis, eps) -> (disp f32[*shape] ~ U(eps, max_dis),
                                  normal f32[*shape, 3] ~ N(0, 1))
    refine(iteration, view, rnd, shape, z_mag, n_mag)
        -> (dz f32[*shape] ~ U(-z_mag, z_mag),
            dn f32[*shape, 3] ~ U(-n_mag, n_mag))

and may have a third, which proposes a refinement stage's candidates
itself (models.patchmatch.plane_refinement asks for it where it exists):

    propose(abc, iteration, rounds, zs, ns, eps)
        -> f32[2, K, H, W, 3]: perturb_planes of abc[v] on refine's draws
           of (iteration, v, i), for each view v and round i in rounds

The iterations of a warm start (models.pipeline.run_pair_warm) have a
numbering of their own: their refinement draws are keyed by PHASE_WARM
(TorchDraws(..., refine_phase=PHASE_WARM)), so warm iteration i never
draws what cold iteration i drew.

TorchDraws is the production source.  A test can hand in another source
with the first two methods (for example one that replays the JAX
engine's threefry key tree) to make the port follow the JAX trajectory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import refine_propose
from .spans import span

PHASE_INIT = 0
PHASE_REFINE = 1
PHASE_WARM = 2


class TorchDraws:
    """The production draws, keyed by (seed, tile) and each draw's
    (phase, iteration, view, round): the same seed gives bit-identical
    draws, whatever order they are asked for in.

    The init draws come from torch.Generator on `device`, seeded from
    numpy's SeedSequence of (seed, *tile, PHASE_INIT, 0, 0, 0): one
    generator a pair.  The refinement draws are a counter-based Philox
    (ops.cuda.refine_propose): the 64-bit key comes once from SeedSequence
    of (seed, tile), the counter from (refine_phase, iteration, view,
    round, pixel), so they are the same bits on every device; propose
    draws them inside kernel RPROP on a CUDA tensor.  `refine_phase` keys
    the refinement draws: PHASE_REFINE for a cold run, PHASE_WARM for a
    warm start's iterations.  `tile` is a spatial tile's index
    (parallel.tiled), None without one.
    """

    def __init__(self, seed: int, device, refine_phase: int = PHASE_REFINE,
                 tile: int | None = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.refine_phase = refine_phase
        self.tile = tile
        # (seed, tile + 1 or 0 without one, 1): SeedSequence drops trailing
        # zero words, so the last word keeps every key apart from the
        # others and from the init's (seed, *tile, PHASE_INIT, 0, 0, 0)
        k0, k1 = np.random.SeedSequence(
            [self.seed % (1 << 63), 0 if tile is None else tile + 1, 1]
        ).generate_state(2, np.uint32)
        self.key = (int(k0), int(k1))

    def _uniform(self, g, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=g, dtype=torch.float32,
                       device=self.device)
        return lo + (hi - lo) * u

    def init(self, shape, max_dis: float, eps: float):
        with span("draws"):
            tile = () if self.tile is None else (self.tile,)
            entropy = [self.seed % (1 << 63), *tile, PHASE_INIT, 0, 0, 0]
            g = torch.Generator(device=self.device).manual_seed(int(
                np.random.SeedSequence(entropy).generate_state(
                    1, np.uint64)[0]))
            disp = self._uniform(g, shape, eps, float(max_dis))
            normal = torch.randn((*shape, 3), generator=g,
                                 dtype=torch.float32, device=self.device)
            return disp, normal

    def refine(self, iteration: int, view: int, rnd: int, shape,
               z_mag: float, n_mag: float):
        with span("draws", view=view, round=rnd):
            return refine_propose.refine_draws(
                self.key, self.refine_phase, iteration, view, rnd, shape,
                z_mag, n_mag, self.device)

    def propose(self, abc: torch.Tensor, iteration: int, rounds: range,
                zs, ns, eps: float) -> torch.Tensor:
        """The candidates of `rounds` from abc f32[2, H, W, 3], on abc's
        device: kernel RPROP on the card (one launch for up to
        refine_propose.MAX_ROUNDS rounds), its plain version on the CPU;
        the same bits as perturb_planes on this source's refine draws."""
        with span("draws", round=rounds.start, k=len(rounds)):
            abc = abc.contiguous()
            step = refine_propose.MAX_ROUNDS
            out = [refine_propose.refine_propose(
                abc, self.key, phase=self.refine_phase, iteration=iteration,
                rounds=rounds[i:i + step], zs=zs, ns=ns, eps=eps)
                for i in range(0, len(rounds), step)]
            return out[0] if len(out) == 1 else torch.cat(out, 1)
