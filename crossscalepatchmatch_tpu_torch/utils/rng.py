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

The iterations of a warm start (models.pipeline.run_pair_warm) have a
numbering of their own: their refinement draws are keyed by PHASE_WARM
(TorchDraws(..., refine_phase=PHASE_WARM)), so warm iteration i never
draws what cold iteration i drew.

TorchDraws is the production source.  A test can hand in another source
with the same methods (for example one that replays the JAX engine's
threefry key tree) to make the port follow the JAX trajectory.
"""

from __future__ import annotations

import numpy as np
import torch

from .spans import span

PHASE_INIT = 0
PHASE_REFINE = 1
PHASE_WARM = 2


class TorchDraws:
    """Draws from torch.Generator on `device`, one generator per key.

    Each key (phase, iteration, view, round) seeds its own generator from
    numpy's SeedSequence of (seed, *key): the same seed gives bit-identical
    draws on the same device, whatever order they are asked for in.
    `refine_phase` keys the refinement draws: PHASE_REFINE for a cold run,
    PHASE_WARM for a warm start's iterations.  `tile` (a spatial tile's
    index, parallel.tiled) joins the seed: (seed, tile, *key).
    """

    def __init__(self, seed: int, device, refine_phase: int = PHASE_REFINE,
                 tile: int | None = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.refine_phase = refine_phase
        self.tile = tile

    def _gen(self, *key: int) -> torch.Generator:
        tile = () if self.tile is None else (self.tile,)
        entropy = [self.seed % (1 << 63), *tile, *key]
        s = int(np.random.SeedSequence(entropy).generate_state(
            1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(s)

    def _uniform(self, g, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=g, dtype=torch.float32,
                       device=self.device)
        return lo + (hi - lo) * u

    def init(self, shape, max_dis: float, eps: float):
        with span("draws"):
            g = self._gen(PHASE_INIT, 0, 0, 0)
            disp = self._uniform(g, shape, eps, float(max_dis))
            normal = torch.randn((*shape, 3), generator=g,
                                 dtype=torch.float32, device=self.device)
            return disp, normal

    def refine(self, iteration: int, view: int, rnd: int, shape,
               z_mag: float, n_mag: float):
        with span("draws", view=view, round=rnd):
            g = self._gen(self.refine_phase, iteration, view, rnd)
            dz = self._uniform(g, shape, -z_mag, z_mag)
            dn = self._uniform(g, (*shape, 3), -n_mag, n_mag)
            return dz, dn
