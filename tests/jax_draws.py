"""Test-only helpers of the port's CPU tests: a config pair built from one
keyword dict, and a draw source that replays the JAX engine's threefry key
tree.

The draw source JaxDraws, handed to the PyTorch port
(crossscalepatchmatch_tpu_torch.utils.rng draw source interface), makes
the port draw exactly the random numbers the
JAX engine draws for the same seed, so the two trajectories can be
compared:

  key = PRNGKey(seed); k_init, _ = split(key)
  init:     kd, kn = split(k_init); uniform(kd, (2,H,W), eps, max_dis),
            normal(kn, (2,H,W,3))                         (plane.py:83-85)
  iteration keys: split(split(key)[1], max_iter)          (patchmatch.py:559)
  batched refinement: split(k_it, 2r).reshape(2, r, -1)[view, round]
  sequential refinement: round i takes the (i+1)-th k, k0, k1 = split(k, 3)
  perturb:  kd, kn = split(k); uniform(kd, (H,W), -z, z),
            uniform(kn, (H,W,3), -n, n)                   (plane.py:109-114)

JaxWarmDraws replays a warm start's tree (models/pipeline.py
run_pair_warm): warm iteration i refines from split(PRNGKey(seed),
warm_iters)[i], split per view and round as above; no init draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crossscalepatchmatch_tpu import config as jconfig
from crossscalepatchmatch_tpu.models import patchmatch as jpm
from crossscalepatchmatch_tpu_torch import config as tconfig


def config_pair(**kw):
    """(JAX CSPMConfig, port CSPMConfig) from the same keywords; enum
    fields may be given by value ("CEN", "GF") and become each package's
    own enum member."""
    def build(mod):
        args = dict(kw)
        if "cost_method" in args:
            args["cost_method"] = mod.CostMethod(args["cost_method"])
        if "aggregator" in args:
            args["aggregator"] = mod.Aggregator(args["aggregator"])
        return mod.CSPMConfig(**args)

    return build(jconfig), build(tconfig)


class JaxDraws:
    def __init__(self, seed: int, cfg):
        self.cfg = cfg
        self.key = jax.random.PRNGKey(seed)
        self.iter_keys = jpm.iteration_keys(self.key, cfg)
        self.r = len(cfg.refinement_schedule())

    def init(self, shape, max_dis, eps):
        k_init, _ = jax.random.split(self.key)
        kd, kn = jax.random.split(k_init)
        disp = jax.random.uniform(kd, shape, jnp.float32, eps, max_dis)
        normal = jax.random.normal(kn, (*shape, 3), jnp.float32)
        return (torch.from_numpy(np.array(disp)),
                torch.from_numpy(np.array(normal)))

    def refine(self, iteration, view, rnd, shape, z_mag, n_mag):
        k_it = self.iter_keys[iteration]
        if self.cfg.batch_refine:
            k = jax.random.split(k_it, 2 * self.r).reshape(
                2, self.r, -1)[view, rnd]
        else:
            k = k_it
            for _ in range(rnd + 1):
                k, k0, k1 = jax.random.split(k, 3)
            k = (k0, k1)[view]
        kd, kn = jax.random.split(k)
        z = jnp.float32(z_mag)
        n = jnp.float32(n_mag)
        dz = jax.random.uniform(kd, shape, jnp.float32, -z, z)
        dn = jax.random.uniform(kn, (*shape, 3), jnp.float32, -n, n)
        return (torch.from_numpy(np.array(dz)),
                torch.from_numpy(np.array(dn)))


class JaxWarmDraws(JaxDraws):
    def __init__(self, seed: int, cfg, warm_iters: int):
        super().__init__(seed, cfg)
        self.iter_keys = jax.random.split(self.key, warm_iters)

    def init(self, shape, max_dis, eps):
        raise AssertionError("a warm start draws no init planes")
