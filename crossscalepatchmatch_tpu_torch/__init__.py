"""crossscalepatchmatch_tpu_torch: the PyTorch + CUDA port of the
cross-scale PatchMatch stereo engine.

The JAX package `crossscalepatchmatch_tpu` is the reference this port is
held against, in the tests only: this package imports neither jax nor
anything of the JAX package, and keeps its own copies of the jax-free
modules it needs (`config`, `data`, `metrics`).  Module names mirror the
JAX package (`ops/...`, `models/...`) so each module's counterpart is easy
to find.

Kernels: the window plane cost (K1) and its strided prescreen form (K3),
the quadrant-volume build (K2), the cross-scale window cost (K4) and the
no-volume fly cost (K5 cost lerp, K6 image lerp, K7 Lab weights, K3
strided) run as hand-written CUDA kernels (`csrc/*.cu`, built at first use
by `ops.cuda._build`) on CUDA tensors; CPU tensors take their plain
PyTorch versions.
"""

from .config import (CEN_CS_PP, KITTI, MIDDLEBURY, README_DEMO, Aggregator,
                     CostMethod, CSPMConfig)

__all__ = ["Aggregator", "CEN_CS_PP", "CostMethod", "CSPMConfig", "KITTI",
           "MIDDLEBURY", "README_DEMO"]
