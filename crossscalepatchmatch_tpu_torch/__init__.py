"""crossscalepatchmatch_tpu_torch: the PyTorch + CUDA port of the
cross-scale PatchMatch stereo engine.

The JAX package `crossscalepatchmatch_tpu` is the reference this port is
held against; its jax-free modules (`config`, `data`, `metrics`, `io`) are
imported by name, never copied.  Module names mirror the JAX package
(`ops/...`, `models/...`) so each module's counterpart is easy to find.

Kernels: the window plane cost and the quadrant-volume build run as
hand-written CUDA kernels (`csrc/*.cu`, built at first use by
`ops.cuda._build`) on CUDA tensors; CPU tensors take their plain PyTorch
versions.  This package never imports jax.
"""

from crossscalepatchmatch_tpu.config import (CostMethod, CSPMConfig,
                                             README_DEMO)

__all__ = ["CostMethod", "CSPMConfig", "README_DEMO"]
