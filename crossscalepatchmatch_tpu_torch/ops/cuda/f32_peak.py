"""The f32 ceiling microbenchmark's kernel (csrc/f32_peak.cu): independent
chains of dependent fused multiply-adds, v = v * m + c.

It is the kernel behind utils.roofline.measure_f32_peak, the counterpart
of crossscalepatchmatch_tpu/utils/roofline.py measure_vpu_peak (a jnp
chain there, not a Pallas kernel).  A torch elementwise chain would
measure the memory rate: every step would read and write the tensor.  Its
plain version, fma_chain_plain, runs the same chain step by step, each
step a product and sum in f64 rounded once to f32 (as an FMA rounds).
"""

from __future__ import annotations

import torch

from . import _build

# the kernel's block: THREADS threads of CHAINS chains each, UNROLL FMAs of
# every chain an iteration
THREADS = 256
CHAINS = 8
UNROLL = 16
BLOCK_ELEMS = THREADS * CHAINS

# Kernel launches (a plain count).
launches = 0


def fma_chain_plain(x: torch.Tensor, iters: int, m: float,
                    c: float) -> torch.Tensor:
    """Each element of f32 x through iters * UNROLL steps v = fma(v, m, c)
    (the product of two f32 is exact in f64; the sum rounds once there, then
    to f32).  m and c are taken as f32, as the kernel takes them."""
    m, c = (float(torch.tensor(t, dtype=torch.float32)) for t in (m, c))
    v = x.to(torch.float32)
    for _ in range(iters * UNROLL):
        v = (v.double() * m + c).float()
    return v


def fma_chain(x: torch.Tensor, iters: int, m: float, c: float) -> torch.Tensor:
    """The FMA chains of f32[n] x: a CPU tensor takes the plain version, a
    CUDA tensor the kernel (n a multiple of BLOCK_ELEMS, contiguous);
    anything else raises ValueError."""
    global launches
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    if x.device.type == "cpu":
        return fma_chain_plain(x, iters, m, c)
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"x: expected a CUDA f32[n], got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    n = x.numel()
    if n == 0 or n % BLOCK_ELEMS or not x.is_contiguous():
        raise ValueError(f"x: {n} elements, not a positive multiple of "
                         f"{BLOCK_ELEMS}, or not contiguous")
    out = torch.empty_like(x)
    err = _build.load().cspm_f32_peak(x.data_ptr(), out.data_ptr(), n, iters,
                                      m, c, _build.stream_of(x))
    _build.check(err, "cspm_f32_peak")
    launches += 1
    return out
