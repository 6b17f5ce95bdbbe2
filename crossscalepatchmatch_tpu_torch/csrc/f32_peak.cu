// The f32 ceiling microbenchmark: dependent fused multiply-add chains.
//
// The counterpart of crossscalepatchmatch_tpu/utils/roofline.py
// measure_vpu_peak (a jnp chain on the TPU's vector unit, not a Pallas
// kernel): what the card's CUDA cores sustain in f32 outside the tensor
// cores, so the kernels' shares of the bound can be read beside a measured
// ceiling as well as the data sheet's 67 TFLOP/s.
//
// Bound: operations, by construction.  A thread keeps kChains independent
// chains in registers (enough independent FFMAs in flight to cover the
// FFMA latency with 8+ warps a scheduler) and runs each through
// iters * kUnroll dependent FFMAs v = v * m + c; it reads and writes each
// element once.  m and c are kernel arguments, so the compiler cannot fold
// or shorten a chain (no fast-math: an FFMA chain is not reassociated).
// Element e of a block's tile is chain e / kThreads of thread
// e % kThreads: loads and stores are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    f32_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int iters, float m, float c) {
  const long base = (long)blockIdx.x * kThreads * kChains + threadIdx.x;
  float v[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) v[j] = x[base + j * kThreads];
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) v[j] = __fmaf_rn(v[j], m, c);
    }
  }
#pragma unroll
  for (int j = 0; j < kChains; ++j) out[base + j * kThreads] = v[j];
}

}  // namespace

// x, out: f32[n], n a multiple of kThreads * kChains (the wrapper checks);
// each element goes through iters * kUnroll FMAs.
extern "C" int cspm_f32_peak(const void* x, void* out, long n, int iters,
                             float m, float c, void* stream) {
  const long per_block = (long)kThreads * kChains;
  if (n <= 0 || n % per_block != 0 || iters < 0) return cudaErrorInvalidValue;
  const long blocks = n / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  f32_peak_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), iters, m, c);
  return cudaGetLastError();
}
