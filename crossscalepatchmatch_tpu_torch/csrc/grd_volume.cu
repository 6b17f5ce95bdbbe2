// Kernel GRDV: the truncated colour + gradient (GRD) cost volume of one
// reference view, every (y, x, d) in one launch.
//
// Replaces the JAX engine's per-slice loop in crossscalepatchmatch_tpu/ops/
// grad_cost.py grd_cost_volume (:62-71: a Python loop over the D + 1
// slices, each a roll, a TAD and a select), which XLA fuses inside
// run_pair's one jitted program.  It is not a Pallas kernel.  Plain
// version: ops/grad_cost.py grd_cost_volume (~16 eager launches a slice).
//
// For reference pixel (y, x) and d in [0, D), with the other view's column
// ox = x - d (left reference) or x + d (right reference):
//   in range (0 <= ox < W):
//     clr = sum_c |ref_c - oth_c| * f32(1/3),  grd = |g_ref - g_oth|;
//   else (the constant border_thres stands in for the other view):
//     clr = ((|ref_0 - b| + |ref_1 - b|) + |ref_2 - b|) * f32(1/3),
//     grd = |g_ref - b|;
//   cost = alpha * min(clr, tau_clr) + beta * min(grd, tau_grd),
// alpha = f32(alpha), beta = f32(1 - alpha) formed in double, as PyTorch
// casts the plain version's Python scalars.
//
// Exactness (bit-equal to the plain version on the card): the in-range
// colour sum is of u8 differences, an integer <= 765 that every order
// forms exactly, here one __vsadu4.  The mean's "/ 3.0" is, on a CUDA
// tensor, PyTorch's multiply by the f32 reciprocal of the CPU scalar (its
// true-division kernel), so this kernel multiplies by 1.f / 3.f as the fly
// kernel does; the CPU's true division differs by one ulp at some sums
// (ROADMAP §3).  Every other step is one explicit _rn operation in the
// plain version's order, so no FMA contraction can merge two roundings.
//
// Inputs: pix uint2[2, H, W], per pixel (R | G << 8 | B << 16, f32
// gradient bits) of the left (0) and right (1) view, packed by the wrapper
// from the RGB views and their Sobel-x gradients (ops/color, ops/gradient:
// the plain functions, so the gradients are the plain version's bit for
// bit).  Output: f32[H, W, D], D-minor.
//
// What bounds it on the H100: the bytes of the volume it writes (4 B an
// element; its inputs are 8 B a pixel).  The design: a block walks one
// row's W * D contiguous outputs, neighbouring threads on neighbouring
// elements, so the stores of a warp are one coalesced 128-byte line; the
// two packed rows it reads (3.6 KB at W = 450, 10 KB at 1242) stay in L1
// through read-only loads, where neighbouring d read neighbouring columns.
// No shared memory, no inter-block state, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;   // outputs a thread writes (a grid-stride)

struct Grd {
  float alpha, beta, tau_clr, tau_grd, border;
};

__device__ __forceinline__ float third(float x) {
  return __fmul_rn(x, 1.f / 3.f);
}

__device__ __forceinline__ float mix(const Grd& g, float clr, float grd) {
  return __fadd_rn(__fmul_rn(g.alpha, fminf(clr, g.tau_clr)),
                   __fmul_rn(g.beta, fminf(grd, g.tau_grd)));
}

__device__ __forceinline__ float chan(uint32_t p, int c) {
  return (float)((p >> (8 * c)) & 0xffu);
}

__global__ void __launch_bounds__(kThreads)
grd_volume_kernel(const uint2* __restrict__ pix, float* __restrict__ out,
                  int H, int W, int D, int right, Grd g) {
  const int y = blockIdx.y;
  const int n = W * D;   // the row's outputs
  const uint2* ref_row = pix + ((size_t)(right ? H : 0) + y) * W;
  const uint2* oth_row = pix + ((size_t)(right ? 0 : H) + y) * W;
  float* orow = out + (size_t)y * n;
  const int step = gridDim.x * kThreads;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += step) {
    const int x = e / D;
    const int d = e - x * D;
    const uint2 r = __ldg(ref_row + x);
    const float rg = __uint_as_float(r.y);
    const int ox = right ? x + d : x - d;
    float cost;
    if (ox >= 0 && ox < W) {
      const uint2 o = __ldg(oth_row + ox);
      cost = mix(g, third((float)__vsadu4(r.x, o.x)),
                 fabsf(__fsub_rn(rg, __uint_as_float(o.y))));
    } else {
      const float s = __fadd_rn(
          __fadd_rn(fabsf(__fsub_rn(chan(r.x, 0), g.border)),
                    fabsf(__fsub_rn(chan(r.x, 1), g.border))),
          fabsf(__fsub_rn(chan(r.x, 2), g.border)));
      cost = mix(g, third(s), fabsf(__fsub_rn(rg, g.border)));
    }
    orow[e] = cost;
  }
}

}  // namespace

// pix: uint2[2, H, W] as above; out: f32[H, W, D] of the view `right`
// selects.  Returns cudaSuccess or the launch's error.
extern "C" int cspm_grd_volume(const void* pix, void* out, int H, int W,
                               int D, int right, float alpha, float beta,
                               float tau_clr, float tau_grd, float border,
                               void* stream) {
  if (H < 1 || W < 1 || D < 1 || H > 65535 ||
      (long long)W * D > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Grd g{alpha, beta, tau_clr, tau_grd, border};
  const long long per_block = kThreads * kPerThread;
  dim3 grid((unsigned)(((long long)W * D + per_block - 1) / per_block),
            (unsigned)H);
  grd_volume_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(pix), static_cast<float*>(out), H, W, D,
      right, g);
  return (int)cudaGetLastError();
}
