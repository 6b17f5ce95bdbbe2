// Kernel RPROP: a refinement stage's candidate planes for both views, one
// launch, the random draws made inside it.
//
// Replaces no TPU kernel: in the JAX engine the refinement proposal
// (crossscalepatchmatch_tpu/ops/plane.py perturb_planes and the
// jax.random.uniform draws that feed it) is fused by XLA inside run_pair's
// one jitted program.  In the port's eager plain version it is ~37
// elementwise launches a (view, round) for the perturbation and ~6 for the
// draws, each draw behind a host-built generator, plus the stacks.  Plain
// version: ops/cuda/refine_propose.py refine_propose_plain (the draws of
// refine_draws fed to ops/plane.py perturb_planes).
//
// Draws.  Each (view v, round i, pixel p) takes one Philox4x32-10 block
// (Salmon et al., SC'11) under the 64-bit key (k0, k1), counter
// (p, i | v << 16, iteration, phase): word 0 gives dz, words 1-3 dn.  A
// word w becomes u = (w >> 8) * 2^-24 in [0, 1), a draw lo + span * u (one
// f32 multiply, one f32 add: the plain version's `lo + (hi - lo) * u`).
//
// Perturbation, in perturb_planes' f32 order on the card, for (a, b, c)
// at (x, y):
//   d   = ((a * x) + (b * y)) + c;            z = d + dz
//   r   = rsqrt(((a * a) + (b * b)) + 1)      (rsqrtf, as torch.rsqrt)
//   m   = (-a * r, -b * r, r) + dn
//   len = max(sqrt(((m0 * m0 + m2 * m2) + m1 * m1) + 0), eps);  q = m / len
//   den = max(|q2|, eps) with the sign of q2 (+ for q2 >= 0 or NaN)
//   out = (-q0 / den, -q1 / den, (((q0 * x + q2 * z) + q1 * y) + 0) / den)
// each step one explicit _rn operation (no FMA contraction), IEEE division
// and square root.  The three-term sums take PyTorch's CUDA reduction
// order for a last axis of 3 (two lanes: elements 0 and 2 in one, then
// element 1 added; the +0 its identity leaves, which turns -0 into +0), so
// the candidates equal the plain version's on the card bit for bit.  The
// max keeps a NaN, as torch.clamp does.
//
// Layout: abc f32[2, H, W, 3] (the stage's starting planes, contiguous),
// out f32[2, K, H, W, 3], K <= kMaxRounds rounds i0 .. i0 + K - 1, H * W
// < 2^31; each round's (lo, span) pairs come by value in the kernel's
// arguments.
//
// What bounds it on the H100.  Its bytes: it reads abc once (24 B a pixel)
// and writes 24 * K B a pixel, 67 MB at a KITTI stage (K = 5, 375 x 1242),
// 20.0 us at 3.35 TB/s (utils/roofline.refine_propose_work).  Its
// instructions come close: a candidate's Philox block is ~40 integer
// multiplies (the integer pipe runs at half the f32 rate), its six IEEE
// divisions and square root are multi-instruction sequences.  On an H100
// at that shape (700 W) the kernel took ~56 us with one pixel a thread,
// ~41 us without its Philox rounds and ~34 us with neither the rounds nor
// the divisions, against 19.7 us for torch's fill_ of the 56 MB output:
// the integer and f32 work does not hide under the stores.  The design
// keeps the instructions few and the stores wide:
//   * one lane proposes kPix pixels (a warp tile of 32 * kPix pixels) over
//     all K rounds: abc is read once, a pixel's own plane terms (d, the
//     normal) are formed once, and kPix independent Philox chains and
//     divisions give each lane instruction-level parallelism (kPix = 4: 48
//     us at the KITTI stage against 56 with one pixel a lane);
//   * a warp stages its tile's planes and each round's stride-3 output in
//     shared memory of its own (double buffered, __syncwarp only, no block
//     barrier), so its loads are coalesced and its global stores 16-byte
//     and coalesced; a round's output starts at a float offset that need
//     not be a multiple of 4, so its first few floats and its tail go out
//     one at a time.
// ptxas (sm_90a): 64 registers, 18 KB shared memory a block of 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;            // pixels a lane
constexpr int kSpan = 96 * kPix;   // floats of a warp tile's planes
constexpr int kMaxRounds = 16;

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

struct Magnitudes {
  float z_lo[kMaxRounds], z_span[kMaxRounds];
  float n_lo[kMaxRounds], n_span[kMaxRounds];
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

constexpr float kTwoToMinus24 = 5.9604644775390625e-8f;  // exact

__device__ __forceinline__ float draw(uint32_t w, float lo, float span) {
  // (w >> 8) * 2^-24 is exact: a 24-bit integer scaled by a power of two
  return __fadd_rn(lo, __fmul_rn(span, __fmul_rn((float)(w >> 8),
                                                   kTwoToMinus24)));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// grid (ceil(H * W / (kThreads * kPix)), 2): blockIdx.y is the view.
__global__ void __launch_bounds__(kThreads)
refine_propose_kernel(const float* __restrict__ abc, float* __restrict__ out,
                      int K, int H, int W, int i0, uint32_t iteration,
                      uint32_t phase, uint32_t k0, uint32_t k1, float eps,
                      Magnitudes mag) {
  __shared__ float s_in[kWarps][kSpan];
  __shared__ float s_out[kWarps][2][kSpan];
  const unsigned hw = (unsigned)H * (unsigned)W;
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  // the warp's tile: pixels q0 .. q0 + np - 1 of view v
  const unsigned q0 = (blockIdx.x * kWarps + wp) * (32u * kPix);
  if (q0 >= hw) return;
  const int np = (int)min(32u * kPix, hw - q0);
  const float* src = abc + ((size_t)v * hw + q0) * 3;
  for (int e = lane; e < 3 * np; e += 32) s_in[wp][e] = __ldg(src + e);
  __syncwarp();
  float fx[kPix], fy[kPix], d[kPix], n0[kPix], n1[kPix], n2[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = lane + 32 * j;
    const unsigned p = q0 + i;
    const unsigned y = p / (unsigned)W;
    fy[j] = (float)y;
    fx[j] = (float)(p - y * (unsigned)W);
    const float a = s_in[wp][3 * i], b = s_in[wp][3 * i + 1];
    const float c = s_in[wp][3 * i + 2];
    d[j] = __fadd_rn(__fadd_rn(__fmul_rn(a, fx[j]), __fmul_rn(b, fy[j])), c);
    const float r = rsqrtf(
        __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), 1.f));
    n0[j] = __fmul_rn(-a, r);
    n1[j] = __fmul_rn(-b, r);
    n2[j] = r;
  }
  for (int k = 0; k < K; ++k) {
    float* buf = s_out[wp][k & 1];
    const float zl = mag.z_lo[k], zs = mag.z_span[k];
    const float nl = mag.n_lo[k], ns = mag.n_span[k];
    const uint32_t c1 = (uint32_t)(i0 + k) | ((uint32_t)v << 16);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int i = lane + 32 * j;
      if (i < np) {
        const uint4 w = philox4x32_10(
            make_uint4(q0 + i, c1, iteration, phase), k0, k1);
        const float z = __fadd_rn(d[j], draw(w.x, zl, zs));
        const float m0 = __fadd_rn(n0[j], draw(w.y, nl, ns));
        const float m1 = __fadd_rn(n1[j], draw(w.z, nl, ns));
        const float m2 = __fadd_rn(n2[j], draw(w.w, nl, ns));
        const float ss = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(m0, m0), __fmul_rn(m2, m2)),
                      __fmul_rn(m1, m1)), 0.f);
        const float len = clamp_min(__fsqrt_rn(ss), eps);
        const float q0n = __fdiv_rn(m0, len), q1n = __fdiv_rn(m1, len);
        const float q2n = __fdiv_rn(m2, len);
        const float az = clamp_min(fabsf(q2n), eps);
        const float den = q2n < 0.f ? -az : az;
        const float sc = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(q0n, fx[j]), __fmul_rn(q2n, z)),
                      __fmul_rn(q1n, fy[j])), 0.f);
        buf[3 * i] = __fdiv_rn(-q0n, den);
        buf[3 * i + 1] = __fdiv_rn(-q1n, den);
        buf[3 * i + 2] = __fdiv_rn(sc, den);
      }
    }
    __syncwarp();  // buf is whole; the other buffer's reads are done
    // round k's 3 * np floats of the tile start at float g0 of out
    const size_t g0 = (((size_t)v * K + k) * hw + q0) * 3;
    float* dst = out + g0;
    const int n = 3 * np;
    const int head = min(n, (int)((4 - (g0 & 3)) & 3));
    const int vecs = (n - head) >> 2;
    if (lane < head) dst[lane] = buf[lane];
    for (int q = lane; q < vecs; q += 32) {
      const int e = head + 4 * q;
      reinterpret_cast<float4*>(dst + head)[q] =
          make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
    }
    const int tail = head + 4 * vecs;
    if (lane < n - tail) dst[tail + lane] = buf[tail + lane];
  }
}

}  // namespace

// abc / out as above (out 16-byte aligned); K in [1, kMaxRounds] rounds
// from i0, mags the host's float[4][K]: each round's dz lo, dz span, dn lo,
// dn span.  Returns cudaSuccess or the launch's error.
extern "C" int cspm_refine_propose(const void* abc, void* out, int K, int H,
                                   int W, int i0, unsigned iteration,
                                   unsigned phase, unsigned k0, unsigned k1,
                                   float eps, const float* mags,
                                   void* stream) {
  if (K < 1 || K > kMaxRounds || H < 1 || W < 1 || i0 < 0 ||
      i0 + K > (1 << 16) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)H * W;
  if (hw >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (hw + kThreads * kPix - 1) / (kThreads * kPix);
  Magnitudes mag = {};
  for (int k = 0; k < K; ++k) {
    mag.z_lo[k] = mags[k];
    mag.z_span[k] = mags[K + k];
    mag.n_lo[k] = mags[2 * K + k];
    mag.n_span[k] = mags[3 * K + k];
  }
  refine_propose_kernel<<<dim3((unsigned)blocks, 2), kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(abc), static_cast<float*>(out), K, H, W, i0,
      iteration, phase, k0, k1, eps, mag);
  return (int)cudaGetLastError();
}
