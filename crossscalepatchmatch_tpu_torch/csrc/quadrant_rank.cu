// Kernel QRANK: the quadrant ranking of K candidate planes of both views,
// one launch.
//
// Replaces the JAX engine's four tent contractions over D in
// crossscalepatchmatch_tpu/ops/prescreen_volume.py quadrant_prescreen_cost
// (:114-153), which XLA fuses inside run_pair's one jitted program.  It is
// not a Pallas kernel.  Plain version: ops/prescreen_volume.py
// quadrant_prescreen_cost, one view a call (~27 elementwise launches and
// two gathers a quadrant); the port ranks with its two-tap lerp, not the
// JAX tent (equal up to rounding in range).
//
// For view v, candidate k and pixel (y, x), with (a, b, c) = abc[v, k, y,
// x] and the quadrant anchors (ay, ax) in the order (lo, lo), (lo, hi),
// (hi, lo), (hi, hi), lo = -(half_wnd + 1) / 2, hi = half_wnd / 2:
//   d_center = ((a * x) + (b * y)) + c
//   dq       = (d_center + a * ax) + b * ay
//   in range (1 <= dq < max_dis): f = trunc(dq), t = dq - f,
//     q = ((1 - t) * B[v, Q, y, x, f]) + (t * B[v, Q, y, x, f + 1])
//   else q = W[v, Q, y, x] * max_costs[v]
//   out[v, k, y, x] = (((0 + q_0) + q_1) + q_2) + q_3
// each step one explicit _rn operation in the plain version's order (no
// FMA contraction can merge two roundings), so the result is the plain
// version's bit for bit on the card.  A NaN or infinite dq fails the range
// test, as in the plain version.
//
// Inputs as kernel K2 writes them: bq f32[2, 4, H, W, D], wq f32[2, 4, H,
// W]; abc f32[2, K, H, W, 3]; max_costs f32[2] on the device (read there:
// no host round trip).  Output f32[2, K, H, W].
//
// What bounds it on the H100: the load/store unit's work on a gather.  A
// tap pair is 8 useful bytes, but a warp's load whose 32 lanes read 32
// different cache lines is 32 L1 wavefronts and as many L2 requests.  One
// thread a (view, k, pixel) puts 32 pixels' rows in every warp load, 244 B
// (D=61) to 516 B (D=129) apart, so every lane is a line of its own, and
// its time follows the number of in-range taps, not the DRAM sectors they
// touch (utils/roofline.quadrant_rank_sectors): on the pipeline's own
// candidates, whose taps share sectors, it ran slower than on random
// planes.  A pixel's K candidates read the same four rows B[v, Q, y, x, :],
// and on the real path they cluster in disparity (the propagation
// stencil's neighbours, the refinement's perturbations of the pixel's own
// plane), so most of a row's K taps fall in one or two sectors.
//
// The design: neighbouring lanes on the (candidate, quadrant) items of one
// pixel, so a warp's tap load reads the four rows of one pixel (K = 8) or
// of a few (small K): a few lines, each fetched once for all candidates.
// A block of kThreads ranks a tile of kTile pixels of one view, kChunk
// candidates at a time: it stages the chunk's planes in shared memory
// (candidate k's planes of the tile are 3 * kTile contiguous floats:
// coalesced loads), ranks the items, forms each (candidate, pixel)'s sum
// in the lane of its quadrant 0 from its neighbours' values by shuffles, in
// the plain version's order, and writes the costs back through shared
// memory (candidate k's costs of the tile are kTile contiguous floats:
// coalesced stores).  The shared rows are padded by one float, so the
// candidates of one pixel sit in different banks.  ptxas (sm_90a): 56
// registers, 16.5 KB shared memory; 9 blocks, 36 warps an SM (registers
// bound it).  In a one-off comparison of variants on an H100 (the
// variants are not kept in the repository, so it cannot be rerun;
// tools/torch_kernel_ab.py times this kernel only against another
// checkout's), one thread a (view, pixel) walking k (its later taps meant
// to hit L1) ran no faster than one thread a (view, k, pixel): each of its
// warp loads still spans 32 rows.  At K = 3 and 8 a tile of 64 pixels ran
// faster than one of 32, and 256 threads a block slower than 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // pixels a block
constexpr int kChunk = 16;  // candidates a block ranks at a time

// grid (ceil(H * W / kTile), 2): blockIdx.y is the view.
__global__ void __launch_bounds__(kThreads)
quadrant_rank_kernel(const float* __restrict__ bq,
                     const float* __restrict__ wq,
                     const float* __restrict__ max_costs,
                     const float* __restrict__ abc, float* __restrict__ out,
                     int K, int H, int W, int D, float max_dis, float lo,
                     float hi) {
  __shared__ float s_abc[kChunk][3 * kTile + 1];
  __shared__ float s_out[kChunk][kTile + 1];
  const long long hw = (long long)H * W;
  const int v = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kTile;
  const int np = (int)min((long long)kTile, hw - p0);
  const float mc = __ldg(max_costs + v);
  const int q = threadIdx.x & 3;  // a lane's quadrant, in every item
  const float ay = q < 2 ? lo : hi;
  const float ax = (q & 1) ? hi : lo;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    for (int t = threadIdx.x; t < kc * 3 * kTile; t += kThreads) {
      const int k = t / (3 * kTile), e = t - k * 3 * kTile;
      if (e < 3 * np)
        s_abc[k][e] = __ldg(abc + ((v * K + k0 + k) * hw + p0) * 3 + e);
    }
    __syncthreads();
    // item j: (pixel i, candidate k, quadrant q), j = (i * kc + k) * 4 + q;
    // the block runs the same trip count, so every lane reaches the
    // shuffles
    const int items = np * kc * 4;
    for (int j0 = 0; j0 < items; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      const int g = j >> 2;
      const int i = g / kc, k = g - i * kc;
      float val = 0.f;
      if (j < items) {
        const float a = s_abc[k][3 * i];
        const float b = s_abc[k][3 * i + 1];
        const float c = s_abc[k][3 * i + 2];
        const long long p = p0 + i;
        const int y = (int)(p / W);
        const float fx = (float)(int)(p - (long long)y * W);
        const float dc = __fadd_rn(
            __fadd_rn(__fmul_rn(a, fx), __fmul_rn(b, (float)y)), c);
        const float dq = __fadd_rn(__fadd_rn(dc, __fmul_rn(a, ax)),
                                   __fmul_rn(b, ay));
        const long long slot = (4 * v + q) * hw + p;
        if (dq >= 1.f && dq < max_dis) {
          const float f = truncf(dq);
          const float t = __fsub_rn(dq, f);
          const float* taps = bq + slot * D + (int)f;
          val = __fadd_rn(__fmul_rn(__fsub_rn(1.f, t), __ldg(taps)),
                          __fmul_rn(t, __ldg(taps + 1)));
        } else {
          val = __fmul_rn(__ldg(wq + slot), mc);
        }
      }
      const float v1 = __shfl_down_sync(~0u, val, 1);
      const float v2 = __shfl_down_sync(~0u, val, 2);
      const float v3 = __shfl_down_sync(~0u, val, 3);
      if (q == 0 && j < items)
        s_out[k][i] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(0.f, val), v1), v2), v3);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kc * kTile; t += kThreads) {
      const int k = t / kTile, i = t - k * kTile;
      if (i < np) out[(v * K + k0 + k) * hw + p0 + i] = s_out[k][i];
    }
    __syncthreads();  // the next chunk restages the planes
  }
}

}  // namespace

// bq / wq / max_costs / abc / out as above; max_dis <= D - 1, so the taps
// f + 1 <= max_dis of an in-range dq lie inside the row.  Returns
// cudaSuccess or the launch's error.
extern "C" int cspm_quadrant_rank(const void* bq, const void* wq,
                                  const void* max_costs, const void* abc,
                                  void* out, int K, int H, int W, int D,
                                  int max_dis, int half_wnd, void* stream) {
  if (K < 1 || H < 1 || W < 1 || D < 2 || max_dis < 1 || max_dis > D - 1 ||
      half_wnd < 0)
    return (int)cudaErrorInvalidValue;
  const long long hw = (long long)H * W;
  const long long blocks = (hw + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quadrant_rank_kernel<<<dim3((unsigned)blocks, 2), kThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const float*>(bq), static_cast<const float*>(wq),
      static_cast<const float*>(max_costs), static_cast<const float*>(abc),
      static_cast<float*>(out), K, H, W, D, (float)max_dis,
      -(half_wnd + 1) / 2.f, half_wnd / 2.f);
  return (int)cudaGetLastError();
}
