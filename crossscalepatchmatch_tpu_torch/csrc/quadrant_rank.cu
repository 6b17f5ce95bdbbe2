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
// What bounds it on the H100: bytes.  A (v, k, pixel) reads its plane (12
// B), at most four pairs of adjacent taps (8 B each, one 32-byte sector a
// pair unless it straddles one) and writes 4 B; the quadrant weights are
// read only where a quadrant is out of range.  The design: one thread a (v,
// k, pixel), pixels fastest, so the plane loads and the output stores of a
// warp are contiguous; the taps of neighbouring pixels lie D floats apart,
// a gather no layout of K2's output avoids (the candidates differ per
// pixel), so each tap pair is one sector and the kernel does nothing
// else.  No shared memory, no inter-block state, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quadrant_rank_kernel(const float* __restrict__ bq,
                     const float* __restrict__ wq,
                     const float* __restrict__ max_costs,
                     const float* __restrict__ abc, float* __restrict__ out,
                     int K, int H, int W, int D, float max_dis, float lo,
                     float hi) {
  const long long hw = (long long)H * W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * K * hw) return;
  const long long p = i % hw;
  const int v = (int)(i / hw) / K;
  const int y = (int)(p / W);
  const int x = (int)(p - (long long)y * W);
  const float a = __ldg(abc + 3 * i);
  const float b = __ldg(abc + 3 * i + 1);
  const float c = __ldg(abc + 3 * i + 2);
  const float dc = __fadd_rn(__fadd_rn(__fmul_rn(a, (float)x),
                                       __fmul_rn(b, (float)y)), c);
  const float mc = __ldg(max_costs + v);
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float ay = q < 2 ? lo : hi;
    const float ax = (q & 1) ? hi : lo;
    const float dq = __fadd_rn(__fadd_rn(dc, __fmul_rn(a, ax)),
                               __fmul_rn(b, ay));
    const long long slot = (long long)(4 * v + q) * hw + p;
    float val;
    if (dq >= 1.f && dq < max_dis) {
      const float f = truncf(dq);
      const float t = __fsub_rn(dq, f);
      const float* taps = bq + slot * D + (int)f;
      val = __fadd_rn(__fmul_rn(__fsub_rn(1.f, t), __ldg(taps)),
                      __fmul_rn(t, __ldg(taps + 1)));
    } else {
      val = __fmul_rn(__ldg(wq + slot), mc);
    }
    total = __fadd_rn(total, val);
  }
  out[i] = total;
}

}  // namespace

// bq / wq / max_costs / abc / out as above; max_dis <= D - 1, so the taps
// f + 1 <= max_dis of an in-range dq lie inside the slot.  Returns
// cudaSuccess or the launch's error.
extern "C" int cspm_quadrant_rank(const void* bq, const void* wq,
                                  const void* max_costs, const void* abc,
                                  void* out, int K, int H, int W, int D,
                                  int max_dis, int half_wnd, void* stream) {
  if (K < 1 || H < 1 || W < 1 || D < 2 || max_dis < 1 || max_dis > D - 1 ||
      half_wnd < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = 2LL * K * H * W;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quadrant_rank_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const float*>(bq), static_cast<const float*>(wq),
      static_cast<const float*>(max_costs), static_cast<const float*>(abc),
      static_cast<float*>(out), K, H, W, D, (float)max_dis,
      -(half_wnd + 1) / 2.f, half_wnd / 2.f);
  return (int)cudaGetLastError();
}
