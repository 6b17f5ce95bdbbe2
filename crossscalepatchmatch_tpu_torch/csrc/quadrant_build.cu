// Kernel K2: ASW quadrant-volume build.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// quadrant_build.py `_kernel` (launched by quadrant_volumes_prepared).
// Plain version: ops/prescreen_volume.py build_quadrant_volumes.
//
// For view v, pixel c and quadrant Q in order (--), (-+), (+-), (++):
//   bq[v, Q, c, d] = sum_{o in Q} w(c, c+o) * vol[v, c+o, d]
//   wq[v, Q, c]    = sum_{o in Q} w(c, c+o)
// over in-image q = c + o, with per-axis offsets range(-hw, 0, stride)
// (- side) and range(0, hw + 1, stride) (+ side), dy-major.
//
// What bounds it on the H100: its output, f32[2, 4, H, W, D] -- 329 MB at
// the bench shape (375 x 450, D = 61) written once -- and the 2 x 168,750 x
// 324 offsets x 61 slices = 6.7 G multiply-adds reading vol[q, :] rows.
// The design: one warp per output pixel with D across the lanes, so every
// vol[q, :] read and every bq[.., c, :] write is one contiguous, coalesced
// row; a lane holds slices lane, lane + 32, ... in ceil(D / 32) <= 8
// accumulators (any D up to 256: KITTI's 129 slices take 5); the quadrant
// sums of a lane stay in registers until a single
// write at the end (no accumulator round trip through device memory, which
// is what the plain version pays per offset); neighbouring warps of a block
// read overlapping windows, which the L1/L2 caches serve.  The weight comes
// from the same 766-entry table as K1 (bit-equal to the plain exp), the
// L1 from one __vsadu4 of packed pixels.  _rn intrinsics keep the plain
// version's rounding order, so f32 results match it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kLutN = 766;

__device__ __forceinline__ float load_vol(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_vol(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

template <typename VT, int NJ>
__global__ void __launch_bounds__(kWarps * 32)
quadrant_build_kernel(const uint32_t* __restrict__ img,  // [2, H, W] packed
                      const VT* __restrict__ vol,        // [2, H, W, D]
                      const float* __restrict__ lut,     // [766]
                      float* __restrict__ bq,            // [2, 4, H, W, D]
                      float* __restrict__ wq,            // [2, 4, H, W]
                      int H, int W, int D, int hw, int stride) {
  __shared__ float s_lut[kLutN];
  for (int i = threadIdx.x; i < kLutN; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int v = blockIdx.y;
  const int hwn = H * W;
  if (p >= hwn) return;
  const int y = p / W;
  const int x = p - y * W;
  const uint32_t* img_v = img + (size_t)v * hwn;
  const VT* vol_v = vol + (size_t)v * hwn * D;
  const uint32_t col_c = img_v[p];

  for (int qi = 0; qi < 4; ++qi) {
    const int y_lo = (qi & 2) ? 0 : -hw;
    const int y_hi = (qi & 2) ? hw : -1;
    const int x_lo = (qi & 1) ? 0 : -hw;
    const int x_hi = (qi & 1) ? hw : -1;
    float acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
    float wsum = 0.f;
    for (int dy = y_lo; dy <= y_hi; dy += stride) {
      const int qy = y + dy;
      if (qy < 0 || qy >= H) continue;
      for (int dx = x_lo; dx <= x_hi; dx += stride) {
        const int qx = x + dx;
        if (qx < 0 || qx >= W) continue;
        const size_t q = (size_t)qy * W + qx;
        const float wgt = s_lut[__vsadu4(col_c, img_v[q])];
        const VT* vq = vol_v + q * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[j] = __fadd_rn(acc[j], __fmul_rn(wgt, load_vol(vq + d)));
        }
        wsum = __fadd_rn(wsum, wgt);
      }
    }
    const size_t o = ((size_t)v * 4 + qi) * hwn + p;
    float* bq_p = bq + o * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) bq_p[d] = acc[j];
    }
    if (lane == 0) wq[o] = wsum;
  }
}

template <typename VT, int NJ>
cudaError_t launch(const void* img, const void* vol, const void* lut, void* bq,
                   void* wq, int H, int W, int D, int hw, int stride,
                   cudaStream_t stream) {
  const dim3 block(kWarps * 32);
  const dim3 grid((H * W + kWarps - 1) / kWarps, 2);
  quadrant_build_kernel<VT, NJ><<<grid, block, 0, stream>>>(
      static_cast<const uint32_t*>(img), static_cast<const VT*>(vol),
      static_cast<const float*>(lut), static_cast<float*>(bq),
      static_cast<float*>(wq), H, W, D, hw, stride);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t dispatch(const void* img, const void* vol, const void* lut,
                     void* bq, void* wq, int H, int W, int D, int hw,
                     int stride, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch<VT, 1>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 2: return launch<VT, 2>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 3: return launch<VT, 3>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 4: return launch<VT, 4>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 5: return launch<VT, 5>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 6: return launch<VT, 6>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 7: return launch<VT, 7>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    case 8: return launch<VT, 8>(img, vol, lut, bq, wq, H, W, D, hw, stride, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cspm_quadrant_build(const void* img, const void* vol,
                                   int vol_bf16, const void* lut, void* bq,
                                   void* wq, int H, int W, int D, int half_wnd,
                                   int stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16)
    return (int)dispatch<__nv_bfloat16>(img, vol, lut, bq, wq, H, W, D,
                                        half_wnd, stride, s);
  return (int)dispatch<float>(img, vol, lut, bq, wq, H, W, D, half_wnd,
                              stride, s);
}
