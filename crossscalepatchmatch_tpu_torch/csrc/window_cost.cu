// Kernel K1: slanted-plane ASW window cost over a precomputed volume.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// window_cost.py `_kernel` (launched by `_invoke`, volume form, scale 0):
// K1 at wnd_stride 1, and K3's volume form, the strided-window prescreen
// (`wnd_stride` > 1, :331-343; prescreen_mode="window").  Plain version:
// ops/plane_cost.py window_plane_cost.
//
// out[v, k, y, x] = sum over in-image window offsets (dy, dx) in
// range(-hw, hw + 1, stride) each, dy-major, of
//   lut[L1(img[v, y, x], img[v, y+dy, x+dx])] * val
// with dq = d_c + a*dx + b*dy (d_c = a*x + b*y + c of candidate k) and
// val = lerp(vol[v, q, f], vol[v, q, f+1]) at dq for f = trunc(dq) when
// 1 <= dq < max_dis, else max_costs[v].
//
// What bounds it on the H100: per window sample the ALU/SFU work of the
// weight (an exp per sample in the plain form) and the dependent gather of
// two adjacent volume slices; at the bench shape one K=1 launch is
// 2 x 168,750 px x 1,225 samples = 413 M samples.  The design:
//   * the weight exp(-L1/gamma) depends only on the integer L1 in
//     [0, 765], so it is read from a 766-entry table in shared memory
//     (built on the card by the plain version's own exp, hence bit-equal
//     to it) -- no transcendental per sample;
//   * the images are packed to one u32 per pixel and the block's tile plus
//     its half_wnd halo is staged in shared memory; the L1 is one
//     __vsadu4;
//   * the two lerp taps are adjacent in the D-minor volume (one 8-byte
//     span); no tent contraction over all D slices (that was a TPU
//     workaround for its missing per-lane gather).
// Every rounding step is an explicit _rn intrinsic in the plain version's
// order, so no FMA contraction moves dq across a slice or range boundary:
// f32 results match the plain version on the card bit for bit.
// One thread per (view, candidate, pixel); no inter-block state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kLutN = 766;  // 3 * 255 + 1

__device__ __forceinline__ float load_vol(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_vol(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

template <typename VT>
__global__ void __launch_bounds__(kTX * kTY)
window_cost_kernel(const uint32_t* __restrict__ img,      // [2, H, W] packed
                   const VT* __restrict__ vol,            // [2, H, W, D]
                   const float* __restrict__ max_costs,   // [2]
                   const float* __restrict__ abc,         // [2, K, H, W, 3]
                   const float* __restrict__ lut,         // [766]
                   float* __restrict__ out,               // [2, K, H, W]
                   int K, int H, int W, int D, int hw, int max_dis,
                   int stride) {
  extern __shared__ uint32_t smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_img = smem + kLutN;
  const int tile_w = kTX + 2 * hw;
  const int tile_h = kTY + 2 * hw;
  const int vk = blockIdx.z;  // v * K + k
  const int v = vk / K;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kTX + threadIdx.x;

  for (int i = tid; i < kLutN; i += kTX * kTY) s_lut[i] = lut[i];
  const uint32_t* img_v = img + (size_t)v * H * W;
  for (int i = tid; i < tile_w * tile_h; i += kTX * kTY) {
    const int ty = i / tile_w;
    const int tx = i - ty * tile_w;
    const int gy = y0 - hw + ty;
    const int gx = x0 - hw + tx;
    s_img[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? img_v[(size_t)gy * W + gx] : 0u;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t pix = ((size_t)vk * H + y) * W + x;
  const float a = abc[pix * 3];
  const float b = abc[pix * 3 + 1];
  const float c = abc[pix * 3 + 2];
  const float d_c = __fadd_rn(
      __fadd_rn(__fmul_rn(a, (float)x), __fmul_rn(b, (float)y)), c);
  const float maxc = max_costs[v];
  const float fmax = (float)max_dis;
  const uint32_t col_c = s_img[(threadIdx.y + hw) * tile_w + threadIdx.x + hw];
  const VT* vol_v = vol + (size_t)v * H * W * D;

  float acc = 0.f;
  for (int dy = -hw; dy <= hw; dy += stride) {
    const int qy = y + dy;
    if (qy < 0 || qy >= H) continue;
    const float bdy = __fmul_rn(b, (float)dy);
    const uint32_t* s_row =
        s_img + (threadIdx.y + hw + dy) * tile_w + threadIdx.x + hw;
    const VT* vol_row = vol_v + (size_t)qy * W * D;
    for (int dx = -hw; dx <= hw; dx += stride) {
      const int qx = x + dx;
      if (qx < 0 || qx >= W) continue;
      const float wgt = s_lut[__vsadu4(col_c, s_row[dx])];
      const float dq = __fadd_rn(__fadd_rn(d_c, __fmul_rn(a, (float)dx)), bdy);
      float val = maxc;
      if (dq >= 1.f && dq < fmax) {  // NaN fails both: saturates
        const int f = (int)dq;        // in range: trunc is defined
        const VT* p = vol_row + (size_t)qx * D + f;
        const float fw = __fsub_rn((float)(f + 1), dq);
        val = __fadd_rn(__fmul_rn(fw, load_vol(p)),
                        __fmul_rn(__fsub_rn(1.f, fw), load_vol(p + 1)));
      }
      acc = __fadd_rn(acc, __fmul_rn(wgt, val));
    }
  }
  out[pix] = acc;
}

template <typename VT>
cudaError_t launch(const void* img, const void* vol, const void* max_costs,
                   const void* abc, const void* lut, void* out, int K, int H,
                   int W, int D, int hw, int max_dis, int stride,
                   cudaStream_t stream) {
  const size_t smem =
      (kLutN + (size_t)(kTX + 2 * hw) * (kTY + 2 * hw)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_cost_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, 2 * K);
  window_cost_kernel<VT><<<grid, block, smem, stream>>>(
      static_cast<const uint32_t*>(img), static_cast<const VT*>(vol),
      static_cast<const float*>(max_costs), static_cast<const float*>(abc),
      static_cast<const float*>(lut), static_cast<float*>(out), K, H, W, D,
      hw, max_dis, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cspm_window_cost(const void* img, const void* vol, int vol_bf16,
                                const void* max_costs, const void* abc,
                                const void* lut, void* out, int K, int H,
                                int W, int D, int half_wnd, int max_dis,
                                int stride, void* stream) {
  if (stride < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16)
    return (int)launch<__nv_bfloat16>(img, vol, max_costs, abc, lut, out, K,
                                      H, W, D, half_wnd, max_dis, stride, s);
  return (int)launch<float>(img, vol, max_costs, abc, lut, out, K, H, W, D,
                            half_wnd, max_dis, stride, s);
}
