// Kernel K4: cross-scale slanted-plane ASW window cost over the pyramid's
// precomputed volumes, all levels in one launch.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// window_cost.py `_kernel` at scale > 0 (launched per level by
// `cross_scale_plane_cost_prepared`, which also runs scale 0 and sums the
// levels).  Plain version: ops/plane_cost.py cross_scale_plane_cost.
//
// out[v, k, y, x] = ((w_0 * c_0 + w_1 * c_1) + w_2 * c_2) + ...
// c_s = sum over the in-level window offsets (dy, dx), dy-major, of
//   lut[L1(img_s[v, y>>s, x>>s], img_s[v, (y>>s)+dy, (x>>s)+dx])] * val
// with d0 = a*x + b*y + c of candidate k at the fine pixel,
// dq = ((d0 * 2^-s) + a*dx) + b*dy and val = lerp(vol_s[v, q, f],
// vol_s[v, q, f+1]) at dq for f = trunc(dq) when 1 <= dq < max_dis_s, else
// max_costs_s[v].  A window pixel counts only inside level s.
//
// What bounds it on the H100: the same per-sample ALU work and two-tap
// volume gather as K1, times the number of levels (every level sums a full
// wnd x wnd window per fine pixel: 5 x 413 M samples per K=1 launch at the
// bench shape).  The design follows K1: the weight from the 766-entry
// table in shared memory, the L1 as one __vsadu4 of packed pixels, the two
// lerp taps adjacent in the D-minor level volume; the block's level-s tile
// plus its half_wnd halo (in level-s pixels) is restaged in shared memory
// for each level.  Level s is indexed directly: no nearest-upsampled
// arrays, no tent contraction (both TPU workarounds).  One launch covers
// every level, so an evaluation costs one launch, not one per level plus
// the adds.  Every rounding step, the weighted level sum included, is an
// explicit _rn intrinsic in the plain version's order: f32 results match
// it on the card bit for bit.
// One thread per (view, candidate, fine pixel); no inter-block state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kLutN = 766;  // 3 * 255 + 1
constexpr int kMaxLevels = 8;

struct Levels {
  const uint32_t* img[kMaxLevels];   // [2, Hs, Ws] packed BGR
  const void* vol[kMaxLevels];       // [2, Hs, Ws, Ds]
  const float* max_costs[kMaxLevels];  // [2]
  int h[kMaxLevels], w[kMaxLevels], d[kMaxLevels], max_dis[kMaxLevels];
  float wgt[kMaxLevels];
  int n;
};

__device__ __forceinline__ float load_vol(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_vol(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

template <typename VT>
__global__ void __launch_bounds__(kTX * kTY)
cross_scale_kernel(const Levels lv,
                   const float* __restrict__ abc,   // [2, K, H, W, 3]
                   const float* __restrict__ lut,   // [766]
                   float* __restrict__ out,         // [2, K, H, W]
                   int K, int H, int W, int hw) {
  extern __shared__ uint32_t smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_img = smem + kLutN;
  const int vk = blockIdx.z;  // v * K + k
  const int v = vk / K;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool active = x < W && y < H;
  // last fine column / row of the block inside the image
  const int x_last = min(x0 + kTX, W) - 1;
  const int y_last = min(y0 + kTY, H) - 1;

  for (int i = tid; i < kLutN; i += kTX * kTY) s_lut[i] = lut[i];

  float a = 0.f, b = 0.f, d0 = 0.f;
  size_t pix = 0;
  if (active) {
    pix = ((size_t)vk * H + y) * W + x;
    a = abc[pix * 3];
    b = abc[pix * 3 + 1];
    d0 = __fadd_rn(__fadd_rn(__fmul_rn(a, (float)x), __fmul_rn(b, (float)y)),
                   abc[pix * 3 + 2]);
  }

  float total = 0.f;
  for (int s = 0; s < lv.n; ++s) {
    const int hs = lv.h[s], ws = lv.w[s], ds = lv.d[s];
    // the block's level-s centers span [cx0, cx1] x [cy0, cy1]
    const int cx0 = x0 >> s, cy0 = y0 >> s;
    const int tile_w = (x_last >> s) - cx0 + 1 + 2 * hw;
    const int tile_h = (y_last >> s) - cy0 + 1 + 2 * hw;
    const uint32_t* img_v = lv.img[s] + (size_t)v * hs * ws;
    __syncthreads();  // the previous level's tile is no longer read
    for (int i = tid; i < tile_w * tile_h; i += kTX * kTY) {
      const int ty = i / tile_w;
      const int tx = i - ty * tile_w;
      const int gy = cy0 - hw + ty;
      const int gx = cx0 - hw + tx;
      s_img[i] = (gy >= 0 && gy < hs && gx >= 0 && gx < ws)
                     ? img_v[(size_t)gy * ws + gx] : 0u;
    }
    __syncthreads();
    if (!active) continue;

    const int cy = y >> s, cx = x >> s;
    const float d_f = __fmul_rn(d0, 1.f / (float)(1 << s));  // exact scale
    const float maxc = lv.max_costs[s][v];
    const float fmax = (float)lv.max_dis[s];
    const int ly = cy - cy0 + hw;  // center in tile coordinates
    const int lx = cx - cx0 + hw;
    const uint32_t col_c = s_img[ly * tile_w + lx];
    const VT* vol_v = static_cast<const VT*>(lv.vol[s]) + (size_t)v * hs * ws * ds;

    float acc = 0.f;
    for (int dy = -hw; dy <= hw; ++dy) {
      const int qy = cy + dy;
      if (qy < 0 || qy >= hs) continue;
      const float bdy = __fmul_rn(b, (float)dy);
      const uint32_t* s_row = s_img + (ly + dy) * tile_w + lx;
      const VT* vol_row = vol_v + (size_t)qy * ws * ds;
      for (int dx = -hw; dx <= hw; ++dx) {
        const int qx = cx + dx;
        if (qx < 0 || qx >= ws) continue;
        const float wgt = s_lut[__vsadu4(col_c, s_row[dx])];
        const float dq = __fadd_rn(__fadd_rn(d_f, __fmul_rn(a, (float)dx)), bdy);
        float val = maxc;
        if (dq >= 1.f && dq < fmax) {  // NaN fails both: saturates
          const int f = (int)dq;        // in range: trunc is defined
          const VT* p = vol_row + (size_t)qx * ds + f;
          const float fw = __fsub_rn((float)(f + 1), dq);
          val = __fadd_rn(__fmul_rn(fw, load_vol(p)),
                          __fmul_rn(__fsub_rn(1.f, fw), load_vol(p + 1)));
        }
        acc = __fadd_rn(acc, __fmul_rn(wgt, val));
      }
    }
    const float term = __fmul_rn(lv.wgt[s], acc);
    total = s == 0 ? term : __fadd_rn(total, term);
  }
  if (active) out[pix] = total;
}

template <typename VT>
cudaError_t launch(const Levels& lv, const void* abc, const void* lut,
                   void* out, int K, int H, int W, int hw,
                   cudaStream_t stream) {
  // level 0's tile is the largest: a coarser level's block spans fewer
  // centers
  const size_t smem =
      (kLutN + (size_t)(kTX + 2 * hw) * (kTY + 2 * hw)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_scale_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, 2 * K);
  cross_scale_kernel<VT><<<grid, block, smem, stream>>>(
      lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
      static_cast<float*>(out), K, H, W, hw);
  return cudaGetLastError();
}

}  // namespace

// Per-level arrays (host memory, `levels` entries each): packed images,
// volumes, saturation values (device pointers), shapes, the levels'
// max_dis and the scale weights.
extern "C" int cspm_cross_scale_cost(
    const void* const* imgs, const void* const* vols,
    const void* const* max_costs, const int* hs, const int* ws,
    const int* ds, const int* max_dis, const float* wgts, int levels,
    int vol_bf16, const void* abc, const void* lut, void* out, int K, int H,
    int W, int half_wnd, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  for (int s = 0; s < levels; ++s) {
    lv.img[s] = static_cast<const uint32_t*>(imgs[s]);
    lv.vol[s] = vols[s];
    lv.max_costs[s] = static_cast<const float*>(max_costs[s]);
    lv.h[s] = hs[s];
    lv.w[s] = ws[s];
    lv.d[s] = ds[s];
    lv.max_dis[s] = max_dis[s];
    lv.wgt[s] = wgts[s];
  }
  for (int s = levels; s < kMaxLevels; ++s) {
    lv.img[s] = nullptr;
    lv.vol[s] = nullptr;
    lv.max_costs[s] = nullptr;
    lv.h[s] = lv.w[s] = lv.d[s] = lv.max_dis[s] = 0;
    lv.wgt[s] = 0.f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16)
    return (int)launch<__nv_bfloat16>(lv, abc, lut, out, K, H, W, half_wnd, s);
  return (int)launch<float>(lv, abc, lut, out, K, H, W, half_wnd, s);
}
