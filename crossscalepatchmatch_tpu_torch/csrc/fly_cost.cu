// Kernels K5, K3 (fly form), K6 and K7: the no-volume slanted-plane ASW
// window cost, every pyramid level in one launch.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// window_cost.py `_kernel` on its fly path: `_fly_build` (:74, K5,
// lerp="cost"), the strided window (`wnd_stride` > 1, :331-343, K3),
// `_fly_build_image` + the `image_lerp` branch (:50, :388-416, K6) and the
// Lab weight slab (`data_ch0` = 3, :316-323, K7); launched per level by
// `fly_plane_cost_prepared` / `cross_scale_fly_cost_prepared`.  Plain
// version: ops/onthefly_cost.py fly_plane_cost.
//
// out[v, k, y, x] = ((w_0 * c_0 + w_1 * c_1) + ...), one level: c_0 alone
// (w_0 = 1, an exact product), with
// c_s = sum over the in-level window offsets (dy, dx) in
//   range(-hw, hw + 1, stride), dy-major, of lut[L1(wgt_s[v, c], wgt_s[v, q])]
//   * val(q), at c = (y >> s, x >> s), q = c + (dy, dx) inside level s,
// dq = ((d0 * 2^-s) + a*dx) + b*dy, d0 = a*x + b*y + c of candidate k, and
// val = sat unless 1 <= dq < max_dis_s, else
//   IMAGE = false (K5): lerp(cost(q, f), cost(q, f+1)) at f = trunc(dq),
//     cost(q, d) the GRD cost of q against the other view at column
//     q_x -+ d (left view -, right view +), or the border pseudo-cost of q
//     where that column leaves the image (ops/grad_cost.py);
//   IMAGE = true (K6): the GrdPC data term against the other view lerped
//     at other_x = q_x -+ dq with C-trunc taps, the tap columns wrapped
//     modulo the level width (HandleBorder's single +-W wrap whenever
//     max_dis_s < W_s, which the wrapper requires).
// LAB = true (K7): the weights read a packed Lab image, the data term the
// packed BGR one; LAB = false: both read the BGR one.
//
// What bounds it on the H100: per window sample the weight, the range test
// and, in range, two GRD slice costs (K5) or four two-tap channel lerps and
// one TAD term (K6) -- ALU work on staged data, no volume anywhere: the
// inputs are O(H*W) per level (packed BGR, f32 gradient, packed Lab).  The
// design: the block's tile of the reference view plus its half_wnd halo,
// and the other view's rows over the columns the block can reach
// ([tile - hw - max_dis_s, tile + hw] for the left view, [tile - hw,
// tile + hw + max_dis_s] for the right), are staged per level in shared
// memory as one packed u32 colour and one f32 gradient per pixel (8 bytes;
// the other view's columns already wrapped in IMAGE mode, so the sample
// loop indexes them directly); the weight comes from the 766-entry table
// built by the plain version's own exp; the cost-mode colour TAD of u8
// channels is one exact integer __vsadu4.  Every rounding step is an
// explicit _rn intrinsic in the plain version's order (the channel mean is
// a multiply by f32(1/3), what PyTorch's CUDA division by the scalar 3.0
// computes), so FMA contraction cannot move dq across a slice or range
// boundary and f32 results match the plain version on the card.
// One thread per (view, candidate, fine pixel); no inter-block state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kLutN = 766;  // 3 * 255 + 1
constexpr int kMaxLevels = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the H100's per-block maximum

struct Levels {
  const uint32_t* col[kMaxLevels];  // [2, Hs, Ws] packed BGR
  const float* grd[kMaxLevels];     // [2, Hs, Ws] x-gradient of gray
  const uint32_t* wgt[kMaxLevels];  // [2, Hs, Ws] packed Lab (LAB only)
  int h[kMaxLevels], w[kMaxLevels], max_dis[kMaxLevels];
  float scale_wgt[kMaxLevels];
  int n;
};

struct Grd {
  float alpha, beta, tau_clr, tau_grd, border, sat;
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

// GRD cost of reference pixel (col, grd) against the other view's pixel.
__device__ __forceinline__ float tad(const Grd& g, uint32_t col, float grd,
                                     uint32_t ocol, float ogrd) {
  return mix(g, third((float)__vsadu4(col, ocol)),
             fabsf(__fsub_rn(grd, ogrd)));
}

// Border pseudo-cost: the reference pixel against the constant border,
// colour channels summed in RGB order like the plain version.
__device__ __forceinline__ float border_cost(const Grd& g, uint32_t col,
                                             float grd) {
  const float s = __fadd_rn(
      __fadd_rn(fabsf(__fsub_rn(chan(col, 2), g.border)),
                fabsf(__fsub_rn(chan(col, 1), g.border))),
      fabsf(__fsub_rn(chan(col, 0), g.border)));
  return mix(g, third(s), fabsf(__fsub_rn(grd, g.border)));
}

__device__ __forceinline__ float lerp2(float fw, float omfw, float a,
                                       float b) {
  return __fadd_rn(__fmul_rn(fw, a), __fmul_rn(omfw, b));
}

template <bool IMAGE, bool LAB>
__global__ void __launch_bounds__(kTX * kTY)
fly_cost_kernel(const Levels lv,
                const float* __restrict__ abc,  // [2, K, H, W, 3]
                const float* __restrict__ lut,  // [766]
                float* __restrict__ out,        // [2, K, H, W]
                int K, int H, int W, int hw, int stride, const Grd g) {
  extern __shared__ uint32_t smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_dyn = smem + kLutN;
  const int vk = blockIdx.z;  // v * K + k
  const int v = vk / K;
  const bool left = v == 0;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool active = x < W && y < H;
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
    const int hs = lv.h[s], ws = lv.w[s], md = lv.max_dis[s];
    const int cx0 = x0 >> s, cy0 = y0 >> s;
    const int tile_w = (x_last >> s) - cx0 + 1 + 2 * hw;
    const int tile_h = (y_last >> s) - cy0 + 1 + 2 * hw;
    const int oth_w = tile_w + md;
    // level column of the other tile's first column
    const int ox0 = left ? cx0 - hw - md : cx0 - hw;
    const int n_t = tile_w * tile_h;
    const int n_o = oth_w * tile_h;
    uint32_t* s_col = s_dyn;
    float* s_grd = reinterpret_cast<float*>(s_col + n_t);
    uint32_t* s_wgt = reinterpret_cast<uint32_t*>(s_grd + n_t);
    uint32_t* s_ocol = LAB ? s_wgt + n_t : s_wgt;
    float* s_ogrd = reinterpret_cast<float*>(s_ocol + n_o);
    const size_t plane = (size_t)hs * ws;
    const uint32_t* col_v = lv.col[s] + v * plane;
    const float* grd_v = lv.grd[s] + v * plane;
    const uint32_t* col_o = lv.col[s] + (1 - v) * plane;
    const float* grd_o = lv.grd[s] + (1 - v) * plane;

    __syncthreads();  // the previous level's tiles are no longer read
    for (int i = tid; i < n_t; i += kTX * kTY) {
      const int ty = i / tile_w;
      const int gy = cy0 - hw + ty;
      const int gx = cx0 - hw + (i - ty * tile_w);
      const bool in = gy >= 0 && gy < hs && gx >= 0 && gx < ws;
      const size_t q = (size_t)gy * ws + gx;
      s_col[i] = in ? col_v[q] : 0u;
      s_grd[i] = in ? grd_v[q] : 0.f;
      if (LAB) s_wgt[i] = in ? lv.wgt[s][v * plane + q] : 0u;
    }
    for (int i = tid; i < n_o; i += kTX * kTY) {
      const int ty = i / oth_w;
      const int gy = cy0 - hw + ty;
      int gx = ox0 + (i - ty * oth_w);
      // cost mode reads only in-image columns (the border pseudo-cost
      // stands in beyond them); image mode wraps every column
      if (IMAGE) gx = ((gx % ws) + ws) % ws;
      const bool in = gy >= 0 && gy < hs && gx >= 0 && gx < ws;
      const size_t q = (size_t)gy * ws + gx;
      s_ocol[i] = in ? col_o[q] : 0u;
      s_ogrd[i] = in ? grd_o[q] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    const int cy = y >> s, cx = x >> s;
    const float d_f = __fmul_rn(d0, 1.f / (float)(1 << s));  // exact scale
    const float fmax = (float)md;
    const int ly = cy - cy0 + hw;  // center in tile coordinates
    const int lx = cx - cx0 + hw;
    const uint32_t wc = LAB ? s_wgt[ly * tile_w + lx] : s_col[ly * tile_w + lx];

    float acc = 0.f;
    for (int dy = -hw; dy <= hw; dy += stride) {
      const int qy = cy + dy;
      if (qy < 0 || qy >= hs) continue;
      const float bdy = __fmul_rn(b, (float)dy);
      const int row = (ly + dy) * tile_w;
      const int orow = (ly + dy) * oth_w - ox0;  // + level column
      for (int dx = -hw; dx <= hw; dx += stride) {
        const int qx = cx + dx;
        if (qx < 0 || qx >= ws) continue;
        const int ti = row + lx + dx;
        const float wgt = s_lut[__vsadu4(wc, LAB ? s_wgt[ti] : s_col[ti])];
        const float dq = __fadd_rn(__fadd_rn(d_f, __fmul_rn(a, (float)dx)), bdy);
        float val = g.sat;
        if (dq >= 1.f && dq < fmax) {  // NaN fails both: saturates
          const uint32_t qc = s_col[ti];
          const float qg = s_grd[ti];
          if (IMAGE) {
            const float other_x = __fadd_rn((float)qx, left ? -dq : dq);
            const int ox = (int)other_x;  // C trunc; |other_x| < ws + md
            const float fw = __fsub_rn((float)(ox + 1), other_x);
            const float omfw = __fsub_rn(1.f, fw);
            const uint32_t c0 = s_ocol[orow + ox], c1 = s_ocol[orow + ox + 1];
            const float sum = __fadd_rn(
                __fadd_rn(
                    fabsf(__fsub_rn(chan(qc, 0), lerp2(fw, omfw, chan(c0, 0),
                                                       chan(c1, 0)))),
                    fabsf(__fsub_rn(chan(qc, 1), lerp2(fw, omfw, chan(c0, 1),
                                                       chan(c1, 1))))),
                fabsf(__fsub_rn(chan(qc, 2),
                                lerp2(fw, omfw, chan(c0, 2), chan(c1, 2)))));
            const float gl = lerp2(fw, omfw, s_ogrd[orow + ox],
                                   s_ogrd[orow + ox + 1]);
            val = mix(g, third(sum), fabsf(__fsub_rn(qg, gl)));
          } else {
            const int f = (int)dq;  // in range: trunc is defined
            float c[2];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int ox = left ? qx - f - t : qx + f + t;
              c[t] = (left ? ox >= 0 : ox < ws)
                         ? tad(g, qc, qg, s_ocol[orow + ox], s_ogrd[orow + ox])
                         : border_cost(g, qc, qg);
            }
            const float fw = __fsub_rn((float)(f + 1), dq);
            val = lerp2(fw, __fsub_rn(1.f, fw), c[0], c[1]);
          }
        }
        acc = __fadd_rn(acc, __fmul_rn(wgt, val));
      }
    }
    const float term = __fmul_rn(lv.scale_wgt[s], acc);
    total = s == 0 ? term : __fadd_rn(total, term);
  }
  if (active) out[pix] = total;
}

size_t smem_bytes(int hw, int max_dis0, bool lab) {
  // level 0's tiles are the largest: a coarser level's block spans fewer
  // centers and a smaller max_dis
  const size_t tile = (size_t)(kTX + 2 * hw) * (kTY + 2 * hw);
  const size_t oth = (size_t)(kTX + 2 * hw + max_dis0) * (kTY + 2 * hw);
  return (kLutN + tile * (lab ? 3 : 2) + oth * 2) * sizeof(uint32_t);
}

template <bool IMAGE, bool LAB>
cudaError_t launch(const Levels& lv, const void* abc, const void* lut,
                   void* out, int K, int H, int W, int hw, int stride,
                   const Grd& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(hw, lv.max_dis[0], LAB);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fly_cost_kernel<IMAGE, LAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTX, kTY);
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, 2 * K);
  fly_cost_kernel<IMAGE, LAB><<<grid, block, smem, stream>>>(
      lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
      static_cast<float*>(out), K, H, W, hw, stride, g);
  return cudaGetLastError();
}

}  // namespace

// Per-level arrays (host memory, `levels` entries each): packed BGR images,
// gradients and packed Lab images (device pointers; Lab only when lab),
// shapes, the levels' max_dis and scale weights.  coef = (alpha, 1 - alpha,
// tau_clr, tau_grd, border_thres, sat).  Returns cudaErrorInvalidValue for
// a launch that would need more than 227 KB of shared memory.
extern "C" int cspm_fly_cost(
    const void* const* cols, const void* const* grds,
    const void* const* wgts_img, const int* hs, const int* ws,
    const int* max_dis, const float* scale_wgts, int levels, int image,
    int lab, const float* coef, const void* abc, const void* lut, void* out,
    int K, int H, int W, int half_wnd, int stride, void* stream) {
  if (levels < 1 || levels > kMaxLevels || stride < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  for (int s = 0; s < kMaxLevels; ++s) {
    const bool on = s < levels;
    lv.col[s] = on ? static_cast<const uint32_t*>(cols[s]) : nullptr;
    lv.grd[s] = on ? static_cast<const float*>(grds[s]) : nullptr;
    lv.wgt[s] = on && lab ? static_cast<const uint32_t*>(wgts_img[s])
                          : nullptr;
    lv.h[s] = on ? hs[s] : 0;
    lv.w[s] = on ? ws[s] : 0;
    lv.max_dis[s] = on ? max_dis[s] : 0;
    lv.scale_wgt[s] = on ? scale_wgts[s] : 0.f;
  }
  const Grd g{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (image) {
    if (lab)
      return (int)launch<true, true>(lv, abc, lut, out, K, H, W, half_wnd,
                                     stride, g, st);
    return (int)launch<true, false>(lv, abc, lut, out, K, H, W, half_wnd,
                                    stride, g, st);
  }
  if (lab)
    return (int)launch<false, true>(lv, abc, lut, out, K, H, W, half_wnd,
                                    stride, g, st);
  return (int)launch<false, false>(lv, abc, lut, out, K, H, W, half_wnd,
                                   stride, g, st);
}
