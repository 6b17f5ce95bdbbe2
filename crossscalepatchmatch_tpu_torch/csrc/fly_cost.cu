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
// What bounds it on the H100: instruction issue, neither bytes (the inputs
// are O(H*W) per level) nor the f32 peak: a window sample is a chain of
// shared loads (pixel, weight table), the range test and two GRD slice
// costs (K5) or four channel lerps and a TAD (K6), about 65 instructions in
// range.  The design (the shared parts are in window_common.cuh):
//   * a 32 x 16 tile with 512 threads where two such blocks fit an SM (32
//     resident warps at max_dis 60 and 128), else the tile that keeps the
//     most warps resident, down to 32 x 8;
//   * staged pixels are interleaved: one 8-byte word (packed colour, f32
//     gradient) per pixel of the reference tile and of the other view's
//     reachable columns ([tile - hw - max_dis_s, tile + hw] for the left
//     view, [tile - hw, tile + hw + max_dis_s] for the right, already
//     wrapped in IMAGE mode), so a pixel or a tap is one LDS.64; the Lab
//     word sits in an array of its own;
//   * the in-image interval of a row is found once per level instead of
//     two tests per sample; the staged pixel, q_x and dx advance as running
//     values;
//   * no F2I / I2F per cost-mode sample: trunc(dq) by a round-toward-zero
//     add of 2^23, dx and q_x as running floats;
//   * the weight comes from the 766-entry table built by the plain
//     version's own exp; the cost-mode colour TAD of u8 channels is one
//     exact integer __vsadu4.
// Measured and dropped: 2 or 4 candidates per thread sharing the weight (no
// gain even at the prescreen's 8 candidates, see window_common.cuh),
// instances with half_wnd 17 and the stride fixed at compile time (slower
// than the runtime loop), cp.async / TMA staging (a block stages 19 pixels
// a thread against 1,225 window samples).
// Every rounding step is an explicit _rn intrinsic in the plain version's
// order (the channel mean is a multiply by f32(1/3), what PyTorch's CUDA
// division by the scalar 3.0 computes), so FMA contraction cannot move dq
// across a slice or range boundary and f32 results match the plain version
// on the card.  No inter-block state, no atomics.

#include "window_common.cuh"

namespace {

using namespace cspm;

constexpr int kSmSmem = 233472;     // 228 KB of shared memory an SM
constexpr int kBlockReserve = 1024;  // the system's share of each block

struct Levels {
  const uint2* ref[kMaxLevels];     // [2, Hs, Ws] (packed BGR, f32 gradient)
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
                                     uint2 oth) {
  return mix(g, third((float)__vsadu4(col, oth.x)),
             fabsf(__fsub_rn(grd, __uint_as_float(oth.y))));
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

// val(q) of one candidate at an in-range dq (see the header comment).
// o_row indexes the other view's staged row by level column; dir is -1 for
// the left view (its match lies at q_x - d), +1 for the right.
template <bool IMAGE>
__device__ __forceinline__ float data_term(const Grd& g, uint2 q, int qx,
                                           float fqx, float dq, int dir,
                                           int ws, const uint2* o_row) {
  const float qg = __uint_as_float(q.y);
  if (IMAGE) {
    const float other_x = __fadd_rn(fqx, dir < 0 ? -dq : dq);
    const int ox = (int)other_x;  // C trunc; |other_x| < ws + max_dis
    const float fw = __fsub_rn((float)(ox + 1), other_x);
    const float omfw = __fsub_rn(1.f, fw);
    const uint2 t0 = o_row[ox], t1 = o_row[ox + 1];
    const float sum = __fadd_rn(
        __fadd_rn(fabsf(__fsub_rn(chan(q.x, 0),
                                  lerp2(fw, omfw, chan(t0.x, 0),
                                        chan(t1.x, 0)))),
                  fabsf(__fsub_rn(chan(q.x, 1),
                                  lerp2(fw, omfw, chan(t0.x, 1),
                                        chan(t1.x, 1))))),
        fabsf(__fsub_rn(chan(q.x, 2),
                        lerp2(fw, omfw, chan(t0.x, 2), chan(t1.x, 2)))));
    const float gl = lerp2(fw, omfw, __uint_as_float(t0.y),
                           __uint_as_float(t1.y));
    return mix(g, third(sum), fabsf(__fsub_rn(qg, gl)));
  }
  const float t = biased_trunc(dq);
  // slices f and f + 1: adjacent columns, the second one farther out
  const int ox = qx + dir * trunc_of(t);
  const int ox1 = ox + dir;
  float c0 = tad(g, q.x, qg, o_row[ox]);
  float c1 = tad(g, q.x, qg, o_row[ox1]);
  if ((unsigned)ox1 >= (unsigned)ws) {  // the farther tap leaves the image
    const float bc = border_cost(g, q.x, qg);
    c1 = bc;
    if ((unsigned)ox >= (unsigned)ws) c0 = bc;
  }
  const float fw = __fsub_rn(trunc_plus_one(t), dq);
  return lerp2(fw, __fsub_rn(1.f, fw), c0, c1);
}

// Window cost of one level for the candidate plane of a thread (the fly
// counterpart of cspm::volume_level_cost).  s_ref / s_wgt are the staged
// reference tile (row length tile_w), s_oth the other view's staged rows
// (row length oth_w, first level column ox0), (lx, ly) the center in tile
// coordinates.  The staged pixel, q_x and dx advance as running values.
template <bool IMAGE, bool LAB>
__device__ __forceinline__ float fly_level_cost(
    const uint2* s_ref, const uint32_t* s_wgt, const uint2* s_oth,
    int tile_w, int oth_w, int ox0, int lx, int ly, const float* s_lut,
    int hs, int ws, int cx, int cy, int hw, int stride, int dir, float fmax,
    const Grd& g, float a, float b, float d_f) {
  const float fstride = (float)stride;
  const Span sy = axis_span(cy, hs, hw, stride);
  const Span sx = axis_span(cx, ws, hw, stride);
  const int dx0 = sx.lo * stride - hw;  // the row's first in-image offset
  const uint32_t wc =
      LAB ? s_wgt[ly * tile_w + lx] : s_ref[ly * tile_w + lx].x;
  float acc = 0.f;
  for (int iy = sy.lo; iy <= sy.hi; ++iy) {
    const int dy = iy * stride - hw;
    const float bdy = __fmul_rn(b, (float)dy);
    const int row = (ly + dy) * tile_w + (lx + dx0);
    const uint2* q_ptr = s_ref + row;
    const uint32_t* w_ptr = s_wgt + row;
    const uint2* o_row = s_oth + (ly + dy) * oth_w - ox0;
    int qx = cx + dx0;
    float fdx = (float)dx0, fqx = (float)qx;
    for (int i = sx.lo; i <= sx.hi; ++i) {
      const uint2 q = *q_ptr;
      const float wgt = s_lut[__vsadu4(wc, LAB ? *w_ptr : q.x)];
      const float dq = __fadd_rn(__fadd_rn(d_f, __fmul_rn(a, fdx)), bdy);
      float val = g.sat;
      if (dq >= 1.f && dq < fmax)  // NaN fails both: saturates
        val = data_term<IMAGE>(g, q, qx, fqx, dq, dir, ws, o_row);
      acc = __fadd_rn(acc, __fmul_rn(wgt, val));
      q_ptr += stride;
      w_ptr += stride;
      qx += stride;
      fdx += fstride;  // small integers: exact, equal to (float)dx
      fqx += fstride;
    }
  }
  return acc;
}

template <bool IMAGE, bool LAB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fly_cost_kernel(const Levels lv,
                const float* __restrict__ abc,  // [2, K, H, W, 3]
                const float* __restrict__ lut,  // [766]
                float* __restrict__ out,        // [2, K, H, W]
                int K, int H, int W, int hw, int stride, const Grd g) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint2* s_dyn = reinterpret_cast<uint2*>(smem + kLutN);  // 8-byte aligned
  const int ty = blockDim.y;  // tile rows
  const int threads = kTX * ty;
  const int vk = blockIdx.z;  // v * K + k
  const int v = vk / K;
  const bool left = v == 0;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * ty;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool active = x < W && y < H;
  const int x_last = min(x0 + kTX, W) - 1;
  const int y_last = min(y0 + ty, H) - 1;

  for (int i = tid; i < kLutN; i += threads) s_lut[i] = lut[i];
  const size_t pix = active ? ((size_t)vk * H + y) * W + x : 0;
  const Plane p = load_plane(abc, pix, x, y);

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
    uint2* s_ref = s_dyn;
    uint2* s_oth = s_ref + n_t;
    uint32_t* s_wgt = reinterpret_cast<uint32_t*>(s_oth + n_o);
    const size_t plane = (size_t)hs * ws;
    const uint2* ref_v = lv.ref[s] + v * plane;
    const uint2* ref_o = lv.ref[s] + (1 - v) * plane;

    __syncthreads();  // the previous level's tiles are no longer read
    for (int i = tid; i < n_t; i += threads) {
      const int r = i / tile_w;
      const int gy = cy0 - hw + r;
      const int gx = cx0 - hw + (i - r * tile_w);
      const bool in = gy >= 0 && gy < hs && gx >= 0 && gx < ws;
      const size_t q = (size_t)gy * ws + gx;
      s_ref[i] = in ? ref_v[q] : make_uint2(0u, 0u);
      if (LAB) s_wgt[i] = in ? lv.wgt[s][v * plane + q] : 0u;
    }
    for (int i = tid; i < n_o; i += threads) {
      const int r = i / oth_w;
      const int gy = cy0 - hw + r;
      int gx = ox0 + (i - r * oth_w);
      // cost mode reads only in-image columns (the border pseudo-cost
      // stands in beyond them); image mode wraps every column
      if (IMAGE) gx = ((gx % ws) + ws) % ws;
      const bool in = gy >= 0 && gy < hs && gx >= 0 && gx < ws;
      s_oth[i] = in ? ref_o[(size_t)gy * ws + gx] : make_uint2(0u, 0u);
    }
    __syncthreads();
    if (!active) continue;

    const int cy = y >> s, cx = x >> s;
    const float d_f = __fmul_rn(p.d0, 1.f / (float)(1 << s));  // exact scale
    const float acc = fly_level_cost<IMAGE, LAB>(
        s_ref, s_wgt, s_oth, tile_w, oth_w, ox0, cx - cx0 + hw,
        cy - cy0 + hw, s_lut, hs, ws, cx, cy, hw, stride, left ? -1 : 1,
        (float)md, g, p.a, p.b, d_f);
    const float term = __fmul_rn(lv.scale_wgt[s], acc);
    total = s == 0 ? term : __fadd_rn(total, term);
  }
  if (active) out[pix] = total;
}

size_t smem_bytes(int hw, int max_dis0, bool lab, int tile_rows) {
  // level 0's tiles are the largest: a coarser level's block spans fewer
  // centers and a smaller max_dis
  const size_t tile = (size_t)(kTX + 2 * hw) * (tile_rows + 2 * hw);
  const size_t oth = (size_t)(kTX + 2 * hw + max_dis0) * (tile_rows + 2 * hw);
  return (kLutN + tile * (lab ? 3 : 2) + oth * 2) * sizeof(uint32_t);
}

// Warps an SM keeps resident with this tile, at the 64 registers a thread
// that two 512-thread blocks leave (32 warps at most).
int resident_warps(size_t smem, int tile_rows) {
  if (smem > (size_t)kMaxSmem) return 0;
  const int by_smem = (int)(kSmSmem / (smem + kBlockReserve));
  const int by_threads = 2 * kMaxTY / tile_rows;
  return (by_smem < by_threads ? by_smem : by_threads) * tile_rows;
}

template <bool IMAGE, bool LAB>
cudaError_t launch(const Levels& lv, const void* abc, const void* lut,
                   void* out, int K, int H, int W, int hw, int stride,
                   const Grd& g, cudaStream_t stream) {
  // 16 rows unless 8 keep more warps resident (or only 8 fit)
  const int w16 = resident_warps(smem_bytes(hw, lv.max_dis[0], LAB, 16), 16);
  const int w8 = resident_warps(smem_bytes(hw, lv.max_dis[0], LAB, 8), 8);
  const int tile_rows = w16 >= w8 ? 16 : 8;
  const size_t smem = smem_bytes(hw, lv.max_dis[0], LAB, tile_rows);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fly_cost_kernel<IMAGE, LAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTX, tile_rows);
  const dim3 grid((W + kTX - 1) / kTX, (H + tile_rows - 1) / tile_rows,
                  2 * K);
  fly_cost_kernel<IMAGE, LAB>
      <<<grid, block, smem, stream>>>(
          lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
          static_cast<float*>(out), K, H, W, hw, stride, g);
  return cudaGetLastError();
}

}  // namespace

// Per-level arrays (host memory, `levels` entries each): the interleaved
// (packed BGR, f32 gradient) images and the packed Lab images (device
// pointers; Lab only when lab), shapes, the levels' max_dis and scale
// weights.  coef = (alpha, 1 - alpha, tau_clr, tau_grd, border_thres, sat).
// Returns cudaErrorInvalidValue for a launch that would need more than 227 KB
// of shared memory.
extern "C" int cspm_fly_cost(
    const void* const* refs, const void* const* wgts_img, const int* hs,
    const int* ws, const int* max_dis, const float* scale_wgts, int levels,
    int image, int lab, const float* coef, const void* abc, const void* lut,
    void* out, int K, int H, int W, int half_wnd, int stride, void* stream) {
  if (levels < 1 || levels > kMaxLevels || stride < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  for (int s = 0; s < kMaxLevels; ++s) {
    const bool on = s < levels;
    lv.ref[s] = on ? static_cast<const uint2*>(refs[s]) : nullptr;
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
