// Kernel K4: cross-scale slanted-plane ASW window cost over the pyramid's
// precomputed volumes, all levels in one launch.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// window_cost.py `_kernel` at scale > 0 (launched per level by
// `cross_scale_plane_cost_prepared`, which also runs scale 0 and sums the
// levels).  Plain version: ops/plane_cost.py cross_scale_plane_cost.
// At one level with weight 1 it is also K1, the same `_kernel` in its
// volume form at scale 0, and with a window stride K3's volume form, the
// strided-window prescreen (`wnd_stride` > 1, :331-343): d0 * 2^0 and
// 1 * cost are exact, so the level term is window_plane_cost's value bit
// for bit (ops/cuda/window_cost.py).  A thin kernel of K1's own around the
// same level loop measured the same in bf16 and up to 10 % slower in f32 on
// an H100, so there is none.
//
// out[v, k, y, x] = ((w_0 * c_0 + w_1 * c_1) + w_2 * c_2) + ...
// c_s = sum over the in-level window offsets (dy, dx) in
// range(-hw, hw + 1, stride) each, dy-major, of
//   lut[L1(img_s[v, y>>s, x>>s], img_s[v, (y>>s)+dy, (x>>s)+dx])] * val
// with d0 = a*x + b*y + c of candidate k at the fine pixel,
// dq = ((d0 * 2^-s) + a*dx) + b*dy and val = lerp(vol_s[v, q, f],
// vol_s[v, q, f+1]) at dq for f = trunc(dq) when 1 <= dq < max_dis_s, else
// max_costs_s[v].  A window pixel counts only inside level s.
//
// Band form (a spatial tile of parallel.tiled, JAX tiled.py:325-370): each
// level carries an origin (oy, ox) and a validity rectangle.  Fine pixel
// (x, y) of the output centers at ((y + oy) >> s, (x + ox) >> s) of the
// level's arrays, and a window pixel counts inside [ylo, yhi) x [xlo, xhi)
// of them.  On one device every origin is 0 and every rectangle the
// level's extent.  On a tile, level 0 is the block with a half_wnd halo on
// its extended axes (origin the halo depth, the rectangle the part inside
// the global image: a neighbour's halo counts, pixels past the global
// border do not) and every coarser level is whole, replicated on every
// tile (origin the block's global fine position, which may be odd: the
// level-s center is (y + row0) >> s, not (y >> s) + (row0 >> s)).
//
// What bounds it on the H100: instruction issue, not the f32 peak (the
// kernel's useful operations are a few percent of it) and not bytes: every
// level sums a full wnd x wnd window per fine pixel (5 x 413 M samples per
// K=1 launch at the bench shape), each sample a chain of two shared loads
// (pixel, weight table), the range test and a two-tap gather from the level
// volume.  The design (see window_common.cuh for the shared parts) cuts the
// instructions of a sample from about 70 to 33:
//   * the in-image interval of a row is found once per level instead of
//     two tests per sample;
//   * the staged pixel, the depth row's 32-bit offset and dx advance as
//     running values (the 64-bit index arithmetic of a gather was 9 of a
//     sample's instructions);
//   * no F2I / I2F: trunc(dq) by a round-toward-zero add of 2^23, dx as a
//     running float;
//   * no branch: the taps' load is predicated on the range test, so the
//     loads of neighbouring samples overlap;
//   * the pair layout: element f of a pixel's depth row holds (vol[f],
//     vol[f+1]), so both taps are one aligned load (4 bytes bf16, 8 f32)
//     where the plain D-minor layout needs two: a tenth of the kernel's
//     time at twice the volume's memory;
//   * a 32 x 16 tile, 512 threads, two blocks an SM (32 resident warps).
// Measured and dropped: 2 or 4 candidates per thread sharing the weight
// (no gain, see window_common.cuh) and an instance with half_wnd 17 fixed
// at compile time and its row loop unrolled (slower than the runtime loop,
// which the compiler unrolls by 4 itself).
// Level s is indexed directly at (y >> s, x >> s): no nearest-upsampled
// arrays, no tent contraction (both TPU workarounds).  One launch covers
// every level; the block's level-s tile plus its half_wnd halo is restaged
// in shared memory for each level.  Every rounding step, the weighted level
// sum included, is an explicit _rn intrinsic in the plain version's order:
// f32 results match it on the card bit for bit.  No inter-block state, no
// atomics.

#include "window_common.cuh"

namespace {

using namespace cspm;

struct Levels {
  const uint32_t* img[kMaxLevels];     // [2, Hs, Ws] packed BGR
  const void* vol[kMaxLevels];         // [2, Hs, Ws, Ds] of pairs
  const float* max_costs[kMaxLevels];  // [2]
  int h[kMaxLevels], w[kMaxLevels], d[kMaxLevels], max_dis[kMaxLevels];
  int oy[kMaxLevels], ox[kMaxLevels];  // array position of fine (0, 0)
  int ylo[kMaxLevels], yhi[kMaxLevels], xlo[kMaxLevels], xhi[kMaxLevels];
  float wgt[kMaxLevels];
  int n;
};

template <typename VT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_scale_kernel(const Levels lv,
                   const float* __restrict__ abc,  // [2, K, H, W, 3]
                   const float* __restrict__ lut,  // [766]
                   float* __restrict__ out,        // [2, K, H, W]
                   int K, int H, int W, int hw, int stride) {
  using E = typename PairOf<VT>::type;
  extern __shared__ uint32_t smem[];
  float* s_lut = reinterpret_cast<float*>(smem);
  uint32_t* s_img = smem + kLutN;
  // blockIdx.x = tile * K + k, blockIdx.y = view: the K candidates of a
  // tile run side by side, so their gathers share the tile's depth rows in
  // L2 (with the candidates outermost, random planes swept the whole volume
  // K times)
  const int v = blockIdx.y;
  const int k = blockIdx.x % K;
  const int tile = blockIdx.x / K;
  const int tiles_x = (W + kTX - 1) / kTX;
  const int vk = v * K + k;
  const int x0 = (tile % tiles_x) * kTX;
  const int y0 = (tile / tiles_x) * kMaxTY;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool active = x < W && y < H;
  // last fine column / row of the block inside the image
  const int x_last = min(x0 + kTX, W) - 1;
  const int y_last = min(y0 + kMaxTY, H) - 1;

  for (int i = tid; i < kLutN; i += kThreads) s_lut[i] = lut[i];
  const size_t pix = active ? ((size_t)vk * H + y) * W + x : 0;
  const Plane p = load_plane(abc, pix, x, y);

  float total = 0.f;
  for (int s = 0; s < lv.n; ++s) {
    const int hs = lv.h[s], ws = lv.w[s], ds = lv.d[s];
    const int oy = lv.oy[s], ox = lv.ox[s];
    const int ylo = lv.ylo[s], yhi = lv.yhi[s];
    const int xlo = lv.xlo[s], xhi = lv.xhi[s];
    // the block's level-s centers span [cx0, cx1] x [cy0, cy1]
    const int cx0 = (x0 + ox) >> s, cy0 = (y0 + oy) >> s;
    const int tile_w = ((x_last + ox) >> s) - cx0 + 1 + 2 * hw;
    const int tile_h = ((y_last + oy) >> s) - cy0 + 1 + 2 * hw;
    const uint32_t* img_v = lv.img[s] + (size_t)v * hs * ws;
    __syncthreads();  // the previous level's tile is no longer read
    for (int i = tid; i < tile_w * tile_h; i += kThreads) {
      const int r = i / tile_w;
      const int gy = cy0 - hw + r;
      const int gx = cx0 - hw + (i - r * tile_w);
      s_img[i] = (gy >= ylo && gy < yhi && gx >= xlo && gx < xhi)
                     ? img_v[(size_t)gy * ws + gx] : 0u;
    }
    __syncthreads();
    if (!active) continue;

    const int cy = (y + oy) >> s, cx = (x + ox) >> s;
    const float d_f = __fmul_rn(p.d0, 1.f / (float)(1 << s));  // exact scale
    const E* vol_v =
        static_cast<const E*>(lv.vol[s]) + (size_t)v * hs * ws * ds;
    // stride 1 (K1, K4) as a constant: a loop of its own without the
    // stride's multiplies, a percent of K4's time
    const int lx = cx - cx0 + hw, ly = cy - cy0 + hw;
    const float maxc = lv.max_costs[s][v], fmax = (float)lv.max_dis[s];
    const float acc =
        stride == 1
            ? volume_level_cost<E>(s_img, tile_w, lx, ly, s_lut, vol_v, ws,
                                   ds, ylo, yhi, xlo, xhi, cx, cy, hw, 1,
                                   maxc, fmax, p.a, p.b, d_f)
            : volume_level_cost<E>(s_img, tile_w, lx, ly, s_lut, vol_v, ws,
                                   ds, ylo, yhi, xlo, xhi, cx, cy, hw, stride,
                                   maxc, fmax, p.a, p.b, d_f);
    const float term = __fmul_rn(lv.wgt[s], acc);
    total = s == 0 ? term : __fadd_rn(total, term);
  }
  if (active) out[pix] = total;
}

template <typename VT>
cudaError_t launch(const Levels& lv, const void* abc, const void* lut,
                   void* out, int K, int H, int W, int hw, int stride,
                   cudaStream_t stream) {
  // level 0's tile is the largest (a coarser level's block spans fewer
  // centers): 95 KB at half_wnd 64, always inside a block's 227 KB
  const size_t smem =
      (kLutN + (size_t)(kTX + 2 * hw) * (kMaxTY + 2 * hw)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_scale_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kTX, kMaxTY);
  const long long tiles =
      (long long)((W + kTX - 1) / kTX) * ((H + kMaxTY - 1) / kMaxTY);
  if (tiles * K > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * K), 2);
  cross_scale_kernel<VT><<<grid, block, smem, stream>>>(
      lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
      static_cast<float*>(out), K, H, W, hw, stride);
  return cudaGetLastError();
}

}  // namespace

// Per-level arrays (host memory, `levels` entries each): packed images,
// pair-layout volumes ([2, Hs, Ws, Ds, 2]), saturation values (device
// pointers), the geometry (kGeom ints a level: Hs, Ws, Ds, max_dis, the
// origin oy, ox and the validity rectangle ylo, yhi, xlo, xhi) and the
// scale weights.  A rectangle must lie inside its level, and every output
// pixel's center inside its rectangle (the wrapper checks both).
constexpr int kGeom = 10;

extern "C" int cspm_cross_scale_cost(
    const void* const* imgs, const void* const* vols,
    const void* const* max_costs, const int* geom, const float* wgts,
    int levels, int vol_bf16, const void* abc, const void* lut, void* out,
    int K, int H, int W, int half_wnd, int stride, void* stream) {
  if (levels < 1 || levels > kMaxLevels || K < 1 || half_wnd < 0 ||
      half_wnd > 64 || stride < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  for (int s = 0; s < kMaxLevels; ++s) {
    const bool on = s < levels;
    const int* g = geom + (on ? s : 0) * kGeom;
    lv.img[s] = on ? static_cast<const uint32_t*>(imgs[s]) : nullptr;
    lv.vol[s] = on ? vols[s] : nullptr;
    lv.max_costs[s] = on ? static_cast<const float*>(max_costs[s]) : nullptr;
    lv.h[s] = on ? g[0] : 0;
    lv.w[s] = on ? g[1] : 0;
    lv.d[s] = on ? g[2] : 0;
    lv.max_dis[s] = on ? g[3] : 0;
    lv.oy[s] = on ? g[4] : 0;
    lv.ox[s] = on ? g[5] : 0;
    lv.ylo[s] = on ? g[6] : 0;
    lv.yhi[s] = on ? g[7] : 0;
    lv.xlo[s] = on ? g[8] : 0;
    lv.xhi[s] = on ? g[9] : 0;
    lv.wgt[s] = on ? wgts[s] : 0.f;
    if (on && (g[6] < 0 || g[7] > g[0] || g[8] < 0 || g[9] > g[1] ||
               g[6] >= g[7] || g[8] >= g[9] || g[4] < 0 || g[5] < 0))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vol_bf16)
    return (int)launch<__nv_bfloat16>(lv, abc, lut, out, K, H, W, half_wnd,
                                      stride, st);
  return (int)launch<float>(lv, abc, lut, out, K, H, W, half_wnd, stride,
                            st);
}
