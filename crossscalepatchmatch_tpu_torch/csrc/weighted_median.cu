// Kernel WMF: the colour-weighted median of post-processing, at the
// LR-invalid pixels of both views.
//
// Replaces the JAX engine's device loop in crossscalepatchmatch_tpu/models/
// postprocess.py weighted_median: a lax.fori_loop over the window offsets
// (:151), run once for the total and once for each of the 8 steps of the
// bisection's fori_loop (:185).  It is not a Pallas kernel but a loop XLA
// keeps on the device.  Plain version: models/postprocess.py
// weighted_median_plain (an f32[N, 256] accumulator, one add per window
// offset).
//
// At an invalid output pixel p, over the window offsets o in dy-major
// order (dx ascending), with w_o = lut[L1(img_p, img_q)] * valid_q (a
// window pixel outside the array weighs 0):
//   S(t) = sum_o w_o * [dis_q <= t],    a sequential f32 sum;
// the median is the smallest t in 0..255 with S(t) >= 0.5 * S(255), and p
// takes it when 0.5 * S(255) > 0.  Every other output pixel keeps dis.
//
// Exactness (u8-equal to the plain version): a thread forms each S(t) as
// one sequential f32 sum in a register of its own, in window order, adding
// w_o only where q lies in the array, is valid and has dis_q <= t.  Every
// term the plain version adds that this skips is +0.0, and adding +0.0 to a
// non-negative sum leaves it unchanged; lut * 1.0 is exact; a sum has no
// product, so no FMA contraction can change it.  So S(t) here is the plain
// version's acc[p, t] bit for bit.  The sums of two thresholds add nested
// subsets of the same terms in the same order, and f32 round-to-nearest
// addition is monotone, so S is monotone in t and any search for the
// smallest t with S(t) >= half returns the plain version's t, ties
// included.  A pixel's sum is never split across lanes and never binned:
// either would round in another order and could move a tie.
//
// The search: 16 thresholds a pass.  Pass 1 forms S(15), S(31), ...,
// S(255) together (S(255) gives half); pass 2 forms the 15 sums inside the
// first bucket of 16 levels whose last sum reaches half.  2 passes over the
// window instead of the bisection's 1 + 8.
//
// Inputs (cspm_wmf_prepare makes them from dis, imgs and valid, two
// launches): packed u32[2, H, W, 2], per pixel its colour B | G << 8 | R <<
// 16 (the layout __vsadu4 reads) and its key, dis where valid and 256
// where not (the threshold test key <= t, t <= 255, drops an invalid pixel
// with no test of its own), one 8-byte load a sample; idx i32[2 * Ho * Wo]
// whose first n entries are the invalid output pixels, view-major in
// raster order (neighbouring lanes on neighbouring pixels, so their window
// loads share cache lines), and n on the device (no host round trip; the
// grid covers every output pixel and blocks past n return at once); lut
// f32[766] (plane_cost.asw_lut, built on the card: the plain version's
// weights bit for bit).
//
// Band form (a spatial tile of parallel.tiled): the arrays are the tile's
// block with its halo, output pixel (y, x) is array pixel (y + oy, x + ox)
// of an Ho x Wo output; window pixels past the global image carry key 256
// (the caller's valid = 0).  On one device Ho x Wo = H x W and the origin
// is 0.
//
// What bounds it on the H100: the work a pass repeats for every window
// sample (an 8-byte load, VABSDIFF4, a table read from shared memory), not
// bytes (the packed words of a 375 x 1242 pair, 7.5 MB, stay in L2) and
// not the compare and predicated FADD each threshold adds: so fewer, wider
// passes win even where they add instructions.  In a one-off comparison of
// variants on an H100 (the variants are not kept in the repository, so it
// cannot be rerun; tools/torch_kernel_ab.py times this kernel only against
// another checkout's), 16 thresholds a pass ran faster than 4, and 4
// faster than 2, and the window row unrolled by 4 faster than by 1 or 2
// and no slower than by 8.
// The design: the 16 (15) sums of a pass are independent FADD chains sharing
// one load and one weight; the window row is unrolled by 4, so four
// samples' loads are in flight ahead of their adds; the table sits in
// shared memory; the window is clipped to the array once per pixel (no
// bounds test per sample); one thread a pixel, so a warp walks 32
// neighbouring windows in step.  ptxas (sm_90a): 63 registers, no spill,
// 3 KB shared memory, 32 warps an SM.

#include "window_common.cuh"

namespace {

using cspm::kLutN;

constexpr int kWmfThreads = 128;
// thresholds a pass of the search: 256 levels = kArity buckets of kArity
constexpr int kArity = 16;
// output pixels a block of the preparation covers
constexpr int kChunk = 1024;

// Array index of output pixel o (view-major, raster order).
__device__ __forceinline__ int array_index(int o, int h, int w, int ho,
                                           int wo, int oy, int ox) {
  const int plane = ho * wo;
  const int v = o / plane;
  const int r = o - v * plane;
  const int y = r / wo;
  return (v * h + y + oy) * w + (r - y * wo) + ox;
}

// Packs every array pixel, and counts the invalid output pixels of each
// chunk of kChunk (counts[blockIdx.x]).  Grid: ceil(2 * h * w / kChunk).
__global__ void __launch_bounds__(kChunk)
wmf_pack_count_kernel(const uint8_t* __restrict__ dis,
                      const uint8_t* __restrict__ imgs,
                      const uint8_t* __restrict__ valid,
                      uint2* __restrict__ packed, int* __restrict__ counts,
                      int h, int w, int ho, int wo, int oy, int ox) {
  const int i = blockIdx.x * kChunk + threadIdx.x;
  if (i < 2 * h * w) {
    const uint8_t* c = imgs + 3LL * i;
    packed[i] = make_uint2(c[0] | c[1] << 8 | c[2] << 16,
                           valid[i] ? dis[i] : 256u);
  }
  const int n_out = 2 * ho * wo;
  if ((int)blockIdx.x * kChunk >= n_out) return;  // the whole block
  const bool inv =
      i < n_out && !valid[array_index(i, h, w, ho, wo, oy, ox)];
  const int cnt = __syncthreads_count(inv);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

// Writes the output window of dis into out and the invalid output pixels
// of chunk blockIdx.x into idx, after those of the chunks before it (in
// order, so idx is view-major raster order); the last block writes n.
// Grid: ceil(2 * ho * wo / kChunk).
__global__ void __launch_bounds__(kChunk)
wmf_compact_kernel(const uint8_t* __restrict__ dis,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ counts, int* __restrict__ idx,
                   int* __restrict__ n, uint8_t* __restrict__ out, int h,
                   int w, int ho, int wo, int oy, int ox) {
  constexpr int kWarps = kChunk / 32;
  __shared__ int s_part[kWarps];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the invalid pixels of the chunks before this one
  int part = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kChunk)
    part += counts[j];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(~0u, part, s);
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  if (warp == 0) {
    int b = s_part[lane];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) b += __shfl_xor_sync(~0u, b, s);
    if (lane == 0) s_base = b;
  }
  __syncthreads();
  const int o = blockIdx.x * kChunk + threadIdx.x;
  const int n_out = 2 * ho * wo;
  bool inv = false;
  if (o < n_out) {
    const int a = array_index(o, h, w, ho, wo, oy, ox);
    out[o] = dis[a];
    inv = !valid[a];
  }
  const unsigned ballot = __ballot_sync(~0u, inv);
  // exclusive prefix of the warps' counts
  if (lane == 0) s_part[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = s_part[lane];
    int incl = c;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(~0u, incl, s);
      if (lane >= s) incl += up;
    }
    s_part[lane] = incl - c;
    if (lane == 31 && blockIdx.x == gridDim.x - 1) *n = s_base + incl;
  }
  __syncthreads();
  if (inv)
    idx[s_base + s_part[warp] + __popc(ballot & ((1u << lane) - 1))] = o;
}

// s[j] = S(t[j]) over the window rows [y0, y1] and columns [x0, x1] of one
// view, each a sequential sum in window order.
template <int NT>
__device__ __forceinline__ void window_sums(
    const uint2* __restrict__ vp, int w, int y0, int y1, int x0, int x1,
    uint32_t center, const float* __restrict__ s_lut, const int (&t)[NT],
    float (&s)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j] = 0.f;
  for (int y = y0; y <= y1; ++y) {
    const uint2* row = vp + y * w;
#pragma unroll 4
    for (int x = x0; x <= x1; ++x) {
      const uint2 q = __ldg(row + x);
      const float wt = s_lut[__vsadu4(center, q.x)];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if ((int)q.y <= t[j]) s[j] = __fadd_rn(s[j], wt);
    }
  }
}

__global__ void __launch_bounds__(kWmfThreads)
    weighted_median_kernel(const uint2* __restrict__ packed,
                           const float* __restrict__ lut,
                           const int* __restrict__ idx,
                           const int* __restrict__ n_ptr,
                           uint8_t* __restrict__ out, int h, int w, int ho,
                           int wo, int oy, int ox, int hw) {
  __shared__ float s_lut[kLutN];
  const int n = *n_ptr;
  const int first = blockIdx.x * kWmfThreads;
  if (first >= n) return;  // the whole block: no thread reaches the barrier
  for (int i = threadIdx.x; i < kLutN; i += kWmfThreads) s_lut[i] = lut[i];
  __syncthreads();
  const int i = first + threadIdx.x;
  if (i >= n) return;
  const int o = idx[i];  // v * Ho * Wo + y * Wo + x
  const int plane = ho * wo;
  const int v = o / plane;
  const int r = o - v * plane;
  const int py = r / wo + oy;
  const int px = r - (r / wo) * wo + ox;
  const uint2* vp = packed + (long)v * h * w;
  const int y0 = max(py - hw, 0), y1 = min(py + hw, h - 1);
  const int x0 = max(px - hw, 0), x1 = min(px + hw, w - 1);
  const uint32_t center = vp[py * w + px].x;
  int t[kArity];
  float s[kArity];
#pragma unroll
  for (int j = 0; j < kArity; ++j) t[j] = (j + 1) * kArity - 1;
  window_sums(vp, w, y0, y1, x0, x1, center, s_lut, t, s);
  const float half = __fmul_rn(s[kArity - 1], 0.5f);
  if (!(half > 0.f)) return;
  // the first bucket of kArity levels whose last sum reaches half (the
  // last bucket's does): the median is one of its levels
  int lo = (kArity - 1) * kArity;
#pragma unroll
  for (int j = kArity - 2; j >= 0; --j)
    if (s[j] >= half) lo = j * kArity;
  int tn[kArity - 1];
  float sn[kArity - 1];
#pragma unroll
  for (int m = 0; m < kArity - 1; ++m) tn[m] = lo + m;
  window_sums(vp, w, y0, y1, x0, x1, center, s_lut, tn, sn);
  int med = lo + kArity - 1;
#pragma unroll
  for (int m = kArity - 2; m >= 0; --m)
    if (sn[m] >= half) med = lo + m;
  out[o] = (uint8_t)med;
}

}  // namespace

// dis: u8[2, h, w]; imgs: u8[2, h, w, 3]; valid: u8 (bool) [2, h, w], all
// contiguous; packed: u32[2, h, w, 2]; counts: i32[n_counts] scratch,
// refused if shorter than ceil(2 * h * w / kChunk); idx: i32[2 * ho * wo];
// n: one int; out: u8[2, ho, wo], the output window of dis.  Two launches.
extern "C" int cspm_wmf_prepare(const void* dis, const void* imgs,
                                const void* valid, void* packed, void* counts,
                                int n_counts, void* idx, void* n, void* out,
                                int h, int w, int ho, int wo, int oy, int ox,
                                void* stream) {
  if (h <= 0 || w <= 0 || ho <= 0 || wo <= 0 || oy < 0 || ox < 0 ||
      oy + ho > h || ox + wo > w || 2L * h * w > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int arr_blocks = (2 * h * w + kChunk - 1) / kChunk;
  if (n_counts < arr_blocks) return cudaErrorInvalidValue;
  const int out_blocks = (2 * ho * wo + kChunk - 1) / kChunk;
  const uint8_t* d = static_cast<const uint8_t*>(dis);
  const uint8_t* vl = static_cast<const uint8_t*>(valid);
  wmf_pack_count_kernel<<<arr_blocks, kChunk, 0, st>>>(
      d, static_cast<const uint8_t*>(imgs), vl, static_cast<uint2*>(packed),
      static_cast<int*>(counts), h, w, ho, wo, oy, ox);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wmf_compact_kernel<<<out_blocks, kChunk, 0, st>>>(
      d, vl, static_cast<const int*>(counts), static_cast<int*>(idx),
      static_cast<int*>(n), static_cast<uint8_t*>(out), h, w, ho, wo, oy,
      ox);
  return cudaGetLastError();
}

// packed, idx, n as cspm_wmf_prepare leaves them; lut: f32[766]; out:
// u8[2, ho, wo] holding dis's output window, overwritten at the replaced
// pixels.  Output pixel (y, x) is array pixel (y + oy, x + ox).
extern "C" int cspm_weighted_median(const void* packed, const void* lut,
                                    const void* idx, const void* n,
                                    void* out, int h, int w, int ho, int wo,
                                    int oy, int ox, int hw, void* stream) {
  if (h <= 0 || w <= 0 || ho <= 0 || wo <= 0 || oy < 0 || ox < 0 ||
      oy + ho > h || ox + wo > w || hw < 0 || 2L * h * w > 0x7fffffffL)
    return cudaErrorInvalidValue;
  const int cells = 2 * ho * wo;
  const int blocks = (cells + kWmfThreads - 1) / kWmfThreads;
  weighted_median_kernel<<<blocks, kWmfThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(packed), static_cast<const float*>(lut),
      static_cast<const int*>(idx), static_cast<const int*>(n),
      static_cast<uint8_t*>(out), h, w, ho, wo, oy, ox, hw);
  return cudaGetLastError();
}
