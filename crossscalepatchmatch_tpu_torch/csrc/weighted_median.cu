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
// one sequential f32 sum in a register, in window order, adding w_o only
// where q lies in the array, is valid and has dis_q <= t.  Every term the
// plain version adds that this skips is +0.0, and adding +0.0 to a
// non-negative sum leaves it unchanged; lut * 1.0 is exact; a sum has no
// product, so no FMA contraction can change it.  So S(t) here is the plain
// version's acc[p, t] bit for bit, and since a sequential sum of
// non-negative terms is monotone in t, the bisection (the JAX engine's: lo
// = 0, hi = 255, 8 steps) picks the plain version's t.  A pixel's sum is
// never split across lanes and never binned: either would round in another
// order and could pick another t on a tie.
//
// Inputs: pix u32[2, H, W] (B | G << 8 | R << 16, the layout __vsadu4
// reads), key i16[2, H, W] (dis where valid, 256 where not: the threshold
// test key <= t, t <= 255, drops an invalid pixel with no test of its
// own), lut f32[766] (plane_cost.asw_lut, built on the card: the plain
// version's weights bit for bit), idx i64[2 * Ho * Wo] whose first n
// entries are the invalid output pixels, view-major in raster order
// (neighbouring lanes on neighbouring pixels, so their window loads share
// cache lines), and n on the device (the list is built without a host
// round trip; the grid covers every output pixel and blocks past n return
// at once).
//
// Band form (a spatial tile of parallel.tiled): the arrays are the tile's
// block with its halo, output pixel (y, x) is array pixel (y + oy, x + ox)
// of an Ho x Wo output; window pixels past the global image carry key 256
// (the caller's valid = 0).  On one device Ho x Wo = H x W and the origin
// is 0.
//
// What bounds it on the H100: instruction issue.  An invalid pixel takes 9
// passes over its window (the total, then 8 bisection steps); a sample of
// a pass is a 2-byte key load, a 4-byte pixel load, VABSDIFF4, a table
// read from shared memory and an FADD, about 10 instructions with the loop.
// Its bytes are few (the packed arrays of a 375 x 1242 pair, 2.8 MB, stay
// in L2).  The design keeps the instructions per sample few: the table in
// shared memory, the window clipped to the array once per pixel (no bounds
// test per sample), the validity folded into the threshold test, one
// thread a pixel so a warp walks 32 neighbouring windows in step.

#include "window_common.cuh"

namespace {

using cspm::kLutN;

constexpr int kWmfThreads = 128;

// S(t) over the window rows [y0, y1] and columns [x0, x1] of one view.
__device__ __forceinline__ float window_sum(
    const uint32_t* __restrict__ pix, const int16_t* __restrict__ key, int w,
    int y0, int y1, int x0, int x1, uint32_t center,
    const float* __restrict__ s_lut, int t) {
  float s = 0.f;
  for (int y = y0; y <= y1; ++y) {
    const int row = y * w;
    for (int x = x0; x <= x1; ++x) {
      if (__ldg(key + row + x) <= t)
        s = __fadd_rn(s, s_lut[__vsadu4(center, __ldg(pix + row + x))]);
    }
  }
  return s;
}

__global__ void __launch_bounds__(kWmfThreads)
    weighted_median_kernel(const uint32_t* __restrict__ pix,
                           const int16_t* __restrict__ key,
                           const float* __restrict__ lut,
                           const long long* __restrict__ idx,
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
  const int o = (int)idx[i];  // v * Ho * Wo + y * Wo + x
  const int plane = ho * wo;
  const int v = o / plane;
  const int r = o - v * plane;
  const int py = r / wo + oy;
  const int px = r - (r / wo) * wo + ox;
  const long base = (long)v * h * w;
  const uint32_t* vpix = pix + base;
  const int16_t* vkey = key + base;
  const int y0 = max(py - hw, 0), y1 = min(py + hw, h - 1);
  const int x0 = max(px - hw, 0), x1 = min(px + hw, w - 1);
  const uint32_t center = vpix[py * w + px];
  const float half = __fmul_rn(
      window_sum(vpix, vkey, w, y0, y1, x0, x1, center, s_lut, 255), 0.5f);
  if (!(half > 0.f)) return;
  int lo = 0, hi = 255;
  for (int step = 0; step < 8; ++step) {
    const int mid = (lo + hi) >> 1;
    if (window_sum(vpix, vkey, w, y0, y1, x0, x1, center, s_lut, mid) >=
        half)
      hi = mid;
    else
      lo = mid + 1;
  }
  out[o] = (uint8_t)lo;
}

}  // namespace

// pix: u32[2, h, w]; key: i16[2, h, w]; lut: f32[766]; idx: i64[2 * ho *
// wo], the first *n the invalid output pixels; n: one int on the device;
// out: u8[2, ho, wo] holding dis's output window, overwritten at the
// replaced pixels.  Output pixel (y, x) is array pixel (y + oy, x + ox).
extern "C" int cspm_weighted_median(const void* pix, const void* key,
                                    const void* lut, const void* idx,
                                    const void* n, void* out, int h, int w,
                                    int ho, int wo, int oy, int ox, int hw,
                                    void* stream) {
  if (h <= 0 || w <= 0 || ho <= 0 || wo <= 0 || oy < 0 || ox < 0 ||
      oy + ho > h || ox + wo > w || hw < 0 || 2L * h * w > 0x7fffffffL)
    return cudaErrorInvalidValue;
  const int cells = 2 * ho * wo;
  const int blocks = (cells + kWmfThreads - 1) / kWmfThreads;
  weighted_median_kernel<<<blocks, kWmfThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(pix), static_cast<const int16_t*>(key),
      static_cast<const float*>(lut), static_cast<const long long*>(idx),
      static_cast<const int*>(n), static_cast<uint8_t*>(out), h, w, ho, wo,
      oy, ox, hw);
  return cudaGetLastError();
}
