// Shared parts of the slanted-plane ASW window kernels (K4 in
// cross_scale_cost.cu, which at one level is also K1 and K3's volume form;
// the fly kernel in fly_cost.cu; K2 in quadrant_build.cu takes the
// pair-layout loads): the thread layout, the per-row in-image interval, the
// conversion-free truncation, the candidate plane a thread owns, and the
// window loop of one pyramid level over a volume.
//
// Thread layout: a block is a 32 x TY tile of fine pixels (TY = blockDim.y:
// 16, or 8 where the fly kernel's staging needs it), a thread owns one fine
// pixel of one candidate plane (blockIdx.z = view * K + candidate), and its
// sum keeps the plain version's order: dy-major, dx ascending, a skipped
// sample adds nothing.  (A chunk of 2 or 4 candidates per thread, sharing
// the staged pixel and its weight, was measured on an H100 and dropped one
// sample at a time: the shared part is about 10 of a sample's 33 (K4) to 67
// (fly) instructions, the compiler saved 2 of them per candidate, and the
// registers of the second chain cost more than that.  The fly kernel's
// shared-row designs take 1 to 8 candidates a thread, where the shared part
// grows: a row's slice costs (cost lerp), the taps' unpack and the pixel's
// (image lerp; see fly_cost.cu).)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cspm {

constexpr int kTX = 32;
constexpr int kMaxTY = 16;
constexpr int kThreads = kTX * kMaxTY;
// Two 512-thread blocks an SM (32 resident warps): 64 registers a thread.
constexpr int kMinBlocks = 2;
constexpr int kLutN = 766;  // 3 * 255 + 1
constexpr int kMaxLevels = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the H100's per-block maximum

// The window offsets of one axis are -hw + i * stride, i = 0, 1, ...; Span
// holds the i whose pixel c - hw + i * stride lies inside [lo, hi), the
// axis's valid interval (the array's extent, or on a spatial tile the part
// of its halo-extended block inside the global image; lo <= c < hi).  The
// valid samples of a row are one such interval, found once per level
// instead of a test per sample.
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span axis_span(int c, int lo, int hi, int hw,
                                          int stride) {
  const int below = hw - (c - lo);  // offsets before pixel lo
  Span s;
  s.lo = below > 0 ? (below + stride - 1) / stride : 0;
  s.hi = min(2 * hw, hi - 1 - c + hw) / stride;  // c < hi: never negative
  return s;
}
__device__ __forceinline__ Span axis_span(int c, int n, int hw, int stride) {
  return axis_span(c, 0, n, hw, stride);
}

// 2^23 + trunc(x) for 1 <= x < 2^22, rounded toward zero: the integer
// trunc(x) sits in the low mantissa bits and (float)(trunc(x) + 1) is an
// exact subtraction, so a sample needs neither F2I nor I2F (both run on a
// pipe an eighth as wide as the FMA pipe).
__device__ __forceinline__ float biased_trunc(float x) {
  return __fadd_rz(x, 8388608.f);
}
__device__ __forceinline__ int trunc_of(float biased) {
  return __float_as_int(biased) & 0x7fffff;
}
__device__ __forceinline__ float trunc_plus_one(float biased) {
  return __fsub_rn(biased, 8388607.f);
}

// The candidate plane of a thread: (a, b, d0 = a*x + b*y + c) of candidate
// k at fine pixel (x, y) of view v.
struct Plane {
  float a, b, d0;
};

__device__ __forceinline__ Plane load_plane(
    const float* __restrict__ abc,  // [2, K, H, W, 3], pix the pixel's index
    size_t pix, int x, int y) {
  Plane p;
  p.a = abc[pix * 3];
  p.b = abc[pix * 3 + 1];
  p.d0 = __fadd_rn(
      __fadd_rn(__fmul_rn(p.a, (float)x), __fmul_rn(p.b, (float)y)),
      abc[pix * 3 + 2]);
  return p;
}

// The two lerp taps vol[q, f], vol[q, f + 1] of a window sample.  The
// volume is in the pair layout: element f of a pixel's depth row holds both,
// so they are one aligned load (4 bytes for bf16, 8 for f32) where the plain
// D-minor layout needs two, the first 4-byte aligned only when q * D + f is
// even.
__device__ __forceinline__ float2 load_taps(const float2* p) {
  return __ldg(p);
}
__device__ __forceinline__ float2 load_taps(const __nv_bfloat162* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Element type of a pair-layout volume of VT (f32 or bf16).
template <typename VT>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

// Window cost of one pyramid level over a precomputed volume for one
// candidate plane:
//   sum over the valid offsets (dy, dx), dy-major, of
//     lut[L1(center, q)] * val(q),   q = (cy + dy, cx + dx),
//   dq = ((d_f + a*dx) + b*dy),
//   val = lerp(vol[q, f], vol[q, f+1]) at f = trunc(dq) when
//         1 <= dq < fmax, else maxc.
// A window pixel is valid inside [ylo, yhi) x [xlo, xhi) of the level's
// arrays (their extent, or a spatial tile's clip of its extended block).
// s_img is the block's staged tile of packed pixels (row length tile_w),
// (lx, ly) the center in tile coordinates, vol the view's level volume
// [., ws, ds] in the pair layout, E the pair type (fewer than 2^31
// elements: offsets are 32-bit).  The
// sample has no branch: the taps' load is predicated on the range test and
// the lerp runs either way, so the loads of consecutive samples overlap;
// the staged pixel, the depth row's offset and dx advance as running
// values.
template <typename E>
__device__ __forceinline__ float volume_level_cost(
    const uint32_t* s_img, int tile_w, int lx, int ly, const float* s_lut,
    const E* vol, int ws, int ds, int ylo, int yhi, int xlo, int xhi,
    int cx, int cy, int hw, int stride, float maxc, float fmax, float a,
    float b, float d_f) {
  const float fstride = (float)stride;
  const Span sy = axis_span(cy, ylo, yhi, hw, stride);
  const Span sx = axis_span(cx, xlo, xhi, hw, stride);
  const int dx0 = sx.lo * stride - hw;  // the row's first valid offset
  const int vstep = stride * ds;
  const uint32_t col_c = s_img[ly * tile_w + lx];
  float acc = 0.f;
  for (int iy = sy.lo; iy <= sy.hi; ++iy) {
    const int dy = iy * stride - hw;
    const float bdy = __fmul_rn(b, (float)dy);
    const uint32_t* q_ptr = s_img + (ly + dy) * tile_w + (lx + dx0);
    int voff = ((cy + dy) * ws + (cx + dx0)) * ds;  // q's depth row
    float fdx = (float)dx0;
    for (int i = sx.lo; i <= sx.hi; ++i) {
      const float wgt = s_lut[__vsadu4(col_c, *q_ptr)];
      const float dq = __fadd_rn(__fadd_rn(d_f, __fmul_rn(a, fdx)), bdy);
      const bool in = dq >= 1.f && dq < fmax;  // NaN fails both
      const float t = biased_trunc(dq);
      float2 tap = make_float2(0.f, 0.f);
      if (in) tap = load_taps(vol + (voff + trunc_of(t)));
      const float fw = __fsub_rn(trunc_plus_one(t), dq);
      const float val = __fadd_rn(__fmul_rn(fw, tap.x),
                                  __fmul_rn(__fsub_rn(1.f, fw), tap.y));
      acc = __fadd_rn(acc, __fmul_rn(wgt, in ? val : maxc));
      q_ptr += stride;
      voff += vstep;
      fdx += fstride;  // small integers: exact, equal to (float)dx
    }
  }
  return acc;
}

}  // namespace cspm
