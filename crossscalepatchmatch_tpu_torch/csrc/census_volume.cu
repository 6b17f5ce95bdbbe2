// Kernel CENV: the census-Hamming cost volumes of both reference views at
// one level, from the two u8 RGB views as they are.
//
// Replaces the JAX engine's census_transform and per-slice loop in
// crossscalepatchmatch_tpu/ops/census.py (census_transform :24, _hamming
// :52, census_cost_volume :57, the slice loop :77), which XLA fuses inside
// run_pair's one jitted program.  It is not a Pallas kernel.  Plain
// version: ops/census.py census_cost_volume on ops/color.py
// rgb_to_gray_u8 (139 eager launches a level for both views).
//
// For each view: gray = (R * 4899 + G * 9617 + B * 1868 + 2^13) >> 14
// (OpenCV's fixed point, integer); the census code of pixel (y, x) has one
// bit for each offset (wy, wx) of the wnd x wnd window but its centre, in
// row-major order, set where gray(y, x) > gray((y + wy) mod H, (x + wx) mod
// W), a true modulo (a level may be narrower or lower than the window, so
// the window wraps more than once); then, for reference pixel (y, x) and d
// in [0, D), with ox = x - d (left reference) or x + d (right reference),
//   cost = popcount(code_ref(y, x) ^ code_oth(y, ox))   if 0 <= ox < W,
//   cost = wnd * wnd - 1                                 otherwise,
// as f32.  Exact by construction: everything is integers, and the bit
// order (bit b of word b / 32) does not change a Hamming distance.
//
// Two kernels a level, in one C call (codes, then volumes):
//   census_codes_kernel<WND>: a block codes a 32 x 8 tile of one view from
//     its gray tile with the window's halo in shared memory (each gray
//     value formed once a tile from the u8 view), into codes u32[2, H, W,
//     4 * quads], a pixel's words padded with zeros to whole 16-byte quads
//     (one quad up to wnd 9, two up to 15), 5.4 MB at the bench's level 0
//     (375 x 450, wnd 9), which stays in L2;
//   census_volume_kernel<WORDS>: the volume walk of GRDV (volume_walk.cuh):
//     a block copies the codes of its run's reference and other-view
//     columns to shared memory, then writes the run: per element a 16-byte
//     load of each code's quad (neighbouring lanes on neighbouring other-
//     view columns), an XOR and a __popc a word, every warp's stores one
//     aligned 128-byte line.
// Coding each pixel once in its own launch costs one launch more a level
// and the codes' round trip through L2; coding in the volume kernel would
// code the other view's columns again in every block that reads them
// (about twice at the bench's D = 61, 80 comparisons a code).
//
// What bounds it on the H100: the bytes of the volumes it writes (4 B an
// element against 3 B a pixel read): 82.4 MB at the bench's level 0.
// Limits: wnd in 1..15 (at most 7 words); the shared memory of a run's
// columns (volume_walk.cuh) at most 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "volume_walk.cuh"

namespace {

using namespace cspm_volume;

constexpr int kTileX = 32, kTileY = 8;   // a codes block's pixels

__device__ __forceinline__ int wrap(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

template <int WND>
__global__ void __launch_bounds__(kTileX * kTileY)
census_codes_kernel(View lv, View rv, uint32_t* __restrict__ codes, int H,
                    int W) {
  constexpr int kHalf = WND / 2;
  constexpr int kWords = (WND * WND - 1 + 31) / 32;
  constexpr int kQuads = (kWords + 3) / 4;
  constexpr int kGX = kTileX + 2 * kHalf, kGY = kTileY + 2 * kHalf;
  __shared__ uint8_t gray[kGY][kGX];
  const int v = blockIdx.z;
  const View src = v ? rv : lv;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  for (int i = threadIdx.x; i < kGY * kGX; i += blockDim.x) {
    const int gy = i / kGX, gx = i - gy * kGX;
    const uint32_t p = load_rgb(src, wrap(y0 + gy - kHalf, H),
                                wrap(x0 + gx - kHalf, W));
    gray[gy][gx] = (uint8_t)((chan(p, 0) * 4899u + chan(p, 1) * 9617u +
                              chan(p, 2) * 1868u + (1u << 13)) >> 14);
  }
  __syncthreads();
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  const int c = gray[ty + kHalf][tx + kHalf];
  uint32_t word[4 * kQuads];
#pragma unroll
  for (int k = 0; k < 4 * kQuads; ++k) word[k] = 0;
  int b = 0;
#pragma unroll
  for (int wy = 0; wy < WND; ++wy) {
#pragma unroll
    for (int wx = 0; wx < WND; ++wx) {
      if (wy == kHalf && wx == kHalf) continue;
      word[b >> 5] |= (uint32_t)(c > gray[ty + wy][tx + wx]) << (b & 31);
      ++b;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(codes) +
               ((size_t)(v * H + y) * W + x) * kQuads;
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
    dst[q] = make_uint4(word[4 * q], word[4 * q + 1], word[4 * q + 2],
                        word[4 * q + 3]);
}

template <int RIGHT, int WORDS>
__device__ __forceinline__ void census_run(const uint4* __restrict__ codes,
                                           float* __restrict__ out,
                                           const Geom& g, float bits,
                                           uint4* smem) {
  constexpr int kQuads = (WORDS + 3) / 4;
  const int y = blockIdx.y;
  const Span s = span_of<RIGHT>(blockIdx.x, g);
  const int nr = s.x_hi - s.x_lo + 1, no = s.o_hi - s.o_lo + 1;
  uint4* ref_s = smem;                  // [nr][kQuads]
  uint4* oth_s = smem + nr * kQuads;    // [no][kQuads]
  const uint4* ref = codes + ((size_t)(RIGHT * g.H + y) * g.W + s.x_lo) *
                                 kQuads;
  const uint4* oth = codes + ((size_t)((1 - RIGHT) * g.H + y) * g.W +
                              s.o_lo) * kQuads;
  for (int i = threadIdx.x; i < nr * kQuads; i += kThreads)
    ref_s[i] = ref[i];
  for (int i = threadIdx.x; i < no * kQuads; i += kThreads)
    oth_s[i] = oth[i];
  __syncthreads();

  const long long base = ((long long)(RIGHT * g.H + y) * g.W) * g.D;
  walk<RIGHT>(out, base, s, g, [&](int i, int j, bool in) {
    const uint4* r = ref_s + i * kQuads;
    const uint4* o = oth_s + (in ? j : 0) * kQuads;
    int n = 0;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const uint4 a = r[q], b = o[q];
      n += __popc(a.x ^ b.x);
      if (4 * q + 1 < WORDS) n += __popc(a.y ^ b.y);
      if (4 * q + 2 < WORDS) n += __popc(a.z ^ b.z);
      if (4 * q + 3 < WORDS) n += __popc(a.w ^ b.w);
    }
    return in ? (float)n : bits;
  });
}

template <int WORDS>
__global__ void __launch_bounds__(kThreads)
census_volume_kernel(const uint4* __restrict__ codes, float* __restrict__ out,
                     Geom g, float bits) {
  extern __shared__ uint4 smem[];
  if (blockIdx.z)
    census_run<1, WORDS>(codes, out, g, bits, smem);
  else
    census_run<0, WORDS>(codes, out, g, bits, smem);
}

template <int WND>
int launch(View lv, View rv, uint32_t* codes, float* out, int H, int W,
           int D, cudaStream_t stream) {
  constexpr int kWords = (WND * WND - 1 + 31) / 32;
  if constexpr (kWords > 0) {
    dim3 grid((unsigned)((W + kTileX - 1) / kTileX),
              (unsigned)((H + kTileY - 1) / kTileY), 2);
    census_codes_kernel<WND><<<grid, kTileX * kTileY, 0, stream>>>(
        lv, rv, codes, H, W);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int kQuads = (kWords + 3) / 4;
  const size_t smem =
      16 * (size_t)kQuads * (ref_cols_max(W) + oth_cols_max(W, D));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        census_volume_kernel<kWords>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return refused(e);
  }
  dim3 grid((unsigned)segments(W, D), (unsigned)H, 2);
  census_volume_kernel<kWords><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const uint4*>(codes), out, geom(H, W, D),
      (float)(WND * WND - 1));
  return (int)cudaGetLastError();
}

}  // namespace

// l / r: u8[H, W, 3] RGB views, strides (sy, sx, sc) in elements; codes:
// u32[2, H, W, 4 * quads] scratch, 16-byte aligned, quads = ceil(words /
// 4), words = ceil((wnd^2 - 1) / 32) (unused at wnd 1); out: f32[2, H, W, D], contiguous and 128-byte aligned.  Two
// launches write both views' volumes.  Returns cudaSuccess or the first
// error.
extern "C" int cspm_census_volume(const void* l, long long lsy,
                                  long long lsx, long long lsc, const void* r,
                                  long long rsy, long long rsx, long long rsc,
                                  void* codes, void* out, int H, int W, int D,
                                  int wnd, void* stream) {
  if (H < 1 || W < 1 || D < 1 || H > 65535 ||
      (long long)W * D > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const View lv{static_cast<const uint8_t*>(l), lsy, lsx, lsc};
  const View rv{static_cast<const uint8_t*>(r), rsy, rsx, rsc};
  uint32_t* c = static_cast<uint32_t*>(codes);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (wnd) {
    case 1: return launch<1>(lv, rv, c, o, H, W, D, st);
    case 3: return launch<3>(lv, rv, c, o, H, W, D, st);
    case 5: return launch<5>(lv, rv, c, o, H, W, D, st);
    case 7: return launch<7>(lv, rv, c, o, H, W, D, st);
    case 9: return launch<9>(lv, rv, c, o, H, W, D, st);
    case 11: return launch<11>(lv, rv, c, o, H, W, D, st);
    case 13: return launch<13>(lv, rv, c, o, H, W, D, st);
    case 15: return launch<15>(lv, rv, c, o, H, W, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
