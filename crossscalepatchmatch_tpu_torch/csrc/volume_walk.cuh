// What the cost-volume kernels GRDV (grd_volume.cu) and CENV
// (census_volume.cu) share: the split of a level's f32[2, H, W, D] volume
// into blocks, the reference and other-view columns a block reads, and the
// walk that writes a block's outputs.
//
// A block (blockIdx.x = segment, blockIdx.y = row y, blockIdx.z = view:
// 0 the left-referenced volume, 1 the right-referenced one) writes the
// flat outputs [e_lo, e_hi) of its row, e = x * D + d, one contiguous run
// of the volume.  The run spans at most kSegCols + 2 reference columns, so
// the other view's columns it reads (x - d, or x + d) are at most
// kSegCols + 1 + D: what a block stages in shared memory is bounded by the
// depth, not by the width.  A run is 32 outputs a thread (8,192), or fewer
// where D is small: a block's fixed costs (its span, a division for each
// thread's first element, the prologue that stages its columns) then
// spread over many outputs.
//
// The walk: thread t takes the elements whose global index is
// (g_lo & ~31) + t + k * kThreads, g_lo the run's first, so the 32 stores
// of a warp are one aligned 128-byte line of the volume (its base is a
// fresh torch allocation, 512-byte aligned).  Each thread finds its first
// element by one division and then steps by kThreads elements with adds
// and one compare, carrying the indices its cost reads: i = x - x_lo, the
// reference column's slot, and j = ox - o_lo, the other view's, with ox =
// x - d (left reference) or x + d (right); ox lies in the image where j
// >= -o_lo (left) or j < W - o_lo (right), one compare.  Neighbouring
// lanes hold neighbouring d of one x (or of two), so their other-view
// reads are neighbouring slots of shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cspm_volume {

constexpr int kThreads = 256;
constexpr int kSegMax = kThreads * 32;   // outputs a block writes at most
constexpr int kSegCols = 128;            // reference columns of a run, about

// A block's run length at depth D: kSegMax, or fewer where D is small so
// that the run spans at most kSegCols + 2 reference columns.
__host__ __device__ inline int seg_len(int D) {
  return D >= kSegMax / kSegCols ? kSegMax : D * kSegCols;
}

// Columns a block stages at most: reference, and other view.
__host__ __device__ inline int ref_cols_max(int W) {
  return W < kSegCols + 2 ? W : kSegCols + 2;
}
__host__ __device__ inline int oth_cols_max(int W, int D) {
  return (long long)W < (long long)kSegCols + 1 + D ? W : kSegCols + 1 + D;
}

// Blocks a row of W * D outputs takes.
__host__ inline int segments(int W, int D) {
  const long long n = (long long)W * D;
  return (int)((n + seg_len(D) - 1) / seg_len(D));
}

// A C entry's refusal of a launch whose block would take more shared
// memory than the card allows (cudaFuncSetAttribute's error): the error,
// cleared from the runtime's last error so that no later launch's check
// reads it again.  The wrappers raise on it; they do not restate the
// block's shared memory.
__host__ inline int refused(cudaError_t e) {
  (void)cudaGetLastError();
  return (int)e;
}

// The launch's geometry: the level's shape, and a thread's step of
// kThreads elements as (columns, depths), formed once on the host.
struct Geom {
  int H, W, D, sx, sd;
};

__host__ inline Geom geom(int H, int W, int D) {
  return Geom{H, W, D, kThreads / D, kThreads % D};
}

// A block's outputs [e_lo, e_hi) of its row, its reference columns [x_lo,
// x_hi] and the other view's columns [o_lo, o_hi] they read in range.
struct Span {
  int e_lo, e_hi, x_lo, x_hi, o_lo, o_hi;
};

template <int RIGHT>
__device__ inline Span span_of(int seg, const Geom& g) {
  Span s;
  const int len = seg_len(g.D);
  s.e_lo = seg * len;
  s.e_hi = min(s.e_lo + len, g.W * g.D);
  s.x_lo = s.e_lo / g.D;
  s.x_hi = (s.e_hi - 1) / g.D;
  s.o_lo = RIGHT ? s.x_lo : max(0, s.x_lo - (g.D - 1));
  s.o_hi = RIGHT ? min(g.W - 1, s.x_hi + g.D - 1) : s.x_hi;
  return s;
}

// out[base + e] = cost(i, j, in) for e = x * D + d in the span's run, by
// the walk above: i = x - x_lo, j = ox - o_lo, in = (0 <= ox < W).
template <int RIGHT, class Cost>
__device__ __forceinline__ void walk(float* __restrict__ out, long long base,
                                     const Span& s, const Geom& g,
                                     Cost cost) {
  const int D = g.D;
  // the first element, at most 31 before e_lo (so possibly negative)
  int e = (int)(((base + s.e_lo) & ~31LL) - base) + (int)threadIdx.x;
  int x = e >= 0 ? e / D : -1 - (-e - 1) / D;
  int d = e - x * D;
  int i = x - s.x_lo;
  int j = (RIGHT ? x + d : x - d) - s.o_lo;
  const int sj = RIGHT ? g.sx + g.sd : g.sx - g.sd;
  const int wj = RIGHT ? 1 - D : 1 + D;   // j's step when d wraps
  const int jb = RIGHT ? g.W - s.o_lo : -s.o_lo;
  float* p = out + base + e;
  if (e < s.e_lo) {   // the run's head, before the aligned start
    e += kThreads;
    p += kThreads;
    i += g.sx;
    d += g.sd;
    j += sj;
    if (d >= D) {
      d -= D;
      ++i;
      j += wj;
    }
  }
  for (; e < s.e_hi; e += kThreads, p += kThreads) {
    *p = cost(i, j, RIGHT ? j < jb : j >= jb);
    i += g.sx;
    d += g.sd;
    j += sj;
    if (d >= D) {
      d -= D;
      ++i;
      j += wj;
    }
  }
}

// A u8[H, W, 3] view with its strides in elements (any layout: a band's
// rows, a column slice).
struct View {
  const uint8_t* p;
  long long sy, sx, sc;
};

// Pixel (y, x) as R | G << 8 | B << 16, the layout __vsadu4 reads.
__device__ __forceinline__ uint32_t load_rgb(const View& v, int y, int x) {
  const uint8_t* q = v.p + y * v.sy + x * v.sx;
  return (uint32_t)q[0] | (uint32_t)q[v.sc] << 8 |
         (uint32_t)q[2 * v.sc] << 16;
}

__device__ __forceinline__ uint32_t chan(uint32_t p, int c) {
  return (p >> (8 * c)) & 0xffu;
}

}  // namespace cspm_volume
