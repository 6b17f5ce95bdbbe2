// Kernel K2: ASW quadrant-volume build.
//
// Replaces the Pallas TPU kernel crossscalepatchmatch_tpu/ops/pallas/
// quadrant_build.py `_kernel` (launched by quadrant_volumes_prepared).
// Plain version: ops/prescreen_volume.py build_quadrant_volumes.
//
// For view v, pixel c and quadrant Q in order (--), (-+), (+-), (++):
//   bq[v, Q, c, d] = sum_{o in Q} w(c, c+o) * vol[v, c+o, d]
//   wq[v, Q, c]    = sum_{o in Q} w(c, c+o)
// over in-image q = c + o, with per-axis offsets range(-hw, 0, stride)
// (- side) and range(0, hw + 1, stride) (+ side), dy-major.
//
// Band form (a spatial tile of parallel.tiled; JAX tiled.py:298-324 builds
// over the whole extended block and slices its centre): the input arrays
// are [H, W] (the tile's block with a half_wnd halo), the output covers
// the Ho x Wo centres from array position (oy, ox), and a window pixel
// counts inside [ylo, yhi) x [xlo, xhi) (the part of the block inside the
// global image).  On one device: Ho x Wo = H x W, origin 0, the rectangle
// the array.
//
// What bounds it on the H100: instruction issue.  Its useful work is 2 x
// H x W x 324 offsets x D multiply-adds (6.7 G at the bench shape, 375 x
// 450, D = 61, half_wnd 17, stride 2), and to stay bit-equal with the plain
// version (a multiply, then an add, as separate PyTorch ops) each is an
// FMUL and an FADD, not an FMA: the floor is twice the f32 bound.  Its
// output, f32[2, 4, H, W, D] (329 MB at the bench shape), is written once.
// The design keeps the instructions other than those two per slice few
// (per window offset and 16 slices the loop is 64 instructions, 32 of them
// FMUL / FADD):
//   * a block owns a 32 x 8 tile of pixels and one chunk of 16 slices
//     (blockIdx.x = tile * chunks + chunk: the chunks of a tile run side
//     by side); a thread owns one pixel and its 16 slices, so the weight
//     (one VABSDIFF4 and a table read) serves 16 slices;
//   * the tile's packed pixels plus the half_wnd halo are staged once; the
//     volume slab (the tile's columns plus the halo, 16 slices, as stored:
//     f32, or bf16 widened in registers) is staged row by row in a ring:
//     offset row dy needs rows [y0 + dy, y0 + dy + 8), and the rows the
//     next offset row adds are copied (cp.async) while this one is summed,
//     so a step waits on no load and has one barrier; a thread reads its
//     16 slices with 16-byte shared loads, the layout
//     [row][slices / vector][column] free of bank conflicts;
//   * the two quadrants that share a row of offsets (-- and -+, then +- and
//     ++) are summed together, so the slab is staged once for both; a
//     thread walks its row's in-image offsets as an interval, no test per
//     sample;
//   * bq rows are written through shared memory, so each store instruction
//     writes two pixels' 64-byte runs; wq once per pixel and quadrant.
// Measured on an H100 and dropped: the D-minor volume as the slab's source
// (2-5 % faster, but it has to be held beside the pair layout K1 reads),
// 2 blocks an SM (7 % slower than 3: 80 registers a thread), the loop
// unrolled by 4 or software-pipelined on the weight (no faster), a padded
// output layout (no faster: the writes are not what bounds it).  The volume
// is read from the pair layout (element f holds vol[f] and vol[f + 1]): one
// copy brings two slices.
// Each sum keeps the plain version's order (dy-major, dx ascending, a
// skipped pixel adds nothing) with explicit _rn steps, so f32 results match
// it bit for bit.  The weight comes from the same 766-entry table as K1
// (bit-equal to the plain exp).  Any depth: the slices run in chunks of 16.

#include <cuda_pipeline.h>

#include "window_common.cuh"

namespace {

using namespace cspm;

constexpr int kQX = 32;  // tile columns: a warp
constexpr int kQY = 8;   // tile rows, and rows of the slab ring
constexpr int kQThreads = kQX * kQY;
constexpr int kDC = 16;  // slices a block owns
constexpr int kQMinBlocks = 3;
constexpr int kLutWords = 768;  // kLutN rounded up to 16 bytes

// How a slab of VT is staged: 16-byte vectors of slices, kVecs of them per
// column of a row; `unpack` widens vector j of a column into acc slots.
template <typename VT>
struct Slab;
template <>
struct Slab<float> {  // f32 as it is: 4 slices a vector
  using Vec = float4;
  static constexpr int kVecs = kDC / 4;
  __device__ static float get(const Vec& t, int i) {
    return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
  }
};
template <>
struct Slab<__nv_bfloat16> {  // bf16 pairs as they are: 8 slices a vector
  using Vec = uint4;
  static constexpr int kVecs = kDC / 8;
  __device__ static float get(const Vec& t, int i) {
    const uint32_t u = i < 2 ? t.x : i < 4 ? t.y : i < 6 ? t.z : t.w;
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

// Shared memory of a block, in bytes: the slab ring (kQY + stride rows of
// [kVecs][cols] vectors: the window of kQY rows and the rows of the next
// offset row's window, copied while this one is summed), the output stage,
// the weight table, the packed pixel tile.
template <typename VT>
__host__ __device__ inline size_t ring_bytes(int cols, int stride) {
  return (size_t)(kQY + stride) * Slab<VT>::kVecs * cols *
         sizeof(typename Slab<VT>::Vec);
}
template <typename VT>
__host__ __device__ inline size_t smem_bytes(int hw, int stride) {
  const int cols = kQX + 2 * hw;
  return ring_bytes<VT>(cols, stride) +
         ((size_t)kQThreads * (kDC + 1) + kLutWords +
          (size_t)(kQY + 2 * hw) * cols) * 4;
}

// acc[j] += w * slab[q][j] for the thread's in-image offsets of one
// quadrant on one offset row: c runs over the staged columns of the
// offsets (n of them, `stride` apart).
template <typename VT>
__device__ __forceinline__ void accumulate(
    float (&acc)[kDC], float& wsum, const typename Slab<VT>::Vec* slab,
    int cols, const uint32_t* q_img, uint32_t col_c, const float* s_lut,
    int c, int n, int stride) {
  using S = Slab<VT>;
  constexpr int kPer = kDC / S::kVecs;  // slices a vector
  for (int i = 0; i < n; ++i, c += stride) {
    const float w = s_lut[__vsadu4(col_c, q_img[c])];
    wsum = __fadd_rn(wsum, w);
#pragma unroll
    for (int j = 0; j < S::kVecs; ++j) {
      const typename S::Vec t = slab[j * cols + c];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        acc[kPer * j + e] =
            __fadd_rn(acc[kPer * j + e], __fmul_rn(w, S::get(t, e)));
    }
  }
}

// Write one quadrant's sums of the block: bq through the output stage
// (two pixels' 16-slice runs a store instruction), wq from chunk 0.  (x0,
// y0) and W x H are the output's.
__device__ __forceinline__ void write_quadrant(
    const float (&acc)[kDC], float wsum, float* s_out, float* bq_q,
    float* wq_q, int tid, bool active, int x0, int y0, int W, int H, int D,
    int d0, bool first_chunk) {
  __syncthreads();  // the stage's previous contents are written out
  if (active) {
#pragma unroll
    for (int j = 0; j < kDC; ++j) s_out[tid * (kDC + 1) + j] = acc[j];
    if (first_chunk)
      wq_q[(size_t)(y0 + threadIdx.y) * W + x0 + threadIdx.x] = wsum;
  }
  __syncthreads();
  for (unsigned i = tid; i < kQThreads * kDC; i += kQThreads) {
    const unsigned p = i / kDC;
    const unsigned j = i % kDC;
    const int x = x0 + (int)(p % kQX);
    const int y = y0 + (int)(p / kQX);
    // 32-bit offsets: a quadrant volume has fewer than 2^31 elements
    if (x < W && y < H && d0 + (int)j < D)
      bq_q[(y * W + x) * D + d0 + (int)j] = s_out[p * (kDC + 1) + j];
  }
}

// Start the copies of one slab row into its ring slot: pair element
// d0 + 2m of each valid column ([xlo, xhi) of the array) holds slices
// d0 + 2m and d0 + 2m + 1 (the other columns are never read).  x0 is the
// tile's first array column.
template <typename VT>
__device__ __forceinline__ void stage_row(
    typename Slab<VT>::Vec* slot, const typename PairOf<VT>::type* row,
    int cols, int x0, int hw, int xlo, int xhi, int D, int d0, int tid) {
  using E = typename PairOf<VT>::type;
  constexpr unsigned kPairs = kDC / 2 / Slab<VT>::kVecs;  // in a vector
  // unsigned and 32-bit (a view's row has fewer than 2^31 elements): the
  // index arithmetic of an element is a few shifts and adds
  for (unsigned e = tid; e < cols * (kDC / 2); e += kQThreads) {
    const unsigned m = e % (kDC / 2);
    const unsigned c = e / (kDC / 2);
    const int gx = x0 - hw + (int)c;
    const int d = d0 + 2 * (int)m;
    if ((unsigned)(gx - xlo) >= (unsigned)(xhi - xlo)) continue;
    // vector m / kPairs of the column, pair m % kPairs of it
    E* dst = reinterpret_cast<E*>(slot + (m / kPairs) * cols + c) +
             m % kPairs;
    if (d < D)
      __pipeline_memcpy_async(dst, row + (gx * D + d), sizeof(E));
    else
      *dst = E{};
  }
}

template <typename VT>
__global__ void __launch_bounds__(kQThreads, kQMinBlocks)
quadrant_build_kernel(const uint32_t* __restrict__ img,  // [2, H, W] packed
                      const void* __restrict__ vol,      // [2, H, W, D] pairs
                      const float* __restrict__ lut,     // [766]
                      float* __restrict__ bq,            // [2, 4, Ho, Wo, D]
                      float* __restrict__ wq,            // [2, 4, Ho, Wo]
                      int H, int W, int D, int Ho, int Wo, int oy, int ox,
                      int ylo, int yhi, int xlo, int xhi, int hw, int stride,
                      int chunks, int tiles_x) {
  using S = Slab<VT>;
  using Vec = typename S::Vec;
  using E = typename PairOf<VT>::type;
  extern __shared__ uint4 smem4[];
  const int cols = kQX + 2 * hw;
  const int ring_rows = kQY + stride;
  Vec* s_ring = reinterpret_cast<Vec*>(smem4);
  float* s_out = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + ring_bytes<VT>(cols, stride));
  float* s_lut = s_out + kQThreads * (kDC + 1);
  uint32_t* s_img = reinterpret_cast<uint32_t*>(s_lut + kLutWords);

  const int chunk = blockIdx.x % chunks;
  const int tile = blockIdx.x / chunks;
  const int v = blockIdx.y;
  // output tile origin (x0, y0); its array position (ax0, ay0)
  const int x0 = (tile % tiles_x) * kQX;
  const int y0 = (tile / tiles_x) * kQY;
  const int ax0 = x0 + ox, ay0 = y0 + oy;
  const int d0 = chunk * kDC;
  const int tid = threadIdx.y * kQX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const int ax = x + ox, ay = y + oy;
  const bool active = x < Wo && y < Ho;
  const size_t hwn = (size_t)H * W;
  const E* vol_v = static_cast<const E*>(vol) + v * hwn * D;

  // the slab rows of the window [lo, lo + kQY) not yet in the ring start
  // copying (rows below `have` were staged; a window's rows and the next
  // window's new ones, at most kQY + stride in a row, never share a slot);
  // array rows, only the valid ones
  int have = ylo;
  auto stage = [&](int lo) {
    for (int r = max(lo, have); r < min(lo + kQY, yhi); ++r)
      stage_row<VT>(s_ring + (r % ring_rows) * S::kVecs * cols,
                    vol_v + (size_t)r * W * D, cols, ax0, hw, xlo, xhi, D,
                    d0, tid);
    have = max(have, lo + kQY);
    __pipeline_commit();
  };
  const int n_neg = (hw + stride - 1) / stride;  // offsets of the - side
  stage(ay0 + (n_neg ? -hw : 0));

  for (int i = tid; i < kLutN; i += kQThreads) s_lut[i] = lut[i];
  const uint32_t* img_v = img + v * hwn;
  const int img_rows = kQY + 2 * hw;
  for (int i = tid; i < img_rows * cols; i += kQThreads) {
    const int r = i / cols;
    const int gy = ay0 - hw + r;
    const int gx = ax0 - hw + (i - r * cols);
    s_img[i] = (gy >= ylo && gy < yhi && gx >= xlo && gx < xhi)
                   ? img_v[(size_t)gy * W + gx] : 0u;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const uint32_t col_c = s_img[(threadIdx.y + hw) * cols + threadIdx.x + hw];

  // the thread's valid offsets per axis: - side i in [xn_lo, n_neg),
  // dx = -hw + i * stride; + side i in [0, xp_n), dx = i * stride
  const int below = hw - (ax - xlo);
  const int xn_lo = below > 0 ? (below + stride - 1) / stride : 0;
  // xlo <= ax < xhi where active
  const int xp_n = min(hw, xhi - 1 - ax) / stride + 1;
  const int c_neg = threadIdx.x + xn_lo * stride;    // staged column of i
  const int c_pos = threadIdx.x + hw;

  for (int side = 0; side < 2; ++side) {
    float acc0[kDC], acc1[kDC];  // quadrants (side, -) and (side, +)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc0[j] = acc1[j] = 0.f;
    float w0 = 0.f, w1 = 0.f;
    const int dy_lo = side ? 0 : -hw;
    const int dy_n = side ? hw / stride + 1 : n_neg;
    for (int iy = 0; iy < dy_n; ++iy) {
      const int dy = dy_lo + iy * stride;
      // the next offset row's window copies while this one is summed
      if (iy + 1 < dy_n)
        stage(ay0 + dy + stride);
      else if (side == 0)
        stage(ay0);
      const int qy = ay + dy;
      if (active && qy >= ylo && qy < yhi) {
        const Vec* slab = s_ring + (qy % ring_rows) * S::kVecs * cols;
        const uint32_t* q_img = s_img + (threadIdx.y + hw + dy) * cols;
        accumulate<VT>(acc0, w0, slab, cols, q_img, col_c, s_lut, c_neg,
                       n_neg - xn_lo, stride);
        accumulate<VT>(acc1, w1, slab, cols, q_img, col_c, s_lut, c_pos,
                       xp_n, stride);
      }
      __pipeline_wait_prior(0);
      __syncthreads();  // the next window is in; this one is read
    }
    const size_t on = (size_t)Ho * Wo;
    float* bq_v = bq + (size_t)v * 4 * on * D;
    float* wq_v = wq + (size_t)v * 4 * on;
    const int q0 = 2 * side;
    write_quadrant(acc0, w0, s_out, bq_v + q0 * on * D, wq_v + q0 * on, tid,
                   active, x0, y0, Wo, Ho, D, d0, chunk == 0);
    write_quadrant(acc1, w1, s_out, bq_v + (q0 + 1) * on * D,
                   wq_v + (q0 + 1) * on, tid, active, x0, y0, Wo, Ho, D, d0,
                   chunk == 0);
  }
}

template <typename VT>
cudaError_t launch(const void* img, const void* vol, const void* lut, void* bq,
                   void* wq, int H, int W, int D, const int* band, int hw,
                   int stride, cudaStream_t stream) {
  const size_t smem = smem_bytes<VT>(hw, stride);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      quadrant_build_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int Ho = band[0], Wo = band[1];
  const int chunks = (D + kDC - 1) / kDC;
  const int tiles_x = (Wo + kQX - 1) / kQX;
  const long long blocks =
      (long long)tiles_x * ((Ho + kQY - 1) / kQY) * chunks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, 2);
  quadrant_build_kernel<VT><<<grid, dim3(kQX, kQY), smem, stream>>>(
      static_cast<const uint32_t*>(img), vol, static_cast<const float*>(lut),
      static_cast<float*>(bq), static_cast<float*>(wq), H, W, D, Ho, Wo,
      band[2], band[3], band[4], band[5], band[6], band[7], hw, stride,
      chunks, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// vol: the pair-layout volume [2, H, W, D, 2] (f32 or bf16).  band (host
// memory, 8 ints): the output's Ho, Wo, its origin oy, ox in the arrays and
// the validity rectangle ylo, yhi, xlo, xhi; every output centre must lie
// inside the rectangle, and the rectangle inside the arrays.
extern "C" int cspm_quadrant_build(const void* img, const void* vol,
                                   int vol_bf16, const void* lut, void* bq,
                                   void* wq, int H, int W, int D,
                                   const int* band, int half_wnd, int stride,
                                   void* stream) {
  if (H < 1 || W < 1 || D < 1 || half_wnd < 0 || half_wnd > 64 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const int Ho = band[0], Wo = band[1], oy = band[2], ox = band[3];
  if (Ho < 1 || Wo < 1 || band[4] < 0 || band[5] > H || band[6] < 0 ||
      band[7] > W || oy < band[4] || oy + Ho > band[5] || ox < band[6] ||
      ox + Wo > band[7])
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16)
    return (int)launch<__nv_bfloat16>(img, vol, lut, bq, wq, H, W, D, band,
                                      half_wnd, stride, s);
  return (int)launch<float>(img, vol, lut, bq, wq, H, W, D, band, half_wnd,
                            stride, s);
}
