// Kernel BFV: the joint bilateral filter of every inner slice of a level's
// cost volumes (the BF aggregator, BFCA), all views in one launch.
//
// Replaces no TPU kernel: the JAX engine runs the filter as a device loop
// over the wnd^2 window offsets (crossscalepatchmatch_tpu/ops/filters.py
// bilateral_filter, its fori_loop), fused by XLA inside run_pair's jitted
// program.  Plain version: ops/filters.py bilateral_filter_volume, a host
// loop over the offsets of ~8 eager launches each (24,000 launches a
// README_DEMO pair at wnd 35).
//
// For view v, pixel (y, x) and inner slice d in [1, D - 2], in the plain
// version's f32 order on the card:
//   g(p)   = f32(u8) * f32(1/255)          (PyTorch's CUDA division by a
//            scalar multiplies by its f32 reciprocal)
//   for the offsets o = 0 .. wnd^2 - 1 in order, dy = o / wnd - half,
//   dx = o % wnd - half, q = ((y + dy) mod H, (x + dx) mod W):
//     clr = (((|g_0(q) - g_0(p)| + |g_2(q) - g_2(p)|) + |g_1(q) - g_1(p)|)
//           * f32(1/3))                    (PyTorch's CUDA mean over a last
//            axis of 3: elements 0 and 2, then 1, times the f32 factor
//            N_out / N, which is f32(1/3) while 3 H W < 2^24)
//     w   = expf(sp(o) - (clr * clr) * inv_clr2),
//           sp(o) = -f32(dx^2 + dy^2) * inv_sp2
//     s_d = fmaf(w, vol(q, d), s_d)        (addcmul_ on the card rounds
//            s + w * p once)
//     sw  = sw + w
//   out(p, d) = s_d / sw;  slices 0 and D - 1 are copied through.
// Every step is one explicit _rn operation (no contraction can merge two
// roundings), expf the same libdevice function torch.exp calls, the
// division IEEE.  sw is summed as one more slice whose value is 1:
// fmaf(w, 1, sw) rounds sw + w once, which is the plain version's add.  A
// zero weight stands in for a (pixel, column) pair outside the pixel's
// window where a warp walks it all the same (a staged row outside one of
// its two rows' windows, windows narrower than its 8 pixels): fma(0, p, s)
// adds +0, which leaves a sum that started at +0 and never holds -0
// unchanged.
//
// Layout: vol f32[V, H, W, D] and out the same, contiguous (D-minor);
// guide u8[V, H, W, 3], contiguous; V * chunks <= 65535, H <= 65535,
// wnd <= kMaxWnd.
//
// What bounds it on the H100: its f32 operations.  A pixel's window is
// wnd^2 samples of D - 2 slices: 2 (D - 2) operations a sample for the
// slice products and sums, and ~12 for its weight
// (utils/roofline.bilateral_volume_work): 3.0e11 a KITTI pair (D = 129,
// wnd 35), 4.5 ms at 67 TFLOP/s, against 0.96 GB of bytes (0.29 ms).  Each
// FMA is an issue slot, so the kernel is held to the share of its issued
// instructions that are useful FFMAs: at 1.98 GHz the KITTI level's
// 4.5e9 warp-FFMAs alone take 4.3 ms.  The design:
//   * a warp filters 8 consecutive pixels of each of 2 rows over a chunk
//     of the inner slices, each lane holding DC consecutive slices
//     (d = 1 + base + DC lane + j), so one vector load of a staged column
//     feeds 16 pixels' FMAs, and the column's 16 weights are four 16-byte
//     broadcasts from the warp's weight table;
//   * a block of wx x wy such warps (4 x 2: 32 pixels of 4 rows) stages
//     each window row of the volume once (its columns and the wnd - 1 of
//     the halo, wrapped, the chunk's slices) in a ring of 2 shared-memory
//     stages, by 4-byte cp.async issued a row ahead, re-laid with a column
//     stride of 32 DC floats so every lane's slices are one aligned vector
//     (a pixel's slices start every 4 D bytes: at D = 129 one column in
//     four is 16-byte aligned).  Every warp whose rows the row's window
//     holds reads it there: one block barrier a row, no global load in
//     the FMA loop, and two blocks a SM so one's barrier overlaps the
//     other's FMAs;
//   * a warp walks its 8 + wnd - 1 columns in order, so pixel i takes
//     column c as its offset dx = c - i - half and every pixel sums its
//     offsets in the plain order; the 7 columns at each end, which only
//     some of the pixels' windows hold, are unrolled with only those
//     pixels' FMAs, so no FFMA is spent on a zero weight there;
//   * the weights: lane l forms pixel l % 16's weights for the offsets
//     l / 16, + 2, ... of the row (no integer division), its own guide
//     value in registers and the row's guide values, staged once a block
//     a row as floats (the byte loads issued a row ahead), in shared
//     memory;
//   * the launch plan (ops/cuda/bilateral_volume.launch_plan, from V, H,
//     W, D and wnd) picks DC (1, 2 or 4), the chunks of slices (one slot
//     kept for sw) and the block: 4 x 2 warps where that makes two blocks
//     a SM and fits, else 2 x 2 (small levels, wide windows; it fits
//     232,448 bytes at every window).
// Measured on an H100 at 700 W, KITTI level, both views: 21.0 ms for the
// design before this one (its FMA loop fed from L1 took 11.5 of them, its
// weight pass 3.7, its loads' exposed latency ~5.7) against ~9.6 for this
// one; of those, without the FMAs 5.5 ms remain (staging and barriers
// ~1-1.5, the weight pass ~1, each alone).  Measured and dropped: a ring
// of 3 stages issued two rows ahead (no faster at one block a SM, and its
// bytes allow only one: 13.1 ms); blocks of 8 x 2 warps (one a SM: 10.2);
// 16-byte copies of the aligned superset of a column read back with
// 4-byte loads (the copies save ~1.3 ms, the loads cost it back: 10.28
// against 10.22); the column loop unrolled by 2 (+0.4 ms); one-warp
// blocks on small levels (slower at every level tried); no minimum of
// blocks a SM in the launch bounds (the compiler keeps 120 registers and
// runs ~0.6 ms slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kPix = 8;                 // a warp's pixels along a row
constexpr int kRows = 2;                // a warp's rows
constexpr int kTile = kPix * kRows;     // a warp's pixels: a table row
constexpr int kMaxWx = 4;               // a block's warps along a row
constexpr int kMaxWy = 2;               // ... and down the rows
constexpr int kStages = 2;              // the ring's depth
constexpr int kMaxWnd = 129;            // half_wnd <= 64
constexpr int kMaxSmem = 232448;        // the H100's per-block limit

struct Plan {
  int H, W, D, wnd, half;
  int per_chunk, chunks, wx, wy;  // slices a chunk; warps of a block
  float inv_sp2, inv_clr2;
};

// a block's columns (its pixels and the window's halo) and a warp's
__host__ __device__ inline int block_cols(const Plan& p) {
  return kPix * p.wx + p.wnd - 1;
}
__host__ __device__ inline int warp_cols(const Plan& p) {
  return kPix + p.wnd - 1;
}

// a block's shared memory: the volume ring (kStages x columns x 32 DC
// floats), the guide ring (kStages x columns float4), the warps' weight
// tables (columns x kTile floats each) and the wrapped column indices
size_t smem_bytes(int dc, const Plan& p) {
  const size_t nb = block_cols(p);
  return sizeof(float) * (kStages * nb * 32 * dc + kStages * nb * 4 +
                          (size_t)p.wx * p.wy * warp_cols(p) * kTile) +
         sizeof(int) * nb;
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float4 unpack_guide(uint32_t b) {
  const float k = 1.f / 255.f;
  return make_float4(__fmul_rn((float)(b & 255u), k),
                     __fmul_rn((float)((b >> 8) & 255u), k),
                     __fmul_rn((float)(b >> 16), k), 0.f);
}

// the guide's three bytes at pixel index p of a view
__device__ __forceinline__ uint32_t guide_bytes(const uint8_t* __restrict__ g,
                                                long long p) {
  return (uint32_t)g[p * 3] | ((uint32_t)g[p * 3 + 1] << 8) |
         ((uint32_t)g[p * 3 + 2] << 16);
}

__device__ __forceinline__ float weight(float4 gq, float4 gp, int dx, int dy,
                                        const Plan& pl) {
  const float e0 = fabsf(__fsub_rn(gq.x, gp.x));
  const float e1 = fabsf(__fsub_rn(gq.y, gp.y));
  const float e2 = fabsf(__fsub_rn(gq.z, gp.z));
  const float clr = __fmul_rn(__fadd_rn(__fadd_rn(e0, e2), e1), 1.f / 3.f);
  const float sp = __fmul_rn(-(float)(dx * dx + dy * dy), pl.inv_sp2);
  return expf(__fsub_rn(sp, __fmul_rn(__fmul_rn(clr, clr), pl.inv_clr2)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int DC>
__device__ __forceinline__ void load_slots(const float* s, float (&v)[DC]) {
  if constexpr (DC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(s);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (DC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(s);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = s[0];
  }
}

// one staged column for the warp's pixels ILO..IHI of each row (the other
// pixels' windows do not hold it): vc the lane's slots, wc the column's
// kTile weights (row r's pixel i at r * kPix + i)
template <int DC, int ILO, int IHI>
__device__ __forceinline__ void column(const float* vc, const float* wc,
                                       float (&acc)[kRows][kPix][DC]) {
  float v[DC];
  load_slots<DC>(vc, v);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 a = reinterpret_cast<const float4*>(wc)[2 * r];
    const float4 b = reinterpret_cast<const float4*>(wc)[2 * r + 1];
    const float w[kPix] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = ILO; i <= IHI; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j)
        acc[r][i][j] = __fmaf_rn(w[i], v[j], acc[r][i][j]);
  }
}

// the warp's first kPix - 1 columns: column c is in the windows of pixels
// 0 .. c (wnd >= kPix)
template <int DC, int... C>
__device__ __forceinline__ void head_columns(
    const float* vc, const float* wc, float (&acc)[kRows][kPix][DC],
    std::integer_sequence<int, C...>) {
  (column<DC, 0, C>(vc + C * 32 * DC, wc + C * kTile, acc), ...);
}

// its last kPix - 1 columns, from column wnd: column wnd + c is in the
// windows of pixels c + 1 .. kPix - 1
template <int DC, int... C>
__device__ __forceinline__ void tail_columns(
    const float* vc, const float* wc, float (&acc)[kRows][kPix][DC],
    std::integer_sequence<int, C...>) {
  (column<DC, C + 1, kPix - 1>(vc + C * 32 * DC, wc + C * kTile, acc), ...);
}

// two blocks a SM: one block's barrier overlaps the other's FMAs (at most
// 128 registers a thread)
template <int DC>
__global__ void __launch_bounds__(32 * kMaxWx * kMaxWy, 2)
bilateral_volume_kernel(const float* __restrict__ vol,
                        const uint8_t* __restrict__ guide,
                        float* __restrict__ out, Plan pl) {
  constexpr int S = 32 * DC;  // a staged column's floats
  extern __shared__ __align__(16) float smem[];
  const int H = pl.H, W = pl.W, D = pl.D, wnd = pl.wnd, half = pl.half;
  const int nw = pl.wx * pl.wy, nthreads = 32 * nw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wxi = warp % pl.wx, wyi = warp / pl.wx;
  const int nb = block_cols(pl), wcols = warp_cols(pl);
  const int v = blockIdx.z / pl.chunks, chunk = blockIdx.z % pl.chunks;
  const int x0 = blockIdx.x * kPix * pl.wx, y0 = blockIdx.y * kRows * pl.wy;
  const int base = chunk * pl.per_chunk;
  const int cnt = min(pl.per_chunk, D - 2 - base);  // the chunk's slices
  const int nrows = min(kRows * pl.wy, H - y0) + wnd - 1;
  float* ring = smem;
  float4* gring = reinterpret_cast<float4*>(ring + kStages * nb * S);
  float* tables = reinterpret_cast<float*>(gring + kStages * nb);
  float* tw = tables + warp * wcols * kTile;
  int* cw = reinterpret_cast<int*>(tables + nw * wcols * kTile);
  const long long vpix = (long long)v * H * W;
  const float* __restrict__ vv = vol + vpix * D + 1 + base;
  const uint8_t* __restrict__ gv = guide + vpix * 3;

  // the block's columns; in every stage slot cnt holds 1 (sw's slice) and
  // the slots past it 0; the tables' zeros (columns outside a pixel's
  // window, pixels outside the image) stay zero
  for (int c = tid; c < nb; c += nthreads) cw[c] = wrap(x0 - half + c, W);
  for (int e = tid; e < kStages * nb; e += nthreads)
    for (int k = cnt; k < S; ++k) ring[e * S + k] = k == cnt ? 1.f : 0.f;
  for (int e = tid; e < nw * wcols * kTile; e += nthreads) tables[e] = 0.f;
  __syncthreads();

  // staged row t is the image's row (qy0 + t) mod H
  const int qy0 = wrap(y0 - half, H);
  auto stage_volume = [&](int t, int s) {
    const float* row = vv + (long long)((qy0 + t) % H) * W * D;
    float* dst = ring + s * nb * S;
    for (int c = warp; c < nb; c += nw) {
      const float* src = row + (long long)cw[c] * D;
      float* d = dst + c * S;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int k = lane + 32 * j;
        if (k < cnt) cp_async4(d + k, src + k);
      }
    }
  };
  auto stage_guide = [&](int t, int s, int c0) {
    const long long row = (long long)((qy0 + t) % H) * W;
    for (int c = c0; c < nb; c += nthreads)
      gring[s * nb + c] = unpack_guide(guide_bytes(gv, row + cw[c]));
  };
  stage_volume(0, 0);
  cp_async_commit();
  stage_guide(0, 0, tid);

  // the lane's pixel for the weights: p = lane % kTile, row pr, column pi
  const int p = lane % kTile, pr = p / kPix, pi = p % kPix;
  const int py = y0 + kRows * wyi + pr, px = x0 + kPix * wxi + pi;
  const bool pvalid = py < H && px < W;
  const float4 gp =
      pvalid ? unpack_guide(guide_bytes(gv, (long long)py * W + px))
             : make_float4(0.f, 0.f, 0.f, 0.f);
  // the warp's rows inside the image (none if its pixels lie past W)
  const int wrows = x0 + kPix * wxi < W
                        ? max(0, min(kRows, H - y0 - kRows * wyi))
                        : 0;

  float acc[kRows][kPix][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[r][i][j] = 0.f;

  for (int t = 0; t < nrows; ++t) {
    const int s = t & 1;  // row t's stage; row t + 1 goes to row t - 1's
    cp_async_wait_all();
    __syncthreads();  // row t staged; every warp done with row t - 1
    const bool more = t + 1 < nrows;
    uint32_t gb = 0;
    if (more) {
      stage_volume(t + 1, s ^ 1);
      if (tid < nb)
        gb = guide_bytes(gv, (long long)((qy0 + t + 1) % H) * W + cw[tid]);
      cp_async_commit();
    }

    // staged row t is dy = tt - pr - half of the warp's row pr
    const int tt = t - kRows * wyi;
    if (wrows > 0 && tt >= 0 && tt < wnd + wrows - 1) {
      const int rr = tt - pr;
      float* tc = tw + pi * kTile + p;  // (column pi + k, pixel p)
      const float4* gq = gring + s * nb + kPix * wxi + pi;
      if (pvalid && rr >= 0 && rr < wnd) {
        const int dy = rr - half;
#pragma unroll 4
        for (int k = lane / kTile; k < wnd; k += 32 / kTile)
          tc[k * kTile] = weight(gq[k], gp, k - half, dy, pl);
      } else if (pvalid) {
        for (int k = lane / kTile; k < wnd; k += 32 / kTile)
          tc[k * kTile] = 0.f;
      }
      __syncwarp();
      const float* vc = ring + (s * nb + kPix * wxi) * S + lane * DC;
      if (wnd >= kPix) {
        head_columns<DC>(vc, tw, acc,
                         std::make_integer_sequence<int, kPix - 1>{});
#pragma unroll 4
        for (int c = kPix - 1; c < wnd; ++c)
          column<DC, 0, kPix - 1>(vc + c * S, tw + c * kTile, acc);
        tail_columns<DC>(vc + wnd * S, tw + wnd * kTile, acc,
                         std::make_integer_sequence<int, kPix - 1>{});
      } else {
        for (int c = 0; c < wcols; ++c)
          column<DC, 0, kPix - 1>(vc + c * S, tw + c * kTile, acc);
      }
    }

    if (more) {
      // row t - 1's stage: every warp left it at this row's barrier
      if (tid < nb) gring[(s ^ 1) * nb + tid] = unpack_guide(gb);
      stage_guide(t + 1, s ^ 1, tid + nthreads);
    }
  }

  // out = s_d / sw, sw the accumulator of slot cnt
  const int sw_lane = cnt / DC, sw_j = cnt % DC;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float own = acc[r][i][0];
#pragma unroll
      for (int j = 1; j < DC; ++j) own = sw_j == j ? acc[r][i][j] : own;
      const float sw = __shfl_sync(0xffffffffu, own, sw_lane);
      const int y = y0 + kRows * wyi + r, x = x0 + kPix * wxi + i;
      if (y < H && x < W) {
        const long long pix = (long long)y * W + x;
        float* o = out + (vpix + pix) * D;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const int k = lane * DC + j;
          if (k < cnt) o[1 + base + k] = __fdiv_rn(acc[r][i][j], sw);
        }
        if (chunk == 0 && lane == 0) {
          const float* src = vol + (vpix + pix) * D;
          o[0] = src[0];
          o[D - 1] = src[D - 1];
        }
      }
    }
  }
}

template <int DC>
cudaError_t launch(const float* vol, const uint8_t* guide, float* out,
                   int V, const Plan& pl, cudaStream_t stream) {
  const size_t smem = smem_bytes(DC, pl);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilateral_volume_kernel<DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int bx = kPix * pl.wx, by = kRows * pl.wy;
  dim3 grid((unsigned)((pl.W + bx - 1) / bx),
            (unsigned)((pl.H + by - 1) / by), (unsigned)(V * pl.chunks));
  bilateral_volume_kernel<DC>
      <<<grid, 32 * pl.wx * pl.wy, smem, stream>>>(vol, guide, out, pl);
  return cudaGetLastError();
}

}  // namespace

// vol: f32[V, H, W, D], guide: u8[V, H, W, 3], out: f32[V, H, W, D], all
// contiguous; D >= 3, 1 <= wnd <= 129; inv_sp2 = f32(1 / (wnd / 2)^2),
// inv_clr2 = f32(1 / sig_clr^2).  The launch plan (launch_plan in
// ops/cuda/bilateral_volume.py): dc slices a lane (1, 2 or 4), per_chunk
// inner slices a block (at most 32 dc - 1: one slot is sw's), chunks of
// them covering the D - 2 inner slices, wx x wy warps a block (wx <= 8,
// wy <= 2).  One launch filters every view.  Returns cudaSuccess or the
// launch's error (cudaErrorInvalidValue for a plan it does not take or
// whose block passes 232,448 bytes of shared memory).
extern "C" int cspm_bilateral_volume(const void* vol, const void* guide,
                                     void* out, int V, int H, int W, int D,
                                     int wnd, float inv_sp2, float inv_clr2,
                                     int dc, int per_chunk, int chunks,
                                     int wx, int wy, void* stream) {
  const int inner = D - 2;
  if (V < 1 || H < 1 || W < 1 || D < 3 || H > 65535 || wnd < 1 ||
      wnd > kMaxWnd || (dc != 1 && dc != 2 && dc != 4) || per_chunk < 1 ||
      per_chunk > 32 * dc - 1 || chunks < 1 ||
      (long long)(chunks - 1) * per_chunk >= inner ||
      (long long)chunks * per_chunk < inner || wx < 1 || wx > kMaxWx ||
      wy < 1 || wy > kMaxWy || (long long)V * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const Plan pl{H, W, D, wnd, wnd / 2, per_chunk, chunks, wx, wy,
                inv_sp2, inv_clr2};
  const float* v = static_cast<const float*>(vol);
  const uint8_t* g = static_cast<const uint8_t*>(guide);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dc == 1)
    e = launch<1>(v, g, o, V, pl, s);
  else if (dc == 2)
    e = launch<2>(v, g, o, V, pl, s);
  else
    e = launch<4>(v, g, o, V, pl, s);
  return (int)e;
}
