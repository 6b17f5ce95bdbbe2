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
// division IEEE.  A zero weight stands in for a (pixel, column) pair
// outside the pixel's window: fma(0, p, s) adds +0, which leaves a sum
// that started at +0 and never holds -0 unchanged.
//
// Layout: vol f32[V, H, W, D] and out the same, contiguous (D-minor);
// guide u8[V, H, W, 3], contiguous; V * chunks <= 65535, H <= 65535,
// wnd <= kMaxWnd.
//
// What bounds it on the H100: its f32 operations.  A pixel's window is
// wnd^2 samples of D - 2 slices: 2 (D - 2) operations a sample for the
// slice products and sums, and ~12 for its weight
// (utils/roofline.bilateral_volume_work): 3.0e11 a KITTI pair (D = 129,
// wnd 35), 4.5 ms at 67 TFLOP/s, against 0.96 GB of bytes (0.29 ms).  The
// design keeps the FMAs fed from registers:
//   * a warp filters kPix = 8 consecutive pixels of one row over all the
//     inner slices, its lanes on consecutive slices (d = d0 + lane + 32 j,
//     DC per lane), so a column's slices are one coalesced 128-byte load
//     and each loaded value feeds all kPix pixels whose window holds that
//     column: for each window row the warp walks the kPix + wnd - 1
//     columns in order, and pixel i takes column c as its offset
//     dx = c - i - half, so every pixel still sums its offsets in the
//     plain order;
//   * each (pixel, offset) weight is formed once, by one lane, into a
//     table in the warp's shared memory laid out by column, read back as
//     two 16-byte broadcasts a column (zeros where a column lies outside
//     a pixel's window); the lane of pixel i then adds its weights to sw
//     in window order.  The guide's values in [0, 1] that the weights
//     read (the warp's pixels once, each window row's columns once a row)
//     are staged in shared memory first, so a weight takes two 16-byte
//     loads and no byte load;
//   * no block barrier: a warp's table is its own (__syncwarp only), so
//     the 8 warps of a block (64 pixels of a row, whose columns overlap
//     in L1) run independently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // warps a block
constexpr int kPix = 8;                      // pixels a warp
constexpr int kMaxWnd = 129;                 // half_wnd <= 64

struct Geom {
  int H, W, D, wnd, half, chunks;
  float inv_sp2, inv_clr2;
};

// a warp's shared memory, in floats: the weight table (ncols x kPix), the
// window row's guide values (ncols float4), the warp's pixels' (kPix
// float4) and the row's wrapped columns (ncols ints)
__host__ __device__ inline int warp_floats(int wnd) {
  const int ncols = kPix + wnd - 1;
  return ncols * kPix + 4 * ncols + 4 * kPix + ((ncols + 3) & ~3);
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// the guide's channels at pixel index p of a view, in [0, 1]
__device__ __forceinline__ float4 guide_at(const uint8_t* __restrict__ g,
                                           long long p) {
  const float k = 1.f / 255.f;
  return make_float4(__fmul_rn((float)g[p * 3], k),
                     __fmul_rn((float)g[p * 3 + 1], k),
                     __fmul_rn((float)g[p * 3 + 2], k), 0.f);
}

__device__ __forceinline__ float weight(float4 gq, float4 gp, int dx, int dy,
                                        const Geom& gm) {
  const float e0 = fabsf(__fsub_rn(gq.x, gp.x));
  const float e1 = fabsf(__fsub_rn(gq.y, gp.y));
  const float e2 = fabsf(__fsub_rn(gq.z, gp.z));
  const float clr = __fmul_rn(__fadd_rn(__fadd_rn(e0, e2), e1), 1.f / 3.f);
  const float sp = __fmul_rn(-(float)(dx * dx + dy * dy), gm.inv_sp2);
  return expf(__fsub_rn(sp, __fmul_rn(__fmul_rn(clr, clr), gm.inv_clr2)));
}

template <int DC>
__global__ void __launch_bounds__(kWarps * 32)
bilateral_volume_kernel(const float* __restrict__ vol,
                        const uint8_t* __restrict__ guide,
                        float* __restrict__ out, Geom gm) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = blockIdx.y;
  const int v = blockIdx.z / gm.chunks, chunk = blockIdx.z % gm.chunks;
  const int x0 = (blockIdx.x * kWarps + warp) * kPix;
  if (x0 >= gm.W) return;
  const int W = gm.W, D = gm.D, wnd = gm.wnd, half = gm.half;
  const int ncols = kPix + wnd - 1;
  const long long vpix = (long long)v * gm.H * W;
  const float* __restrict__ vv = vol + vpix * D;
  const uint8_t* __restrict__ gv = guide + vpix * 3;
  float* tw = smem + warp * warp_floats(wnd);
  float4* gq = reinterpret_cast<float4*>(tw + ncols * kPix);
  float4* gp = gq + ncols;
  int* cw = reinterpret_cast<int*>(gp + kPix);
  const int d0 = 1 + chunk * 32 * DC + lane;
  const int npix = min(kPix, W - x0);

  // the zeros of the table (columns outside a pixel's window, pixels past
  // the row's end), the window row's columns and the pixels' guide values,
  // all the same every row
  for (int e = lane; e < ncols * kPix; e += 32) tw[e] = 0.f;
  for (int c = lane; c < ncols; c += 32) cw[c] = wrap(x0 - half + c, W);
  if (lane < npix) gp[lane] = guide_at(gv, (long long)y * W + x0 + lane);

  float acc[kPix][DC];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  float sw = 0.f;  // lane i < kPix: pixel x0 + i's weight sum
  int qy = wrap(y - half, gm.H);
  for (int r = 0; r < wnd; ++r) {
    const int dy = r - half;
    __syncwarp();
    const long long qrow = (long long)qy * W;
    for (int c = lane; c < ncols; c += 32) gq[c] = guide_at(gv, qrow + cw[c]);
    __syncwarp();
    // the row's weights: entry (i, k) at column c = i + k
#pragma unroll 3
    for (int e = lane; e < npix * wnd; e += 32) {
      const int i = e / wnd, k = e - i * wnd, c = i + k;
      tw[c * kPix + i] = weight(gq[c], gp[i], k - half, dy, gm);
    }
    __syncwarp();
    if (lane < npix) {
      for (int k = 0; k < wnd; ++k)
        sw = __fadd_rn(sw, tw[(lane + k) * kPix + lane]);
    }
    const float* __restrict__ row = vv + qrow * D;
#pragma unroll 2
    for (int c = 0; c < ncols; ++c) {
      const float* __restrict__ col = row + (long long)cw[c] * D;
      float p[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int d = d0 + 32 * j;
        p[j] = d < D - 1 ? __ldg(col + d) : 0.f;
      }
      const float4 wa = *reinterpret_cast<const float4*>(tw + c * kPix);
      const float4 wb = *reinterpret_cast<const float4*>(tw + c * kPix + 4);
      const float wv[kPix] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < kPix; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j)
          acc[i][j] = __fmaf_rn(wv[i], p[j], acc[i][j]);
    }
    qy = qy + 1 == gm.H ? 0 : qy + 1;
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float s = __shfl_sync(0xffffffffu, sw, i);
    if (i < npix) {
      const long long pix = (long long)y * W + x0 + i;
      float* o = out + (vpix + pix) * D;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int d = d0 + 32 * j;
        if (d < D - 1) o[d] = __fdiv_rn(acc[i][j], s);
      }
      if (chunk == 0 && lane == 0) {
        o[0] = vv[pix * D];
        o[D - 1] = vv[pix * D + D - 1];
      }
    }
  }
}

template <int DC>
cudaError_t launch(const float* vol, const uint8_t* guide, float* out,
                   int V, const Geom& gm, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * warp_floats(gm.wnd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilateral_volume_kernel<DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int px = kWarps * kPix;
  dim3 grid((unsigned)((gm.W + px - 1) / px), (unsigned)gm.H,
            (unsigned)(V * gm.chunks));
  bilateral_volume_kernel<DC>
      <<<grid, kWarps * 32, smem, stream>>>(vol, guide, out, gm);
  return cudaGetLastError();
}

}  // namespace

// vol: f32[V, H, W, D], guide: u8[V, H, W, 3], out: f32[V, H, W, D], all
// contiguous; D >= 3, 1 <= wnd <= 129; inv_sp2 = f32(1 / (wnd / 2)^2),
// inv_clr2 = f32(1 / sig_clr^2).  One launch filters every view.  Returns
// cudaSuccess or the launch's error.
extern "C" int cspm_bilateral_volume(const void* vol, const void* guide,
                                     void* out, int V, int H, int W, int D,
                                     int wnd, float inv_sp2, float inv_clr2,
                                     void* stream) {
  const int inner = D - 2;
  // slices a lane holds: 1, 2 or 4; past 128 inner slices the grid splits
  // them into chunks of 128
  const int dc = inner <= 32 ? 1 : inner <= 64 ? 2 : 4;
  const int chunks = (inner + 32 * dc - 1) / (32 * dc);
  if (V < 1 || H < 1 || W < 1 || D < 3 || H > 65535 || wnd < 1 ||
      wnd > kMaxWnd || (long long)V * chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const Geom gm{H, W, D, wnd, wnd / 2, chunks, inv_sp2, inv_clr2};
  const float* v = static_cast<const float*>(vol);
  const uint8_t* g = static_cast<const uint8_t*>(guide);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dc == 1)
    e = launch<1>(v, g, o, V, gm, s);
  else if (dc == 2)
    e = launch<2>(v, g, o, V, gm, s);
  else
    e = launch<4>(v, g, o, V, gm, s);
  return (int)e;
}
