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
// Two designs, chosen per launch from its shape by ops/cuda/fly_cost.py
// launch_plan (one launch a call either way; all three kernels keep
// "fly_cost_kernel" in their names): the shared rows, a kernel each lerp,
// where they fit a block, else one sample at a time.
//
// The shared-row design, fly_cost_kernel_rows (cost lerp: K5, K3's fly
// form, K7).  A slice cost cost(q, f) depends on q and f alone, not on the
// center or its plane, yet one sample at a time computes each ~3 (K = 1)
// to ~6 (the prescreen's K = 8) times a block, and the two slice costs are
// ~43 % of that design's time (94.2 ms of a no-volume KITTI pair's 27
// launches: 53.6 with the costs replaced by two staged words, 85.6 with
// the costs alone).  So a block computes each of its window rows' costs
// once, into a shared-memory row buffer that all its centers and
// candidates read:
//   * the buffer S[col][f - 1] holds the slices f = 1 .. max_dis_s of the
//     tile's columns at a column stride of max_dis_s | 1 floats (odd: 32
//     neighbouring columns at one slice lie in 32 banks), in two stages
//     beside three stages of raw rows (the tile's colour, gradient and Lab
//     words, the other view's reachable columns, by cp.async): while row r
//     is summed, row r + 1's costs are computed and row r + 2's pixels
//     arrive, one barrier a row (~77 KB at KITTI, two blocks an SM);
//   * an entry is the other view's GRD cost in the plain version's rounding
//     (the colour TAD made a float by (2^23 + s) - 2^23, no I2F), or the
//     border pseudo-cost where the column leaves the image: c0 and c1 take
//     it exactly where one sample at a time does;
//   * a warp is one center row; it adds a row's samples, dx ascending, only
//     where its window holds the row, so every sum keeps the plain
//     version's order and the costs are bit-equal;
//   * only the slices a row's samples can read are computed: dq is
//     monotone along a row (each rounding step is), so a candidate's
//     in-range samples read between the slices of the row's first and last
//     sample; the block merges its threads' ranges a row ahead (a wild or
//     random plane widens the range to every slice);
//   * a thread holds C = 1, 2, 4, 5 or 8 candidates (the prescreen's 5 and
//     8 in one chunk) that share each sample's weight; a chunk short of C
//     repeats its last candidate, so the candidate loops carry no test (a
//     test kept the candidates' chains apart: 16 % slower at K = 8);
//   * at one level with a stride (the prescreen) a block's 32 x 16 pixels
//     lie on a lattice of that step, so its windows sample one residue of
//     rows and columns: 33 rows of 49 columns at stride 2 in place of 50 of
//     66, and more of its warps sum each row (K = 8: 4.7 -> 3.3 ms).
// What bounds it: the barrier a row.  A center row's window holds 35 of
// the tile's 50 rows, so ~30 % of the warps wait at each barrier, and the
// costs (the whole range on early, random planes) add ~15 instructions an
// entry.  Measured (H100 80GB HBM3, 700 W; KITTI, both views, the
// pipeline's own candidates; one sample at a time -> this design): K = 1
// 2.56 -> 2.0-2.6 ms (slower than one sample at a time on the first
// iteration's random planes, faster once they settle), K = 2 5.03 -> 3.6,
// K = 5 at stride 2 3.52 -> 2.3, K = 8 at stride 2 5.67 -> 3.35; a
// no-volume pair's 27 launches 94.0 -> 68.0 ms.
// Measured and dropped: the colour term from a 766-entry table (bank
// conflicts: K = 1 2.57 -> 2.69 ms); two centers a thread 32 apart (98
// columns for 64 centers: K = 1 -1 %, K = 2 +11 % with spills); 8-row
// tiles of 256 threads at up to 128 registers (K = 8 +56 %); three blocks
// an SM at 40 registers with two stages of the other view's rows (+5 %,
// spills); the K = 8 prescreen as two chunks of 4 (+11 %); the idle warps
// of a row taking the next row's costs first (+8 % with its bookkeeping);
// unrolling the sample loop by 2 or 4, or the cost loop by 4 (+-3 %);
// reloading b each row to spare registers (+9 % at K = 8, more spills).
//
// The shared-row design of image lerp, fly_cost_kernel_image_rows (K6 and
// its stride-2 form).  K6 has no integer slice to share: its data term
// reads the other view at fractional columns.  What one sample at a time
// repeats is the unpacking: six tap channels a candidate and sample from
// packed words (a shift, a mask and a conversion each) and the pixel's
// three again for each candidate.  Timed one sample at a time on a KITTI
// pair's own 27 calls (118.4 ms): the taps read as ready floats 100.5 ms;
// the pixel's channels as floats too 106.3 (the extra 16-byte load costs
// more than three conversions); the index conversions replaced by exact
// integer arithmetic 119.5; no conversion at all 109.2; the weight a
// constant 116.8.  So the taps' unpack is what staging removes:
//   * a ring of 17 tile rows holds the other view's reachable columns as
//     f32 channels (B, G, R, gradient: 16 bytes a column, wrapped modulo
//     the level width as HandleBorder wraps them, one column past max_dis
//     for a match that rounds onto it) beside the tile's weight words and
//     gradients (and colour words with LAB): a column is unpacked once a
//     row a block, a tap is one 16-byte load of ready floats;
//   * the block walks its window diagonally: at step t every warp adds its
//     window row lat * t - hw, so the 16 warps read 16 consecutive tile
//     rows while the next one is filled, one barrier a step, and no warp
//     waits out a row its window lacks (walking the rows in order, as cost
//     lerp does, idles ~30 % of the warps at each barrier: 106.8 -> 101.9
//     ms a pair);
//   * a thread holds C = 1, 2, 4, 5 or 8 candidates (cost lerp's chunks)
//     that share each sample's weight, pixel and loop;
//   * at one level with a stride the rows lie on a lattice of that step and
//     the 32 columns stay adjacent: on a column lattice neighbouring lanes'
//     taps lie 32 bytes apart, two to a bank (101.9 -> 96.8 ms);
//   * the sample's pixel is its colour word, read for the weight and
//     unpacked once for the C candidates, and its gradient, not a 16-byte
//     row of channels (96.8 -> 91.7 ms).
// What bounds it: shared-memory traffic beside the instruction rate.  The two
// taps are 32 bytes a candidate and sample; without their loads a pair takes
// 79.9 ms, without the weight table 94.0.  Every rounding step is the
// one-sample design's, in its order, so the costs are bit-equal to it.
// Measured (H100 80GB HBM3, 700 W; KITTI, both views, the pipeline's own
// candidates; one sample at a time -> this design): K = 1 3.16 -> 2.75 ms,
// K = 2 6.27 -> 5.55, K = 5 at stride 2 4.30 -> 3.14, K = 8 at stride 2
// 6.89 -> 4.83; a pair's 27 launches 117.6 -> 91.9 ms.  Measured and dropped:
// both taps' colour words and gradients in one 16-byte record (half the taps'
// bytes, six unpacks a candidate: 106.1 ms with conversions, 94.8 with
// byte-permute and magic-number ones; faster only at K = 2), those
// conversions for the pixel (+1 %), the weight table replicated 8 times
// against bank conflicts (+1 %), b in shared memory or b * dy a sample for
// C = 8's spills (+-0.2 %), each view's direction fixed at compile time
// (+0.1 %), the sample loop unrolled by 2 (+0.2 %), the next row's pixels by
// cp.async a step ahead (+0.6 %), one block an SM at 128 registers for C >= 5
// (+2 %), the prescreen's K = 8 and 5 as chunks of 4 (+12 %).
//
// One sample at a time, fly_cost_kernel (cost lerp at a wide window and
// range, image lerp at a window of at most 7 past a range of ~780: where
// the shared rows do not fit a block, which no cell does).  What bounds it on
// the H100: instruction issue (~3.6 of 4 a clock), neither bytes (the
// inputs are O(H*W) per level) nor the f32 peak: a window sample is a
// chain of shared loads (pixel, weight table), the range test and two GRD
// slice costs (K5) or four channel lerps and a TAD (K6), about 65
// instructions in range.  The design (the shared parts are in
// window_common.cuh):
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
// Measured and dropped there: 2 or 4 candidates per thread sharing the
// weight (no gain even at the prescreen's 8 candidates: the shared part is
// small in this design, see window_common.cuh), instances with half_wnd 17
// and the stride fixed at
// compile time (slower than the runtime loop), cp.async / TMA staging (a
// block stages 19 pixels a thread against 1,225 window samples).
//
// Every rounding step is an explicit _rn intrinsic in the plain version's
// order (the channel mean is a multiply by f32(1/3), what PyTorch's CUDA
// division by the scalar 3.0 computes), so FMA contraction cannot move dq
// across a slice or range boundary and f32 results match the plain version
// on the card.  No inter-block state; the shared-row design's only atomics
// merge a row's slice range in shared memory.

#include "window_common.cuh"

namespace {

using namespace cspm;

// the shared-row design's rings: raw window rows (two ahead of the row
// summed) and slice-cost rows (one ahead)
constexpr int kRawStages = 3;
constexpr int kCostStages = 2;
// each window row's slice range (lo, hi), merged a row ahead of its build:
// three rows' slots, padded to keep the weight table 8-byte aligned
constexpr int kRangeSlots = 3;
constexpr int kRangeWords = 8;

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

// A pixel's BGR channels and gradient as floats: (B, G, R, gradient).
__device__ __forceinline__ float4 channels(uint32_t col, float grd) {
  return make_float4(chan(col, 0), chan(col, 1), chan(col, 2), grd);
}

// The image-lerp data term: q against the other view lerped at other_x
// between taps t0 at ox = trunc(other_x) and t1 at ox + 1, one_ox the float
// ox + 1 (every argument as channels gives it).
__device__ __forceinline__ float tap_term(const Grd& g, float4 q,
                                          float other_x, float one_ox,
                                          float4 t0, float4 t1) {
  const float fw = __fsub_rn(one_ox, other_x);
  const float omfw = __fsub_rn(1.f, fw);
  const float sum = __fadd_rn(
      __fadd_rn(fabsf(__fsub_rn(q.x, lerp2(fw, omfw, t0.x, t1.x))),
                fabsf(__fsub_rn(q.y, lerp2(fw, omfw, t0.y, t1.y)))),
      fabsf(__fsub_rn(q.z, lerp2(fw, omfw, t0.z, t1.z))));
  const float gl = lerp2(fw, omfw, t0.w, t1.w);
  return mix(g, third(sum), fabsf(__fsub_rn(q.w, gl)));
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
    const uint2 t0 = o_row[ox], t1 = o_row[ox + 1];
    return tap_term(g, channels(q.x, qg), other_x, (float)(ox + 1),
                    channels(t0.x, __uint_as_float(t0.y)),
                    channels(t1.x, __uint_as_float(t1.y)));
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

// ---- The shared-row design (cost lerp: K5, K3's fly form, K7) ----

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
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

// tad without the I2F: the colour TAD s <= 765 of u8 channels is exact as
// (2^23 + s) - 2^23, two full-rate instructions
__device__ __forceinline__ float row_tad(const Grd& g, uint32_t col,
                                         float grd, uint2 oth) {
  const uint32_t s = __vsadu4(col, oth.x);
  const float clr = __fsub_rn(__uint_as_float(0x4B000000u | s), 8388608.f);
  return mix(g, third(clr), fabsf(__fsub_rn(grd, __uint_as_float(oth.y))));
}

// The row buffer's column stride in floats: odd, so 32 neighbouring
// columns at one slice lie in 32 banks.
__host__ __device__ __forceinline__ int cost_stride(int max_dis) {
  return max_dis | 1;
}

// Tile columns of the shared-row design (level 0, the widest): every
// level column from the tile's first center - hw to its last + hw, or on
// a lattice of step `lat` (a block's centers lat apart, at one residue)
// only the columns its windows sample, 32 - 1 + the offsets an axis.
__host__ __device__ __forceinline__ int row_cols(int hw, int stride,
                                                 int lat) {
  return lat == 1 ? kTX + 2 * hw : kTX - 1 + (2 * hw) / stride + 1;
}

// Shared memory of the shared-row design, from level 0 (a coarser level's
// rows are narrower and its max_dis smaller): the rows' slice ranges, the
// weight table, three stages of raw window rows (the other view's
// reachable columns, the tile's colour and gradient words, its Lab words
// with LAB) and two stages of slice costs S[col][f - 1], f = 1 .. max_dis,
// at cost_stride(max_dis) floats a column.
size_t rows_smem_bytes(int hw, int stride, int lat, int max_dis0, bool lab) {
  const size_t tw = row_cols(hw, stride, lat);
  const size_t ow = lat * (tw - 1) + 1 + max_dis0;
  return (kRangeWords + kLutN + kRawStages * (2 * ow + tw * (lab ? 3 : 2)) +
          kCostStages * tw * cost_stride(max_dis0)) *
         sizeof(uint32_t);
}

// Window cost of every level for C candidates a thread (a chunk of
// per_chunk of the K, blockIdx.z = view * chunks + chunk; a chunk of fewer
// than C repeats its last candidate in the spare slots, so the loops carry
// no test), the block walking its window rows in order: while row r is
// summed from its slice costs, row r + 1's are computed and row r + 2's
// pixels arrive by cp.async.  A thread adds the row's samples of its
// center, dx ascending, when its window holds the row (every warp is one
// center row), so its sum keeps the plain version's order.  A row's slice
// costs are computed only over the slices its samples can read: dq is
// monotone along a row (every rounding step is), so a candidate's
// in-range samples read slices between those of the row's first and last
// sample; the block merges its threads' ranges a row ahead.  With a
// lattice (one level, stride lat > 1) a block's 32 x 16 pixels lie lat
// apart at one residue (blockIdx.x = column block * lat + residue, rows
// alike), so its windows sample only one residue of rows and columns.
template <bool LAB, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fly_cost_kernel_rows(const Levels lv,
                     const float* __restrict__ abc,  // [2, K, H, W, 3]
                     const float* __restrict__ lut,  // [766]
                     float* __restrict__ out,        // [2, K, H, W]
                     int K, int H, int W, int hw, int stride, int lat,
                     int per_chunk, const Grd g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int ty = blockDim.y;
  const int threads = kTX * ty;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kTX + lane;
  const int chunks = gridDim.z >> 1;
  const int v = blockIdx.z / chunks;
  const int k0 = (blockIdx.z - v * chunks) * per_chunk;
  const int n = min(per_chunk, K - k0);
  const bool left = v == 0;
  const int dir = left ? -1 : 1;
  const int bx = blockIdx.x / lat, by = blockIdx.y / lat;
  const int x0 = bx * kTX * lat + (blockIdx.x - bx * lat);  // first pixel
  const int y0 = by * ty * lat + (blockIdx.y - by * lat);
  if (x0 >= W || y0 >= H) return;  // a residue past the image's edge
  const int x = x0 + lat * lane, y = y0 + lat * warp;
  const bool active = x < W && y < H;
  const int x_last = x0 + lat * min(kTX - 1, (W - 1 - x0) / lat);
  const int y_last = y0 + lat * min(ty - 1, (H - 1 - y0) / lat);

  // the layout of rows_smem_bytes
  const int tw_max = row_cols(hw, stride, lat);
  const int ow_max = lat * (tw_max - 1) + 1 + lv.max_dis[0];
  const int cs_max = cost_stride(lv.max_dis[0]);
  int* s_rng = reinterpret_cast<int*>(smem);  // (lo, hi) of row r at r % 3
  float* s_lut = reinterpret_cast<float*>(smem + kRangeWords);
  uint2* s_oth = reinterpret_cast<uint2*>(s_lut + kLutN);  // 8-byte aligned
  uint32_t* s_col = reinterpret_cast<uint32_t*>(s_oth + kRawStages * ow_max);
  float* s_grd = reinterpret_cast<float*>(s_col + kRawStages * tw_max);
  uint32_t* s_lab = reinterpret_cast<uint32_t*>(s_grd + kRawStages * tw_max);
  float* s_cost = reinterpret_cast<float*>(s_lab +
                                           (LAB ? kRawStages * tw_max : 0));

  for (int i = tid; i < kLutN; i += threads) s_lut[i] = lut[i];
  const float fstride = (float)stride;

  for (int s = 0; s < lv.n; ++s) {
    const int hs = lv.h[s], ws = lv.w[s], md = lv.max_dis[s];
    const int cs = cost_stride(md);
    const int cx0 = x0 >> s, cy0 = y0 >> s;
    const int qx0 = cx0 - hw;  // level column of tile column 0
    const int qy0 = cy0 - hw;  // level row of tile row 0
    // tile columns (the samples' columns qx0 + lat * m) and rows
    const int tw = lat == 1 ? (x_last >> s) - cx0 + 1 + 2 * hw
                            : (x_last - x0) / lat + (2 * hw) / stride + 1;
    const int th = lat == 1 ? (y_last >> s) - cy0 + 1 + 2 * hw
                            : (y_last - y0) / lat + (2 * hw) / stride + 1;
    const int ow = lat * (tw - 1) + 1 + md;
    // level column of the other row's first column
    const int ox0 = left ? qx0 - md : qx0;
    // the tile rows inside the image: m_lo + r, r < nr
    const int m_lo = qy0 < 0 ? (-qy0 + lat - 1) / lat : 0;
    const int nr = min(th - 1, (hs - 1 - qy0) / lat) - m_lo + 1;
    const size_t plane = (size_t)hs * ws;
    const uint2* ref_v = lv.ref[s] + v * plane;
    const uint2* ref_o = lv.ref[s] + (1 - v) * plane;
    const uint32_t* lab_v = LAB ? lv.wgt[s] + v * plane : nullptr;

    // the thread's center and its C candidate planes at this level
    const int cx = x >> s, cy = y >> s;
    const Span sx = axis_span(cx, ws, hw, stride);
    const int dx0 = sx.lo * stride - hw;  // the row's first in-image offset
    const int nx = sx.hi - sx.lo + 1;
    const int m0 = (cx + dx0 - qx0) / lat;  // its tile column
    const int mstep = stride / lat;
    const float fdx0 = (float)dx0;
    const float fdx1 = (float)(dx0 + (nx - 1) * stride);
    const float scale = 1.f / (float)(1 << s);  // exact
    const float fmax = (float)md;
    uint32_t wc = 0;
    float a[C], b[C], d_f[C], acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[c] = b[c] = d_f[c] = acc[c] = 0.f;
      if (active) {
        const int k = k0 + min(c, n - 1);
        const size_t pix = ((size_t)(v * K + k) * H + y) * W + x;
        const Plane p = load_plane(abc, pix, x, y);
        a[c] = p.a;
        b[c] = p.b;
        d_f[c] = __fmul_rn(p.d0, scale);
      }
    }
    if (active) wc = LAB ? lab_v[(size_t)cy * ws + cx]
                         : ref_v[(size_t)cy * ws + cx].x;
    // window row r's offset from the thread's center, and whether its
    // window holds the row (warp-uniform but for the columns past the
    // image)
    auto row_dy = [&](int r) { return qy0 + lat * (m_lo + r) - cy; };
    auto holds = [&](int r) {
      const int dy = row_dy(r);
      return active && nx > 0 && dy >= -hw && dy <= hw &&
             (dy + hw) % stride == 0;
    };

    // window row r's in-image pixels into raw stage r % 3 (cost mode reads
    // only in-image columns: the border pseudo-cost stands in beyond them)
    auto stage = [&](int r) {
      const int st = r % kRawStages;
      const size_t row = (size_t)(qy0 + lat * (m_lo + r)) * ws;
      for (int i = tid; i < tw + ow; i += threads) {
        if (i < tw) {
          const int gx = qx0 + lat * i;
          if (gx < 0 || gx >= ws) continue;
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
              ref_v + row + gx);
          cp_async4(s_col + st * tw_max + i, src);
          cp_async4(s_grd + st * tw_max + i, src + 1);
          if (LAB) cp_async4(s_lab + st * tw_max + i, lab_v + row + gx);
        } else {
          const int j = i - tw, gx = ox0 + j;
          if (gx >= 0 && gx < ws)
            cp_async8(s_oth + st * ow_max + j, ref_o + row + gx);
        }
      }
      cp_async_commit();
    };
    // merge the slices the thread's samples on row r can read into the
    // row's range: an in-range sample at f = trunc(dq) reads f and f + 1
    auto reach = [&](int r) {
      int lo = md + 1, hi = 0;
      if (r < nr && holds(r)) {
        const float fdy = (float)row_dy(r);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float bdy = __fmul_rn(b[c], fdy);
          const float q0 =
              __fadd_rn(__fadd_rn(d_f[c], __fmul_rn(a[c], fdx0)), bdy);
          const float q1 =
              __fadd_rn(__fadd_rn(d_f[c], __fmul_rn(a[c], fdx1)), bdy);
          if (!isfinite(q0) || !isfinite(q1)) {
            lo = 1;  // not monotone on this row's evidence: all slices
            hi = md;
          } else {
            const float qlo = fminf(q0, q1), qhi = fmaxf(q0, q1);
            if (qhi >= 1.f && qlo < fmax) {
              lo = min(lo, qlo >= 1.f ? (int)qlo : 1);
              hi = max(hi, qhi < fmax ? (int)qhi + 1 : md);
            }
          }
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0 && lo <= hi) {
        atomicMin(s_rng + 2 * (r % kRangeSlots), lo);
        atomicMax(s_rng + 2 * (r % kRangeSlots) + 1, hi);
      }
    };
    // the slice costs of row r over its range into cost stage r % 2: a
    // warp takes 32 >> lg columns at a time, 1 << lg lanes a column
    auto build = [&](int r) {
      const int lo = s_rng[2 * (r % kRangeSlots)];
      const int hi = s_rng[2 * (r % kRangeSlots) + 1];
      if (lo > hi) return;
      const int st = r % kRawStages;
      const uint32_t* col_r = s_col + st * tw_max;
      const float* grd_r = s_grd + st * tw_max;
      const uint2* oth_r = s_oth + st * ow_max - ox0;  // by level column
      float* cost = s_cost + (r % kCostStages) * (tw_max * cs_max) - 1;
      const int span = hi - lo + 1;
      const int lg = span >= 32 ? 5 : 32 - __clz(span - 1);
      const int per = 32 >> lg;  // columns a warp takes at once
      const int f0 = lo + (lane & ((1 << lg) - 1));
      for (int m = warp * per + (lane >> lg); m < tw; m += ty * per) {
        const uint32_t qc = col_r[m];
        const float qg = grd_r[m];
        const int qx = qx0 + lat * m;
        for (int f = f0; f <= hi; f += 1 << lg) {
          const int ox = qx + dir * f;
          cost[m * cs + f] = (unsigned)ox < (unsigned)ws
                                 ? row_tad(g, qc, qg, oth_r[ox])
                                 : border_cost(g, qc, qg);
        }
      }
    };

    // (no window row inside the image, a lattice on a few rows: every
    // sample lies outside it and adds nothing)
    if (nr > 0) {
      __syncthreads();  // the previous level's stages are no longer read
      if (tid < kRangeSlots) {
        s_rng[2 * tid] = md + 1;  // empty
        s_rng[2 * tid + 1] = 0;
      }
      stage(0);
      if (nr > 1) stage(1);
      __syncthreads();
      reach(0);
      reach(1);
      cp_async_wait_all();
      __syncthreads();
      build(0);
      __syncthreads();
      for (int r = 0; r < nr; ++r) {
        if (r + 2 < nr) stage(r + 2);
        if (tid == 0) {  // row r's range was read by its build
          s_rng[2 * (r % kRangeSlots)] = md + 1;
          s_rng[2 * (r % kRangeSlots) + 1] = 0;
        }
        reach(r + 2);
        if (r + 1 < nr) build(r + 1);
        if (holds(r)) {
          const float fdy = (float)row_dy(r);
          float bdy[C];
#pragma unroll
          for (int c = 0; c < C; ++c) bdy[c] = __fmul_rn(b[c], fdy);
          // slice f of the sample's column at sp[f]
          const float* sp =
              s_cost + (r % kCostStages) * (tw_max * cs_max) + m0 * cs - 1;
          const uint32_t* wp =
              (LAB ? s_lab : s_col) + (r % kRawStages) * tw_max + m0;
          const int sstep = mstep * cs;
          float fdx = fdx0;
          for (int i = 0; i < nx; ++i) {
            const float wgt = s_lut[__vsadu4(wc, *wp)];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float dq =
                  __fadd_rn(__fadd_rn(d_f[c], __fmul_rn(a[c], fdx)), bdy[c]);
              const bool in = dq >= 1.f && dq < fmax;  // NaN fails both
              const float t = biased_trunc(dq);
              float c0 = 0.f, c1 = 0.f;
              if (in) {
                const float* p = sp + trunc_of(t);
                c0 = p[0];
                c1 = p[1];
              }
              const float fw = __fsub_rn(trunc_plus_one(t), dq);
              const float val = lerp2(fw, __fsub_rn(1.f, fw), c0, c1);
              acc[c] = __fadd_rn(acc[c], __fmul_rn(wgt, in ? val : g.sat));
            }
            sp += sstep;
            wp += mstep;
            fdx += fstride;  // small integers: exact, equal to (float)dx
          }
        }
        cp_async_wait_all();
        __syncthreads();
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n) {
          float* o = out + ((size_t)(v * K + k0 + c) * H + y) * W + x;
          const float term = __fmul_rn(lv.scale_wgt[s], acc[c]);
          *o = s == 0 ? term : __fadd_rn(*o, term);
        }
      }
    }
  }
}

// ---- The shared-row design of image lerp (K6) ----

// Image lerp's ring of tile rows: the 16 a block's warps read at a step
// and the one filled meanwhile (kMaxTY + 1).
constexpr int kTapRows = 17;
// The weight table's words in image lerp's layout, padded to a multiple of
// 4 so the ring's 16-byte loads are aligned.
constexpr int kTapLut = 768;
static_assert(kTapRows == kMaxTY + 1 && kTapLut >= kLutN && kTapLut % 4 == 0,
              "image lerp's layout");

// Shared memory of image lerp's shared-row design, from level 0: the weight
// table, then kTapRows tile rows, each the other view's reachable columns
// as f32 channels (16 bytes a column: the tile's 32 + 2 hw columns, max_dis
// beyond them and one more, the far tap of a match that rounds onto
// max_dis) and the tile's 32 + 2 hw columns as weight words (colour, or
// Lab with LAB), gradients and, with LAB, colour words.
size_t image_rows_smem_bytes(int hw, int max_dis0, bool lab) {
  const size_t tw = kTX + 2 * hw, ow = tw + max_dis0 + 1;
  return (kTapLut + kTapRows * (4 * ow + tw * (lab ? 3 : 2))) *
         sizeof(uint32_t);
}

// Window cost of every level for C candidates a thread, image lerp (the
// chunks as in fly_cost_kernel_rows).  A block is 32 adjacent columns of
// 16 rows; with a lattice (one level, stride lat > 1) the rows lie lat
// apart at one residue (blockIdx.y = row block * lat + residue), so its
// windows sample one residue of rows, and its 32 columns stay adjacent:
// neighbouring lanes read neighbouring columns at each window offset, in
// distinct banks.  The block walks its window diagonally: at step t every
// warp (one center row) adds its window row dy = lat * t - hw, tile row
// c + t for its center's tile row c, dx ascending, so its sum keeps the
// plain version's order, and the 16 warps read 16 consecutive tile rows at
// once: none waits out a row its window lacks.  The tile rows sit in a
// ring of kTapRows, the other view's reachable columns (wrapped modulo the
// level width, HandleBorder) as f32 channels and the tile's weight words
// and gradients: at step t rows t .. t + 15 are read while row t + 16 is
// filled, one barrier a step.  A sample unpacks its pixel's colour word
// once for its C candidates; each candidate lerps two ready taps.
template <bool LAB, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fly_cost_kernel_image_rows(const Levels lv,
                           const float* __restrict__ abc,  // [2, K, H, W, 3]
                           const float* __restrict__ lut,  // [766]
                           float* __restrict__ out,        // [2, K, H, W]
                           int K, int H, int W, int hw, int stride, int lat,
                           int per_chunk, const Grd g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int ty = blockDim.y;
  const int threads = kTX * ty;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kTX + lane;
  const int chunks = gridDim.z >> 1;
  const int v = blockIdx.z / chunks;
  const int k0 = (blockIdx.z - v * chunks) * per_chunk;
  const int n = min(per_chunk, K - k0);
  const bool left = v == 0;
  const int by = blockIdx.y / lat;
  const int x0 = blockIdx.x * kTX;  // first pixel
  const int y0 = by * ty * lat + (blockIdx.y - by * lat);
  if (y0 >= H) return;  // a residue past the image's edge
  const int x = x0 + lane, y = y0 + lat * warp;
  const bool active = x < W && y < H;
  const int x_last = min(x0 + kTX, W) - 1;
  const int y_last = y0 + lat * min(ty - 1, (H - 1 - y0) / lat);

  // the layout of image_rows_smem_bytes
  const int tw_max = kTX + 2 * hw;
  const int ow_max = tw_max + lv.max_dis[0] + 1;
  float* s_lut = reinterpret_cast<float*>(smem);
  float4* s_fo = reinterpret_cast<float4*>(smem + kTapLut);
  uint32_t* s_wt = reinterpret_cast<uint32_t*>(s_fo + kTapRows * ow_max);
  float* s_gt = reinterpret_cast<float*>(s_wt + kTapRows * tw_max);
  uint32_t* s_ct = reinterpret_cast<uint32_t*>(s_gt + kTapRows * tw_max);

  for (int i = tid; i < kLutN; i += threads) s_lut[i] = lut[i];
  const float fstride = (float)stride;
  const int steps = (2 * hw) / lat + 1;  // a center's window rows

  for (int s = 0; s < lv.n; ++s) {
    const int hs = lv.h[s], ws = lv.w[s], md = lv.max_dis[s];
    const int cx0 = x0 >> s, cy0 = y0 >> s;
    const int qx0 = cx0 - hw;  // level column of tile column 0
    const int qy0 = cy0 - hw;  // level row of tile row 0
    // tile columns qx0 + m, tile rows qy0 + lat * m, other view's columns
    const int tw = (x_last >> s) - cx0 + 1 + 2 * hw;
    const int th = ((y_last >> s) - cy0) / lat + steps;
    const int ow = tw + md + 1;
    // level column of the other row's first column
    const int ox0 = left ? qx0 - md : qx0;
    const size_t plane = (size_t)hs * ws;
    const uint2* ref_v = lv.ref[s] + v * plane;
    const uint2* ref_o = lv.ref[s] + (1 - v) * plane;
    const uint32_t* lab_v = LAB ? lv.wgt[s] + v * plane : nullptr;

    // the thread's center and its C candidate planes at this level
    const int cx = x >> s, cy = y >> s;
    const Span sx = axis_span(cx, ws, hw, stride);
    const int dx0 = sx.lo * stride - hw;  // the row's first in-image offset
    const int nx = sx.hi - sx.lo + 1;
    const int m0 = cx + dx0 - qx0;  // its tile column
    const int c_row = (cy - cy0) / lat;  // the center's tile row, less hw
    const float fdx0 = (float)dx0;
    const float fqx0 = (float)(cx + dx0);
    const float scale = 1.f / (float)(1 << s);  // exact
    const float fmax = (float)md;
    uint32_t wc = 0;
    float a[C], b[C], d_f[C], acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[c] = b[c] = d_f[c] = acc[c] = 0.f;
      if (active) {
        const int k = k0 + min(c, n - 1);
        const size_t pix = ((size_t)(v * K + k) * H + y) * W + x;
        const Plane p = load_plane(abc, pix, x, y);
        a[c] = p.a;
        b[c] = p.b;
        d_f[c] = __fmul_rn(p.d0, scale);
      }
    }
    if (active) wc = LAB ? lab_v[(size_t)cy * ws + cx]
                         : ref_v[(size_t)cy * ws + cx].x;

    // tile row m's pixels into ring slot m % kTapRows: the other view's
    // reachable columns wrapped modulo the width, the tile's columns inside
    // the image (a row outside it is never read)
    auto fill = [&](int m) {
      const int gy = qy0 + lat * m;
      if (m >= th || gy < 0 || gy >= hs) return;
      const size_t row = (size_t)gy * ws;
      const int slot = m % kTapRows;
      float4* fo = s_fo + slot * ow_max;
      const int to = slot * tw_max;
      for (int i = tid; i < ow + tw; i += threads) {
        if (i < ow) {
          const int gx = ((ox0 + i) % ws + ws) % ws;
          const uint2 p = ref_o[row + gx];
          fo[i] = channels(p.x, __uint_as_float(p.y));
        } else {
          const int j = i - ow, gx = qx0 + j;
          if (gx < 0 || gx >= ws) continue;
          const uint2 p = ref_v[row + gx];
          s_wt[to + j] = LAB ? lab_v[row + gx] : p.x;
          s_gt[to + j] = __uint_as_float(p.y);
          if (LAB) s_ct[to + j] = p.x;
        }
      }
    };

    __syncthreads();  // the previous level's rows are no longer read
    for (int m = 0; m < kTapRows - 1; ++m) fill(m);
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      fill(t + kTapRows - 1);  // into the slot row t - 1 left
      const int dy = lat * t - hw;
      if (active && nx > 0 && (dy + hw) % stride == 0 && cy + dy >= 0 &&
          cy + dy < hs) {
        const int slot = (c_row + t) % kTapRows;
        const float fdy = (float)dy;
        float bdy[C];
#pragma unroll
        for (int c = 0; c < C; ++c) bdy[c] = __fmul_rn(b[c], fdy);
        // the sample's pixel: weight word, gradient, colour word
        const int qo = slot * tw_max + m0;
        const uint32_t* wp = s_wt + qo;
        const float* gp = s_gt + qo;
        const uint32_t* cp = (LAB ? s_ct : s_wt) + qo;
        // the other view's row by level column
        const float4* o_row = s_fo + slot * ow_max - ox0;
        float fdx = fdx0, fqx = fqx0;
        for (int i = 0; i < nx; ++i) {
          const uint32_t qw = *wp;
          const float wgt = s_lut[__vsadu4(wc, qw)];
          const float4 q = channels(LAB ? *cp : qw, *gp);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float dq =
                __fadd_rn(__fadd_rn(d_f[c], __fmul_rn(a[c], fdx)), bdy[c]);
            const bool in = dq >= 1.f && dq < fmax;  // NaN fails both
            const float other_x = __fadd_rn(fqx, left ? -dq : dq);
            const int ox = (int)other_x;  // C trunc
            float4 t0 = make_float4(0.f, 0.f, 0.f, 0.f), t1 = t0;
            if (in) {
              t0 = o_row[ox];
              t1 = o_row[ox + 1];
            }
            const float val =
                tap_term(g, q, other_x, (float)(ox + 1), t0, t1);
            acc[c] = __fadd_rn(acc[c], __fmul_rn(wgt, in ? val : g.sat));
          }
          wp += stride;
          gp += stride;
          cp += stride;
          fdx += fstride;  // small integers: exact, equal to (float)dx
          fqx += fstride;
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < n) {
          float* o = out + ((size_t)(v * K + k0 + c) * H + y) * W + x;
          const float term = __fmul_rn(lv.scale_wgt[s], acc[c]);
          *o = s == 0 ? term : __fadd_rn(*o, term);
        }
      }
    }
  }
}

// ---- Launches ----

// Shared memory of the one-sample-at-a-time design: the level-0 tiles of
// the reference view (and its Lab words) and of the other view's reachable
// columns, over the tile's rows and the window's.
size_t sample_smem_bytes(int hw, int max_dis0, bool lab, int tile_rows) {
  // level 0's tiles are the largest: a coarser level's block spans fewer
  // centers and a smaller max_dis
  const size_t tile = (size_t)(kTX + 2 * hw) * (tile_rows + 2 * hw);
  const size_t oth = (size_t)(kTX + 2 * hw + max_dis0) * (tile_rows + 2 * hw);
  return (kLutN + tile * (lab ? 3 : 2) + oth * 2) * sizeof(uint32_t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool IMAGE, bool LAB>
cudaError_t launch_sample(const Levels& lv, const void* abc, const void* lut,
                          void* out, int K, int H, int W, int hw, int stride,
                          int tile_rows, size_t smem, const Grd& g,
                          cudaStream_t stream) {
  if (tile_rows != kMaxTY && tile_rows != kMaxTY / 2)
    return cudaErrorInvalidValue;
  if (smem < sample_smem_bytes(hw, lv.max_dis[0], LAB, tile_rows))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fly_cost_kernel<IMAGE, LAB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 block(kTX, tile_rows);
  const dim3 grid((W + kTX - 1) / kTX, (H + tile_rows - 1) / tile_rows,
                  2 * K);
  fly_cost_kernel<IMAGE, LAB>
      <<<grid, block, smem, stream>>>(
          lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
          static_cast<float*>(out), K, H, W, hw, stride, g);
  return cudaGetLastError();
}

template <bool LAB, int C>
cudaError_t launch_rows(const Levels& lv, const void* abc, const void* lut,
                        void* out, int K, int H, int W, int hw, int stride,
                        int lat, int per_chunk, size_t smem, const Grd& g,
                        cudaStream_t stream) {
  if (smem < rows_smem_bytes(hw, stride, lat, lv.max_dis[0], LAB))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fly_cost_kernel_rows<LAB, C>, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (K + per_chunk - 1) / per_chunk;
  const int gx = (W + kTX * lat - 1) / (kTX * lat) * lat;
  const int gy = (H + kMaxTY * lat - 1) / (kMaxTY * lat) * lat;
  if (2 * chunks > 65535 || gy > 65535) return cudaErrorInvalidValue;
  fly_cost_kernel_rows<LAB, C>
      <<<dim3(gx, gy, 2 * chunks), dim3(kTX, kMaxTY), smem, stream>>>(
          lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
          static_cast<float*>(out), K, H, W, hw, stride, lat, per_chunk, g);
  return cudaGetLastError();
}

template <bool LAB, int C>
cudaError_t launch_image_rows(const Levels& lv, const void* abc,
                              const void* lut, void* out, int K, int H, int W,
                              int hw, int stride, int lat, int per_chunk,
                              size_t smem, const Grd& g, cudaStream_t stream) {
  if (smem < image_rows_smem_bytes(hw, lv.max_dis[0], LAB))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fly_cost_kernel_image_rows<LAB, C>, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (K + per_chunk - 1) / per_chunk;
  const int gx = (W + kTX - 1) / kTX;
  const int gy = (H + kMaxTY * lat - 1) / (kMaxTY * lat) * lat;
  if (2 * chunks > 65535 || gy > 65535) return cudaErrorInvalidValue;
  fly_cost_kernel_image_rows<LAB, C>
      <<<dim3(gx, gy, 2 * chunks), dim3(kTX, kMaxTY), smem, stream>>>(
          lv, static_cast<const float*>(abc), static_cast<const float*>(lut),
          static_cast<float*>(out), K, H, W, hw, stride, lat, per_chunk, g);
  return cudaGetLastError();
}

// The shared-row design's launch for a thread's C candidates: image lerp's
// kernel or cost lerp's.
template <bool IMAGE, bool LAB, int C>
cudaError_t launch_shared_rows(const Levels& lv, const void* abc,
                               const void* lut, void* out, int K, int H,
                               int W, int hw, int stride, int lat,
                               int per_chunk, size_t smem, const Grd& g,
                               cudaStream_t stream) {
  if (IMAGE)
    return launch_image_rows<LAB, C>(lv, abc, lut, out, K, H, W, hw, stride,
                                     lat, per_chunk, smem, g, stream);
  return launch_rows<LAB, C>(lv, abc, lut, out, K, H, W, hw, stride, lat,
                             per_chunk, smem, g, stream);
}

template <bool IMAGE, bool LAB>
cudaError_t launch_rows_cands(const Levels& lv, const void* abc,
                              const void* lut, void* out, int K, int H, int W,
                              int hw, int stride, int lat, int cands,
                              int per_chunk, size_t smem, const Grd& g,
                              cudaStream_t stream) {
  if (per_chunk < 1 || per_chunk > cands) return cudaErrorInvalidValue;
  switch (cands) {
    case 1:
      return launch_shared_rows<IMAGE, LAB, 1>(lv, abc, lut, out, K, H, W, hw,
                                               stride, lat, per_chunk, smem,
                                               g, stream);
    case 2:
      return launch_shared_rows<IMAGE, LAB, 2>(lv, abc, lut, out, K, H, W, hw,
                                               stride, lat, per_chunk, smem,
                                               g, stream);
    case 4:
      return launch_shared_rows<IMAGE, LAB, 4>(lv, abc, lut, out, K, H, W, hw,
                                               stride, lat, per_chunk, smem,
                                               g, stream);
    case 5:
      return launch_shared_rows<IMAGE, LAB, 5>(lv, abc, lut, out, K, H, W, hw,
                                               stride, lat, per_chunk, smem,
                                               g, stream);
    case 8:
      return launch_shared_rows<IMAGE, LAB, 8>(lv, abc, lut, out, K, H, W, hw,
                                               stride, lat, per_chunk, smem,
                                               g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Per-level arrays (host memory, `levels` entries each): the interleaved
// (packed BGR, f32 gradient) images and the packed Lab images (device
// pointers; Lab only when lab), shapes, the levels' max_dis and scale
// weights.  coef = (alpha, 1 - alpha, tau_clr, tau_grd, border_thres, sat).
// The launch plan (ops/cuda/fly_cost.py launch_plan): rows 1 for the
// shared-row design (either lerp; 16-row tiles), 0 for one sample at a
// time (16 or 8 tile rows); the lattice step of the shared-row design's
// rows, and in cost lerp its columns (1, or the stride at one level); the
// candidates a thread holds (1, 2, 4, 5 or 8; 1 one sample at a time) and
// a block takes; the shared bytes a block.  Returns cudaErrorInvalidValue
// for a plan the kernels do not take (more than 227 KB of shared memory, or
// fewer bytes than the design lays out).
extern "C" int cspm_fly_cost(
    const void* const* refs, const void* const* wgts_img, const int* hs,
    const int* ws, const int* max_dis, const float* scale_wgts, int levels,
    int image, int lab, const float* coef, const void* abc, const void* lut,
    void* out, int K, int H, int W, int half_wnd, int stride, int rows,
    int tile_rows, int lattice, int cands, int per_chunk, int smem,
    void* stream) {
  if (levels < 1 || levels > kMaxLevels || stride < 1 || K < 1 ||
      smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (rows && (tile_rows != kMaxTY ||
               (lattice != 1 && (lattice != stride || levels != 1))))
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
  const size_t bytes = (size_t)smem;
  if (rows) {
    if (image) {
      if (lab)
        return (int)launch_rows_cands<true, true>(
            lv, abc, lut, out, K, H, W, half_wnd, stride, lattice, cands,
            per_chunk, bytes, g, st);
      return (int)launch_rows_cands<true, false>(
          lv, abc, lut, out, K, H, W, half_wnd, stride, lattice, cands,
          per_chunk, bytes, g, st);
    }
    if (lab)
      return (int)launch_rows_cands<false, true>(
          lv, abc, lut, out, K, H, W, half_wnd, stride, lattice, cands,
          per_chunk, bytes, g, st);
    return (int)launch_rows_cands<false, false>(
        lv, abc, lut, out, K, H, W, half_wnd, stride, lattice, cands,
        per_chunk, bytes, g, st);
  }
  if (image) {
    if (lab)
      return (int)launch_sample<true, true>(lv, abc, lut, out, K, H, W,
                                            half_wnd, stride, tile_rows,
                                            bytes, g, st);
    return (int)launch_sample<true, false>(lv, abc, lut, out, K, H, W,
                                           half_wnd, stride, tile_rows, bytes,
                                           g, st);
  }
  if (lab)
    return (int)launch_sample<false, true>(lv, abc, lut, out, K, H, W,
                                           half_wnd, stride, tile_rows, bytes,
                                           g, st);
  return (int)launch_sample<false, false>(lv, abc, lut, out, K, H, W,
                                          half_wnd, stride, tile_rows, bytes,
                                          g, st);
}
