// Kernel GRDV: the truncated colour + gradient (GRD) cost volumes of both
// reference views, every (view, y, x, d) in one launch, from the two u8
// RGB views as they are.
//
// Replaces the JAX engine's per-slice loop in crossscalepatchmatch_tpu/ops/
// grad_cost.py grd_cost_volume (:62-71: a Python loop over the D + 1
// slices, each a roll, a TAD and a select), which XLA fuses inside
// run_pair's one jitted program.  It is not a Pallas kernel.  Plain
// version: ops/grad_cost.py grd_cost_volume (~16 eager launches a slice).
//
// For reference pixel (y, x) and d in [0, D), with the other view's column
// ox = x - d (left reference) or x + d (right reference):
//   in range (0 <= ox < W):
//     clr = sum_c |ref_c - oth_c| * f32(1/3),  grd = |g_ref - g_oth|;
//   else (the constant border_thres stands in for the other view):
//     clr = ((|ref_0 - b| + |ref_1 - b|) + |ref_2 - b|) * f32(1/3),
//     grd = |g_ref - b|;
//   cost = alpha * min(clr, tau_clr) + beta * min(grd, tau_grd),
// alpha = f32(alpha), beta = f32(1 - alpha) formed in double, as PyTorch
// casts the plain version's Python scalars.  g is the Sobel-x gradient
// (ops/gradient.py sobel_x_k1) of the f32 gray image (ops/color.py
// rgb_to_gray_f32): g(x) = gray(x + 1) - gray(x - 1), 0 in the first and
// last column (so 0 at W = 1 and 2), gray = (0.299f R + 0.587f G) +
// 0.114f B.
//
// Exactness (bit-equal to the plain version on the card): the in-range
// colour sum is of u8 differences, an integer <= 765 that every order
// forms exactly, here one __vsadu4.  The mean's "/ 3.0" is, on a CUDA
// tensor, PyTorch's multiply by the f32 reciprocal of the CPU scalar (its
// true-division kernel), so this kernel multiplies by 1.f / 3.f as the fly
// kernel does; the CPU's true division differs by one ulp at some sums
// (ROADMAP §3).  Every other step, the gray image and the gradient
// included, is one explicit _rn operation in the plain version's order
// (each of its eager ops rounds), so no FMA contraction can merge two
// roundings.
//
// Inputs: the left and right u8[H, W, 3] RGB views with their strides (a
// band's rows, any layout).  Output: f32[2, H, W, D], D-minor, the
// left-referenced volume at 0.
//
// What bounds it on the H100: the bytes of the volumes it writes (4 B an
// element; the u8 views it reads are 3 B a pixel).  The design
// (volume_walk.cuh): a block takes one contiguous run of a row's outputs;
// its prologue forms in shared memory, from the u8 views, what the run
// reads (per reference column its packed RGB, gradient and border cost,
// per other-view column its packed RGB and gradient), so nothing is packed
// before the launch; its body writes the run with every warp's stores one
// aligned 128-byte line, walking (x, d) with no division per element and
// taking every tap from shared memory.  The stores are 4 bytes a lane: 16
// bytes a lane would put four neighbouring d on one lane, whose other-view
// columns are then four apart across lanes (a 4-way bank conflict), for
// the same lines written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "volume_walk.cuh"

namespace {

using namespace cspm_volume;

struct Grd {
  float alpha, beta, tau_clr, tau_grd, border;
};

__device__ __forceinline__ float third(float x) {
  return __fmul_rn(x, 1.f / 3.f);
}

__device__ __forceinline__ float mix(const Grd& g, float clr, float grd) {
  return __fadd_rn(__fmul_rn(g.alpha, fminf(clr, g.tau_clr)),
                   __fmul_rn(g.beta, fminf(grd, g.tau_grd)));
}

// ops/color.py rgb_to_gray_f32: (0.299 R + 0.587 G) + 0.114 B in f32
__device__ __forceinline__ float gray(uint32_t p) {
  return __fadd_rn(__fadd_rn(__fmul_rn((float)chan(p, 0), 0.299f),
                             __fmul_rn((float)chan(p, 1), 0.587f)),
                   __fmul_rn((float)chan(p, 2), 0.114f));
}

// ops/gradient.py sobel_x_k1 at (y, x)
__device__ __forceinline__ float sobel(const View& v, int y, int x, int W) {
  if (x == 0 || x >= W - 1) return 0.f;
  return __fsub_rn(gray(load_rgb(v, y, x + 1)), gray(load_rgb(v, y, x - 1)));
}

// A reference column's staged data: its packed RGB, its gradient's bits
// and its border cost's bits (one 16-byte load); an other-view column's:
// its packed RGB and gradient's bits (one 8-byte load).
template <int RIGHT>
__device__ __forceinline__ void grd_run(const View& lv, const View& rv,
                                        float* __restrict__ out,
                                        const Geom& g, const Grd& c,
                                        uint4* smem) {
  const int y = blockIdx.y;
  const Span s = span_of<RIGHT>(blockIdx.x, g);
  const int nr = s.x_hi - s.x_lo + 1, no = s.o_hi - s.o_lo + 1;
  uint4* ref_s = smem;
  uint2* oth_s = reinterpret_cast<uint2*>(smem + nr);

  // the prologue: the run's reference and other-view columns
  const View ref = RIGHT ? rv : lv;
  const View oth = RIGHT ? lv : rv;
  for (int i = threadIdx.x; i < nr + no; i += kThreads) {
    if (i < nr) {
      const int x = s.x_lo + i;
      const uint32_t p = load_rgb(ref, y, x);
      const float gr = sobel(ref, y, x, g.W);
      const float sum = __fadd_rn(
          __fadd_rn(fabsf(__fsub_rn((float)chan(p, 0), c.border)),
                    fabsf(__fsub_rn((float)chan(p, 1), c.border))),
          fabsf(__fsub_rn((float)chan(p, 2), c.border)));
      const float bdr = mix(c, third(sum), fabsf(__fsub_rn(gr, c.border)));
      ref_s[i] = make_uint4(p, __float_as_uint(gr), __float_as_uint(bdr), 0);
    } else {
      const int x = s.o_lo + i - nr;
      oth_s[i - nr] = make_uint2(load_rgb(oth, y, x),
                                 __float_as_uint(sobel(oth, y, x, g.W)));
    }
  }
  __syncthreads();

  const long long base = ((long long)(RIGHT * g.H + y) * g.W) * g.D;
  walk<RIGHT>(out, base, s, g, [&](int i, int j, bool in) {
    const uint4 r = ref_s[i];
    const uint2 o = oth_s[in ? j : 0];
    const float cost = mix(
        c, third((float)__vsadu4(r.x, o.x)),
        fabsf(__fsub_rn(__uint_as_float(r.y), __uint_as_float(o.y))));
    return in ? cost : __uint_as_float(r.z);
  });
}

__global__ void __launch_bounds__(kThreads)
grd_volume_kernel(View lv, View rv, float* __restrict__ out, Geom g, Grd c) {
  extern __shared__ uint4 smem[];
  if (blockIdx.z)
    grd_run<1>(lv, rv, out, g, c, smem);
  else
    grd_run<0>(lv, rv, out, g, c, smem);
}

}  // namespace

// Shared memory a block of grd_volume_kernel takes at most, in bytes.
static size_t grd_smem_bytes(int W, int D) {
  return 16 * (size_t)ref_cols_max(W) + 8 * (size_t)oth_cols_max(W, D);
}

// l / r: u8[H, W, 3] views, strides (sy, sx, sc) in elements; out: f32[2,
// H, W, D], contiguous and 128-byte aligned.  One launch writes both
// views' volumes.  Returns cudaSuccess or the launch's error.
extern "C" int cspm_grd_volume(const void* l, long long lsy, long long lsx,
                               long long lsc, const void* r, long long rsy,
                               long long rsx, long long rsc, void* out,
                               int H, int W, int D, float alpha, float beta,
                               float tau_clr, float tau_grd, float border,
                               void* stream) {
  if (H < 1 || W < 1 || D < 1 || H > 65535 ||
      (long long)W * D > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const size_t smem = grd_smem_bytes(W, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grd_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return refused(e);
  }
  const View lv{static_cast<const uint8_t*>(l), lsy, lsx, lsc};
  const View rv{static_cast<const uint8_t*>(r), rsy, rsx, rsc};
  const Grd c{alpha, beta, tau_clr, tau_grd, border};
  dim3 grid((unsigned)segments(W, D), (unsigned)H, 2);
  grd_volume_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      lv, rv, static_cast<float*>(out), geom(H, W, D), c);
  return (int)cudaGetLastError();
}
