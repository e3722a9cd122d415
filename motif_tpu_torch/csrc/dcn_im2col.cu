// dcn_im2col: the deformable im2col of the modulated deformable conv
// (DCNv2) in one pass: sample positions from the offsets, bilinear
// sampling of grouped NHWC features with zero outside the image, times the
// (already sigmoided) mask, written as the GEMM-ready column matrix that
// one addmm with the weights contracts.
//
// Replaces the TPU kernels motif_tpu/ops/dcn_pallas.py::_kernel (one-hot
// MXU contractions per 512-query tile, behind sample_pallas) and
// motif_tpu/ops/dcn_pallas.py::_ywin_kernel (the same contract over a
// per-row y-window, behind sample_pallas_ywin), together with the XLA ops
// around them in motif_tpu/ops/dcn.py (_sample_positions, the mask
// multiply and the transpose into the im2col operand). It is exact for
// every input: no window, no precondition.
//
// Element type E: float32 or bfloat16 (one template, two entries). In
// bfloat16 x, the offsets, the mask and the columns are bfloat16; the
// positions, the hat weights, the corner sum and the mask product are
// float32, and a column is rounded once, at its store. (The JAX package's
// one-hot sampler rounds its hat weights to bfloat16 before the product;
// this kernel keeps them float32, which costs it nothing.)
//
// Layout:
//   x    (B, H, W, G * cg)     NHWC, contiguous; group g owns channels
//                              [g * cg, (g + 1) * cg)
//   off  (B, Ho, Wo, G*K*K*2)  layout (g, k, [y, x]); pixel p's row starts
//                              at off + p * off_row (a strided view, such
//                              as a channel slice of one conv output, is
//                              read in place)
//   mask (B, Ho, Wo, G*K*K)    layout (g, k); row p at mask + p * mask_row
//   cols (B*Ho*Wo, G*K*K*cg)   column (g, k, c), c fastest: the order of
//                              motif_tpu's _dcn_v2_gather sample tensor
// cols[p, g, k, c] = mask[p, g, k] * sum over the 4 integer corners (y, x)
// around (py, px) of hat weight * x[b, y, x, g * cg + c], with
//   py = ho * stride - pad + (k / K) * dil + off[p, g, k, 0]
//   px = wo * stride - pad + (k % K) * dil + off[p, g, k, 1]
// and each corner outside the image contributing zero: the per-corner
// bounds of the reference CUDA im2col (dcn_v2_im2col_cuda.cu). Validity is
// decided in float, so huge or non-finite positions never reach an int.
//
// Bound on an H100: memory. At the PCD's L1 (B = 2, 64 x 112, G = 8,
// cg = 8, K = 3) it reads x (3.7 MB, which stays in L2), the offsets and
// the mask (12.4 MB) and writes the columns (33.0 MB): 49.1 MB, 0.0147 ms
// at 3.35 TB/s, against ~1.2 flops per byte.
// Design: one thread per (pixel, group, tap, VEC-channel chunk), chunk
// fastest, so that a warp stores one contiguous run of columns (512 bytes
// when cg % 4 == 0). The first lanes of each warp compute the warp's taps
// (position, hat weights, corner offsets and mask: once per tap, reading
// the offsets and the mask of neighbouring taps at neighbouring addresses)
// and hand each chunk thread its tap by warp shuffle. Each thread then
// loads the four corner runs of VEC contiguous channels of x (16-byte
// loads: 4 floats when cg % 4 == 0, 8 bfloat16s when cg % 8 == 0; x stays
// in L2) and writes VEC columns. No shared
// memory and no barrier: at the PCD's L3 (896 pixels) the kernel is a few
// microseconds of latency, and a form that staged the taps in shared
// memory behind a barrier was slower there and at L1 on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
typedef __nv_bfloat16 bf16;

struct Tap {
  float4 w;  // hat weights of corners (y0, x0), (y0, x1), (y1, x0), (y1, x1)
  int4 i;    // x offset of each corner's channel run for this group (the
             // batch's image start plus the group's channels where the
             // corner is outside the image: read there with weight 0)
  float m;   // the mask
};

// VEC consecutive elements of type E at p, as floats: one 16-byte access
// for 4 floats or 8 bfloat16s, else one element.
template <typename E, int VEC>
struct Run;
template <>
struct Run<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Run<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};
template <>
struct Run<bf16, 8> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // a bfloat16 is the top half of a float
      v[2 * n] = __uint_as_float(u[n] << 16);
      v[2 * n + 1] = __uint_as_float(u[n] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    unsigned u[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * n], v[2 * n + 1]);
      u[n] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};
template <>
struct Run<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

// All indices are 32-bit: the wrapper refuses x or columns of 2**31
// elements or more. KT and NCT are K and cg / VEC where they are known at
// compile time (3 and 2 or 1: every DCN of the model), else 0; the
// divisions by them then cost a multiply.
template <typename E, int VEC, int KT, int NCT>
__global__ void __launch_bounds__(THREADS)
    dcn_im2col_kernel(const E* __restrict__ x, const E* __restrict__ off,
                      const E* __restrict__ msk, E* __restrict__ cols,
                      int H, int W, int Ho, int Wo, int G, int cg, int k_any,
                      int stride, int pad, int dil, int off_row, int mask_row,
                      int npix) {
  const int K = KT ? KT : k_any;
  const int KK = K * K;
  const int GKK = G * KK;
  const int nchunk = NCT ? NCT : cg / VEC;
  const int n_taps = npix * GKK;
  const int n_items = n_taps * nchunk;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // the warp's items span taps tap0 .. tap0 + 31 / nchunk + 1 at most
  const int tap0 = (j - lane) / nchunk;
  const int my = tap0 + lane;
  Tap t;
  t.w = make_float4(0.f, 0.f, 0.f, 0.f);
  t.i = make_int4(0, 0, 0, 0);
  t.m = 0.0f;
  const int C = G * cg;
  if (lane <= 31 / nchunk + 1 && my < n_taps) {
    const int p = my / GKK;
    const int gk = my - p * GKK;
    const int g = gk / KK;
    const int k = gk - g * KK;
    const int ky = k / K;
    const int b = p / (Ho * Wo);
    const int hw = p - b * (Ho * Wo);
    const int ho = hw / Wo;
    const int wo = hw - ho * Wo;
    const float2 o = load2(off + p * off_row + 2 * gk);
    // sample_positions' order: (base + tap) first, exact in float, then
    // the offset
    const float py = ((float)(ho * stride - pad) + (float)(ky * dil)) + o.x;
    const float px =
        ((float)(wo * stride - pad) + (float)((k - ky * K) * dil)) + o.y;
    const float y0 = floorf(py);
    const float x0 = floorf(px);
    const float ly = py - y0;
    const float lx = px - x0;
    const float fh = (float)(H - 1);
    const float fw = (float)(W - 1);
    // validity in float: huge or non-finite positions never reach an int
    const bool vy0 = y0 >= 0.0f && y0 <= fh;
    const bool vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= fh;
    const bool vx0 = x0 >= 0.0f && x0 <= fw;
    const bool vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= fw;
    const int iy0 = vy0 ? (int)y0 : 0;
    const int iy1 = vy1 ? (int)y0 + 1 : 0;
    const int ix0 = vx0 ? (int)x0 : 0;
    const int ix1 = vx1 ? (int)x0 + 1 : 0;
    const int base = b * H * W * C + g * cg;
    t.w.x = (vy0 && vx0) ? (1.0f - ly) * (1.0f - lx) : 0.0f;
    t.w.y = (vy0 && vx1) ? (1.0f - ly) * lx : 0.0f;
    t.w.z = (vy1 && vx0) ? ly * (1.0f - lx) : 0.0f;
    t.w.w = (vy1 && vx1) ? ly * lx : 0.0f;
    t.i.x = base + ((vy0 && vx0) ? (iy0 * W + ix0) * C : 0);
    t.i.y = base + ((vy0 && vx1) ? (iy0 * W + ix1) * C : 0);
    t.i.z = base + ((vy1 && vx0) ? (iy1 * W + ix0) * C : 0);
    t.i.w = base + ((vy1 && vx1) ? (iy1 * W + ix1) * C : 0);
    t.m = load1(msk + p * mask_row + gk);
  }
  // this item's tap, from the lane that computed it (every lane takes part)
  const int e = j / nchunk;
  const int src = e - tap0;
  const unsigned all = 0xffffffffu;
  const float4 w = make_float4(
      __shfl_sync(all, t.w.x, src), __shfl_sync(all, t.w.y, src),
      __shfl_sync(all, t.w.z, src), __shfl_sync(all, t.w.w, src));
  const int i0 = __shfl_sync(all, t.i.x, src);
  const int i1 = __shfl_sync(all, t.i.y, src);
  const int i2 = __shfl_sync(all, t.i.z, src);
  const int i3 = __shfl_sync(all, t.i.w, src);
  const float m = __shfl_sync(all, t.m, src);
  if (j >= n_items) return;
  const int c = (j - e * nchunk) * VEC;
  float a[VEC], bb[VEC], cc[VEC], d[VEC], v[VEC];
  Run<E, VEC>::load(x + i0 + c, a);
  Run<E, VEC>::load(x + i1 + c, bb);
  Run<E, VEC>::load(x + i2 + c, cc);
  Run<E, VEC>::load(x + i3 + c, d);
  // the plain version's order: the four weighted corners summed in turn,
  // then the mask
#pragma unroll
  for (int n = 0; n < VEC; ++n)
    v[n] = (((a[n] * w.x + bb[n] * w.y) + cc[n] * w.z) + d[n] * w.w) * m;
  Run<E, VEC>::store(cols + j * VEC, v);
}

template <typename E, int VEC, int KT, int NCT>
void launch(const void* x, const void* off, const void* mask, void* cols,
            int H, int W, int Ho, int Wo, int G, int cg, int K, int stride,
            int pad, int dil, int off_row, int mask_row, int npix,
            cudaStream_t s) {
  const int blocks = (npix * G * K * K * (cg / VEC) + THREADS - 1) / THREADS;
  dcn_im2col_kernel<E, VEC, KT, NCT><<<blocks, THREADS, 0, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(off),
      static_cast<const E*>(mask), static_cast<E*>(cols), H, W, Ho, Wo, G,
      cg, K, stride, pad, dil, off_row, mask_row, npix);
}

}  // namespace

// elem: 0 float32, 1 bfloat16 (every tensor).
extern "C" int dcn_im2col_forward(const void* x, const void* off,
                                  const void* mask, void* cols, int B, int H,
                                  int W, int Ho, int Wo, int G, int cg, int K,
                                  int stride, int pad, int dil, int off_row,
                                  int mask_row, int elem, void* stream) {
  const int npix = B * Ho * Wo;
  if (npix == 0) return (int)cudaGetLastError();
  const bool aligned =
      ((unsigned long long)x | (unsigned long long)cols) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define DCN_LAUNCH(E, VEC, KT, NCT)                                        \
  launch<E, VEC, KT, NCT>(x, off, mask, cols, H, W, Ho, Wo, G, cg, K,      \
                          stride, pad, dil, off_row, mask_row, npix, s)
  if (elem == 0) {
    const bool vec = cg % 4 == 0 && aligned;
    if (vec && K == 3 && cg == 8) DCN_LAUNCH(float, 4, 3, 2);
    else if (vec) DCN_LAUNCH(float, 4, 0, 0);
    else DCN_LAUNCH(float, 1, 0, 0);
  } else if (elem == 1) {
    const bool vec = cg % 8 == 0 && aligned;
    if (vec && K == 3 && cg == 8) DCN_LAUNCH(bf16, 8, 3, 1);
    else if (vec) DCN_LAUNCH(bf16, 8, 0, 0);
    else DCN_LAUNCH(bf16, 1, 0, 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DCN_LAUNCH
  return (int)cudaGetLastError();
}
