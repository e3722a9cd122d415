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
// Layout (float32):
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
// loads when cg % 4 == 0; x stays in L2) and writes VEC columns. No shared
// memory and no barrier: at the PCD's L3 (896 pixels) the kernel is a few
// microseconds of latency, and a form that staged the taps in shared
// memory behind a barrier was slower there and at L1 on the H100.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Tap {
  float4 w;  // hat weights of corners (y0, x0), (y0, x1), (y1, x0), (y1, x1)
  int4 i;    // x offset of each corner's channel run for this group (the
             // batch's image start plus the group's channels where the
             // corner is outside the image: read there with weight 0)
  float m;   // the mask
};

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float4 load(const float* p, float4*) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float load(const float* p, float*) {
  return __ldg(p);
}

__device__ __forceinline__ float4 combine(float4 a, float4 b, float4 c,
                                          float4 d, float4 w, float m) {
  // the plain version's order: the four weighted corners summed in turn,
  // then the mask
  float4 v;
  v.x = (((a.x * w.x + b.x * w.y) + c.x * w.z) + d.x * w.w) * m;
  v.y = (((a.y * w.x + b.y * w.y) + c.y * w.z) + d.y * w.w) * m;
  v.z = (((a.z * w.x + b.z * w.y) + c.z * w.z) + d.z * w.w) * m;
  v.w = (((a.w * w.x + b.w * w.y) + c.w * w.z) + d.w * w.w) * m;
  return v;
}
__device__ __forceinline__ float combine(float a, float b, float c, float d,
                                         float4 w, float m) {
  return (((a * w.x + b * w.y) + c * w.z) + d * w.w) * m;
}

// All indices are 32-bit: the wrapper refuses x or columns of 2**31
// elements or more. KT and NCT are K and cg / VEC where they are known at
// compile time (3 and 2: every DCN of the model), else 0; the divisions
// by them then cost a multiply.
template <int VEC, int KT, int NCT>
__global__ void __launch_bounds__(THREADS)
    dcn_im2col_kernel(const float* __restrict__ x,
                      const float* __restrict__ off,
                      const float* __restrict__ msk, float* __restrict__ cols,
                      int H, int W, int Ho, int Wo, int G, int cg, int k_any,
                      int stride, int pad, int dil, int off_row, int mask_row,
                      int npix) {
  using V = typename Vec<VEC>::T;
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
    const float2 o =
        *reinterpret_cast<const float2*>(off + p * off_row + 2 * gk);
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
    t.m = msk[p * mask_row + gk];
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
  const V a = load(x + i0 + c, (V*)nullptr);
  const V bb = load(x + i1 + c, (V*)nullptr);
  const V cc = load(x + i2 + c, (V*)nullptr);
  const V d = load(x + i3 + c, (V*)nullptr);
  *reinterpret_cast<V*>(cols + j * VEC) = combine(a, bb, cc, d, w, m);
}

}  // namespace

extern "C" int dcn_im2col_forward(const float* x, const float* off,
                                  const float* mask, float* cols, int B,
                                  int H, int W, int Ho, int Wo, int G, int cg,
                                  int K, int stride, int pad, int dil,
                                  int off_row, int mask_row, void* stream) {
  const int npix = B * Ho * Wo;
  if (npix == 0) return (int)cudaGetLastError();
  const bool aligned =
      ((unsigned long long)x | (unsigned long long)cols) % 16 == 0;
  const int vec = cg % 4 == 0 && aligned ? 4 : 1;
  const int blocks = (npix * G * K * K * (cg / vec) + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4 && K == 3 && cg == 8) {
    dcn_im2col_kernel<4, 3, 2><<<blocks, THREADS, 0, s>>>(
        x, off, mask, cols, H, W, Ho, Wo, G, cg, K, stride, pad, dil,
        off_row, mask_row, npix);
  } else if (vec == 4) {
    dcn_im2col_kernel<4, 0, 0><<<blocks, THREADS, 0, s>>>(
        x, off, mask, cols, H, W, Ho, Wo, G, cg, K, stride, pad, dil,
        off_row, mask_row, npix);
  } else {
    dcn_im2col_kernel<1, 0, 0><<<blocks, THREADS, 0, s>>>(
        x, off, mask, cols, H, W, Ho, Wo, G, cg, K, stride, pad, dil,
        off_row, mask_row, npix);
  }
  return (int)cudaGetLastError();
}
