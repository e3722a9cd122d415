// splat_fused: forward softmax splat fused with the norm and count splats,
// plus the ones-initialised max splat of e^z.
//
// Replaces the TPU kernel motif_tpu/ops/softsplat_pallas.py::_splat_kernel
// (the ring-sweep MXU placement behind splat_fused_pallas) and, for the
// max, motif_tpu/ops/softsplat.py::_splat_max_scan. Same contract as
// motif_tpu/ops/softsplat.py::splat_fused: each source pixel p lands at
// q = p + flow(p) and bilinearly scatters [img * e^z | e^z] into q's four
// integer corners, plus an unweighted +1 per in-image corner (the count).
// Corners outside the image are dropped, as the reference CUDA kernel
// drops them (softsplat_cp.py:30-38).
//
// Layout (NHWC, float32, contiguous):
//   img  (B, H, W, C)   flow (B, H, W, 2) = (dx, dy)   ez (B, H, W)
//   acc  (B, H, W, C + 2), zero-filled by the caller: channels [0, C) the
//        splatted img * e^z, C the norm (splatted e^z), C + 1 the count.
//   zmax (B, H, W), filled with 1.0 by the caller.
//
// Bound on an H100: memory. Each pixel reads C + 3 floats and adds into
// 4 (C + 2) floats with ~2 flops per add, far below the card's 67 TFLOP/s
// fp32 rate. Design: one warp per source pixel; lane l takes channels
// l, l + 32, ... (the channel chunk), so the warp's loads of img and its
// atomicAdds into one corner row are consecutive addresses and coalesce.
// The corner weights are recomputed per lane instead of shared, which
// costs a few flops and no memory traffic. The summation order of the
// atomics varies from run to run, so results match the plain version to
// rounding, not bit for bit; the count is exact.
//
// The max uses atomicMax on the int bit pattern: e^z * w >= 0, and the
// order of non-negative IEEE floats is the order of their bit patterns.

#include <cuda_runtime.h>

namespace {

struct Corners {
  int iy0, ix0;
  bool vy0, vy1, vx0, vx1;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(const float* __restrict__ flow,
                                           long long p, int x, int y, int H,
                                           int W) {
  Corners c;
  const float fx = (float)x + flow[2 * p];
  const float fy = (float)y + flow[2 * p + 1];
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx1 = fx - x0;
  const float wy1 = fy - y0;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  // validity is decided in float so that huge or non-finite targets never
  // reach an int conversion
  c.vx0 = x0 >= 0.0f && x0 <= (float)(W - 1);
  c.vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
  c.vy0 = y0 >= 0.0f && y0 <= (float)(H - 1);
  c.vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
  c.ix0 = (c.vx0 || c.vx1) ? (int)x0 : 0;
  c.iy0 = (c.vy0 || c.vy1) ? (int)y0 : 0;
  c.w00 = wy0 * wx0;
  c.w01 = wy0 * wx1;
  c.w10 = wy1 * wx0;
  c.w11 = wy1 * wx1;
  return c;
}

__global__ void splat_sum_kernel(const float* __restrict__ img,
                                 const float* __restrict__ flow,
                                 const float* __restrict__ ez,
                                 float* __restrict__ acc, int H, int W, int C,
                                 long long n_pix) {
  const long long p =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= n_pix) return;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long b = p / ((long long)H * W);
  const Corners c = corners(flow, p, x, y, H, W);
  const float e = ez[p];
  const int CP = C + 2;
  float* const base = acc + b * H * W * (long long)CP;
  const long long q00 = ((long long)c.iy0 * W + c.ix0) * CP;
  const long long q01 = q00 + CP;
  const long long q10 = q00 + (long long)W * CP;
  const long long q11 = q10 + CP;
  for (int ch = lane; ch < CP; ch += 32) {
    const bool count = ch == C + 1;
    const float v = ch < C ? img[p * C + ch] * e : (ch == C ? e : 1.0f);
    if (c.vy0 && c.vx0) atomicAdd(base + q00 + ch, count ? 1.0f : v * c.w00);
    if (c.vy0 && c.vx1) atomicAdd(base + q01 + ch, count ? 1.0f : v * c.w01);
    if (c.vy1 && c.vx0) atomicAdd(base + q10 + ch, count ? 1.0f : v * c.w10);
    if (c.vy1 && c.vx1) atomicAdd(base + q11 + ch, count ? 1.0f : v * c.w11);
  }
}

__device__ __forceinline__ void atomic_max_nonneg(float* addr, float v) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__global__ void splat_max_kernel(const float* __restrict__ flow,
                                 const float* __restrict__ ez,
                                 float* __restrict__ zmax, int H, int W,
                                 long long n_pix) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const long long b = p / ((long long)H * W);
  const Corners c = corners(flow, p, x, y, H, W);
  const float e = ez[p];
  float* const base = zmax + b * H * (long long)W;
  const long long q00 = (long long)c.iy0 * W + c.ix0;
  if (c.vy0 && c.vx0) atomic_max_nonneg(base + q00, e * c.w00);
  if (c.vy0 && c.vx1) atomic_max_nonneg(base + q00 + 1, e * c.w01);
  if (c.vy1 && c.vx0) atomic_max_nonneg(base + q00 + W, e * c.w10);
  if (c.vy1 && c.vx1) atomic_max_nonneg(base + q00 + W + 1, e * c.w11);
}

}  // namespace

extern "C" int splat_fused_forward(const float* img, const float* flow,
                                   const float* ez, float* acc, int B, int H,
                                   int W, int C, void* stream) {
  const long long n_pix = (long long)B * H * W;
  if (n_pix > 0) {
    const int threads = 256;
    const long long blocks = (n_pix * 32 + threads - 1) / threads;
    splat_sum_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(img, flow, ez, acc, H, W, C,
                                               n_pix);
  }
  return (int)cudaGetLastError();
}

extern "C" int splat_max_forward(const float* flow, const float* ez,
                                 float* zmax, int B, int H, int W,
                                 void* stream) {
  const long long n_pix = (long long)B * H * W;
  if (n_pix > 0) {
    const int threads = 256;
    const long long blocks = (n_pix + threads - 1) / threads;
    splat_max_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(flow, ez, zmax, H, W, n_pix);
  }
  return (int)cudaGetLastError();
}
