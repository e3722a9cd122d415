// dcn_sample: bilinear sampling of grouped features at fractional
// positions — the sampling stage of the modulated deformable conv (DCNv2).
//
// Replaces the TPU kernels motif_tpu/ops/dcn_pallas.py::_kernel (one-hot
// MXU contractions per 512-query tile, behind sample_pallas) and
// motif_tpu/ops/dcn_pallas.py::_ywin_kernel (the same contract over a
// per-row y-window, behind sample_pallas_ywin). Unlike the y-window kernel
// this one is exact for every input: it has no window and no precondition.
//
// Layout (float32, contiguous):
//   x   (B, H, W, G * cg)  NHWC features, group g owns channels
//                          [g * cg, (g + 1) * cg)
//   py, px (B, G, Q)       sample row / column in pixels
//   out (B, Q, G, cg)
// out[b, q, g, :] = sum over the 4 integer corners (y, x) around
// (py, px) of hat weight * x[b, y, x, g, :], where each corner outside
// the image contributes zero — the per-corner bounds of the reference
// CUDA im2col (dcn_v2_im2col_cuda.cu), equal to the TPU kernels' hat
// weights that are zero outside [-1, size].
//
// Bound on an H100: memory. Per query and group it reads 2 positions and
// up to 4 * cg features and writes cg, with ~8 flops per output value.
// Design: one thread per (b, g, q) that gathers the cg-wide channel vector
// of each corner. q is the fastest thread index, so the position reads
// coalesce and each thread writes one contiguous cg-float run of the
// output. The four corner rows are contiguous cg-float runs in x, read
// through the read-only cache.

#include <cuda_runtime.h>

namespace {

__global__ void dcn_sample_kernel(const float* __restrict__ x,
                                  const float* __restrict__ py,
                                  const float* __restrict__ px,
                                  float* __restrict__ out, int H, int W,
                                  int G, int cg, long long Q,
                                  long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long q = i % Q;
  const long long bg = i / Q;
  const int g = (int)(bg % G);
  const long long b = bg / G;

  const float yy = py[i];
  const float xx = px[i];
  const float y0 = floorf(yy);
  const float x0 = floorf(xx);
  const float ly = yy - y0;
  const float lx = xx - x0;
  const float w00 = (1.0f - ly) * (1.0f - lx);
  const float w01 = (1.0f - ly) * lx;
  const float w10 = ly * (1.0f - lx);
  const float w11 = ly * lx;
  // validity in float: huge or non-finite positions never reach an int
  const bool vy0 = y0 >= 0.0f && y0 <= (float)(H - 1);
  const bool vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
  const bool vx0 = x0 >= 0.0f && x0 <= (float)(W - 1);
  const bool vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
  const long long iy0 = (vy0 || vy1) ? (long long)y0 : 0;
  const long long ix0 = (vx0 || vx1) ? (long long)x0 : 0;

  const long long C = (long long)G * cg;
  const float* const xb = x + b * H * W * C + (long long)g * cg;
  const float* const r00 = xb + (iy0 * W + ix0) * C;
  const float* const r01 = r00 + C;
  const float* const r10 = r00 + W * C;
  const float* const r11 = r10 + C;
  float* const o = out + ((b * Q + q) * G + g) * cg;
  for (int c = 0; c < cg; ++c) {
    float v = 0.0f;
    if (vy0 && vx0) v += __ldg(r00 + c) * w00;
    if (vy0 && vx1) v += __ldg(r01 + c) * w01;
    if (vy1 && vx0) v += __ldg(r10 + c) * w10;
    if (vy1 && vx1) v += __ldg(r11 + c) * w11;
    o[c] = v;
  }
}

}  // namespace

extern "C" int dcn_sample_forward(const float* x, const float* py,
                                  const float* px, float* out, int B, int H,
                                  int W, int G, int cg, long long Q,
                                  void* stream) {
  const long long total = (long long)B * G * Q;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    dcn_sample_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(x, py, px, out, H, W, G, cg,
                                                Q, total);
  }
  return (int)cudaGetLastError();
}
