// Native host-side preprocessing core of the motif_tpu_torch data pipeline,
// the port's own copy of motif_tpu/native/preprocess.cpp (the same code, so
// the same results bit for bit from the same compiler and flags):
// MATLAB-equivalent antialiased bicubic resizing (the per-batch LR synthesis
// of the arbitrary-scale collate, reference data/__init__.py:113,192 — the
// heaviest host compute), uint8 -> float conversion with the BGR -> RGB
// flip, and batch Y-channel PSNR. OpenMP-parallel across rows / frames.
//
// A plain C ABI for ctypes. Built at first use by motif_tpu_torch/native
// (g++ -O3 -fPIC -shared -std=c++17 -fopenmp) into build/native/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// MATLAB bicubic kernel (a = -0.5), reference data/util.py:261-268.
inline double cubic(double x) {
  double ax = std::fabs(x);
  double ax2 = ax * ax, ax3 = ax2 * ax;
  if (ax <= 1.0) return 1.5 * ax3 - 2.5 * ax2 + 1.0;
  if (ax <= 2.0) return -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0;
  return 0.0;
}

// Dense (out, in) MATLAB-imresize matrix with symmetric padding folded in —
// identical math to motif_tpu_torch/ops/resize.py matlab_resize_matrix.
void resize_matrix(int in_size, int out_size, double scale, bool antialias,
                   std::vector<float>& m) {
  double kw = 4.0;
  if (scale < 1.0 && antialias) kw /= scale;
  int P = static_cast<int>(std::ceil(kw)) + 2;
  m.assign(static_cast<size_t>(out_size) * in_size, 0.0f);
  std::vector<double> w(P);
  for (int i = 0; i < out_size; ++i) {
    double u = (i + 1) / scale + 0.5 * (1.0 - 1.0 / scale);
    double left = std::floor(u - kw / 2.0);
    double wsum = 0.0;
    for (int k = 0; k < P; ++k) {
      double d = u - (left + k);
      w[k] = (scale < 1.0 && antialias) ? scale * cubic(d * scale) : cubic(d);
      wsum += w[k];
    }
    for (int k = 0; k < P; ++k) {
      int j = static_cast<int>(left) + k - 1;  // 0-based source index
      if (j < 0) j = -1 - j;                    // symmetric (mirror) padding
      if (j >= in_size) j = in_size - 1 - (j - in_size);
      if (j < 0) j = 0;
      if (j >= in_size) j = in_size - 1;
      m[static_cast<size_t>(i) * in_size + j] += static_cast<float>(w[k] / wsum);
    }
  }
}

}  // namespace

extern "C" {

// MATLAB-equivalent antialiased bicubic resize of a batch of HWC float32
// images. in: (n, h, w, c) contiguous; out: (n, oh, ow, c) preallocated.
void matlab_resize_batch(const float* in, float* out, int n, int h, int w,
                         int c, int oh, int ow, double scale, int antialias) {
  std::vector<float> mh, mw;
  resize_matrix(h, oh, scale, antialias != 0, mh);
  resize_matrix(w, ow, scale, antialias != 0, mw);

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int img = 0; img < n; ++img) {
    const float* src = in + static_cast<size_t>(img) * h * w * c;
    float* dst = out + static_cast<size_t>(img) * oh * ow * c;
    // rows: tmp (oh, w, c)
    std::vector<float> tmp(static_cast<size_t>(oh) * w * c, 0.0f);
    for (int i = 0; i < oh; ++i) {
      const float* mrow = mh.data() + static_cast<size_t>(i) * h;
      float* trow = tmp.data() + static_cast<size_t>(i) * w * c;
      for (int y = 0; y < h; ++y) {
        float wv = mrow[y];
        if (wv == 0.0f) continue;
        const float* srow = src + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w * c; ++x) trow[x] += wv * srow[x];
      }
    }
    // cols
    for (int i = 0; i < oh; ++i) {
      const float* trow = tmp.data() + static_cast<size_t>(i) * w * c;
      float* drow = dst + static_cast<size_t>(i) * ow * c;
      for (int x = 0; x < ow; ++x) {
        const float* mcol = mw.data() + static_cast<size_t>(x) * w;
        for (int ch = 0; ch < c; ++ch) {
          double acc = 0.0;
          for (int y = 0; y < w; ++y) {
            float wv = mcol[y];
            if (wv != 0.0f) acc += wv * trow[static_cast<size_t>(y) * c + ch];
          }
          drow[static_cast<size_t>(x) * c + ch] = static_cast<float>(acc);
        }
      }
    }
  }
}

// uint8 BGR HWC batch → float32 RGB [0,1] (the decode-side conversion every
// dataset performs, data/util.py:59-83 + [2,1,0] reindex).
void u8bgr_to_f32rgb(const uint8_t* in, float* out, int64_t n_pixels) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t p = 0; p < n_pixels; ++p) {
    const uint8_t* s = in + p * 3;
    float* d = out + p * 3;
    d[0] = s[2] * (1.0f / 255.0f);
    d[1] = s[1] * (1.0f / 255.0f);
    d[2] = s[0] * (1.0f / 255.0f);
  }
}

// Batch Y-channel PSNR (test.py:212-235 semantics): inputs RGB [0,1]
// (n, h, w, 3); writes n per-frame PSNRs (peak 1.0 on Y/255-ish scale).
void y_psnr_batch(const float* a, const float* b, int n, int64_t hw,
                  double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int img = 0; img < n; ++img) {
    const float* pa = a + static_cast<size_t>(img) * hw * 3;
    const float* pb = b + static_cast<size_t>(img) * hw * 3;
    double mse = 0.0;
    for (int64_t p = 0; p < hw; ++p) {
      double ya = (pa[p * 3] * 65.481 + pa[p * 3 + 1] * 128.553 +
                   pa[p * 3 + 2] * 24.966 + 16.0) / 255.0;
      double yb = (pb[p * 3] * 65.481 + pb[p * 3 + 1] * 128.553 +
                   pb[p * 3 + 2] * 24.966 + 16.0) / 255.0;
      double d = ya - yb;
      mse += d * d;
    }
    mse /= static_cast<double>(hw);
    out[img] = mse > 0 ? 10.0 * std::log10(1.0 / mse) : 1e9;
  }
}

int native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
