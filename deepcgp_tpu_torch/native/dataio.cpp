// Native host-side data path of the PyTorch port (deepcgp_tpu_torch), the
// port's own copy of the JAX package's deepcgp_tpu/native/dataio.cpp.
//
// The card runs the model; what runs on the host around it -- dataset
// standardisation, row gathers, patch extraction and the random patch
// sampling of the inducing-point initialisation -- lives here as a small C++
// core behind a C ABI, bound from Python with ctypes
// (deepcgp_tpu_torch/native/__init__.py, which builds it with
// g++ -O3 -march=native at first use).
//
// It replaces the host work the reference delegates to sklearn/numpy
// (StandardScaler at conv_gp/mnist.py:40-45, random patch sampling at
// conv_gp/kernels.py:139-159).  Every function is shape-checked on the
// Python side and writes into caller-allocated buffers (no allocation, no
// state, thread-safe).  The squared deviations of the scaler's fit
// accumulate through std::fma, the instruction g++ -O3 -march=native
// contracts the JAX package's `stddev += c * c` into on a card's host, so
// the two libraries give the same bits there and the result does not hang
// on the compiler's choice to contract.

#include <cstdint>
#include <cmath>

extern "C" {

// Per-column mean / population std of in [n, d] (float64 accumulate, the
// same numerics as the reference's sklearn StandardScaler fit).
void dcgp_fit_scaler_f64(const double* in, int64_t n, int64_t d,
                         double* mean, double* stddev) {
  for (int64_t j = 0; j < d; ++j) { mean[j] = 0.0; stddev[j] = 0.0; }
  for (int64_t i = 0; i < n; ++i) {
    const double* row = in + i * d;
    for (int64_t j = 0; j < d; ++j) mean[j] += row[j];
  }
  for (int64_t j = 0; j < d; ++j) mean[j] /= (double)n;
  for (int64_t i = 0; i < n; ++i) {
    const double* row = in + i * d;
    for (int64_t j = 0; j < d; ++j) {
      const double c = row[j] - mean[j];
      stddev[j] = std::fma(c, c, stddev[j]);
    }
  }
  for (int64_t j = 0; j < d; ++j) {
    stddev[j] = std::sqrt(stddev[j] / (double)n);
    if (stddev[j] == 0.0) stddev[j] = 1.0;  // constant features pass through
  }
}

// out[i, j] = (in[i, j] - mean[j]) / stddev[j]
void dcgp_standardize_f32(const float* in, const float* mean,
                          const float* stddev, float* out,
                          int64_t n, int64_t d) {
  for (int64_t i = 0; i < n; ++i) {
    const float* row = in + i * d;
    float* orow = out + i * d;
    for (int64_t j = 0; j < d; ++j) orow[j] = (row[j] - mean[j]) / stddev[j];
  }
}

// out[k, :] = in[idx[k], :]
void dcgp_gather_rows_f32(const float* in, const int64_t* idx, float* out,
                          int64_t k, int64_t d) {
  for (int64_t i = 0; i < k; ++i) {
    const float* src = in + idx[i] * d;
    float* dst = out + i * d;
    for (int64_t j = 0; j < d; ++j) dst[j] = src[j];
  }
}

// im2col over NHWC images: out [n, P, f*f*c] with P the row-major count of
// valid (stride-strided) patch positions — the host twin of the device
// extraction (deepcgp_tpu_torch/ops/patches.py).
void dcgp_extract_patches_f32(const float* in, int64_t n, int64_t h,
                              int64_t w, int64_t c, int64_t f,
                              int64_t stride, float* out) {
  const int64_t ph = (h - f) / stride + 1;
  const int64_t pw = (w - f) / stride + 1;
  const int64_t patch_len = f * f * c;
  for (int64_t i = 0; i < n; ++i) {
    const float* img = in + i * h * w * c;
    float* obase = out + i * ph * pw * patch_len;
    for (int64_t py = 0; py < ph; ++py) {
      for (int64_t px = 0; px < pw; ++px) {
        float* dst = obase + (py * pw + px) * patch_len;
        const int64_t y0 = py * stride, x0 = px * stride;
        for (int64_t fy = 0; fy < f; ++fy) {
          const float* src = img + ((y0 + fy) * w + x0) * c;
          for (int64_t t = 0; t < f * c; ++t) dst[fy * f * c + t] = src[t];
        }
      }
    }
  }
}

// Random-offset patch gather: out[k] = in[img[k]][ys[k]:ys[k]+f,
// xs[k]:xs[k]+f, :] flattened — inducing-point init sampling.
void dcgp_sample_patches_f32(const float* in, int64_t n, int64_t h,
                             int64_t w, int64_t c, int64_t f,
                             const int32_t* img, const int32_t* ys,
                             const int32_t* xs, float* out, int64_t count) {
  (void)n;
  const int64_t patch_len = f * f * c;
  for (int64_t k = 0; k < count; ++k) {
    const float* base = in + (int64_t)img[k] * h * w * c;
    float* dst = out + k * patch_len;
    for (int64_t fy = 0; fy < f; ++fy) {
      const float* src = base + (((int64_t)ys[k] + fy) * w + xs[k]) * c;
      for (int64_t t = 0; t < f * c; ++t) dst[fy * f * c + t] = src[t];
    }
  }
}

}  // extern "C"
