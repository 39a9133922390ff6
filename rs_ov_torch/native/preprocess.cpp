// Native host-side normalisation for the eval data path (a copy of the JAX
// package's): uint8 or fp32 HWC RGB -> mean/std-normalised CHW fp32, one
// OpenMP thread per row block. Built with g++ -O3 -fopenmp by
// rs_ov_torch/native, bound via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// dst[c][y][x] = (src[y][x][c] - mean[c]) * inv_std[c]
void normalize_hwc_to_chw(const uint8_t* src, float* dst,
                          int64_t h, int64_t w,
                          const float* mean, const float* inv_std) {
  const int64_t plane = h * w;
#pragma omp parallel for schedule(static)
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = src + y * w * 3;
    float* d0 = dst + 0 * plane + y * w;
    float* d1 = dst + 1 * plane + y * w;
    float* d2 = dst + 2 * plane + y * w;
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float s0 = inv_std[0], s1 = inv_std[1], s2 = inv_std[2];
    for (int64_t x = 0; x < w; ++x) {
      d0[x] = (static_cast<float>(row[3 * x + 0]) - m0) * s0;
      d1[x] = (static_cast<float>(row[3 * x + 1]) - m1) * s1;
      d2[x] = (static_cast<float>(row[3 * x + 2]) - m2) * s2;
    }
  }
}

// float32 variant (already-decoded float HWC images)
void normalize_hwc_to_chw_f32(const float* src, float* dst,
                              int64_t h, int64_t w,
                              const float* mean, const float* inv_std) {
  const int64_t plane = h * w;
#pragma omp parallel for schedule(static)
  for (int64_t y = 0; y < h; ++y) {
    const float* row = src + y * w * 3;
    float* d0 = dst + 0 * plane + y * w;
    float* d1 = dst + 1 * plane + y * w;
    float* d2 = dst + 2 * plane + y * w;
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float s0 = inv_std[0], s1 = inv_std[1], s2 = inv_std[2];
    for (int64_t x = 0; x < w; ++x) {
      d0[x] = (row[3 * x + 0] - m0) * s0;
      d1[x] = (row[3 * x + 1] - m1) * s1;
      d2[x] = (row[3 * x + 2] - m2) * s2;
    }
  }
}

}  // extern "C"
