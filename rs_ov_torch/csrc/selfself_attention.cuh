// The row-softmax pieces shared by the two fused self-self attention kernels
// (K6): selfself_attention_sm90.cu (bf16 operands) and
// selfself_attention_f32_sm90.cu (fp32 operands). Both hold a warp's 16 query
// rows' scores for every key in the m16n8 accumulators of mma.sync: element
// e of n8 tile n is the warp's row g + 8 (e / 2), key 8 n + 2 tq + e % 2
// (g = lane / 4, tq = lane % 4), so a row lives in a quad of 4 lanes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace rs_ov {

enum AttentionMode { VANILLA = 0, CLEARCLIP = 1, SCLIP = 2, SEGEARTH = 3, SFP = 4,
                     EXPERIMENTAL = 5 };

__host__ __device__ inline int n_operands(int mode) { return mode == CLEARCLIP ? 2 : 3; }

// Floats of a warp's slice of the staged sim rows (4 more for alignment).
__host__ __device__ inline int sim_slice(int L) { return 16 * L + 4; }

template <int N>
__device__ __forceinline__ void zero(float (&s)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
}

// s = s * mul + S (S where sim, the warp's first sim row with rows of L, is
// given; rows of them), keys past L -inf.
template <int N>
__device__ __forceinline__ void logits(float (&s)[N][4], float mul, const float* sim, float w,
                                       int rows, int L, int g, int tq) {
  if (sim != nullptr) {  // the staged rows have landed (stage_sim)
    cp_async_wait<0>();
    __syncwarp();
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), key = 8 * n + 2 * tq + (e & 1);
      float x = s[n][e] * mul;
      if (sim != nullptr && row < rows && key < L) x += sim[row * L + key] * w;
      s[n][e] = key < L ? x : -INFINITY;
    }
}

// The n floats of the warp's sim rows (contiguous in device memory) into its
// slice dst (16-byte aligned) by cp.async, shifted by src's misalignment so
// that the copies are 16 bytes wide; returns where they start. Commits one
// group; logits waits for it.
__device__ __forceinline__ const float* stage_sim(float* dst, const float* src, int n,
                                                  int lane) {
  const int k = (int)(reinterpret_cast<uintptr_t>(src) / 4 % 4);
  float* d = dst + k;
  const int head = min(n, (4 - k) % 4), end = head + (n - head) / 4 * 4;
  for (int i = lane; i < head; i += 32) cp_async4(d + i, src + i, 4);
  for (int i = head + 4 * lane; i < end; i += 128) cp_async16(d + i, src + i, 16);
  for (int i = end + lane; i < n; i += 32) cp_async4(d + i, src + i, 4);
  cp_async_commit();
  return d;
}

// Each of the lane's two rows (e < 2: row g; e >= 2: row g + 8) softmaxed
// in place over the quad's keys, times the reciprocal of the row's sum (one
// division a row, not one a weight); -inf becomes 0.
template <int N>
__device__ __forceinline__ void softmax_rows(float (&s)[N][4]) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __expf(s[n][e] - m[e >> 1]);
      s[n][e] = x;
      l[e >> 1] += x;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] = 1.f / (l[r] + __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= l[e >> 1];
}

}  // namespace rs_ov
