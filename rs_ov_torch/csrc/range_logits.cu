// JBU range-kernel logits on Hopper (sm_90a).
//
//   logits[b, u*d+v, h, w] = sum_k padded[b, k, h+u, w+v] * proj[b, k, h, w]
//
// Replaces the TPU kernel rs_ov/kernels/range_logits.py:range_logits_pallas.
//
// What bounds it on the H100: bytes, and before that latency. At the
// main-path shapes (B=2, K=32, d=11, H=W=56) it reads 2*32*(66*66+56*56)*4 B
// = 1.9 MB and writes 2*121*56*56*4 B = 3.0 MB, for 24 M multiply-adds:
// about 5 FLOP per byte, far below the card's ~20 FLOP/B fp32 balance, so the
// store bounds it at about 1.5 us (0.4 us at 28^2). The tensor cores do not
// help; what stands in the way is latency: the earlier kernel staged its
// window with dependent scalar loads (three divisions an element) for each
// of the d tap rows again, and computed taps in groups of 8 (16 for 11).
//
// Design: a block takes one image b, a tile of TH x TW output pixels and a
// group of UG tap rows u, one thread a (pixel, u): 128 threads, and 168
// blocks at 28^2 (672 at 56^2) for d = 11, B = 2. It stages the padded
// projection's rows h0+u0 .. h0+u0+TH+UG-2 over the tile's TW+d-1 columns,
// all K channels, once for its UG tap rows, by cp.async: a warp copies one
// (channel, row) segment, 16 bytes a lane where the row's alignment allows
// and 4 at its ends (each row is placed in shared memory at its own
// misalignment, so that the 16-byte copies line up), with no division per
// element. The channels go in four cp.async groups of 8, so the first
// multiply-adds start when the first 8 channels have landed. Each thread
// holds its pixel's K projection values in registers and exactly d
// accumulators (the kernel is instantiated for each d up to DMAX), walks
// the channels in order and stores its d taps coalesced along w.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace rs_ov;

constexpr int TW = 32;          // tile width (lanes along w)
constexpr int TH = 2;           // tile height
constexpr int UG = 2;           // tap rows a block serves
constexpr int R = TH + UG - 1;  // window rows a block stages
constexpr int KC = 8;           // channels per cp.async group
constexpr int KMAX = 32;        // projection channels held in registers
constexpr int DMAX = 25;        // the largest diameter instantiated

// floats of a staged window row: TW + d - 1 columns at an offset of up to 3
__host__ __device__ constexpr int row_floats(int d) { return (TW + d - 1 + 3 + 3) / 4 * 4; }

template <int D>
__global__ void __launch_bounds__(TW * TH * UG)
range_logits_kernel(const float* __restrict__ padded, const float* __restrict__ proj,
                    float* __restrict__ out, int K, int H, int W) {
  extern __shared__ __align__(16) float win[];  // [K][R][SW]
  constexpr int SW = row_floats(D), GROUPS = (D + UG - 1) / UG, NWARP = TH * UG;
  const int b = blockIdx.z / GROUPS, u0 = blockIdx.z % GROUPS * UG;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int Hp = H + D - 1, Wp = W + D - 1;
  const int lane = threadIdx.x, warp = threadIdx.y + TH * threadIdx.z;
  const float* pb = padded + (size_t)b * K * Hp * Wp;

  // the window, a warp per (channel, row) segment of the columns that exist
  const int n = min(TW + D - 1, Wp - w0);
#pragma unroll
  for (int c = 0; c < KMAX / KC; ++c) {
    for (int s = warp; s < KC * R; s += NWARP) {
      const int k = c * KC + s / R, r = s % R, y = h0 + u0 + r;
      if (k < K && y < Hp) {
        const float* src = pb + ((size_t)k * Hp + y) * Wp + w0;
        const int m = (int)(reinterpret_cast<uintptr_t>(src) / 4 % 4);
        float* dst = win + (k * R + r) * SW + m;
        const int head = min(n, (4 - m) % 4), body = (n - head) / 4;
        const int tail = head + 4 * body;
        if (lane < body) cp_async16(dst + head + 4 * lane, src + head + 4 * lane, 16);
        if (lane < head) cp_async4(dst + lane, src + lane, 4);
        if (tail + lane < n) cp_async4(dst + tail + lane, src + tail + lane, 4);
      }
    }
    cp_async_commit();
  }

  const int h = h0 + threadIdx.y, w = w0 + lane, u = u0 + threadIdx.z;
  const bool pixel = h < H && w < W;
  float pc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    pc[k] = (pixel && k < K) ? proj[(((size_t)b * K + k) * H + h) * W + w] : 0.f;

  // the thread's window row, and where channel k's copy of it starts: each
  // channel's row lies Hp * Wp floats past the last one's in device memory
  const int r = threadIdx.y + threadIdx.z;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(pb + (size_t)(h0 + u0 + r) * Wp + w0) / 4;
  const int plane = (int)((size_t)Hp * Wp % 4);
  float acc[D];
#pragma unroll
  for (int v = 0; v < D; ++v) acc[v] = 0.f;
#pragma unroll
  for (int c = 0; c < KMAX / KC; ++c) {
    if (c == 0) cp_async_wait<3>();
    else if (c == 1) cp_async_wait<2>();
    else if (c == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int k = c * KC + j;
      if (k < K) {
        const int m = (int)((a0 + (uintptr_t)k * plane) % 4);
        const float* row = win + (k * R + r) * SW + m + lane;
#pragma unroll
        for (int v = 0; v < D; ++v) acc[v] = fmaf(row[v], pc[k], acc[v]);
      }
    }
  }
  if (!pixel || u >= D) return;
  float* ob = out + (((size_t)b * D + u) * D * H + h) * W + w;
#pragma unroll
  for (int v = 0; v < D; ++v) ob[(size_t)v * H * W] = acc[v];
}

template <int D>
int launch(const float* padded, const float* proj, float* out, int B, int K, int H, int W,
           int d, cudaStream_t stream) {
  if constexpr (D > DMAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (d != D) return launch<D + 1>(padded, proj, out, B, K, H, W, d, stream);
    const size_t smem = (size_t)K * R * row_floats(D) * sizeof(float);  // < 48 KB
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * ((D + UG - 1) / UG));
    range_logits_kernel<D><<<grid, dim3(TW, TH, UG), smem, stream>>>(padded, proj, out, K, H, W);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// padded [B, K, H+d-1, W+d-1], proj [B, K, H, W] fp32 -> out [B, d*d, H, W];
// 1 <= K <= 32, 1 <= d <= 25, else cudaErrorInvalidValue.
extern "C" int rs_range_logits(const float* padded, const float* proj, float* out,
                               int B, int K, int H, int W, int d,
                               cudaStream_t stream) {
  if (K < 1 || K > KMAX || d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  return launch<1>(padded, proj, out, B, K, H, W, d, stream);
}

extern "C" const char* rs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
