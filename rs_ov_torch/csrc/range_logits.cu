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
// store bounds it at about 1.5 us. At these small sizes what stands in the way
// is having too few blocks and serial FMA chains, which the design attacks.
//
// Design: one block per (b, tap row u, 8 x 32 tile of output pixels), so a
// stage launches B * d times more blocks than it has tiles (308 at H=W=56)
// and fills the SMs. The block stages the rows it reads, h0+u .. h0+u+7 of
// the padded projection over the tile's 32+d-1 columns, all K channels, in
// shared memory (K * 8 * (32+d-1) floats: 43 KB at K=32, d=11). Each thread
// keeps its own pixel's K projection values in registers and accumulates 8
// taps of its row at once (8 independent FMA chains), walking the channels
// in order; the store is tap-major, so a warp writes 32 consecutive floats.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;   // tile width (threads along w)
constexpr int TH = 8;    // tile height
constexpr int VB = 8;    // taps accumulated at once
constexpr int KMAX = 32; // projection channels held in registers

__global__ void range_logits_kernel(const float* __restrict__ padded,
                                    const float* __restrict__ proj,
                                    float* __restrict__ out,
                                    int K, int H, int W, int d) {
  extern __shared__ float win[];  // [K][TH][TW+d-1], then VB floats of slack
  const int b = blockIdx.z / d, u = blockIdx.z % d;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int Hp = H + d - 1, Wp = W + d - 1;
  const int ww = TW + d - 1;
  const int tid = threadIdx.y * TW + threadIdx.x;

  const float* pb = padded + (size_t)b * K * Hp * Wp;
  for (int i = tid; i < K * TH * ww; i += TW * TH) {
    const int k = i / (TH * ww);
    const int r = (i / ww) % TH;
    const int c = i % ww;
    const int y = h0 + u + r, x = w0 + c;
    win[i] = (y < Hp && x < Wp) ? pb[((size_t)k * Hp + y) * Wp + x] : 0.f;
  }

  const int h = h0 + threadIdx.y, w = w0 + threadIdx.x;
  const bool valid = h < H && w < W;
  float pc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    pc[k] = (valid && k < K) ? proj[(((size_t)b * K + k) * H + h) * W + w] : 0.f;
  __syncthreads();
  if (!valid) return;

  // taps v0+j >= d read the slack or the next row; their sums are dropped
  const float* base = win + threadIdx.y * ww + threadIdx.x;
  float* ob = out + ((size_t)b * d * d + (size_t)u * d) * H * W + (size_t)h * W + w;
  for (int v0 = 0; v0 < d; v0 += VB) {
    float acc[VB];
#pragma unroll
    for (int j = 0; j < VB; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float* src = base + k * TH * ww + v0;
#pragma unroll
        for (int j = 0; j < VB; ++j) acc[j] = fmaf(src[j], pc[k], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < VB; ++j)
      if (v0 + j < d) ob[(size_t)(v0 + j) * H * W] = acc[j];
  }
}

}  // namespace

extern "C" int rs_range_logits(const float* padded, const float* proj, float* out,
                               int B, int K, int H, int W, int d,
                               cudaStream_t stream) {
  const size_t smem = ((size_t)K * TH * (TW + d - 1) + VB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      range_logits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * d);
  range_logits_kernel<<<grid, dim3(TW, TH), smem, stream>>>(padded, proj, out, K, H, W, d);
  return (int)cudaGetLastError();
}

extern "C" const char* rs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
