// Adaptive (per-pixel) convolution, channel-first, on Hopper (sm_90a):
//
//   out[b, c, h, w] = sum_{u,v} filt[b, u*d+v, h, w] * inp[b, c, h+u, w+v]
//
// inp [B, C, H+d-1, W+d-1], filt [B, d*d, H, W] tap-major, out [B, C, H, W],
// all of one element type T: bf16 (K4a) or fp32 (K4b). Products and sums in
// fp32, one rounding to T at the end; bf16 taps are taken as they come (the
// caller rounds them, as rs_ov/upsample/jbu.py:190 does before the TPU kernel).
//
// Replaces the TPU kernels rs_ov/kernels/adaptive_conv_v5.py:
// adaptive_conv_pallas_v5 (K4a, bf16 banded MXU matmuls) and
// rs_ov/kernels/adaptive_conv_v2.py:adaptive_conv_pallas_v2 (K4b, fp32 VPU
// row streaming). The TPU's band construction and row rolls are lane
// artefacts and are not carried over.
//
// What bounds it on the H100, at the main-path shapes (B=2, C=512, d=11,
// H=W=56): 2*B*C*H*W*d^2 = 777 MFLOP per call. K4b moves 33.7 MB of fp32
// (input 17.8, taps 3.0, output 12.8): 10.1 us at 3.35 TB/s, below the
// 11.6 us its FLOPs take on the fp32 cores at 67 TFLOP/s, so operations
// bound it. K4a moves half the bytes, 16.9 MB: 5.0 us, and its bf16 FLOPs
// would take 0.8 us at the tensor-core rate, so bytes bound it. This first
// version runs on the fp32 cores, reads about 2 bytes of shared memory per
// multiply-add and reads each input row once per output row that needs it
// (d times, through L2); tensor cores and multi-row blocks are later work.
//
// Design: one block of 256 threads per (b, output row h, 64 output columns,
// 64 channels). The block first stages all d*d taps of its 64 pixels in
// shared memory (fp32, taps padded to a multiple of 4 with zeros), then walks
// the d window rows u: input row h+u of its 64 channels, over the 64+d-1
// columns it reads, goes through registers into shared memory (coalesced
// along W, converted to fp32), and the next row's loads are issued before the
// current row is computed, so their latency hides behind the arithmetic; the
// staged rows alternate between two buffers, one barrier per row (73 KB of
// shared memory at d=11; two blocks per SM). Thread (g, k) owns
// pixels 4g..4g+3 and channels k, k+16, k+32, k+48: per group of 4 taps it
// reads the 4 pixels' taps as float4s (shared by its 4 channels) and, per
// channel, the next 4 input values as one float4 (the previous 4 are kept),
// for 64 multiply-adds. Taps are summed in order t = 0..d*d-1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;       // output columns per block
constexpr int CT = 64;       // channels per block
constexpr int NT = 256;      // threads: 16 pixel groups x 16 channel groups
constexpr int P = 4;         // pixels per thread
constexpr int CC = 4;        // channels per thread
constexpr int NG = TW / P;   // pixel groups

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ inline int taps_padded(int d) { return (d + 3) / 4 * 4; }
// staged input row length: the last float4 a thread reads ends at column
// 4*(NG-1) + taps_padded(d) + 3
__host__ __device__ inline int row_len(int d) { return TW + taps_padded(d); }
// all taps of the block's pixels plus two staged input rows: 73 KB at d=11,
// 51 KB at d=7; d <= 25 fits the 227 KB a block may use
inline size_t smem_bytes(int d) {
  return ((size_t)d * taps_padded(d) * TW + 2 * (size_t)CT * row_len(d)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
adaptive_conv_kernel(const T* __restrict__ inp, const T* __restrict__ filt,
                     T* __restrict__ out, int C, int H, int W, int d) {
  extern __shared__ float4 smem4[];
  const int ld = row_len(d), dv = taps_padded(d);
  float* s_f = reinterpret_cast<float*>(smem4);  // [d][dv][TW] taps of the block's pixels
  float* s_in0 = s_f + d * dv * TW;               // [2][CT][ld] input rows, double-buffered

  const int n_ct = (C + CT - 1) / CT;
  const int b = blockIdx.z / n_ct, c0 = (blockIdx.z % n_ct) * CT;
  const int h = blockIdx.y, w0 = blockIdx.x * TW;
  const int Hp = H + d - 1, Wp = W + d - 1;
  const size_t plane_in = (size_t)Hp * Wp, plane_f = (size_t)H * W;
  const int g = threadIdx.x % NG, k = threadIdx.x / NG;      // compute: pixels, channels
  const int sx = threadIdx.x % TW, sr = threadIdx.x / TW;    // staging: column, channel

  // every tap of the block's pixels, once (zeros past W and for v >= d)
  const T* fb = filt + (size_t)b * d * d * plane_f + (size_t)h * W + w0;
#pragma unroll 4
  for (int uv = sr; uv < d * dv; uv += NT / TW) {
    const int u = uv / dv, v = uv % dv;
    s_f[uv * TW + sx] = (v < d && w0 + sx < W) ? to_f32(fb[(size_t)(u * d + v) * plane_f + sx]) : 0.f;
  }

  // input row h+u of the block's channels, held in registers (in T, so that
  // nothing waits on the loads) until stored: the next row's loads are in
  // flight while the current row is computed
  constexpr int RPT = CT / (NT / TW);  // channel rows per staging thread
  T pre[RPT][2];
  const bool col1 = sx + TW < ld;      // the columns past TW (d-1 of them, rounded)
  auto load_row = [&](int u) {
    const T* row = inp + ((size_t)b * C + c0) * plane_in + (size_t)(h + u) * Wp + w0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int cl = sr + (NT / TW) * i;
      const bool cok = c0 + cl < C;
      pre[i][0] = (cok && w0 + sx < Wp) ? row[cl * plane_in + sx] : from_f32<T>(0.f);
      pre[i][1] = (cok && col1 && w0 + sx + TW < Wp) ? row[cl * plane_in + sx + TW]
                                                     : from_f32<T>(0.f);
    }
  };

  float acc[CC][P];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[cc][p] = 0.f;

  load_row(0);
  for (int u = 0; u < d; ++u) {
    // buffer u % 2 was last read two rows ago, before the previous barrier
    float* s_in = s_in0 + (u % 2) * CT * ld;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float* srow = s_in + (sr + (NT / TW) * i) * ld;
      srow[sx] = to_f32(pre[i][0]);
      if (col1) srow[sx + TW] = to_f32(pre[i][1]);
    }
    __syncthreads();
    if (u + 1 < d) load_row(u + 1);

    const float* fu = s_f + u * dv * TW;
    float4 lo[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
      lo[cc] = *reinterpret_cast<const float4*>(s_in + (k + 16 * cc) * ld + P * g);
    for (int v0 = 0; v0 < d; v0 += 4) {
      float f[4][P];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 fv = *reinterpret_cast<const float4*>(fu + (v0 + j) * TW + P * g);
        f[j][0] = fv.x; f[j][1] = fv.y; f[j][2] = fv.z; f[j][3] = fv.w;
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float4 hi = *reinterpret_cast<const float4*>(
            s_in + (k + 16 * cc) * ld + P * g + v0 + 4);
        const float x[8] = {lo[cc].x, lo[cc].y, lo[cc].z, lo[cc].w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (v0 + j < d) {
#pragma unroll
            for (int p = 0; p < P; ++p) acc[cc][p] = fmaf(f[j][p], x[p + j], acc[cc][p]);
          }
        }
        lo[cc] = hi;
      }
    }
  }

#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    const int c = c0 + k + 16 * cc;
    if (c >= C) continue;
    T* orow = out + ((size_t)b * C + c) * plane_f + (size_t)h * W;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int w = w0 + P * g + p;
      if (w < W) orow[w] = from_f32<T>(acc[cc][p]);
    }
  }
}

template <typename T>
int launch(const void* inp, const void* filt, void* out, int B, int C, int H, int W,
           int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(adaptive_conv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, H, B * ((C + CT - 1) / CT));
  adaptive_conv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(inp), static_cast<const T*>(filt), static_cast<T*>(out),
      C, H, W, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rs_adaptive_conv_bf16(const void* inp, const void* filt, void* out,
                                     int B, int C, int H, int W, int d,
                                     cudaStream_t stream) {
  return launch<__nv_bfloat16>(inp, filt, out, B, C, H, W, d, stream);
}

extern "C" int rs_adaptive_conv_f32(const void* inp, const void* filt, void* out,
                                    int B, int C, int H, int W, int d,
                                    cudaStream_t stream) {
  return launch<float>(inp, filt, out, B, C, H, W, d, stream);
}
