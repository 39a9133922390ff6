// Adaptive (per-pixel) convolution with BOTH operands rounded to bf16, on
// Hopper (sm_90a):
//
//   out[b, c, h, w] = sum_{u,v} bf16(filt[b, u*d+v, h, w]) * bf16(inp[b, c, h+u, w+v])
//
// Each operand is rounded to bf16 on load (round to nearest even, as
// astype(jnp.bfloat16)); the products of two bf16 values are exact in fp32
// and are summed in fp32 in tap order t = u*d + v, then rounded once to
// inp's type. So an fp32 input with fp32 taps does NOT give the fp32 kernels'
// (K4b, K4c) result, and a bf16 input with fp32 taps rounds the taps.
//
// Replaces the TPU kernels rs_ov/kernels/adaptive_conv_v3.py:
// adaptive_conv_pallas_v3 (K4e: one banded bf16 matrix product per output
// row and window row on the MXU, fp32 accumulation) and
// rs_ov/kernels/adaptive_conv_v4.py:adaptive_conv_pallas_v4 (K4f: the same,
// output columns in chunks of WT = min(112, pad8(W)), d <= 17 so that a
// chunk's window fits the 128-lane K window).
//
// What bounds it on the H100, at the main-path shapes (B=2, C=512, d=11,
// H=W=56): 2*B*C*H*W*d^2 = 777 M operations on bf16 operands, 0.8 us at
// 989 TFLOP/s, against 33.7 MB moved in fp32 (10.1 us at 3.35 TB/s; half
// with a bf16 input): bytes bound it. This first version multiplies on the
// fp32 cores (67 TFLOP/s: 11.6 us), so in practice operations and the
// shared-memory reads behind them set its time; the TPU design (banded
// bf16 matrices on the matrix unit) maps to mma.sync / wgmma in a later
// version.
//
// Design: K4c's planes decomposition. One block of 256 threads per (b, 32
// channels, 8 output rows, TW output columns): K4e takes TW = 32, one output
// pixel per thread; K4f takes the TPU kernel's column chunk TW = min(112,
// pad8(W)) and each thread walks the chunk's pixels with a stride of 256.
// The block's input window, 32 channels x (8+d-1) rows x (TW+d-1) columns,
// is rounded to bf16 as it is staged in shared memory: storing bf16 is
// exact after the rounding and halves the window (48 KB for K4e at d=11,
// 137 KB for K4f at d=11 and WT=112, 192 KB at d=17). Each thread keeps 32
// channel sums of one pixel in registers and streams the d*d taps of that
// pixel from device memory, rounded on load, the next tap's load in flight
// while the current one is summed. Neighbouring threads read neighbouring
// columns of a tap plane and of the window, so global loads coalesce and
// shared loads have no bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using rs_ov::from_f32;

constexpr int NT = 256;
constexpr int RH = 8;      // output rows per block
constexpr int CB = 32;     // channels per block
constexpr int V3_TW = 32;  // K4e: output columns per block

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ float rounded(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rounded(__nv_bfloat16 x) { return __bfloat162float(x); }

inline size_t smem_bytes(int tw, int d) {
  return (size_t)CB * (RH + d - 1) * (tw + d - 1) * sizeof(__nv_bfloat16);
}

// kChunked = false: K4e, TW = 32; true: K4f, TW = tw_arg
template <typename Ti, typename Tf, bool kChunked>
__global__ void __launch_bounds__(NT)
bf16_conv_kernel(const Ti* __restrict__ inp, const Tf* __restrict__ filt,
                 Ti* __restrict__ out, int C, int H, int W, int d, int tw_arg) {
  extern __shared__ __nv_bfloat16 s_win[];  // [CB][RH+d-1][TW+d-1]
  const int tw = kChunked ? tw_arg : V3_TW;
  const int n_cb = (C + CB - 1) / CB;
  const int b = blockIdx.z / n_cb, c0 = (blockIdx.z % n_cb) * CB;
  const int h0 = blockIdx.y * RH, w0 = blockIdx.x * tw;
  const int Hp = H + d - 1, Wp = W + d - 1;
  const int sh = RH + d - 1, sw = tw + d - 1, splane = sh * sw;

  for (int i = threadIdx.x; i < CB * splane; i += NT) {
    const int x = i % sw, y = (i / sw) % sh, c = i / splane;
    const int gy = h0 + y, gx = w0 + x;
    s_win[i] = (c0 + c < C && gy < Hp && gx < Wp)
                   ? to_bf16(inp[(((size_t)b * C + c0 + c) * Hp + gy) * Wp + gx])
                   : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const size_t plane = (size_t)H * W;
  const int dd = d * d;
  for (int p = threadIdx.x; p < RH * tw; p += NT) {
    const int ty = p / tw, tx = p % tw;
    const int h = h0 + ty, w = w0 + tx;
    if (h >= H || w >= W) continue;
    const Tf* fp = filt + (size_t)b * dd * plane + (size_t)h * W + w;
    float acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.f;
    float next = rounded(fp[0]);
    for (int u = 0; u < d; ++u) {
      for (int v = 0; v < d; ++v) {
        const int t = u * d + v;
        const float f = next;
        if (t + 1 < dd) next = rounded(fp[(size_t)(t + 1) * plane]);
        const __nv_bfloat16* si = s_win + (ty + u) * sw + tx + v;
        // bf16 x bf16 is exact in fp32, so the fma rounds only the sum
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] = fmaf(f, __bfloat162float(si[c * splane]), acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c0 + c < C) out[(((size_t)b * C + c0 + c) * H + h) * W + w] = from_f32<Ti>(acc[c]);
  }
}

template <typename Ti, typename Tf, bool kChunked>
int launch(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
           int tw, cudaStream_t stream) {
  const size_t smem = smem_bytes(tw, d);
  cudaError_t err = cudaFuncSetAttribute(bf16_conv_kernel<Ti, Tf, kChunked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + tw - 1) / tw, (H + RH - 1) / RH, B * ((C + CB - 1) / CB));
  bf16_conv_kernel<Ti, Tf, kChunked><<<grid, NT, smem, stream>>>(
      static_cast<const Ti*>(inp), static_cast<const Tf*>(filt), static_cast<Ti*>(out),
      C, H, W, d, tw);
  return (int)cudaGetLastError();
}

// the launchers, indexed [input is bf16][taps are bf16]
using Launch = int (*)(const void*, const void*, void*, int, int, int, int, int, int,
                       cudaStream_t);

template <bool kChunked>
int dispatch(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
             int tw, int inp_bf16, int filt_bf16, cudaStream_t stream) {
  static const Launch table[2][2] = {
      {launch<float, float, kChunked>, launch<float, __nv_bfloat16, kChunked>},
      {launch<__nv_bfloat16, float, kChunked>,
       launch<__nv_bfloat16, __nv_bfloat16, kChunked>}};
  return table[inp_bf16 != 0][filt_bf16 != 0](inp, filt, out, B, C, H, W, d, tw, stream);
}

}  // namespace

// K4e
extern "C" int rs_adaptive_conv_v3(const void* inp, const void* filt, void* out, int B, int C,
                                   int H, int W, int d, int inp_bf16, int filt_bf16,
                                   cudaStream_t stream) {
  return dispatch<false>(inp, filt, out, B, C, H, W, d, V3_TW, inp_bf16, filt_bf16, stream);
}

// K4f: tw is the column chunk, min(112, pad8(W))
extern "C" int rs_adaptive_conv_v4(const void* inp, const void* filt, void* out, int B, int C,
                                   int H, int W, int d, int tw, int inp_bf16, int filt_bf16,
                                   cudaStream_t stream) {
  if (tw < 1 || tw > 112 || d > 17) return (int)cudaErrorInvalidValue;
  return dispatch<true>(inp, filt, out, B, C, H, W, d, tw, inp_bf16, filt_bf16, stream);
}
