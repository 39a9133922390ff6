// Adaptive (per-pixel) convolution with fp32 products, each operand in its
// own element type, in two layouts, on Hopper (sm_90a):
//
//   out[b, c, h, w] = sum_{u,v} f32(filt[b, u*d+v, h, w]) * f32(inp[b, c, h+u, w+v])
//
// summed in fp32 in tap order t = u*d + v and rounded once to inp's type.
// The input and the taps are each bf16 or fp32 (four instantiations per
// kernel): neither is rounded to the other's type.
//
// Replaces the TPU kernels rs_ov/kernels/adaptive_conv.py:
// adaptive_conv_pallas_planes (K4c: NCHW input resident per channel block,
// tap planes streamed by DMA) and :adaptive_conv_pallas_cl (K4d: the same
// function computed channels-last; its wrapper transposes in and out, and
// hands C % 128 != 0 to the planes kernel, a lane artefact this port drops:
// K4d takes any even C).
//
// What bounds it on the H100, at the main-path shapes (B=2, C=512, d=11,
// H=W=56, fp32): 2*B*C*H*W*d^2 = 777 MFLOP, 11.6 us on the fp32 cores at
// 67 TFLOP/s, against 33.7 MB moved (10.1 us at 3.35 TB/s): operations bound
// it, as they bound K4b. With a bf16 input the bytes shrink and operations
// bound it all the more. This first version runs on the fp32 cores.
//
// K4c design (planes): one block of 256 threads per (b, 32 channels, 8
// output rows, 32 output columns). The block's input window, 32 channels x
// (8+d-1) rows x (32+d-1) columns, is staged once in shared memory as fp32
// (97 KB at d=11: two blocks per SM). Each thread owns one output pixel and
// 32 channel sums; it streams the d*d tap planes through registers, the
// next tap's load in flight while the current tap is summed over the 32
// channels. A tap value is read by one thread only, so it needs no shared
// memory; neighbouring threads read neighbouring columns of a tap plane and
// of the staged window, so global loads coalesce and shared loads have no
// bank conflicts. The taps cross device memory once per channel block.
//
// K4d design (channels-last): the wrapper permutes the input to
// [B, Hp, Wp, C] and the output back, as the JAX wrapper does. One block of
// 256 threads per (b, output row h, strip of 16 pixels): the strip's taps
// are staged in shared memory as fp32 [16][d*d]; threads run over channel
// pairs (so a warp reads consecutive bytes of one source pixel) and each
// source pixel of the strip's d x (16+d-1) window is loaded once and feeds
// every output pixel whose window covers it, in tap order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using rs_ov::from_f32;
using rs_ov::to_f32;

constexpr int NT = 256;

// ---- K4c: planes ----------------------------------------------------------
constexpr int PL_TW = 32;  // output columns per block
constexpr int PL_RH = 8;   // output rows per block
constexpr int PL_CB = 32;  // channels per block

inline size_t planes_smem_bytes(int d) {
  return (size_t)PL_CB * (PL_RH + d - 1) * (PL_TW + d - 1) * sizeof(float);
}

template <typename Ti, typename Tf>
__global__ void __launch_bounds__(NT)
planes_kernel(const Ti* __restrict__ inp, const Tf* __restrict__ filt,
              Ti* __restrict__ out, int C, int H, int W, int d) {
  extern __shared__ float s_in[];  // [PL_CB][PL_RH+d-1][PL_TW+d-1]
  const int n_cb = (C + PL_CB - 1) / PL_CB;
  const int b = blockIdx.z / n_cb, c0 = (blockIdx.z % n_cb) * PL_CB;
  const int h0 = blockIdx.y * PL_RH, w0 = blockIdx.x * PL_TW;
  const int Hp = H + d - 1, Wp = W + d - 1;
  const int sh = PL_RH + d - 1, sw = PL_TW + d - 1, splane = sh * sw;

  for (int i = threadIdx.x; i < PL_CB * splane; i += NT) {
    const int x = i % sw, y = (i / sw) % sh, c = i / splane;
    const int gy = h0 + y, gx = w0 + x;
    s_in[i] = (c0 + c < C && gy < Hp && gx < Wp)
                  ? to_f32(inp[(((size_t)b * C + c0 + c) * Hp + gy) * Wp + gx])
                  : 0.f;
  }

  const int tx = threadIdx.x % PL_TW, ty = threadIdx.x / PL_TW;
  const int h = h0 + ty, w = w0 + tx;
  const bool ok = h < H && w < W;
  const size_t plane = (size_t)H * W;
  const Tf* fp = filt + (size_t)b * d * d * plane + (size_t)h * W + w;
  float acc[PL_CB];
#pragma unroll
  for (int c = 0; c < PL_CB; ++c) acc[c] = 0.f;
  float next = ok ? to_f32(fp[0]) : 0.f;
  __syncthreads();

  for (int u = 0; u < d; ++u) {
    for (int v = 0; v < d; ++v) {
      const int t = u * d + v;
      const float f = next;
      if (ok && t + 1 < d * d) next = to_f32(fp[(size_t)(t + 1) * plane]);
      const float* si = s_in + (ty + u) * sw + tx + v;
#pragma unroll
      for (int c = 0; c < PL_CB; ++c) acc[c] = fmaf(f, si[c * splane], acc[c]);
    }
  }
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < PL_CB; ++c)
    if (c0 + c < C) out[(((size_t)b * C + c0 + c) * H + h) * W + w] = from_f32<Ti>(acc[c]);
}

// ---- K4d: channels-last ---------------------------------------------------
constexpr int CL_PIX = 16;  // output pixels per block

inline size_t cl_smem_bytes(int d) { return (size_t)CL_PIX * d * d * sizeof(float); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename Ti, typename Tf>
__global__ void __launch_bounds__(NT)
cl_kernel(const Ti* __restrict__ inp, const Tf* __restrict__ filt, Ti* __restrict__ out,
          int C, int H, int W, int d) {
  extern __shared__ float s_f[];  // [CL_PIX][d*d]
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * CL_PIX;
  const int dd = d * d, Hp = H + d - 1, Wp = W + d - 1, C2 = C / 2;
  for (int i = threadIdx.x; i < CL_PIX * dd; i += NT) {
    const int p = i % CL_PIX, t = i / CL_PIX, w = w0 + p;
    s_f[p * dd + t] = w < W ? to_f32(filt[(((size_t)b * dd + t) * H + h) * W + w]) : 0.f;
  }
  __syncthreads();

  const int nxw = min(CL_PIX + d - 1, Wp - w0);
  for (int c2 = threadIdx.x; c2 < C2; c2 += NT) {
    float acc0[CL_PIX], acc1[CL_PIX];
#pragma unroll
    for (int p = 0; p < CL_PIX; ++p) acc0[p] = acc1[p] = 0.f;
    for (int u = 0; u < d; ++u) {
      const Ti* row = inp + (((size_t)b * Hp + h + u) * Wp + w0) * C + 2 * c2;
      const float* fu = s_f + u * d;
      for (int x = 0; x < nxw; ++x) {
        const float2 val = load2(row + (size_t)x * C);
#pragma unroll
        for (int p = 0; p < CL_PIX; ++p) {
          const int v = x - p;
          if (v >= 0 && v < d) {
            const float wt = fu[p * dd + v];
            acc0[p] = fmaf(wt, val.x, acc0[p]);
            acc1[p] = fmaf(wt, val.y, acc1[p]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < CL_PIX; ++p)
      if (w0 + p < W)
        store2(out + (((size_t)b * H + h) * W + w0 + p) * C + 2 * c2, acc0[p], acc1[p]);
  }
}

template <typename Ti, typename Tf>
int launch_planes(const void* inp, const void* filt, void* out, int B, int C, int H,
                  int W, int d, cudaStream_t stream) {
  const size_t smem = planes_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(planes_kernel<Ti, Tf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + PL_TW - 1) / PL_TW, (H + PL_RH - 1) / PL_RH,
            B * ((C + PL_CB - 1) / PL_CB));
  planes_kernel<Ti, Tf><<<grid, NT, smem, stream>>>(
      static_cast<const Ti*>(inp), static_cast<const Tf*>(filt), static_cast<Ti*>(out),
      C, H, W, d);
  return (int)cudaGetLastError();
}

template <typename Ti, typename Tf>
int launch_cl(const void* inp, const void* filt, void* out, int B, int C, int H, int W,
              int d, cudaStream_t stream) {
  const size_t smem = cl_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(cl_kernel<Ti, Tf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + CL_PIX - 1) / CL_PIX, H, B);
  cl_kernel<Ti, Tf><<<grid, NT, smem, stream>>>(
      static_cast<const Ti*>(inp), static_cast<const Tf*>(filt), static_cast<Ti*>(out),
      C, H, W, d);
  return (int)cudaGetLastError();
}

// the launchers, indexed [input is bf16][taps are bf16]
using Launch = int (*)(const void*, const void*, void*, int, int, int, int, int,
                       cudaStream_t);

}  // namespace

extern "C" int rs_adaptive_conv_planes(const void* inp, const void* filt, void* out,
                                       int B, int C, int H, int W, int d, int inp_bf16,
                                       int filt_bf16, cudaStream_t stream) {
  static const Launch table[2][2] = {
      {launch_planes<float, float>, launch_planes<float, __nv_bfloat16>},
      {launch_planes<__nv_bfloat16, float>, launch_planes<__nv_bfloat16, __nv_bfloat16>}};
  return table[inp_bf16 != 0][filt_bf16 != 0](inp, filt, out, B, C, H, W, d, stream);
}

extern "C" int rs_adaptive_conv_cl(const void* inp, const void* filt, void* out,
                                   int B, int C, int H, int W, int d, int inp_bf16,
                                   int filt_bf16, cudaStream_t stream) {
  static const Launch table[2][2] = {
      {launch_cl<float, float>, launch_cl<float, __nv_bfloat16>},
      {launch_cl<__nv_bfloat16, float>, launch_cl<__nv_bfloat16, __nv_bfloat16>}};
  return table[inp_bf16 != 0][filt_bf16 != 0](inp, filt, out, B, C, H, W, d, stream);
}
