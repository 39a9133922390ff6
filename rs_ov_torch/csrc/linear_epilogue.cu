// K8: a linear layer's epilogue on Hopper (sm_90a).
//
//   out[r, c] = act(round(y[r, c] + bias[c]))
//
// y the fp32 product [rows, N] that matmul32 writes for a linear layer
// (rs_ov_torch/nn/layers.py:linear), bias [N] in bf16 or fp32 (or none),
// round() to the output type (bf16 or fp32, to nearest even), act none,
// QuickGELU or the exact (erf) GELU. Each step rounds where the plain chain
// of eager PyTorch operations rounds it on the card, so the output is equal
// to it bit for bit:
//   bias:       h = round(y + float(bias))          (y + b.float()).to(dtype)
//   QuickGELU:  t = round(h * 1.702f)                1.702 * h
//               s = round(1 / (1 + expf(-t)))        torch.sigmoid(t)
//               out = round(h * s)                   h * s
//   GELU:       out = round(h * 0.5f * (1 + erff(h * M_SQRT1_2)))   F.gelu(h)
// with every product and sum an IEEE fp32 operation (__fmul_rn / __fadd_rn,
// never contracted into an fma), and expf, erff and the division as the
// library builds them without fast math (kernels/build.py:NVCC_FLAGS).
// Replaces no TPU kernel: XLA fused the bias add, the cast and the activation
// of the JAX package's rs_ov/nn/layers.py:linear and mlp into one pass, where
// eager PyTorch runs them as 3 launches after the product (the bias's cast,
// the fp32 add, the cast) and 1 (GELU) or 3 (QuickGELU) more.
//
// What bounds it on the H100: bytes, 4 read and 2 written an element in bf16
// (4 and 4 in fp32); the bias is read once a thread. ViT-B/16's c_fc over a
// call of 8 tiles, [25216, 3072], is 464.8 MB, 0.139 ms at 3.35 TB/s;
// ViT-L/14's, [32896, 4096], 808.4 MB, 0.241 ms. The chain it replaces moves
// 14 bytes an element (28 with QuickGELU).
//
// Design: a thread owns 8 consecutive columns of one row (two 16-byte fp32
// loads, one 16-byte bf16 store or two fp32 stores) and their 8 bias values.
// A block is BX column groups x BY rows (BX a multiple of 32 that divides
// N / 8 where one does, BX * BY <= 128); the grid covers the whole output,
// one row a thread, so the hardware keeps every SM's blocks turning over and
// the loads of new blocks overlap the arithmetic of old ones (a grid of the
// resident blocks walking the rows by a stride read 79-83% of the bound at
// the batch shapes without an activation or with QuickGELU, this one 86-88%;
// the stride loop stays for more than 65535 row blocks). The launch bounds
// name a minimum of one block an SM: without it ptxas holds the GELU
// instantiation to 40 registers by issuing the second 16-byte load after the
// first half's arithmetic, so a thread waits on memory twice (61% of the
// bound); with it, 56 registers, both loads first, 87%; the other
// instantiations compile as before. y is read with the evict-first hint: it
// is dead after this pass. Where N is no multiple of 8 or an operand is not
// 16-byte aligned the same kernel takes one column a thread (VEC = 1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using namespace rs_ov;

enum DType { F32 = 0, BF16 = 1 };
enum Bias { NO_BIAS = -1, BIAS_F32 = 0, BIAS_BF16 = 1 };
enum Act { NONE = 0, QUICK_GELU = 1, GELU = 2 };

constexpr int kThreads = 128;  // threads a block, at most
constexpr float kSqrtHalf = 0.70710678118654752440f;  // (float)M_SQRT1_2, as F.gelu takes it

// x rounded to T and read back: the value the plain chain stores as a T
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The activation of h (already a T value), rounded as eager PyTorch rounds
// each of its operations; the last rounding is the caller's.
template <typename T, int ACT>
__device__ __forceinline__ float activate(float h) {
  if constexpr (ACT == QUICK_GELU) {
    const float t = round_to<T>(__fmul_rn(h, 1.702f));
    const float s = round_to<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t))));
    return __fmul_rn(h, s);
  }
  if constexpr (ACT == GELU) {
    const float e = erff(__fmul_rn(h, kSqrtHalf));
    return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.0f, e));
  }
  return h;
}

template <typename T, int BIAS, int ACT>
__device__ __forceinline__ float epilogue(float y, float b) {
  float h = y;
  if constexpr (BIAS != NO_BIAS) h = __fadd_rn(y, b);
  h = round_to<T>(h);
  return activate<T, ACT>(h);
}

template <int BIAS, int VEC>
__device__ __forceinline__ void load_bias(const void* bias, size_t c, float (&b)[VEC]) {
  if constexpr (BIAS == BIAS_BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(bias) + c;
    if constexpr (VEC == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) b[j] = to_f32(v[j]);
    } else {
      b[0] = to_f32(p[0]);
    }
  } else if constexpr (BIAS == BIAS_F32) {
    const float* p = static_cast<const float*>(bias) + c;
    if constexpr (VEC == 8) {
      const float4 u0 = reinterpret_cast<const float4*>(p)[0];
      const float4 u1 = reinterpret_cast<const float4*>(p)[1];
      b[0] = u0.x; b[1] = u0.y; b[2] = u0.z; b[3] = u0.w;
      b[4] = u1.x; b[5] = u1.y; b[6] = u1.z; b[7] = u1.w;
    } else {
      b[0] = p[0];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) b[j] = 0.f;
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const float4 u0 = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 u1 = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
    v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&o)[VEC]);

template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 8>(__nv_bfloat16* p, const float (&o)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <>
__device__ __forceinline__ void store_row<float, 8>(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

template <>
__device__ __forceinline__ void store_row<__nv_bfloat16, 1>(__nv_bfloat16* p, const float (&o)[1]) {
  *p = from_f32<__nv_bfloat16>(o[0]);
}

template <>
__device__ __forceinline__ void store_row<float, 1>(float* p, const float (&o)[1]) {
  *p = o[0];
}

template <typename T, int BIAS, int ACT, int VEC>
__device__ __forceinline__ void finish(const float (&v)[VEC], const float (&b)[VEC], T* p) {
  float o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = epilogue<T, BIAS, ACT>(v[j], b[j]);
  store_row<T, VEC>(p, o);
}

// y, out [rows, N] contiguous; the thread (threadIdx.x, threadIdx.y) of block
// (blockIdx.x, blockIdx.y) owns columns [VEC * g, VEC * g + VEC) with
// g = blockIdx.x * blockDim.x + threadIdx.x of the row blockIdx.y *
// blockDim.y + threadIdx.y (and of every gridDim.y * blockDim.y rows after
// it, where the rows outnumber the grid).
template <typename T, int BIAS, int ACT, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
linear_epilogue_kernel(const float* __restrict__ y, const void* __restrict__ bias,
                       T* __restrict__ out, int rows, int N) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= N / VEC) return;
  const size_t c = (size_t)g * VEC;
  float b[VEC];
  load_bias<BIAS, VEC>(bias, c, b);
  const long long stride = (long long)gridDim.y * blockDim.y;
  for (long long r = blockIdx.y * blockDim.y + threadIdx.y; r < rows; r += stride) {
    const size_t o = (size_t)r * N + c;
    float v[VEC];
    load_row<VEC>(y + o, v);
    finish<T, BIAS, ACT, VEC>(v, b, out + o);
  }
}

template <typename T, int BIAS, int ACT, int VEC>
int launch(const void* y, const void* bias, void* out, int rows, int N, cudaStream_t stream) {
  const int groups = N / VEC;
  int bx = groups < kThreads ? (groups + 31) / 32 * 32 : kThreads;
  if (groups >= kThreads)
    for (int w = kThreads; w >= kThreads / 2; w -= 32)
      if (groups % w == 0) {
        bx = w;
        break;
      }
  const int by = kThreads / bx;
  const int gx = (groups + bx - 1) / bx;
  const long gy = ((long)rows + by - 1) / by;
  linear_epilogue_kernel<T, BIAS, ACT, VEC><<<dim3(gx, (unsigned)(gy < 65535 ? gy : 65535)),
                                              dim3(bx, by), 0, stream>>>(
      static_cast<const float*>(y), bias, static_cast<T*>(out), rows, N);
  return (int)cudaGetLastError();
}

template <typename T, int BIAS, int ACT>
int launch_vec(const void* y, const void* bias, void* out, int rows, int N, int vec,
               cudaStream_t stream) {
  return vec == 8 ? launch<T, BIAS, ACT, 8>(y, bias, out, rows, N, stream)
                  : launch<T, BIAS, ACT, 1>(y, bias, out, rows, N, stream);
}

template <typename T, int BIAS>
int launch_act(const void* y, const void* bias, void* out, int rows, int N, int act, int vec,
               cudaStream_t stream) {
  switch (act) {
    case QUICK_GELU: return launch_vec<T, BIAS, QUICK_GELU>(y, bias, out, rows, N, vec, stream);
    case GELU: return launch_vec<T, BIAS, GELU>(y, bias, out, rows, N, vec, stream);
    default: return launch_vec<T, BIAS, NONE>(y, bias, out, rows, N, vec, stream);
  }
}

template <typename T>
int launch_bias(const void* y, const void* bias, void* out, int rows, int N, int bias_dtype,
                int act, int vec, cudaStream_t stream) {
  switch (bias_dtype) {
    case BIAS_F32: return launch_act<T, BIAS_F32>(y, bias, out, rows, N, act, vec, stream);
    case BIAS_BF16: return launch_act<T, BIAS_BF16>(y, bias, out, rows, N, act, vec, stream);
    default: return launch_act<T, NO_BIAS>(y, bias, out, rows, N, act, vec, stream);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// y [rows, N] fp32 and out [rows, N] contiguous, bias [N] or null;
// out_dtype 0 = fp32, 1 = bf16; bias_dtype -1 = none, 0 = fp32, 1 = bf16;
// act 0 = none, 1 = QuickGELU, 2 = GELU (erf); vec 8 (N a multiple of 8,
// every pointer 16-byte aligned) or 1.
extern "C" int rs_linear_epilogue(const void* y, const void* bias, void* out, int rows, int N,
                                  int out_dtype, int bias_dtype, int act, int vec,
                                  cudaStream_t stream) {
  if (rows < 1 || N < 1 || (out_dtype != F32 && out_dtype != BF16) || bias_dtype < NO_BIAS ||
      bias_dtype > BIAS_BF16 || (bias_dtype != NO_BIAS) != (bias != nullptr) || act < NONE ||
      act > GELU || (vec != 1 && vec != 8))
    return (int)cudaErrorInvalidValue;
  if (vec == 8 && (N % 8 != 0 || !aligned16(y) || !aligned16(out) ||
                   (bias != nullptr && !aligned16(bias))))
    return (int)cudaErrorInvalidValue;
  if (out_dtype == BF16)
    return launch_bias<__nv_bfloat16>(y, bias, out, rows, N, bias_dtype, act, vec, stream);
  return launch_bias<float>(y, bias, out, rows, N, bias_dtype, act, vec, stream);
}
