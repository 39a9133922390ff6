// Element-type conversions shared by the adaptive-conv kernels: every
// operand is read into fp32, every output rounded once from fp32.
#pragma once

#include <cuda_bf16.h>

namespace rs_ov {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace rs_ov
