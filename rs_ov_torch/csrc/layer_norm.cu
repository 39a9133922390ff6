// K7: LayerNorm over the last axis on Hopper (sm_90a).
//
//   out[r, :] = bf16-or-fp32((x[r, :] - mean) * rsqrt(var + eps) * scale + bias)
//
// with the statistics in fp32: the mean, then the variance as the mean of
// the squared deviations from it (two passes over the row held on chip, not
// E[x^2] - E[x]^2), the affine step in fp32 and one rounding to x's type.
// Replaces no TPU kernel: XLA fused the JAX package's LayerNorm,
// rs_ov/nn/layers.py:layer_norm, into one pass, where eager PyTorch runs the
// formula as 14 launches that move about 17 fp32 copies of the activation.
// The products are rounded as the plain version rounds them (no fma); only
// the order of the fp32 sums differs. No atomics: a run repeats bit for bit.
//
// What bounds it on the H100: bytes, 2 * rows * D * sizeof(x) (the affine
// parameters are read from L1 / L2). ViT-B/16's [25216, 768] bf16 is
// 77.5 MB, 23.1 us at 3.35 TB/s; ViT-L/14's [32896, 1024] 134.7 MB, 40.2 us.
//
// Design: one warp a row, eight rows a block (~3,150 blocks at B/16), the
// row held in registers as fp32: each lane loads NV vectors of 16 bytes
// (8 bf16 or 4 fp32), neighbouring lanes on neighbouring addresses, all NV
// loads in flight before the first sum; warp-shuffle sums (every lane gets
// the same total). The kernel is instantiated for NV = 1..kMaxNV (D = 768
// bf16 is 3 vectors a lane, 1024 is 4); the wrapper picks NV from the row
// length (kernels/layer_norm.py:_row_vectors). A row whose length is not a
// multiple of the vector, whose operands are not 16-byte aligned, or which is
// longer than kMaxNV vectors a lane (2048 bf16, 1024 fp32) takes
// layer_norm_block: a block a row, looping over the row in element steps,
// reading it once for each of the three passes (the later two from cache).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

using namespace rs_ov;

constexpr int kRows = 8;    // rows (warps) a block of layer_norm_warp
constexpr int kMaxNV = 8;   // 16-byte vectors a lane holds, at most
constexpr int kMaxBlock = 512;

enum DType { F32 = 0, BF16 = 1 };

template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Chunk {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  const Chunk<T, N> c = *reinterpret_cast<const Chunk<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) f[j] = to_f32(c.v[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (x - mean) * rstd * scale + bias, each product and the sum rounded as the
// plain version rounds them
__device__ __forceinline__ float affine(float x, float mean, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), s), b);
}

template <typename T, typename P, int NV>
__global__ void __launch_bounds__(32 * kRows)
layer_norm_warp(const T* __restrict__ x, const P* __restrict__ scale,
                const P* __restrict__ bias, T* __restrict__ out, int rows, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = D / V;
  const size_t base = (size_t)row * D;

  float v[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      load(x + base + (size_t)c * V, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[i][j];
  const float mean = warp_sum(s) / D;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[i][j] - mean;
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      float sc[V], bi[V];
      load(scale + (size_t)c * V, sc);
      load(bias + (size_t)c * V, bi);
      Chunk<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(affine(v[i][j], mean, rstd, sc[j], bi[j]));
      *reinterpret_cast<Chunk<T, V>*>(out + base + (size_t)c * V) = o;
    }
  }
}

// The sum of v over the block, the same in every thread; part[] is reused
// by the next call, hence the barrier before it is written.
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kMaxBlock)
layer_norm_block(const T* __restrict__ x, const P* __restrict__ scale,
                 const P* __restrict__ bias, T* __restrict__ out, int D, float eps) {
  __shared__ float part[32];
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = out + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) s += to_f32(xr[c]);
  const float mean = block_sum(s, part) / D;
  float q = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float d = to_f32(xr[c]) - mean;
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float rstd = rsqrtf(block_sum(q, part) / D + eps);
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    yr[c] = from_f32<T>(affine(to_f32(xr[c]), mean, rstd, to_f32(scale[c]), to_f32(bias[c])));
}

template <typename T, typename P>
int launch(const void* x_, const void* scale_, const void* bias_, void* out_, int rows, int D,
           int nv, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const P* scale = static_cast<const P*>(scale_);
  const P* bias = static_cast<const P*>(bias_);
  T* out = static_cast<T*>(out_);
  const dim3 grid((rows - 1) / kRows + 1), block(32 * kRows);
  switch (nv) {
#define RS_LN_CASE(N)                                                                   \
  case N:                                                                               \
    layer_norm_warp<T, P, N><<<grid, block, 0, stream>>>(x, scale, bias, out, rows, D, eps); \
    break;
    RS_LN_CASE(1) RS_LN_CASE(2) RS_LN_CASE(3) RS_LN_CASE(4)
    RS_LN_CASE(5) RS_LN_CASE(6) RS_LN_CASE(7) RS_LN_CASE(8)
#undef RS_LN_CASE
    default: {  // nv == 0: a block a row, about 8 elements a thread
      const int want = ((D + 7) / 8 + 31) / 32 * 32;
      const int threads = want < kMaxBlock ? want : kMaxBlock;
      layer_norm_block<T, P><<<rows, threads, 0, stream>>>(x, scale, bias, out, D, eps);
    }
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, out [rows, D] contiguous; scale, bias [D]; x_dtype / p_dtype 0 = fp32,
// 1 = bf16 (out takes x's); nv: 16-byte vectors a lane holds (1..8, the row
// in registers: D a multiple of the vector, every pointer 16-byte aligned,
// (nv - 1) * 32 vectors < D / vector <= nv * 32) or 0 (a block a row).
extern "C" int rs_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                             int rows, int D, int x_dtype, int p_dtype, int nv, float eps,
                             cudaStream_t stream) {
  if (rows < 1 || D < 1 || (x_dtype != F32 && x_dtype != BF16) ||
      (p_dtype != F32 && p_dtype != BF16) || nv < 0 || nv > kMaxNV)
    return (int)cudaErrorInvalidValue;
  if (nv > 0) {
    const int V = x_dtype == F32 ? 4 : 8;
    if (D % V != 0 || D / V > nv * 32 || D / V <= (nv - 1) * 32 || !aligned16(x) ||
        !aligned16(out) || !aligned16(scale) || !aligned16(bias))
      return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == BF16 && p_dtype == BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, rows, D, nv, eps, stream);
  if (x_dtype == BF16)
    return launch<__nv_bfloat16, float>(x, scale, bias, out, rows, D, nv, eps, stream);
  if (p_dtype == BF16)
    return launch<float, __nv_bfloat16>(x, scale, bias, out, rows, D, nv, eps, stream);
  return launch<float, float>(x, scale, bias, out, rows, D, nv, eps, stream);
}
