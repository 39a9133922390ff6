// Fused self-self attention (K6) in fp32 on Hopper (sm_90a), on the fp32
// cores. The bf16 entry is selfself_attention_sm90.cu, on the tensor cores.
//
//   out[b, h, i, :] = sum_j A[i, j] * v[b, h, j, :]      (fp32)
//
// with the attention weights A of one of six modes (s = hd^-0.5, S = sim * w):
//   0 vanilla       softmax(q k^T s + S)
//   1 ClearCLIP     softmax(q q^T s + S)
//   2 SCLIP         softmax(q q^T s + S) + softmax(k k^T s + S)
//   3 SegEarth      SCLIP's two terms + softmax(v v^T s + S)
//   4 SFP           softmax(0.5 (q q^T s + k k^T s) + S)
//   5 Experimental  softmax(softmax(k k^T s + q q^T s) + S)
// Sums of softmaxes are not renormalised. Experimental takes its second
// softmax with or without a sim map.
//
// Replaces the TPU kernel rs_ov/kernels/selfself_attention.py:
// fused_selfself_attention (pallas_call at :103), for fp32 operands.
//
// What bounds it on the H100: operations. At the main path's shapes (B=16
// crops, H=12, L=197, hd=64) one score product is 2*B*H*L^2*hd = 0.954
// GFLOP; Experimental has two, SegEarth three, and the product with the
// weights a third or fourth. On the fp32 cores (67 TFLOP/s) that is 28-57
// us; the bytes (q, k, v, out in fp32: 38.7 MB; the sim map: 2.5 MB) take
// 12 us. This kernel computes everything on the fp32 cores.
//
// Design: one block of 16 warps per (b*h, tile of about 64 query rows). The
// block stages the head's q, k and v (only the operands the mode needs) in
// shared memory, each row padded by 16 bytes so that the 16-byte loads of 8
// lanes from 8 different rows hit 8 different banks. Each warp owns one
// query row at a time: lane t holds the scores of the keys j = t + 32m (m <
// 9, so L <= 288) in registers, computed with fp32 FMAs from 16-byte vector
// loads; each softmax is a warp-shuffle max, exp and a warp-shuffle sum. The
// weights row goes to the warp's own row of shared memory, and each lane
// then accumulates the output channel pairs 2t + 64m (hd <= 128) over all L
// keys in fp32. The sim map is read per image (b = bh / H), not per head,
// straight from device memory (each row once per head).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NWARPS = 16;      // warps per block (the wrapper's WARPS)
constexpr int JMAX = 9;         // keys per lane: L <= 288
constexpr int CMAX = 4;         // output channels per lane: hd <= 128
constexpr int ROWS_TARGET = 64; // query rows per block, about

enum Mode { VANILLA = 0, CLEARCLIP = 1, SCLIP = 2, SEGEARTH = 3, SFP = 4, EXPERIMENTAL = 5 };

// A 16-byte vector of T.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
// Two adjacent elements, loaded and stored.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float2 x) {
  *reinterpret_cast<float2*>(p) = x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// out[m] = (a[i] . b[j]) * scale for the lane's keys j = lane + 32m < L.
template <typename T>
__device__ __forceinline__ void score_row(const T* a, const T* b, int i, int L, int hd,
                                          int srow, float scale, int lane, float* out) {
  constexpr int N = Vec<T>::N;
  float acc[JMAX];
#pragma unroll
  for (int m = 0; m < JMAX; ++m) acc[m] = 0.f;
  const T* ar = a + (size_t)i * srow;
  for (int c = 0; c < hd; c += N) {
    float av[N];
    Vec<T>::load(ar + c, av);
#pragma unroll
    for (int m = 0; m < JMAX; ++m) {
      const int j = lane + 32 * m;
      if (j < L) {
        float bv[N];
        Vec<T>::load(b + (size_t)j * srow + c, bv);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[m] = fmaf(av[n], bv[n], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < JMAX; ++m) out[m] = acc[m] * scale;
}

// x[m] += sim_row[j] * w for the lane's valid keys.
__device__ __forceinline__ void add_sim(float* x, const float* sim_row, float w, int L,
                                        int lane) {
#pragma unroll
  for (int m = 0; m < JMAX; ++m) {
    const int j = lane + 32 * m;
    if (j < L) x[m] += sim_row[j] * w;
  }
}

// In-place softmax over the row's L keys; keys j >= L become 0.
__device__ __forceinline__ void softmax_row(float* x, int L, int lane) {
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < JMAX; ++m)
    if (lane + 32 * m < L) mx = fmaxf(mx, x[m]);
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < JMAX; ++m) {
    x[m] = (lane + 32 * m < L) ? expf(x[m] - mx) : 0.f;
    s += x[m];
  }
  s = warp_sum(s);
#pragma unroll
  for (int m = 0; m < JMAX; ++m) x[m] = x[m] / s;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NWARPS * 32, 2)
selfself_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ sim,
                          T* __restrict__ out, int H, int L, int hd, int rows_per_block,
                          float scale, float sim_weight) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = Vec<T>::N;
  constexpr bool NEED_K = MODE != CLEARCLIP;
  const int srow = hd + N;  // row stride in elements: 16 bytes of padding
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + (size_t)L * srow;
  T* sv = NEED_K ? sk + (size_t)L * srow : sk;
  float* wbuf = reinterpret_cast<float*>(sv + (size_t)L * srow) + warp * L;

  // stage the head's operands, 16 bytes per thread and step
  const size_t head = (size_t)bh * L * hd;
  const int vecs_per_row = hd / N;
  for (int e = threadIdx.x; e < L * vecs_per_row; e += NWARPS * 32) {
    const int r = e / vecs_per_row, c = (e % vecs_per_row) * N;
    const size_t src = head + (size_t)r * hd + c;
    const size_t dst = (size_t)r * srow + c;
    *reinterpret_cast<uint4*>(sq + dst) = *reinterpret_cast<const uint4*>(q + src);
    if (NEED_K) *reinterpret_cast<uint4*>(sk + dst) = *reinterpret_cast<const uint4*>(k + src);
    *reinterpret_cast<uint4*>(sv + dst) = *reinterpret_cast<const uint4*>(v + src);
  }
  __syncthreads();

  const int row0 = blockIdx.y * rows_per_block;
  const int row_end = min(L, row0 + rows_per_block);
  const float* sim_img = sim ? sim + (size_t)(bh / H) * L * L : nullptr;

  for (int i = row0 + warp; i < row_end; i += NWARPS) {
    const float* sim_row = sim_img ? sim_img + (size_t)i * L : nullptr;
    float p[JMAX], s[JMAX];
    if (MODE == VANILLA || MODE == CLEARCLIP) {
      score_row(sq, MODE == VANILLA ? sk : sq, i, L, hd, srow, scale, lane, p);
      if (sim_row) add_sim(p, sim_row, sim_weight, L, lane);
      softmax_row(p, L, lane);
    } else if (MODE == SCLIP || MODE == SEGEARTH) {
      score_row(sq, sq, i, L, hd, srow, scale, lane, p);
      if (sim_row) add_sim(p, sim_row, sim_weight, L, lane);
      softmax_row(p, L, lane);
      score_row(sk, sk, i, L, hd, srow, scale, lane, s);
      if (sim_row) add_sim(s, sim_row, sim_weight, L, lane);
      softmax_row(s, L, lane);
#pragma unroll
      for (int m = 0; m < JMAX; ++m) p[m] += s[m];
      if (MODE == SEGEARTH) {
        score_row(sv, sv, i, L, hd, srow, scale, lane, s);
        if (sim_row) add_sim(s, sim_row, sim_weight, L, lane);
        softmax_row(s, L, lane);
#pragma unroll
        for (int m = 0; m < JMAX; ++m) p[m] += s[m];
      }
    } else if (MODE == SFP) {
      score_row(sq, sq, i, L, hd, srow, scale, lane, p);
      score_row(sk, sk, i, L, hd, srow, scale, lane, s);
#pragma unroll
      for (int m = 0; m < JMAX; ++m) p[m] = 0.5f * (p[m] + s[m]);
      if (sim_row) add_sim(p, sim_row, sim_weight, L, lane);
      softmax_row(p, L, lane);
    } else {  // EXPERIMENTAL: the sim map joins after the first softmax
      score_row(sk, sk, i, L, hd, srow, scale, lane, p);
      score_row(sq, sq, i, L, hd, srow, scale, lane, s);
#pragma unroll
      for (int m = 0; m < JMAX; ++m) p[m] += s[m];
      softmax_row(p, L, lane);
      if (sim_row) add_sim(p, sim_row, sim_weight, L, lane);
      softmax_row(p, L, lane);
    }

    // the weights row to the warp's buffer, then lane t sums the channel
    // pairs 2t + 64m
#pragma unroll
    for (int m = 0; m < JMAX; ++m) {
      const int j = lane + 32 * m;
      if (j < L) wbuf[j] = p[m];
    }
    __syncwarp();
    float2 acc[CMAX / 2];
#pragma unroll
    for (int m = 0; m < CMAX / 2; ++m) acc[m] = make_float2(0.f, 0.f);
    for (int j = 0; j < L; ++j) {
      const float w = wbuf[j];
      const T* vr = sv + (size_t)j * srow;
#pragma unroll
      for (int m = 0; m < CMAX / 2; ++m) {
        const int c = 2 * lane + 64 * m;
        if (c < hd) {
          const float2 x = load2(vr + c);
          acc[m].x = fmaf(w, x.x, acc[m].x);
          acc[m].y = fmaf(w, x.y, acc[m].y);
        }
      }
    }
    __syncwarp();  // the buffer is rewritten by the next row
    T* orow = out + head + (size_t)i * hd;
#pragma unroll
    for (int m = 0; m < CMAX / 2; ++m) {
      const int c = 2 * lane + 64 * m;
      if (c < hd) store2(orow + c, acc[m]);
    }
  }
}

template <typename T, int MODE>
int launch(const T* q, const T* k, const T* v, const float* sim, T* out, int B, int H,
           int L, int hd, float scale, float sim_weight, cudaStream_t stream) {
  const int n_ops = MODE == CLEARCLIP ? 2 : 3;
  const size_t smem = (size_t)n_ops * L * (hd + Vec<T>::N) * sizeof(T)
                      + (size_t)NWARPS * L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(selfself_attention_kernel<T, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (L + ROWS_TARGET - 1) / ROWS_TARGET;
  const int rows_per_block = (L + tiles - 1) / tiles;
  const dim3 grid(B * H, tiles);
  selfself_attention_kernel<T, MODE><<<grid, NWARPS * 32, smem, stream>>>(
      q, k, v, sim, out, H, L, hd, rows_per_block, scale, sim_weight);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const float* sim, T* out, int B, int H,
             int L, int hd, int mode, float scale, float sim_weight, cudaStream_t stream) {
  switch (mode) {
    case VANILLA:
      return launch<T, VANILLA>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight, stream);
    case CLEARCLIP:
      return launch<T, CLEARCLIP>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight, stream);
    case SCLIP:
      return launch<T, SCLIP>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight, stream);
    case SEGEARTH:
      return launch<T, SEGEARTH>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight, stream);
    case SFP:
      return launch<T, SFP>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight, stream);
    case EXPERIMENTAL:
      return launch<T, EXPERIMENTAL>(q, k, v, sim, out, B, H, L, hd, scale, sim_weight,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rs_selfself_attention_f32(const float* q, const float* k, const float* v,
                                         const float* sim, float* out, int B, int H, int L,
                                         int hd, int mode, float scale, float sim_weight,
                                         cudaStream_t stream) {
  return dispatch(q, k, v, sim, out, B, H, L, hd, mode, scale, sim_weight, stream);
}
