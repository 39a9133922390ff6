// JBU stage epilogue (K2) and its classify variant (K3) on Hopper (sm_90a).
//
// Replaces the TPU kernels rs_ov/kernels/jbu_epilogue.py:jbu_epilogue_pallas
// (nhwc=True) and :jbu_epilogue_classify_pallas. Per output pixel:
//
//   comb  = softmax_t(logits * temp) * spatial;  comb /= max(sum_t comb, 1e-7)
//   fix   = W1 gelu(W0 [bf16(comb), guid] + b0) + b1
//   comb' = bf16(comb + 0.1 fix)
//   y[c]  = sum_t comb'[t] * inp[h+u, w+v, c]            (t = u*d + v, fp32)
//   K2:  out = bf16(y)
//   K3:  yb = bf16(y); res = bf16(bf16((yb Wf^T + bf) * 0.1) + yb)
//        rb = bf16(res * rsqrt(max(|res|^2, 1e-24)));  logits[q] = rb . bf16(Q[q])
//
// The casts sit where the TPU kernel puts them. The TPU kernel's lane
// artefacts (taps padded to 128 lanes, Q <= 128, d <= 17, 16 x 112 tiles, the
// rational erf) are not carried over: d, G, C and Q are runtime values and the
// GELU uses erff.
//
// What bounds it on the H100, at the main-path shapes (B=2, d=11, C=512,
// G=3): K2 at H=W=28 reads the padded bf16 source (2*38*38*512*2 B = 3.0 MB)
// and writes 1.6 MB, for 2*784*(121*512 + 30k) = 0.14 G multiply-adds; K3 at
// H=W=56 adds the 512 x 512 fixup product per pixel, 2*3136*512*512 = 1.6 G
// multiply-adds, which makes K3 compute-bound on the fp32 cores in this
// first version (no tensor cores yet: a later PR moves the products to wgmma).
//
// Design: one block of 256 threads per (b, row h, strip of 16 pixels).
//   Phase 1 (comb'): one warp per pixel for the tap softmax and normalisation,
//     then the two fixup 1x1 convs with threads over (pixel, output) pairs;
//     comb' lands in shared memory [16][d*d] as bf16-rounded floats.
//   Phase 2 (adaptive conv): threads over channel pairs (bf16x2 loads, so a
//     warp reads 128 consecutive bytes of one source pixel); each source
//     pixel of the strip's d x (16+d-1) window is loaded once and feeds every
//     output pixel whose window covers it, summing taps in order t = 0..d*d-1.
//   K3 tail: y goes to shared memory as bf16; the fixup product runs with
//     threads over output-channel pairs reading the transposed weight
//     [C_in][C_out] through L2 (512 KB at C=512); one warp per pixel reduces
//     the L2 norm; one warp per (pixel, query) takes each cosine dot product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PIX = 16;  // output pixels per block
constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;

struct EpiArgs {
  const __nv_bfloat16* inp;  // [B, H+d-1, W+d-1, C]
  const float* logits;       // [B, H, W, d*d]
  const __nv_bfloat16* guid; // [B, H, W, G]
  const float* spatial;      // [d*d]
  const float* temp;         // [1]
  const float* w0;           // [cmid, d*d+G]
  const float* b0;           // [cmid]
  const float* w1;           // [d*d, cmid]
  const float* b1;           // [d*d]
  int H, W, C, G, cmid, d;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// Phase 1: comb' of the strip's PIX pixels into s_comb [PIX][d*d].
__device__ void comb_phase(const EpiArgs& a, int b, int h, int w0,
                           float* s_comb, float* s_x, float* s_mid) {
  const int dd = a.d * a.d, nx = dd + a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float temp = *a.temp;

  for (int p = warp; p < PIX; p += NWARP) {
    float* c = s_comb + p * dd;
    float* x = s_x + p * nx;
    const int w = w0 + p;
    if (w >= a.W) {  // past the right edge: computed, never stored
      for (int t = lane; t < dd; t += 32) c[t] = 0.f;
      for (int i = lane; i < nx; i += 32) x[i] = 0.f;
      continue;
    }
    const float* lg = a.logits + (((size_t)b * a.H + h) * a.W + w) * dd;
    float m = -INFINITY;
    for (int t = lane; t < dd; t += 32) {
      const float s = lg[t] * temp;
      c[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < dd; t += 32) {
      const float e = expf(c[t] - m);
      c[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float sum2 = 0.f;
    for (int t = lane; t < dd; t += 32) {
      const float v = (c[t] / sum) * a.spatial[t];
      c[t] = v;
      sum2 += v;
    }
    sum2 = fmaxf(warp_sum(sum2), 1e-7f);
    for (int t = lane; t < dd; t += 32) {
      const float v = c[t] / sum2;
      c[t] = v;
      x[t] = bf16_round(v);  // comb -> guidance dtype for the fixup input
    }
    const __nv_bfloat16* g = a.guid + (((size_t)b * a.H + h) * a.W + w) * a.G;
    for (int i = lane; i < a.G; i += 32) x[dd + i] = __bfloat162float(g[i]);
  }
  __syncthreads();

  // fixup conv 1 + exact GELU; pixel index fastest so a warp shares weight rows
  for (int i = threadIdx.x; i < PIX * a.cmid; i += NT) {
    const int p = i % PIX, o = i / PIX;
    const float* wr = a.w0 + (size_t)o * nx;
    const float* xr = s_x + p * nx;
    float acc = 0.f;
    for (int j = 0; j < nx; ++j) acc = fmaf(wr[j], xr[j], acc);
    s_mid[p * a.cmid + o] = gelu_exact(acc + a.b0[o]);
  }
  __syncthreads();

  // fixup conv 2, residual, cast to bf16
  for (int i = threadIdx.x; i < PIX * dd; i += NT) {
    const int p = i % PIX, t = i / PIX;
    const float* wr = a.w1 + (size_t)t * a.cmid;
    const float* mr = s_mid + p * a.cmid;
    float acc = 0.f;
    for (int j = 0; j < a.cmid; ++j) acc = fmaf(wr[j], mr[j], acc);
    const float fix = acc + a.b1[t];
    s_comb[p * dd + t] = bf16_round(s_comb[p * dd + t] + __fmul_rn(0.1f, fix));
  }
  __syncthreads();
}

// Phase 2: adaptive conv of the strip; emit(c2, acc0, acc1) receives the fp32
// sums of channels 2*c2 and 2*c2+1 for every pixel of the strip.
template <typename Emit>
__device__ __forceinline__ void conv_phase(const EpiArgs& a, int b, int h, int w0,
                           const float* s_comb, Emit emit) {
  const int d = a.d, dd = d * d, C2 = a.C / 2;
  const int Hp = a.H + d - 1, Wp = a.W + d - 1;
  const int nxw = min(PIX + d - 1, Wp - w0);
  const __nv_bfloat162* in2 = reinterpret_cast<const __nv_bfloat162*>(a.inp);
  for (int c2 = threadIdx.x; c2 < C2; c2 += NT) {
    float acc0[PIX], acc1[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) acc0[p] = acc1[p] = 0.f;
    for (int u = 0; u < d; ++u) {
      const __nv_bfloat162* row = in2 + (((size_t)b * Hp + h + u) * Wp + w0) * C2 + c2;
      const float* cu = s_comb + u * d;
      for (int x = 0; x < nxw; ++x) {
        const float2 val = __bfloat1622float2(row[(size_t)x * C2]);
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          const int v = x - p;
          if (v >= 0 && v < d) {
            const float wt = cu[p * dd + v];
            acc0[p] = fmaf(wt, val.x, acc0[p]);
            acc1[p] = fmaf(wt, val.y, acc1[p]);
          }
        }
      }
    }
    emit(c2, acc0, acc1);
  }
}

__host__ __device__ inline size_t phase1_floats(int d, int G, int cmid) {
  const int dd = d * d;
  return (size_t)PIX * (dd + dd + G + cmid);
}

__global__ void __launch_bounds__(NT)
jbu_epilogue_kernel(EpiArgs a, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  const int dd = a.d * a.d;
  float* s_comb = smem;
  float* s_x = s_comb + PIX * dd;
  float* s_mid = s_x + PIX * (dd + a.G);
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * PIX;

  comb_phase(a, b, h, w0, s_comb, s_x, s_mid);

  const int C2 = a.C / 2;
  __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(out);
  conv_phase(a, b, h, w0, s_comb, [&](int c2, const float* acc0, const float* acc1) {
#pragma unroll
    for (int p = 0; p < PIX; ++p)
      if (w0 + p < a.W)
        out2[(((size_t)b * a.H + h) * a.W + w0 + p) * C2 + c2] =
            __floats2bfloat162_rn(acc0[p], acc1[p]);
  });
}

__global__ void __launch_bounds__(NT)
jbu_epilogue_classify_kernel(EpiArgs a, const __nv_bfloat16* __restrict__ fwt,
                             const float* __restrict__ fb,
                             const __nv_bfloat16* __restrict__ qf, int Q,
                             float* __restrict__ out) {
  extern __shared__ float smem[];
  const int dd = a.d * a.d, C = a.C, C2 = C / 2;
  float* s_comb = smem;
  float* s_x = s_comb + PIX * dd;
  float* s_mid = s_x + PIX * (dd + a.G);
  float* s_inv = smem + phase1_floats(a.d, a.G, a.cmid);
  __nv_bfloat162* s_y = reinterpret_cast<__nv_bfloat162*>(s_inv + PIX);  // [PIX][C2]
  __nv_bfloat162* s_r = s_y + PIX * C2;                                  // [PIX][C2]
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * PIX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  comb_phase(a, b, h, w0, s_comb, s_x, s_mid);
  conv_phase(a, b, h, w0, s_comb, [&](int c2, const float* acc0, const float* acc1) {
#pragma unroll
    for (int p = 0; p < PIX; ++p) s_y[p * C2 + c2] = __floats2bfloat162_rn(acc0[p], acc1[p]);
  });
  __syncthreads();

  // final fixup conv, scaled residual in bf16
  const __nv_bfloat16* s_yh = reinterpret_cast<const __nv_bfloat16*>(s_y);
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(fwt);
  for (int o2 = threadIdx.x; o2 < C2; o2 += NT) {
    float acc0[PIX], acc1[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) acc0[p] = acc1[p] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float2 wv = __bfloat1622float2(w2[(size_t)c * C2 + o2]);
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const float y = __bfloat162float(s_yh[p * C + c]);
        acc0[p] = fmaf(y, wv.x, acc0[p]);
        acc1[p] = fmaf(y, wv.y, acc1[p]);
      }
    }
    const float fb0 = fb[2 * o2], fb1 = fb[2 * o2 + 1];
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const float2 yv = __bfloat1622float2(s_y[p * C2 + o2]);
      s_r[p * C2 + o2] = __floats2bfloat162_rn(
          bf16_round(__fmul_rn(acc0[p] + fb0, 0.1f)) + yv.x,
          bf16_round(__fmul_rn(acc1[p] + fb1, 0.1f)) + yv.y);
    }
  }
  __syncthreads();

  // L2 norm per pixel
  for (int p = warp; p < PIX; p += NWARP) {
    float s = 0.f;
    for (int c2 = lane; c2 < C2; c2 += 32) {
      const float2 r = __bfloat1622float2(s_r[p * C2 + c2]);
      s = fmaf(r.x, r.x, fmaf(r.y, r.y, s));
    }
    s = warp_sum(s);
    if (lane == 0) s_inv[p] = rsqrtf(fmaxf(s, 1e-24f));
  }
  __syncthreads();

  // cosine logits against the queries
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qf);
  for (int pq = warp; pq < PIX * Q; pq += NWARP) {
    const int p = pq / Q, q = pq % Q;
    if (w0 + p >= a.W) continue;
    const float inv = s_inv[p];
    float s = 0.f;
    for (int c2 = lane; c2 < C2; c2 += 32) {
      const float2 r = __bfloat1622float2(s_r[p * C2 + c2]);
      const float2 qv = __bfloat1622float2(q2[(size_t)q * C2 + c2]);
      s = fmaf(bf16_round(r.x * inv), qv.x, fmaf(bf16_round(r.y * inv), qv.y, s));
    }
    s = warp_sum(s);
    if (lane == 0) out[(((size_t)b * a.H + h) * a.W + w0 + p) * Q + q] = s;
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" int rs_jbu_epilogue(const void* inp, const float* logits, const void* guid,
                               const float* spatial, const float* temp,
                               const float* w0, const float* b0, const float* w1,
                               const float* b1, void* out,
                               int B, int H, int W, int C, int G, int cmid, int d,
                               cudaStream_t stream) {
  EpiArgs a{static_cast<const __nv_bfloat16*>(inp), logits,
            static_cast<const __nv_bfloat16*>(guid), spatial, temp, w0, b0, w1, b1,
            H, W, C, G, cmid, d};
  const size_t smem = phase1_floats(d, G, cmid) * sizeof(float);
  if (int err = set_smem(jbu_epilogue_kernel, smem)) return err;
  dim3 grid((W + PIX - 1) / PIX, H, B);
  jbu_epilogue_kernel<<<grid, NT, smem, stream>>>(a, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

extern "C" int rs_jbu_epilogue_classify(const void* inp, const float* logits,
                                        const void* guid, const float* spatial,
                                        const float* temp, const float* w0,
                                        const float* b0, const float* w1,
                                        const float* b1, const void* fwt,
                                        const float* fb, const void* qf, float* out,
                                        int B, int H, int W, int C, int G, int cmid,
                                        int d, int Q, cudaStream_t stream) {
  EpiArgs a{static_cast<const __nv_bfloat16*>(inp), logits,
            static_cast<const __nv_bfloat16*>(guid), spatial, temp, w0, b0, w1, b1,
            H, W, C, G, cmid, d};
  const size_t smem = (phase1_floats(d, G, cmid) + PIX) * sizeof(float) +
                      2 * (size_t)PIX * C * sizeof(__nv_bfloat16);
  if (int err = set_smem(jbu_epilogue_classify_kernel, smem)) return err;
  dim3 grid((W + PIX - 1) / PIX, H, B);
  jbu_epilogue_classify_kernel<<<grid, NT, smem, stream>>>(
      a, static_cast<const __nv_bfloat16*>(fwt), fb,
      static_cast<const __nv_bfloat16*>(qf), Q, out);
  return (int)cudaGetLastError();
}
