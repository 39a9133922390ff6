// The fused-range JBU stage (K5a) and its classify variant (K5b) on Hopper
// (sm_90a). The split route's epilogue (K2) and its classify variant (K3)
// are jbu_classify_sm90.cu, on the tensor cores.
//
// Replaces the TPU kernels rs_ov/kernels/jbu_epilogue.py:jbu_epilogue_fused_pallas
// and :jbu_epilogue_fused_classify_pallas. Per output pixel:
//
//   comb  = softmax_t(logits * temp) * spatial;  comb /= max(sum_t comb, 1e-7)
//   fix   = W1 gelu(W0 [bf16(comb), guid] + b0) + b1
//   comb' = bf16(comb + 0.1 fix)
//   y[c]  = sum_t comb'[t] * inp[h+u-r, w+v-r, c]        (t = u*d + v, fp32)
//   K5a: out = bf16(y)
//   K5b: yb = bf16(y); res = bf16(bf16((yb Wf^T + bf) * 0.1) + yb)
//        rb = bf16(res * rsqrt(max(|res|^2, 1e-24)));  logits[q] = rb . bf16(Q[q])
//
// K5a / K5b are K2 / K3 for a whole stage: they take the UNpadded source
// [B, H, W, C] and the range projection proj [B, H, W, K] fp32, compute
//   logits[t] = sum_k proj[h, w, k] * proj[h+u-r, w+v-r, k]      (fp32)
// and read the source at h+u-r, w+v-r, both at reflected indices
// (i < 0 -> -i, i >= n -> 2n-2-i, which needs r <= n-1): the split route's
// range-logits kernel K1, its [B, H, W, d*d] logits round trip through
// device memory and both reflect pads disappear. Their guidance arrives
// channel-first, [B, G, H, W].
//
// The casts sit where the TPU kernels put them. The TPU kernels' lane
// artefacts (taps padded to 128 lanes, Q <= 128, d <= 17, K <= 128, 16 x 112
// tiles, the rational erf) are not carried over: d, K, G, C and Q are
// runtime values and the GELU uses erff.
//
// What bounds it on the H100, at the main-path shapes (B=2, d=11, C=512,
// G=3, K=32): K5a at H=W=28 reads the bf16 source (2*28*28*512*2 B = 1.6 MB)
// and writes 1.6 MB, for 2*784*(121*512 + 30k + 3.9k) = 0.15 G multiply-adds;
// K5b at H=W=56 adds the 512 x 512 fixup product per pixel, 2*3136*512*512 =
// 1.6 G multiply-adds, which makes it compute-bound on the fp32 cores in this
// first version (K3 has moved the same tail to mma.sync).
// K5 adds d*d*K = 3.9k fp32 multiply-adds per pixel to K2's 62k and saves
// K1's launch, the logits' write and read (3 MB at 56^2) and the pads.
//
// Design: one block of 256 threads per (b, row h, strip of 16 pixels).
//   Phase 0 (range logits): the strip's projection window,
//     d rows x (16+d-1) columns x K, is staged in shared memory at reflected
//     indices (K padded to an odd stride, so that lanes reading different taps
//     at one k hit different banks; 37 KB at d=11, K=32); one warp per pixel
//     then takes its d*d dot products over K, into the comb' buffer. The
//     window shares its shared memory with phase 1's scratch.
//   Phase 1 (comb'): one warp per pixel for the tap softmax and normalisation,
//     then the two fixup 1x1 convs with threads over (pixel, output) pairs;
//     comb' lands in shared memory [16][d*d] as bf16-rounded floats.
//   Phase 2 (adaptive conv): threads over channel pairs (bf16x2 loads, so a
//     warp reads 128 consecutive bytes of one source pixel); each source
//     pixel of the strip's d x (16+d-1) window is loaded once and feeds every
//     output pixel whose window covers it, summing taps in order t = 0..d*d-1,
//     from the unpadded source at reflected rows and columns.
//   K5b tail: y goes to shared memory as bf16; the fixup product runs with
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
  const __nv_bfloat16* inp;  // [B, H, W, C]
  const float* proj;         // [B, H, W, K]
  const __nv_bfloat16* guid; // [B, G, H, W]
  const float* spatial;      // [d*d]
  const float* temp;         // [1]
  const float* w0;           // [cmid, d*d+G]
  const float* b0;           // [cmid]
  const float* w1;           // [d*d, cmid]
  const float* b1;           // [d*d]
  int H, W, C, G, cmid, d, K;
};

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

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

__host__ __device__ inline int window_stride(int K) { return K | 1; }

// Phase 0: the raw range logits of the strip's PIX pixels into
// s_lg [PIX][d*d], from the projection window staged in s_win
// [d][PIX+d-1][K|1] at reflected indices (zeros past the right edge's reach,
// which only pixels past W read).
__device__ void range_phase(const EpiArgs& a, int b, int h, int w0,
                            float* s_lg, float* s_win) {
  const int d = a.d, r = d / 2, dd = d * d, K = a.K, ks = window_stride(K);
  const int nx = PIX + d - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < d * nx * K; i += NT) {
    const int k = i % K, x = (i / K) % nx, u = i / (K * nx);
    const int col = w0 - r + x;
    float v = 0.f;
    if (col <= a.W - 1 + r) {
      const int hr = reflect(h - r + u, a.H), wr = reflect(col, a.W);
      v = a.proj[(((size_t)b * a.H + hr) * a.W + wr) * K + k];
    }
    s_win[(u * nx + x) * ks + k] = v;
  }
  __syncthreads();
  for (int p = warp; p < PIX; p += NWARP) {
    const float* ctr = s_win + (r * nx + p + r) * ks;
    for (int t = lane; t < dd; t += 32) {
      const float* nb = s_win + ((t / d) * nx + p + t % d) * ks;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc = fmaf(ctr[k], nb[k], acc);
      s_lg[p * dd + t] = acc;
    }
  }
  __syncthreads();  // phase 1 overwrites the window
}

// Phase 1: comb' of the strip's PIX pixels into s_comb [PIX][d*d], from the
// logits that phase 0 left there.
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
    float m = -INFINITY;
    for (int t = lane; t < dd; t += 32) {
      const float s = c[t] * temp;
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
    for (int i = lane; i < a.G; i += 32) {
      const size_t gi = (((size_t)b * a.G + i) * a.H + h) * a.W + w;
      x[dd + i] = __bfloat162float(a.guid[gi]);
    }
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
// sums of channels 2*c2 and 2*c2+1 for every pixel of the strip, read from
// the unpadded source at the reflected (h+u-r, w0+x-r).
template <typename Emit>
__device__ __forceinline__ void conv_phase(const EpiArgs& a, int b, int h, int w0,
                           const float* s_comb, Emit emit) {
  const int d = a.d, r = d / 2, dd = d * d, C2 = a.C / 2;
  const int nxw = min(PIX + d - 1, a.W + d - 1 - w0);
  const __nv_bfloat162* in2 = reinterpret_cast<const __nv_bfloat162*>(a.inp);
  for (int c2 = threadIdx.x; c2 < C2; c2 += NT) {
    float acc0[PIX], acc1[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) acc0[p] = acc1[p] = 0.f;
    for (int u = 0; u < d; ++u) {
      const int hs = reflect(h + u - r, a.H);
      const __nv_bfloat162* row = in2 + ((size_t)b * a.H + hs) * a.W * C2 + c2;
      const float* cu = s_comb + u * d;
      for (int x = 0; x < nxw; ++x) {
        const int ws = reflect(w0 + x - r, a.W);
        const float2 val = __bfloat1622float2(row[(size_t)ws * C2]);
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

// K5's shared memory: comb' beside the larger of the epilogue's own floats
// past it and the projection window, which lies where phase 1's scratch will
inline size_t fused_floats(size_t epilogue_floats, int d, int K) {
  const size_t window = (size_t)PIX * d * d + (size_t)d * (PIX + d - 1) * window_stride(K);
  return epilogue_floats > window ? epilogue_floats : window;
}

__global__ void __launch_bounds__(NT)
jbu_epilogue_kernel(EpiArgs a, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  const int dd = a.d * a.d;
  float* s_comb = smem;
  float* s_x = s_comb + PIX * dd;
  float* s_mid = s_x + PIX * (dd + a.G);
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * PIX;

  range_phase(a, b, h, w0, s_comb, s_x);
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

  range_phase(a, b, h, w0, s_comb, s_x);
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

int launch_epilogue(const EpiArgs& a, void* out, int B, cudaStream_t stream) {
  size_t floats = phase1_floats(a.d, a.G, a.cmid);
  floats = fused_floats(floats, a.d, a.K);
  const size_t smem = floats * sizeof(float);
  if (int err = set_smem(jbu_epilogue_kernel, smem)) return err;
  dim3 grid((a.W + PIX - 1) / PIX, a.H, B);
  jbu_epilogue_kernel<<<grid, NT, smem, stream>>>(a, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

int launch_classify(const EpiArgs& a, const void* fwt, const float* fb, const void* qf,
                    float* out, int B, int Q, cudaStream_t stream) {
  // s_inv [PIX] and s_y, s_r [PIX][C] bf16 after phase 1's floats
  size_t floats = phase1_floats(a.d, a.G, a.cmid) + PIX + (size_t)PIX * a.C;
  floats = fused_floats(floats, a.d, a.K);
  const size_t smem = floats * sizeof(float);
  if (int err = set_smem(jbu_epilogue_classify_kernel, smem)) return err;
  dim3 grid((a.W + PIX - 1) / PIX, a.H, B);
  jbu_epilogue_classify_kernel<<<grid, NT, smem, stream>>>(
      a, static_cast<const __nv_bfloat16*>(fwt), fb,
      static_cast<const __nv_bfloat16*>(qf), Q, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rs_jbu_epilogue_fused(const void* inp, const float* proj, const void* guid,
                                     const float* spatial, const float* temp,
                                     const float* w0, const float* b0, const float* w1,
                                     const float* b1, void* out,
                                     int B, int H, int W, int C, int G, int cmid, int d,
                                     int K, cudaStream_t stream) {
  EpiArgs a{static_cast<const __nv_bfloat16*>(inp), proj,
            static_cast<const __nv_bfloat16*>(guid), spatial, temp, w0, b0, w1, b1,
            H, W, C, G, cmid, d, K};
  return launch_epilogue(a, out, B, stream);
}

extern "C" int rs_jbu_epilogue_fused_classify(const void* inp, const float* proj,
                                              const void* guid, const float* spatial,
                                              const float* temp, const float* w0,
                                              const float* b0, const float* w1,
                                              const float* b1, const void* fwt,
                                              const float* fb, const void* qf, float* out,
                                              int B, int H, int W, int C, int G, int cmid,
                                              int d, int K, int Q, cudaStream_t stream) {
  EpiArgs a{static_cast<const __nv_bfloat16*>(inp), proj,
            static_cast<const __nv_bfloat16*>(guid), spatial, temp, w0, b0, w1, b1,
            H, W, C, G, cmid, d, K};
  return launch_classify(a, fwt, fb, qf, out, B, Q, stream);
}
