// The JBU stage epilogue (K2), the last stage's epilogue with the classify
// tail (K3), and both as a whole fused-range stage (K5a, K5b), on Hopper's
// tensor cores (sm_90a).
//
// Replaces the TPU kernels rs_ov/kernels/jbu_epilogue.py:jbu_epilogue_pallas
// (nhwc=True; K2), :jbu_epilogue_classify_pallas (K3),
// :jbu_epilogue_fused_pallas (K5a) and :jbu_epilogue_fused_classify_pallas
// (K5b). Per output pixel:
//
//   comb  = softmax_t(logits * temp) * spatial;  comb /= max(sum_t comb, 1e-7)
//   fix   = W1 gelu(W0 [bf16(comb), guid] + b0) + b1            (fp32)
//   comb' = bf16(comb + 0.1 fix)
//   y[c]  = sum_t comb'[t] * inp[h+u, w+v, c]                   (t = u*d + v)
//   K2: out = bf16(y)
//   K3: yb = bf16(y); res = bf16(bf16((yb Wf^T + bf) * 0.1) + yb)
//       rb = bf16(res * rsqrt(max(|res|^2, 1e-24)));  logits[q] = rb . bf16(Q[q])
//
// K5a / K5b are K2 / K3 for a whole stage: from the UNpadded source [B, H, W,
// C] and the range projection proj [B, H, W, K] fp32 they compute the logits
// themselves (phase 0 below),
//   logits[t] = sum_k proj[h, w, k] * proj[h+u-r, w+v-r, k]      (r = d / 2)
// and read the source at h+u-r, w+v-r, both at reflected indices (i < 0 ->
// -i, i >= n -> 2n-2-i, which needs r <= n-1): the split route's range-logits
// kernel K1, its logits' round trip through device memory and both reflect
// pads disappear. Their guidance arrives channel-first, [B, G, H, W]. Every
// other phase is K2's / K3's, the same device functions on the same blocks,
// so that K5a / K5b equal K1 + pads + K2 / K3 bit for bit.
//
// The operands of the three products (the adaptive conv, the C x C fixup
// product and the cosine) are bf16, and a product of two bf16 values is exact
// in fp32, so mma.sync with fp32 accumulation computes the same function; only
// the order of the sums differs. The range MLP stays fp32 on the fp32 cores.
// Where the order shows: a sum rounded to bf16 (y, and t = (yb Wf^T + bf) *
// 0.1) that lands within NEAR fp32 ulps of a bf16 rounding midpoint may round
// to the other neighbour than the same sum taken in order, and one such flip
// moves a logit by up to ~1e-3 of the largest. Those sums (~0.4% of them) are
// taken again in order on the fp32 cores, as the plain version takes them;
// so K2's y rounds as the tap-ordered sum does.
//
// What bounds it on the H100, at the main path's shapes (B=2, d=11, C=512,
// G=3, Q=8): K3 at 56^2: 2*6272*512*512 = 3.3 G operations of the fixup
// product and the banded conv's ~2.3 G, both bf16 operands (~6 us at
// mma.sync's rate), the fp32 range MLP's 0.37 G (~6 us), and ~12 MB of bytes
// (~4 us). K2 at 28^2 reads the padded source (3.0 MB) and the logits (0.8
// MB) and writes 1.6 MB (1.6 us), for 0.19 G conv and 0.09 G MLP operations;
// at d=7, 112^2 (jbu_stack) 59 MB of bytes (18 us). K5 reads the unpadded
// source and the projection (0.2 MB at 28^2, K = 32) in place of the padded
// source and the logits, for 2*121*32 = 7.7 k more fp32 operations a pixel.
// The first versions on the fp32 cores were latency-bound instead: 16 pixels
// per block, K3's and K5b's blocks each re-reading the whole 512 KB fixup
// weight through L2.
//
// Design: K2, K3, K5a and K5b alike, one block of 256 threads (8 warps) per
// (b, R = 2 output rows x 16 columns) over all of C, M = 32 pixels; two
// blocks per SM at d <= 11 and C = 512 (113 KB of shared memory each). R = 2
// beat R = 1 and R = 4 for K3 on the H100, and beat R = 1 and splitting the
// channels across blocks for K2 at 28^2 and 112^2 (PERF.md).
//   range logits (K5a, K5b; phase 0): the block's projection window, rows
//     h0-r .. h0+R-1+r by columns w0-r .. w0+15+r at reflected indices (zeros
//     past the reach of the image's pixels), is staged by cp.async KCH = 32
//     channels at a time as [R+d-1][16+d-1][ks] fp32, one pixel's channels
//     contiguous (16-byte copies where K % 4 == 0, else 4-byte ones; ks / 4
//     odd, so 16-byte reads of 8 neighbouring window pixels hit distinct
//     banks); one thread per (pixel, tap) then sums its K products in channel
//     order with one fma each from 0, as K1 does, across the chunks, into the
//     comb' scratch [M][d*d] that the tap softmax reads. The window (45 KB at
//     d = 11, K = 32; 83 KB at d = 17) lies past those logits in the work
//     region, which the conv's ring and the tail take over afterwards, so the
//     block's shared memory does not grow.
//   comb': one warp per pixel for the tap softmax and normalisation; the two
//     fixup 1x1 convs as register-tiled products (4 pixels x 4 outputs per
//     thread) over weight chunks of KC input rows staged in shared memory;
//     comb' lands in shared memory as bf16 [M][d*d].
//   conv: the TPU kernel's banded product, on mma.sync. For output row j
//     and tap row u, A is the band [16 px][32 x] bf16 with A[p][x] =
//     comb'[p][u d + x - p] for 0 <= x - p < d (16 + d - 1 <= 32 for
//     d <= 17), built in registers from comb'; B is the padded source row
//     h0 + j + u, columns w0 .. w0+31, by a chunk of CCH channels (K5: the
//     unpadded source's reflected row and columns), staged by
//     cp.async in a ring of two rows: each of the R + d - 1 source rows is
//     loaded once per chunk and feeds every output row j it reaches. Each
//     warp owns CCH/8 channels for all R rows; the fp32 sums are rounded to
//     bf16 into y [M][Cp]. The band wastes (16 + d - 1)/d of the products,
//     the trade the TPU kernel makes too. K2 then writes y out, 16 bytes a
//     thread.
//   fixup product (K3): A = yb [M][Cp] bf16 in shared memory (ldmatrix), B =
//     the fixup weight as the caller holds it, [C_out][C_in], which is mma's
//     .col layout of [k][n]: streamed by cp.async in [128 n][64 k] stages,
//     double buffered; each warp owns 16 output columns of a 128-wide chunk
//     for all M rows. The epilogue adds the bias, scales, rounds and adds yb
//     into res [M][Cp] bf16.
//   norm (K3): one warp per pixel; rb = bf16(res * inv) in place.
//   cosine (K3): the same streamed product with B = the queries [Q][C] (Q <=
//     128, one chunk), written as fp32 [B, H, W, Q].
//   repairs: the sums near a midpoint are queued in shared memory and taken
//     again in order after the conv and after the fixup product, one per
//     thread; past QCAP of them, every sum of the phase is taken again.
// Channels past C (up to Cp = C rounded up to 128) and queries past Q are
// zero-filled in the staged operands; pixels past W or H are computed on
// zeros and never stored. C must be even; a multiple of 8 (with 16-byte
// aligned operands) takes 16-byte copies, any other even C 4-byte copies.
// d <= 17 (odd for K5), Q <= 128, any K >= 1, the TPU kernels' limits but
// K's; a block whose shared memory does not fit is refused (see launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace rs_ov;

constexpr int NT = 256;  // threads per block
constexpr int ROWS = 2;  // output rows per block
constexpr int NWARP = NT / 32;
constexpr int COLS = 16;  // output columns per block
constexpr int KC = 32;    // input rows of a fixup-MLP weight chunk
constexpr int NB = 128;   // output columns of a tail stage
constexpr int KB = 64;    // reduction depth of a tail stage
constexpr int KBS = KB + 8;  // row stride of a tail stage (bf16): conflict-free ldmatrix
constexpr int MAXD = 17;       // the largest diameter (16 + d - 1 <= 32 columns)
constexpr int QCAP = 512;      // rounding repairs a block queues (past it: all are redone)
constexpr int KCH = 32;        // projection channels of a staged window chunk (K5)
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper
constexpr uint32_t NEAR = 128;  // fp32 ulps from a bf16 rounding midpoint that count as near

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* inp;      // [B, H+d-1, W+d-1, C]; K5: [B, H, W, C]
  const float* logits;  // [B, H, W, d*d]; K5: none
  const bf16* guid;     // [B, H, W, G]; K5: [B, G, H, W]
  const float* spatial; // [d*d]
  const float* temp;    // [1]
  const void* w0;       // [cmid, d*d+G]   (w0, b0, w1, b1 and K3's fb: all fp32 or all bf16)
  const void* b0;       // [cmid]
  const void* w1;       // [d*d, cmid]
  const void* b1;       // [d*d]
  const bf16* fw;       // [C, C] (out, in) (K3)
  const void* fb;       // [C] (K3)
  const void* qf;       // [Q, C], fp32 or bf16 (K3)
  void* out;            // K2, K5a: [B, H, W, C] bf16; K3, K5b: [B, H, W, Q] fp32
  int H, W, C, G, cmid, d, Q;
  int wbf16, qbf16;     // the weights' and the queries' dtype: 1 for bf16
  const float* proj;    // K5: [B, H, W, K]
  int K;                // K5: projection channels (0 for K2, K3)
  int pvec;             // K5: 1 where proj takes 16-byte copies
};

// channels of a conv chunk: each warp's CCH/8 of them for all R rows
constexpr int CCH = 512;

__host__ __device__ inline size_t up128(size_t x) { return (x + 127) & ~(size_t)127; }
__host__ __device__ inline size_t maxz(size_t a, size_t b) { return a > b ? a : b; }

// fp32 stride of one window pixel for a chunk of kc channels: a multiple of
// 4 (16-byte copies) with an odd count of 16-byte units (conflict-free reads)
__host__ __device__ inline int win_stride(int kc) { return 4 * (((kc + 3) / 4) | 1); }

// Byte offsets of a block's shared memory. y and comb' live throughout; the
// work region holds in turn (K5) the logits with the projection window past
// them, the comb' scratch (which starts with those logits), the conv's ring,
// and (K3, K5b) res with the tail stages. K = 0 for K2 and K3.
struct Layout {
  int M, Cp, ldy, nin, ldw;
  size_t y, cb, queue, work;  // regions
  size_t comb, xT, midT, w;  // in work: comb' scratch
  size_t win;                // in work: K5's projection window, past the logits
  size_t ring;               // in work: the conv's two staged source rows
  size_t res, bst;           // in work: the tail
  size_t bytes;
};

__host__ __device__ inline Layout make_layout(int d, int G, int cmid, int C, int K) {
  Layout L;
  const int dd = d * d;
  L.M = COLS * ROWS;
  L.Cp = (C + 127) / 128 * 128;
  L.ldy = L.Cp + 8;
  L.nin = dd + G;
  const int nout = cmid > dd ? cmid : dd;
  L.ldw = (nout + 3) / 4 * 4 + 1;  // odd: the staging writes hit distinct banks
  size_t off = 0;
  L.y = off;   off += up128((size_t)L.M * L.ldy * 2);
  L.cb = off;  off += up128((size_t)L.M * dd * 2);
  L.queue = off;  off += up128(4 * (1 + QCAP));
  L.work = off;
  size_t p = 0;
  L.comb = p;  p += up128((size_t)L.M * dd * 4);
  L.xT = p;    p += up128((size_t)L.nin * L.M * 4);
  L.midT = p;  p += up128((size_t)cmid * L.M * 4);
  L.w = p;     p += up128((size_t)KC * L.ldw * 4);
  size_t work = p;
  L.win = L.xT;
  if (K > 0)
    work = maxz(work, L.win + up128((size_t)(ROWS + d - 1) * (COLS + d - 1) *
                                    win_stride(K < KCH ? K : KCH) * 4));
  L.ring = 0;
  work = maxz(work, 2 * up128((size_t)32 * (CCH + 8) * 2));
  p = 0;
  L.res = p;   p += up128((size_t)L.M * L.ldy * 2);
  L.bst = p;   p += 2 * up128((size_t)NB * KBS * 2);
  work = maxz(work, p);
  L.bytes = off + work;
  return L;
}

// element i of an fp32 (bf16 = 0) or bf16 (bf16 = 1) array, as fp32
__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
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

// Whether v lies within NEAR fp32 ulps of a bf16 rounding midpoint, where the
// same sum taken in another order may round to the other bf16 neighbour.
__device__ __forceinline__ bool near_midpoint(float v) {
  return (__float_as_uint(v) & 0xffffu) + NEAR - 0x8000u < 2 * NEAR;
}

// Queue a repair: q[0] counts, q[1..QCAP] hold the first QCAP items; a
// count past QCAP asks for every sum of the phase to be redone.
__device__ __forceinline__ void queue_push(int* q, int item) {
  const int i = atomicAdd(q, 1);
  if (i < QCAP) q[1 + i] = item;
}

// out[o][p] = sum_k W[o][k] in[k][p] for o < nout, p < M: W [nout][nin]
// (fp32 or bf16) in device memory, staged KC input rows at a time as s_w
// [KC][ldw] (transposed); in as s_inT [nin][M]. Each thread holds 4 outputs
// x 4 pixels; epi(o, p, sum) receives every sum, summed over k in order.
template <int M, typename Epi>
__device__ void mlp_layer(const void* wg, int wbf16, int nout, int nin, int ldw,
                          const float* s_inT, float* s_w, Epi epi) {
  constexpr int PG = M / 4;
  const int ntile = PG * ((nout + 3) / 4);
  for (int base = 0; base < ntile; base += NT) {
    const int tile = base + threadIdx.x;
    const int pg = tile % PG, og = tile / PG;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int k0 = 0; k0 < nin; k0 += KC) {
      const int kn = min(KC, nin - k0);
      __syncthreads();  // the previous chunk (or the inputs' writers) done
      for (int i = threadIdx.x; i < kn * nout; i += NT) {
        const int kk = i % kn, o = i / kn;
        s_w[kk * ldw + o] = ld(wg, (size_t)o * nin + k0 + kk, wbf16);
      }
      __syncthreads();
      if (tile < ntile) {
        for (int kk = 0; kk < kn; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(s_inT + (k0 + kk) * M + pg * 4);
          const float* wr = s_w + kk * ldw + og * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = wr[i];
            acc[i][0] = fmaf(wv, x.x, acc[i][0]);
            acc[i][1] = fmaf(wv, x.y, acc[i][1]);
            acc[i][2] = fmaf(wv, x.z, acc[i][2]);
            acc[i][3] = fmaf(wv, x.w, acc[i][3]);
          }
        }
      }
    }
    if (tile < ntile) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = og * 4 + i;
        if (o < nout) {
#pragma unroll
          for (int q = 0; q < 4; ++q) epi(o, pg * 4 + q, acc[i][q]);
        }
      }
    }
  }
}

// i reflected into 0 .. n-1 (i < 0 -> -i, i >= n -> 2n-2-i), for -n < i < 2n-1
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// K5's phase 0: the raw range logits of the block's M pixels into the comb'
// scratch [M][d*d] fp32, logits[m][u d + v] = sum_k proj[h, w, k] *
// proj[h+u-r, w+v-r, k], each summed over k in order with one fma a
// channel from 0, as K1 sums it. The projection window (see the header) is
// staged KCH channels at a time; each thread takes (pixel, tap) pairs.
template <int R>
__device__ void range_phase(const Args& a, const Layout& L, int b, int h0, int w0,
                            unsigned char* work) {
  constexpr int M = COLS * R;
  const int d = a.d, r = d / 2, dd = d * d, nx = COLS + d - 1, ny = R + d - 1;
  float* s_lg = reinterpret_cast<float*>(work + L.comb);
  float* s_win = reinterpret_cast<float*>(work + L.win);
  const int vec = a.pvec ? 4 : 1;
  for (int k0 = 0; k0 < a.K; k0 += KCH) {
    const int kc = min(KCH, a.K - k0), ks = win_stride(kc), per = kc / vec;
    for (int i = threadIdx.x; i < ny * nx * per; i += NT) {
      const int pos = i / per, k = i % per * vec, hs = h0 - r + pos / nx, ws = w0 - r + pos % nx;
      const bool ok = hs < a.H + r && ws < a.W + r;  // within reach of a pixel of the image
      const float* src =
          ok ? a.proj + (((size_t)b * a.H + reflect(hs, a.H)) * a.W + reflect(ws, a.W)) * a.K +
                   k0 + k
             : a.proj;
      if (a.pvec)
        cp_async16(s_win + pos * ks + k, src, ok ? 16 : 0);
      else
        cp_async4(s_win + pos * ks + k, src, ok ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < M * dd; i += NT) {
      const int m = i / dd, t = i % dd, j = m / COLS, p = m % COLS;
      const float* c = s_win + ((j + r) * nx + p + r) * ks;
      const float* n = s_win + ((j + t / d) * nx + p + t % d) * ks;
      float acc = k0 ? s_lg[i] : 0.f;
      int k = 0;
      for (; k + 4 <= kc; k += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(c + k);
        const float4 nv = *reinterpret_cast<const float4*>(n + k);
        acc = fmaf(nv.x, cv.x, acc);
        acc = fmaf(nv.y, cv.y, acc);
        acc = fmaf(nv.z, cv.z, acc);
        acc = fmaf(nv.w, cv.w, acc);
      }
      for (; k < kc; ++k) acc = fmaf(n[k], c[k], acc);
      s_lg[i] = acc;
    }
    __syncthreads();  // the window is restaged, or comb_phase reuses its memory
  }
}

// comb' of the block's M pixels into s_cb [M][d*d] bf16. K5 (kFused) finds
// its logits in the comb' scratch (range_phase) and its guidance
// channel-first.
template <int R, bool kFused>
__device__ void comb_phase(const Args& a, const Layout& L, int b, int h0, int w0,
                           unsigned char* work, bf16* s_cb) {
  constexpr int M = COLS * R;
  const int dd = a.d * a.d, nin = L.nin;
  float* s_comb = reinterpret_cast<float*>(work + L.comb);  // [M][dd]
  float* s_xT = reinterpret_cast<float*>(work + L.xT);      // [nin][M]
  float* s_midT = reinterpret_cast<float*>(work + L.midT);  // [cmid][M]
  float* s_w = reinterpret_cast<float*>(work + L.w);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float temp = *a.temp;

  for (int m = warp; m < M; m += NWARP) {
    float* c = s_comb + m * dd;
    const int h = h0 + m / COLS, w = w0 + m % COLS;
    if (h >= a.H || w >= a.W) {  // past the edge: computed, never stored
      for (int t = lane; t < dd; t += 32) c[t] = 0.f;
      for (int i = lane; i < nin; i += 32) s_xT[i * M + m] = 0.f;
      continue;
    }
    const float* lg = kFused ? c : a.logits + (((size_t)b * a.H + h) * a.W + w) * dd;
    float mx = -INFINITY;
    for (int t = lane; t < dd; t += 32) {
      const float s = lg[t] * temp;
      c[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < dd; t += 32) {
      const float e = expf(c[t] - mx);
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
      s_xT[t * M + m] = bf16_round(v);  // comb -> guidance dtype for the fixup input
    }
    for (int i = lane; i < a.G; i += 32)
      s_xT[(dd + i) * M + m] = __bfloat162float(
          a.guid[kFused ? (((size_t)b * a.G + i) * a.H + h) * a.W + w
                        : (((size_t)b * a.H + h) * a.W + w) * a.G + i]);
  }

  // fixup conv 1 + exact GELU, then conv 2, the residual and the cast
  mlp_layer<M>(a.w0, a.wbf16, a.cmid, nin, L.ldw, s_xT, s_w, [&](int o, int p, float acc) {
    s_midT[o * M + p] = gelu_exact(acc + ld(a.b0, o, a.wbf16));
  });
  mlp_layer<M>(a.w1, a.wbf16, dd, a.cmid, L.ldw, s_midT, s_w, [&](int t, int p, float acc) {
    const float fix = acc + ld(a.b1, t, a.wbf16);
    s_cb[p * dd + t] = __float2bfloat16_rn(s_comb[p * dd + t] + __fmul_rn(0.1f, fix));
  });
  __syncthreads();
}

// Channel 0 of the padded source at (b, hs, ws), hs < H+d-1, ws < W+d-1;
// K5 (kFused) reads the unpadded source at the reflected (hs - r, ws - r).
template <bool kFused>
__device__ __forceinline__ const bf16* src_at(const Args& a, int b, int hs, int ws) {
  if (kFused) {
    const int r = a.d / 2;
    return a.inp + (((size_t)b * a.H + reflect(hs - r, a.H)) * a.W + reflect(ws - r, a.W)) * a.C;
  }
  return a.inp + (((size_t)b * (a.H + a.d - 1) + hs) * (a.W + a.d - 1) + ws) * a.C;
}

// Source row hs of the padded source, columns w0 .. w0+31, channels c0 ..
// c0+cw-1, into dst [32][ldr] (zeros past the source's edges and C).
template <bool kVec16, bool kFused>
__device__ __forceinline__ void stage_row(bf16* dst, const Args& a, int b, int hs, int w0,
                                          int c0, int cw, int ldr) {
  const int Hp = a.H + a.d - 1, Wp = a.W + a.d - 1;
  const int vec = kVec16 ? 8 : 2, per = cw / vec;
  for (int i = threadIdx.x; i < 32 * per; i += NT) {
    const int x = i / per, c = (i % per) * vec;
    const bool ok = hs < Hp && w0 + x < Wp && c0 + c < a.C;
    const bf16* src = ok ? src_at<kFused>(a, b, hs, w0 + x) + c0 + c : a.inp;
    if (kVec16)
      cp_async16(dst + x * ldr + c, src, ok ? 16 : 0);
    else
      cp_async4(dst + x * ldr + c, src, ok ? 4 : 0);
  }
}

// y[c] of output pixel (h, w) summed in tap order, one rounding per tap, as
// the plain version sums it; taps: the pixel's comb'.
template <bool kFused>
__device__ float conv_seq(const Args& a, const unsigned short* taps, int b, int h, int w,
                          int c) {
  const int d = a.d;
  float x[MAXD], nx[MAXD];  // a tap row's source values, and the next row's in flight
#pragma unroll
  for (int v = 0; v < MAXD; ++v)
    x[v] = v < d ? __bfloat162float(src_at<kFused>(a, b, h, w + v)[c]) : 0.f;
  float s = 0.f;
  for (int u = 0; u < d; ++u) {
    const int un = u + 1 < d ? u + 1 : u;
#pragma unroll
    for (int v = 0; v < MAXD; ++v)
      nx[v] = v < d ? __bfloat162float(src_at<kFused>(a, b, h + un, w + v)[c]) : 0.f;
#pragma unroll
    for (int v = 0; v < MAXD; ++v)
      if (v < d)
        s = __fadd_rn(s, __bfloat162float(__ushort_as_bfloat16(taps[u * d + v])) * x[v]);
#pragma unroll
    for (int v = 0; v < MAXD; ++v) x[v] = nx[v];
  }
  return s;
}

// Adaptive conv of the block's R rows into s_y [M][ldy] bf16 (channels past
// C zero), as banded products on mma.sync. A sum that lands near a bf16
// rounding midpoint is taken again in tap order (queued in q, repaired after
// the loop), so that y rounds as the plain version's sum does.
template <int R, bool kVec16, bool kFused>
__device__ void conv_phase(const Args& a, const Layout& L, int b, int h0, int w0,
                           const bf16* s_cb, bf16* s_y, unsigned char* work, int* q) {
  constexpr int NTW = CCH / 64, LDR = CCH + 8;
  const int d = a.d, dd = d * d, nrow = R + d - 1;
  const int steps = (L.Cp + CCH - 1) / CCH * nrow;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const unsigned short* cb = reinterpret_cast<const unsigned short*>(s_cb);
  bf16* ring = reinterpret_cast<bf16*>(work + L.ring);
  float acc[R][NTW][4];
  stage_row<kVec16, kFused>(ring, a, b, h0, w0, 0, min(CCH, L.Cp), LDR);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int r = s % nrow, c0 = s / nrow * CCH, cw = min(CCH, L.Cp - c0);
    if (s + 1 < steps) {
      const int cn = (s + 1) / nrow * CCH;
      stage_row<kVec16, kFused>(ring + ((s + 1) & 1) * 32 * LDR, a, b, h0 + (s + 1) % nrow, w0,
                                cn, min(CCH, L.Cp - cn), LDR);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (r == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int t = 0; t < NTW; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
    }
    const bf16* row = ring + (s & 1) * 32 * LDR;
    const int ww = cw / NWARP, npair = ww / 16, nb = warp * ww;  // the warp's channels
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int u = r - j;  // the tap row through which source row r reaches row j
        if (u >= 0 && u < d)
          band_fragment(af[j], cb + j * COLS * dd + u * d, dd, d, ks * 16 + 2 * tq, g);
      }
#pragma unroll
      for (int pr = 0; pr < NTW / 2; ++pr) {
        if (pr < npair) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, row + (ks * 16 + (lane & 15)) * LDR + nb + pr * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int u = r - j;
            if (u >= 0 && u < d) {
              mma_bf16(acc[j][2 * pr], af[j], bfr[0], bfr[1]);
              mma_bf16(acc[j][2 * pr + 1], af[j], bfr[2], bfr[3]);
            }
          }
        }
      }
    }
    if (r == nrow - 1) {
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          if (t < 2 * npair) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int c = c0 + nb + t * 8 + 2 * tq, m = j * COLS + g + 8 * hf;
              float v[2] = {acc[j][t][2 * hf], acc[j][t][2 * hf + 1]};
              const bool in = h0 + j < a.H && w0 + m % COLS < a.W && c < a.C;
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (in && near_midpoint(v[e])) queue_push(q, (m << 16) | (c + e));
              *reinterpret_cast<__nv_bfloat162*>(s_y + m * L.ldy + c) =
                  __floats2bfloat162_rn(v[0], v[1]);
            }
          }
        }
    }
    __syncthreads();  // the row is refilled two steps on
  }
  const bool all = q[0] > QCAP;
  for (int i = threadIdx.x; i < (all ? R * COLS * a.C : q[0]); i += NT) {
    const int m = all ? i / a.C : q[1 + i] >> 16, c = all ? i % a.C : q[1 + i] & 0xffff;
    if (h0 + m / COLS < a.H && w0 + m % COLS < a.W)
      s_y[m * L.ldy + c] = __float2bfloat16_rn(
          conv_seq<kFused>(a, cb + m * dd, b, h0 + m / COLS, w0 + m % COLS, c));
  }
  __syncthreads();
  if (threadIdx.x == 0) q[0] = 0;  // the next pushes follow a barrier
}

// One [NB][KB] stage of a tail product's B operand: rows n0.. of bgv
// [nrows][C], columns k0.. (zeros past nrows and C). bf16 rows are copied by
// cp.async; fp32 rows (f32) are loaded and rounded to bf16 on the way.
template <bool kVec16>
__device__ __forceinline__ void stage_b(bf16* dst, const void* bgv, int f32, int nrows, int C,
                                        int n0, int k0) {
  if (f32) {
    const float* bg = static_cast<const float*>(bgv);
    for (int i = threadIdx.x; i < NB * KB / 2; i += NT) {
      const int n = i / (KB / 2), k = (i % (KB / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (n0 + n < nrows && k0 + k < C)
        v = *reinterpret_cast<const float2*>(bg + (size_t)(n0 + n) * C + k0 + k);
      *reinterpret_cast<__nv_bfloat162*>(dst + n * KBS + k) = __floats2bfloat162_rn(v.x, v.y);
    }
    return;
  }
  const bf16* bg = static_cast<const bf16*>(bgv);
  if (kVec16) {
    for (int i = threadIdx.x; i < NB * KB / 8; i += NT) {
      const int n = i / (KB / 8), k = (i % (KB / 8)) * 8;
      const bool ok = n0 + n < nrows && k0 + k < C;
      cp_async16(dst + n * KBS + k, ok ? bg + (size_t)(n0 + n) * C + k0 + k : bg, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < NB * KB / 2; i += NT) {
      const int n = i / (KB / 2), k = (i % (KB / 2)) * 2;
      const bool ok = n0 + n < nrows && k0 + k < C;
      cp_async4(dst + n * KBS + k, ok ? bg + (size_t)(n0 + n) * C + k0 + k : bg, ok ? 4 : 0);
    }
  }
}

// D[M][N] = A[M][Cp] B^T for N = nrows rounded up to NB: A bf16 in shared
// memory (row stride lda), B [nrows][C] bf16 (or fp32, b_f32, rounded to
// bf16 as it is staged) in device memory, streamed in
// double-buffered [NB][KB] stages. Each warp owns 16 columns of every
// NB-wide chunk for all M rows; epi(n, acc) receives the chunk's sums, n
// the warp's first column, acc[i][t] the m16n8 tile (rows 16 i, columns
// n + 8 t) in mma's accumulator layout.
template <int R, bool kVec16, typename Epi>
__device__ void tail_product(const bf16* s_a, int lda, const void* bg, int b_f32, int nrows,
                             int C, int Cp, bf16* s_b, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = Cp / KB, steps = (nrows + NB - 1) / NB * nk;
  float acc[R][2][4];
  stage_b<kVec16>(s_b, bg, b_f32, nrows, C, 0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int nc = s / nk, kc = s % nk;
    if (s + 1 < steps) {
      stage_b<kVec16>(s_b + ((s + 1) & 1) * NB * KBS, bg, b_f32, nrows, C,
                      (s + 1) / nk * NB, (s + 1) % nk * KB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
    }
    const bf16* bs = s_b + (s & 1) * NB * KBS;
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      uint32_t bfr[4];
      ldsm_x4(bfr, bs + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * KBS + ks * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        uint32_t afr[4];
        ldsm_x4(afr, s_a + (16 * i + (lane & 15)) * lda + kc * KB + ks * 16 + (lane >> 4) * 8);
        mma_bf16(acc[i][0], afr, bfr[0], bfr[1]);
        mma_bf16(acc[i][1], afr, bfr[2], bfr[3]);
      }
    }
    if (kc == nk - 1) epi(nc * NB + warp * 16, acc);
    __syncthreads();  // the stage is refilled two steps on
  }
}

// sum_c y[c] w[c] for c = 0 .. C-1 in order, one fma each, as an fp32
// matrix product sums it: y in shared memory, w in device memory, read 64
// values ahead (8 x 16 bytes; 2 x 4 bytes where C is not a multiple of 8).
template <bool kVec16>
__device__ float dot_seq(const bf16* y, const bf16* w, int C) {
  constexpr int V = kVec16 ? 8 : 2, N = 64 / V;
  typedef typename std::conditional<kVec16, uint4, uint32_t>::type Vec;
  const Vec* wv = reinterpret_cast<const Vec*>(w);
  const Vec* yv = reinterpret_cast<const Vec*>(y);
  const int n = C / V;
  Vec cur[N], nxt[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) nxt[i] = wv[i];
  float s = 0.f;
  for (int base = 0; base < n; base += N) {
#pragma unroll
    for (int i = 0; i < N; ++i) cur[i] = nxt[i];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (base + N + i < n) nxt[i] = wv[base + N + i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (base + i < n) {
        const Vec yc = yv[base + i];
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&cur[i]);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yc);
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          const float2 wf = __bfloat1622float2(w2[k]), yf = __bfloat1622float2(y2[k]);
          s = fmaf(yf.x, wf.x, s);
          s = fmaf(yf.y, wf.y, s);
        }
      }
    }
  }
  return s;
}

// K3, or K5b with kFused.
template <bool kVec16, bool kFused>
__global__ void __launch_bounds__(NT, 2) jbu_classify_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = ROWS, M = COLS * R;
  const Layout L = make_layout(a.d, a.G, a.cmid, a.C, a.K);
  bf16* s_y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* s_cb = reinterpret_cast<bf16*>(smem + L.cb);
  int* q = reinterpret_cast<int*>(smem + L.queue);
  unsigned char* work = smem + L.work;
  const int b = blockIdx.z, h0 = blockIdx.y * R, w0 = blockIdx.x * COLS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) q[0] = 0;  // comb_phase's barriers order it before the pushes
  const int g = lane / 4, tq = lane % 4;

  if (kFused) range_phase<R>(a, L, b, h0, w0, work);
  comb_phase<R, kFused>(a, L, b, h0, w0, work, s_cb);
  conv_phase<R, kVec16, kFused>(a, L, b, h0, w0, s_cb, s_y, work, q);

  // fixup product and residual: res = bf16(bf16((yb Wf^T + bf) * 0.1) + yb).
  // t = (yb Wf^T + bf) * 0.1 near a bf16 rounding midpoint is taken again
  // with the product summed over c in order (queued, repaired after the
  // product), as the plain version's fp32 product sums it.
  bf16* s_res = reinterpret_cast<bf16*>(work + L.res);
  bf16* s_b = reinterpret_cast<bf16*>(work + L.bst);
  const int ldy = L.ldy;
  auto fixup_seq = [&](int m, int o) {
    return __fmul_rn(dot_seq<kVec16>(s_y + m * ldy, a.fw + (size_t)o * a.C, a.C) +
                         ld(a.fb, o, a.wbf16), 0.1f);
  };
  tail_product<R, kVec16>(s_y, ldy, a.fw, 0, a.C, a.C, L.Cp, s_b,
                          [&](int n, const float (&acc)[R][2][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int o = n + t * 8 + 2 * tq;
        const float fb0 = o < a.C ? ld(a.fb, o, a.wbf16) : 0.f;
        const float fb1 = o < a.C ? ld(a.fb, o + 1, a.wbf16) : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = 16 * i + g + 8 * hf;
          __nv_bfloat162* r2 = reinterpret_cast<__nv_bfloat162*>(s_res + m * ldy + o);
          if (o < a.C) {
            const float2 yv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(s_y + m * ldy + o));
            float v[2] = {__fmul_rn(acc[i][t][2 * hf] + fb0, 0.1f),
                          __fmul_rn(acc[i][t][2 * hf + 1] + fb1, 0.1f)};
            const bool in = h0 + m / COLS < a.H && w0 + m % COLS < a.W;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (in && near_midpoint(v[e])) queue_push(q, (m << 16) | (o + e));
            *r2 = __floats2bfloat162_rn(bf16_round(v[0]) + yv.x, bf16_round(v[1]) + yv.y);
          } else {
            *r2 = __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
  });

  const bool all = q[0] > QCAP;
  for (int i = threadIdx.x; i < (all ? M * a.C : q[0]); i += NT) {
    const int m = all ? i / a.C : q[1 + i] >> 16, o = all ? i % a.C : q[1 + i] & 0xffff;
    if (h0 + m / COLS < a.H && w0 + m % COLS < a.W)
      s_res[m * ldy + o] = __float2bfloat16_rn(bf16_round(fixup_seq(m, o)) +
                                               __bfloat162float(s_y[m * ldy + o]));
  }
  __syncthreads();

  // L2 norm per pixel, then rb = bf16(res * inv) in place
  const int C2 = a.C / 2;
  for (int m = warp; m < M; m += NWARP) {
    __nv_bfloat162* r2 = reinterpret_cast<__nv_bfloat162*>(s_res + m * ldy);
    float s = 0.f;
    for (int c2 = lane; c2 < C2; c2 += 32) {
      const float2 r = __bfloat1622float2(r2[c2]);
      s = fmaf(r.x, r.x, fmaf(r.y, r.y, s));
    }
    const float inv = rsqrtf(fmaxf(warp_sum(s), 1e-24f));
    for (int c2 = lane; c2 < C2; c2 += 32) {
      const float2 r = __bfloat1622float2(r2[c2]);
      r2[c2] = __floats2bfloat162_rn(r.x * inv, r.y * inv);
    }
  }
  // (tail_product's first barrier orders these writes before its reads)

  // cosine logits against the queries
  tail_product<R, kVec16>(s_res, ldy, a.qf, !a.qbf16, a.Q, a.C, L.Cp, s_b,
                          [&](int n, const float (&acc)[R][2][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = 16 * i + g + 8 * hf;
        const int h = h0 + m / COLS, w = w0 + m % COLS;
        if (h >= a.H || w >= a.W) continue;
        float* o = static_cast<float*>(a.out) + (((size_t)b * a.H + h) * a.W + w) * a.Q;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = n + t * 8 + 2 * tq;
          if (q < a.Q) o[q] = acc[i][t][2 * hf];
          if (q + 1 < a.Q) o[q + 1] = acc[i][t][2 * hf + 1];
        }
      }
  });
}

// K2, or K5a with kFused: the epilogue alone; y (repaired) written out as
// bf16 [B, H, W, C].
template <bool kVec16, bool kFused>
__global__ void __launch_bounds__(NT, 2) jbu_epilogue_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = ROWS, M = COLS * R;
  const Layout L = make_layout(a.d, a.G, a.cmid, a.C, a.K);
  bf16* s_y = reinterpret_cast<bf16*>(smem + L.y);
  bf16* s_cb = reinterpret_cast<bf16*>(smem + L.cb);
  int* q = reinterpret_cast<int*>(smem + L.queue);
  const int b = blockIdx.z, h0 = blockIdx.y * R, w0 = blockIdx.x * COLS;
  if (threadIdx.x == 0) q[0] = 0;  // comb_phase's barriers order it before the pushes

  if (kFused) range_phase<R>(a, L, b, h0, w0, smem + L.work);
  comb_phase<R, kFused>(a, L, b, h0, w0, smem + L.work, s_cb);
  conv_phase<R, kVec16, kFused>(a, L, b, h0, w0, s_cb, s_y, smem + L.work, q);

  // conv_phase ends on a barrier
  const int V = kVec16 ? 8 : 2, per = a.C / V;
  bf16* out = static_cast<bf16*>(a.out);
  for (int i = threadIdx.x; i < M * per; i += NT) {
    const int m = i / per, c = i % per * V, h = h0 + m / COLS, w = w0 + m % COLS;
    if (h >= a.H || w >= a.W) continue;
    bf16* dst = out + (((size_t)b * a.H + h) * a.W + w) * a.C + c;
    if (kVec16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s_y + m * L.ldy + c);
    else
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(s_y + m * L.ldy + c);
  }
}

// A block whose shared memory does not fit (with the MLP d*d wide: C past 1408
// at d <= 11, past 896 at d = 17) is refused with cudaErrorInvalidValue; K2,
// K3, K5a and K5b share the layout (K5's window fits inside it at K >= 1 up
// to d = 17), so they take the same shapes.
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int B, cudaStream_t stream) {
  const Layout L = make_layout(a.d, a.G, a.cmid, a.C, a.K);
  if (L.bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)L.bytes))
    return err;
  dim3 grid((a.W + COLS - 1) / COLS, (a.H + ROWS - 1) / ROWS, B);
  kernel<<<grid, NT, L.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// What K5 takes beside K2's and K3's limits: an odd d, r = d / 2 <= H - 1
// and W - 1 (the reflection's reach), K >= 1.
bool fused_ok(int H, int W, int d, int K) {
  return d % 2 == 1 && d / 2 <= (H < W ? H : W) - 1 && K >= 1;
}

// K3 and K5b: the queries' and the operands' alignment picks the copies.
template <bool kFused>
int launch_classify(const Args& a, int B, cudaStream_t stream) {
  if (!aligned(a.qf, a.qbf16 ? 4 : 8)) return (int)cudaErrorMisalignedAddress;
  if (a.C % 8 == 0 && aligned(a.inp, 16) && aligned(a.fw, 16) && (!a.qbf16 || aligned(a.qf, 16)))
    return launch(jbu_classify_kernel<true, kFused>, a, B, stream);
  if (!aligned(a.inp, 4) || !aligned(a.fw, 4)) return (int)cudaErrorMisalignedAddress;
  return launch(jbu_classify_kernel<false, kFused>, a, B, stream);
}

// K2 and K5a.
template <bool kFused>
int launch_epilogue(const Args& a, int B, cudaStream_t stream) {
  if (a.C % 8 == 0 && aligned(a.inp, 16) && aligned(a.out, 16))
    return launch(jbu_epilogue_kernel<true, kFused>, a, B, stream);
  if (!aligned(a.inp, 4) || !aligned(a.out, 4)) return (int)cudaErrorMisalignedAddress;
  return launch(jbu_epilogue_kernel<false, kFused>, a, B, stream);
}

}  // namespace

// w0, b0, w1, b1 and fb are fp32 (wbf16 = 0) or bf16 (1), qf fp32 or bf16
// (qbf16); the rest as the plain version takes them.
extern "C" int rs_jbu_epilogue_classify(const void* inp, const float* logits,
                                        const void* guid, const float* spatial,
                                        const float* temp, const void* w0,
                                        const void* b0, const void* w1,
                                        const void* b1, const void* fw,
                                        const void* fb, const void* qf, void* out,
                                        int B, int H, int W, int C, int G, int cmid,
                                        int d, int Q, int wbf16, int qbf16,
                                        cudaStream_t stream) {
  if (C % 2 || Q < 1 || Q > NB || d < 1 || d > MAXD) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(inp), logits, static_cast<const bf16*>(guid), spatial,
         temp, w0, b0, w1, b1, static_cast<const bf16*>(fw), fb, qf, out,
         H, W, C, G, cmid, d, Q, wbf16, qbf16};
  return launch_classify<false>(a, B, stream);
}

// K2: w0, b0, w1 and b1 are fp32 (wbf16 = 0) or bf16 (1); out [B, H, W, C]
// bf16; the rest as the plain version takes them.
extern "C" int rs_jbu_epilogue(const void* inp, const float* logits, const void* guid,
                               const float* spatial, const float* temp, const void* w0,
                               const void* b0, const void* w1, const void* b1, void* out,
                               int B, int H, int W, int C, int G, int cmid, int d, int wbf16,
                               cudaStream_t stream) {
  if (C % 2 || d < 1 || d > MAXD) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(inp), logits, static_cast<const bf16*>(guid), spatial,
         temp, w0, b0, w1, b1, nullptr, nullptr, nullptr, out,
         H, W, C, G, cmid, d, 0, wbf16, 0};
  return launch_epilogue<false>(a, B, stream);
}

// K5a: inp [B, H, W, C] bf16 unpadded, proj [B, H, W, K] fp32, guid [B, G, H,
// W] bf16; w0, b0, w1 and b1 fp32 (wbf16 = 0) or bf16 (1); out [B, H, W, C]
// bf16.
extern "C" int rs_jbu_epilogue_fused(const void* inp, const float* proj, const void* guid,
                                     const float* spatial, const float* temp, const void* w0,
                                     const void* b0, const void* w1, const void* b1, void* out,
                                     int B, int H, int W, int C, int G, int cmid, int d, int K,
                                     int wbf16, cudaStream_t stream) {
  if (C % 2 || d < 1 || d > MAXD || !fused_ok(H, W, d, K)) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(inp), nullptr, static_cast<const bf16*>(guid), spatial,
         temp, w0, b0, w1, b1, nullptr, nullptr, nullptr, out,
         H, W, C, G, cmid, d, 0, wbf16, 0, proj, K, K % 4 == 0 && aligned(proj, 16)};
  return launch_epilogue<true>(a, B, stream);
}

// K5b: K5a's operands, then fw, fb and qf as K3 takes them; out [B, H, W, Q]
// fp32.
extern "C" int rs_jbu_epilogue_fused_classify(const void* inp, const float* proj,
                                              const void* guid, const float* spatial,
                                              const float* temp, const void* w0,
                                              const void* b0, const void* w1,
                                              const void* b1, const void* fw,
                                              const void* fb, const void* qf, void* out,
                                              int B, int H, int W, int C, int G, int cmid,
                                              int d, int K, int Q, int wbf16, int qbf16,
                                              cudaStream_t stream) {
  if (C % 2 || Q < 1 || Q > NB || d < 1 || d > MAXD || !fused_ok(H, W, d, K))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(inp), nullptr, static_cast<const bf16*>(guid), spatial,
         temp, w0, b0, w1, b1, static_cast<const bf16*>(fw), fb, qf, out,
         H, W, C, G, cmid, d, Q, wbf16, qbf16, proj, K, K % 4 == 0 && aligned(proj, 16)};
  return launch_classify<true>(a, B, stream);
}

// Bytes of shared memory a block of these kernels takes (K = 0 for K2 and
// K3), for the wrappers' mirror of the layout to be checked against.
extern "C" int rs_jbu_block_smem(int d, int G, int cmid, int C, int K) {
  return (int)make_layout(d, G, cmid, C, K).bytes;
}
