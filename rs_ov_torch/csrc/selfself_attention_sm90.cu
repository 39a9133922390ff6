// Fused self-self attention (K6) in bf16, on Hopper's tensor cores (sm_90a).
//
//   out[b, h, i, :] = bf16(sum_j A[i, j] * v[b, h, j, :])      (fp32 sums)
//
// with the attention weights A of one of six modes (s = hd^-0.5, S = sim * w):
//   0 vanilla       softmax(q k^T s + S)
//   1 ClearCLIP     softmax(q q^T s + S)
//   2 SCLIP         softmax(q q^T s + S) + softmax(k k^T s + S)
//   3 SegEarth      SCLIP's two terms + softmax(v v^T s + S)
//   4 SFP           softmax(0.5 (q q^T s + k k^T s) + S)
//   5 Experimental  softmax(softmax(k k^T s + q q^T s) + S)
// Sums of softmaxes are not renormalised; Experimental takes its second
// softmax with or without a sim map. The fp32 entry is
// selfself_attention_f32_sm90.cu (the same design on TF32 operands); the
// row softmax and the sim-row staging are shared, in selfself_attention.cuh.
//
// Replaces the TPU kernel rs_ov/kernels/selfself_attention.py:
// fused_selfself_attention (pallas_call at :103), for bf16 operands.
//
// What bounds it on the H100: bytes. At the main path's shapes (B=16 crops,
// H=12, L=197, hd=64) q, k, v and out are 19.4 MB of bf16 and the sim map
// 2.5 MB (6.5 us at 3.35 TB/s); one score product is 2*B*H*L^2*hd = 0.954
// G operations, and Experimental's two score products plus the weights @ v
// pair below are 3.8 G on bf16 operands (3.9 us at 989 TFLOP/s). The
// products of two bf16 values are exact in fp32, so mma.sync with fp32 sums
// computes the score products as the plain version does, up to the order of
// the sums. The softmaxes stay fp32, in registers. The fp32 weights meet v on
// the tensor cores as a bf16 pair hi + lo (hi = bf16(p), lo = bf16(p - hi)):
// hi@v + lo@v is p@v within ~2^-16 of a weight, far below the output's bf16
// step; the earlier kernel took that product on the fp32 cores (14 us).
//
// Design: a block of NW warps takes one (b, h) and NW tiles of 16 query
// rows; each warp owns one tile. The block stages the head's q, k and v (the
// operands the mode needs, in that order) once by cp.async into shared
// memory as bf16, hd zero-padded to a multiple of 16 and each row 16 bytes
// longer, so that ldmatrix reads 8 rows in 8 bank groups. The tiles read L
// rounded up to 16 rows: past L, q's and k's rows are the next operand's
// first ones (their scores are masked, their outputs never stored) and v,
// staged last, has zero rows (where the weights are 0); so a block holds
// ((n - 1) L + Lp) rows and takes every shape the earlier kernel took. A warp
// holds its 16 rows' scores for every key in the m16n8 accumulators (L <=
// 208: 104 fp32 a lane; up to L = 288 a second instantiation, 144), so each
// softmax is exact over the whole row: a row lives in a quad of 4 lanes, and
// its max and sum are two shuffles. Padded keys are set to -inf before every
// softmax, Experimental's second one included. Two neighbouring n8 score
// tiles are the A fragment of one k16 step of weights @ v
// (FlashAttention-2's register reuse), and v is read with ldmatrix.trans, so
// the weights never leave registers. SCLIP and SegEarth add each term's
// weights @ v into the same output accumulators, so one score tile is live
// at a time. The output is taken 64 channels at a time over the same
// weights (an hd past 64, ViT-H/14's 80, takes the scores again for a
// second pass only in SCLIP and SegEarth; hd <= 64 has instantiations of its
// own, in which the weights die as they are read). Each warp stages its 16 rows of
// the sim map (per image, b = bh / H) into shared memory by cp.async while
// its first score product runs, where the block has room (at L = 197, 88 KB
// for 7 warps beside the operands' 87 KB), else reads them from device
// memory; read in the fragment's layout, they kept Experimental's second
// softmax waiting on device memory. NW = 7 (two blocks a head at L = 197,
// one block an SM at ~240 registers a thread) beat 4 and 2 on the H100
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "selfself_attention.cuh"

namespace {

using namespace rs_ov;

constexpr int NW = 7;    // warps (16-row query tiles) per block
constexpr int HC = 64;   // output channels per pass of weights @ v
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper

typedef __nv_bfloat16 bf16;

// The block's operands: L and hd padded to multiples of 16 (LP, HP), rows of
// HP + 8.
struct Shape {
  int L, hd, LP, HP, ld;
};

__host__ __device__ inline Shape make_shape(int L, int hd) {
  const int LP = (L + 15) / 16 * 16, HP = (hd + 15) / 16 * 16;
  return Shape{L, hd, LP, HP, HP + 8};
}

// Bytes of the staged operands: (n - 1) L rows, then v's LP.
__host__ __device__ inline size_t operand_bytes(int mode, const Shape& sh) {
  return ((size_t)(n_operands(mode) - 1) * sh.L + sh.LP) * sh.ld * sizeof(bf16);
}

// s[n] += A[r0 .. r0+15] . Bk[8n .. 8n+7] over the padded hd, for the
// warp's nkt key tiles of 16 (n < 2 nkt <= N)
template <int N>
__device__ __forceinline__ void scores(float (&s)[N][4], const bf16* A, const bf16* Bk,
                                       int r0, int nkt, const Shape& sh, int lane) {
  for (int kk = 0; kk < sh.HP; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, A + (r0 + (lane & 15)) * sh.ld + kk + (lane >> 4) * 8);
#pragma unroll
    for (int t = 0; t < N / 2; ++t) {
      if (t < nkt) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Bk + (t * 16 + (lane & 7) + ((lane >> 4) << 3)) * sh.ld + kk +
                         ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * t], af, bfr[0], bfr[1]);
        mma_bf16(s[2 * t + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

// (x, y) as a bf16 pair hi and the pair of what hi leaves, lo
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Output channels [c0, c0 + 64) of the warp's rows (rows of hd bf16).
__device__ __forceinline__ void store_rows(bf16* out, const float (&o)[HC / 8][4], int c0,
                                           int hd, int r0, int L, int g, int tq) {
#pragma unroll
  for (int n = 0; n < HC / 8; ++n) {
    const int c = c0 + 8 * n + 2 * tq;
    if (c < hd) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + 8 * hf;
        if (row < L)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * hd + c) =
              __floats2bfloat162_rn(o[n][2 * hf], o[n][2 * hf + 1]);
      }
    }
  }
}

// o += p @ v[:, c0 .. c0+63]: the weights p in the score accumulators' layout
// are the A fragments (tiles 2t and 2t+1 are k16 step t), as hi + lo.
template <int N>
__device__ __forceinline__ void weights_v(float (&o)[HC / 8][4], const float (&p)[N][4],
                                          const bf16* sv, int c0, int nkt, const Shape& sh,
                                          int lane) {
#pragma unroll
  for (int t = 0; t < N / 2; ++t) {
    if (t < nkt) {
      uint32_t hi[4], lo[4];
      split_pair(p[2 * t][0], p[2 * t][1], hi[0], lo[0]);
      split_pair(p[2 * t][2], p[2 * t][3], hi[1], lo[1]);
      split_pair(p[2 * t + 1][0], p[2 * t + 1][1], hi[2], lo[2]);
      split_pair(p[2 * t + 1][2], p[2 * t + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int pr = 0; pr < HC / 16; ++pr) {
        if (c0 + pr * 16 < sh.HP) {
          uint32_t b[4];
          ldsm_x4_trans(b, sv + (t * 16 + (lane & 15)) * sh.ld + c0 + pr * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * pr], hi, b[0], b[1]);
          mma_bf16(o[2 * pr + 1], hi, b[2], b[3]);
          mma_bf16(o[2 * pr], lo, b[0], b[1]);
          mma_bf16(o[2 * pr + 1], lo, b[2], b[3]);
        }
      }
    }
  }
}

// KT: key tiles of 16 a warp holds (L <= 16 KT); MULTI: hd > 64, more than
// one pass of weights @ v
template <int MODE, int KT, bool MULTI>
__global__ void __launch_bounds__(NW * 32)
selfself_attention_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ sim,
                               bf16* __restrict__ out, int H, int L, int hd, float scale,
                               float sim_weight, int sim_staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape sh = make_shape(L, hd);
  const int bh = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  constexpr bool NEED_K = MODE != CLEARCLIP;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + (size_t)L * sh.ld;
  bf16* sv = NEED_K ? sk + (size_t)L * sh.ld : sk;

  // stage the head's operands: zeros past hd, and v's past L
  const size_t head = (size_t)bh * L * hd;
  const int vecs = sh.HP / 8;
  for (int i = threadIdx.x; i < sh.LP * vecs; i += NW * 32) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const bool ok = r < L && c < hd;
    const size_t src = ok ? head + (size_t)r * hd + c : 0;
    const int dst = r * sh.ld + c, n = ok ? 16 : 0;
    if (r < L) {
      cp_async16(sq + dst, q + src, n);
      if (NEED_K) cp_async16(sk + dst, k + src, n);
    }
    cp_async16(sv + dst, v + src, n);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = (blockIdx.y * NW + warp) * 16;
  if (r0 >= L) return;  // no barrier follows
  const int nkt = sh.LP / 16, rows = min(16, L - r0);
  // the warp's sim rows (per image, b = bh / H): staged into shared memory
  // while the first score product runs, where the block has room
  const float* simg = nullptr;
  if (sim != nullptr) {
    simg = sim + ((size_t)(bh / H) * L + r0) * L;
    if (sim_staged)
      simg = stage_sim(reinterpret_cast<float*>(smem + operand_bytes(MODE, sh)) +
                           warp * sim_slice(L), simg, rows * L, lane);
  }

  bf16* head_out = out + head;
  float s[2 * KT][4];
  if (MODE == SCLIP || MODE == SEGEARTH) {
    // the terms' weights meet v apart: each further 64 output channels take
    // the scores again
#pragma unroll 1
    for (int c0 = 0; c0 < hd; c0 += HC) {
      float o[HC / 8][4];
      zero(o);
#pragma unroll 1
      for (int term = 0; term < (MODE == SEGEARTH ? 3 : 2); ++term) {
        const bf16* x = term == 0 ? sq : (term == 1 ? sk : sv);
        zero(s);
        scores(s, x, x, r0, nkt, sh, lane);
        logits(s, scale, simg, sim_weight, rows, L, g, tq);
        softmax_rows(s);
        weights_v(o, s, sv, c0, nkt, sh, lane);
      }
      store_rows(head_out, o, c0, hd, r0, L, g, tq);
    }
    return;
  }
  zero(s);
  if (MODE == VANILLA || MODE == CLEARCLIP) {
    scores(s, sq, MODE == VANILLA ? sk : sq, r0, nkt, sh, lane);
    logits(s, scale, simg, sim_weight, rows, L, g, tq);
    softmax_rows(s);
  } else {  // SFP, EXPERIMENTAL: both score products in one accumulator
    scores(s, sk, sk, r0, nkt, sh, lane);
    scores(s, sq, sq, r0, nkt, sh, lane);
    if (MODE == SFP) {
      logits(s, 0.5f * scale, simg, sim_weight, rows, L, g, tq);
      softmax_rows(s);
    } else {  // the sim map joins after the first softmax
      logits(s, scale, nullptr, 0.f, rows, L, g, tq);
      softmax_rows(s);
      logits(s, 1.f, simg, sim_weight, rows, L, g, tq);
      softmax_rows(s);
    }
  }
  // one softmax's weights, taken once, meet v in passes of 64 output
  // channels; with one pass (hd <= 64) the weights die as they are read
  if (!MULTI) {
    float o[HC / 8][4];
    zero(o);
    weights_v(o, s, sv, 0, nkt, sh, lane);
    store_rows(head_out, o, 0, hd, r0, L, g, tq);
    return;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += HC) {
    float o[HC / 8][4];
    zero(o);
    weights_v(o, s, sv, c0, nkt, sh, lane);
    store_rows(head_out, o, c0, hd, r0, L, g, tq);
  }
}

template <int MODE, int KT, bool MULTI>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* sim, bf16* out, int B,
           int H, int L, int hd, float scale, float sim_weight, cudaStream_t stream) {
  const Shape sh = make_shape(L, hd);
  size_t smem = operand_bytes(MODE, sh);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const size_t sim_bytes = (size_t)NW * sim_slice(L) * sizeof(float);
  const int sim_staged = sim != nullptr && smem + sim_bytes <= (size_t)SMEM_MAX;
  if (sim_staged) smem += sim_bytes;
  auto kernel = selfself_attention_sm90_kernel<MODE, KT, MULTI>;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  const dim3 grid(B * H, (sh.LP / 16 + NW - 1) / NW);
  kernel<<<grid, NW * 32, smem, stream>>>(q, k, v, sim, out, H, L, hd, scale, sim_weight,
                                          sim_staged);
  return (int)cudaGetLastError();
}

// SCLIP and SegEarth take the scores again for each pass of 64 output
// channels, so they have one instantiation for every hd
template <int KT, bool MULTI>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const float* sim, bf16* out, int B,
             int H, int L, int hd, int mode, float scale, float w, cudaStream_t stream) {
  switch (mode) {
    case VANILLA:
      return launch<VANILLA, KT, MULTI>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    case CLEARCLIP:
      return launch<CLEARCLIP, KT, MULTI>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    case SCLIP: return launch<SCLIP, KT, false>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    case SEGEARTH:
      return launch<SEGEARTH, KT, false>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    case SFP: return launch<SFP, KT, MULTI>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    case EXPERIMENTAL:
      return launch<EXPERIMENTAL, KT, MULTI>(q, k, v, sim, out, B, H, L, hd, scale, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out [B, H, L, hd] bf16, 16-byte aligned; sim [B, L, L] fp32 or
// null. L <= 288, hd a multiple of 8 up to 128; a block whose operands do
// not fit in shared memory is refused with cudaErrorInvalidValue.
extern "C" int rs_selfself_attention_bf16(const void* q, const void* k, const void* v,
                                          const float* sim, void* out, int B, int H, int L,
                                          int hd, int mode, float scale, float sim_weight,
                                          cudaStream_t stream) {
  if (L < 1 || L > 288 || hd < 8 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  bf16* bo = static_cast<bf16*>(out);
  const bool multi = hd > HC;
  const auto fn = L <= 208 ? (multi ? &dispatch<13, true> : &dispatch<13, false>)
                           : (multi ? &dispatch<18, true> : &dispatch<18, false>);
  return fn(bq, bk, bv, sim, bo, B, H, L, hd, mode, scale, sim_weight, stream);
}
