// Fused self-self attention (K6) in fp32, on Hopper's TF32 tensor cores
// (sm_90a).
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
// Sums of softmaxes are not renormalised; Experimental takes its second
// softmax with or without a sim map. The bf16 entry is
// selfself_attention_sm90.cu.
//
// Replaces the TPU kernel rs_ov/kernels/selfself_attention.py:
// fused_selfself_attention (pallas_call at :103), for fp32 operands.
//
// What bounds it on the H100: operations. At the main path's shapes (B=16
// crops, H=12, L=197, hd=64) one product of two [L, hd] operands is
// 2*B*H*L^2*hd = 0.954 G operations; Experimental takes two score products
// and weights @ v, 2.9 G, which the fp32 cores (67 TFLOP/s) need 43 us
// for; q, k, v and out in fp32 and the sim map are 41.2 MB (12 us at 3.35
// TB/s). The earlier kernel took every product on the fp32 cores, a query
// row per warp at a time, and took 0.59 ms. Here every product runs on the
// TF32 tensor cores (495 TFLOP/s) as a split product ("3xTF32"): each fp32
// operand x is hi + lo with hi = tf32(x) and lo = x - hi, and
// a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b with fp32 sums, which keeps ~22
// bits of each operand (a product within ~2^-21 of the fp32 one): three
// mma.sync a product, 8.6 G operations at Experimental, 17 us at the TF32
// rate. The split is made as a fragment is loaded from fp32 in shared
// memory (an integer add and mask for hi, a subtraction for lo, whose low
// bits the tensor core ignores; cvt.rna.tf32.f32 took four instructions
// for hi alone, and the kernel's time follows its instruction count): split
// planes staged ahead would double the shared memory.
//
// Design: the bf16 kernel's on m16n8k8 TF32 tiles. A block of up to 8 warps
// takes one (b, h) and as many tiles of 16 query rows, each warp one tile,
// over as few blocks a head as that allows (2 of 7 warps at L = 197), and
// each warp holds its 16 rows' scores for every key in the accumulators
// (L <= 208: 104 fp32 a lane; up to L = 288 a second instantiation, 144), so
// each softmax is exact over the whole row, with keys past L at -inf before
// each of them, Experimental's second one included. A tile's three products
// go into one accumulator, so the key tiles go in groups of 8 and each
// group's products in three passes: 8 independent mma.sync in flight. The
// score products' fragments load by ldmatrix, fp32 values as b16 pairs. The
// weights leave the score accumulators as the A fragment of weights @ v
// with no shuffle: in an n8 score tile a lane holds keys 2tq and 2tq + 1, so
// A's column tq is taken to be key 2tq and column tq + 4 key 2tq + 1, and
// v's B fragment reads the same two keys. The block stages the head's q, k
// and v in fp32 by cp.async, rows of hd + 4 floats (every fragment load then
// hits 32 banks), in two groups: the operands of the first score product,
// then the rest, which land while that product runs. q and k have L rows,
// and a tile reading past L reads the next operand's rows (masked keys, rows
// never stored); v, staged last, has zero rows up to L rounded to 16. The
// fp32 operands take 164 KB at L = 197, hd = 64, one block an SM: each
// warp's 16 sim rows (12.6 KB) are staged by cp.async while its first score
// product runs where the block has room for them (ClearCLIP's two operands),
// else read from device memory in the fragments' layout: staging them at
// L = 197 would take 5 warps a block and 3 blocks a head, which ran slower
// on the H100 than the loads. An hd past 64 (ViT-H/14's 80) takes weights @
// v in passes of 64 output channels over the same weights; only SCLIP and
// SegEarth, whose terms' weights meet v apart, take the scores again for
// each further pass. hd <= 64 has instantiations of its own (MULTI false),
// in which the weights die as weights @ v reads them: held across passes
// they spill at L > 208.
//
// Where the three operands do not fit a block (ViT-H/14's L = 257, hd = 80:
// 264096 B), the score operands share one slot of L rows, staged in turn
// beside v (each self-self score product q q^T, k k^T or v v^T reads only its
// own operand), with a barrier before and after each restage: (257 + 272) x
// 84 x 4 = 177744 B there. vanilla's q k^T reads k from the slot and each
// warp's own 16 query rows from a slice of the block's rows of q staged after
// v. The order of the products, and so every sum, is the three-operand
// layout's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "selfself_attention.cuh"

namespace {

using namespace rs_ov;

constexpr int NW_MAX = 8;  // warps (16-row query tiles) a block at most
constexpr int HC = 64;     // output channels per pass of weights @ v
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper

// The block's operands: L rounded up to 16 (LP), rows of hd + 4 floats.
struct Shape {
  int L, hd, LP, ld;
};

__host__ __device__ inline Shape make_shape(int L, int hd) {
  return Shape{L, hd, (L + 15) / 16 * 16, hd + 4};
}

// Bytes of the staged operands: (n - 1) L rows, then v's LP; with one slot
// for the score operands (single), L rows, v's LP and for vanilla the block's
// nw x 16 rows of q.
__host__ __device__ inline size_t operand_bytes(int mode, const Shape& sh, int single, int nw) {
  const size_t rows = single ? (size_t)sh.L + sh.LP + (mode == VANILLA ? 16 * nw : 0)
                             : (size_t)(n_operands(mode) - 1) * sh.L + sh.LP;
  return rows * sh.ld * sizeof(float);
}

// Warps a block and blocks a head: up to NW_MAX warps (16-row query tiles) a
// block, over as few blocks a head as that allows.
__host__ __device__ inline void block_shape(const Shape& sh, int& blocks, int& nw) {
  const int tiles = sh.LP / 16;
  blocks = (tiles + NW_MAX - 1) / NW_MAX;
  nw = (tiles + blocks - 1) / blocks;
}

// The layout a launch takes: the three-operand one where it fits, else one
// slot for the score operands; 0 where neither fits.
__host__ __device__ inline int pick_layout(int mode, const Shape& sh, int nw, int& single) {
  single = operand_bytes(mode, sh, 0, nw) > (size_t)SMEM_MAX;
  return operand_bytes(mode, sh, single, nw) <= (size_t)SMEM_MAX;
}

// The B fragments of key tiles t .. t+G-1 (those below N), two tiles a
// ldmatrix.x4: the fp32 values as pairs of b16, each 8x8 b16 matrix being 8
// keys x 4 columns, so that a lane receives key g, column tq of each
// (matrices: even tile columns 0-3 and 4-7, odd tile the same). b is the
// lane's row of its matrix at tile 0; a tile past last reads tile last
// again. Then their three products with the A fragment in three passes over
// the tiles, so that G independent mma.sync are in flight where one tile's
// three would wait on each other.
template <int G, int N>
__device__ __forceinline__ void score_tiles(float (&s)[N][4], int t, const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], const float* b, int tile,
                                            int last, int lane) {
  uint32_t bh[G][2], bl[G][2];
#pragma unroll
  for (int i = 0; i < G; i += 2)
    if (t + i < N) {
      uint32_t r[4];
      ldsm_x4(r, b + min(t + i + (lane >> 4), last) * tile);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(r[e]), bh[i + e / 2][e % 2], bl[i + e / 2][e % 2]);
    }
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (t + i < N) mma_tf32(s[t + i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (t + i < N) mma_tf32(s[t + i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (t + i < N) mma_tf32(s[t + i], ah, bh[i]);
}

// s[n] += A[r0 .. r0+15] . Bk[8n .. 8n+7] over hd, for the nkt key tiles of
// 8 (nkt <= N, N even), each product as three TF32 products. A fragment (one
// ldmatrix.x4): rows g and g + 8, columns tq and tq + 4; B fragment: key
// 8n + g, columns tq and tq + 4. The tiles go in groups of G = 8; a tile
// past nkt (in the last group) reads the last tile's keys again (its scores
// are masked), so that every read stays within the staged rows.
template <int N>
__device__ __forceinline__ void scores(float (&s)[N][4], const float* A, const float* Bk,
                                       int r0, int nkt, const Shape& sh, int lane) {
  constexpr int G = 8;
  static_assert(N % 2 == 0, "key tiles go in pairs");
  const int tile = 8 * sh.ld;  // floats from one key tile to the next
  const float* a = A + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * sh.ld + 4 * (lane >> 4);
  const float* b = Bk + (lane & 7) * sh.ld + 4 * ((lane >> 3) & 1);
  for (int kk = 0; kk < sh.hd; kk += 8) {
    uint32_t af[4], ah[4], al[4];
    ldsm_x4(af, a + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(af[e]), ah[e], al[e]);
#pragma unroll
    for (int t = 0; t < N; t += G)
      if (t < nkt) score_tiles<G>(s, t, ah, al, b + kk, tile, nkt - 1, lane);
  }
}

// The B fragments of v's column tiles j0 .. j0+3 (tile i at v + c[i]: rows
// keys 2tq and 2tq + 1, column g), then their three products with the
// weights' A fragment in three passes over the tiles.
__device__ __forceinline__ void v_tiles(float (&o)[HC / 8][4], int j0, const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const float* v, int ld,
                                        const int (&c)[4]) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(v[c[i]], bh[i][0], bl[i][0]);
    split_tf32(v[ld + c[i]], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(o[j0 + i], al, bh[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(o[j0 + i], ah, bl[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(o[j0 + i], ah, bh[i]);
}

// o += p @ v[:, c0 .. c0+63]: score tile n is k8 step n of the product, A's
// column tq being key 8n + 2tq and column tq + 4 key 8n + 2tq + 1 (the
// accumulators' own layout); v's B fragment reads those keys at column g.
// The 8 column tiles go in two groups of 4. Where hd ends inside the pass,
// a tile past hd reads hd's last 8 columns again: computed, never stored.
template <int N>
__device__ __forceinline__ void weights_v(float (&o)[HC / 8][4], const float (&p)[N][4],
                                          const float* sv, int c0, int nkt, const Shape& sh,
                                          int g, int tq) {
  const float* vt = sv + 2 * tq * sh.ld + c0 + g;
  const bool whole = c0 + HC <= sh.hd;
  const int last = sh.hd - c0 - 8;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (n < nkt) {
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
      const float* v = vt + n * 8 * sh.ld;
#pragma unroll
      for (int j0 = 0; j0 < HC / 8; j0 += 4) {
        if (whole) {
          const int c[4] = {8 * j0, 8 * j0 + 8, 8 * j0 + 16, 8 * j0 + 24};
          v_tiles(o, j0, ah, al, v, sh.ld, c);
        } else if (c0 + 8 * j0 < sh.hd) {
          const int c[4] = {min(8 * j0, last), min(8 * j0 + 8, last), min(8 * j0 + 16, last),
                            min(8 * j0 + 24, last)};
          v_tiles(o, j0, ah, al, v, sh.ld, c);
        }
      }
    }
  }
}

// rows [0, n) of x (rows of hd floats) into dst (rows of ld), zero rows from
// `rows` on, by the block's warps, 16 bytes a copy (hd <= 128: a lane a copy)
__device__ __forceinline__ void stage(float* dst, const float* x, int rows, int n,
                                      const Shape& sh, int warp, int nw, int lane) {
  if (4 * lane >= sh.hd) return;
  for (int r = warp; r < n; r += nw) {
    const bool ok = r < rows;
    cp_async16(dst + r * sh.ld + 4 * lane, ok ? x + (size_t)r * sh.hd + 4 * lane : x,
               ok ? 16 : 0);
  }
}

// Output channels [c0, c0 + 64) of the warp's rows (rows of hd floats).
__device__ __forceinline__ void store_rows(float* out, const float (&o)[HC / 8][4], int c0,
                                           int hd, int r0, int L, int g, int tq) {
#pragma unroll
  for (int n = 0; n < HC / 8; ++n) {
    const int c = c0 + 8 * n + 2 * tq;
    if (c < hd) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + 8 * hf;
        if (row < L)
          *reinterpret_cast<float2*>(out + (size_t)row * hd + c) =
              make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
      }
    }
  }
}

// The single-slot layout's restage: once every warp is done with what the
// slot holds, operand x's L rows into it, landed for every warp on return.
__device__ __forceinline__ void restage(float* slot, const float* x, const Shape& sh, int warp,
                                        int nw, int lane) {
  __syncthreads();
  stage(slot, x, sh.L, sh.L, sh, warp, nw, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// KT: key tiles of 8 a warp holds (L <= 8 KT); MULTI: hd > 64, more than
// one pass of weights @ v. single: the score operands share one slot
// (operand_bytes).
template <int MODE, int KT, bool MULTI>
__global__ void __launch_bounds__(NW_MAX * 32, 1)
selfself_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ sim,
                              float* __restrict__ out, int H, int L, int hd, float scale,
                              float sim_weight, int sim_staged, int single) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shape sh = make_shape(L, hd);
  const int nw = blockDim.x / 32;
  const int bh = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  constexpr bool NEED_K = MODE != CLEARCLIP;
  // the first score product's operands, and its A and B
  constexpr bool K_FIRST = MODE == SFP || MODE == EXPERIMENTAL;
  const bool two_slots = NEED_K && !single;
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = two_slots ? sq + (size_t)L * sh.ld : sq;  // single: one slot, sq == sk
  float* sv = sk + (size_t)L * sh.ld;
  float* sqb = sv + (size_t)sh.LP * sh.ld;  // single vanilla: the block's rows of q
  const size_t head = (size_t)bh * L * hd;
  const float *gq = q + head, *gk = k + head;
  const int r0 = (blockIdx.y * nw + warp) * 16;
  const bool vanilla_rows = MODE == VANILLA && single;
  const float* first_a = vanilla_rows ? sqb : (K_FIRST ? sk : sq);
  const float* first_b = MODE == VANILLA ? sk : first_a;
  const int ra = vanilla_rows ? 16 * warp : r0;  // the first product's A row
  // the operand the slot must hold for the first product
  const float* first_x = MODE == VANILLA || K_FIRST ? gk : gq;

  if (single) {  // group 1: the slot's first operand (vanilla: and its q rows)
    stage(sq, first_x, L, L, sh, warp, nw, lane);
    if (MODE == VANILLA) {
      const int row0 = blockIdx.y * nw * 16;
      stage(sqb, gq + (size_t)row0 * hd, min(16 * nw, L - row0), 16 * nw, sh, warp, nw, lane);
    }
    cp_async_commit();
  } else {  // group 1: the first product's operands; group 2: the rest
    if (!K_FIRST) stage(sq, gq, L, L, sh, warp, nw, lane);
    if (MODE == VANILLA || K_FIRST) stage(sk, gk, L, L, sh, warp, nw, lane);
    cp_async_commit();
    if (K_FIRST) stage(sq, gq, L, L, sh, warp, nw, lane);
    if (MODE == SCLIP || MODE == SEGEARTH) stage(sk, gk, L, L, sh, warp, nw, lane);
  }
  stage(sv, v + head, L, sh.LP, sh, warp, nw, lane);
  cp_async_commit();

  const bool active = r0 < L;
  const int nkt = (L + 7) / 8, rows = min(16, L - r0);
  // the warp's sim rows (per image, b = bh / H): staged into shared memory
  // while the first score product runs, where the block has room (group 3,
  // committed by every thread, empty where nothing is staged)
  const float* simg = nullptr;
  if (sim != nullptr && active) {
    simg = sim + ((size_t)(bh / H) * L + r0) * L;
    if (sim_staged)
      simg = stage_sim(reinterpret_cast<float*>(smem + operand_bytes(MODE, sh, single, nw)) +
                           warp * sim_slice(L), simg, rows * L, lane);
    else
      cp_async_commit();
  } else {
    cp_async_commit();
  }

  cp_async_wait<2>();
  __syncthreads();
  // the first score product; the rest of the operands land while it runs
  float s[KT][4];
  zero(s);
  if (active) scores(s, first_a, first_b, ra, nkt, sh, lane);
  cp_async_wait<1>();
  __syncthreads();
  if (!active && !single) return;  // no barrier follows
  float* head_out = out + head;
  if (MODE == SCLIP || MODE == SEGEARTH) {
    // the terms' weights meet v apart: each further 64 output channels take
    // the scores again
    const float* held = gq;  // what the single slot holds
#pragma unroll 1
    for (int c0 = 0; c0 < hd; c0 += HC) {
      float o[HC / 8][4];
      zero(o);
#pragma unroll 1
      for (int term = 0; term < (MODE == SEGEARTH ? 3 : 2); ++term) {
        if (term > 0 || c0 > 0) {
          const float* want = term == 0 ? gq : gk;
          if (single && term < 2 && held != want) {
            restage(sq, want, sh, warp, nw, lane);
            held = want;
          }
          const float* x = term == 0 ? sq : (term == 1 ? sk : sv);
          zero(s);
          if (active) scores(s, x, x, r0, nkt, sh, lane);
        }
        if (active) {
          logits(s, scale, simg, sim_weight, rows, L, g, tq);
          softmax_rows(s);
          weights_v(o, s, sv, c0, nkt, sh, g, tq);
        }
      }
      if (active) store_rows(head_out, o, c0, hd, r0, L, g, tq);
    }
    return;
  }
  // SFP, EXPERIMENTAL: k k^T, then q q^T into the same accumulator
  if ((MODE == SFP || MODE == EXPERIMENTAL) && single) restage(sq, gq, sh, warp, nw, lane);
  if (!active) return;  // no barrier follows
  if (MODE == SFP || MODE == EXPERIMENTAL) scores(s, sq, sq, r0, nkt, sh, lane);
  if (MODE == VANILLA || MODE == CLEARCLIP) {
    logits(s, scale, simg, sim_weight, rows, L, g, tq);
    softmax_rows(s);
  } else if (MODE == SFP) {
    logits(s, 0.5f * scale, simg, sim_weight, rows, L, g, tq);
    softmax_rows(s);
  } else {  // EXPERIMENTAL: the sim map joins after the first softmax
    logits(s, scale, nullptr, 0.f, rows, L, g, tq);
    softmax_rows(s);
    logits(s, 1.f, simg, sim_weight, rows, L, g, tq);
    softmax_rows(s);
  }
  // one softmax's weights, taken once, meet v in passes of 64 output
  // channels; with one pass (hd <= 64) the weights die as they are read
  if (!MULTI) {
    float o[HC / 8][4];
    zero(o);
    weights_v(o, s, sv, 0, nkt, sh, g, tq);
    store_rows(head_out, o, 0, hd, r0, L, g, tq);
    return;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < hd; c0 += HC) {
    float o[HC / 8][4];
    zero(o);
    weights_v(o, s, sv, c0, nkt, sh, g, tq);
    store_rows(head_out, o, c0, hd, r0, L, g, tq);
  }
}

template <int MODE, int KT, bool MULTI>
int launch(const float* q, const float* k, const float* v, const float* sim, float* out,
           int B, int H, int L, int hd, float scale, float sim_weight, cudaStream_t stream) {
  const Shape sh = make_shape(L, hd);
  // the sim rows are staged where the block has room for them at its count
  // of blocks (a block per SM: fewer warps would cost more waves than the
  // sim map's loads from device memory, measured on the H100)
  int blocks, nw, single;
  block_shape(sh, blocks, nw);
  if (!pick_layout(MODE, sh, nw, single)) return (int)cudaErrorInvalidValue;
  const size_t ops = operand_bytes(MODE, sh, single, nw);
  const size_t sim_bytes = (size_t)nw * sim_slice(L) * sizeof(float);
  const int sim_staged = sim != nullptr && ops + sim_bytes <= (size_t)SMEM_MAX;
  const size_t smem = ops + (sim_staged ? sim_bytes : 0);
  auto kernel = selfself_attention_f32_kernel<MODE, KT, MULTI>;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  kernel<<<dim3(B * H, blocks), nw * 32, smem, stream>>>(q, k, v, sim, out, H, L, hd, scale,
                                                        sim_weight, sim_staged, single);
  return (int)cudaGetLastError();
}

// SCLIP and SegEarth take the scores again for each pass of 64 output
// channels, so they have one instantiation for every hd
template <int KT, bool MULTI>
int dispatch(const float* q, const float* k, const float* v, const float* sim, float* out,
             int B, int H, int L, int hd, int mode, float scale, float w, cudaStream_t stream) {
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

// Bytes of shared memory the staged operands of a launch at (mode, L, hd)
// take (the layout it picks), 0 where the launch is refused.
extern "C" int rs_selfself_attention_f32_smem(int mode, int L, int hd) {
  if (L < 1 || L > 288 || hd < 8 || hd > 128 || hd % 8 || mode < VANILLA || mode > EXPERIMENTAL)
    return 0;
  const Shape sh = make_shape(L, hd);
  int blocks, nw, single;
  block_shape(sh, blocks, nw);
  return pick_layout(mode, sh, nw, single) ? (int)operand_bytes(mode, sh, single, nw) : 0;
}

// q, k, v, out [B, H, L, hd] fp32, 16-byte aligned; sim [B, L, L] fp32 or
// null. L <= 288, hd a multiple of 8 up to 128; a block whose operands do
// not fit in shared memory in either layout is refused with
// cudaErrorInvalidValue.
extern "C" int rs_selfself_attention_f32(const float* q, const float* k, const float* v,
                                         const float* sim, float* out, int B, int H, int L,
                                         int hd, int mode, float scale, float sim_weight,
                                         cudaStream_t stream) {
  if (L < 1 || L > 288 || hd < 8 || hd > 128 || hd % 8) return (int)cudaErrorInvalidValue;
  const bool multi = hd > HC;
  const auto fn = L <= 208 ? (multi ? &dispatch<26, true> : &dispatch<26, false>)
                           : (multi ? &dispatch<36, true> : &dispatch<36, false>);
  return fn(q, k, v, sim, out, B, H, L, hd, mode, scale, sim_weight, stream);
}
