// The banded adaptive convolution on Hopper's tensor cores (sm_90a), shared
// by adaptive_conv.cu (channel-first input: K4a, K4b, K4c, and with both
// operands rounded to bf16 K4e, K4f) and adaptive_conv_cl.cu (channels-last
// input: K4d):
//
//   out[b, c, h, w] = sum_{u,v} filt[b, u*d+v, h, w] * inp[b, c, h+u, w+v]
//
// inp [B, C, H+d-1, W+d-1] (kCL: [B, H+d-1, W+d-1, C]) of element type Ti,
// filt [B, d*d, H, W] tap-major of element type Tf, out [B, C, H, W] of type
// Ti; Ti and Tf each bf16 or fp32, neither rounded to the other, or with
// kRound both rounded to bf16 (round to nearest even). Products and sums in
// fp32, one rounding to Ti at the end.
//
// The product by operand types:
//   bf16 x bf16, and every pair with kRound: mma.sync m16n8k16 on bf16
//     operands; the products are exact in fp32. kRound rounds fp32 taps as
//     they are staged and an fp32 input row once after it lands.
//   any fp32 operand without kRound: mma.sync m16n8k8 on TF32 operands, each
//     fp32 operand split into hi + lo (split_tf32, mma_sm90.cuh; hi*b + lo*b
//     is x*b within ~2^-21). bf16 values are exact in TF32, so a bf16
//     operand is not split: fp32 x fp32 takes three products (lo*hi + hi*lo
//     + hi*hi, 3xTF32), a bf16 input with fp32 taps or an fp32 input with
//     bf16 taps two.
//
// Design: one block of 256 threads (8 warps) per (b, R output rows x 16
// columns, CB channels); R (1, 2, 4 or 8) and CW, each warp's channels, are
// chosen by the caller (kernels/adaptive_conv.py:_tiling, from a sweep on
// the H100, PERF.md); CB = CW * 8 / R. Warp w owns output row j = w % R and
// channels (w / R) * CW .. + CW - 1 of the block's slice, for all 16 pixels.
//   copies: every operand reaches shared memory by cp.async, in the widest
//     of 16, 8 or 4 bytes that the rows' alignment allows (bf16 rows of odd
//     width: element by element through registers); each thread's pieces
//     are fixed columns (channel-first) or channels (channels-last).
//   taps: the d*d taps of the block's R x 16 pixels, staged once, tap-major
//     as they lie in device memory ([tap][R*16 + 8]: a band fragment's
//     loads hit distinct banks), in the first copy group; fp32 taps that
//     kRound rounds pass through registers instead, while the first rows'
//     copies are in flight, and are staged as bf16.
//   source rows: the R + d - 1 rows h0 .. h0+R+d-2 of the slice, columns w0
//     .. w0+xw-1 (xw = 32 for d <= 17, else 64), pass through a ring of
//     staged rows, three in flight. Each source row is read from L2 once per
//     block and feeds every output row it reaches: row s reaches row j
//     through tap row u = s - j. Channel-first, a staged row is [channel][x]:
//     mma's .col layout of B = [k = x][n = channel]. Channels-last it is
//     [x][channel], B row-major, every pixel's channels one contiguous run
//     (16-byte copies where C is a multiple of 8 in bf16 or of 4 in fp32).
//     On the TF32 product each staged row is split once into its TF32 parts
//     (one step ahead, into a double buffer), so that the warps that read it
//     load ready operands; kRound rounds a staged fp32 row the same way, once,
//     into a bf16 row [channel][xw + 8] that ldmatrix reads as a bf16 input's.
//   product: for row j and tap row u, A is the band [16 px][xw] with
//     A[p][x] = tap(p, u d + x - p) for 0 <= x - p < d, built in registers
//     from the staged taps (band_fragment, mma_sm90.cuh, K2's); B is the
//     staged row. bf16 fragments come by ldmatrix (channel-first) or
//     ldmatrix.trans (channels-last), TF32 fragments by one 32-bit load each
//     at a padded stride that puts a fragment's 32 loads in distinct banks.
//   output: the D fragments ([pixel][channel], fp32) are rounded to Ti and
//     written through shared memory (over the ring) to the channel-first
//     output, so that each channel's 16 pixels leave as 16-byte stores where
//     the row allows, else element by element.
// Channels past C and pixels past H or W are computed on zeros and never
// stored. A NaN or infinity in the window reaches every pixel of its 16
// whose band spans it (0 * inf), as in the TPU's banded kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace rs_ov;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int COLS = 16;           // output columns per block (the mma's m)
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use on Hopper
constexpr int MAX_D = 25;
constexpr int MAX_D_ROUNDED = 49;  // kRound: the widest band, 16 + d - 1 <= 64 columns

// The product of an operand pair (kRound: both rounded to bf16 first). A
// bf16 input row feeding the bf16 product is read as it landed: row s while
// rows s+1 .. s+3 are in flight (a ring of 4). Any other row is made into
// the product's operand one step ahead: row s+1 while s+2, s+3 are in
// flight (3), and row s's is read; the TF32 product splits it into parts
// hi, and lo where the input is fp32, kRound rounds an fp32 row into one
// bf16 part.
template <typename Ti, typename Tf, bool kRound>
struct Product {
  static constexpr bool kF32In = std::is_same<Ti, float>::value;
  static constexpr bool kBF16 = kRound || (!kF32In && std::is_same<Tf, bf16>::value);
  static constexpr bool kDirect = kBF16 && !kF32In;  // the mma reads the staged row itself
  static constexpr bool kSplitB = !kBF16 && kF32In;  // the input's lo part
  static constexpr int RING = kDirect ? 4 : 3, WAIT = kDirect ? 2 : 1, KSTEP = kBF16 ? 16 : 8;
  static constexpr int PARTS = kDirect ? 0 : (kSplitB ? 2 : 1);
  static constexpr int PART_SZ = kBF16 ? 2 : 4;  // bytes of a part's element
  typedef typename std::conditional<kRound, bf16, Tf>::type Ts;  // the staged taps' type
};

__host__ __device__ inline int band_width(int d) { return d <= 17 ? 32 : 64; }

struct Layout {
  int CB, xw;      // channels, staged columns
  int lines;       // lines of a staged row: CB channel-first, xw channels-last
  int ldx, lds;    // line strides of a staged row and of its parts (elements of each)
  int ldt;         // the taps' row stride (elements)
  size_t ring, split, part, total;  // byte offsets of the ring and of the parts, part bytes,
                                    // block bytes
};

// The block's shared memory: [taps][ring][parts: 2 x (hi[, lo] or rounded)],
// the output stage over the ring and what follows it. Line strides:
// channel-first bf16 xw + 8 (ldmatrix rows 16 B apart, no conflicts), fp32
// xw + 4, TF32 parts xw + 4 words (4 mod 32), rounded parts xw + 8 bf16 (a
// bf16 input's); channels-last CB + 8 bf16 (an odd count of 16 B for
// ldmatrix.trans), CB + 4 fp32, parts CB + 8 words (8 or 24 mod 32).
template <typename Ti, typename Tf, bool kCL, bool kRound>
__host__ __device__ inline Layout make_layout(int d, int R, int CW) {
  typedef Product<Ti, Tf, kRound> P;
  static_assert(!(kCL && kRound), "the rounded product is channel-first only");
  constexpr int szi = sizeof(Ti), szf = sizeof(typename P::Ts);
  Layout L;
  L.CB = CW * (NWARP / R);
  L.xw = band_width(d);
  L.lines = kCL ? L.xw : L.CB;
  L.ldx = (kCL ? L.CB : L.xw) + 16 / szi;
  L.lds = P::kBF16 ? L.xw + 8 : (kCL ? L.CB + 8 : L.xw + 4);
  L.ldt = R * COLS + 8;
  const size_t taps = ((size_t)d * d * L.ldt * szf + 127) / 128 * 128;
  const size_t row = (size_t)L.lines * L.ldx * szi;
  L.part = (size_t)L.lines * L.lds * P::PART_SZ;
  const size_t work = P::RING * row + 2 * P::PARTS * L.part;
  const size_t ostage = (size_t)NWARP * CW * (COLS + 16 / szi) * szi;
  L.ring = taps;
  L.split = taps + P::RING * row;
  L.total = taps + (work > ostage ? work : ostage);
  return L;
}

template <int VEC>
__device__ __forceinline__ void copy_piece(void* to, const void* from, bool ok) {
  if (VEC == 16)
    cp_async16(to, from, ok ? 16 : 0);
  else if (VEC == 8)
    cp_async8(to, from, ok ? 8 : 0);
  else
    cp_async4(to, from, ok ? 4 : 0);
}

// Source row hs of the block's channel slice, columns w0 .. w0+xw-1, into
// dst (zeros past the source's edges and C), in VEC-byte pieces (VEC = 2:
// element by element through registers); the alignment that chose VEC puts
// each piece wholly inside or outside the row.
// Channel-first, dst [CB][ldx]: thread t takes piece t % per of channels
// t / per + k NT / per (per pieces a row, a power of two).
template <typename T, int VEC>
__device__ __forceinline__ void stage_row_vec(T* dst, const T* __restrict__ inp,
                                              const Layout& L, int b, int C, int Hp, int Wp,
                                              int c0, int hs, int w0) {
  constexpr int EV = VEC > (int)sizeof(T) ? VEC / (int)sizeof(T) : 1;
  const int per = L.xw / EV, dc = NT / per, x = (threadIdx.x % per) * EV;
  const size_t plane = (size_t)Hp * Wp;
  const int cmax = (hs < Hp && w0 + x < Wp) ? min(L.CB, C - c0) : 0;  // channels with data
  int c = threadIdx.x / per;
  T* to = dst + c * L.ldx + x;
  const T* from = inp + (((size_t)b * C + c0 + c) * Hp + hs) * Wp + w0 + x;
  for (; c < L.CB; c += dc, to += dc * L.ldx, from += dc * plane) {
    const bool ok = c < cmax;
    if (VEC == 2)
      *to = ok ? *from : from_f32<T>(0.f);
    else
      copy_piece<VEC>(to, ok ? from : inp, ok);
  }
}

// Channels-last, dst [xw][ldx]: piece i takes channels (i % per) * EV .. of
// column i / per (per = CB / EV pieces a column, a power of two), so that
// neighbouring threads copy neighbouring bytes of one source pixel.
template <typename T, int VEC>
__device__ __forceinline__ void stage_row_cl_vec(T* dst, const T* __restrict__ inp,
                                                 const Layout& L, int b, int C, int Hp, int Wp,
                                                 int c0, int hs, int w0) {
  constexpr int EV = VEC > (int)sizeof(T) ? VEC / (int)sizeof(T) : 1;
  const int per = L.CB / EV, lp = __ffs(per) - 1, n = L.xw * per;
  const int xmax = hs < Hp ? min(L.xw, Wp - w0) : 0;  // columns with data
  const T* src = inp + (((size_t)b * Hp + hs) * Wp + w0) * C + c0;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int x = i >> lp, c = (i & (per - 1)) * EV;
    const bool ok = x < xmax && c0 + c < C;
    T* to = dst + x * L.ldx + c;
    const T* from = src + (size_t)x * C + c;
    if (VEC == 2)
      *to = ok ? *from : from_f32<T>(0.f);
    else
      copy_piece<VEC>(to, ok ? from : inp, ok);
  }
}

template <typename T, bool kCL>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ inp, const Layout& L,
                                          int b, int C, int Hp, int Wp, int c0, int hs, int w0,
                                          int vec) {
#define RS_OV_STAGE(V)                                                  \
  if constexpr (kCL)                                                    \
    stage_row_cl_vec<T, V>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0);      \
  else                                                                  \
    stage_row_vec<T, V>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0);         \
  break;
  switch (vec) {
    case 16: RS_OV_STAGE(16)
    case 8: RS_OV_STAGE(8)
    case 4: RS_OV_STAGE(4)
    default: RS_OV_STAGE(2)
  }
#undef RS_OV_STAGE
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

// EV fp32 values at from (zeros where !ok) rounded to bf16 into to
template <int EV>
__device__ __forceinline__ void round_piece(bf16* to, const float* __restrict__ from, bool ok) {
  if (EV == 4) {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(from)) : make_float4(0, 0, 0, 0);
    *reinterpret_cast<uint2*>(to) = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  } else if (EV == 2) {
    const float2 v = ok ? __ldg(reinterpret_cast<const float2*>(from)) : make_float2(0, 0);
    *reinterpret_cast<uint32_t*>(to) = bf16_pair(v.x, v.y);
  } else {
    *to = __float2bfloat16_rn(ok ? __ldg(from) : 0.f);
  }
}

// The d*d taps of the block's R x 16 pixels into dst [tap][ldt] (pixel j*16
// + p at column j*16 + p; zeros past H and W), in VEC-byte pieces: piece q
// of row (tap t, row j) for each index i = (t R + j) ppr + q. Taps staged in
// their own type T come by cp.async; fp32 taps staged as bf16 (Ts) are read
// through registers and rounded.
template <typename Ts, typename T, int VEC>
__device__ __forceinline__ void stage_taps_vec(Ts* dst, const T* __restrict__ filt,
                                               const Layout& L, int b, int H, int W, int d,
                                               int R, int h0, int w0) {
  constexpr int EV = VEC > (int)sizeof(T) ? VEC / (int)sizeof(T) : 1, PPR = COLS / EV;
  const int lr = __ffs(R) - 1, n = d * d * R * PPR;
  const T* fb = filt + (size_t)b * d * d * H * W;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int q = i % PPR, r = i / PPR, j = r & (R - 1), t = r >> lr, x = q * EV;
    const bool ok = h0 + j < H && w0 + x < W;
    Ts* to = dst + t * L.ldt + j * COLS + x;
    const T* from = fb + ((size_t)t * H + h0 + j) * W + w0 + x;
    if constexpr (!std::is_same<Ts, T>::value)
      round_piece<EV>(to, from, ok);
    else if (VEC == 2)
      *to = ok ? *from : from_f32<T>(0.f);
    else
      copy_piece<VEC>(to, ok ? from : filt, ok);
  }
}

template <typename Ts, typename T>
__device__ __forceinline__ void stage_taps(Ts* dst, const T* __restrict__ filt, const Layout& L,
                                           int b, int H, int W, int d, int R, int h0, int w0,
                                           int vec) {
  switch (vec) {
    case 16: stage_taps_vec<Ts, T, 16>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    case 8: stage_taps_vec<Ts, T, 8>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    case 4: stage_taps_vec<Ts, T, 4>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    default: stage_taps_vec<Ts, T, 2>(dst, filt, L, b, H, W, d, R, h0, w0); break;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// The TF32 product's operand B: the staged row src (lines of ldx elements)
// -> its TF32 parts hi and, for an fp32 input, lo (lines of lds words), the
// first ne elements of nl lines, four at a time. A bf16 value is exact in
// TF32: its hi is its fp32 bits.
template <typename Ti>
__device__ __forceinline__ void split_row(uint32_t* hi, uint32_t* lo, const Ti* src,
                                          const Layout& L, int nl, int ne) {
  const int per = ne / 4;
  for (int i = threadIdx.x; i < nl * per; i += NT) {
    const int l = i / per, e = (i % per) * 4;
    float v[4];
    load4(src + l * L.ldx + e, v);
    uint4 h;
    if constexpr (std::is_same<Ti, float>::value) {
      uint4 w;
      split_tf32(v[0], h.x, w.x);
      split_tf32(v[1], h.y, w.y);
      split_tf32(v[2], h.z, w.z);
      split_tf32(v[3], h.w, w.w);
      *reinterpret_cast<uint4*>(lo + l * L.lds + e) = w;
    } else {
      h = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                     __float_as_uint(v[3]));
    }
    *reinterpret_cast<uint4*>(hi + l * L.lds + e) = h;
  }
}

// The rounded product's operand B from an fp32 input: the staged row src
// (lines of ldx elements) rounded to bf16 (round to nearest even) into dst
// (lines of lds elements, the layout ldmatrix reads), the first ne elements
// of nl lines, four at a time.
__device__ __forceinline__ void round_row(bf16* dst, const float* src, const Layout& L, int nl,
                                          int ne) {
  const int per = ne / 4;
  for (int i = threadIdx.x; i < nl * per; i += NT) {
    const int l = i / per, e = (i % per) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + l * L.ldx + e);
    *reinterpret_cast<uint2*>(dst + l * L.lds + e) =
        make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  }
}

// acc[n-tile] += band(row j, tap row u) x row (lines ld elements apart),
// over the warp's CW channels starting at nb; bf16 operands on m16n8k16.
// taps: tap 0 of pixel 0 of row j, tap row u, in the tap-major stage.
template <int CW, bool kCL>
__device__ __forceinline__ void row_product(float (&acc)[CW / 8][4], const bf16* row, int ld,
                                            const bf16* taps, const Layout& L, int d, int nks,
                                            int nb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4, mi = lane >> 3;
  const unsigned short* tp = reinterpret_cast<const unsigned short*>(taps);
  // ldmatrix x4 matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
  // (n 8-15, k 8-15) -> b0, b1 of n-tile 0 and of n-tile 1; lane l gives
  // row l & 7 of matrix l >> 3: channel-first a row is a channel (plain
  // loads), channels-last a column x (transposed loads)
  const bf16* brow =
      kCL ? row + ((lane & 7) + ((mi & 1) << 3)) * ld + nb + ((mi >> 1) << 3)
          : row + (nb + (lane & 7) + ((mi >> 1) << 3)) * ld + ((mi & 1) << 3);
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t af[4];
    band_fragment(af, tp, 1, d, ks * 16 + 2 * tq, g, L.ldt);
#pragma unroll
    for (int pr = 0; pr < CW / 16; ++pr) {
      uint32_t bfr[4];
      if (kCL)
        ldsm_x4_trans(bfr, brow + ks * 16 * ld + pr * 16);
      else
        ldsm_x4(bfr, brow + pr * 16 * ld + ks * 16);
      mma_bf16(acc[2 * pr], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * pr + 1], af, bfr[2], bfr[3]);
    }
  }
}

// The same on the TF32 product: m16n8k8, B's parts ready in hi (and lo for
// an fp32 input), A split where the taps are fp32; fp32 x fp32 as 3xTF32,
// the small terms first.
template <int CW, bool kCL, typename Tf, bool kSplitB>
__device__ __forceinline__ void row_product(float (&acc)[CW / 8][4], const uint32_t* hi,
                                            const uint32_t* lo, const Tf* taps,
                                            const Layout& L, int d, int nks, int nb) {
  constexpr bool kSplitA = std::is_same<Tf, float>::value;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int step = kCL ? 4 * L.lds : 4;  // from b0 (k = tq) to b1 (k = tq + 4)
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t ah[4], al[4];
    if constexpr (kSplitA)
      band_fragment_tf32(ah, al, taps, 1, d, ks * 8 + tq, g, L.ldt);
    else
      band_fragment_tf32(ah, reinterpret_cast<const unsigned short*>(taps), 1, d, ks * 8 + tq,
                         g, L.ldt);
#pragma unroll
    for (int nt = 0; nt < CW / 8; ++nt) {
      const int o = kCL ? (ks * 8 + tq) * L.lds + nb + nt * 8 + g
                        : (nb + nt * 8 + g) * L.lds + ks * 8 + tq;
      const uint32_t bh[2] = {hi[o], hi[o + step]};
      if constexpr (kSplitA) mma_tf32(acc[nt], al, bh);
      if constexpr (kSplitB) {
        const uint32_t bl[2] = {lo[o], lo[o + step]};
        mma_tf32(acc[nt], ah, bl);
      }
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

template <typename Ti, typename Tf, int CW, bool kCL, bool kRound>
__global__ void __launch_bounds__(NT, 2)
adaptive_conv_kernel(const Ti* __restrict__ inp, const Tf* __restrict__ filt,
                     Ti* __restrict__ out, int C, int H, int W, int d, int R, int vec,
                     int vec_taps) {
  typedef Product<Ti, Tf, kRound> P;
  typedef typename P::Ts Ts;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<Ti, Tf, kCL, kRound>(d, R, CW);
  Ts* s_taps = reinterpret_cast<Ts*>(smem);
  Ti* ring = reinterpret_cast<Ti*>(smem + L.ring);
  const int Hp = H + d - 1, Wp = W + d - 1, nrow = R + d - 1;
  const int n_cb = (C + L.CB - 1) / L.CB;
  const int b = blockIdx.z / n_cb, c0 = (blockIdx.z % n_cb) * L.CB;
  const int h0 = blockIdx.y * R, w0 = blockIdx.x * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int j = warp % R, nb = (warp / R) * CW;  // the warp's output row and first channel
  const bool busy = c0 + nb < C;                 // the warp has a channel to compute
  const int nks = (COLS + d - 1 + P::KSTEP - 1) / P::KSTEP;  // k steps that meet the band
  const int rowsz = L.lines * L.ldx;
  // the parts of row s ([2][hi, lo or rounded][lines][lds]) cover the columns
  // the k steps reach
  auto parts = [&](int s) { return smem + L.split + (s % 2) * P::PARTS * L.part; };
  const int nl = kCL ? nks * P::KSTEP : L.CB, ne = kCL ? L.CB : nks * P::KSTEP;
  // staged row s -> the product's operand: its TF32 parts, or rounded to bf16
  auto prepare = [&](int s) {
    const Ti* src = ring + (s % P::RING) * rowsz;
    unsigned char* p = parts(s);
    if constexpr (P::kDirect) {
    } else if constexpr (P::kBF16) {
      round_row(reinterpret_cast<bf16*>(p), src, L, nl, ne);
    } else {
      split_row(reinterpret_cast<uint32_t*>(p), reinterpret_cast<uint32_t*>(p + L.part), src,
                L, nl, ne);
    }
  };

  // copy groups: taps and row 0, then rows 1 and 2; taps rounded to bf16 on
  // the way are read while the rows are in flight
  constexpr bool kRoundTaps = !std::is_same<Ts, Tf>::value;
  if constexpr (!kRoundTaps) stage_taps(s_taps, filt, L, b, H, W, d, R, h0, w0, vec_taps);
  for (int s = 0; s < 3; ++s) {
    if (s < nrow)
      stage_row<Ti, kCL>(ring + s * rowsz, inp, L, b, C, Hp, Wp, c0, h0 + s, w0, vec);
    cp_async_commit();
  }
  if constexpr (kRoundTaps) stage_taps(s_taps, filt, L, b, H, W, d, R, h0, w0, vec_taps);
  if constexpr (!P::kDirect) {  // row 0's operand
    cp_async_wait<2>();
    __syncthreads();
    prepare(0);
  }

  float acc[CW / 8][4];
#pragma unroll
  for (int t = 0; t < CW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int s = 0; s < nrow; ++s) {
    // a row read as it landed (kDirect): row s has landed; else row s + 1
    // has (two groups may be in flight)
    cp_async_wait<P::WAIT>();
    __syncthreads();  // ... for every thread; the slots read before are free again
    if (s + 3 < nrow)
      stage_row<Ti, kCL>(ring + ((s + 3) % P::RING) * rowsz, inp, L, b, C, Hp, Wp, c0,
                         h0 + s + 3, w0, vec);
    cp_async_commit();
    if constexpr (!P::kDirect)
      if (s + 1 < nrow) prepare(s + 1);
    const int u = s - j;  // the tap row through which source row s reaches row j
    if (busy && u >= 0 && u < d) {
      const Ts* tp = s_taps + u * d * L.ldt + j * COLS;
      if constexpr (P::kDirect)
        row_product<CW, kCL>(acc, ring + (s % P::RING) * rowsz, L.ldx, tp, L, d, nks, nb);
      else if constexpr (P::kBF16)
        row_product<CW, kCL>(acc, reinterpret_cast<const bf16*>(parts(s)), L.lds, tp, L, d,
                             nks, nb);
      else
        row_product<CW, kCL, Tf, P::kSplitB>(acc, reinterpret_cast<const uint32_t*>(parts(s)),
                                             reinterpret_cast<const uint32_t*>(parts(s) + L.part),
                                             tp, L, d, nks, nb);
    }
  }

  // D fragments -> the warp's [CW][ldo] output stage (over the ring) -> out
  const int ldo = COLS + 16 / sizeof(Ti);
  cp_async_wait<0>();
  __syncthreads();
  Ti* os = ring + warp * CW * ldo;
#pragma unroll
  for (int t = 0; t < CW / 8; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = t * 8 + 2 * tq, p = g + 8 * hf;
      os[n * ldo + p] = from_f32<Ti>(acc[t][2 * hf]);
      os[(n + 1) * ldo + p] = from_f32<Ti>(acc[t][2 * hf + 1]);
    }
  __syncwarp();
  if (!busy || h0 + j >= H) return;
  Ti* ob = out + (((size_t)b * C + c0 + nb) * H + h0 + j) * W + w0;
  const size_t plane = (size_t)H * W;
  const int ncw = min(CW, C - c0 - nb);
  if (w0 + COLS <= W && (W * sizeof(Ti)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    constexpr int EV = 16 / sizeof(Ti), PER = COLS / EV;  // 16-byte pieces of a channel's row
    for (int i = lane; i < ncw * PER; i += 32) {
      const int n = i / PER, x = (i % PER) * EV;
      *reinterpret_cast<uint4*>(ob + n * plane + x) =
          *reinterpret_cast<const uint4*>(os + n * ldo + x);
    }
  } else {
    for (int i = lane; i < ncw * COLS; i += 32) {
      const int n = i / COLS, x = i % COLS;
      if (w0 + x < W) ob[n * plane + x] = os[n * ldo + x];
    }
  }
}

// The widest copy, of 16, 8 or 4 bytes, that rows of row_bytes starting at
// base allow; 2 (element by element) where none does
inline int copy_width(const void* base, size_t row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v /= 2)
    if (a % v == 0 && row_bytes % v == 0) return v;
  return 2;
}

template <typename Ti, typename Tf, bool kCL, bool kRound, int CW>
int launch_cw(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
              int R, cudaStream_t stream) {
  // bf16 x bf16 has nothing to round: kRound takes the unrounded instantiation
  constexpr bool kR = kRound && !Product<Ti, Tf, false>::kBF16;
  const auto kernel = adaptive_conv_kernel<Ti, Tf, CW, kCL, kR>;
  const Layout L = make_layout<Ti, Tf, kCL, kR>(d, R, CW);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  // channel-first rows of W + d - 1 elements; channels-last pixels of C
  const int vec = copy_width(inp, (size_t)(kCL ? C : W + d - 1) * sizeof(Ti));
  const int vec_taps = copy_width(filt, (size_t)W * sizeof(Tf));
  dim3 grid((W + COLS - 1) / COLS, (H + R - 1) / R, B * ((C + L.CB - 1) / L.CB));
  kernel<<<grid, NT, L.total, stream>>>(static_cast<const Ti*>(inp), static_cast<const Tf*>(filt),
                                        static_cast<Ti*>(out), C, H, W, d, R, vec, vec_taps);
  return (int)cudaGetLastError();
}

template <typename Ti, typename Tf, bool kCL, bool kRound = false>
int launch(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
           int R, int CW, cudaStream_t stream) {
  if (d < 1 || d > (kRound ? MAX_D_ROUNDED : MAX_D) || (R != 1 && R != 2 && R != 4 && R != 8) ||
      C < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  switch (CW) {
    case 16: return launch_cw<Ti, Tf, kCL, kRound, 16>(inp, filt, out, B, C, H, W, d, R, stream);
    case 32: return launch_cw<Ti, Tf, kCL, kRound, 32>(inp, filt, out, B, C, H, W, d, R, stream);
    case 64: return launch_cw<Ti, Tf, kCL, kRound, 64>(inp, filt, out, B, C, H, W, d, R, stream);
    case 128:
      return launch_cw<Ti, Tf, kCL, kRound, 128>(inp, filt, out, B, C, H, W, d, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the launchers of one layout for each operand pair, [input is bf16][taps are bf16]
typedef int (*Launch)(const void*, const void*, void*, int, int, int, int, int, int, int,
                      cudaStream_t);

template <bool kCL, bool kRound = false>
int launch_pair(const void* inp, const void* filt, void* out, int B, int C, int H, int W,
                int d, int inp_bf16, int filt_bf16, int R, int CW, cudaStream_t stream) {
  static const Launch table[2][2] = {
      {launch<float, float, kCL, kRound>, launch<float, bf16, kCL, kRound>},
      {launch<bf16, float, kCL, kRound>, launch<bf16, bf16, kCL, kRound>}};
  return table[inp_bf16 != 0][filt_bf16 != 0](inp, filt, out, B, C, H, W, d, R, CW, stream);
}

}  // namespace
