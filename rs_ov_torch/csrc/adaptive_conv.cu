// Adaptive (per-pixel) convolution, channel-first, on Hopper's tensor cores
// (sm_90a):
//
//   out[b, c, h, w] = sum_{u,v} filt[b, u*d+v, h, w] * inp[b, c, h+u, w+v]
//
// inp [B, C, H+d-1, W+d-1], filt [B, d*d, H, W] tap-major, out [B, C, H, W],
// all of one element type T: bf16 (K4a) or fp32 (K4b). Sums in fp32, one
// rounding to T at the end; bf16 taps are taken as they come (the caller
// rounds them, as rs_ov/upsample/jbu.py:190 does before the TPU kernel).
//
// Replaces the TPU kernels rs_ov/kernels/adaptive_conv_v5.py:
// adaptive_conv_pallas_v5 (K4a, bf16 banded MXU matmuls, a band per tap row)
// and rs_ov/kernels/adaptive_conv_v2.py:adaptive_conv_pallas_v2 (K4b, fp32
// VPU row streaming). Both become the v5 kernel's banded product, on
// mma.sync: K4a with bf16 operands (m16n8k16), K4b with TF32 operands
// (m16n8k8), every product as 3xTF32 (each operand split into hi + lo,
// split_tf32; hi*hi + hi*lo + lo*hi is the fp32 product within ~2^-21).
//
// What bounds it on the H100, at the main path's shapes (B=2, C=512, d=11,
// H=W=56): 2*B*C*H*W*d^2 = 777 M useful operations. K4a moves 16.9 MB of
// bf16 (input 8.9, taps 1.5, output 6.4): 5.0 us at 3.35 TB/s, and its bf16
// operations take 0.8 us at the tensor-core rate, so bytes bound it. K4b
// moves 33.7 MB (10.1 us); on the fp32 cores its operations took 11.6 us
// (67 TFLOP/s), as 3xTF32 they take 4.7 us (495 TFLOP/s), so on the tensor
// cores bytes bound it too. The band wastes (16 + d - 1 rounded up to the
// mma's k) / d of the products (32/11 at d = 11), the trade the TPU kernel
// makes; that still leaves K4a under a microsecond of tensor-core time.
// A first design on the fp32 cores, one output row per block, read each
// input row d times through L2 and ran at 13-33x these bounds.
//
// Design: one block of 256 threads (8 warps) per (b, R output rows x 16
// columns, CB channels); R (1, 2, 4 or 8) and CW, each warp's channels, are
// chosen by the caller (kernels/adaptive_conv.py:_tiling, from a sweep on
// the H100, PERF.md); CB = CW * 8 / R. Warp w owns output row j = w % R and
// channels (w / R) * CW .. + CW - 1 of the block's slice, for all 16 pixels.
//   copies: every operand reaches shared memory by cp.async, in the widest
//     of 16, 8 or 4 bytes that the rows' alignment allows (bf16 rows of odd
//     width: element by element through registers); each thread's pieces
//     are fixed columns of a few channels, walked by pointer increments.
//   taps: the d*d taps of the block's R x 16 pixels, staged once, tap-major
//     as they lie in device memory ([tap][R*16 + 8]: a band fragment's
//     loads hit distinct banks), in the first copy group.
//   source rows: the R + d - 1 rows h0 .. h0+R+d-2 of the slice, columns w0
//     .. w0+xw-1 (xw = 32 for d <= 17, else 64), pass through a ring of
//     staged rows [channel][x], three in flight. Each source row is read from
//     L2 once per block and feeds every output row it reaches: row s reaches
//     row j through tap row u = s - j. K4b splits each staged row once into
//     its TF32 hi and lo parts (one step ahead, into a double buffer), so
//     that the warps that read it load ready operands.
//   product: for row j and tap row u, A is the band [16 px][xw] with
//     A[p][x] = tap(p, u d + x - p) for 0 <= x - p < d, built in registers
//     from the staged taps (band_fragment, mma_sm90.cuh, K2's); B is the
//     staged row: [channel][x] is mma's .col layout of [k = x][n = channel],
//     so bf16 fragments come by plain ldmatrix and TF32 fragments by one
//     32-bit load each (row stride 4 mod 32 words: distinct banks).
//   output: the D fragments ([pixel][channel], fp32) are rounded to T and
//     written through shared memory (over the ring), so that each channel's
//     16 pixels leave as 16-byte stores where the row allows, else element
//     by element.
// Channels past C and pixels past H or W are computed on zeros and never
// stored. A NaN or infinity in the window reaches every pixel of its 16
// whose band spans it (0 * inf), as in the TPU's banded kernel.

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

// the ring: K4a reads row s while rows s+1 .. s+3 are in flight (4 rows);
// K4b splits row s+1 while s+2, s+3 are in flight (3 rows) and reads row s's
// split parts
template <typename T> struct Ring;
template <> struct Ring<bf16> { static constexpr int N = 4, WAIT = 2; };
template <> struct Ring<float> { static constexpr int N = 3, WAIT = 1; };

__host__ __device__ inline int band_width(int d) { return d <= 17 ? 32 : 64; }

struct Layout {
  int CB, xw, ldx, ldt;     // channels, staged columns, row strides (elements)
  size_t ring, split, total;  // byte offsets of the ring and of K4b's split rows, block bytes
};

// The block's shared memory: [taps][ring][split hi, lo x 2 (K4b)], the output
// stage over the ring and what follows it
template <typename T>
__host__ __device__ inline Layout make_layout(int d, int R, int CW) {
  constexpr int sz = sizeof(T);
  Layout L;
  L.CB = CW * (NWARP / R);
  L.xw = band_width(d);
  L.ldx = L.xw + 16 / sz;  // bf16 xw + 8 (ldmatrix rows 16 B apart, no conflicts),
                           // fp32 xw + 4 (4 mod 32 words)
  L.ldt = R * COLS + 8;
  const size_t taps = ((size_t)d * d * L.ldt * sz + 127) / 128 * 128;
  const size_t row = (size_t)L.CB * L.ldx * sz;
  const size_t work = Ring<T>::N * row + (sz == 4 ? 4 * row : 0);
  const size_t ostage = (size_t)NWARP * CW * (COLS + 16 / sz) * sz;
  L.ring = taps;
  L.split = taps + Ring<T>::N * row;
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
// dst [CB][ldx] (zeros past the source's edges and C), in VEC-byte pieces
// (VEC = 2: element by element through registers). Thread t takes piece
// t % per of channels t / per + k NT / per (per pieces a row, a power of
// two); the alignment that chose VEC puts each piece wholly inside or
// outside the row.
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

template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ inp, const Layout& L,
                                          int b, int C, int Hp, int Wp, int c0, int hs, int w0,
                                          int vec) {
  switch (vec) {
    case 16: stage_row_vec<T, 16>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0); break;
    case 8: stage_row_vec<T, 8>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0); break;
    case 4: stage_row_vec<T, 4>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0); break;
    default: stage_row_vec<T, 2>(dst, inp, L, b, C, Hp, Wp, c0, hs, w0); break;
  }
}

// The d*d taps of the block's R x 16 pixels into dst [tap][ldt] (pixel j*16
// + p at column j*16 + p; zeros past H and W), in VEC-byte pieces: piece q
// of row (tap t, row j) for each index i = (t R + j) ppr + q.
template <typename T, int VEC>
__device__ __forceinline__ void stage_taps_vec(T* dst, const T* __restrict__ filt,
                                               const Layout& L, int b, int H, int W, int d,
                                               int R, int h0, int w0) {
  constexpr int EV = VEC > (int)sizeof(T) ? VEC / (int)sizeof(T) : 1, PPR = COLS / EV;
  const int lr = __ffs(R) - 1, n = d * d * R * PPR;
  const T* fb = filt + (size_t)b * d * d * H * W;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int q = i % PPR, r = i / PPR, j = r & (R - 1), t = r >> lr, x = q * EV;
    const bool ok = h0 + j < H && w0 + x < W;
    T* to = dst + t * L.ldt + j * COLS + x;
    const T* from = fb + ((size_t)t * H + h0 + j) * W + w0 + x;
    if (VEC == 2)
      *to = ok ? *from : from_f32<T>(0.f);
    else
      copy_piece<VEC>(to, ok ? from : filt, ok);
  }
}

template <typename T>
__device__ __forceinline__ void stage_taps(T* dst, const T* __restrict__ filt, const Layout& L,
                                           int b, int H, int W, int d, int R, int h0, int w0,
                                           int vec) {
  switch (vec) {
    case 16: stage_taps_vec<T, 16>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    case 8: stage_taps_vec<T, 8>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    case 4: stage_taps_vec<T, 4>(dst, filt, L, b, H, W, d, R, h0, w0); break;
    default: stage_taps_vec<T, 2>(dst, filt, L, b, H, W, d, R, h0, w0); break;
  }
}

// K4b: staged fp32 row src [CB][ldx] -> its TF32 parts hi, lo (same layout),
// the first ncol columns, four at a time
__device__ __forceinline__ void split_row(uint32_t* hi, uint32_t* lo, const float* src,
                                          const Layout& L, int ncol) {
  const int per = ncol / 4;
  for (int i = threadIdx.x; i < L.CB * per; i += NT) {
    const int off = (i / per) * L.ldx + (i % per) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + off);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// acc[n-tile] += band(row j, tap row u) x staged row, over the warp's CW
// channels starting at nb; bf16 operands on m16n8k16. taps: tap 0 of pixel 0
// of row j, tap row u, in the tap-major stage.
template <int CW>
__device__ __forceinline__ void row_product(float (&acc)[CW / 8][4], const bf16* row,
                                            const bf16* taps, const Layout& L, int d, int nks,
                                            int nb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4, mi = lane >> 3;
  const unsigned short* tp = reinterpret_cast<const unsigned short*>(taps);
  // ldmatrix x4 rows: matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
  // (n 8-15, k 8-15) -> b0, b1 of n-tile 0 and of n-tile 1
  const bf16* brow = row + (nb + (lane & 7) + ((mi >> 1) << 3)) * L.ldx + ((mi & 1) << 3);
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t af[4];
    band_fragment(af, tp, 1, d, ks * 16 + 2 * tq, g, L.ldt);
#pragma unroll
    for (int pr = 0; pr < CW / 16; ++pr) {
      uint32_t bfr[4];
      ldsm_x4(bfr, brow + pr * 16 * L.ldx + ks * 16);
      mma_bf16(acc[2 * pr], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * pr + 1], af, bfr[2], bfr[3]);
    }
  }
}

// The same on fp32 operands: m16n8k8 TF32, every product as 3xTF32, B's
// parts ready in hi / lo.
template <int CW>
__device__ __forceinline__ void row_product(float (&acc)[CW / 8][4], const uint32_t* hi,
                                            const uint32_t* lo, const float* taps,
                                            const Layout& L, int d, int nks, int nb) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int off = (nb + g) * L.ldx + tq;
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t ah[4], al[4];
    band_fragment_tf32(ah, al, taps, 1, d, ks * 8 + tq, g, L.ldt);
#pragma unroll
    for (int nt = 0; nt < CW / 8; ++nt) {
      const int o = off + nt * 8 * L.ldx + ks * 8;
      const uint32_t bh[2] = {hi[o], hi[o + 4]}, bl[2] = {lo[o], lo[o + 4]};
      mma_tf32(acc[nt], al, bh);
      mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

template <typename T, int CW>
__global__ void __launch_bounds__(NT, 2)
adaptive_conv_kernel(const T* __restrict__ inp, const T* __restrict__ filt,
                     T* __restrict__ out, int C, int H, int W, int d, int R, int vec,
                     int vec_taps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NBUF = Ring<T>::N, KSTEP = kF32 ? 8 : 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(d, R, CW);
  T* s_taps = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + L.split);  // K4b: [2][hi, lo][CB][ldx]
  const int Hp = H + d - 1, Wp = W + d - 1, nrow = R + d - 1;
  const int n_cb = (C + L.CB - 1) / L.CB;
  const int b = blockIdx.z / n_cb, c0 = (blockIdx.z % n_cb) * L.CB;
  const int h0 = blockIdx.y * R, w0 = blockIdx.x * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int j = warp % R, nb = (warp / R) * CW;  // the warp's output row and first channel
  const bool busy = c0 + nb < C;                 // the warp has a channel to compute
  const int nks = (COLS + d - 1 + KSTEP - 1) / KSTEP;  // k steps that meet the band
  const int rowsz = L.CB * L.ldx;
  auto parts = [&](int s) { return split + (s % 2) * 2 * rowsz; };  // hi; lo = hi + rowsz

  // copy groups: taps and row 0, then rows 1 and 2
  stage_taps(s_taps, filt, L, b, H, W, d, R, h0, w0, vec_taps);
  for (int s = 0; s < 3; ++s) {
    if (s < nrow) stage_row(ring + s * rowsz, inp, L, b, C, Hp, Wp, c0, h0 + s, w0, vec);
    cp_async_commit();
  }
  if (kF32) {  // row 0's parts
    cp_async_wait<2>();
    __syncthreads();
    split_row(parts(0), parts(0) + rowsz, reinterpret_cast<const float*>(ring), L, nks * 8);
  }

  float acc[CW / 8][4];
#pragma unroll
  for (int t = 0; t < CW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int s = 0; s < nrow; ++s) {
    // K4a: row s has landed; K4b: row s + 1 has (two groups may be in flight)
    cp_async_wait<Ring<T>::WAIT>();
    __syncthreads();  // ... for every thread; the slots read before are free again
    if (s + 3 < nrow)
      stage_row(ring + ((s + 3) % NBUF) * rowsz, inp, L, b, C, Hp, Wp, c0, h0 + s + 3, w0,
                vec);
    cp_async_commit();
    if (kF32 && s + 1 < nrow)
      split_row(parts(s + 1), parts(s + 1) + rowsz,
                reinterpret_cast<const float*>(ring + ((s + 1) % NBUF) * rowsz), L, nks * 8);
    const int u = s - j;  // the tap row through which source row s reaches row j
    if (busy && u >= 0 && u < d) {
      const T* tp = s_taps + u * d * L.ldt + j * COLS;
      if constexpr (kF32)
        row_product<CW>(acc, parts(s), parts(s) + rowsz, tp, L, d, nks, nb);
      else
        row_product<CW>(acc, ring + (s % NBUF) * rowsz, tp, L, d, nks, nb);
    }
  }

  // D fragments -> the warp's [CW][ldo] output stage (over the ring) -> out
  const int ldo = COLS + 16 / sizeof(T);
  cp_async_wait<0>();
  __syncthreads();
  T* os = ring + warp * CW * ldo;
#pragma unroll
  for (int t = 0; t < CW / 8; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = t * 8 + 2 * tq, p = g + 8 * hf;
      os[n * ldo + p] = from_f32<T>(acc[t][2 * hf]);
      os[(n + 1) * ldo + p] = from_f32<T>(acc[t][2 * hf + 1]);
    }
  __syncwarp();
  if (!busy || h0 + j >= H) return;
  T* ob = out + (((size_t)b * C + c0 + nb) * H + h0 + j) * W + w0;
  const size_t plane = (size_t)H * W;
  const int ncw = min(CW, C - c0 - nb);
  if (w0 + COLS <= W && (W * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    constexpr int EV = 16 / sizeof(T), PER = COLS / EV;  // 16-byte pieces of a channel's row
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

template <typename T, int CW>
int launch_cw(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
              int R, cudaStream_t stream) {
  const Layout L = make_layout<T>(d, R, CW);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(adaptive_conv_kernel<T, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int vec = copy_width(inp, (size_t)(W + d - 1) * sizeof(T));
  const int vec_taps = copy_width(filt, (size_t)W * sizeof(T));
  dim3 grid((W + COLS - 1) / COLS, (H + R - 1) / R, B * ((C + L.CB - 1) / L.CB));
  adaptive_conv_kernel<T, CW><<<grid, NT, L.total, stream>>>(
      static_cast<const T*>(inp), static_cast<const T*>(filt), static_cast<T*>(out), C, H, W,
      d, R, vec, vec_taps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* inp, const void* filt, void* out, int B, int C, int H, int W, int d,
           int R, int CW, cudaStream_t stream) {
  if (d < 1 || d > 25 || (R != 1 && R != 2 && R != 4 && R != 8) || C < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  switch (CW) {
    case 16: return launch_cw<T, 16>(inp, filt, out, B, C, H, W, d, R, stream);
    case 32: return launch_cw<T, 32>(inp, filt, out, B, C, H, W, d, R, stream);
    case 64: return launch_cw<T, 64>(inp, filt, out, B, C, H, W, d, R, stream);
    case 128: return launch_cw<T, 128>(inp, filt, out, B, C, H, W, d, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: R, output rows per block; cw: channels per warp (16, 32, 64, 128)
extern "C" int rs_adaptive_conv_bf16(const void* inp, const void* filt, void* out,
                                     int B, int C, int H, int W, int d, int rows, int cw,
                                     cudaStream_t stream) {
  return launch<bf16>(inp, filt, out, B, C, H, W, d, rows, cw, stream);
}

extern "C" int rs_adaptive_conv_f32(const void* inp, const void* filt, void* out,
                                    int B, int C, int H, int W, int d, int rows, int cw,
                                    cudaStream_t stream) {
  return launch<float>(inp, filt, out, B, C, H, W, d, rows, cw, stream);
}

// A block's bytes of shared memory at (d, rows, cw) for elements of
// elem_bytes (2: bf16, 4: fp32); kernels/adaptive_conv.py:_smem_bytes mirrors it
extern "C" int rs_adaptive_conv_smem(int d, int rows, int cw, int elem_bytes) {
  return (int)(elem_bytes == 2 ? make_layout<bf16>(d, rows, cw) : make_layout<float>(d, rows, cw))
      .total;
}
