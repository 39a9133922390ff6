// The PTX building blocks shared by the hand-written kernels (K2/K3 in
// jbu_classify_sm90.cu, K6 in selfself_attention_sm90.cu and
// selfself_attention_f32_sm90.cu, K1 in range_logits.cu, K4a-K4d in
// adaptive_conv.cuh): cp.async copies into shared memory, ldmatrix loads of
// mma fragments, mma.sync m16n8k16 with bf16 operands and m16n8k8 with TF32
// operands, both with fp32 sums, the split of an fp32 value into two TF32
// parts, and the A fragments of the adaptive conv's band (K2's and K4's).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rs_ov {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// D += A B: A 16x16 row-major, B 16x8 column-major, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B: A 16x8 row-major, B 8x8 column-major, TF32 operands, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo: hi = x rounded to the nearest TF32 value (ties away from zero;
// x finite), lo = x - hi, exact in fp32 and within 2^-11 of |x|. The tensor
// core reads a TF32 operand's top 19 bits, so lo enters a product as its own
// first 11 bits: hi b + lo b is x b within ~2^-21 of |x b|. Three integer
// and float operations; cvt.rna.tf32.f32 takes four for hi alone.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The adaptive conv as banded products (K2, K3, K5 and K4a-K4d): for 16
// neighbouring output pixels p of one row and one tap row u, the band
// A[p][x] = tap(p, u d + x - p) for 0 <= x - p < d (else 0), over the
// window's columns x, times the source row's window [x][channel]. Tap v of
// pixel p (of tap row u) lies at taps[p ps + v ts]: K2 keeps a pixel's taps
// together (ps = d*d, ts = 1), K4 each tap's pixels (ps = 1).

// Taps v and v+1 of one pixel's tap row as a bf16 pair (zero outside 0..d-1)
__device__ __forceinline__ uint32_t tap_pair(const unsigned short* row, int v, int d,
                                             int ts = 1) {
  const uint32_t lo = (v >= 0 && v < d) ? row[v * ts] : 0u;
  const uint32_t hi = (v + 1 >= 0 && v + 1 < d) ? row[(v + 1) * ts] : 0u;
  return lo | (hi << 16);
}

// mma m16n8k16's A fragment of the band from bf16 taps, columns x0 ..
// x0+15 (x0 a multiple of 16): rows g and g+8, columns x and x+8, x = x0 +
// 2 (lane % 4). taps points at tap 0 of the row's pixel 0, tap row u.
__device__ __forceinline__ void band_fragment(uint32_t (&af)[4], const unsigned short* taps,
                                              int ps, int d, int x, int g, int ts = 1) {
  const unsigned short* p0 = taps + g * ps;
  const unsigned short* p8 = p0 + 8 * ps;
  af[0] = tap_pair(p0, x - g, d, ts);
  af[1] = tap_pair(p8, x - g - 8, d, ts);
  af[2] = tap_pair(p0, x + 8 - g, d, ts);
  af[3] = tap_pair(p8, x - g, d, ts);
}

// mma m16n8k8 (TF32)'s A fragment of the band from fp32 taps, columns x0 ..
// x0+7: rows g and g+8, columns x and x+4, x = x0 + lane % 4; each entry
// split into its hi and lo TF32 parts (3xTF32).
__device__ __forceinline__ void band_fragment_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                   const float* taps, int ps, int d, int x,
                                                   int g, int ts = 1) {
  const float* p0 = taps + g * ps;
  const float* p8 = p0 + 8 * ps;
  const int v[4] = {x - g, x - g - 8, x + 4 - g, x - 4 - g};
  const float* row[4] = {p0, p8, p0, p8};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32((v[i] >= 0 && v[i] < d) ? row[i][v[i] * ts] : 0.f, hi[i], lo[i]);
}

// The same fragment from bf16 taps: a bf16 value is exact in TF32 (its fp32
// bits), so it needs no lo part.
__device__ __forceinline__ void band_fragment_tf32(uint32_t (&a)[4], const unsigned short* taps,
                                                   int ps, int d, int x, int g, int ts = 1) {
  const unsigned short* p0 = taps + g * ps;
  const unsigned short* p8 = p0 + 8 * ps;
  const int v[4] = {x - g, x - g - 8, x + 4 - g, x - 4 - g};
  const unsigned short* row[4] = {p0, p8, p0, p8};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (v[i] >= 0 && v[i] < d) ? (uint32_t)row[i][v[i] * ts] << 16 : 0u;
}

}  // namespace rs_ov
