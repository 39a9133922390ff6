// Adaptive (per-pixel) convolution, channel-first, on Hopper's tensor cores
// (sm_90a): the banded kernel of adaptive_conv.cuh on NCHW input,
//
//   out[b, c, h, w] = sum_{u,v} filt[b, u*d+v, h, w] * inp[b, c, h+u, w+v]
//
// inp [B, C, H+d-1, W+d-1], filt [B, d*d, H, W] tap-major, out [B, C, H, W]
// in inp's type. Sums in fp32, one rounding at the end.
//
// Replaces the TPU kernels rs_ov/kernels/adaptive_conv_v5.py:
// adaptive_conv_pallas_v5 (K4a, bf16 banded MXU matmuls, a band per tap
// row), rs_ov/kernels/adaptive_conv_v2.py:adaptive_conv_pallas_v2 (K4b, fp32
// VPU row streaming), rs_ov/kernels/adaptive_conv.py:
// adaptive_conv_pallas_planes (K4c: the input resident per channel block,
// tap planes streamed by DMA; each operand bf16 or fp32 in its own type),
// rs_ov/kernels/adaptive_conv_v3.py:adaptive_conv_pallas_v3 (K4e: both
// operands rounded to bf16, one banded bf16 MXU product per output row and
// tap row, fp32 sums, the output in the input's type) and
// rs_ov/kernels/adaptive_conv_v4.py:adaptive_conv_pallas_v4 (K4f: K4e's
// function in output-column chunks of min(112, pad8(W)), so that a chunk's
// band fits the MXU's 128-lane K window, d <= 17). All five become the v5
// kernel's banded product on mma.sync: K4a (bf16 operands, rounded by its
// caller as rs_ov/upsample/jbu.py:190 does) on m16n8k16, K4b (fp32) as
// 3xTF32 on m16n8k8, K4c on whichever of the two its operand pair takes (two
// TF32 products where one side is bf16), K4e and K4f on m16n8k16 with fp32
// operands rounded as they are staged (kRound). On the card K4f's column
// chunk is only a tiling of the kernel's 16-column blocks, so K4f is K4e's
// launch, refusing d > 17 as the TPU kernel does.
//
// What bounds it on the H100, at the main path's shapes (B=2, C=512, d=11,
// H=W=56): 2*B*C*H*W*d^2 = 777 M useful operations. K4a moves 16.9 MB of
// bf16 (input 8.9, taps 1.5, output 6.4): 5.0 us at 3.35 TB/s, and its bf16
// operations take 0.8 us at the tensor-core rate, so bytes bound it. K4b
// moves 33.7 MB (10.1 us); on the fp32 cores its operations took 11.6 us
// (67 TFLOP/s), as 3xTF32 they take 4.7 us (495 TFLOP/s), so on the tensor
// cores bytes bound it too, and K4c with it, between the two (a bf16 input
// with fp32 taps moves 18.4 MB, two TF32 products take 3.1 us). K4e/K4f
// move K4c's bytes for the same pair and take K4a's 0.8 us of bf16
// operations: bytes bound them. The band wastes (16 + d - 1 rounded up to
// the mma's k) / d of the products (32/11 at d = 11), the trade the TPU
// kernel makes. First designs on the fp32 cores (one output row a block
// for K4a/K4b, the input window staged in fp32 for K4c, one pixel a thread
// with taps streamed from device memory for K4e/K4f) ran at 13-33x these
// bounds.

#include "adaptive_conv.cuh"

// rows: R, output rows per block; cw: channels per warp (16, 32, 64, 128)
extern "C" int rs_adaptive_conv_bf16(const void* inp, const void* filt, void* out,
                                     int B, int C, int H, int W, int d, int rows, int cw,
                                     cudaStream_t stream) {
  return launch<bf16, bf16, false>(inp, filt, out, B, C, H, W, d, rows, cw, stream);
}

extern "C" int rs_adaptive_conv_f32(const void* inp, const void* filt, void* out,
                                    int B, int C, int H, int W, int d, int rows, int cw,
                                    cudaStream_t stream) {
  return launch<float, float, false>(inp, filt, out, B, C, H, W, d, rows, cw, stream);
}

// K4c: each operand in its own type (inp_bf16, filt_bf16: 1 for bf16, 0 for fp32)
extern "C" int rs_adaptive_conv_planes(const void* inp, const void* filt, void* out,
                                       int B, int C, int H, int W, int d, int inp_bf16,
                                       int filt_bf16, int rows, int cw, cudaStream_t stream) {
  return launch_pair<false>(inp, filt, out, B, C, H, W, d, inp_bf16, filt_bf16, rows, cw,
                            stream);
}

// K4e: both operands rounded to bf16 (inp_bf16, filt_bf16 as for K4c); d <= 49
extern "C" int rs_adaptive_conv_v3(const void* inp, const void* filt, void* out, int B, int C,
                                   int H, int W, int d, int inp_bf16, int filt_bf16, int rows,
                                   int cw, cudaStream_t stream) {
  return launch_pair<false, true>(inp, filt, out, B, C, H, W, d, inp_bf16, filt_bf16, rows, cw,
                                  stream);
}

// K4f: K4e's launch; d <= 17, as the TPU kernel takes
extern "C" int rs_adaptive_conv_v4(const void* inp, const void* filt, void* out, int B, int C,
                                   int H, int W, int d, int inp_bf16, int filt_bf16, int rows,
                                   int cw, cudaStream_t stream) {
  if (d > 17) return (int)cudaErrorInvalidValue;
  return rs_adaptive_conv_v3(inp, filt, out, B, C, H, W, d, inp_bf16, filt_bf16, rows, cw,
                             stream);
}

namespace {

template <bool kCL, bool kRound>
Layout pair_layout(bool inp_bf16, bool filt_bf16, int d, int rows, int cw) {
  // bf16 x bf16 has nothing to round (launch_cw)
  return inp_bf16 ? (filt_bf16 ? make_layout<bf16, bf16, kCL, false>(d, rows, cw)
                               : make_layout<bf16, float, kCL, kRound>(d, rows, cw))
                  : (filt_bf16 ? make_layout<float, bf16, kCL, kRound>(d, rows, cw)
                               : make_layout<float, float, kCL, kRound>(d, rows, cw));
}

}  // namespace

// A block's bytes of shared memory at (d, rows, cw) for an input and taps of
// inp_bytes and filt_bytes a value (2: bf16, 4: fp32), channel-first or
// channels-last, with both operands rounded to bf16 (rounded, channel-first
// only) or not; kernels/adaptive_conv.py:_smem_bytes mirrors it
extern "C" int rs_adaptive_conv_smem(int d, int rows, int cw, int inp_bytes, int filt_bytes,
                                     int channels_last, int rounded) {
  const bool bi = inp_bytes == 2, bf = filt_bytes == 2;
  if (rounded) return channels_last ? -1 : (int)pair_layout<false, true>(bi, bf, d, rows, cw).total;
  return (int)(channels_last ? pair_layout<true, false>(bi, bf, d, rows, cw)
                             : pair_layout<false, false>(bi, bf, d, rows, cw))
      .total;
}
