// Adaptive (per-pixel) convolution from a channels-last input, on Hopper's
// tensor cores (sm_90a): the banded kernel of adaptive_conv.cuh with source
// rows staged [x][channel],
//
//   out[b, c, h, w] = sum_{u,v} filt[b, u*d+v, h, w] * inp[b, h+u, w+v, c]
//
// inp [B, H+d-1, W+d-1, C], filt [B, d*d, H, W] tap-major, each bf16 or fp32
// in its own type, out [B, C, H, W] in inp's type (channel-first: the D
// fragments leave through the shared-memory output stage, so the JAX
// wrapper's transpose back has no counterpart). Sums in fp32, one rounding.
//
// Replaces the TPU kernel rs_ov/kernels/adaptive_conv.py:
// adaptive_conv_pallas_cl (K4d: the function of adaptive_conv_pallas_planes
// computed channels-last, the wrapper transposing in and out, C % 128 != 0
// handed to the planes kernel, a TPU lane rule this port drops: K4d takes
// any even C). A staged row [x][channel] is mma's row-major B: bf16
// fragments come by ldmatrix.trans, TF32 fragments by 32-bit loads at a
// stride of C_block + 8 words. Every source pixel's channels are one
// contiguous run, 16-byte aligned where C is a multiple of 8 in bf16 or of 4
// in fp32 (C = 512 on the main path), so rows are staged by 16-byte
// cp.async (TMA would need a tensor map per call, encoded on the host, for
// a run of CB channels that cp.async already moves in whole 16-byte pieces).
//
// What bounds it on the H100, at B=2, C=512, d=11, H=W=56: K4c's function
// and operands, so K4c's bound: 33.7 MB of fp32 (10.1 us at 3.35 TB/s)
// against 4.7 us of 3xTF32 products; the wrapper's channels-last copy of
// the input reads and writes 17.8 MB each (10.6 us more). The first
// design, 16 pixels a block on the fp32 cores with a permuted copy each
// way, ran at 26x the bound.

#include "adaptive_conv.cuh"

// inp_bf16, filt_bf16: 1 for bf16, 0 for fp32; rows: R, output rows per
// block; cw: channels per warp (16, 32, 64, 128)
extern "C" int rs_adaptive_conv_cl(const void* inp, const void* filt, void* out,
                                   int B, int C, int H, int W, int d, int inp_bf16,
                                   int filt_bf16, int rows, int cw, cudaStream_t stream) {
  return launch_pair<true>(inp, filt, out, B, C, H, W, d, inp_bf16, filt_bf16, rows, cw,
                           stream);
}
