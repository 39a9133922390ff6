"""Adaptive (per-pixel) convolution with tap-major filters, channel-first:

    out[b, c, h, w] = sum_{u,v} filt_t[b, u*d+v, h, w] * inp[b, c, h+u, w+v]

``adaptive_conv_tapmajor`` dispatches on the device: a CPU tensor takes the
plain version (a loop of shifted multiply-adds in fp32, cast once, as
rs_ov/upsample/jbu.py:87-98), a CUDA tensor the hand-written kernel in
``rs_ov_torch/csrc/adaptive_conv.cu``. bf16 operands launch K4a, which
replaces ``adaptive_conv_pallas_v5`` (rs_ov/kernels/adaptive_conv_v5.py:68);
fp32 operands launch K4b, which replaces ``adaptive_conv_pallas_v2``
(rs_ov/kernels/adaptive_conv_v2.py:99). Both kernels take the input and the
taps in one dtype: bf16 taps come rounded by the caller, never here.
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import check, load_library

__all__ = ["adaptive_conv_tapmajor", "adaptive_conv_tapmajor_plain"]

_ENTRY = {torch.bfloat16: "rs_adaptive_conv_bf16", torch.float32: "rs_adaptive_conv_f32"}
SMEM_MAX = 232448  # bytes of shared memory a block may use on Hopper


def _smem_bytes(d: int) -> int:
    """The kernel's shared memory: all taps of 64 pixels (taps padded to a
    multiple of 4) and two input rows of 64 channels, in fp32."""
    dv = -(-d // 4) * 4
    return 4 * (d * dv * 64 + 2 * 64 * (64 + dv))


def adaptive_conv_tapmajor_plain(inp: torch.Tensor, filt_t: torch.Tensor,
                                 diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] -> [B, C, H, W] in
    inp's dtype; fp32 products and sums, taps in order t = 0..d*d-1."""
    b, _, h, w = filt_t.shape
    d = diameter
    acc = torch.zeros((b, inp.shape[1], h, w), dtype=torch.float32, device=inp.device)
    f32 = filt_t.float()
    for t in range(d * d):
        u, v = divmod(t, d)
        acc += f32[:, t:t + 1] * inp[:, :, u:u + h, v:v + w].float()
    return acc.to(inp.dtype)


def _check(inp: torch.Tensor, filt_t: torch.Tensor, d: int) -> None:
    if inp.dim() != 4 or filt_t.dim() != 4:
        raise ValueError(f"adaptive_conv: inp and filt_t must be 4-D, got "
                         f"{tuple(inp.shape)} and {tuple(filt_t.shape)}")
    b, c, hp, wp = inp.shape
    h, w = hp - d + 1, wp - d + 1
    if d < 1 or h < 1 or w < 1 or tuple(filt_t.shape) != (b, d * d, h, w):
        raise ValueError(f"adaptive_conv: filt_t {tuple(filt_t.shape)} does not match "
                         f"inp {tuple(inp.shape)} at d={d}; want {(b, d * d, h, w)}")
    if inp.dtype not in _ENTRY or filt_t.dtype != inp.dtype:
        raise ValueError(f"adaptive_conv kernel takes bf16 or fp32 operands of one dtype, "
                         f"got inp {inp.dtype} and filt_t {filt_t.dtype}")
    if _smem_bytes(d) > SMEM_MAX:
        raise ValueError(f"adaptive_conv kernel takes d <= 25 (shared memory), got d={d}")
    for name, t in (("inp", inp), ("filt_t", filt_t)):
        if not t.is_contiguous():
            raise ValueError(f"adaptive_conv: {name} must be contiguous")
    if filt_t.device != inp.device:
        raise ValueError(f"adaptive_conv: filt_t is on {filt_t.device}, inp on {inp.device}")


def _adaptive_conv_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                        diameter: int) -> torch.Tensor:
    _check(inp, filt_t, diameter)
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    lib = load_library()
    name = _ENTRY[inp.dtype]
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, name)(inp.data_ptr(), filt_t.data_ptr(), out.data_ptr(),
                                 b, c, h, w, diameter, stream), name)
    adaptive_conv_tapmajor.launches[inp.dtype] += 1
    return out


def adaptive_conv_tapmajor(inp: torch.Tensor, filt_t: torch.Tensor,
                           diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] tap-major ->
    [B, C, H, W] in inp's dtype. CPU tensors take the plain version, CUDA
    tensors the kernel (bf16: K4a, fp32: K4b)."""
    if inp.device.type == "cpu":
        return adaptive_conv_tapmajor_plain(inp, filt_t, diameter)
    if inp.device.type != "cuda":
        raise NotImplementedError(f"adaptive_conv: no route for {inp.device}")
    return _adaptive_conv_cuda(inp, filt_t, diameter)


# CUDA kernel launches per TPU kernel (bf16: K4a, fp32: K4b), for the chip smoke run
adaptive_conv_tapmajor.launches = {torch.bfloat16: 0, torch.float32: 0}
