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

``adaptive_conv_planes`` and ``adaptive_conv_cl`` are the kernels' own entry
points of the JAX package, ``adaptive_conv_pallas_planes``
(rs_ov/kernels/adaptive_conv.py:189, K4c) and ``adaptive_conv_pallas_cl``
(:70, K4d): the same function with the same NCHW contract, where the input
and the taps each keep their own dtype (bf16 or fp32; fp32 products, the
output in the input's dtype). Their CUDA kernels are in
``rs_ov_torch/csrc/adaptive_conv_layouts.cu``: K4c computes on the NCHW
planes, K4d channels-last on a permuted copy. Their plain version is
``adaptive_conv_tapmajor_plain``.
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import check, load_library

__all__ = ["adaptive_conv_tapmajor", "adaptive_conv_tapmajor_plain", "adaptive_conv_planes",
           "adaptive_conv_cl"]

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


def _check_shapes(inp: torch.Tensor, filt_t: torch.Tensor, d: int) -> None:
    if inp.dim() != 4 or filt_t.dim() != 4:
        raise ValueError(f"adaptive_conv: inp and filt_t must be 4-D, got "
                         f"{tuple(inp.shape)} and {tuple(filt_t.shape)}")
    b, c, hp, wp = inp.shape
    h, w = hp - d + 1, wp - d + 1
    if d < 1 or h < 1 or w < 1 or tuple(filt_t.shape) != (b, d * d, h, w):
        raise ValueError(f"adaptive_conv: filt_t {tuple(filt_t.shape)} does not match "
                         f"inp {tuple(inp.shape)} at d={d}; want {(b, d * d, h, w)}")
    for name, t in (("inp", inp), ("filt_t", filt_t)):
        if not t.is_contiguous():
            raise ValueError(f"adaptive_conv: {name} must be contiguous")
    if filt_t.device != inp.device:
        raise ValueError(f"adaptive_conv: filt_t is on {filt_t.device}, inp on {inp.device}")


def _check(inp: torch.Tensor, filt_t: torch.Tensor, d: int) -> None:
    _check_shapes(inp, filt_t, d)
    if inp.dtype not in _ENTRY or filt_t.dtype != inp.dtype:
        raise ValueError(f"adaptive_conv kernel takes bf16 or fp32 operands of one dtype, "
                         f"got inp {inp.dtype} and filt_t {filt_t.dtype}")
    if _smem_bytes(d) > SMEM_MAX:
        raise ValueError(f"adaptive_conv kernel takes d <= 25 (shared memory), got d={d}")


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


# ---------------------------------------------------------------------------
# K4c (planes) and K4d (channels-last): operands in their own dtypes
# ---------------------------------------------------------------------------

_TYPES = (torch.bfloat16, torch.float32)
_SMEM = {  # bytes of shared memory a block of each kernel takes at diameter d
    # K4c: 32 channels x (8+d-1) rows x (32+d-1) columns of the input, fp32
    "rs_adaptive_conv_planes": lambda d: 4 * 32 * (8 + d - 1) * (32 + d - 1),
    # K4d: the d*d taps of 16 pixels, fp32
    "rs_adaptive_conv_cl": lambda d: 4 * 16 * d * d,
}


def _check_layout(inp: torch.Tensor, filt_t: torch.Tensor, d: int, entry: str) -> None:
    _check_shapes(inp, filt_t, d)
    if inp.dtype not in _TYPES or filt_t.dtype not in _TYPES:
        raise ValueError(f"{entry} takes bf16 or fp32 for each operand, got inp "
                         f"{inp.dtype} and filt_t {filt_t.dtype}")
    smem = _SMEM[entry](d)
    if smem > SMEM_MAX:
        raise ValueError(f"{entry}: a block needs {smem} bytes of shared memory at d={d}; "
                         f"the card gives {SMEM_MAX}")


def _launch_layout(entry: str, inp: torch.Tensor, filt_t: torch.Tensor, out: torch.Tensor,
                   c: int, d: int) -> None:
    b, _, h, w = filt_t.shape
    lib = load_library()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, entry)(inp.data_ptr(), filt_t.data_ptr(), out.data_ptr(),
                                  b, c, h, w, d, int(inp.dtype == torch.bfloat16),
                                  int(filt_t.dtype == torch.bfloat16), stream), entry)


def _adaptive_conv_planes_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                               diameter: int) -> torch.Tensor:
    _check_layout(inp, filt_t, diameter, "rs_adaptive_conv_planes")
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    _launch_layout("rs_adaptive_conv_planes", inp, filt_t, out, c, diameter)
    adaptive_conv_planes.launches += 1
    return out


def _adaptive_conv_cl_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                           diameter: int) -> torch.Tensor:
    _check_layout(inp, filt_t, diameter, "rs_adaptive_conv_cl")
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    if c % 2:
        raise ValueError(f"rs_adaptive_conv_cl takes an even channel count, got C={c}")
    # a fresh copy: channel pairs are read and written as 4- or 8-byte words
    inp_cl = inp.permute(0, 2, 3, 1).clone(memory_format=torch.contiguous_format)
    out = torch.empty((b, h, w, c), dtype=inp.dtype, device=inp.device)
    _launch_layout("rs_adaptive_conv_cl", inp_cl, filt_t, out, c, diameter)
    adaptive_conv_cl.launches += 1
    return out.permute(0, 3, 1, 2).contiguous()


def _on_cpu(inp: torch.Tensor, name: str) -> bool:
    if inp.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no route for {inp.device}")
    return inp.device.type == "cpu"


def adaptive_conv_planes(inp: torch.Tensor, filt_t: torch.Tensor,
                         diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] tap-major, each bf16
    or fp32 -> [B, C, H, W] in inp's dtype, fp32 products and sums in tap
    order. CPU tensors take the plain version, CUDA tensors kernel K4c."""
    if _on_cpu(inp, "adaptive_conv_planes"):
        return adaptive_conv_tapmajor_plain(inp, filt_t, diameter)
    return _adaptive_conv_planes_cuda(inp, filt_t, diameter)


def adaptive_conv_cl(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int) -> torch.Tensor:
    """adaptive_conv_planes's function and NCHW contract, computed
    channels-last: CUDA tensors are permuted to [B, H+d-1, W+d-1, C], go
    through kernel K4d and come back permuted, as the JAX wrapper does. K4d
    takes any even C (the JAX kernel hands C % 128 != 0 to the planes kernel,
    a TPU lane rule). CPU tensors take the plain version."""
    if _on_cpu(inp, "adaptive_conv_cl"):
        return adaptive_conv_tapmajor_plain(inp, filt_t, diameter)
    return _adaptive_conv_cl_cuda(inp, filt_t, diameter)


adaptive_conv_planes.launches = 0  # CUDA kernel launches (K4c), for the chip smoke run
adaptive_conv_cl.launches = 0      # (K4d)
