"""Adaptive (per-pixel) convolution with tap-major filters, channel-first:

    out[b, c, h, w] = sum_{u,v} filt_t[b, u*d+v, h, w] * inp[b, c, h+u, w+v]

``adaptive_conv_tapmajor`` dispatches on the device: a CPU tensor takes the
plain version (a loop of shifted multiply-adds in fp32, cast once, as
rs_ov/upsample/jbu.py:87-98), a CUDA tensor the hand-written kernel in
``rs_ov_torch/csrc/adaptive_conv.cu``, banded products on the tensor cores.
bf16 operands launch K4a, which replaces ``adaptive_conv_pallas_v5``
(rs_ov/kernels/adaptive_conv_v5.py:68); fp32 operands launch K4b (3xTF32),
which replaces ``adaptive_conv_pallas_v2`` (rs_ov/kernels/adaptive_conv_v2.py:99).
Both kernels take the input and the taps in one dtype: bf16 taps come
rounded by the caller, never here. A block takes R output rows x 16 columns
x a slice of channels; ``_tiling`` picks R and each warp's channels.

``adaptive_conv_planes`` and ``adaptive_conv_cl`` are the kernels' own entry
points of the JAX package, ``adaptive_conv_pallas_planes``
(rs_ov/kernels/adaptive_conv.py:189, K4c) and ``adaptive_conv_pallas_cl``
(:70, K4d): the same function with the same NCHW contract, where the input
and the taps each keep their own dtype (bf16 or fp32; fp32 products, the
output in the input's dtype). Their CUDA kernels are in
``rs_ov_torch/csrc/adaptive_conv_layouts.cu``: K4c computes on the NCHW
planes, K4d channels-last on a permuted copy. Their plain version is
``adaptive_conv_tapmajor_plain``.

``adaptive_conv_v3`` and ``adaptive_conv_v4`` are the entry points of
``adaptive_conv_pallas_v3`` (rs_ov/kernels/adaptive_conv_v3.py:96, K4e) and
``adaptive_conv_pallas_v4`` (rs_ov/kernels/adaptive_conv_v4.py:80, K4f), with
the same NCHW contract but another function: both operands are rounded to
bf16 first, the bf16 x bf16 products summed in fp32, the output in the
input's dtype. K4f computes it in column chunks of min(112, pad8(W)) and
takes d <= 17, as the JAX kernel does. Their CUDA kernels are in
``rs_ov_torch/csrc/adaptive_conv_bf16.cu``, their plain version is
``adaptive_conv_bf16_plain``.
"""

from __future__ import annotations

import functools

import torch

from rs_ov_torch.kernels.build import check, launch, load_library

__all__ = ["adaptive_conv_tapmajor", "adaptive_conv_tapmajor_plain", "adaptive_conv_planes",
           "adaptive_conv_cl", "adaptive_conv_v3", "adaptive_conv_v4",
           "adaptive_conv_bf16_plain"]

_ENTRY = {torch.bfloat16: "rs_adaptive_conv_bf16", torch.float32: "rs_adaptive_conv_f32"}
SMEM_MAX = 232448  # bytes of shared memory a block may use on Hopper
MAX_D = 25
# the kernel's block: 8 warps, 16 output columns; staged source rows in
# flight: 4 bf16 rows, or 3 fp32 rows and 4 of their TF32 parts
_WARPS, _COLS, _RING = 8, 16, {torch.bfloat16: 4, torch.float32: 3 + 4}
ROWS, WARP_CHANNELS = (1, 2, 4, 8), (16, 32, 64, 128)
# (R, channels per warp) by dtype, in order of preference: the first whose
# grid gives every SM a block, else the last. The fastest at the main path's
# shapes (B=2, C=512; d=11 at 56^2 and 28^2, d=7 at 56^2) in the sweep of
# rs_ov_torch/tools/adaptive_conv_tiling.py on the H100 (PERF.md): bf16
# 8 x 128 at 56^2 (224 blocks), 2 x 32 at 28^2; fp32 4 x 32 at both.
TILINGS = {torch.bfloat16: ((8, 128), (2, 32)), torch.float32: ((4, 32),)}


def _smem_bytes(d: int, rows: int, cw: int, dtype: torch.dtype) -> int:
    """Shared memory of a block at (d, R, channels per warp): the taps of its
    R x 16 pixels ([d*d][R*16 + 8]) and the larger of the staged source rows
    ([channels][32 or 64 columns + 16 bytes] each) and the output stage. The
    mirror of ``make_layout`` in ``csrc/adaptive_conv.cu``
    (``rs_adaptive_conv_smem`` returns the library's own count)."""
    sz = 2 if dtype == torch.bfloat16 else 4
    xw = 32 if d <= 17 else 64
    taps = -(-d * d * (rows * _COLS + 8) * sz // 128) * 128
    work = _RING[dtype] * cw * (_WARPS // rows) * (xw + 16 // sz) * sz
    ostage = _WARPS * cw * (_COLS + 16 // sz) * sz
    return taps + max(work, ostage)


def _blocks(b: int, c: int, h: int, w: int, rows: int, cw: int) -> int:
    """The kernel's grid size at a tiling."""
    return b * -(-h // rows) * -(-w // _COLS) * -(-c // (cw * (_WARPS // rows)))


def _tiling(b: int, c: int, h: int, w: int, d: int, dtype: torch.dtype,
            sms: int) -> tuple[int, int]:
    """(R, channels per warp) for a call on a card of ``sms`` SMs: the first
    of ``TILINGS`` whose grid fills the SMs (else the last), each warp's
    channels cut to what C needs; where that block does not fit in shared
    memory (large d), the first that does with R and the channels no
    larger."""
    options = TILINGS[dtype]
    rows, cw = next((t for t in options if _blocks(b, c, h, w, *t) >= sms), options[-1])
    while cw > 16 and cw * (_WARPS // rows) >= 2 * c:
        cw //= 2
    for r in (x for x in ROWS[::-1] if x <= rows):
        for k in (x for x in WARP_CHANNELS[::-1] if x <= cw):
            if _smem_bytes(d, r, k, dtype) <= SMEM_MAX:
                return r, k
    raise ValueError(f"adaptive_conv kernel: no block fits in shared memory at d={d}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if d > MAX_D:
        raise ValueError(f"adaptive_conv kernel takes d <= {MAX_D} (its widest band), "
                         f"got d={d}")


def _adaptive_conv_operands(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int,
                            tiling: tuple[int, int] | None = None):
    """K4a's / K4b's operands checked and the output allocated. Returns (out,
    entry, args): ``load_library().<entry>(*args, stream)`` is the bare
    library call, at ``tiling`` (R, channels per warp) or ``_tiling``'s."""
    _check(inp, filt_t, diameter)
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    index = inp.device.index if inp.device.index is not None else torch.cuda.current_device()
    rows, cw = tiling or _tiling(b, c, h, w, diameter, inp.dtype, _sm_count(index))
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    return out, _ENTRY[inp.dtype], (inp.data_ptr(), filt_t.data_ptr(), out.data_ptr(), b, c,
                                    h, w, diameter, rows, cw)


def _adaptive_conv_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                        diameter: int) -> torch.Tensor:
    out, entry, args = _adaptive_conv_operands(inp, filt_t, diameter)
    check(launch(getattr(load_library(), entry), args, inp.device), entry)
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


# ---------------------------------------------------------------------------
# K4e (v3) and K4f (v4): both operands rounded to bf16
# ---------------------------------------------------------------------------

V4_MAX_D = 17  # the JAX kernel's chunk + window must fit 128 lanes (WT + d - 1 <= 128)


def adaptive_conv_bf16_plain(inp: torch.Tensor, filt_t: torch.Tensor,
                             diameter: int) -> torch.Tensor:
    """adaptive_conv_pallas_v3's function: the input and the taps rounded to
    bf16 (round to nearest even), their products (exact in fp32) summed in
    fp32 in tap order, the sum cast once to inp's dtype (K4b's loop on fp32
    copies of the rounded operands, so that an fp32 input keeps an fp32
    output)."""
    return adaptive_conv_tapmajor_plain(inp.bfloat16().float(), filt_t.bfloat16().float(),
                                        diameter).to(inp.dtype)


def v4_chunk(w: int) -> int:
    """K4f's output columns per block: min(112, W padded to a multiple of 8)
    (rs_ov/kernels/adaptive_conv_v4.py:92)."""
    return min(112, -(-w // 8) * 8)


def _bf16_smem(tw: int, d: int) -> int:
    """Shared memory of a K4e/K4f block: 32 channels x (8+d-1) rows x
    (tw+d-1) columns of the input, in bf16."""
    return 2 * 32 * (8 + d - 1) * (tw + d - 1)


def _adaptive_conv_bf16_cuda(entry: str, inp: torch.Tensor, filt_t: torch.Tensor,
                             d: int, tw: int) -> torch.Tensor:
    _check_shapes(inp, filt_t, d)
    if inp.dtype not in _TYPES or filt_t.dtype not in _TYPES:
        raise ValueError(f"{entry} takes bf16 or fp32 for each operand, got inp "
                         f"{inp.dtype} and filt_t {filt_t.dtype}")
    smem = _bf16_smem(tw, d)
    if smem > SMEM_MAX:
        raise ValueError(f"{entry}: a block needs {smem} bytes of shared memory at d={d}; "
                         f"the card gives {SMEM_MAX}")
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    lib = load_library()
    flags = (int(inp.dtype == torch.bfloat16), int(filt_t.dtype == torch.bfloat16))
    chunk = (tw,) if entry == "rs_adaptive_conv_v4" else ()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, entry)(inp.data_ptr(), filt_t.data_ptr(), out.data_ptr(),
                                  b, c, h, w, d, *chunk, *flags, stream), entry)
    return out


def adaptive_conv_v3(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] tap-major, each bf16
    or fp32 -> [B, C, H, W] in inp's dtype, both operands rounded to bf16
    (adaptive_conv_pallas_v3's function). CPU tensors take the plain
    version, CUDA tensors kernel K4e."""
    if _on_cpu(inp, "adaptive_conv_v3"):
        return adaptive_conv_bf16_plain(inp, filt_t, diameter)
    out = _adaptive_conv_bf16_cuda("rs_adaptive_conv_v3", inp, filt_t, diameter, 32)
    adaptive_conv_v3.launches += 1
    return out


def adaptive_conv_v4(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int) -> torch.Tensor:
    """adaptive_conv_v3's function, computed in output-column chunks of
    min(112, pad8(W)) (adaptive_conv_pallas_v4). Refuses d > 17, as the JAX
    entry does: there a chunk and its window must fit 128 lanes. CPU tensors
    take the plain version, CUDA tensors kernel K4f."""
    if diameter > V4_MAX_D:
        raise ValueError(f"adaptive_conv_v4 takes d <= {V4_MAX_D}, got d={diameter}")
    if _on_cpu(inp, "adaptive_conv_v4"):
        return adaptive_conv_bf16_plain(inp, filt_t, diameter)
    out = _adaptive_conv_bf16_cuda("rs_adaptive_conv_v4", inp, filt_t, diameter,
                                   v4_chunk(filt_t.shape[-1]))
    adaptive_conv_v4.launches += 1
    return out


adaptive_conv_v3.launches = 0  # CUDA kernel launches (K4e), for the chip smoke run
adaptive_conv_v4.launches = 0  # (K4f)
