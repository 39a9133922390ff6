"""Adaptive (per-pixel) convolution with tap-major filters, channel-first:

    out[b, c, h, w] = sum_{u,v} filt_t[b, u*d+v, h, w] * inp[b, c, h+u, w+v]

``adaptive_conv_tapmajor`` dispatches on the device: a CPU tensor takes the
plain version (a loop of shifted multiply-adds in fp32, cast once, as
rs_ov/upsample/jbu.py:87-98), a CUDA tensor the hand-written banded kernel
of ``rs_ov_torch/csrc/adaptive_conv.cuh``, on the tensor cores. bf16
operands launch K4a, which replaces ``adaptive_conv_pallas_v5``
(rs_ov/kernels/adaptive_conv_v5.py:68); fp32 operands launch K4b (3xTF32),
which replaces ``adaptive_conv_pallas_v2`` (rs_ov/kernels/adaptive_conv_v2.py:99).
Both take the input and the taps in one dtype: bf16 taps come rounded by
the caller, never here. A block takes R output rows x 16 columns x a slice
of channels; ``_tiling`` picks R and each warp's channels.

``adaptive_conv_planes`` and ``adaptive_conv_cl`` are the kernels' own entry
points of the JAX package, ``adaptive_conv_pallas_planes``
(rs_ov/kernels/adaptive_conv.py:189, K4c) and ``adaptive_conv_pallas_cl``
(:70, K4d): the same function with the same NCHW contract, where the input
and the taps each keep their own dtype (bf16 or fp32; fp32 products, the
output in the input's dtype). K4c is the same banded kernel on the NCHW
input, K4d its channels-last form (``csrc/adaptive_conv_cl.cu``) on a
channels-last copy of the input, writing the NCHW output itself. Both take
the bf16 product where both operands are bf16, else the TF32 one, each fp32
operand split in two. Their plain version is ``adaptive_conv_tapmajor_plain``.

``adaptive_conv_v3`` and ``adaptive_conv_v4`` are the entry points of
``adaptive_conv_pallas_v3`` (rs_ov/kernels/adaptive_conv_v3.py:96, K4e) and
``adaptive_conv_pallas_v4`` (rs_ov/kernels/adaptive_conv_v4.py:80, K4f), with
the same NCHW contract but another function: both operands are rounded to
bf16 first, the bf16 x bf16 products summed in fp32, the output in the
input's dtype. K4f computes it in column chunks of min(112, pad8(W)) and
takes d <= 17, as the JAX kernel does. On the card both are the banded
kernel with its rounded product (bf16 operands on m16n8k16, fp32 operands
rounded as they are staged; entries in ``rs_ov_torch/csrc/adaptive_conv.cu``),
where K4f's chunk is only a tiling; their plain version is
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
_WARPS, _COLS = 8, 16  # the kernel's block: 8 warps, 16 output columns
ROWS, WARP_CHANNELS = (1, 2, 4, 8), (16, 32, 64, 128)
# (R, channels per warp) by product, in order of preference: the first whose
# grid gives every SM a block, else the last. The fastest at the main path's
# shapes (B=2, C=512; d=11 at 56^2 and 28^2, d=7 at 56^2) in the sweep of
# rs_ov_torch/tools/adaptive_conv_tiling.py on the H100 (PERF.md): bf16
# 8 x 128 at 56^2 (224 blocks), 2 x 32 at 28^2; fp32 (TF32) 4 x 32 at both;
# K4e/K4f with an fp32 input 8 x 128 at 56^2 and d=7 224^2, 4 x 64 at 28^2
# (112 blocks; 2 x 32 is 5-11% slower there), with a bf16 input bf16's.
TILINGS = {"bf16": ((8, 128), (2, 32)), "tf32": ((4, 32),), "rounded": ((8, 128), (4, 64))}


def _product(dtype: torch.dtype, filt_dtype: torch.dtype | None = None,
             rounded: bool = False) -> str:
    """The kernel's product and pipeline for an operand pair: "bf16" where a
    bf16 input row feeds the bf16 product as it lands (both operands bf16,
    or with ``rounded``, K4e/K4f, any bf16 input: fp32 taps are rounded as
    they are staged); "rounded" where an fp32 input row is rounded to bf16
    once it lands; else "tf32" (each fp32 operand split into two TF32
    parts)."""
    if dtype == torch.bfloat16 and (rounded or filt_dtype in (None, torch.bfloat16)):
        return "bf16"
    return "rounded" if rounded else "tf32"


def _smem_bytes(d: int, rows: int, cw: int, dtype: torch.dtype,
                filt_dtype: torch.dtype | None = None, channels_last: bool = False,
                rounded: bool = False) -> int:
    """Shared memory of a block at (d, R, channels per warp) for an input of
    ``dtype`` and taps of ``filt_dtype`` (default: the same), both rounded to
    bf16 with ``rounded`` (channel-first only): the taps of its R x 16 pixels
    ([d*d][R*16 + 8], in bf16 where rounded) and the larger of the output
    stage and the staged source rows (4 rows where a bf16 input feeds the
    bf16 product; else 3 rows and two steps of their parts: TF32 hi and, for
    an fp32 input, lo, [lines][row + 4] words, or the rounded row [channels]
    [32 or 64 columns + 8] bf16), a row [channels][32 or 64 columns + 16
    bytes] channel-first, [32 or 64 columns][channels + 16 bytes]
    channels-last. The mirror of ``make_layout`` in ``csrc/adaptive_conv.cuh``
    (``rs_adaptive_conv_smem`` returns the library's own count)."""
    if rounded and channels_last:
        raise ValueError("the rounded product is channel-first only")
    product = _product(dtype, filt_dtype, rounded)
    si, sf = dtype.itemsize, 2 if rounded else (filt_dtype or dtype).itemsize
    cb, xw = cw * (_WARPS // rows), 32 if d <= 17 else 64
    lines = xw if channels_last else cb
    ldx = (cb if channels_last else xw) + 16 // si
    if product == "tf32":  # 3 rows, parts hi[, lo] in words
        ring, parts, lds, part_sz = 3, 2 if si == 4 else 1, cb + 8 if channels_last else xw + 4, 4
    elif si == 4:  # an fp32 input: 3 rows, each rounded into one bf16 part
        ring, parts, lds, part_sz = 3, 1, xw + 8, 2
    else:  # a bf16 input feeding the bf16 product: 4 rows read as they land
        ring, parts, lds, part_sz = 4, 0, 0, 0
    taps = -(-d * d * (rows * _COLS + 8) * sf // 128) * 128
    work = ring * lines * ldx * si + 2 * parts * lines * lds * part_sz
    ostage = _WARPS * cw * (_COLS + 16 // si) * si
    return taps + max(work, ostage)


def _blocks(b: int, c: int, h: int, w: int, rows: int, cw: int) -> int:
    """The kernel's grid size at a tiling."""
    return b * -(-h // rows) * -(-w // _COLS) * -(-c // (cw * (_WARPS // rows)))


def _tiling(b: int, c: int, h: int, w: int, d: int, dtype: torch.dtype, sms: int,
            filt_dtype: torch.dtype | None = None, channels_last: bool = False,
            rounded: bool = False) -> tuple[int, int]:
    """(R, channels per warp) for a call on a card of ``sms`` SMs: the first
    of the product's ``TILINGS`` whose grid fills the SMs (else the last),
    each warp's channels cut to what C needs; where that block does not fit
    in shared memory (large d), the first that does with R and the channels
    no larger."""
    options = TILINGS[_product(dtype, filt_dtype, rounded)]
    rows, cw = next((t for t in options if _blocks(b, c, h, w, *t) >= sms), options[-1])
    while cw > 16 and cw * (_WARPS // rows) >= 2 * c:
        cw //= 2
    needs = {}
    for r in (x for x in ROWS[::-1] if x <= rows):
        for k in (x for x in WARP_CHANNELS[::-1] if x <= cw):
            needs[r, k] = _smem_bytes(d, r, k, dtype, filt_dtype, channels_last, rounded)
            if needs[r, k] <= SMEM_MAX:
                return r, k
    raise ValueError(f"adaptive_conv kernel: no block fits in shared memory at d={d}: the "
                     f"smallest needs {min(needs.values())} bytes, a block may use {SMEM_MAX}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    """The SMs of a CUDA device (its index, or the current one)."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


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
    rows, cw = tiling or _tiling(b, c, h, w, diameter, inp.dtype, _sms(inp.device))
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
_LAYOUT_ENTRY = {False: "rs_adaptive_conv_planes", True: "rs_adaptive_conv_cl"}


def _layout_operands(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int,
                     channels_last: bool, tiling: tuple[int, int] | None = None):
    """K4c's (``channels_last`` False) or K4d's operands checked, K4d's input
    copied channels-last ([B, H+d-1, W+d-1, C]) and the NCHW output
    allocated. Returns (out, entry, args, src): ``load_library().<entry>(*args,
    stream)`` is the bare library call, at ``tiling`` (R, channels per warp)
    or ``_tiling``'s, on ``src``, which must outlive it."""
    entry = _LAYOUT_ENTRY[channels_last]
    _check_shapes(inp, filt_t, diameter)
    if inp.dtype not in _TYPES or filt_t.dtype not in _TYPES:
        raise ValueError(f"{entry} takes bf16 or fp32 for each operand, got inp "
                         f"{inp.dtype} and filt_t {filt_t.dtype}")
    b, c, _, _ = inp.shape
    if channels_last and c % 2:
        raise ValueError(f"{entry} takes an even channel count, got C={c}")
    if diameter > MAX_D:
        raise ValueError(f"{entry} takes d <= {MAX_D} (its widest band), got d={diameter}")
    _, _, h, w = filt_t.shape
    rows, cw = tiling or _tiling(b, c, h, w, diameter, inp.dtype, _sms(inp.device),
                                 filt_t.dtype, channels_last)
    src = inp.permute(0, 2, 3, 1).contiguous() if channels_last else inp
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    return out, entry, (src.data_ptr(), filt_t.data_ptr(), out.data_ptr(), b, c, h, w,
                        diameter, int(inp.dtype == torch.bfloat16),
                        int(filt_t.dtype == torch.bfloat16), rows, cw), src


def _layout_cuda(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int,
                 channels_last: bool) -> torch.Tensor:
    out, entry, args, _src = _layout_operands(inp, filt_t, diameter, channels_last)
    check(launch(getattr(load_library(), entry), args, inp.device), entry)
    return out


def _adaptive_conv_planes_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                               diameter: int) -> torch.Tensor:
    out = _layout_cuda(inp, filt_t, diameter, False)
    adaptive_conv_planes.launches += 1
    return out


def _adaptive_conv_cl_cuda(inp: torch.Tensor, filt_t: torch.Tensor,
                           diameter: int) -> torch.Tensor:
    out = _layout_cuda(inp, filt_t, diameter, True)
    adaptive_conv_cl.launches += 1
    return out


def _on_cpu(inp: torch.Tensor, name: str) -> bool:
    if inp.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no route for {inp.device}")
    return inp.device.type == "cpu"


def adaptive_conv_planes(inp: torch.Tensor, filt_t: torch.Tensor,
                         diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] tap-major, each bf16
    or fp32 -> [B, C, H, W] in inp's dtype, fp32 products and sums (in tap
    order on the CPU). CPU tensors take the plain version, CUDA tensors
    kernel K4c (d <= 25, any C)."""
    if _on_cpu(inp, "adaptive_conv_planes"):
        return adaptive_conv_tapmajor_plain(inp, filt_t, diameter)
    return _adaptive_conv_planes_cuda(inp, filt_t, diameter)


def adaptive_conv_cl(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int) -> torch.Tensor:
    """adaptive_conv_planes's function and NCHW contract, computed
    channels-last: a CUDA input is copied to [B, H+d-1, W+d-1, C], as the
    JAX wrapper transposes it, and kernel K4d writes the NCHW output itself.
    K4d takes any even C (the JAX kernel hands C % 128 != 0 to the planes
    kernel, a TPU lane rule) and d <= 25. CPU tensors take the plain
    version."""
    if _on_cpu(inp, "adaptive_conv_cl"):
        return adaptive_conv_tapmajor_plain(inp, filt_t, diameter)
    return _adaptive_conv_cl_cuda(inp, filt_t, diameter)


adaptive_conv_planes.launches = 0  # CUDA kernel launches (K4c), for the chip smoke run
adaptive_conv_cl.launches = 0      # (K4d)


# ---------------------------------------------------------------------------
# K4e (v3) and K4f (v4): both operands rounded to bf16
# ---------------------------------------------------------------------------

V4_MAX_D = 17  # the JAX kernel's chunk + window must fit 128 lanes (WT + d - 1 <= 128)
ROUNDED_MAX_D = 49  # the kernel's widest band: 16 + d - 1 <= 64 columns
_ROUNDED_ENTRY = {False: "rs_adaptive_conv_v3", True: "rs_adaptive_conv_v4"}


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
    """The JAX K4f's output columns per grid step: min(112, W padded to a
    multiple of 8) (rs_ov/kernels/adaptive_conv_v4.py:92). On the card the
    chunk is only a tiling of the kernel's 16-column blocks."""
    return min(112, -(-w // 8) * 8)


def _rounded_operands(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int,
                      chunked: bool = False, tiling: tuple[int, int] | None = None):
    """K4e's (``chunked`` False) or K4f's operands checked and the output
    allocated. Returns (out, entry, args): ``load_library().<entry>(*args,
    stream)`` is the bare library call, at ``tiling`` (R, channels per warp)
    or ``_tiling``'s for the rounded product. K4f takes d <= 17; both take d
    up to the widest band where a block fits in shared memory (every d <= 44
    with an fp32 input, <= 49 with a bf16 one)."""
    entry = _ROUNDED_ENTRY[chunked]
    _check_shapes(inp, filt_t, diameter)
    if inp.dtype not in _TYPES or filt_t.dtype not in _TYPES:
        raise ValueError(f"{entry} takes bf16 or fp32 for each operand, got inp "
                         f"{inp.dtype} and filt_t {filt_t.dtype}")
    max_d = V4_MAX_D if chunked else ROUNDED_MAX_D
    if diameter > max_d:
        raise ValueError(f"{entry} takes d <= {max_d}, got d={diameter}")
    b, c, _, _ = inp.shape
    _, _, h, w = filt_t.shape
    rows, cw = tiling or _tiling(b, c, h, w, diameter, inp.dtype, _sms(inp.device),
                                 filt_t.dtype, rounded=True)
    out = torch.empty((b, c, h, w), dtype=inp.dtype, device=inp.device)
    return out, entry, (inp.data_ptr(), filt_t.data_ptr(), out.data_ptr(), b, c, h, w, diameter,
                        int(inp.dtype == torch.bfloat16), int(filt_t.dtype == torch.bfloat16),
                        rows, cw)


def _rounded_cuda(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int,
                  chunked: bool) -> torch.Tensor:
    out, entry, args = _rounded_operands(inp, filt_t, diameter, chunked)
    check(launch(getattr(load_library(), entry), args, inp.device), entry)
    return out


def adaptive_conv_v3(inp: torch.Tensor, filt_t: torch.Tensor, diameter: int) -> torch.Tensor:
    """inp [B, C, H+d-1, W+d-1], filt_t [B, d*d, H, W] tap-major, each bf16
    or fp32 -> [B, C, H, W] in inp's dtype, both operands rounded to bf16
    (adaptive_conv_pallas_v3's function). CPU tensors take the plain
    version, CUDA tensors kernel K4e."""
    if _on_cpu(inp, "adaptive_conv_v3"):
        return adaptive_conv_bf16_plain(inp, filt_t, diameter)
    out = _rounded_cuda(inp, filt_t, diameter, False)
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
    out = _rounded_cuda(inp, filt_t, diameter, True)
    adaptive_conv_v4.launches += 1
    return out


adaptive_conv_v3.launches = 0  # CUDA kernel launches (K4e), for the chip smoke run
adaptive_conv_v4.launches = 0  # (K4f)
