"""Fused self-self attention (K6): the context of one of six attention modes,

    out[b, h] = A(q, k, v, S) @ v          [B, H, L, hd], in q's dtype

with the weights A of the mode (s = hd^-0.5, S = sim_map * sim_weight):

    vanilla       softmax(q k^T s + S)
    ClearCLIP     softmax(q q^T s + S)
    SCLIP         softmax(q q^T s + S) + softmax(k k^T s + S)
    SegEarth      SCLIP's two terms + softmax(v v^T s + S)
    SFP           softmax(0.5 (q q^T s + k k^T s) + S)
    Experimental  softmax(softmax(k k^T s + q q^T s) + S)

q, k and v are widened to fp32; the score products, the softmaxes and the
product with v run in fp32, with one cast at the end (the TPU kernel's
function, rs_ov/kernels/selfself_attention.py:38-73). This is not what the
plain ``custom_attn`` path computes under bf16: that path rounds the weights
to bf16 before the product with v. ``fused_selfself_attention_plain`` below is
the fp32 formula, the oracle of the kernel.

``fused_selfself_attention`` dispatches on the device: a CPU tensor takes the
plain version, a CUDA tensor the hand-written kernel, which replaces the TPU
kernel ``fused_selfself_attention`` (rs_ov/kernels/selfself_attention.py:78):
bf16 in ``rs_ov_torch/csrc/selfself_attention_sm90.cu`` (the products on the
tensor cores, the weights meeting v as a bf16 pair hi + lo), fp32 in
``rs_ov_torch/csrc/selfself_attention_f32_sm90.cu`` (the same design on the
TF32 tensor cores, each fp32 product taken as three TF32 products of the
operands split into hi + lo; where the three operands do not fit a block, as
at ViT-H/14's L = 257, hd = 80, the score operands share one slot, staged in
turn).
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import check, launch, load_library

__all__ = ["fused_selfself_attention", "fused_selfself_attention_plain", "SUPPORTED_MODES"]

SUPPORTED_MODES = ("vanilla", "ClearCLIP", "SCLIP", "SegEarth", "SFP", "Experimental")
SMEM_MAX = 232448  # bytes of shared memory a block may use on Hopper
LMAX = 288         # keys a row's scores hold in registers
HDMAX = 128        # output channels


def _smem_bytes(mode: str, l: int, hd: int, dtype: torch.dtype) -> int:
    """The shared memory of a block's operands: those the mode needs, each
    row 16 bytes longer, and the last one, v, padded to a multiple of 16 rows
    (the tensor cores' query tiles). bf16 also pads hd to a multiple of 16.
    Where fp32's three operands do not fit, the score operands share one
    slot of L rows, staged in turn, and vanilla also stages the block's own
    rows of q (16 a warp, up to 8 warps a block over as few blocks a head as
    that allows). The sim rows are staged where room is left, else read from
    device memory. Mirrors ``rs_selfself_attention_f32_smem``."""
    n_ops = 2 if mode == "ClearCLIP" else 3
    lp = -(-l // 16) * 16
    if dtype == torch.bfloat16:
        return ((n_ops - 1) * l + lp) * (-(-hd // 16) * 16 + 8) * 2
    full = ((n_ops - 1) * l + lp) * (hd + 4) * 4
    if full <= SMEM_MAX:
        return full
    tiles = lp // 16
    blocks = -(-tiles // 8)
    q_rows = 16 * -(-tiles // blocks) if mode == "vanilla" else 0
    return (l + lp + q_rows) * (hd + 4) * 4


def fused_selfself_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   sim_map: torch.Tensor | None = None, *,
                                   mode: str = "Experimental",
                                   sim_weight: float = 1.0) -> torch.Tensor:
    """q, k, v [B, H, L, hd]; sim_map optional fp32 [B, L, L] (CLS-padded)
    -> [B, H, L, hd] in q's dtype, every step in fp32."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32 = q.float(), k.float(), v.float()
    sim = None if sim_map is None else sim_map.float()[:, None] * sim_weight

    def score(a, b):
        return torch.matmul(a, b.transpose(-1, -2)) * scale

    def enhance(logits):
        return logits if sim is None else logits + sim

    def softmax(x):
        return torch.softmax(x, dim=-1)

    if mode == "vanilla":
        attn = softmax(enhance(score(q32, k32)))
    elif mode == "ClearCLIP":
        attn = softmax(enhance(score(q32, q32)))
    elif mode == "SCLIP":
        attn = softmax(enhance(score(q32, q32))) + softmax(enhance(score(k32, k32)))
    elif mode == "SegEarth":
        attn = (softmax(enhance(score(q32, q32))) + softmax(enhance(score(k32, k32)))
                + softmax(enhance(score(v32, v32))))
    elif mode == "SFP":
        attn = softmax(enhance(0.5 * (score(q32, q32) + score(k32, k32))))
    elif mode == "Experimental":
        attn = softmax(enhance(softmax(score(k32, k32) + score(q32, q32))))
    else:
        raise ValueError(f"fused_selfself_attention: unsupported mode '{mode}', "
                         f"supported: {SUPPORTED_MODES}")
    return torch.matmul(attn, v32).to(q.dtype)


_ENTRY = {torch.bfloat16: "rs_selfself_attention_bf16",
          torch.float32: "rs_selfself_attention_f32"}


def _attention_operands(q, k, v, sim_map, mode: str, sim_weight: float):
    """The operands checked and the output allocated. Returns (out, entry,
    args): the library entry's name and its arguments up to the stream."""
    if mode not in SUPPORTED_MODES:
        raise ValueError(f"fused_selfself_attention: unsupported mode '{mode}', "
                         f"supported: {SUPPORTED_MODES}")
    if q.dim() != 4:
        raise ValueError(f"fused_selfself_attention: q must be [B, H, L, hd], "
                         f"got {tuple(q.shape)}")
    b, h, l, hd = q.shape
    if q.dtype not in _ENTRY:
        raise ValueError(f"fused_selfself_attention kernel takes bf16 or fp32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or tuple(t.shape) != (b, h, l, hd):
            raise ValueError(f"fused_selfself_attention: {name} must be {q.dtype} of "
                             f"shape {(b, h, l, hd)}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"fused_selfself_attention: {name} must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    if sim_map is not None and (sim_map.dtype != torch.float32
                                or tuple(sim_map.shape) != (b, l, l)
                                or not sim_map.is_contiguous()
                                or sim_map.device != q.device):
        raise ValueError(f"fused_selfself_attention: sim_map must be contiguous fp32 "
                         f"{(b, l, l)} on {q.device}, got {sim_map.dtype} "
                         f"{tuple(sim_map.shape)} on {sim_map.device}")
    if not (1 <= l <= LMAX and 8 <= hd <= HDMAX and hd % 8 == 0):
        raise ValueError(f"fused_selfself_attention kernel takes L <= {LMAX} and hd a "
                         f"multiple of 8 up to {HDMAX}, got L={l}, hd={hd}")
    smem = _smem_bytes(mode, l, hd, q.dtype)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_selfself_attention: L={l}, hd={hd} in {q.dtype} needs "
                         f"{smem} B of shared memory, more than {SMEM_MAX}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if sim_map is None else sim_map.data_ptr(), out.data_ptr(),
            b, h, l, hd, SUPPORTED_MODES.index(mode), hd ** -0.5, float(sim_weight))
    return out, _ENTRY[q.dtype], args


def _fused_selfself_attention_cuda(q, k, v, sim_map, mode: str,
                                   sim_weight: float) -> torch.Tensor:
    out, entry, args = _attention_operands(q, k, v, sim_map, mode, sim_weight)
    check(launch(getattr(load_library(), entry), args, q.device), entry)
    fused_selfself_attention.launches += 1
    return out


def fused_selfself_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sim_map: torch.Tensor | None = None, *,
                             mode: str = "Experimental",
                             sim_weight: float = 1.0) -> torch.Tensor:
    """q, k, v [B, H, L, hd] in one dtype; sim_map optional fp32 [B, L, L]
    (CLS row and column padded) -> the context [B, H, L, hd] in q's dtype."""
    if q.device.type == "cpu":
        return fused_selfself_attention_plain(q, k, v, sim_map, mode=mode,
                                              sim_weight=sim_weight)
    if q.device.type != "cuda":
        raise NotImplementedError(f"fused_selfself_attention: no route for {q.device}")
    return _fused_selfself_attention_cuda(q, k, v, sim_map, mode, sim_weight)


fused_selfself_attention.launches = 0  # CUDA kernel launches, for the chip smoke run
