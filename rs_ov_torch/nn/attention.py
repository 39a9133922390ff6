"""Attention (rs_ov/nn/attention.py): standard multi-head attention with
head-averaged weights, and the self-self mode registry ``custom_attn``
(rs_ov/nn/attention.py:147-237) with its ten modes.

Layouts as in the JAX package: [B, L, D] in and out, heads [B, H, L, hd].
Softmaxes run in fp32; batched products take the operands in their dtype
and keep an fp32 result with fp32 sums (``matmul32``).

With ``RS_OV_FUSED_ATTN=1``, CUDA tensors and a mode the fused kernel
supports, the context comes from K6 (``rs_ov_torch.kernels.selfself_attention``)
and the out-projection follows (rs_ov/nn/attention.py:131-173). The default
is off, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from rs_ov_torch.nn.layers import linear, matmul32
from rs_ov_torch.utils.device_cache import device_cache

__all__ = ["standard_attention", "custom_attn", "ATTENTION_MODES", "qkv_projection"]

ATTENTION_MODES = (
    "vanilla", "MaskCLIP", "SCLIP", "SegEarth", "SFP",
    "Experimental", "ClearCLIP", "NACLIP", "NOnly", "GAV",
)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def qkv_projection(p, x: torch.Tensor, heads: int):
    """[B, L, D] -> three [B, H, L, hd] tensors through the fused in_proj."""
    q, k, v = linear(x, p.in_proj_w, p.in_proj_b).chunk(3, dim=-1)
    return _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with fp32 sums and an fp32 result, from operands of
    any float dtype (rs_ov/nn/attention.py:56-58)."""
    return matmul32(a, b)


def _softmax32(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x.float(), dim=-1)


def _context(p, attn: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    out = _bmm(attn.to(v.dtype), v).to(dtype)
    return linear(_merge_heads(out), p.out_proj_w, p.out_proj_b)


def standard_attention(p, x: torch.Tensor, heads: int,
                       mask: torch.Tensor | None = None,
                       need_weights: bool = False):
    """softmax(q k^T / sqrt(hd)) v with out-projection. Returns (out, weights):
    weights is the head-averaged fp32 map [B, L, L] when asked, else None."""
    q, k, v = qkv_projection(p, x, heads)
    scale = (x.shape[-1] // heads) ** -0.5
    attn = _bmm(q * scale, k.transpose(-1, -2))
    if mask is not None:
        attn = attn + mask
    attn = _softmax32(attn)
    out = _context(p, attn, v, x.dtype)
    return out, (attn.mean(1) if need_weights else None)


@functools.lru_cache(maxsize=None)
def _gaussian_addition(grid_h: int, grid_w: int, std: float) -> np.ndarray:
    """(N, N) locality bias with a zero CLS row and column, N = grid_h*grid_w
    + 1 (rs_ov/nn/attention.py:95-123): the entry for patches (i, j) ->
    (k, l) is the Gaussian window at the offset (i-k, j-l). Host numpy,
    cached per grid and std."""
    wh, ww = grid_h * 2 - 1, grid_w * 2 - 1
    constant = 1.0 / (std * math.sqrt(2.0))

    def axis_vals(dim):
        start = -(dim - 1) / 2.0
        return np.linspace(start * constant, (start + (dim - 1)) * constant, dim)

    ky, kx = axis_vals(wh), axis_vals(ww)
    win = np.exp(-(ky[:, None] ** 2 + kx[None, :] ** 2))
    rows = np.arange(grid_h * grid_w)
    ri, ci = rows // grid_w, rows % grid_w
    dy = ri[:, None] - ri[None, :] + (grid_h - 1)
    dx = ci[:, None] - ci[None, :] + (grid_w - 1)
    n = grid_h * grid_w + 1
    full = np.zeros((n, n), dtype=np.float32)
    full[1:, 1:] = win[dy, dx]
    return full


@device_cache
def _gaussian_on(grid_h: int, grid_w: int, std: float, device: torch.device) -> torch.Tensor:
    """``_gaussian_addition`` moved to the device once per grid, std and device."""
    return torch.from_numpy(_gaussian_addition(grid_h, grid_w, std)).to(device)


def _pad_sim_map_for_cls(sim_map: torch.Tensor) -> torch.Tensor:
    """[B, P, P] patch similarity -> [B, P+1, P+1] with a zero CLS row and column."""
    return torch.nn.functional.pad(sim_map, (1, 0, 1, 0))


def _use_fused_kernel(mode: str, device: torch.device) -> bool:
    """The JAX package's routing rule (rs_ov/nn/attention.py:131-144) with the
    card in the TPU's role: ``RS_OV_FUSED_ATTN`` is "1", the tensors are on
    CUDA and the kernel supports the mode."""
    from rs_ov_torch.kernels.selfself_attention import SUPPORTED_MODES

    return (os.environ.get("RS_OV_FUSED_ATTN", "0") == "1" and device.type == "cuda"
            and mode in SUPPORTED_MODES)


def custom_attn(p, x: torch.Tensor, *, mode: str, heads: int,
                sim_map: torch.Tensor | None = None,
                similarity_weight: float = 1.0,
                gaussian_std: float = 1.0,
                grid_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Self-self attention mode registry over [B, L, D] (CLS at index 0).

    ``sim_map``: optional [B, L-1, L-1] fp32 mid-layer cosine-similarity map,
    added (raw) to the pre-softmax logits, or for ``Experimental`` to the
    post-softmax weights, which are then softmaxed again. ``grid_hw`` and
    ``gaussian_std`` shape the NACLIP / NOnly / GAV locality bias (a square
    grid when ``grid_hw`` is None)."""
    b, l, d = x.shape
    scale = (d // heads) ** -0.5
    q, k, v = qkv_projection(p, x, heads)

    if _use_fused_kernel(mode, x.device):
        from rs_ov_torch.kernels.selfself_attention import fused_selfself_attention

        sim_padded = None if sim_map is None else \
            _pad_sim_map_for_cls(sim_map.float()).contiguous()
        ctx = fused_selfself_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       sim_padded, mode=mode,
                                       sim_weight=float(similarity_weight))
        return linear(_merge_heads(ctx), p.out_proj_w, p.out_proj_b)

    sim = None
    if sim_map is not None:
        sim = _pad_sim_map_for_cls(sim_map.float())[:, None] * similarity_weight

    def enhance(logits):
        return logits if sim is None else logits + sim

    def score(a, c):
        return _bmm(a, c.transpose(-1, -2)) * scale

    if mode == "vanilla":
        attn = _softmax32(enhance(score(q, k)))
    elif mode == "MaskCLIP":
        attn = torch.eye(l, dtype=torch.float32, device=x.device).expand(b, heads, l, l)
    elif mode == "SCLIP":
        attn = _softmax32(enhance(score(q, q))) + _softmax32(enhance(score(k, k)))
    elif mode == "SegEarth":
        attn = (_softmax32(enhance(score(q, q))) + _softmax32(enhance(score(k, k)))
                + _softmax32(enhance(score(v, v))))
    elif mode == "SFP":
        attn = _softmax32(enhance(0.5 * (score(q, q) + score(k, k))))
    elif mode == "Experimental":
        # the sim map is added to the post-softmax weights, then softmaxed again
        attn = _softmax32(enhance(_softmax32(score(k, k) + score(q, q))))
    elif mode == "ClearCLIP":
        attn = _softmax32(enhance(score(q, q)))
    elif mode in ("NACLIP", "NOnly", "GAV"):
        if grid_hw is None:
            g = int(math.sqrt(l - 1))
            grid_hw = (g, g)
        omega = _gaussian_on(grid_hw[0], grid_hw[1], float(gaussian_std), x.device)
        omega = omega.expand(b, heads, l, l)
        if mode == "NACLIP":
            logits = score(k, k)
        else:
            qn = torch.linalg.vector_norm(q.float(), dim=-1)  # [B, H, L]
            kn = torch.linalg.vector_norm(k.float(), dim=-1)
            omega = omega * scale * (qn[..., :, None] * kn[..., None, :])
            logits = (torch.zeros((b, heads, l, l), device=x.device) if mode == "NOnly"
                      else score(q, k))
        attn = _softmax32(logits + omega)
    else:
        raise ValueError(f"Unknown attention mode '{mode}'. Known: {ATTENTION_MODES}")

    return _context(p, attn, v, x.dtype)
