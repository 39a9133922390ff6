"""Attention (rs_ov/nn/attention.py): standard multi-head attention with
head-averaged weights, and the ``Experimental`` self-self mode.

Layouts as in the JAX package: [B, L, D] in and out, heads [B, H, L, hd].
Softmaxes run in fp32; batched products take the operands in their dtype,
multiply in fp32 and keep the fp32 result.
"""

from __future__ import annotations

import torch

from rs_ov_torch.nn.layers import linear

__all__ = ["standard_attention", "custom_attn", "qkv_projection"]


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
    """Batched product in fp32 from operands of any float dtype."""
    return torch.matmul(a.float(), b.float())


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


def custom_attn(p, x: torch.Tensor, *, mode: str, heads: int,
                sim_map: torch.Tensor | None = None,
                similarity_weight: float = 1.0) -> torch.Tensor:
    """Self-self attention over [B, L, D] (CLS at index 0). Only the
    ``Experimental`` mode is ported: softmax(qq + kk), the mid-layer sim map
    [B, L-1, L-1] added to those post-softmax weights (zero CLS row and
    column), then softmaxed again (rs_ov/nn/attention.py:206-211)."""
    if mode != "Experimental":
        raise NotImplementedError(
            f"attention mode '{mode}' is not ported yet (ROADMAP queue 1 item 7)")
    scale = (x.shape[-1] // heads) ** -0.5
    q, k, v = qkv_projection(p, x, heads)
    qq = _bmm(q, q.transpose(-1, -2)) * scale
    kk = _bmm(k, k.transpose(-1, -2)) * scale
    attn = _softmax32(kk + qq)
    if sim_map is not None:
        sim = torch.nn.functional.pad(sim_map.float(), (1, 0, 1, 0))
        attn = _softmax32(attn + sim[:, None] * similarity_weight)
    else:
        attn = _softmax32(attn)
    return _context(p, attn, v, x.dtype)
