"""Primitive layers (rs_ov/nn/layers.py).

Precision policy as in the JAX package: LayerNorm computes in fp32 and casts
back; a linear layer multiplies its (possibly bf16) operands in fp32, adds
the bias in fp32 and returns the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "linear", "gelu", "quick_gelu", "mlp"]


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32. ``p`` has ``scale`` and ``bias``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w.T + b with torch-style (out, in) weights, computed in fp32."""
    y = torch.matmul(x.float(), w.float().t())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


def mlp(x: torch.Tensor, p, act=gelu) -> torch.Tensor:
    """c_fc -> act -> c_proj."""
    return linear(act(linear(x, p.c_fc_w, p.c_fc_b)), p.c_proj_w, p.c_proj_b)
