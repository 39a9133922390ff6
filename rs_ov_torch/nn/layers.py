"""Primitive layers (rs_ov/nn/layers.py).

Precision policy as in the JAX package: LayerNorm computes in fp32 and casts
back; a linear layer multiplies its (possibly bf16) operands with fp32 sums
(``matmul32``), adds the bias in fp32 and returns the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "linear", "matmul32", "gelu", "quick_gelu", "mlp"]


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (torch.matmul's broadcasting) with fp32 sums and an fp32 result,
    as the JAX package's ``preferred_element_type=jnp.float32`` products.
    CUDA bf16 operands go to the tensor cores as they are (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype=torch.float32``): the products of bf16
    values are exact in fp32. Other operands are upcast to fp32 first, the
    only form on the CPU, which has no kernel for ``out_dtype``; fp32
    products run in full fp32 (TF32 stays off, pipeline/segmentor.py)."""
    if a.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"matmul32: no route for {a.device}")
    if not (a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16
            and a.dim() >= 2 and b.dim() >= 2):
        return torch.matmul(a.float(), b.float())
    m, n = a.shape[-2], b.shape[-1]
    if b.dim() == 2:  # one right operand: a single product over a's leading axes
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], n)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    y = torch.bmm(a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:]),
                  b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:]),
                  out_dtype=torch.float32)
    return y.reshape(*batch, m, n)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32. ``p`` has ``scale`` and ``bias``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w.T + b with torch-style (out, in) weights: fp32 sums, the bias
    added in fp32, one cast to x's dtype (rs_ov/nn/layers.py:28-36)."""
    y = matmul32(x, w.t())
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
