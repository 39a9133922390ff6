"""Primitive layers (rs_ov/nn/layers.py).

Precision policy as in the JAX package: LayerNorm computes in fp32 and casts
back (on the card in one kernel, K7); a linear layer multiplies its (possibly
bf16) operands with fp32 sums (``matmul32``), adds the bias in fp32 and
returns the input's dtype (on the card the bias add, the rounding and the
MLP's activation in one kernel, K8).
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.layer_norm import layer_norm as _layer_norm
from rs_ov_torch.kernels.linear_epilogue import ACTIVATIONS, gelu, quick_gelu
from rs_ov_torch.kernels.linear_epilogue import linear_epilogue as _linear_epilogue

__all__ = ["layer_norm", "linear", "matmul32", "gelu", "quick_gelu", "mlp"]


def _matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul32``'s product, with no gradient of its own."""
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


def _unbroadcast(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sum a broadcast gradient back to an operand's ``shape``."""
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dims, keepdim=True) if dims else g


def _matmul32_grads(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, need_a: bool,
                    need_b: bool):
    """JAX's transpose rule for a dot with ``preferred_element_type=float32``:
    each operand's gradient is a product of the fp32 cotangent with the other
    operand, with fp32 sums, summed over broadcast axes and cast to the
    operand's dtype. On the card's bf16 route the cotangent is rounded to
    bf16 so that both products run on the bf16 tensor cores (fp32 sums)."""
    if a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16:
        g = g.to(torch.bfloat16)
    ga = gb = None
    if need_a:
        ga = _unbroadcast(_matmul32(g, b.transpose(-1, -2)), a.shape).to(a.dtype)
    if need_b and b.dim() == 2:  # one product over a's leading axes, as the forward
        gb = _matmul32(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1])).to(b.dtype)
    elif need_b:
        gb = _unbroadcast(_matmul32(a.transpose(-1, -2), g), b.shape).to(b.dtype)
    return ga, gb


class _Matmul32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _matmul32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _matmul32_grads(a, b, g, *ctx.needs_input_grad)


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (torch.matmul's broadcasting) with fp32 sums and an fp32 result,
    as the JAX package's ``preferred_element_type=jnp.float32`` products.
    CUDA bf16 operands go to the tensor cores as they are (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype=torch.float32``): the products of bf16
    values are exact in fp32. Other operands are upcast to fp32 first, the
    only form on the CPU, which has no kernel for ``out_dtype``; fp32
    products run in full fp32 (TF32 stays off, pipeline/segmentor.py).
    Where an operand needs a gradient the product is ``_Matmul32``, whose
    backward is ``_matmul32_grads`` (2-D operands or more)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul32.apply(a, b)
    return _matmul32(a, b)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32. ``p`` has ``scale`` and ``bias``.
    One launch of the kernel K7 on the card (``kernels/layer_norm.py``)."""
    return _layer_norm(x, p.scale, p.bias, eps)


# the activations K8 applies, by the function: its name for the kernel
_EPILOGUE_ACTS = {fn: name for name, fn in ACTIVATIONS.items()}


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           act=None) -> torch.Tensor:
    """act(x @ w.T + b) with torch-style (out, in) weights: fp32 sums, the bias
    added in fp32, one cast to x's dtype (rs_ov/nn/layers.py:28-36), then
    ``act`` on the cast values. The bias add, the cast and ``quick_gelu`` or
    ``gelu`` are one call of ``linear_epilogue`` (K8 on the card, with the
    plain chain's gradient where an operand needs one); another ``act`` is
    applied after."""
    if act not in _EPILOGUE_ACTS:
        return act(linear(x, w, b))
    y = matmul32(x, w.t())
    if b is None and act is None and y.dtype == x.dtype:
        return y  # nothing to add, round or apply
    return _linear_epilogue(y, b, _EPILOGUE_ACTS[act], x.dtype)


def mlp(x: torch.Tensor, p, act=gelu) -> torch.Tensor:
    """c_fc -> act -> c_proj."""
    return linear(linear(x, p.c_fc_w, p.c_fc_b, act=act), p.c_proj_w, p.c_proj_b)
