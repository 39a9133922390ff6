"""A linear layer's epilogue (K8): the fp32 product's bias add, its one
rounding to the layer's dtype and the MLP's activation,

    out = act((y + bias.float()).to(dtype))

y the fp32 product [..., N] of ``nn.layers.matmul32``, bias [N] (bf16 or
fp32) or None, dtype bf16 or fp32, act ``"none"``, ``"quick_gelu"`` or
``"gelu"`` (exact, erf) applied to the rounded values: the JAX package's
``rs_ov/nn/layers.py:linear`` and the activation after ``mlp``'s ``c_fc``.
``linear_epilogue`` dispatches on the device: a CPU tensor takes the plain
version (the chain of eager tensor operations), a CUDA tensor the
hand-written kernel in ``rs_ov_torch/csrc/linear_epilogue.cu`` (one launch,
the product read once and the output written once, each step rounded where
the chain rounds it, so that both are equal bit for bit), declared as
``build.Kernel`` (the operator ``rs_ov::linear_epilogue``). It replaces no
TPU kernel: XLA fused the JAX package's epilogue into the product's
consumer, where the chain is 3 launches after the product on the card and
1 (GELU) or 3 (QuickGELU) more. Where an operand needs a gradient the call
is ``_LinearEpilogue``: the kernel forward, the plain chain's gradient
backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rs_ov_torch.kernels.build import Kernel

__all__ = ["linear_epilogue", "linear_epilogue_plain", "quick_gelu", "gelu", "ACTIVATIONS"]

_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


# the activations the kernel applies, by the name it takes; the kernel's code
# is the position
ACTIVATIONS = {"none": None, "quick_gelu": quick_gelu, "gelu": gelu}
_ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}


def linear_epilogue_plain(y: torch.Tensor, bias: torch.Tensor | None, act: str,
                          dtype: torch.dtype) -> torch.Tensor:
    """y [..., N] fp32, bias [N] or None -> [..., N] in ``dtype``: the chain as
    eager operations (the bias added in fp32, one rounding to ``dtype``, the
    activation), differentiable, as a tensor of its own (as the kernel's
    output)."""
    h = (y if bias is None else y + bias.float()).to(dtype)
    fn = ACTIVATIONS[act]
    out = h if fn is None else fn(h)
    return out.clone() if out is y else out


def _linear_epilogue_operands(y: torch.Tensor, bias: torch.Tensor | None, act: str,
                              dtype: torch.dtype):
    """The operands checked and the output allocated. Returns (out, entry,
    args, keep): the library entry, its arguments up to the stream, and the
    tensors the kernel reads."""
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(f"linear_epilogue: y must be a contiguous fp32 product, got "
                         f"{y.dtype} {tuple(y.shape)} strides {y.stride()}")
    if dtype not in _CODES or act not in _ACT_CODES:
        raise ValueError(f"linear_epilogue: dtype must be fp32 or bf16 and act one of "
                         f"{tuple(ACTIVATIONS)}, got {dtype}, {act!r}")
    n = y.shape[-1] if y.dim() else 0
    rows = y.numel() // n if n else 0
    if not 1 <= rows < 2 ** 31 or not 1 <= n < 2 ** 31:
        raise ValueError(f"linear_epilogue kernel takes 1 <= rows < 2^31 and 1 <= N < 2^31, "
                         f"got y {tuple(y.shape)}")
    bcode, bp = -1, 0
    if bias is not None:
        if (bias.dtype not in _CODES or bias.shape != (n,) or not bias.is_contiguous()
                or bias.device != y.device):
            raise ValueError(f"linear_epilogue: bias {tuple(bias.shape)} {bias.dtype} on "
                             f"{bias.device} must be contiguous [{n}] fp32 or bf16 on "
                             f"{y.device}")
        bcode, bp = _CODES[bias.dtype], bias.data_ptr()
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    yp, op = y.data_ptr(), out.data_ptr()
    vec = 8 if n % 8 == 0 and (yp | op | bp) % 16 == 0 else 1
    return out, "rs_linear_epilogue", (yp, bp, op, rows, n, _CODES[dtype], bcode,
                                       _ACT_CODES[act], vec), (y, bias)


def _linear_epilogue_fake(y, bias, act, dtype):
    return y.new_empty(y.shape, dtype=dtype)


_KERNEL = Kernel(
    "linear_epilogue", "(Tensor y, Tensor? bias, str act, ScalarType dtype) -> Tensor",
    linear_epilogue_plain, _linear_epilogue_operands, _linear_epilogue_fake)


class _LinearEpilogue(torch.autograd.Function):
    """The kernel forward; the plain chain's gradient backward. With an
    activation it is recomputed from the saved product; without one the
    chain's gradient reads no value of the forward, so nothing is kept."""

    @staticmethod
    def forward(ctx, y, bias, act, dtype):
        ctx.act, ctx.dtype = act, dtype
        ctx.save_for_backward(y if ACTIVATIONS[act] else None, bias)
        return _KERNEL(y, bias, act, dtype)

    @staticmethod
    def backward(ctx, g):
        y, bias = ctx.saved_tensors
        need_y, need_b = ctx.needs_input_grad[:2]
        if y is None:  # the casts' and the add's gradients, as autograd forms them
            g32 = g.to(torch.float32)
            return (g32 if need_y else None,
                    g32.sum_to_size(bias.shape).to(bias.dtype) if need_b else None, None, None)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip((y, bias), (need_y, need_b))]
            out = linear_epilogue_plain(*leaves, ctx.act, ctx.dtype)
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None
                                                   and t.requires_grad], g))
        return (next(grads) if need_y else None, next(grads) if need_b else None, None, None)


def linear_epilogue(y: torch.Tensor, bias: torch.Tensor | None, act: str,
                    dtype: torch.dtype) -> torch.Tensor:
    """y [..., N] fp32 product, bias [N] or None -> act((y + bias).to(dtype)):
    one launch of K8 on the card, the plain chain on the CPU."""
    if torch.is_grad_enabled() and (y.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return _LinearEpilogue.apply(y, bias, act, dtype)
    return _KERNEL(y, bias, act, dtype)
