"""LayerNorm over the last axis, with fp32 statistics (K7):

    out = ((x - mean) * rsqrt(var + eps) * scale + bias).to(x.dtype)

the mean and the variance (the mean of squared deviations) over the last
axis in fp32, the affine step in fp32, one rounding to x's dtype: the JAX
package's ``rs_ov/nn/layers.py:layer_norm``. ``layer_norm`` dispatches on the
device: a CPU tensor takes the plain version (the same formula as eager
tensor operations), a CUDA tensor the hand-written kernel in
``rs_ov_torch/csrc/layer_norm.cu`` (one launch, the row read once and
written once), declared as ``build.Kernel`` (the operator
``rs_ov::layer_norm``; eager CUDA calls launch it directly, a traced call
records one node). It replaces no TPU kernel: XLA fused the JAX package's
LayerNorm, where the plain version is 14 launches on the card.
Where an operand needs a gradient the call is ``_LayerNorm``, whose backward
is the plain version's gradient, recomputed from the saved input.
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import Kernel

__all__ = ["layer_norm", "layer_norm_plain"]

_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes
MAX_VECTORS = 8  # 16-byte vectors a lane holds at most (the row in registers)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """x [..., D], scale and bias [D] -> [..., D] in x's dtype, contiguous
    (as the kernel's output)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype).contiguous()


def _row_vectors(d: int, dtype: torch.dtype, aligned: bool) -> int:
    """The 16-byte vectors a lane of the one-warp-a-row kernel holds for a
    row of d elements of ``dtype``, or 0 for the one-block-a-row kernel: a
    row that is not a whole number of vectors, operands that are not 16-byte
    aligned, or a row longer than MAX_VECTORS vectors a lane."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if not aligned or d % vec or d > MAX_VECTORS * 32 * vec:
        return 0
    return -(-d // (32 * vec))


def _layer_norm_operands(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float):
    """The operands checked, x made contiguous and the output allocated.
    Returns (out, entry, args, keep): the library entry, its arguments up to
    the stream, and x as the kernel reads it."""
    x = x.contiguous()
    d = x.shape[-1] if x.dim() else 0
    code, pcode = _CODES.get(x.dtype), _CODES.get(scale.dtype)
    if code is None or pcode is None or bias.dtype not in _CODES:
        raise ValueError(f"layer_norm: x, scale and bias must be fp32 or bf16, got {x.dtype}, "
                         f"{scale.dtype}, {bias.dtype}")
    if (scale.shape != (d,) or bias.shape != (d,) or bias.dtype != scale.dtype
            or not (scale.is_contiguous() and bias.is_contiguous())
            or scale.device != x.device or bias.device != x.device):
        raise ValueError(f"layer_norm: scale {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device} and bias {tuple(bias.shape)} {bias.dtype} on "
                         f"{bias.device} must be contiguous [{d}] of one dtype on {x.device}, "
                         f"for x {tuple(x.shape)}")
    rows = x.numel() // d if d else 0
    if not 1 <= rows < 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"layer_norm kernel takes 1 <= rows < 2^31 and 1 <= D < 2^31, "
                         f"got x {tuple(x.shape)}")
    out = torch.empty_like(x)
    xp, sp, bp = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    nv = _row_vectors(d, x.dtype, (xp | sp | bp) % 16 == 0)
    return out, "rs_layer_norm", (xp, sp, bp, out.data_ptr(), rows, d, code, pcode, nv, eps), x


def _layer_norm_fake(x, scale, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_KERNEL = Kernel("layer_norm", "(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor",
                 layer_norm_plain, _layer_norm_operands, _layer_norm_fake)


class _LayerNorm(torch.autograd.Function):
    """The kernel forward; the plain version's gradient backward,
    recomputed from the saved operands."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _KERNEL(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = layer_norm_plain(*leaves, ctx.eps)
            grads = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need), None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x [..., D] normalised over its last axis with scale and bias [D] ->
    [..., D] in x's dtype (fp32 or bf16 on the card; parameters fp32 or
    bf16)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _KERNEL(x, scale, bias, eps)
