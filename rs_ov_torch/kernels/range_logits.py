"""JBU range-kernel logits (local self-correlation of the guidance projection):

    logits[b, u*d+v, h, w] = sum_k padded[b, k, h+u, w+v] * proj[b, k, h, w]

``range_logits`` dispatches on the device: a CPU tensor takes the plain
version (a loop of shifted multiply-adds), a CUDA tensor the hand-written
kernel in ``rs_ov_torch/csrc/range_logits.cu`` (the window staged once for
several tap rows by cp.async, d accumulators a thread), which replaces the
TPU kernel ``range_logits_pallas`` (rs_ov/kernels/range_logits.py:64),
declared as ``build.Kernel`` (the operator ``rs_ov::range_logits``).
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import Kernel

__all__ = ["range_logits", "range_logits_plain"]

KMAX = 32  # the kernel keeps a pixel's projection in registers
DMAX = 25  # the largest diameter the kernel is instantiated for


def range_logits_plain(padded: torch.Tensor, proj: torch.Tensor,
                       diameter: int) -> torch.Tensor:
    """padded [B, K, H+d-1, W+d-1], proj [B, K, H, W] -> [B, d*d, H, W] fp32."""
    b, _, h, w = proj.shape
    d = diameter
    out = torch.empty((b, d * d, h, w), dtype=torch.float32, device=proj.device)
    p32, q32 = padded.float(), proj.float()
    for u in range(d):
        for v in range(d):
            out[:, u * d + v] = (p32[:, :, u:u + h, v:v + w] * q32).sum(1)
    return out


def _range_logits_operands(padded: torch.Tensor, proj: torch.Tensor, diameter: int):
    """The operands checked and the output allocated. Returns (out, entry,
    args, keep): the library entry, its arguments up to the stream, and no
    tensor of its own to keep."""
    if proj.dim() != 4:
        raise ValueError(f"range_logits: proj must be [B, K, H, W], got {tuple(proj.shape)}")
    b, k, h, w = proj.shape
    d = diameter
    for name, t in (("padded", padded), ("proj", proj)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != proj.device:
            raise ValueError(f"range_logits: {name} must be contiguous fp32 on "
                             f"{proj.device}, got {t.dtype} on {t.device}")
    if tuple(padded.shape) != (b, k, h + d - 1, w + d - 1):
        raise ValueError(f"range_logits: padded {tuple(padded.shape)} does not "
                         f"match proj {tuple(proj.shape)} at d={d}")
    if not 1 <= k <= KMAX or not 1 <= d <= DMAX:
        raise ValueError(f"range_logits kernel takes 1 <= K <= {KMAX} and 1 <= d <= "
                         f"{DMAX}, got K={k}, d={d}")
    out = torch.empty((b, d * d, h, w), dtype=torch.float32, device=proj.device)
    return out, "rs_range_logits", (padded.data_ptr(), proj.data_ptr(), out.data_ptr(), b, k,
                                    h, w, d), ()


def _range_logits_fake(padded, proj, diameter):
    b, _, h, w = proj.shape
    return proj.new_empty((b, diameter * diameter, h, w), dtype=torch.float32)


range_logits = Kernel(
    "range_logits", "(Tensor padded, Tensor proj, int diameter) -> Tensor", range_logits_plain,
    _range_logits_operands, _range_logits_fake,
    doc="""padded [B, K, H+d-1, W+d-1] (reflect-padded projection), proj
    [B, K, H, W] -> logits [B, d*d, H, W] fp32.""")
