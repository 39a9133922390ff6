"""JBU range-kernel logits (local self-correlation of the guidance projection):

    logits[b, u*d+v, h, w] = sum_k padded[b, k, h+u, w+v] * proj[b, k, h, w]

``range_logits`` dispatches on the device: a CPU tensor takes the plain
version (a loop of shifted multiply-adds), a CUDA tensor the hand-written
kernel in ``rs_ov_torch/csrc/range_logits.cu`` (the window staged once for
several tap rows by cp.async, d accumulators a thread), which replaces the
TPU kernel ``range_logits_pallas`` (rs_ov/kernels/range_logits.py:64).
"""

from __future__ import annotations

import torch

from rs_ov_torch.kernels.build import check, launch, load_library

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


def _range_logits_operands(padded: torch.Tensor, proj: torch.Tensor,
                           diameter: int) -> tuple[torch.Tensor, tuple]:
    """The operands checked and the output allocated. Returns (out, args):
    the library entry's arguments up to the stream."""
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
    return out, (padded.data_ptr(), proj.data_ptr(), out.data_ptr(), b, k, h, w, d)


def _range_logits_cuda(padded: torch.Tensor, proj: torch.Tensor,
                       diameter: int) -> torch.Tensor:
    out, args = _range_logits_operands(padded, proj, diameter)
    check(launch(load_library().rs_range_logits, args, proj.device), "rs_range_logits")
    range_logits.launches += 1
    return out


def range_logits(padded: torch.Tensor, proj: torch.Tensor, diameter: int) -> torch.Tensor:
    """padded [B, K, H+d-1, W+d-1] (reflect-padded projection), proj
    [B, K, H, W] -> logits [B, d*d, H, W] fp32."""
    if proj.device.type == "cpu":
        return range_logits_plain(padded, proj, diameter)
    if proj.device.type != "cuda":
        raise NotImplementedError(f"range_logits: no route for {proj.device}")
    return _range_logits_cuda(padded, proj, diameter)


range_logits.launches = 0  # CUDA kernel launches, for the chip smoke run
