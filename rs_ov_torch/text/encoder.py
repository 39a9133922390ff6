"""CLIP text transformer forward (rs_ov/text/encoder.py): token + position
embedding -> causal transformer -> ln_final -> argmax-EOT pool -> projection."""

from __future__ import annotations

import torch

from rs_ov.core.config import TextConfig
from rs_ov_torch.nn.attention import standard_attention
from rs_ov_torch.nn.layers import gelu, layer_norm, mlp, quick_gelu

__all__ = ["text_forward", "causal_mask"]


def causal_mask(n: int, device=None) -> torch.Tensor:
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def text_forward(p, text_ids: torch.Tensor, cfg: TextConfig,
                 quick_gelu_act: bool = False, normalize: bool = False) -> torch.Tensor:
    """text_ids int [B, ctx] (0-padded) -> [B, output_dim] in the weights'
    dtype; L2-normalised in fp32 when ``normalize``."""
    act = quick_gelu if quick_gelu_act else gelu
    x = p.token_embedding[text_ids]
    x = x + p.positional_embedding.to(x.dtype)[None]
    mask = causal_mask(cfg.context_length, x.device)
    for blk in p.blocks:
        attn_out, _ = standard_attention(blk.attn, layer_norm(x, blk.ln_1), cfg.heads,
                                         mask=mask)
        x = x + attn_out
        x = x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)
    x = layer_norm(x, p.ln_final)
    # the EOT token has the highest id in each row
    pooled = x[torch.arange(x.shape[0], device=x.device), text_ids.argmax(-1)]
    out = torch.matmul(pooled.float(), p.text_projection.float()).to(x.dtype)
    if normalize:
        out32 = out.float()
        out = (out32 / out32.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(out.dtype)
    return out
