"""The BLIP vision transformer with its q.q last block (rs_ov/nn/blip_vit.py).

A timm-style pre-LN ViT: LayerNorm eps 1e-6, a biased patch embedding, a CLS
token, a learned pos-embed and no ln_pre. With ``ignore_residual`` its last
block runs attention only, residual-free, with q q^T scores in place of
q k^T. The segmentor resizes each crop to the tower's ``image_size``, so
the pos-embed is never interpolated.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rs_ov_torch.core.params import Attention, LayerNorm, Mlp, _p
from rs_ov_torch.nn.attention import (_bmm, _merge_heads, _softmax32, qkv_projection,
                                      standard_attention)
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, mlp
from rs_ov_torch.nn.vit import _patchify

__all__ = ["BlipVisionConfig", "BlipVisionTower", "blip_vit_forward"]

_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0


class PatchEmbed(nn.Module):
    def __init__(self, width: int, patch: int):
        super().__init__()
        self.w = _p(width, 3, patch, patch)
        self.b = _p(width)


class BlipBlock(nn.Module):
    def __init__(self, width: int, mlp_width: int):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = Attention(width)
        self.norm2 = LayerNorm(width)
        self.mlp = Mlp(width, mlp_width)


class BlipVisionTower(nn.Module):
    """The JAX pytree's ``visual``: patch_embed {w, b}, cls_token, pos_embed
    [1 + P, width], blocks, norm."""

    def __init__(self, width: int, patch: int, n_pos: int, layers: int, mlp_width: int):
        super().__init__()
        self.patch_embed = PatchEmbed(width, patch)
        self.cls_token = _p(width)
        self.pos_embed = _p(n_pos, width)
        self.blocks = nn.ModuleList(BlipBlock(width, mlp_width) for _ in range(layers))
        self.norm = LayerNorm(width)

    @classmethod
    def from_config(cls, cfg: BlipVisionConfig) -> "BlipVisionTower":
        return cls(cfg.width, cfg.patch_size, (cfg.image_size // cfg.patch_size) ** 2 + 1,
                   cfg.layers, int(cfg.width * cfg.mlp_ratio))


def _qq_attention(p, x: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q q^T hd^-0.5) v in fp32, out-projected (rs_ov/nn/blip_vit.py:46-53)."""
    q, _, v = qkv_projection(p, x, heads)
    scale = (x.shape[-1] // heads) ** -0.5
    q32 = q.float()
    attn = _softmax32(_bmm(q32, q32.transpose(-1, -2)) * scale)
    out = _merge_heads(_bmm(attn, v.float()).to(x.dtype))
    return linear(out, p.out_proj_w, p.out_proj_b)


def blip_vit_forward(p: BlipVisionTower, images: torch.Tensor, cfg: BlipVisionConfig,
                     ignore_residual: bool = False) -> torch.Tensor:
    """images [B, 3, H, W] in the weights' dtype -> tokens [B, 1 + P, width]
    after the final norm (rs_ov/nn/blip_vit.py:56-80)."""
    b = images.shape[0]
    x = _patchify(images, p.patch_embed.w)
    x = x + p.patch_embed.b.to(x.dtype)
    x = torch.cat([p.cls_token.to(x.dtype).expand(b, 1, -1), x], dim=1)
    x = x + p.pos_embed[:x.shape[1]].to(x.dtype)[None]
    n = len(p.blocks)
    for i, blk in enumerate(p.blocks):
        if i == n - 1 and ignore_residual:
            x = _qq_attention(blk.attn, layer_norm(x, blk.norm1, eps=_LN_EPS), cfg.heads)
        else:
            x = x + standard_attention(blk.attn, layer_norm(x, blk.norm1, eps=_LN_EPS),
                                       cfg.heads)[0]
            x = x + mlp(layer_norm(x, blk.norm2, eps=_LN_EPS), blk.mlp, act=gelu)
    return layer_norm(x, p.norm, eps=_LN_EPS)
