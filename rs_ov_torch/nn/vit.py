"""The decontaminating vision transformer (rs_ov/nn/vit.py), main-path
toggles only:

  patchify -> CLS + (interpolated) pos-embed -> ln_pre
  -> front blocks (capturing the mid-layer state for similarity enhancement
     and the penultimate head-averaged attention for outlier detection)
  -> last block: output = custom_attn(ln_1(x))      [ignore_residual]
                 or x + attn + mlp                  [otherwise]
  -> outlier suppression -> ln_post -> @proj (fp32) -> (pooled, tokens)
"""

from __future__ import annotations

import dataclasses

import torch

from rs_ov.core.config import VisionConfig
from rs_ov_torch.decontam.outlier import outlier_suppress
from rs_ov_torch.decontam.similarity import compute_similarity_map
from rs_ov_torch.nn.attention import custom_attn, standard_attention
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, mlp, quick_gelu
from rs_ov_torch.utils.resize import resize_bicubic_scaled

__all__ = ["VitCallConfig", "vit_forward", "interpolate_pos_embedding"]


@dataclasses.dataclass(frozen=True)
class VitCallConfig:
    """The main-path subset of rs_ov.nn.vit.VitCallConfig (one last block;
    outlier detection from the last front block)."""

    model_type: str = "Experimental"
    ignore_residual: bool = True
    quick_gelu: bool = False
    apply_similarity_enhancement: bool = False
    similarity_weight: float = 1.0
    similarity_temperature: float = 1.0
    add_self_similarity: bool = True
    apply_outlier_suppression: bool = False
    outlier_top_k: int = 10
    contamination_temp: float = 0.1


def _patchify(images: torch.Tensor, conv1_w: torch.Tensor) -> torch.Tensor:
    """The patch conv as patch extraction + matmul. images [B, 3, H, W]."""
    width, cin, ph, pw = conv1_w.shape
    b, c, h, w = images.shape
    gh, gw = h // ph, w // pw
    x = images.reshape(b, c, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, c * ph * pw)
    return linear(x, conv1_w.reshape(width, cin * ph * pw))


def interpolate_pos_embedding(pos_embed: torch.Tensor,
                              grid_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic pos-embed interpolation with the reference's +0.1 coordinate
    scale. pos_embed [N+1, width]."""
    n = pos_embed.shape[0] - 1
    gh, gw = grid_hw
    if gh * gw == n and gh == gw:
        return pos_embed
    old = int(round(n ** 0.5))
    dim = pos_embed.shape[1]
    patch_pos = pos_embed[1:].reshape(old, old, dim).permute(2, 0, 1)
    resized = resize_bicubic_scaled(patch_pos, (gh, gw),
                                    (old / (gh + 0.1), old / (gw + 0.1)))
    resized = resized.permute(1, 2, 0).reshape(gh * gw, dim)
    return torch.cat([pos_embed[:1], resized], dim=0)


def _resblock(blk, x: torch.Tensor, heads: int, act, need_weights: bool = False):
    attn_out, weights = standard_attention(blk.attn, layer_norm(x, blk.ln_1), heads,
                                           need_weights=need_weights)
    x = x + attn_out
    x = x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)
    return x, weights


def vit_forward(p, images: torch.Tensor, vcfg: VisionConfig, call: VitCallConfig):
    """images [B, 3, H, W] (H, W multiples of the patch size), in the
    weights' dtype -> (pooled [B, E], tokens [B, P, E]) in that dtype."""
    b, _, h, w = images.shape
    gh, gw = h // vcfg.patch_size, w // vcfg.patch_size
    heads = vcfg.heads
    act = quick_gelu if call.quick_gelu else gelu

    x = _patchify(images, p.conv1_w)
    cls_tok = p.class_embedding.to(x.dtype).expand(b, 1, -1)
    x = torch.cat([cls_tok, x], dim=1)
    pos = p.positional_embedding
    if x.shape[1] != pos.shape[0]:
        pos = interpolate_pos_embedding(pos, (gh, gw))
    x = layer_norm(x + pos.to(x.dtype)[None], p.ln_pre)

    n_front = len(p.blocks) - 1
    mid_idx = n_front // 2
    mid_features = None
    attn_weights = None
    for idx in range(n_front):
        if idx == mid_idx:
            mid_features = x  # the state BEFORE block mid_idx
        need_w = call.apply_outlier_suppression and idx == n_front - 1
        x, w_attn = _resblock(p.blocks[idx], x, heads, act, need_weights=need_w)
        if need_w:
            attn_weights = w_attn

    sim_map = None
    if call.apply_similarity_enhancement and mid_features is not None:
        sim_map = compute_similarity_map(
            mid_features[:, 1:, :], temperature=call.similarity_temperature,
            add_self_similarity=call.add_self_similarity)

    blk = p.blocks[n_front]
    output = custom_attn(blk.attn, layer_norm(x, blk.ln_1), mode=call.model_type,
                         heads=heads, sim_map=sim_map,
                         similarity_weight=call.similarity_weight)
    if not call.ignore_residual:
        output = x + output
        output = output + mlp(layer_norm(output, blk.ln_2), blk.mlp, act=act)
    # the last block's ordinary stream feeds nothing on this path, so it is
    # not computed

    if call.apply_outlier_suppression and attn_weights is not None:
        d = output.shape[-1]
        spatial = output[:, 1:].transpose(1, 2).reshape(b, d, gh, gw)
        suppressed = outlier_suppress(spatial, attn_weights, gh, gw,
                                      top_k=call.outlier_top_k,
                                      contamination_temp=call.contamination_temp)
        output = torch.cat([output[:, :1],
                            suppressed.reshape(b, d, gh * gw).transpose(1, 2)], dim=1)

    x = layer_norm(output, p.ln_post)
    proj = p.proj.float()
    pooled = torch.matmul(x[:, 0].float(), proj).to(x.dtype)
    tokens = torch.matmul(x[:, 1:].float(), proj).to(x.dtype)
    return pooled, tokens
