"""The decontaminating vision transformer (rs_ov/nn/vit.py:39-331):

  patchify -> CLS + (interpolated) pos-embed -> ln_pre (not for CLIPA)
  -> front blocks (capturing the mid-layer state for similarity enhancement,
     the head-averaged attention of the outlier source layers, or the
     layer-fusion EMA of every block's attention)
  -> last block(s): output (+)= custom_attn(ln_1(x))   [ignore_residual]
                    or x + attn + mlp                  [otherwise]
  -> SOM | layer-fusion re-weighting | self-attention enhancement
  -> outlier suppression -> ln_post -> pool ('tok': CLS, 'avg': mean of the
     patch tokens; CLIPA's final_ln_after_pool pools the raw stream, applies
     ln_post to the pooled vector only and leaves the tokens un-normalised)
  -> @proj (fp32) -> (pooled, tokens)

LayerScale towers (ViT-M-16-alt) scale each branch of the ordinary blocks by
``ls_1`` / ``ls_2``; the decontaminated last block's own output leaves them
out, as in the JAX package (rs_ov/nn/vit.py:245-256). The JAX package runs
the homogeneous front blocks as one lax.scan; the port keeps a loop.
"""

from __future__ import annotations

import dataclasses

import torch

from rs_ov_torch.core.config import VisionConfig
from rs_ov_torch.decontam.layer_fusion import fuse_attention_ema, layer_fusion_reweight
from rs_ov_torch.decontam.outlier import outlier_suppress
from rs_ov_torch.decontam.self_attn_enhance import self_attention_enhance
from rs_ov_torch.decontam.similarity import compute_similarity_map
from rs_ov_torch.decontam.som import suppress_outlier_module
from rs_ov_torch.nn.attention import custom_attn, qkv_projection, standard_attention
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, mlp, quick_gelu
from rs_ov_torch.utils.resize import resize_bicubic_scaled

__all__ = ["VitCallConfig", "vit_forward", "interpolate_pos_embedding"]


@dataclasses.dataclass(frozen=True)
class VitCallConfig:
    """rs_ov.nn.vit.VitCallConfig (rs_ov/nn/vit.py:39-85), with the same
    defaults; ``vit_forward`` always returns (pooled, tokens), so the JAX
    field ``output_cls_token`` is the caller's choice of what to keep
    (``factory.CLIPModel.encode_image``)."""

    model_type: str = "ClearCLIP"
    ignore_residual: bool = True
    last_n_layers: int = 1
    quick_gelu: bool = False
    # similarity enhancement
    apply_similarity_enhancement: bool = False
    similarity_weight: float = 1.0
    similarity_temperature: float = 1.0
    add_self_similarity: bool = True
    # outlier suppression
    apply_outlier_suppression: bool = False
    outlier_top_k: int = 10
    contamination_temp: float = 0.1
    # global layers whose head-averaged attention (their mean) feeds outlier
    # detection and self-attention enhancement; () = the last front block
    outlier_source_layers: tuple = ()
    # self-attention enhancement
    apply_self_attn_enhancement: bool = False
    self_attn_strength: float = 0.1
    self_attn_threshold: float = 0.15
    self_attn_mode: str = "feature"
    self_attn_top_k: int = 10
    # attention layer fusion
    apply_layer_fusion: bool = False
    layer_fusion_lambda: float = 0.5
    layer_fusion_threshold: float = 0.7
    # SOM, the Suppress Outlier Module
    apply_som: bool = False
    som_consensus_threshold: float = 0.5
    som_detection_mode: str = "both"
    som_self_sufficiency_ratio: float = 1.0
    # NACLIP-family spatial bias
    gaussian_std: float = 1.0


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
    if hasattr(blk, "ls_1"):
        attn_out = attn_out * blk.ls_1.to(attn_out.dtype)
    x = x + attn_out
    mlp_out = mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)
    if hasattr(blk, "ls_2"):
        mlp_out = mlp_out * blk.ls_2.to(mlp_out.dtype)
    return x + mlp_out, weights


def _patch_stage(output: torch.Tensor, gh: int, gw: int, fn) -> torch.Tensor:
    """Apply fn to the patch tokens of [B, L, D] as a [B, D, gh, gw] map; the
    CLS token passes through."""
    b, _, d = output.shape
    spatial = output[:, 1:].transpose(1, 2).reshape(b, d, gh, gw)
    out = fn(spatial).reshape(b, d, gh * gw).transpose(1, 2)
    return torch.cat([output[:, :1], out], dim=1)


def vit_forward(p, images: torch.Tensor, vcfg: VisionConfig, call: VitCallConfig):
    """images [B, 3, H, W] (H, W multiples of the patch size), in the
    weights' dtype -> (pooled [B, E], tokens [B, P, E]) in that dtype
    (rs_ov/nn/vit.py:133-331)."""
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
    x = x + pos.to(x.dtype)[None]
    if not vcfg.no_ln_pre:
        x = layer_norm(x, p.ln_pre)

    n_layers = len(p.blocks)
    last_n = call.last_n_layers
    n_front = n_layers - last_n
    mid_idx = n_front // 2

    # the attention maps are captured when outlier suppression or
    # self-attention enhancement reads them, unless layer fusion replaces
    # them (rs_ov/nn/vit.py:166-181)
    capture_attn = ((call.apply_outlier_suppression or call.apply_self_attn_enhancement)
                    and not call.apply_layer_fusion)
    if call.outlier_source_layers:
        src_layers = sorted({i if i >= 0 else n_layers + i
                             for i in call.outlier_source_layers})
        if not all(0 <= i < n_layers for i in src_layers):
            raise ValueError(f"outlier_source_layers {call.outlier_source_layers} out "
                             f"of range for {n_layers} layers")
    else:
        src_layers = [n_front - 1]

    mid_features = None
    captured = []     # head-averaged [B, L, L] maps of the source layers
    attn_acc = None   # the layer-fusion EMA
    for idx in range(n_front):
        if idx == mid_idx:
            mid_features = x  # the state BEFORE block mid_idx
        need_w = call.apply_layer_fusion or (capture_attn and idx in src_layers)
        x, w_attn = _resblock(p.blocks[idx], x, heads, act, need_weights=need_w)
        if call.apply_layer_fusion:
            attn_acc = fuse_attention_ema(attn_acc, w_attn, call.layer_fusion_lambda)
        elif need_w:
            captured.append(w_attn)

    sim_map = None
    if call.apply_similarity_enhancement and mid_features is not None:
        sim_map = compute_similarity_map(
            mid_features[:, 1:, :], temperature=call.similarity_temperature,
            add_self_similarity=call.add_self_similarity)

    output = None
    qk_attn = None  # per-head qk attention of the final block, for SOM
    for i in range(last_n):
        layer = n_front + i
        blk = p.blocks[layer]
        x_ln = layer_norm(x, blk.ln_1)
        if call.apply_som and i == last_n - 1:
            q, k, _ = qkv_projection(blk.attn, x_ln, heads)
            scale = (vcfg.width // heads) ** -0.5
            qk_attn = torch.softmax(
                torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
        attn_out = custom_attn(blk.attn, x_ln, mode=call.model_type, heads=heads,
                               sim_map=sim_map, similarity_weight=call.similarity_weight,
                               gaussian_std=call.gaussian_std, grid_hw=(gh, gw))
        if not call.ignore_residual:
            attn_out = x + attn_out
            attn_out = attn_out + mlp(layer_norm(attn_out, blk.ln_2), blk.mlp, act=act)
        output = attn_out if output is None else output + attn_out
        # the ordinary stream runs through the full block when a later block,
        # a capture or layer fusion reads it; otherwise nothing does
        need_w = call.apply_layer_fusion or (capture_attn and layer in src_layers)
        if need_w or i < last_n - 1:
            x, w_attn = _resblock(blk, x, heads, act, need_weights=need_w)
            if call.apply_layer_fusion:
                attn_acc = fuse_attention_ema(attn_acc, w_attn, call.layer_fusion_lambda)
            elif need_w:
                captured.append(w_attn)

    attn_weights = None
    if captured:
        attn_weights = captured[0] if len(captured) == 1 else sum(captured) / len(captured)

    if call.apply_som:
        purified, _, _ = suppress_outlier_module(
            output[:, 1:], qk_attn, gh, gw,
            consensus_threshold=call.som_consensus_threshold,
            detection_mode=call.som_detection_mode,
            self_sufficiency_ratio=call.som_self_sufficiency_ratio)
        output = torch.cat([output[:, :1], purified], dim=1)

    if call.apply_layer_fusion and call.apply_outlier_suppression:
        output = layer_fusion_reweight(output, attn_acc, call.outlier_top_k)

    if call.apply_self_attn_enhancement and attn_weights is not None:
        output = _patch_stage(output, gh, gw, lambda s: self_attention_enhance(
            s, attn_weights, gh, gw, mode=call.self_attn_mode,
            enhancement_strength=call.self_attn_strength,
            min_self_attn_threshold=call.self_attn_threshold,
            top_k=call.self_attn_top_k))

    if call.apply_outlier_suppression and attn_weights is not None:
        output = _patch_stage(output, gh, gw, lambda s: outlier_suppress(
            s, attn_weights, gh, gw, top_k=call.outlier_top_k,
            contamination_temp=call.contamination_temp))

    def pool(y):
        return y[:, 1:].mean(1) if vcfg.pool_type == "avg" else y[:, 0]

    if vcfg.final_ln_after_pool:
        pooled, tokens = layer_norm(pool(output), p.ln_post), output[:, 1:]
    else:
        x = layer_norm(output, p.ln_post)
        pooled, tokens = pool(x), x[:, 1:]
    proj = p.proj.float()
    dtype = output.dtype
    return (torch.matmul(pooled.float(), proj).to(dtype),
            torch.matmul(tokens.float(), proj).to(dtype))
