"""GEM, the dual-stream self-self attention tower (rs_ov/nn/gem.py).

The last ``depth - 1`` blocks of a plain CLIP ViT run two streams:

  * ori: ordinary q k^T attention + residual + MLP, which feeds the next block;
  * gem: iterated, L2-normalised q q^T, k k^T and v v^T self-self attention
    with an adaptive inverse temperature (the mean token norm times
    hd^-0.5), each applied to the original values and averaged, summed over
    the blocks (or the last block's alone with ``ignore_residual``), no MLP.

The output is the gem stream's patch tokens after ln_post and the
projection: no CLS. The weights are the plain tower's (``VisionTower``); a
pos-embed at another grid is resampled with antialiased bicubic, not the
plain path's +0.1-scale quirk. Every score product, softmax and product
with v runs in fp32, as in the JAX package.
"""

from __future__ import annotations

import torch

from rs_ov_torch.core.config import VisionConfig
from rs_ov_torch.nn.attention import (_bmm, _merge_heads, _softmax32, qkv_projection,
                                      standard_attention)
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, mlp, quick_gelu
from rs_ov_torch.nn.vit import _patchify
from rs_ov_torch.utils.resize import resize_bicubic_antialias

__all__ = ["self_self_attention", "gem_vit_forward", "resample_pos_embed"]


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def self_self_attention(p, x: torch.Tensor, heads: int, *, ss_attn_iter: int = 1,
                        ss_attn_temp: float | None = None):
    """x [B, N, C] -> (x_gem, x_ori), both [B, N, C] in x's dtype
    (rs_ov/nn/gem.py:30-71)."""
    scale = (x.shape[-1] // heads) ** -0.5
    q, k, v = qkv_projection(p, x, heads)
    q32, k32, v32 = q.float(), k.float(), v.float()

    attn_ori = _softmax32(_bmm(q32, k32.transpose(-1, -2)) * scale)
    x_ori = linear(_merge_heads(_bmm(attn_ori, v32).to(x.dtype)), p.out_proj_w, p.out_proj_b)

    if ss_attn_temp is None:  # the mean token norm of each crop, times the scale
        inv_temp = (x.float().norm(dim=-1).mean(-1) * scale)[:, None, None, None]
    else:
        inv_temp = float(ss_attn_temp)

    def attend(t, values):
        return _bmm(_softmax32(_bmm(t, t.transpose(-1, -2)) * inv_temp), values)

    xs = [v32, k32, q32]
    for _ in range(ss_attn_iter):
        xs = [attend(t, t) for t in map(_l2norm, xs)]
    outs = [attend(t, v32) for t in map(_l2norm, xs)]
    x_gem = _merge_heads(((outs[0] + outs[1] + outs[2]) / 3.0).to(x.dtype))
    return linear(x_gem, p.out_proj_w, p.out_proj_b), x_ori


def resample_pos_embed(pos: torch.Tensor, grid_hw: tuple[int, int]) -> torch.Tensor:
    """pos [N+1, width] -> [gh*gw + 1, width]: the patch rows resampled with
    antialiased bicubic to the grid, the CLS row kept."""
    gh, gw = grid_hw
    if pos.shape[0] == gh * gw + 1:
        return pos
    old = int(round((pos.shape[0] - 1) ** 0.5))
    dim = pos.shape[1]
    patch = pos[1:].reshape(old, old, dim).permute(2, 0, 1)
    resized = resize_bicubic_antialias(patch, (gh, gw)).permute(1, 2, 0).reshape(gh * gw, dim)
    return torch.cat([pos[:1], resized], dim=0)


def gem_vit_forward(p, images: torch.Tensor, vcfg: VisionConfig, *, depth: int = 7,
                    ss_attn_iter: int = 1, ss_attn_temp: float | None = None,
                    ignore_residual: bool = False,
                    quick_gelu_act: bool = False) -> torch.Tensor:
    """images [B, 3, H, W] in the weights' dtype -> the gem stream's patch
    tokens [B, P, output_dim] in that dtype (rs_ov/nn/gem.py:74-130)."""
    act = quick_gelu if quick_gelu_act else gelu
    b, _, h, w = images.shape
    gh, gw = h // vcfg.patch_size, w // vcfg.patch_size

    x = _patchify(images, p.conv1_w)
    x = torch.cat([p.class_embedding.to(x.dtype).expand(b, 1, -1), x], dim=1)
    pos = resample_pos_embed(p.positional_embedding, (gh, gw))
    x = layer_norm(x + pos.to(x.dtype)[None], p.ln_pre)

    n_plain = len(p.blocks) - (depth - 1)
    for blk in p.blocks[:n_plain]:
        x = x + standard_attention(blk.attn, layer_norm(x, blk.ln_1), vcfg.heads)[0]
        x = x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)

    x_gem = x
    for blk in p.blocks[n_plain:]:
        gem_res, ori_res = self_self_attention(
            blk.attn, layer_norm(x, blk.ln_1), vcfg.heads, ss_attn_iter=ss_attn_iter,
            ss_attn_temp=ss_attn_temp)
        x_ori = x + ori_res
        x = x_ori + mlp(layer_norm(x_ori, blk.ln_2), blk.mlp, act=act)
        x_gem = gem_res if ignore_residual else x_gem + gem_res

    x_gem = layer_norm(x_gem, p.ln_post)
    tokens = torch.matmul(x_gem.float(), p.proj.float()).to(x_gem.dtype)
    return tokens[:, 1:]
