"""The timm-named vision towers (rs_ov/nn/timm_tower.py): ConvNeXt, the
SigLIP MAP-head ViT and EVA / EVA02, with open_clip's (pool, proj) head.

- **ConvNeXt**: a 4x4 stride-4 stem conv and LayerNorm, four stages of
  depthwise-7x7 blocks (LN, fc1, erf GELU, fc2, ``gamma``, residual), a
  LayerNorm and 2x2 stride-2 conv between stages, the global average and
  ``head_norm``. Activations stay channels-last; each conv sees them as a
  channels-last NCHW view (``F.conv2d`` on OIHW weights, ``groups=C`` for
  the depthwise one) with fp32 sums, cast back to the activation dtype.
- **SigLIP ViT**: CLS-less, tanh GELU, LayerNorm eps 1e-6, and the MAP
  head: a learned latent query over the tokens, ``proj``, a residual MLP on
  ``norm(out)``, token 0 out.
- **EVA / EVA02**: fused or split q / k / v (``k`` has no bias), 2-D axial
  RoPE on the patch tokens (the CLS token is not rotated; y angles then x
  angles, each driving an interleaved (even, odd) lane pair; positions
  rescaled to ``ref_feat_hw``), SwiGLU, the MLP's and the attention's inner
  LayerNorms, post-norm blocks (EVA02-E), and the trunk's own head.

Head (open_clip's timm adapter): ``'linear'`` a projection without bias,
``'mlp'`` an erf-GELU MLP to 2 * embed and back, ``'none'`` nothing (SigLIP),
``None`` the EVA trunk's ``head_w`` / ``head_b`` in its place.

A pos-embed table at another grid than the input's is resampled with
``resize_bicubic_antialias`` (the JAX package's ``jax.image.resize``
bicubic: Keys a = -0.5 with antialias). Parameters are read by the JAX
tree's names from the modules of ``core.params`` (``TimmTower``), except
ConvNeXt's conv weights, which the modules hold as OIHW (``oihw_conv_leaves``
transposes a JAX tree's HWIO ones once, when it is loaded).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from rs_ov_torch.nn.attention import standard_attention
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, matmul32, mlp
from rs_ov_torch.utils.device_cache import device_cache
from rs_ov_torch.utils.resize import resize_bicubic_antialias

__all__ = ["ConvNeXtArch", "SigLipVitArch", "EvaArch", "TIMM_ARCHS", "timm_arch",
           "timm_tower_forward", "timm_head_width", "oihw_conv_leaves"]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (big_vision / HF 'gelu_pytorch_tanh')."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# arch tables (a copy of rs_ov/nn/timm_tower.py:66-139)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvNeXtArch:
    depths: tuple[int, ...]
    dims: tuple[int, ...]
    family: str = "convnext"


@dataclasses.dataclass(frozen=True)
class SigLipVitArch:
    patch: int
    width: int
    depth: int
    heads: int
    family: str = "siglip_vit"


@dataclasses.dataclass(frozen=True)
class EvaArch:
    patch: int
    width: int
    depth: int
    heads: int
    mlp_hidden: int
    swiglu: bool = False
    rope: bool = False
    scale_mlp: bool = False          # LayerNorm inside the (Swi)GLU MLP
    scale_attn_inner: bool = False   # LayerNorm on attn output pre-proj
    fused_qkv: bool = True
    post_norm: bool = False          # EVA02-E: norm AFTER each sublayer
    ref_feat_hw: tuple[int, int] | None = None  # rope ref_feat_shape
    family: str = "eva"


TIMM_ARCHS: dict[str, object] = {
    # ConvNeXt (timm convnext.py defaults)
    "convnext_tiny": ConvNeXtArch((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ConvNeXtArch((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ConvNeXtArch((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ConvNeXtArch((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ConvNeXtArch((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ConvNeXtArch((3, 4, 30, 3), (384, 768, 1536, 3072)),
    # SigLIP ViT (timm vision_transformer.py *_siglip registrations)
    "vit_base_patch16_siglip_224": SigLipVitArch(16, 768, 12, 12),
    "vit_base_patch16_siglip_256": SigLipVitArch(16, 768, 12, 12),
    "vit_base_patch16_siglip_384": SigLipVitArch(16, 768, 12, 12),
    "vit_base_patch16_siglip_512": SigLipVitArch(16, 768, 12, 12),
    "vit_large_patch16_siglip_256": SigLipVitArch(16, 1024, 24, 16),
    "vit_large_patch16_siglip_384": SigLipVitArch(16, 1024, 24, 16),
    # EVA / EVA02 (timm eva.py registrations for the CLIP variants)
    "eva_giant_patch14_224": EvaArch(14, 1408, 40, 16, 6144),
    "eva02_base_patch16_clip_224": EvaArch(
        16, 768, 12, 12, int(768 * 8 / 3), swiglu=True, rope=True,
        scale_mlp=True, scale_attn_inner=True, fused_qkv=False,
        ref_feat_hw=(16, 16)),
    "eva02_large_patch14_clip_224": EvaArch(
        14, 1024, 24, 16, int(1024 * 8 / 3), swiglu=True, rope=True,
        scale_mlp=True, scale_attn_inner=True, fused_qkv=False,
        ref_feat_hw=(16, 16)),
    "eva02_large_patch14_clip_336": EvaArch(
        14, 1024, 24, 16, int(1024 * 8 / 3), swiglu=True, rope=True,
        scale_mlp=True, scale_attn_inner=True, fused_qkv=False,
        ref_feat_hw=(16, 16)),
    "eva02_enormous_patch14_clip_224": EvaArch(
        14, 1792, 64, 16, 15360, post_norm=True),
}


def timm_arch(name: str):
    try:
        return TIMM_ARCHS[name]
    except KeyError:
        raise NotImplementedError(
            f"timm tower '{name}' has no implementation in the port "
            f"(known: {sorted(TIMM_ARCHS)})") from None


def timm_head_width(arch, embed_dim: int) -> int:
    """The width the trunk hands the head: ConvNeXt's last dim, the SigLIP
    width, the EVA trunk's own projection (``embed_dim``)."""
    if arch.family == "convnext":
        return arch.dims[-1]
    return arch.width if arch.family == "siglip_vit" else embed_dim


# ---------------------------------------------------------------------------
# ConvNeXt
# ---------------------------------------------------------------------------

_CONV_LEAVES = ("stem_conv_w", "conv_w", "conv_dw_w")


def oihw_conv_leaves(tree):
    """A ConvNeXt trunk tree (numpy leaves) with its HWIO conv weights (the
    JAX package's layout) as OIHW, the layout the port's modules hold."""
    if isinstance(tree, dict):
        return {k: (np.ascontiguousarray(np.asarray(v).transpose(3, 2, 0, 1))
                    if k in _CONV_LEAVES else oihw_conv_leaves(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [oihw_conv_leaves(v) for v in tree]
    return tree


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
               padding: int = 0, groups: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] channels-last, w OIHW: the conv with fp32 sums and
    the bias added in fp32, cast to x's dtype (rs_ov/nn/timm_tower.py:146-155)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), b.float(), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _convnext_block(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """dwconv 7x7 (zero pad 3) -> LN -> fc1 -> GELU -> fc2 -> gamma -> residual."""
    y = _conv_nhwc(x, p.conv_dw_w, p.conv_dw_b, padding=3, groups=x.shape[-1])
    y = layer_norm(y, p.norm, eps)
    y = linear(linear(y, p.fc1_w, p.fc1_b, act=gelu), p.fc2_w, p.fc2_b)
    return x + y * p.gamma.to(y.dtype)


def convnext_forward(p, images: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """images [B, 3, H, W] -> pooled features [B, dims[-1]]: stem, 4
    stages, global average, head norm (rs_ov/nn/timm_tower.py:170-188)."""
    x = _conv_nhwc(images.permute(0, 2, 3, 1), p.stem_conv_w, p.stem_conv_b, stride=4)
    x = layer_norm(x, p.stem_norm, eps)
    for stage in p.stages:
        if hasattr(stage, "downsample"):
            x = layer_norm(x, stage.downsample.norm, eps)
            x = _conv_nhwc(x, stage.downsample.conv_w, stage.downsample.conv_b, stride=2)
        for blk in stage.blocks:
            x = _convnext_block(x, blk, eps)
    pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
    return layer_norm(pooled, p.head_norm, eps)


# ---------------------------------------------------------------------------
# patch embedding and pos-embed resample (SigLIP, EVA)
# ---------------------------------------------------------------------------

def _patchify(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor, patch: int):
    """[B, 3, H, W] -> [B, gh * gw, width] tokens (a stride-``patch`` conv as
    a product with fp32 sums), and the grid (gh, gw)."""
    bsz, c, h, wd = images.shape
    gh, gw = h // patch, wd // patch
    x = images.reshape(bsz, c, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(bsz, gh * gw, c * patch * patch)
    return linear(x, w.reshape(w.shape[0], -1), b), (gh, gw)


def _interp_pos_embed(pos: torch.Tensor, n_tokens: int, grid_hw) -> torch.Tensor:
    """A [N0, C] square-grid pos-embed table resampled to ``grid_hw`` when
    N0 differs from ``n_tokens`` (rs_ov/nn/timm_tower.py:236-247)."""
    n0 = pos.shape[0]
    if n0 == n_tokens:
        return pos
    g0 = int(round(n0 ** 0.5))
    grid = pos.reshape(g0, g0, -1).permute(2, 0, 1).float()
    grid = resize_bicubic_antialias(grid, tuple(grid_hw))
    return grid.permute(1, 2, 0).reshape(n_tokens, -1).to(pos.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """[B, H, Lq, hd] heads -> the merged context [B, Lq, H * hd] in ``dtype``:
    fp32 scores and softmax, weights in v's dtype, fp32 sums."""
    hd = q.shape[-1]
    attn = torch.softmax(matmul32(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
    out = matmul32(attn.to(v.dtype), v).to(dtype)
    b, h, lq, _ = out.shape
    return out.transpose(1, 2).reshape(b, lq, h * hd)


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, w = t.shape
    return t.reshape(b, n, heads, w // heads).transpose(1, 2)


# ---------------------------------------------------------------------------
# SigLIP ViT (CLS-less, MAP head)
# ---------------------------------------------------------------------------

def _map_pool(p, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
    """timm AttentionPoolLatent: the latent probe attends over the tokens,
    then a residual MLP; token 0 out (rs_ov/nn/timm_tower.py:256-277)."""
    b = x.shape[0]
    q = linear(p.latent.expand(b, *p.latent.shape).to(x.dtype), p.q_w, p.q_b)
    k, v = linear(x, p.kv_w, p.kv_b).chunk(2, dim=-1)
    out = _attend(_split(q, heads), _split(k, heads), _split(v, heads), x.dtype)
    out = linear(out, p.proj_w, p.proj_b)
    out = out + mlp(layer_norm(out, p.norm, eps), p.mlp, act=gelu_tanh)
    return out[:, 0]


def siglip_vit_forward(p, images: torch.Tensor, arch: SigLipVitArch,
                       eps: float = 1e-6) -> torch.Tensor:
    """images [B, 3, H, W] -> MAP-pooled features [B, width]."""
    x, grid = _patchify(images, p.patch_embed_w, p.patch_embed_b, arch.patch)
    x = x + _interp_pos_embed(p.pos_embed, x.shape[1], grid).to(x.dtype)
    for blk in p.blocks:
        y, _ = standard_attention(blk.attn, layer_norm(x, blk.ln_1, eps), arch.heads)
        x = x + y
        x = x + mlp(layer_norm(x, blk.ln_2, eps), blk.mlp, act=gelu_tanh)
    x = layer_norm(x, p.norm, eps)
    return _map_pool(p.attn_pool, x, arch.heads, eps)


# ---------------------------------------------------------------------------
# EVA / EVA02
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_tables(head_dim: int, grid_h: int, grid_w: int,
                 ref_hw: tuple[int, int] | None) -> tuple[np.ndarray, np.ndarray]:
    """2-D axial rotary tables [N, head_dim] (sin, cos), theta 10000
    (rs_ov/nn/timm_tower.py:347-370): head_dim // 4 frequency bands per
    axis, the y angles then the x angles, each angle repeated over one
    (even, odd) lane pair; positions rescaled to ``ref_hw`` where set."""
    nb = head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(nb, dtype=np.float64) / nb))
    ty = np.arange(grid_h, dtype=np.float64)
    tx = np.arange(grid_w, dtype=np.float64)
    if ref_hw is not None:
        ty = ty / max(grid_h, 1) * ref_hw[0]
        tx = tx / max(grid_w, 1) * ref_hw[1]
    ay, ax = np.outer(ty, inv), np.outer(tx, inv)
    ang = np.concatenate([np.broadcast_to(ay[:, None, :], (grid_h, grid_w, nb)),
                          np.broadcast_to(ax[None, :, :], (grid_h, grid_w, nb))],
                         axis=-1).reshape(grid_h * grid_w, 2 * nb)
    ang = np.repeat(ang, 2, axis=-1)
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


@device_cache
def _rope_on(head_dim: int, grid_hw: tuple[int, int], ref_hw, device: torch.device):
    """``_rope_tables`` as fp32 tensors on ``device``, copied once per grid."""
    sin, cos = _rope_tables(head_dim, grid_hw[0], grid_hw[1], ref_hw)
    return torch.from_numpy(sin).to(device), torch.from_numpy(cos).to(device)


def _apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [B, H, N, hd]: rotate each (even, odd) lane pair."""
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def _eva_attention(p, x: torch.Tensor, arch: EvaArch, grid_hw, eps: float) -> torch.Tensor:
    if arch.fused_qkv:
        q, k, v = linear(x, p.in_proj_w, p.in_proj_b).chunk(3, dim=-1)
    else:
        q, k, v = linear(x, p.q_w, p.q_b), linear(x, p.k_w), linear(x, p.v_w, p.v_b)
    q, k, v = (_split(t, arch.heads) for t in (q, k, v))
    if arch.rope:
        sin, cos = _rope_on(q.shape[-1], tuple(grid_hw), arch.ref_feat_hw, x.device)
        q = torch.cat([q[:, :, :1], _apply_rope(q[:, :, 1:], sin, cos)], dim=2)
        k = torch.cat([k[:, :, :1], _apply_rope(k[:, :, 1:], sin, cos)], dim=2)
    out = _attend(q, k, v, x.dtype)
    if arch.scale_attn_inner:
        out = layer_norm(out, p.inner_norm, eps)
    return linear(out, p.out_proj_w, p.out_proj_b)


def _eva_mlp(p, x: torch.Tensor, arch: EvaArch, eps: float) -> torch.Tensor:
    if arch.swiglu:
        h = F.silu(linear(x, p.fc1g_w, p.fc1g_b)) * linear(x, p.fc1x_w, p.fc1x_b)
    else:
        h = linear(x, p.fc1_w, p.fc1_b, act=gelu)
    if arch.scale_mlp:
        h = layer_norm(h, p.mlp_norm, eps)
    return linear(h, p.fc2_w, p.fc2_b)


def eva_forward(p, images: torch.Tensor, arch: EvaArch, eps: float = 1e-6) -> torch.Tensor:
    """images [B, 3, H, W] -> the CLS token through the trunk's own head
    [B, embed_dim] (rs_ov/nn/timm_tower.py:427-458)."""
    x, grid = _patchify(images, p.patch_embed_w, p.patch_embed_b, arch.patch)
    cls = p.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1)
    pos = torch.cat([p.pos_embed[:1], _interp_pos_embed(p.pos_embed[1:], x.shape[1] - 1,
                                                        grid)], dim=0)
    x = x + pos.to(x.dtype)
    for blk in p.blocks:
        if arch.post_norm:
            x = x + layer_norm(_eva_attention(blk, x, arch, grid, eps), blk.ln_1, eps)
            x = x + layer_norm(_eva_mlp(blk.mlp, x, arch, eps), blk.ln_2, eps)
        else:
            x = x + _eva_attention(blk, layer_norm(x, blk.ln_1, eps), arch, grid, eps)
            x = x + _eva_mlp(blk.mlp, layer_norm(x, blk.ln_2, eps), arch, eps)
    x = layer_norm(x, p.norm, eps)
    return linear(x[:, 0], p.head_w, p.head_b)


# ---------------------------------------------------------------------------
# head and entry (rs_ov/nn/timm_tower.py:517-568)
# ---------------------------------------------------------------------------

def _apply_head(feats: torch.Tensor, head) -> torch.Tensor:
    if head is None:
        return feats
    if hasattr(head, "mlp"):  # proj 'mlp': Mlp(prev, 2 * embed, embed)
        return mlp(feats, head.mlp, act=gelu)
    return linear(feats, head.proj_w, getattr(head, "proj_b", None))


def timm_tower_forward(p, images: torch.Tensor, vcfg) -> torch.Tensor:
    """[B, 3, H, W] -> [B, embed_dim]: the trunk, then the (pool, proj) head.
    ``p`` is a ``core.params.TimmTower``."""
    arch = timm_arch(vcfg.timm_model_name)
    if arch.family == "convnext":
        feats = convnext_forward(p.trunk, images)
    elif arch.family == "siglip_vit":
        feats = siglip_vit_forward(p.trunk, images, arch)
    else:
        feats = eva_forward(p.trunk, images, arch)
    return _apply_head(feats, getattr(p, "head", None))
