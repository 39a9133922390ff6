"""CLIP, CoCa and JBU parameters as ``nn.Module``s, random init, weight bridge.

The modules hold exactly the leaves of the JAX package's parameter pytrees
(rs_ov/core/params.py, rs_ov/upsample/jbu.py:483-530), under the same names
and shapes: a pytree path such as ``visual/blocks/3/attn/in_proj_w`` is the
state-dict key ``visual.blocks.3.attn.in_proj_w``. So the bridge from a JAX
pytree is a flatten plus a strict ``load_state_dict``, and the forward code
reads parameters by the same names as the JAX forward code.

Linear weights keep torch's (out, in) orientation, as in the JAX package.
The leaves are built frozen, for inference; training switches them on with
``module.requires_grad_()``. Random init draws from an explicit CPU
``torch.Generator`` with the JAX package's shapes and scales
(rs_ov/core/params.py:53-134); the numbers differ from ``jax.random``'s, so
tests carry weights across with the bridge.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.config import CLIPConfig, CoCaConfig, TextConfig, VisionConfig
from rs_ov_torch.nn.timm_tower import oihw_conv_leaves, timm_arch, timm_head_width

__all__ = ["LayerNorm", "ResBlock", "VisionTower", "TextTower", "TimmTower", "CLIP",
           "AttentionalPooler", "CoCaVisionTower", "CoCaTextTower", "MultimodalDecoder",
           "CoCa", "Proj2", "JBUModule", "JBUOne", "JBUStack", "init_clip_params",
           "init_timm_tower_params", "init_coca_params",
           "init_jbu_one_params", "init_jbu_stack_params",
           "clip_params_from_numpy", "blip_params_from_numpy",
           "blip_decoder_params_from_numpy", "blip_vqa_params_from_numpy",
           "blip_nlvr_params_from_numpy", "coca_params_from_numpy", "jbu_params_from_numpy",
           "load_numpy_tree", "module_from_tree", "LeafView", "leaf_view",
           "cast_floating", "momentum_copy", "blip_retrieval_state_from_numpy",
           "blip_pretrain_state_from_numpy"]


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.scale = _p(width)
        self.bias = _p(width)


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj_w = _p(3 * width, width)
        self.in_proj_b = _p(3 * width)
        self.out_proj_w = _p(width, width)
        self.out_proj_b = _p(width)


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_width: int, out_width: int | None = None):
        super().__init__()
        out_width = width if out_width is None else out_width
        self.c_fc_w = _p(mlp_width, width)
        self.c_fc_b = _p(mlp_width)
        self.c_proj_w = _p(out_width, mlp_width)
        self.c_proj_b = _p(out_width)


class ResBlock(nn.Module):
    """Residual attention block; with ``layer_scale`` the per-branch
    LayerScale gammas ``ls_1`` / ``ls_2`` (open_clip's ``ls_init_value``)."""

    def __init__(self, width: int, mlp_ratio: float, layer_scale: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width)
        self.ln_2 = LayerNorm(width)
        self.mlp = Mlp(width, int(width * mlp_ratio))
        if layer_scale:
            self.ls_1 = _p(width)
            self.ls_2 = _p(width)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        gh, gw = cfg.grid_size
        self.conv1_w = _p(cfg.width, 3, cfg.patch_size, cfg.patch_size)
        self.class_embedding = _p(cfg.width)
        self.positional_embedding = _p(gh * gw + 1, cfg.width)
        # kept when ``no_ln_pre`` (CLIPA) as in the JAX pytree; the forward
        # skips it then
        self.ln_pre = LayerNorm(cfg.width)
        self.blocks = nn.ModuleList(ResBlock(cfg.width, cfg.mlp_ratio,
                                             layer_scale=cfg.ls_init_value is not None)
                                    for _ in range(cfg.layers))
        self.ln_post = LayerNorm(cfg.width)
        self.proj = _p(cfg.width, cfg.output_dim)


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = _p(cfg.vocab_size, cfg.width)
        self.positional_embedding = _p(cfg.context_length, cfg.width)
        self.blocks = nn.ModuleList(ResBlock(cfg.width, cfg.mlp_ratio)
                                    for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = _p(cfg.width, cfg.output_dim)
        if cfg.proj_bias:
            self.text_projection_b = _p(cfg.output_dim)


# ---------------------------------------------------------------------------
# the timm towers (rs_ov/nn/timm_tower.py's trees: ``trunk`` and ``head``)
# ---------------------------------------------------------------------------

class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw_w = _p(dim, 1, 7, 7)  # OIHW; the JAX tree holds HWIO
        self.conv_dw_b = _p(dim)
        self.norm = LayerNorm(dim)
        self.fc1_w = _p(4 * dim, dim)
        self.fc1_b = _p(4 * dim)
        self.fc2_w = _p(dim, 4 * dim)
        self.fc2_b = _p(dim)
        self.gamma = _p(dim)


class ConvNeXtDownsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = LayerNorm(cin)
        self.conv_w = _p(cout, cin, 2, 2)
        self.conv_b = _p(cout)


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: int | None, dim: int, depth: int):
        super().__init__()
        if cin is not None:
            self.downsample = ConvNeXtDownsample(cin, dim)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth))


class ConvNeXtTrunk(nn.Module):
    def __init__(self, arch):
        super().__init__()
        dims = arch.dims
        self.stem_conv_w = _p(dims[0], 3, 4, 4)
        self.stem_conv_b = _p(dims[0])
        self.stem_norm = LayerNorm(dims[0])
        self.head_norm = LayerNorm(dims[-1])
        self.stages = nn.ModuleList(
            ConvNeXtStage(dims[i - 1] if i else None, dim, depth)
            for i, (depth, dim) in enumerate(zip(arch.depths, dims)))


class MapHead(nn.Module):
    """timm's AttentionPoolLatent: latent probe, q / kv / proj, LN, MLP."""

    def __init__(self, width: int):
        super().__init__()
        self.latent = _p(1, width)
        self.q_w = _p(width, width)
        self.q_b = _p(width)
        self.kv_w = _p(2 * width, width)
        self.kv_b = _p(2 * width)
        self.proj_w = _p(width, width)
        self.proj_b = _p(width)
        self.norm = LayerNorm(width)
        self.mlp = Mlp(width, 4 * width)


class SigLipTrunk(nn.Module):
    def __init__(self, arch, image_size: int):
        super().__init__()
        w = arch.width
        self.patch_embed_w = _p(w, 3, arch.patch, arch.patch)
        self.patch_embed_b = _p(w)
        self.pos_embed = _p((image_size // arch.patch) ** 2, w)
        self.blocks = nn.ModuleList(ResBlock(w, 4.0) for _ in range(arch.depth))
        self.norm = LayerNorm(w)
        self.attn_pool = MapHead(w)


class EvaMlp(nn.Module):
    def __init__(self, arch):
        super().__init__()
        w, hidden = arch.width, arch.mlp_hidden
        for name in ("fc1g", "fc1x") if arch.swiglu else ("fc1",):
            setattr(self, f"{name}_w", _p(hidden, w))
            setattr(self, f"{name}_b", _p(hidden))
        if arch.scale_mlp:
            self.mlp_norm = LayerNorm(hidden)
        self.fc2_w = _p(w, hidden)
        self.fc2_b = _p(w)


class EvaBlock(nn.Module):
    """Fused ``in_proj`` or split q / k / v (k without bias), the inner
    LayerNorm where ``scale_attn_inner``."""

    def __init__(self, arch):
        super().__init__()
        w = arch.width
        self.ln_1 = LayerNorm(w)
        self.ln_2 = LayerNorm(w)
        if arch.fused_qkv:
            self.in_proj_w = _p(3 * w, w)
            self.in_proj_b = _p(3 * w)
        else:
            self.q_w, self.q_b = _p(w, w), _p(w)
            self.k_w = _p(w, w)
            self.v_w, self.v_b = _p(w, w), _p(w)
        if arch.scale_attn_inner:
            self.inner_norm = LayerNorm(w)
        self.out_proj_w = _p(w, w)
        self.out_proj_b = _p(w)
        self.mlp = EvaMlp(arch)


class EvaTrunk(nn.Module):
    def __init__(self, arch, image_size: int, embed_dim: int):
        super().__init__()
        w = arch.width
        self.patch_embed_w = _p(w, 3, arch.patch, arch.patch)
        self.patch_embed_b = _p(w)
        self.cls_token = _p(w)
        self.pos_embed = _p((image_size // arch.patch) ** 2 + 1, w)
        self.blocks = nn.ModuleList(EvaBlock(arch) for _ in range(arch.depth))
        self.norm = LayerNorm(w)
        self.head_w = _p(embed_dim, w)
        self.head_b = _p(embed_dim)


class TimmHead(nn.Module):
    """open_clip's timm adapter head: 'linear' a projection (its bias only
    where a checkpoint has one), 'mlp' Mlp(prev, 2 * embed, embed)."""

    def __init__(self, proj: str, prev: int, embed_dim: int, proj_bias: bool = False):
        super().__init__()
        if proj == "mlp":
            self.mlp = Mlp(prev, 2 * embed_dim, embed_dim)
        else:
            self.proj_w = _p(embed_dim, prev)
            if proj_bias:
                self.proj_b = _p(embed_dim)


class TimmTower(nn.Module):
    """A timm-named vision tower: ``trunk`` by family, ``head`` where the
    config's ``timm_proj`` is 'linear' or 'mlp'."""

    def __init__(self, cfg: VisionConfig, embed_dim: int, proj_bias: bool = False):
        super().__init__()
        arch = timm_arch(cfg.timm_model_name)
        if arch.family == "convnext":
            self.trunk = ConvNeXtTrunk(arch)
        elif arch.family == "siglip_vit":
            self.trunk = SigLipTrunk(arch, cfg.image_size)
        else:
            self.trunk = EvaTrunk(arch, cfg.image_size, embed_dim)
        if cfg.timm_proj in ("linear", "mlp"):
            self.head = TimmHead(cfg.timm_proj, timm_head_width(arch, embed_dim), embed_dim,
                                 proj_bias)


class CLIP(nn.Module):
    """The CLIP tree: ``visual`` (a ViT tower or a ``TimmTower``), ``text``,
    ``logit_scale`` and, where the config sets ``init_logit_bias`` (or
    ``logit_bias`` says so for a checkpoint), ``logit_bias``. CoCa's fields
    (``attentional_pool``, ``embed_cls``, ``hf_model_name``) do not change
    the CLIP tree, as in the JAX package: only ``CoCa`` builds them."""

    def __init__(self, cfg: CLIPConfig, logit_bias: bool | None = None,
                 timm_proj_bias: bool = False):
        super().__init__()
        v, t = cfg.vision, cfg.text
        self.visual = (TimmTower(v, cfg.embed_dim, timm_proj_bias) if v.timm_model_name
                       else VisionTower(v))
        self.text = TextTower(t)
        self.logit_scale = _p()
        if cfg.init_logit_bias is not None if logit_bias is None else logit_bias:
            self.logit_bias = _p()


# ---------------------------------------------------------------------------
# CoCa (rs_ov/nn/coca.py:591-688's tree)
# ---------------------------------------------------------------------------

class AttentionalPooler(nn.Module):
    """Learned queries over the tokens: separate q / k / v projections (k
    and v ``ctx_dim`` wide) and one fused 3 x d bias, as torch's
    MultiheadAttention with kdim = vdim = ctx_dim holds them."""

    def __init__(self, d_model: int, ctx_dim: int, n_queries: int):
        super().__init__()
        self.query = _p(n_queries, d_model)
        self.ln_q = LayerNorm(d_model)
        self.ln_k = LayerNorm(ctx_dim)
        self.q_proj_w = _p(d_model, d_model)
        self.k_proj_w = _p(d_model, ctx_dim)
        self.v_proj_w = _p(d_model, ctx_dim)
        self.in_proj_b = _p(3 * d_model)
        self.out_proj_w = _p(d_model, d_model)
        self.out_proj_b = _p(d_model)


class CoCaVisionTower(nn.Module):
    """The ViT trunk, the attentional pooler into ``embed_dim``, ``ln_post``
    and the square ``proj`` of the pooled and token outputs."""

    def __init__(self, cfg: CoCaConfig):
        super().__init__()
        v, d = cfg.vision, cfg.embed_dim
        gh, gw = v.grid_size
        self.conv1_w = _p(v.width, 3, v.patch_size, v.patch_size)
        self.class_embedding = _p(v.width)
        self.positional_embedding = _p(gh * gw + 1, v.width)
        self.ln_pre = LayerNorm(v.width)
        self.blocks = nn.ModuleList(ResBlock(v.width, v.mlp_ratio) for _ in range(v.layers))
        self.attn_pool = AttentionalPooler(d, v.width, cfg.attn_pooler_queries)
        self.ln_post = LayerNorm(d)
        self.proj = _p(d, d)


class CoCaTextTower(nn.Module):
    """The text tower with its learned CLS (``cls_emb``, appended at the end
    of the sequence, hence ``context_length + 1`` positions)."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = _p(cfg.vocab_size, cfg.width)
        self.positional_embedding = _p(cfg.context_length + 1, cfg.width)
        self.cls_emb = _p(cfg.width)
        self.blocks = nn.ModuleList(ResBlock(cfg.width, cfg.mlp_ratio)
                                    for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = _p(cfg.width, cfg.output_dim)


class CrossBlock(ResBlock):
    """A cross-attention block: ``ln_1_kv`` normalises the image tokens."""

    def __init__(self, width: int, mlp_ratio: float):
        super().__init__(width, mlp_ratio)
        self.ln_1_kv = LayerNorm(width)


class MultimodalDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.blocks = nn.ModuleList(ResBlock(cfg.width, cfg.mlp_ratio)
                                    for _ in range(cfg.layers))
        self.cross_blocks = nn.ModuleList(CrossBlock(cfg.width, cfg.mlp_ratio)
                                          for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = _p(cfg.width, cfg.vocab_size)


class CoCa(nn.Module):
    """The CoCa tree: ``visual``, ``text`` (a ``CoCaTextTower``, or for a
    config with ``hf_model_name`` an ``nn.hf_text.HFTextTower``, or the HF
    module given as ``text``), ``multimodal`` and ``logit_scale``."""

    def __init__(self, cfg: CoCaConfig, text: nn.Module | None = None):
        super().__init__()
        self.visual = CoCaVisionTower(cfg)
        if text is None and cfg.text.hf_model_name:
            from rs_ov_torch.nn.hf_text import HFTextTower, hf_text_config

            text = HFTextTower(hf_text_config(cfg.text.hf_model_name, output_dim=cfg.embed_dim,
                                              proj_type=cfg.text.hf_proj_type))
        self.text = text if text is not None else CoCaTextTower(cfg.text)
        self.multimodal = MultimodalDecoder(cfg.multimodal)
        self.logit_scale = _p()


class Proj2(nn.Module):
    """conv1x1 -> GELU -> conv1x1 weights (rs_ov/upsample/jbu.py:483-492)."""

    def __init__(self, cin: int, cmid: int, cout: int):
        super().__init__()
        self.w0 = _p(cmid, cin, 1, 1)
        self.b0 = _p(cmid)
        self.w1 = _p(cout, cmid, 1, 1)
        self.b1 = _p(cout)


class JBUModule(nn.Module):
    """One learned-range JBU step (rs_ov/upsample/jbu.py:495-503)."""

    def __init__(self, guidance_dim: int, key_dim: int, radius: int):
        super().__init__()
        d2 = (radius * 2 + 1) ** 2
        self.radius = radius
        self.range_temp = _p()
        self.sigma_spatial = _p()
        self.range_proj = Proj2(guidance_dim, key_dim, key_dim)
        self.fixup_proj = Proj2(guidance_dim + d2, d2, d2)


class FinalFixup(nn.Module):
    def __init__(self, feat_dim: int):
        super().__init__()
        self.w = _p(feat_dim, feat_dim, 1, 1)
        self.b = _p(feat_dim)


class JBUOne(nn.Module):
    """SimFeatUp ``jbu_one``: one shared 2x module applied per stage, then the
    final fixup (rs_ov/upsample/jbu.py:506-516)."""

    def __init__(self, feat_dim: int, guidance_dim: int = 3, key_dim: int = 32,
                 radius: int = 5):
        super().__init__()
        self.up = JBUModule(guidance_dim, key_dim, radius)
        self.final_fixup = FinalFixup(feat_dim)


class JBUStack(nn.Module):
    """SimFeatUp ``jbu_stack``: four distinct 2x modules, then the final
    fixup (rs_ov/upsample/jbu.py:519-530)."""

    def __init__(self, feat_dim: int, guidance_dim: int = 3, key_dim: int = 32,
                 radius: int = 3):
        super().__init__()
        self.ups = nn.ModuleList(JBUModule(guidance_dim, key_dim, radius) for _ in range(4))
        self.final_fixup = FinalFixup(feat_dim)


# ---------------------------------------------------------------------------
# random init (shapes and scales of rs_ov/core/params.py:53-134 and
# rs_ov/upsample/jbu.py:483-516)
# ---------------------------------------------------------------------------

def _normal(p: nn.Parameter, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=gen) * std)


def _init_ln(ln: LayerNorm) -> None:
    ln.scale.fill_(1.0)
    ln.bias.zero_()


def _init_block(blk: ResBlock, width: int, gen: torch.Generator,
                ls_init_value: float | None = None) -> None:
    attn_std = width ** -0.5
    proj_std = attn_std * 0.5
    fc_std = (2 * width) ** -0.5
    _init_ln(blk.ln_1)
    _init_ln(blk.ln_2)
    _normal(blk.attn.in_proj_w, attn_std, gen)
    blk.attn.in_proj_b.zero_()
    _normal(blk.attn.out_proj_w, proj_std, gen)
    blk.attn.out_proj_b.zero_()
    _normal(blk.mlp.c_fc_w, fc_std, gen)
    blk.mlp.c_fc_b.zero_()
    _normal(blk.mlp.c_proj_w, proj_std, gen)
    blk.mlp.c_proj_b.zero_()
    if hasattr(blk, "ls_1"):
        blk.ls_1.fill_(ls_init_value)
        blk.ls_2.fill_(ls_init_value)


@torch.no_grad()
def init_timm_tower_params(gen: torch.Generator, cfg: VisionConfig,
                           embed_dim: int) -> TimmTower:
    """Random fp32 timm-tower weights on the CPU, drawn from ``gen`` with the
    JAX init's distributions (rs_ov/nn/timm_tower.py:191-229, :301-340,
    :461-510, :525-555): weights, pos-embeds and the MAP latent N(0, 0.02),
    biases and ``cls_token`` zero, LayerNorms identity, ConvNeXt's ``gamma``
    1e-6."""
    m = TimmTower(cfg, embed_dim)
    _init_timm_tower(m, gen)
    return m


def _init_timm_tower(m: TimmTower, gen: torch.Generator) -> None:
    for mod in m.modules():
        if isinstance(mod, LayerNorm):
            _init_ln(mod)
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name == "gamma":
                p.fill_(1e-6)
            elif name == "cls_token" or name.endswith("_b"):
                p.zero_()
            else:
                _normal(p, 0.02, gen)


def _init_text(t: TextTower, cfg: TextConfig, gen: torch.Generator) -> None:
    _normal(t.token_embedding, 0.02, gen)
    _normal(t.positional_embedding, 0.01, gen)
    for blk in t.blocks:
        _init_block(blk, cfg.width, gen)
    _init_ln(t.ln_final)
    _normal(t.text_projection, cfg.width ** -0.5, gen)
    if cfg.proj_bias:
        t.text_projection_b.zero_()


@torch.no_grad()
def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> CLIP:
    """Random fp32 CLIP weights on the CPU, drawn from ``gen``; a timm tower
    from ``init_timm_tower_params``, ``logit_bias`` at the config's
    ``init_logit_bias`` (rs_ov/factory.py:220-237)."""
    m = CLIP(cfg)
    if cfg.vision.timm_model_name:
        _init_timm_tower(m.visual, gen)
    else:
        v = m.visual
        scale = cfg.vision.width ** -0.5
        _normal(v.conv1_w, scale, gen)
        _normal(v.class_embedding, scale, gen)
        _normal(v.positional_embedding, scale, gen)
        _init_ln(v.ln_pre)
        for blk in v.blocks:
            _init_block(blk, cfg.vision.width, gen, cfg.vision.ls_init_value)
        _init_ln(v.ln_post)
        _normal(v.proj, scale, gen)
    _init_text(m.text, cfg.text, gen)
    m.logit_scale.fill_(float(np.log(1 / 0.07)))
    if cfg.init_logit_bias is not None:
        m.logit_bias.fill_(cfg.init_logit_bias)
    return m


def _init_coca_block(blk: ResBlock, width: int, gen: torch.Generator) -> None:
    """rs_ov/nn/coca.py:595-613: width^-0.5 for in / out projections and
    c_fc, (2 width)^-0.5 for c_proj (not CLIP's halved out-projection)."""
    s = width ** -0.5
    for ln in (blk.ln_1, blk.ln_2) + ((blk.ln_1_kv,) if hasattr(blk, "ln_1_kv") else ()):
        _init_ln(ln)
    _normal(blk.attn.in_proj_w, s, gen)
    blk.attn.in_proj_b.zero_()
    _normal(blk.attn.out_proj_w, s, gen)
    blk.attn.out_proj_b.zero_()
    _normal(blk.mlp.c_fc_w, s, gen)
    blk.mlp.c_fc_b.zero_()
    _normal(blk.mlp.c_proj_w, (2 * width) ** -0.5, gen)
    blk.mlp.c_proj_b.zero_()


@torch.no_grad()
def init_coca_params(gen: torch.Generator, cfg: CoCaConfig) -> CoCa:
    """Random fp32 CoCa weights on the CPU, drawn from ``gen`` with the JAX
    init's shapes and scales (rs_ov/nn/coca.py:631-688); an HF text tower
    from ``nn.hf_text.init_hf_text_params``."""
    from rs_ov_torch.nn.hf_text import hf_text_config, init_hf_text_params

    v, t, mm, d = cfg.vision, cfg.text, cfg.multimodal, cfg.embed_dim
    text = None
    if t.hf_model_name:
        text = init_hf_text_params(gen, hf_text_config(t.hf_model_name, output_dim=d,
                                                       proj_type=t.hf_proj_type))
    m = CoCa(cfg, text)
    vis = m.visual
    _normal(vis.conv1_w, (3 * v.patch_size ** 2) ** -0.5, gen)
    _normal(vis.class_embedding, v.width ** -0.5, gen)
    _normal(vis.positional_embedding, v.width ** -0.5, gen)
    _init_ln(vis.ln_pre)
    for blk in vis.blocks:
        _init_coca_block(blk, v.width, gen)
    pool = vis.attn_pool
    _normal(pool.query, 1.0, gen)
    _init_ln(pool.ln_q)
    _init_ln(pool.ln_k)
    for w in (pool.q_proj_w, pool.k_proj_w, pool.v_proj_w, pool.out_proj_w):
        _normal(w, d ** -0.5, gen)
    pool.in_proj_b.zero_()
    pool.out_proj_b.zero_()
    _init_ln(vis.ln_post)
    _normal(vis.proj, d ** -0.5, gen)
    if not t.hf_model_name:
        tt = m.text
        _normal(tt.token_embedding, 0.02, gen)
        _normal(tt.positional_embedding, 0.01, gen)
        _normal(tt.cls_emb, 0.01, gen)
        for blk in tt.blocks:
            _init_coca_block(blk, t.width, gen)
        _init_ln(tt.ln_final)
        _normal(tt.text_projection, t.width ** -0.5, gen)
    dec = m.multimodal
    for blk in list(dec.blocks) + list(dec.cross_blocks):
        _init_coca_block(blk, mm.width, gen)
    _init_ln(dec.ln_final)
    _normal(dec.text_projection, mm.width ** -0.5, gen)
    m.logit_scale.fill_(float(np.log(1 / 0.07)))
    return m


def _init_proj2(p: Proj2, gen: torch.Generator) -> None:
    _normal(p.w0, p.w0.shape[1] ** -0.5, gen)
    p.b0.zero_()
    _normal(p.w1, p.w1.shape[1] ** -0.5, gen)
    p.b1.zero_()


def _init_jbu_module(m: JBUModule, gen: torch.Generator) -> None:
    m.range_temp.zero_()
    m.sigma_spatial.fill_(1.0)
    _init_proj2(m.range_proj, gen)
    _init_proj2(m.fixup_proj, gen)


def _init_final_fixup(m: FinalFixup, gen: torch.Generator) -> None:
    _normal(m.w, m.w.shape[0] ** -0.5, gen)
    m.b.zero_()


@torch.no_grad()
def init_jbu_one_params(gen: torch.Generator, feat_dim: int,
                        guidance_dim: int = 3, key_dim: int = 32,
                        radius: int = 5) -> JBUOne:
    """Random fp32 ``jbu_one`` weights on the CPU (range_temp 0, sigma 1,
    zero biases, as rs_ov/upsample/jbu.py:495-516)."""
    m = JBUOne(feat_dim, guidance_dim, key_dim, radius)
    _init_jbu_module(m.up, gen)
    _init_final_fixup(m.final_fixup, gen)
    return m


@torch.no_grad()
def init_jbu_stack_params(gen: torch.Generator, feat_dim: int,
                          guidance_dim: int = 3, key_dim: int = 32,
                          radius: int = 3) -> JBUStack:
    """Random fp32 ``jbu_stack`` weights on the CPU (rs_ov/upsample/jbu.py:519-530)."""
    m = JBUStack(feat_dim, guidance_dim, key_dim, radius)
    for up in m.ups:
        _init_jbu_module(up, gen)
    _init_final_fixup(m.final_fixup, gen)
    return m


# ---------------------------------------------------------------------------
# weight bridge: JAX pytree (numpy leaves) -> module
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


@torch.no_grad()
def load_numpy_tree(module: nn.Module, tree) -> nn.Module:
    """Copy a pytree of numpy arrays into ``module`` by path. Raises on a
    missing or unused key and on a shape mismatch."""
    flat = {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in _flatten(tree).items()}
    want = dict(module.named_parameters())
    missing = sorted(set(want) - set(flat))
    unused = sorted(set(flat) - set(want))
    if missing or unused:
        raise KeyError(f"weight bridge: missing {missing}, unused {unused}")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"weight bridge: {k} has shape {tuple(v.shape)}, "
                             f"module wants {tuple(want[k].shape)}")
        want[k].copy_(v)
    return module


@torch.no_grad()
def module_from_tree(tree) -> nn.Module:
    """A module holding a pytree's numpy leaves as CPU fp32 parameters under
    the tree's paths: dicts become modules, lists ``ModuleList``s, None
    entries are left out."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList(module_from_tree(v) for v in tree)
    m = nn.Module()
    for k, v in tree.items():
        if v is None:
            continue
        if isinstance(v, (dict, list, tuple)):
            m.add_module(k, module_from_tree(v))
        else:
            m.register_parameter(k, nn.Parameter(torch.from_numpy(np.array(v, np.float32)),
                                                 requires_grad=False))
    return m


class LeafView:
    """An attribute tree of tensors with a module's names: what the
    functional forwards read (``p.visual.blocks[3].attn.in_proj_w``)."""

    def __repr__(self) -> str:
        return f"LeafView({', '.join(vars(self))})"


def leaf_view(tree, fn=None):
    """``tree`` (a module, ``ModuleList``, list or ``LeafView``) as a new
    ``LeafView`` whose every leaf is ``fn(leaf)`` (the leaf itself without
    ``fn``); lists stay lists. Differentiable: gradients of the view's
    leaves flow back into the tree's."""
    if isinstance(tree, (nn.ModuleList, list, tuple)):
        return [leaf_view(m, fn) for m in tree]
    if isinstance(tree, torch.Tensor):
        return tree if fn is None else fn(tree)
    items = (vars(tree).items() if isinstance(tree, LeafView) else
             [*tree._parameters.items(), *tree._buffers.items(), *tree._modules.items()])
    view = LeafView()
    for name, v in items:
        if v is not None:
            setattr(view, name, leaf_view(v, fn))
    return view


def cast_floating(tree, dtype: torch.dtype):
    """rs_ov/core/params.py:137: a compute copy of ``tree`` with every
    floating leaf cast to ``dtype``, as a ``LeafView``. The cast is a graph
    op, so the copy's gradients come back into the fp32 masters in their
    dtype, as through JAX's ``astype``."""
    return leaf_view(tree, lambda p: p.to(dtype) if p.is_floating_point() else p)


def clip_params_from_numpy(tree, cfg: CLIPConfig) -> CLIP:
    """The JAX ``init_clip_params`` pytree (numpy leaves) as a CPU fp32 CLIP:
    LayerScale gammas and the text projection bias where the config has
    them; for a ``no_ln_pre`` tower (CLIPA) a tree without ``ln_pre`` gets
    the identity LayerNorm, which the forward skips. A timm tower's tree
    (``visual`` = {trunk, head}) loads with its ConvNeXt conv weights turned
    from HWIO to OIHW, a head bias and ``logit_bias`` where the tree has them."""
    visual = tree["visual"]
    if cfg.vision.timm_model_name:
        visual = {**visual, "trunk": oihw_conv_leaves(visual["trunk"])}
    elif "ln_pre" not in visual and cfg.vision.no_ln_pre:
        width = cfg.vision.width
        visual = {**visual, "ln_pre": {"scale": np.ones(width, np.float32),
                                       "bias": np.zeros(width, np.float32)}}
    module = CLIP(cfg, logit_bias="logit_bias" in tree,
                  timm_proj_bias="proj_b" in (visual.get("head") or {}))
    return load_numpy_tree(module, {**tree, "visual": visual})


def blip_params_from_numpy(tree):
    """The JAX ``init_blip_params`` / ``blip_params_from_state_dict`` pytree
    (numpy leaves) as a CPU fp32 ``rs_ov_torch.nn.blip.Blip``, shaped by the
    tree: cross-attention layers, ``itm_head`` and ``temp`` where present."""
    from rs_ov_torch.nn.blip import blip_from_tree  # nn.blip builds on this module

    return blip_from_tree(tree)


def blip_decoder_params_from_numpy(tree):
    """The JAX ``init_blip_decoder_params`` / ``blip_decoder_params_from_state_dict``
    pytree as a CPU fp32 ``nn.blip_lm.BlipDecoder``."""
    from rs_ov_torch.nn.blip_lm import blip_decoder_from_tree

    return blip_decoder_from_tree(tree)


def blip_vqa_params_from_numpy(tree):
    """The JAX VQA pytree (``visual``, ``text_encoder``, ``text_decoder``,
    ``lm_head``) as a CPU fp32 ``nn.blip_lm.BlipVQA``."""
    from rs_ov_torch.nn.blip_lm import blip_vqa_from_tree

    return blip_vqa_from_tree(tree)


def blip_nlvr_params_from_numpy(tree):
    """The JAX NLVR pytree (the twin-stream ``text_encoder``, ``cls_head``)
    as a CPU fp32 ``nn.blip_lm.BlipNLVR``."""
    from rs_ov_torch.nn.blip_lm import blip_nlvr_from_tree

    return blip_nlvr_from_tree(tree)


def coca_params_from_numpy(tree, cfg: CoCaConfig) -> CoCa:
    """The JAX ``init_coca_params`` / ``coca_params_from_state_dict`` pytree
    (numpy leaves) as a CPU fp32 CoCa; the HF text tower's subtree (None
    entries left out) for a config with ``hf_model_name``."""
    text = module_from_tree(tree["text"]) if cfg.text.hf_model_name else None
    if text is not None:
        tree = {**tree, "text": {k: v for k, v in tree["text"].items() if v is not None}}
    return load_numpy_tree(CoCa(cfg, text), tree)


def jbu_params_from_numpy(tree, feat_dim: int, guidance_dim: int = 3,
                          key_dim: int = 32) -> nn.Module:
    """The JAX ``init_jbu_one_params`` (``up``) or ``init_jbu_stack_params``
    (``ups``) pytree (numpy leaves) as a CPU fp32 JBUOne / JBUStack."""
    cls = JBUStack if "ups" in tree else JBUOne
    return load_numpy_tree(cls(feat_dim, guidance_dim, key_dim), tree)


def momentum_copy(params: nn.Module) -> nn.Module:
    """Frozen copies (not aliases) of BLIP's four momentum pairs: visual,
    vision_proj, text and text_proj."""
    m = nn.Module()
    for k in ("visual", "vision_proj", "text", "text_proj"):
        m.add_module(k, copy.deepcopy(getattr(params, k)))
    return m.requires_grad_(False)


def _blip_state(params: nn.Module, tree) -> dict:
    params_m = load_numpy_tree(momentum_copy(params), tree["params_m"])
    q = tree["queue"]
    return {"params": params.requires_grad_(), "params_m": params_m,
            "queue": {"image": torch.tensor(q["image"], dtype=torch.float32),
                      "text": torch.tensor(q["text"], dtype=torch.float32),
                      "idx": torch.tensor(q["idx"], dtype=torch.long),
                      "ptr": torch.tensor(q["ptr"], dtype=torch.long).reshape(())}}


def blip_retrieval_state_from_numpy(tree) -> dict:
    """The JAX ``init_blip_retrieval_state`` tree (``params``, ``params_m``,
    ``queue`` with ``ptr``; numpy leaves) as the port's state: CPU fp32
    modules, the live ones trainable, the queue as CPU tensors."""
    from rs_ov_torch.nn.blip import blip_from_tree  # nn.blip builds on this module

    return _blip_state(blip_from_tree(tree["params"]), tree)


def blip_pretrain_state_from_numpy(tree) -> dict:
    """The JAX ``init_blip_pretrain_state`` tree: the retrieval state with
    the decoder's ``dec_self_attn`` layers and ``lm_head`` in ``params``."""
    from rs_ov_torch.nn.blip import blip_from_tree
    from rs_ov_torch.nn.blip_lm import add_pretrain_decoder

    p = tree["params"]
    params = blip_from_tree({k: v for k, v in p.items() if k not in ("dec_self_attn", "lm_head")})
    word = p["text"]["embeddings"]["word"]
    load_numpy_tree(add_pretrain_decoder(params, word.shape[1], word.shape[0],
                                         len(p["dec_self_attn"])), p)
    return _blip_state(params, tree)
