"""CLIP tower and JBU parameters as ``nn.Module``s, random init, weight bridge.

The modules hold exactly the leaves of the JAX package's parameter pytrees
(rs_ov/core/params.py, rs_ov/upsample/jbu.py:483-530), under the same names
and shapes: a pytree path such as ``visual/blocks/3/attn/in_proj_w`` is the
state-dict key ``visual.blocks.3.attn.in_proj_w``. So the bridge from a JAX
pytree is a flatten plus a strict ``load_state_dict``, and the forward code
reads parameters by the same names as the JAX forward code.

Linear weights keep torch's (out, in) orientation, as in the JAX package.
Random init draws from an explicit CPU ``torch.Generator`` with the JAX
package's shapes and scales (rs_ov/core/params.py:53-134); the numbers differ
from ``jax.random``'s, so tests carry weights across with the bridge.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig

__all__ = ["LayerNorm", "ResBlock", "VisionTower", "TextTower", "CLIP",
           "Proj2", "JBUModule", "JBUOne", "JBUStack", "init_clip_params",
           "init_jbu_one_params", "init_jbu_stack_params",
           "clip_params_from_numpy", "blip_params_from_numpy", "jbu_params_from_numpy",
           "load_numpy_tree"]


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
    def __init__(self, width: int, mlp_width: int):
        super().__init__()
        self.c_fc_w = _p(mlp_width, width)
        self.c_fc_b = _p(mlp_width)
        self.c_proj_w = _p(width, mlp_width)
        self.c_proj_b = _p(width)


class ResBlock(nn.Module):
    def __init__(self, width: int, mlp_ratio: float):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width)
        self.ln_2 = LayerNorm(width)
        self.mlp = Mlp(width, int(width * mlp_ratio))


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        gh, gw = cfg.grid_size
        self.conv1_w = _p(cfg.width, 3, cfg.patch_size, cfg.patch_size)
        self.class_embedding = _p(cfg.width)
        self.positional_embedding = _p(gh * gw + 1, cfg.width)
        self.ln_pre = LayerNorm(cfg.width)
        self.blocks = nn.ModuleList(ResBlock(cfg.width, cfg.mlp_ratio)
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


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        v, t = cfg.vision, cfg.text
        if (v.timm_model_name or v.pool_type != "tok" or v.no_ln_pre
                or v.final_ln_after_pool or v.ls_init_value is not None
                or v.attentional_pool or t.proj_bias or t.pool_type != "argmax"
                or t.no_causal_mask or t.hf_model_name or t.embed_cls
                or t.norm_eps is not None):
            raise NotImplementedError(
                "only plain OpenAI-style CLIP ViT towers are ported; the other "
                "towers are ROADMAP queue 1 item 8")
        self.visual = VisionTower(v)
        self.text = TextTower(t)
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


def _init_block(blk: ResBlock, width: int, gen: torch.Generator) -> None:
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


@torch.no_grad()
def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> CLIP:
    """Random fp32 CLIP weights on the CPU, drawn from ``gen``."""
    m = CLIP(cfg)
    v, t = m.visual, m.text
    scale = cfg.vision.width ** -0.5
    _normal(v.conv1_w, scale, gen)
    _normal(v.class_embedding, scale, gen)
    _normal(v.positional_embedding, scale, gen)
    _init_ln(v.ln_pre)
    for blk in v.blocks:
        _init_block(blk, cfg.vision.width, gen)
    _init_ln(v.ln_post)
    _normal(v.proj, scale, gen)
    _normal(t.token_embedding, 0.02, gen)
    _normal(t.positional_embedding, 0.01, gen)
    for blk in t.blocks:
        _init_block(blk, cfg.text.width, gen)
    _init_ln(t.ln_final)
    _normal(t.text_projection, cfg.text.width ** -0.5, gen)
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


def clip_params_from_numpy(tree, cfg: CLIPConfig) -> CLIP:
    """The JAX ``init_clip_params`` pytree (numpy leaves) as a CPU fp32 CLIP."""
    return load_numpy_tree(CLIP(cfg), tree)


def blip_params_from_numpy(tree):
    """The JAX ``init_blip_params`` / ``blip_params_from_state_dict`` pytree
    (numpy leaves) as a CPU fp32 ``rs_ov_torch.nn.blip.Blip``, shaped by the
    tree: cross-attention layers, ``itm_head`` and ``temp`` where present."""
    from rs_ov_torch.nn.blip import blip_from_tree  # nn.blip builds on this module

    return blip_from_tree(tree)


def jbu_params_from_numpy(tree, feat_dim: int, guidance_dim: int = 3,
                          key_dim: int = 32) -> nn.Module:
    """The JAX ``init_jbu_one_params`` (``up``) or ``init_jbu_stack_params``
    (``ups``) pytree (numpy leaves) as a CPU fp32 JBUOne / JBUStack."""
    cls = JBUStack if "ups" in tree else JBUOne
    return load_numpy_tree(cls(feat_dim, guidance_dim, key_dim), tree)
