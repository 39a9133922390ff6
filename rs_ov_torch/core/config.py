"""Model architecture configs and the registry (a copy of
rs_ov/core/config.py).

The port keeps its own definitions so that it imports nothing of rs_ov. The
fields, defaults and registry entries are those of the JAX package, so a
config from either package carries the same numbers; the port reads them by
attribute only, so it accepts either package's dataclasses. The port's CLIP
module builds the ViT towers (plain, LayerScale, CLIPA); the timm-towered
entries (SigLIP, EVA, ConvNeXt) resolve here and are refused when built
(ROADMAP queue 1 item 8e). CoCa names are listed, and resolving one raises
(queue 1 item 9: their configs are the CoCa module's dataclasses).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["VisionConfig", "TextConfig", "CLIPConfig", "COCA_MODELS", "get_model_config",
           "list_models", "register_model"]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    mlp_ratio: float = 4.0
    output_dim: int = 512
    # heads = width // head_width (OpenCLIP convention)
    head_width: int = 64
    pool_type: str = "tok"  # 'tok' | 'avg' | 'none'
    final_ln_after_pool: bool = False
    no_ln_pre: bool = False
    ls_init_value: Optional[float] = None  # LayerScale init (ViT-M-16-alt)
    attentional_pool: bool = False         # CoCa-style pooler head
    attn_pooler_heads: int = 8
    output_tokens: bool = False
    timm_model_name: Optional[str] = None  # timm towers: not built by the port
    timm_pool: str = ""
    timm_proj: Optional[str] = None

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.image_size // self.patch_size, self.image_size // self.patch_size)


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    output_dim: int = 512
    pool_type: str = "argmax"  # 'argmax' | 'first' | 'last' | 'none'
    no_causal_mask: bool = False
    pad_id: int = 0
    proj_bias: bool = False
    embed_cls: bool = False     # CoCa text: learned CLS appended at the end
    output_tokens: bool = False
    norm_eps: Optional[float] = None  # LayerNorm eps override (SigLIP 1e-6)
    hf_tokenizer_name: Optional[str] = None
    hf_model_name: Optional[str] = None
    hf_proj_type: Optional[str] = None
    tokenizer_clean: Optional[str] = None
    strip_sep_token: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    vision: VisionConfig
    text: TextConfig
    quick_gelu: bool = False  # OpenAI checkpoints use QuickGELU
    custom_text: bool = False
    init_logit_bias: Optional[float] = None

    @property
    def name(self) -> str:
        return f"ViT-{self.vision.width}x{self.vision.layers}-p{self.vision.patch_size}"


def _cfg(embed_dim, image_size, patch_size, v_width, v_layers,
         t_width, t_heads, t_layers, quick_gelu=False, head_width=64,
         v_mlp_ratio=4.0, ls_init_value=None) -> CLIPConfig:
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(
            image_size=image_size, patch_size=patch_size,
            width=v_width, layers=v_layers, output_dim=embed_dim,
            head_width=head_width, mlp_ratio=v_mlp_ratio,
            ls_init_value=ls_init_value,
        ),
        text=TextConfig(
            width=t_width, heads=t_heads, layers=t_layers, output_dim=embed_dim,
        ),
        quick_gelu=quick_gelu,
    )


def _clipa(embed_dim, image_size, patch_size, v_width, v_layers,
           t_width, t_heads, t_layers, head_width=64,
           v_mlp_ratio=4.0) -> CLIPConfig:
    """CLIPA family: avg-pooled no-ln-pre vision, bert-tokenized 32-token
    causal-mask-free text (reference model_configs/ViT-*-CLIPA*.json)."""
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(
            image_size=image_size, patch_size=patch_size, width=v_width,
            layers=v_layers, output_dim=embed_dim, head_width=head_width,
            mlp_ratio=v_mlp_ratio, no_ln_pre=True, pool_type="avg",
            final_ln_after_pool=True,
        ),
        text=TextConfig(
            context_length=32, vocab_size=32000, width=t_width, heads=t_heads,
            layers=t_layers, output_dim=embed_dim, pool_type="last",
            no_causal_mask=True, hf_tokenizer_name="bert-base-uncased",
            strip_sep_token=True,
        ),
    )


def _siglip(embed_dim, image_size, v_width, v_layers, t_width, t_heads,
            t_layers, timm_name, vocab_size=32000,
            hf_tok="timm/ViT-B-16-SigLIP") -> CLIPConfig:
    """SigLIP family (reference model_configs/ViT-*-SigLIP*.json): timm MAP-
    pooled CLS-less vision tower, SentencePiece text with last-token pool.
    The shape fields are the underlying plain-ViT timm arch's."""
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(
            image_size=image_size, patch_size=16, width=v_width,
            layers=v_layers, output_dim=embed_dim,
            timm_model_name=timm_name, timm_pool="map", timm_proj="none",
        ),
        text=TextConfig(
            context_length=64, vocab_size=vocab_size, width=t_width,
            heads=t_heads, layers=t_layers, output_dim=embed_dim,
            pool_type="last", no_causal_mask=True, proj_bias=True,
            norm_eps=1e-6, hf_tokenizer_name=hf_tok,
            tokenizer_clean="canonicalize",
        ),
        custom_text=True,
        init_logit_bias=-10.0,
    )


def _timm(embed_dim, image_size, t_width, t_heads, t_layers, timm_name,
          timm_pool="", timm_proj="linear", custom_text=False,
          t_ctx=77, t_vocab=49408) -> CLIPConfig:
    """timm-towered families (EVA / convnext): the vision shape fields are
    not meaningful, only ``timm_model_name`` and the head fields are."""
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(
            image_size=image_size, output_dim=embed_dim,
            timm_model_name=timm_name, timm_pool=timm_pool,
            timm_proj=timm_proj,
        ),
        text=TextConfig(
            context_length=t_ctx, vocab_size=t_vocab, width=t_width,
            heads=t_heads, layers=t_layers, output_dim=embed_dim,
        ),
        custom_text=custom_text,
    )


# the registry of rs_ov/core/config.py:187-369, same names and numbers
_MODEL_CONFIGS: dict[str, CLIPConfig] = {
    # OpenAI-style names (quick_gelu=True: reference openai.py path)
    "ViT-B/16": _cfg(512, 224, 16, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-B/32": _cfg(512, 224, 32, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-L/14": _cfg(768, 224, 14, 1024, 24, 768, 12, 12, quick_gelu=True),
    "ViT-L/14-quickgelu": _cfg(768, 224, 14, 1024, 24, 768, 12, 12, quick_gelu=True),
    # ViT-M / ViT-B / ViT-L / ViT-H plain towers
    "ViT-M-32": _cfg(512, 224, 32, 512, 12, 512, 8, 12),
    "ViT-M-32-alt": _cfg(384, 224, 32, 512, 12, 384, 6, 12),
    "ViT-M-16": _cfg(512, 224, 16, 512, 12, 512, 8, 12),
    "ViT-M-16-alt": _cfg(384, 224, 16, 512, 12, 384, 6, 12, ls_init_value=1e-4),
    "ViT-B-32": _cfg(512, 224, 32, 768, 12, 512, 8, 12),
    "ViT-B-32-256": _cfg(512, 256, 32, 768, 12, 512, 8, 12),
    "ViT-B-32-quickgelu": _cfg(512, 224, 32, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-B-32-plus-256": _cfg(640, 256, 32, 896, 12, 640, 10, 12),
    "ViT-B-16": _cfg(512, 224, 16, 768, 12, 512, 8, 12),
    "ViT-B-16-quickgelu": _cfg(512, 224, 16, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-B-16-plus": _cfg(640, 224, 16, 896, 12, 640, 10, 12),
    "ViT-B-16-plus-240": _cfg(640, 240, 16, 896, 12, 640, 10, 12),
    "ViT-L-14": _cfg(768, 224, 14, 1024, 24, 768, 12, 12),
    "ViT-L-14-quickgelu": _cfg(768, 224, 14, 1024, 24, 768, 12, 12, quick_gelu=True),
    "ViT-L-14-280": _cfg(768, 280, 14, 1024, 24, 768, 12, 12),
    "ViT-L-14-336": _cfg(768, 336, 14, 1024, 24, 768, 12, 12),
    "ViT-L-16": _cfg(768, 224, 16, 1024, 24, 768, 12, 12),
    "ViT-L-16-320": _cfg(768, 320, 16, 1024, 24, 768, 12, 12),
    "ViT-H-14": _cfg(1024, 224, 14, 1280, 32, 1024, 16, 24, head_width=80),
    "ViT-H-14-quickgelu": _cfg(1024, 224, 14, 1280, 32, 1024, 16, 24,
                               quick_gelu=True, head_width=80),
    "ViT-H-14-378-quickgelu": _cfg(1024, 378, 14, 1280, 32, 1024, 16, 24,
                                   quick_gelu=True, head_width=80),
    "ViT-H-16": _cfg(1024, 224, 16, 1280, 32, 1024, 16, 24, head_width=80),
    # giant/enormous towers
    "ViT-g-14": _cfg(1024, 224, 14, 1408, 40, 1024, 16, 24, head_width=88,
                     v_mlp_ratio=4.3637),
    "ViT-bigG-14": _cfg(1280, 224, 14, 1664, 48, 1280, 20, 32, head_width=104,
                        v_mlp_ratio=4.9231),
    "ViT-e-14": _cfg(1280, 224, 14, 1792, 56, 1280, 20, 36, head_width=112,
                     v_mlp_ratio=8.5715),
    # CLIPA
    "ViT-L-14-CLIPA": _clipa(768, 224, 14, 1024, 24, 768, 12, 12),
    "ViT-L-14-CLIPA-336": _clipa(768, 336, 14, 1024, 24, 768, 12, 12),
    "ViT-H-14-CLIPA": _clipa(1024, 224, 14, 1280, 32, 1024, 16, 24, head_width=80),
    "ViT-H-14-CLIPA-336": _clipa(1024, 336, 14, 1280, 32, 1024, 16, 24,
                                 head_width=80),
    "ViT-bigG-14-CLIPA": _clipa(1280, 224, 14, 1664, 48, 1280, 20, 32,
                                head_width=104, v_mlp_ratio=4.9231),
    "ViT-bigG-14-CLIPA-336": _clipa(1280, 336, 14, 1664, 48, 1280, 20, 32,
                                    head_width=104, v_mlp_ratio=4.9231),
    # SigLIP
    "ViT-B-16-SigLIP": _siglip(768, 224, 768, 12, 768, 12, 12,
                               "vit_base_patch16_siglip_224"),
    "ViT-B-16-SigLIP-256": _siglip(768, 256, 768, 12, 768, 12, 12,
                                   "vit_base_patch16_siglip_256"),
    "ViT-B-16-SigLIP-384": _siglip(768, 384, 768, 12, 768, 12, 12,
                                   "vit_base_patch16_siglip_384"),
    "ViT-B-16-SigLIP-512": _siglip(768, 512, 768, 12, 768, 12, 12,
                                   "vit_base_patch16_siglip_512"),
    "ViT-B-16-SigLIP-i18n-256": _siglip(768, 256, 768, 12, 768, 12, 12,
                                        "vit_base_patch16_siglip_256",
                                        vocab_size=250000,
                                        hf_tok="timm/ViT-B-16-SigLIP-i18n-256"),
    "ViT-L-16-SigLIP-256": _siglip(1024, 256, 1024, 24, 1024, 16, 24,
                                   "vit_large_patch16_siglip_256"),
    "ViT-L-16-SigLIP-384": _siglip(1024, 384, 1024, 24, 1024, 16, 24,
                                   "vit_large_patch16_siglip_384"),
    # EVA (timm towers)
    "EVA01-g-14": _timm(1024, 224, 768, 12, 12, "eva_giant_patch14_224",
                        timm_pool="token", timm_proj=None, custom_text=True),
    "EVA01-g-14-plus": _timm(1024, 224, 1024, 16, 24, "eva_giant_patch14_224",
                             timm_pool="token", timm_proj=None, custom_text=True),
    "EVA02-B-16": _timm(512, 224, 512, 8, 12, "eva02_base_patch16_clip_224",
                        timm_pool="token", timm_proj=None, custom_text=True),
    "EVA02-L-14": _timm(768, 224, 768, 12, 12, "eva02_large_patch14_clip_224",
                        timm_pool="token", timm_proj=None, custom_text=True),
    "EVA02-L-14-336": _timm(768, 336, 768, 12, 12, "eva02_large_patch14_clip_336",
                            timm_pool="token", timm_proj=None, custom_text=True),
    "EVA02-E-14": _timm(1024, 224, 1024, 16, 24, "eva02_enormous_patch14_clip_224",
                        timm_pool="token", timm_proj=None, custom_text=True),
    "EVA02-E-14-plus": _timm(1024, 224, 1280, 20, 32,
                             "eva02_enormous_patch14_clip_224",
                             timm_pool="token", timm_proj=None, custom_text=True),
    # convnext (timm towers)
    "convnext_tiny": _timm(1024, 224, 512, 8, 12, "convnext_tiny"),
    "convnext_small": _timm(512, 224, 512, 8, 12, "convnext_small"),
    "convnext_base": _timm(512, 224, 512, 8, 12, "convnext_base"),
    "convnext_base_w": _timm(640, 256, 640, 10, 12, "convnext_base"),
    "convnext_base_w_320": _timm(640, 320, 640, 10, 12, "convnext_base"),
    "convnext_large": _timm(768, 224, 768, 12, 12, "convnext_large"),
    "convnext_large_d": _timm(768, 256, 768, 12, 16, "convnext_large",
                              timm_proj="mlp"),
    "convnext_large_d_320": _timm(768, 320, 768, 12, 16, "convnext_large",
                                  timm_proj="mlp"),
    "convnext_xlarge": _timm(1024, 256, 1024, 16, 20, "convnext_xlarge"),
    "convnext_xxlarge": _timm(1024, 256, 1024, 16, 24, "convnext_xxlarge"),
    "convnext_xxlarge_320": _timm(1024, 320, 1024, 16, 24, "convnext_xxlarge"),
}


COCA_MODELS = ("coca_base", "coca_ViT-B-32", "coca_ViT-L-14", "coca_roberta-ViT-B-32")


def get_model_config(name: str) -> CLIPConfig:
    """Resolve a model name ('ViT-B/16', 'ViT-L-14', ...) to its config;
    '/' and '-' spellings are interchangeable, as in open_clip. A CoCa name
    raises NotImplementedError."""
    for key in (name, name.replace("/", "-")):
        if key in _MODEL_CONFIGS:
            return _MODEL_CONFIGS[key]
    if name in COCA_MODELS:
        raise NotImplementedError(f"CoCa model '{name}' is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    raise KeyError(f"Unknown model '{name}'. Known: {list_models()}")


def list_models() -> list[str]:
    """Canonical arch names ('/'-spelled OpenAI aliases left out), CoCa's
    included: the JAX package's list."""
    return sorted([n for n in _MODEL_CONFIGS if "/" not in n] + list(COCA_MODELS))


def register_model(name: str, cfg: CLIPConfig) -> None:
    _MODEL_CONFIGS[name] = cfg
