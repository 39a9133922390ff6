"""Model architecture configs (a copy of rs_ov/core/config.py's dataclasses
and of its plain-tower registry entries).

The port keeps its own definitions so that it imports nothing of rs_ov. The
fields and defaults are those of the JAX package, so a config from either
package carries the same numbers; the port reads them by attribute only, so
it accepts either package's dataclasses. Only the plain OpenAI-style ViT
towers are listed here: they are the ones the port's CLIP module builds
(CLIPA, SigLIP, the timm towers and CoCa are ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["VisionConfig", "TextConfig", "CLIPConfig", "get_model_config", "list_models"]


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


# the plain-tower entries of rs_ov/core/config.py:190-227, same numbers
_MODEL_CONFIGS: dict[str, CLIPConfig] = {
    "ViT-B/16": _cfg(512, 224, 16, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-B/32": _cfg(512, 224, 32, 768, 12, 512, 8, 12, quick_gelu=True),
    "ViT-L/14": _cfg(768, 224, 14, 1024, 24, 768, 12, 12, quick_gelu=True),
    "ViT-L/14-quickgelu": _cfg(768, 224, 14, 1024, 24, 768, 12, 12, quick_gelu=True),
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
    "ViT-g-14": _cfg(1024, 224, 14, 1408, 40, 1024, 16, 24, head_width=88,
                     v_mlp_ratio=4.3637),
    "ViT-bigG-14": _cfg(1280, 224, 14, 1664, 48, 1280, 20, 32, head_width=104,
                        v_mlp_ratio=4.9231),
    "ViT-e-14": _cfg(1280, 224, 14, 1792, 56, 1280, 20, 36, head_width=112,
                     v_mlp_ratio=8.5715),
}


def get_model_config(name: str) -> CLIPConfig:
    """Resolve a model name ('ViT-B/16', 'ViT-L-14', ...) to its config;
    '/' and '-' spellings are interchangeable, as in open_clip."""
    for key in (name, name.replace("/", "-")):
        if key in _MODEL_CONFIGS:
            return _MODEL_CONFIGS[key]
    raise KeyError(f"Unknown or unported model '{name}'. Known: {list_models()}")


def list_models() -> list[str]:
    return sorted(n for n in _MODEL_CONFIGS if "/" not in n)
