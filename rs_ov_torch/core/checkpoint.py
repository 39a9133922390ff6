"""Reference-named checkpoints -> the port's modules (rs_ov/core/checkpoint.py,
the open_clip and SimFeatUp loaders).

The way from a state dict in the reference's names to the port is a pure
renaming into the JAX package's pytree layout (numpy leaves, torch's (out,
in) orientation kept), then the strict bridge ``clip_params_from_numpy`` /
``load_numpy_tree``, which raises on a missing, unused or misshapen key.
The timm, big_vision and CoCa loaders belong to the other towers (ROADMAP
queue 1 item 8) and raise naming it.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov_torch.core.params import (CLIP, JBUOne, JBUStack, clip_params_from_numpy,
                                     load_numpy_tree)

__all__ = ["load_torch_state_dict", "vision_params_from_state_dict",
           "text_params_from_state_dict", "clip_params_from_state_dict",
           "infer_clip_config_from_state_dict", "jbu_params_from_state_dict"]

_OTHER_TOWERS = "queue 1 item 8"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {_OTHER_TOWERS})")


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().float().numpy() if x.is_floating_point() else x.detach().cpu().numpy()


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a checkpoint file into {name: np.ndarray} (floats as fp32): raw
    state dicts, {'state_dict': ...} wrappers, TorchScript archives (OpenAI
    JIT .pt files) and .safetensors files."""
    if path.endswith(".safetensors"):
        from rs_ov_torch.utils.safetensors import load_safetensors

        return {k: _np(v) for k, v in load_safetensors(path).items()}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except Exception:
            obj = torch.jit.load(path, map_location="cpu").state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        obj = obj.state_dict()
    return {k: _np(v) for k, v in obj.items()}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _ln(sd, prefix):
    return {"scale": _f32(sd[f"{prefix}.weight"]), "bias": _f32(sd[f"{prefix}.bias"])}


def _block(sd, prefix):
    blk = {
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "attn": {
            "in_proj_w": _f32(sd[f"{prefix}.attn.in_proj_weight"]),
            "in_proj_b": _f32(sd[f"{prefix}.attn.in_proj_bias"]),
            "out_proj_w": _f32(sd[f"{prefix}.attn.out_proj.weight"]),
            "out_proj_b": _f32(sd[f"{prefix}.attn.out_proj.bias"]),
        },
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {
            "c_fc_w": _f32(sd[f"{prefix}.mlp.c_fc.weight"]),
            "c_fc_b": _f32(sd[f"{prefix}.mlp.c_fc.bias"]),
            "c_proj_w": _f32(sd[f"{prefix}.mlp.c_proj.weight"]),
            "c_proj_b": _f32(sd[f"{prefix}.mlp.c_proj.bias"]),
        },
    }
    for ls in ("ls_1", "ls_2"):  # open_clip LayerScale blocks
        if f"{prefix}.{ls}.gamma" in sd:
            blk[ls] = _f32(sd[f"{prefix}.{ls}.gamma"])
    return blk


def _count_blocks(sd, prefix) -> int:
    n = 0
    while f"{prefix}.{n}.ln_1.weight" in sd:
        n += 1
    return n


def vision_params_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "visual.") -> dict:
    """An open_clip VisionTransformer state dict as the JAX pytree layout."""
    p = prefix
    n = _count_blocks(sd, f"{p}transformer.resblocks")
    return {
        "conv1_w": _f32(sd[f"{p}conv1.weight"]),
        "class_embedding": _f32(sd[f"{p}class_embedding"]),
        "positional_embedding": _f32(sd[f"{p}positional_embedding"]),
        "ln_pre": _ln(sd, f"{p}ln_pre"),
        "blocks": [_block(sd, f"{p}transformer.resblocks.{i}") for i in range(n)],
        "ln_post": _ln(sd, f"{p}ln_post"),
        "proj": _f32(sd[f"{p}proj"]),
    }


def text_params_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "") -> dict:
    """The CLIP text tower's state dict as the JAX pytree layout; an
    nn.Linear text projection becomes the [width, embed] matrix and its
    bias."""
    p = prefix
    n = _count_blocks(sd, f"{p}transformer.resblocks")
    params = {
        "token_embedding": _f32(sd[f"{p}token_embedding.weight"]),
        "positional_embedding": _f32(sd[f"{p}positional_embedding"]),
        "blocks": [_block(sd, f"{p}transformer.resblocks.{i}") for i in range(n)],
        "ln_final": _ln(sd, f"{p}ln_final"),
    }
    if f"{p}text_projection.weight" in sd:
        params["text_projection"] = _f32(np.asarray(sd[f"{p}text_projection.weight"]).T)
        if f"{p}text_projection.bias" in sd:
            params["text_projection_b"] = _f32(sd[f"{p}text_projection.bias"])
    else:
        params["text_projection"] = _f32(sd[f"{p}text_projection"])
    return params


def _clip_tree(sd: Mapping[str, np.ndarray]) -> dict:
    """An open_clip-named CLIP state dict as the JAX pytree layout."""
    if "visual.conv1.weight" not in sd:
        raise _not_ported("loading a timm-flavoured vision tower")
    text_prefix = "text." if "text.token_embedding.weight" in sd else ""
    tree = {"visual": vision_params_from_state_dict(sd, "visual."),
            "text": text_params_from_state_dict(sd, text_prefix),
            "logit_scale": _f32(sd.get("logit_scale", np.log(1 / 0.07)))}
    if "logit_bias" in sd:
        tree["logit_bias"] = _f32(sd["logit_bias"])
    return tree


def clip_params_from_state_dict(sd: Mapping[str, np.ndarray],
                                cfg: CLIPConfig | None = None) -> CLIP:
    """An open_clip-named CLIP state dict as the port's CPU fp32 CLIP module;
    ``cfg`` defaults to the one the state dict implies. Strict: a missing,
    unused or misshapen key raises."""
    tree = _clip_tree(sd)
    return clip_params_from_numpy(tree, cfg or infer_clip_config_from_state_dict(sd))


def infer_clip_config_from_state_dict(sd: Mapping[str, np.ndarray],
                                      quick_gelu: bool = True) -> CLIPConfig:
    """The architecture an open_clip-named checkpoint implies (the
    reference's build_model_from_openai_state_dict)."""
    if "visual.conv1.weight" not in sd:
        raise _not_ported("inferring the config of a timm-flavoured vision tower")
    v_width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    v_layers = _count_blocks(sd, "visual.transformer.resblocks")
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    embed_dim = sd["visual.proj"].shape[1]
    vision = VisionConfig(image_size=grid * patch, patch_size=patch, width=v_width,
                          layers=v_layers, output_dim=embed_dim)
    if "ln_final.weight" not in sd:  # vision-only export
        return CLIPConfig(embed_dim=embed_dim, vision=vision,
                          text=TextConfig(output_dim=embed_dim), quick_gelu=quick_gelu)
    t_width = sd["ln_final.weight"].shape[0]
    text = TextConfig(context_length=sd["positional_embedding"].shape[0],
                      vocab_size=sd["token_embedding.weight"].shape[0], width=t_width,
                      heads=t_width // 64, layers=_count_blocks(sd, "transformer.resblocks"),
                      output_dim=embed_dim)
    return CLIPConfig(embed_dim=embed_dim, vision=vision, text=text, quick_gelu=quick_gelu)


def _jbu_module(sd, prefix):
    return {
        "range_temp": _f32(sd[f"{prefix}.range_temp"]),
        "sigma_spatial": _f32(sd[f"{prefix}.sigma_spatial"]),
        "range_proj": {"w0": _f32(sd[f"{prefix}.range_proj.0.weight"]),
                       "b0": _f32(sd[f"{prefix}.range_proj.0.bias"]),
                       "w1": _f32(sd[f"{prefix}.range_proj.3.weight"]),
                       "b1": _f32(sd[f"{prefix}.range_proj.3.bias"])},
        "fixup_proj": {"w0": _f32(sd[f"{prefix}.fixup_proj.0.weight"]),
                       "b0": _f32(sd[f"{prefix}.fixup_proj.0.bias"]),
                       "w1": _f32(sd[f"{prefix}.fixup_proj.3.weight"]),
                       "b1": _f32(sd[f"{prefix}.fixup_proj.3.bias"])},
    }


def _jbu_tree(sd: Mapping[str, np.ndarray], model_name: str,
                                    strip_prefix: str = "upsampler.") -> dict:
    """A SimFeatUp checkpoint ('jbu_one' or 'jbu_stack') as the JAX pytree
    layout, with ``strip_prefix`` removed from its keys."""
    if strip_prefix:
        sd = {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k): v
              for k, v in sd.items()}
    final = {"w": _f32(sd["fixup_proj.1.weight"]), "b": _f32(sd["fixup_proj.1.bias"])}
    if model_name == "jbu_one":
        return {"up": _jbu_module(sd, "up"), "final_fixup": final}
    if model_name == "jbu_stack":
        return {"ups": [_jbu_module(sd, f"up{i}") for i in (1, 2, 3, 4)], "final_fixup": final}
    raise ValueError(f"Unknown SimFeatUp model '{model_name}'")


def jbu_params_from_state_dict(sd: Mapping[str, np.ndarray], model_name: str,
                               strip_prefix: str = "upsampler."):
    """A SimFeatUp checkpoint as the port's CPU fp32 JBUOne / JBUStack, its
    feature width, key and guidance dims read from the weights. Strict, as
    the CLIP bridge."""
    tree = _jbu_tree(sd, model_name, strip_prefix)
    key_dim, guidance_dim = (tree["up"] if model_name == "jbu_one"
                             else tree["ups"][0])["range_proj"]["w0"].shape[:2]
    cls = JBUOne if model_name == "jbu_one" else JBUStack
    return load_numpy_tree(cls(tree["final_fixup"]["b"].shape[0], guidance_dim, key_dim), tree)
