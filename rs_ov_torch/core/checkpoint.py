"""Reference-named checkpoints -> the port's modules (rs_ov/core/checkpoint.py,
the open_clip, timm-named ViT and SimFeatUp loaders).

The way from a state dict in the reference's names to the port is a pure
renaming into the JAX package's pytree layout (numpy leaves, torch's (out,
in) orientation kept), then the strict bridge ``clip_params_from_numpy`` /
``load_numpy_tree``, which raises on a missing, unused or misshapen key.
The timm-tower (ConvNeXt, SigLIP MAP-head ViT, EVA) and big_vision loaders
are ROADMAP queue 1 item 8e, CoCa's is item 9.
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
           "infer_clip_config_from_state_dict", "jbu_params_from_state_dict",
           "detect_timm_vision_prefix", "vision_params_from_timm_state_dict"]


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
    """An open_clip VisionTransformer state dict as the JAX pytree layout;
    LayerScale gammas where the blocks have them, no ``ln_pre`` where the
    export has none (a ``no_ln_pre`` tower)."""
    p = prefix
    n = _count_blocks(sd, f"{p}transformer.resblocks")
    tree = {
        "conv1_w": _f32(sd[f"{p}conv1.weight"]),
        "class_embedding": _f32(sd[f"{p}class_embedding"]),
        "positional_embedding": _f32(sd[f"{p}positional_embedding"]),
        "blocks": [_block(sd, f"{p}transformer.resblocks.{i}") for i in range(n)],
        "ln_post": _ln(sd, f"{p}ln_post"),
        "proj": _f32(sd[f"{p}proj"]),
    }
    if f"{p}ln_pre.weight" in sd:
        tree["ln_pre"] = _ln(sd, f"{p}ln_pre")
    return tree


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


# ---------------------------------------------------------------------------
# timm-named plain-ViT exports (rs_ov/core/checkpoint.py:197-312)
# ---------------------------------------------------------------------------

_TIMM_VISION_PREFIXES = ("", "visual.", "visual.trunk.", "module.visual.trunk.",
                         "image_encoder.", "vision_model.")


def detect_timm_vision_prefix(sd: Mapping[str, np.ndarray]) -> str | None:
    """Prefix under which timm ViT names live, or None if not timm-named."""
    for p in _TIMM_VISION_PREFIXES:
        if f"{p}patch_embed.proj.weight" in sd:
            return p
    return None


def _identity_ln(width: int) -> dict:
    return {"scale": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)}


def _timm_block(sd, prefix):
    d = sd[f"{prefix}.attn.qkv.weight"].shape[1]
    if f"{prefix}.attn.qkv.bias" in sd:
        qkv_b = sd[f"{prefix}.attn.qkv.bias"]
    elif f"{prefix}.attn.q_bias" in sd:  # EVA / BLIP style: q and v biases, no k bias
        qkv_b = np.concatenate([_f32(sd[f"{prefix}.attn.q_bias"]), np.zeros(d, np.float32),
                                _f32(sd[f"{prefix}.attn.v_bias"])])
    else:
        qkv_b = np.zeros(3 * d, np.float32)
    return {
        "ln_1": _ln(sd, f"{prefix}.norm1"),
        "attn": {"in_proj_w": _f32(sd[f"{prefix}.attn.qkv.weight"]),
                 "in_proj_b": _f32(qkv_b),
                 "out_proj_w": _f32(sd[f"{prefix}.attn.proj.weight"]),
                 "out_proj_b": _f32(sd[f"{prefix}.attn.proj.bias"])},
        "ln_2": _ln(sd, f"{prefix}.norm2"),
        "mlp": {"c_fc_w": _f32(sd[f"{prefix}.mlp.fc1.weight"]),
                "c_fc_b": _f32(sd[f"{prefix}.mlp.fc1.bias"]),
                "c_proj_w": _f32(sd[f"{prefix}.mlp.fc2.weight"]),
                "c_proj_b": _f32(sd[f"{prefix}.mlp.fc2.bias"])},
    }


def vision_params_from_timm_state_dict(sd: Mapping[str, np.ndarray],
                                       prefix: str | None = None) -> dict:
    """A timm-named plain-ViT state dict as the JAX pytree layout:
    patch_embed.proj -> conv1_w, cls_token -> class_embedding (zeros when
    absent), pos_embed -> positional_embedding (a zero CLS row prepended to a
    table without one), norm_pre -> ln_pre (identity when absent),
    blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2} -> the
    block, norm / fc_norm -> ln_post (identity when absent), head.proj ->
    proj (identity when absent), gamma_1 / ls1.gamma -> ls_1 and likewise
    ls_2."""
    p = detect_timm_vision_prefix(sd) if prefix is None else prefix
    if p is None:
        raise KeyError("not a timm-named ViT state dict "
                       "(no patch_embed.proj.weight under known prefixes)")
    conv1 = _f32(sd[f"{p}patch_embed.proj.weight"])
    width = conv1.shape[0]
    n = 0
    while f"{p}blocks.{n}.norm1.weight" in sd:
        n += 1
    pos = _f32(sd[f"{p}pos_embed"])
    if pos.ndim == 3:
        pos = pos[0]
    cls = (_f32(sd[f"{p}cls_token"]).reshape(width) if f"{p}cls_token" in sd
           else np.zeros(width, np.float32))
    grid = int(round(pos.shape[0] ** 0.5))
    if grid * grid == pos.shape[0]:  # a CLS-less table: a zero row for the CLS
        pos = np.concatenate([np.zeros((1, width), np.float32), pos], 0)
    post = "norm" if f"{p}norm.weight" in sd else "fc_norm"
    for head in (f"{p}head.proj.weight", "visual.head.proj.weight"):
        if head in sd:  # open_clip's timm adapter head, [E, D]
            proj = _f32(np.asarray(sd[head]).T)
            break
    else:
        proj = np.eye(width, dtype=np.float32)
    tree = {
        "conv1_w": conv1,
        "class_embedding": cls,
        "positional_embedding": pos,
        "ln_pre": (_ln(sd, f"{p}norm_pre") if f"{p}norm_pre.weight" in sd
                   else _identity_ln(width)),
        "blocks": [_timm_block(sd, f"{p}blocks.{i}") for i in range(n)],
        "ln_post": (_ln(sd, f"{p}{post}") if f"{p}{post}.weight" in sd
                    else _identity_ln(width)),
        "proj": proj,
    }
    for i, blk in enumerate(tree["blocks"]):  # timm LayerScale
        for ours, theirs in (("ls_1", ("gamma_1", "ls1.gamma")),
                             ("ls_2", ("gamma_2", "ls2.gamma"))):
            for t in theirs:
                if f"{p}blocks.{i}.{t}" in sd:
                    blk[ours] = _f32(sd[f"{p}blocks.{i}.{t}"])
    return tree


def _clip_tree(sd: Mapping[str, np.ndarray]) -> dict:
    """An open_clip-named CLIP state dict, or one whose vision tower has
    timm's names, as the JAX pytree layout."""
    if "visual.trunk.stem.0.weight" in sd:
        raise NotImplementedError("loading a timm-tower export (visual.trunk.*) is not "
                                  "ported yet (ROADMAP queue 1 item 8e)")
    visual = (vision_params_from_state_dict(sd, "visual.") if "visual.conv1.weight" in sd
              else vision_params_from_timm_state_dict(sd))
    text_prefix = "text." if "text.token_embedding.weight" in sd else ""
    tree = {"visual": visual,
            "text": text_params_from_state_dict(sd, text_prefix),
            "logit_scale": _f32(sd.get("logit_scale", np.log(1 / 0.07)))}
    if "logit_bias" in sd:
        tree["logit_bias"] = _f32(sd["logit_bias"])
    return tree


def clip_params_from_state_dict(sd: Mapping[str, np.ndarray],
                                cfg: CLIPConfig | None = None) -> CLIP:
    """An open_clip-named CLIP state dict (its vision tower in open_clip's
    or timm's names) as the port's CPU fp32 CLIP module; ``cfg`` defaults to
    the one the state dict implies. Strict: a missing, unused or misshapen
    key raises."""
    tree = _clip_tree(sd)
    return clip_params_from_numpy(tree, cfg or infer_clip_config_from_state_dict(sd))


def infer_clip_config_from_state_dict(sd: Mapping[str, np.ndarray],
                                      quick_gelu: bool = True) -> CLIPConfig:
    """The architecture a checkpoint implies (the reference's
    build_model_from_openai_state_dict): open_clip or timm vision names, the
    text tower's fields where the export has one (rs_ov/core/checkpoint.py:485-543)."""
    if "visual.conv1.weight" in sd:
        v_width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        v_layers = _count_blocks(sd, "visual.transformer.resblocks")
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        embed_dim = sd["visual.proj"].shape[1]
    else:
        p = detect_timm_vision_prefix(sd)
        if p is None:
            raise KeyError("state dict has neither open_clip nor timm vision-tower names")
        conv1 = sd[f"{p}patch_embed.proj.weight"]
        v_width, patch = conv1.shape[0], conv1.shape[-1]
        v_layers = 0
        while f"{p}blocks.{v_layers}.norm1.weight" in sd:
            v_layers += 1
        npos = np.asarray(sd[f"{p}pos_embed"]).shape[-2]
        grid = int(round(npos ** 0.5))
        if grid * grid != npos:  # the table has a CLS row
            grid = int(round((npos - 1) ** 0.5))
        embed_dim = (sd[f"{p}head.proj.weight"].shape[0] if f"{p}head.proj.weight" in sd
                     else v_width)
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
    if model_name not in ("jbu_one", "jbu_stack"):
        raise ValueError(f"Unknown SimFeatUp model '{model_name}'")
    if strip_prefix:
        sd = {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k): v
              for k, v in sd.items()}
    final = {"w": _f32(sd["fixup_proj.1.weight"]), "b": _f32(sd["fixup_proj.1.bias"])}
    if model_name == "jbu_one":
        return {"up": _jbu_module(sd, "up"), "final_fixup": final}
    return {"ups": [_jbu_module(sd, f"up{i}") for i in (1, 2, 3, 4)], "final_fixup": final}


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
