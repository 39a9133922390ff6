"""HF-hub packaging (rs_ov/hub.py).

``save_for_hub`` writes the artifact directory open_clip's push_to_hf_hub
produces: ``open_clip_config.json`` (model_cfg and preprocess_cfg),
``open_clip_model.safetensors`` with open_clip-named tensors (so either
package, or open_clip, loads it back) and a generated ``README.md`` model
card. ``push_to_hf_hub`` stages that directory and then refuses: the upload
is left to the user, nothing is sent from here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rs_ov_torch.core.config import CLIPConfig
from rs_ov_torch.factory import preprocess_style
from rs_ov_torch.utils.safetensors import save_safetensors

__all__ = ["clip_state_dict", "save_for_hub", "push_to_hf_hub", "generate_readme"]

HF_SAFE_WEIGHTS_NAME = "open_clip_model.safetensors"
HF_CONFIG_NAME = "open_clip_config.json"


def _np32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _export_block(blk, pre: str, sd: dict) -> None:
    sd[pre + "ln_1.weight"] = _np32(blk.ln_1.scale)
    sd[pre + "ln_1.bias"] = _np32(blk.ln_1.bias)
    sd[pre + "attn.in_proj_weight"] = _np32(blk.attn.in_proj_w)
    sd[pre + "attn.in_proj_bias"] = _np32(blk.attn.in_proj_b)
    sd[pre + "attn.out_proj.weight"] = _np32(blk.attn.out_proj_w)
    sd[pre + "attn.out_proj.bias"] = _np32(blk.attn.out_proj_b)
    sd[pre + "ln_2.weight"] = _np32(blk.ln_2.scale)
    sd[pre + "ln_2.bias"] = _np32(blk.ln_2.bias)
    sd[pre + "mlp.c_fc.weight"] = _np32(blk.mlp.c_fc_w)
    sd[pre + "mlp.c_fc.bias"] = _np32(blk.mlp.c_fc_b)
    sd[pre + "mlp.c_proj.weight"] = _np32(blk.mlp.c_proj_w)
    sd[pre + "mlp.c_proj.bias"] = _np32(blk.mlp.c_proj_b)
    for ls in ("ls_1", "ls_2"):  # LayerScale towers: open_clip's ls_*.gamma
        if hasattr(blk, ls):
            sd[pre + f"{ls}.gamma"] = _np32(getattr(blk, ls))


def clip_state_dict(model) -> dict[str, np.ndarray]:
    """A ``CLIPModel`` (or the port's ``CLIP`` module) in open_clip's
    state-dict names, fp32 numpy on the host: the inverse of
    ``core.checkpoint.clip_params_from_state_dict``."""
    clip = getattr(model, "clip", model)
    sd: dict[str, np.ndarray] = {}
    v = clip.visual
    if not hasattr(v, "conv1_w"):
        raise NotImplementedError(
            "hub export covers the classic CLIP ViT+text tree; a timm-family tower "
            "has no open_clip export here (rs_ov/hub.py:58-61)")
    sd["visual.conv1.weight"] = _np32(v.conv1_w)
    sd["visual.class_embedding"] = _np32(v.class_embedding)
    sd["visual.positional_embedding"] = _np32(v.positional_embedding)
    sd["visual.ln_pre.weight"] = _np32(v.ln_pre.scale)
    sd["visual.ln_pre.bias"] = _np32(v.ln_pre.bias)
    for i, blk in enumerate(v.blocks):
        _export_block(blk, f"visual.transformer.resblocks.{i}.", sd)
    sd["visual.ln_post.weight"] = _np32(v.ln_post.scale)
    sd["visual.ln_post.bias"] = _np32(v.ln_post.bias)
    sd["visual.proj"] = _np32(v.proj)

    t = clip.text
    sd["token_embedding.weight"] = _np32(t.token_embedding)
    sd["positional_embedding"] = _np32(t.positional_embedding)
    for i, blk in enumerate(t.blocks):
        _export_block(blk, f"transformer.resblocks.{i}.", sd)
    sd["ln_final.weight"] = _np32(t.ln_final.scale)
    sd["ln_final.bias"] = _np32(t.ln_final.bias)
    if hasattr(t, "text_projection_b"):
        sd["text_projection.weight"] = _np32(t.text_projection).T
        sd["text_projection.bias"] = _np32(t.text_projection_b)
    else:
        sd["text_projection"] = _np32(t.text_projection)
    sd["logit_scale"] = _np32(clip.logit_scale)
    return sd


def _model_cfg_dict(cfg: CLIPConfig) -> dict:
    """CLIPConfig -> open_clip's model_configs JSON schema."""
    vis = {"image_size": cfg.vision.image_size, "layers": cfg.vision.layers,
           "width": cfg.vision.width, "patch_size": cfg.vision.patch_size}
    if cfg.vision.head_width != 64:
        vis["head_width"] = cfg.vision.head_width
    if cfg.vision.mlp_ratio != 4.0:
        vis["mlp_ratio"] = cfg.vision.mlp_ratio
    if cfg.vision.timm_model_name:
        vis.update(timm_model_name=cfg.vision.timm_model_name,
                   timm_pool=cfg.vision.timm_pool,
                   timm_proj=cfg.vision.timm_proj)
    txt = {"context_length": cfg.text.context_length,
           "vocab_size": cfg.text.vocab_size, "width": cfg.text.width,
           "heads": cfg.text.heads, "layers": cfg.text.layers}
    model_cfg = {"embed_dim": cfg.embed_dim, "vision_cfg": vis,
                 "text_cfg": txt}
    if cfg.quick_gelu:
        model_cfg["quick_gelu"] = True
    if cfg.custom_text:
        model_cfg["custom_text"] = True
    if cfg.init_logit_bias is not None:
        model_cfg["init_logit_bias"] = cfg.init_logit_bias
    return model_cfg


def save_for_hub(model, model_name: str, save_directory: str,
                 model_card: dict | None = None) -> str:
    """Write the HF-hub artifact directory (open_clip's save_for_hf and the
    README its push step adds). Returns the directory path."""
    os.makedirs(save_directory, exist_ok=True)
    sd = clip_state_dict(model)
    save_safetensors(sd, os.path.join(save_directory, HF_SAFE_WEIGHTS_NAME),
                     metadata={"format": "pt"})
    mean, std, interp, mode = preprocess_style(model_name)
    hf_config = {
        "model_cfg": _model_cfg_dict(model.cfg),
        "preprocess_cfg": {"mean": list(mean), "std": list(std),
                           "size": model.cfg.vision.image_size,
                           "interpolation": interp,
                           "resize_mode": mode},
    }
    with open(os.path.join(save_directory, HF_CONFIG_NAME), "w") as f:
        json.dump(hf_config, f, indent=2)
    readme = generate_readme(dict(model_card or {}), model_name)
    with open(os.path.join(save_directory, "README.md"), "w") as f:
        f.write(readme)
    return save_directory


def push_to_hf_hub(model, model_name: str, repo_id: str,
                   save_directory: str | None = None,
                   model_card: dict | None = None, **_ignored) -> str:
    """Stage the artifact directory, then refuse the upload: nothing is sent.
    Raises RuntimeError naming the staged path and the upload command."""
    save_directory = save_directory or os.path.join(
        os.path.expanduser("~/.cache/rs_ov_hub"), repo_id.replace("/", "_"))
    save_for_hub(model, model_name, save_directory, model_card)
    raise RuntimeError(
        f"No implicit uploads: the artifact directory is staged at "
        f"{save_directory}; upload it with `huggingface-cli upload {repo_id} "
        f"{save_directory}`.")


def generate_readme(model_card: dict, model_name: str) -> str:
    """Model-card README text (open_clip's frontmatter and sections)."""
    card = dict(model_card)
    tags = card.pop("tags", ("clip",))
    pipeline_tag = card.pop("pipeline_tag", "zero-shot-image-classification")
    lines = ["---"]
    if tags:
        lines.append("tags:")
        lines.extend(f"- {t}" for t in tags)
    lines.append("library_name: open_clip")
    lines.append(f"pipeline_tag: {pipeline_tag}")
    lines.append(f"license: {card.get('license', 'mit')}")
    details = card.get("details", {})
    if "Dataset" in details:
        lines.append("datasets:")
        lines.append(f"- {details['Dataset'].lower()}")
    lines.append("---")
    lines.append(f"# Model card for {model_name}")
    if "description" in card:
        lines += ["", card["description"]]
    if details:
        lines += ["", "## Model Details"]
        for k, v in details.items():
            if isinstance(v, (list, tuple)):
                lines.append(f"- **{k}:**")
                lines.extend(f"  - {vi}" for vi in v)
            elif isinstance(v, dict):
                lines.append(f"- **{k}:**")
                lines.extend(f"  - {ki}: {vi}" for ki, vi in v.items())
            else:
                lines.append(f"- **{k}:** {v}")
    for section in ("usage", "comparison", "citation"):
        if section in card:
            lines += ["", f"## Model {section.capitalize()}", card[section]]
    return "\n".join(lines) + "\n"
