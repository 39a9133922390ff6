"""Reference-named checkpoints -> the port's modules (rs_ov/core/checkpoint.py,
the open_clip, timm-named ViT and SimFeatUp loaders).

Trees (``save_pytree`` / ``load_pytree``, rs_ov/core/checkpoint.py:36-77)
are ``.npz`` files with the JAX package's layout: '/'-joined paths, '#i'
for list indices, so either package reads what the other writes.

The way from a state dict in the reference's names to the port is a pure
renaming into the JAX package's pytree layout (numpy leaves, torch's (out,
in) orientation kept), then the strict bridge ``clip_params_from_numpy`` /
``load_numpy_tree``, which raises on a missing, unused or misshapen key.
The timm-tower exports (``visual.trunk.*``: ConvNeXt, SigLIP MAP-head ViT,
EVA) and big_vision ``.npz`` files (a classic ViT, or SigLIP onto its
MAP-head tower and 'last'-pooled text tower) take the same way, and an
open_clip CoCa state dict (``coca_params_from_state_dict``, a numpy tree
for ``core.params.coca_params_from_numpy``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov_torch.core.params import (CLIP, JBUOne, JBUStack, clip_params_from_numpy,
                                     load_numpy_tree)
from rs_ov_torch.nn.timm_tower import timm_arch

__all__ = ["save_pytree", "load_pytree", "tree_to_numpy", "load_torch_state_dict", "vision_params_from_state_dict",
           "text_params_from_state_dict", "clip_params_from_state_dict",
           "infer_clip_config_from_state_dict", "jbu_params_from_state_dict",
           "detect_timm_vision_prefix", "vision_params_from_timm_state_dict",
           "timm_tower_params_from_state_dict", "vision_params_from_big_vision_npz",
           "siglip_params_from_big_vision_npz", "coca_params_from_state_dict"]


def tree_to_numpy(tree):
    """A tree of modules (``ModuleList``s as lists), dicts, lists, tensors
    and arrays as nested dicts and lists of numpy arrays, on the host; bf16
    leaves as fp32."""
    if isinstance(tree, torch.nn.ModuleList):
        return [tree_to_numpy(m) for m in tree]
    if isinstance(tree, torch.nn.Module):
        tree = {**tree._parameters, **tree._buffers, **tree._modules}
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tree)


def save_pytree(tree, path: str) -> None:
    """Save a tree (modules, dicts, lists, tensors, arrays) to ``.npz``."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}/#{i}", v)
        else:
            flat[prefix] = node

    walk("", tree_to_numpy(tree))
    np.savez(path, **flat)


def load_pytree(path: str) -> dict:
    """Inverse of ``save_pytree``: nested dicts and lists of numpy arrays."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [listify(node[f"#{i}"]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


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


# ---------------------------------------------------------------------------
# open_clip timm-tower exports: visual.trunk.* in timm's names, visual.head.*
# (rs_ov/core/checkpoint.py:313-460)
# ---------------------------------------------------------------------------

def _hwio(a) -> np.ndarray:
    """torch OIHW conv weight -> HWIO, the JAX tree's ConvNeXt layout."""
    return _f32(np.asarray(a).transpose(2, 3, 1, 0))


def _convnext_trunk(sd, t: str, arch) -> dict:
    trunk = {"stem_conv_w": _hwio(sd[t + "stem.0.weight"]),
             "stem_conv_b": _f32(sd[t + "stem.0.bias"]),
             "stem_norm": _ln(sd, t + "stem.1"),
             "head_norm": _ln(sd, t + "head.norm"),
             "stages": []}
    for i, depth in enumerate(arch.depths):
        st = {"blocks": []}
        if i > 0:
            pre = t + f"stages.{i}.downsample."
            st["downsample"] = {"norm": _ln(sd, pre + "0"),
                                "conv_w": _hwio(sd[pre + "1.weight"]),
                                "conv_b": _f32(sd[pre + "1.bias"])}
        for j in range(depth):
            pre = t + f"stages.{i}.blocks.{j}."
            st["blocks"].append({
                "conv_dw_w": _hwio(sd[pre + "conv_dw.weight"]),
                "conv_dw_b": _f32(sd[pre + "conv_dw.bias"]),
                "norm": _ln(sd, pre + "norm"),
                "fc1_w": _f32(sd[pre + "mlp.fc1.weight"]),
                "fc1_b": _f32(sd[pre + "mlp.fc1.bias"]),
                "fc2_w": _f32(sd[pre + "mlp.fc2.weight"]),
                "fc2_b": _f32(sd[pre + "mlp.fc2.bias"]),
                "gamma": _f32(sd[pre + "gamma"]),
            })
        trunk["stages"].append(st)
    return trunk


def _siglip_trunk(sd, t: str, arch) -> dict:
    n = 0
    while t + f"blocks.{n}.norm1.weight" in sd:
        n += 1
    a = t + "attn_pool."
    return {
        "patch_embed_w": _f32(sd[t + "patch_embed.proj.weight"]),
        "patch_embed_b": _f32(sd[t + "patch_embed.proj.bias"]),
        "pos_embed": _f32(sd[t + "pos_embed"]).reshape(-1, arch.width),
        "blocks": [_timm_block(sd, t + f"blocks.{i}") for i in range(n)],
        "norm": _ln(sd, t + "norm"),
        "attn_pool": {
            "latent": _f32(sd[a + "latent"]).reshape(-1, arch.width),
            **{f"{k}_{s}": _f32(sd[f"{a}{k}.{name}"])
               for k in ("q", "kv", "proj") for s, name in (("w", "weight"), ("b", "bias"))},
            "norm": _ln(sd, a + "norm"),
            "mlp": {"c_fc_w": _f32(sd[a + "mlp.fc1.weight"]),
                    "c_fc_b": _f32(sd[a + "mlp.fc1.bias"]),
                    "c_proj_w": _f32(sd[a + "mlp.fc2.weight"]),
                    "c_proj_b": _f32(sd[a + "mlp.fc2.bias"])},
        },
    }


def _eva_block(sd, pre: str, arch) -> dict:
    blk = {"ln_1": _ln(sd, pre + "norm1"), "ln_2": _ln(sd, pre + "norm2")}
    if arch.fused_qkv:
        if pre + "attn.q_bias" in sd:  # timm eva's fused qkv: no k bias
            b = np.concatenate([_f32(sd[pre + "attn.q_bias"]),
                                np.zeros(arch.width, np.float32),
                                _f32(sd[pre + "attn.v_bias"])])
        else:
            b = _f32(sd[pre + "attn.qkv.bias"])
        blk.update({"in_proj_w": _f32(sd[pre + "attn.qkv.weight"]), "in_proj_b": b})
    else:
        blk.update({"q_w": _f32(sd[pre + "attn.q_proj.weight"]),
                    "q_b": _f32(sd[pre + "attn.q_proj.bias"]),
                    "k_w": _f32(sd[pre + "attn.k_proj.weight"]),
                    "v_w": _f32(sd[pre + "attn.v_proj.weight"]),
                    "v_b": _f32(sd[pre + "attn.v_proj.bias"])})
    if arch.scale_attn_inner:
        blk["inner_norm"] = _ln(sd, pre + "attn.norm")
    blk.update({"out_proj_w": _f32(sd[pre + "attn.proj.weight"]),
                "out_proj_b": _f32(sd[pre + "attn.proj.bias"])})
    fc1 = (("fc1g", "fc1_g"), ("fc1x", "fc1_x")) if arch.swiglu else (("fc1", "fc1"),)
    m = {}
    for ours, theirs in fc1 + (("fc2", "fc2"),):
        m[f"{ours}_w"] = _f32(sd[f"{pre}mlp.{theirs}.weight"])
        m[f"{ours}_b"] = _f32(sd[f"{pre}mlp.{theirs}.bias"])
    if arch.scale_mlp:
        m["mlp_norm"] = _ln(sd, pre + "mlp.norm")
    blk["mlp"] = m
    return blk


def _eva_trunk(sd, t: str, arch) -> dict:
    w = arch.width
    return {
        "patch_embed_w": _f32(sd[t + "patch_embed.proj.weight"]),
        "patch_embed_b": _f32(sd[t + "patch_embed.proj.bias"]),
        "cls_token": _f32(sd[t + "cls_token"]).reshape(w),
        "pos_embed": _f32(sd[t + "pos_embed"]).reshape(-1, w),
        "blocks": [_eva_block(sd, t + f"blocks.{i}.", arch) for i in range(arch.depth)],
        "norm": _ln(sd, t + "norm"),
        "head_w": _f32(sd[t + "head.weight"]),
        "head_b": _f32(sd[t + "head.bias"]),
    }


def timm_tower_params_from_state_dict(sd: Mapping[str, np.ndarray], timm_model_name: str,
                                      prefix: str = "visual.") -> dict:
    """An open_clip TimmModel export (``visual.trunk.*`` in timm's names and
    the ``visual.head.*`` adapter head) as the JAX tree of the ConvNeXt /
    SigLIP-ViT / EVA tower: {'trunk': ..., 'head': ...} with numpy leaves,
    ConvNeXt's conv weights HWIO. A missing key raises ``KeyError``; an EVA
    ``k`` projection gets no bias."""
    arch = timm_arch(timm_model_name)
    t = prefix + "trunk."
    trunk = {"convnext": _convnext_trunk, "siglip_vit": _siglip_trunk,
             "eva": _eva_trunk}[arch.family](sd, t, arch)
    tree = {"trunk": trunk}
    h = prefix + "head."
    if h + "proj.weight" in sd:
        tree["head"] = {"proj_w": _f32(sd[h + "proj.weight"])}
        if h + "proj.bias" in sd:
            tree["head"]["proj_b"] = _f32(sd[h + "proj.bias"])
    elif h + "mlp.fc1.weight" in sd:
        tree["head"] = {"mlp": {"c_fc_w": _f32(sd[h + "mlp.fc1.weight"]),
                                "c_fc_b": _f32(sd[h + "mlp.fc1.bias"]),
                                "c_proj_w": _f32(sd[h + "mlp.fc2.weight"]),
                                "c_proj_b": _f32(sd[h + "mlp.fc2.bias"])}}
    return tree


def _clip_tree(sd: Mapping[str, np.ndarray], timm_model_name: str | None = None) -> dict:
    """An open_clip-named CLIP state dict, one whose vision tower has timm's
    ViT names, or, with ``timm_model_name``, an open_clip timm-tower export,
    as the JAX pytree layout (rs_ov/core/checkpoint.py:462-482)."""
    if timm_model_name and ("visual.trunk.stem.0.weight" in sd
                            or "visual.trunk.patch_embed.proj.weight" in sd):
        visual = timm_tower_params_from_state_dict(sd, timm_model_name)
    elif "visual.conv1.weight" in sd:
        visual = vision_params_from_state_dict(sd, "visual.")
    else:
        visual = vision_params_from_timm_state_dict(sd)
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
    key raises. A ``cfg`` with ``timm_model_name`` reads a ``visual.trunk.*``
    timm-tower export."""
    tree = _clip_tree(sd, getattr(cfg.vision, "timm_model_name", None) if cfg else None)
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


# ---------------------------------------------------------------------------
# big_vision .npz checkpoints (rs_ov/core/checkpoint.py:545-765)
# ---------------------------------------------------------------------------

def _npz_finder(path: str, prefixes: tuple[str, ...]):
    """find(*names): the first of ``names`` under the first of ``prefixes``
    that the .npz at ``path`` holds, as fp32; KeyError when none is."""
    w = np.load(path)

    def find(*names) -> np.ndarray:
        for n in names:
            for prefix in prefixes:
                if prefix + n in w:
                    return _f32(w[prefix + n])
        raise KeyError(f"none of {names} in {path}")

    return find


def _bv_blocks(find, stacks: tuple[str, ...], width: int) -> list:
    """big_vision's encoderblock_i stack, under the first of ``stacks`` that
    has one (Transformer/ for a vision tower, Encoder_0/ for a text tower),
    as blocks with q / k / v fused."""
    stack = stacks[-1]
    for cand in stacks[:-1]:
        try:
            find(cand + "/encoderblock_0/LayerNorm_0/scale")
        except KeyError:
            continue
        stack = cand
        break
    blocks = []
    while True:
        pre = f"{stack}/encoderblock_{len(blocks)}/"
        try:
            ln1s = find(pre + "LayerNorm_0/scale")
        except KeyError:
            break
        a = pre + "MultiHeadDotProductAttention_1/"
        try:
            find(a + "query/kernel")
        except KeyError:
            a = pre + "MultiHeadDotProductAttention_0/"
        q, k, v = (find(a + f"{n}/kernel").reshape(width, -1) for n in ("query", "key", "value"))

        def ln2(leaf):
            return find(pre + f"LayerNorm_1/{leaf}", pre + f"LayerNorm_2/{leaf}")

        def dense(i, leaf):
            x = find(pre + f"MlpBlock_3/Dense_{i}/{leaf}")
            return np.ascontiguousarray(x.T) if leaf == "kernel" else x

        blocks.append({
            "ln_1": {"scale": ln1s, "bias": find(pre + "LayerNorm_0/bias")},
            "attn": {"in_proj_w": np.concatenate([q.T, k.T, v.T], 0),
                     "in_proj_b": np.concatenate([find(a + f"{n}/bias").reshape(-1)
                                                  for n in ("query", "key", "value")]),
                     "out_proj_w": np.ascontiguousarray(
                         find(a + "out/kernel").reshape(-1, width).T),
                     "out_proj_b": find(a + "out/bias")},
            "ln_2": {"scale": ln2("scale"), "bias": ln2("bias")},
            "mlp": {"c_fc_w": dense(0, "kernel"), "c_fc_b": dense(0, "bias"),
                    "c_proj_w": dense(1, "kernel"), "c_proj_b": dense(1, "bias")},
        })
    return blocks


def vision_params_from_big_vision_npz(path: str) -> dict:
    """A big_vision ViT (``params/img/...`` names) as the classic ViT tree:
    the embedding conv, the CLS token (zeros, and a zero pos-embed row, for
    a CLS-less tower), the encoder blocks with q / k / v fused, the encoder
    norm as ``ln_post``, ``head/kernel`` (else the identity) as ``proj``,
    an identity ``ln_pre``."""
    find = _npz_finder(path, ("params/img/", "img/", ""))
    emb_k = find("embedding/kernel")  # [ph, pw, 3, width]
    width = emb_k.shape[-1]
    pos = find("Transformer/posembed_input/pos_embedding")[0]
    try:
        cls = find("cls")[0, 0]
    except KeyError:
        cls = np.zeros(width, np.float32)
        pos = np.concatenate([np.zeros((1, width), np.float32), pos], axis=0)
    try:
        proj = find("head/kernel")
    except KeyError:
        proj = np.eye(width, dtype=np.float32)
    return {
        "conv1_w": np.ascontiguousarray(emb_k.transpose(3, 2, 0, 1)),
        "class_embedding": cls,
        "positional_embedding": pos,
        "ln_pre": _identity_ln(width),
        "blocks": _bv_blocks(find, ("Transformer",), width),
        "ln_post": {"scale": find("Transformer/encoder_norm/scale"),
                    "bias": find("Transformer/encoder_norm/bias")},
        "proj": proj,
    }


def siglip_params_from_big_vision_npz(path: str) -> dict:
    """A big_vision SigLIP .npz onto the SigLIP towers: the CLS-less MAP-head
    vision trunk and the 'last'-pooled text tower. Returns the JAX tree
    {'visual': {'trunk': ...}, 'text': ..., 'logit_scale', 'logit_bias'}
    (the last two where the file has ``t`` and ``b``)."""
    f = _npz_finder(path, ("params/", ""))
    emb_k = f("img/embedding/kernel")
    width = emb_k.shape[-1]
    m = "img/MAPHead_0/"
    mha = m + "MultiHeadDotProductAttention_0/"
    q_k, k_k, v_k = (f(mha + f"{n}/kernel").reshape(width, -1)
                     for n in ("query", "key", "value"))

    def dense(i, leaf):
        x = f(m + f"MlpBlock_0/Dense_{i}/{leaf}")
        return np.ascontiguousarray(x.T) if leaf == "kernel" else x

    trunk = {
        "patch_embed_w": np.ascontiguousarray(emb_k.transpose(3, 2, 0, 1)),
        "patch_embed_b": f("img/embedding/bias"),
        "pos_embed": f("img/Transformer/posembed_input/pos_embedding")[0],
        "blocks": _bv_blocks(f, ("img/Transformer", "img/Encoder_0"), width),
        "norm": {"scale": f("img/Transformer/encoder_norm/scale"),
                 "bias": f("img/Transformer/encoder_norm/bias")},
        "attn_pool": {
            "latent": f(m + "probe")[0],
            "q_w": np.ascontiguousarray(q_k.T),
            "q_b": f(mha + "query/bias").reshape(-1),
            "kv_w": np.concatenate([k_k.T, v_k.T], 0),
            "kv_b": np.concatenate([f(mha + "key/bias").reshape(-1),
                                    f(mha + "value/bias").reshape(-1)]),
            "proj_w": np.ascontiguousarray(f(mha + "out/kernel").reshape(-1, width).T),
            "proj_b": f(mha + "out/bias"),
            "norm": {"scale": f(m + "LayerNorm_0/scale"), "bias": f(m + "LayerNorm_0/bias")},
            "mlp": {"c_fc_w": dense(0, "kernel"), "c_fc_b": dense(0, "bias"),
                    "c_proj_w": dense(1, "kernel"), "c_proj_b": dense(1, "bias")},
        },
    }
    t_width = f("txt/Embed_0/embedding").shape[-1]
    text = {
        "token_embedding": f("txt/Embed_0/embedding"),
        "positional_embedding": f("txt/pos_embedding")[0],
        "blocks": _bv_blocks(f, ("txt/Transformer", "txt/Encoder_0"), t_width),
        "ln_final": {"scale": f("txt/Encoder_0/encoder_norm/scale",
                                "txt/Transformer/encoder_norm/scale"),
                     "bias": f("txt/Encoder_0/encoder_norm/bias",
                               "txt/Transformer/encoder_norm/bias")},
        "text_projection": f("txt/head/kernel"),
        "text_projection_b": f("txt/head/bias"),
    }
    tree = {"visual": {"trunk": trunk}, "text": text}
    try:
        tree["logit_scale"] = f("t").reshape(())
        tree["logit_bias"] = f("b").reshape(())
    except KeyError:
        pass
    return tree


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


def coca_params_from_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """An open_clip CoCa state dict (``visual.*`` with ``attn_pool``,
    ``text.*`` with ``cls_emb`` or an HF tower at ``text.transformer.*`` /
    ``text.proj.*``, ``text_decoder.*``) as the JAX package's CoCa pytree
    with fp32 numpy leaves (rs_ov/core/checkpoint.py:810-858)."""
    def pool(prefix):
        return {"query": _f32(sd[f"{prefix}.query"]), "ln_q": _ln(sd, f"{prefix}.ln_q"),
                "ln_k": _ln(sd, f"{prefix}.ln_k"),
                "q_proj_w": _f32(sd[f"{prefix}.attn.q_proj_weight"]),
                "k_proj_w": _f32(sd[f"{prefix}.attn.k_proj_weight"]),
                "v_proj_w": _f32(sd[f"{prefix}.attn.v_proj_weight"]),
                "in_proj_b": _f32(sd[f"{prefix}.attn.in_proj_bias"]),
                "out_proj_w": _f32(sd[f"{prefix}.attn.out_proj.weight"]),
                "out_proj_b": _f32(sd[f"{prefix}.attn.out_proj.bias"])}

    visual = vision_params_from_state_dict(sd, prefix="visual.")
    visual["attn_pool"] = pool("visual.attn_pool")
    if "text.transformer.embeddings.word_embeddings.weight" in sd:
        from rs_ov_torch.nn.hf_text import _hf_text_tree

        text = _hf_text_tree(sd, prefix="text.")
    else:
        text = text_params_from_state_dict(sd, prefix="text.")
        text["cls_emb"] = _f32(sd["text.cls_emb"])
    n = _count_blocks(sd, "text_decoder.resblocks")
    cross = []
    for i in range(n):
        blk = _block(sd, f"text_decoder.cross_attn.{i}")
        blk["ln_1_kv"] = _ln(sd, f"text_decoder.cross_attn.{i}.ln_1_kv")
        cross.append(blk)
    multimodal = {"blocks": [_block(sd, f"text_decoder.resblocks.{i}") for i in range(n)],
                  "cross_blocks": cross, "ln_final": _ln(sd, "text_decoder.ln_final"),
                  "text_projection": _f32(sd["text_decoder.text_projection"])}
    return {"visual": visual, "text": text, "multimodal": multimodal,
            "logit_scale": _f32(sd["logit_scale"])}
