"""BLIP for the segmentation path (rs_ov/nn/blip.py): the vision tower and
its projection for patch features, the BERT text tower and its projection
for the text queries, random init, and the BLIP checkpoint's names.

``Blip`` holds the JAX pytree's leaves under its names (``visual``,
``vision_proj``, ``text``, ``text_proj``; a retrieval checkpoint's
``itm_head`` and ``temp`` where present), so ``core.params.load_numpy_tree``
bridges a JAX pytree. ``blip_multimodal_features`` and ``blip_itm_score``
are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.params import _p, load_numpy_tree
from rs_ov_torch.nn.bert import BertConfig, BertEncoder, bert_encode
from rs_ov_torch.nn.blip_vit import BlipVisionConfig, BlipVisionTower, blip_vit_forward
from rs_ov_torch.nn.layers import linear

__all__ = ["BlipConfig", "Blip", "init_blip_params", "bert_params_from_state_dict",
           "blip_visual_params_from_state_dict", "blip_params_from_state_dict",
           "blip_encode_image", "blip_encode_text"]


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: BlipVisionConfig = BlipVisionConfig()
    text: BertConfig = BertConfig()
    embed_dim: int = 256

    @staticmethod
    def base(image_size: int = 224) -> "BlipConfig":
        return BlipConfig(vision=BlipVisionConfig(image_size=image_size))

    @staticmethod
    def large(image_size: int = 224) -> "BlipConfig":
        return BlipConfig(vision=BlipVisionConfig(image_size=image_size, width=1024,
                                                  layers=24, heads=16))


class Linear(nn.Module):
    def __init__(self, out_dim: int, in_dim: int):
        super().__init__()
        self.w = _p(out_dim, in_dim)
        self.b = _p(out_dim)


class Blip(nn.Module):
    """``text`` may be a ``BertEncoder`` with cross-attention layers (a
    retrieval or caption checkpoint's)."""

    def __init__(self, visual: BlipVisionTower, text: BertEncoder, embed_dim: int,
                 itm_head: bool = False, temp: bool = False):
        super().__init__()
        self.visual = visual
        self.vision_proj = Linear(embed_dim, visual.cls_token.shape[0])
        self.text = text
        self.text_proj = Linear(embed_dim, text.embeddings.word.shape[1])
        if itm_head:
            self.itm_head = Linear(2, text.embeddings.word.shape[1])
        if temp:
            self.temp = _p()


def _normal(p: nn.Parameter, gen: torch.Generator, std: float = 0.02) -> None:
    p.copy_(torch.randn(p.shape, generator=gen) * std)


@torch.no_grad()
def init_blip_params(gen: torch.Generator, cfg: BlipConfig) -> Blip:
    """Random fp32 weights on the CPU, drawn from ``gen``, with the JAX
    package's shapes and scales (rs_ov/nn/blip.py:55-150): N(0, 0.02)
    matrices and embeddings, zero biases, token types and CLS token, unit
    LayerNorms."""
    m = Blip(BlipVisionTower.from_config(cfg.vision), BertEncoder(cfg.text), cfg.embed_dim)
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "b", "cls_token", "token_type") or leaf.endswith("_b"):
            p.zero_()
        else:
            _normal(p, gen)
    return m


# ---------------------------------------------------------------------------
# BLIP checkpoint names (visual_encoder.* / text_encoder.*) -> modules
# ---------------------------------------------------------------------------

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _bert_tree(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """The JAX package's ``bert_params_from_state_dict`` pytree
    (rs_ov/nn/blip.py:159-241) as numpy arrays."""
    def a(name):
        return np.asarray(sd[name], np.float32)

    def ln(p):
        return {"scale": a(f"{p}.weight"), "bias": a(f"{p}.bias")}

    tp = prefix
    if f"{tp}.bert.embeddings.word_embeddings.weight" in sd:  # an LM-head checkpoint
        tp = f"{tp}.bert"
    n_layers = 0
    while f"{tp}.encoder.layer.{n_layers}.attention.self.query.weight" in sd:
        n_layers += 1
    emb = {"word": a(f"{tp}.embeddings.word_embeddings.weight"),
           "position": a(f"{tp}.embeddings.position_embeddings.weight"),
           "ln": ln(f"{tp}.embeddings.LayerNorm")}
    if f"{tp}.embeddings.token_type_embeddings.weight" in sd:
        emb["token_type"] = a(f"{tp}.embeddings.token_type_embeddings.weight")
    layers = []
    for i in range(n_layers):
        pre = f"{tp}.encoder.layer.{i}"
        if f"{pre}.crossattention.self0.query.weight" in sd:
            raise _not_ported("the NLVR twin cross-attention", "queue 1 item 9")
        layer = {"attn_ln": ln(f"{pre}.attention.output.LayerNorm"),
                 "inter_w": a(f"{pre}.intermediate.dense.weight"),
                 "inter_b": a(f"{pre}.intermediate.dense.bias"),
                 "out_w": a(f"{pre}.output.dense.weight"),
                 "out_b": a(f"{pre}.output.dense.bias"),
                 "out_ln": ln(f"{pre}.output.LayerNorm")}
        names = [(n, f"attention.self.{t}") for n, t in (("q", "query"), ("k", "key"),
                                                        ("v", "value"))]
        names.append(("attn_out", "attention.output.dense"))
        if f"{pre}.crossattention.self.query.weight" in sd:
            names += [(f"x{n}", f"crossattention.self.{t}") for n, t in (
                ("q", "query"), ("k", "key"), ("v", "value"))]
            names.append(("x_out", "crossattention.output.dense"))
            layer["x_ln"] = ln(f"{pre}.crossattention.output.LayerNorm")
        for n, t in names:
            layer[f"{n}_w"], layer[f"{n}_b"] = a(f"{pre}.{t}.weight"), a(f"{pre}.{t}.bias")
        layers.append(layer)
    return {"embeddings": emb, "layers": layers}


def _bert_module(tree: dict) -> BertEncoder:
    """An empty BertEncoder shaped like the pytree ``tree``."""
    word, pos = tree["embeddings"]["word"], tree["embeddings"]["position"]
    layers = tree["layers"]
    cfg = BertConfig(vocab_size=word.shape[0], hidden_size=word.shape[1],
                     num_layers=len(layers),
                     intermediate_size=layers[0]["inter_w"].shape[0] if layers else 1,
                     max_position_embeddings=pos.shape[0])
    return BertEncoder(cfg, cross=bool(layers) and "x_ln" in layers[0],
                       token_type="token_type" in tree["embeddings"])


def bert_params_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str) -> BertEncoder:
    """A BertModel subtree of a checkpoint (``{prefix}.embeddings.*``,
    ``{prefix}.encoder.layer.N.*``, under ``{prefix}.bert`` for an LM-head
    checkpoint), with the MED cross-attention where present, as an fp32
    BertEncoder on the CPU."""
    tree = _bert_tree(sd, prefix)
    return load_numpy_tree(_bert_module(tree), tree)


def _visual_tree(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """rs_ov/nn/blip.py:244-289 as numpy arrays."""
    def a(name):
        return np.asarray(sd[f"{prefix}.{name}"], np.float32)

    def ln(p):
        return {"scale": a(f"{p}.weight"), "bias": a(f"{p}.bias")}

    n_blocks = 0
    while f"{prefix}.blocks.{n_blocks}.norm1.weight" in sd:
        n_blocks += 1
    blocks = [{"norm1": ln(f"blocks.{i}.norm1"), "norm2": ln(f"blocks.{i}.norm2"),
               "attn": {"in_proj_w": a(f"blocks.{i}.attn.qkv.weight"),
                        "in_proj_b": a(f"blocks.{i}.attn.qkv.bias"),
                        "out_proj_w": a(f"blocks.{i}.attn.proj.weight"),
                        "out_proj_b": a(f"blocks.{i}.attn.proj.bias")},
               "mlp": {"c_fc_w": a(f"blocks.{i}.mlp.fc1.weight"),
                       "c_fc_b": a(f"blocks.{i}.mlp.fc1.bias"),
                       "c_proj_w": a(f"blocks.{i}.mlp.fc2.weight"),
                       "c_proj_b": a(f"blocks.{i}.mlp.fc2.bias")}}
              for i in range(n_blocks)]
    return {"patch_embed": {"w": a("patch_embed.proj.weight"), "b": a("patch_embed.proj.bias")},
            "cls_token": a("cls_token").reshape(-1), "pos_embed": a("pos_embed")[0],
            "blocks": blocks, "norm": ln("norm")}


def _visual_module(tree: dict) -> BlipVisionTower:
    w = tree["patch_embed"]["w"]
    blocks = tree["blocks"]
    return BlipVisionTower(w.shape[0], w.shape[-1], tree["pos_embed"].shape[0], len(blocks),
                           blocks[0]["mlp"]["c_fc_w"].shape[0] if blocks else 1)


def blip_visual_params_from_state_dict(sd: Mapping[str, np.ndarray],
                                       prefix: str = "visual_encoder") -> BlipVisionTower:
    """The BLIP ViT of a checkpoint (timm names under ``prefix``) as an fp32
    BlipVisionTower on the CPU."""
    tree = _visual_tree(sd, prefix)
    return load_numpy_tree(_visual_module(tree), tree)


def blip_params_from_state_dict(sd: Mapping[str, np.ndarray]) -> Blip:
    """A BLIP checkpoint (``visual_encoder.*``, ``text_encoder.*``,
    ``vision_proj``, ``text_proj``; ``itm_head`` and ``temp`` where present)
    as an fp32 Blip on the CPU (rs_ov/nn/blip.py:292-314)."""
    def a(name):
        return np.asarray(sd[name], np.float32)

    tree = {"visual": _visual_tree(sd, "visual_encoder"),
            "vision_proj": {"w": a("vision_proj.weight"), "b": a("vision_proj.bias")},
            "text": _bert_tree(sd, "text_encoder"),
            "text_proj": {"w": a("text_proj.weight"), "b": a("text_proj.bias")}}
    if "itm_head.weight" in sd:
        tree["itm_head"] = {"w": a("itm_head.weight"), "b": a("itm_head.bias")}
    if "temp" in sd:
        tree["temp"] = a("temp").reshape(())
    return blip_from_tree(tree)


def blip_from_tree(tree) -> Blip:
    """A pytree of numpy leaves in the JAX package's BLIP layout as an fp32
    Blip on the CPU, shaped by the tree (``core.params.blip_params_from_numpy``)."""
    model = Blip(_visual_module(tree["visual"]), _bert_module(tree["text"]),
                 tree["vision_proj"]["w"].shape[0], itm_head="itm_head" in tree,
                 temp="temp" in tree)
    return load_numpy_tree(model, tree)


# ---------------------------------------------------------------------------
# the segmentor's surface
# ---------------------------------------------------------------------------

def blip_encode_image(p: Blip, images: torch.Tensor, cfg: BlipConfig,
                      ignore_residual: bool = True) -> torch.Tensor:
    """images [B, 3, S, S] -> projected patch features [B, P, embed_dim]
    (rs_ov/nn/blip.py:321-329)."""
    feats = blip_vit_forward(p.visual, images, cfg.vision, ignore_residual=ignore_residual)
    return linear(feats[:, 1:], p.vision_proj.w, p.vision_proj.b)


def blip_encode_text(p: Blip, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                     cfg: BlipConfig, normalize: bool = True) -> torch.Tensor:
    """Token ids [B, L] -> the projected CLS embedding [B, embed_dim],
    L2-normalised in fp32 when ``normalize`` (rs_ov/nn/blip.py:369-381)."""
    hidden = bert_encode(p.text, input_ids, attention_mask, cfg.text)
    pooled = linear(hidden[:, 0], p.text_proj.w, p.text_proj.b)
    if normalize:
        p32 = pooled.float()
        pooled = (p32 / p32.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(pooled.dtype)
    return pooled
