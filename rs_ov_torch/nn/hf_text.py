"""HuggingFace-style text towers (RoBERTa / BERT family), rs_ov/nn/hf_text.py.

The encoder is the port's BERT stack (``nn.bert.bert_encode``) with the
architecture's LayerNorm eps and position ids (RoBERTa counts only the
non-pad tokens, offset past the pad id; BERT takes 0..L-1), then open_clip's
pooler and a bias-free projection.

Poolers: ``mean_pooler`` the masked mean; ``max_pooler`` the masked max —
the reference's MaxPooler fills the *valid* positions with -inf, an evident
bug no config exercises, so the pads are masked out instead, as in the JAX
package; ``cls_pooler`` the tanh dense pooler where the checkpoint has one,
else the CLS hidden state; ``cls_last_hidden_state_pooler`` the CLS hidden
state. Projections: 'linear' one bias-free Linear, 'mlp' Linear -> GELU ->
Linear, both bias-free.

The parameters are a module tree with the JAX pytree's names
(``transformer.embeddings.word``, ``pooler.w``, ``proj.w0``, ...), so a JAX
tree crosses with ``core.params.module_from_tree``. CoCa's HF-text variant
(coca_roberta-ViT-B-32, ``nn.coca``) is the one model that builds it.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.params import _p, module_from_tree
from rs_ov_torch.nn.bert import BertConfig, BertEncoder, bert_encode
from rs_ov_torch.nn.layers import gelu, linear

__all__ = ["HFTextConfig", "HFTextTower", "hf_text_config", "hf_text_encode",
           "init_hf_text_params", "hf_text_params_from_state_dict"]

# the reference's hf_configs.py arch_dict: default pooler, pad id and eps
_ARCH = {
    "roberta": dict(pooler="mean_pooler", pad_token_id=1, layer_norm_eps=1e-5),
    "xlm-roberta": dict(pooler="mean_pooler", pad_token_id=1, layer_norm_eps=1e-5),
    "bert": dict(pooler="cls_pooler", pad_token_id=0, layer_norm_eps=1e-12),
}


@dataclasses.dataclass(frozen=True)
class HFTextConfig:
    model_type: str = "roberta"
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    output_dim: int = 512
    pooler_type: str = "mean_pooler"
    proj_type: Optional[str] = None  # None | 'linear' | 'mlp'

    @property
    def bert(self) -> BertConfig:
        return BertConfig(vocab_size=self.vocab_size, hidden_size=self.hidden_size,
                          num_layers=self.num_layers, num_heads=self.num_heads,
                          intermediate_size=self.intermediate_size,
                          max_position_embeddings=self.max_position_embeddings,
                          layer_norm_eps=self.layer_norm_eps)


class HFTextTower(nn.Module):
    """The tree of ``init_hf_text_params``, its leaves uninitialised: the
    BERT stack under ``transformer``, ``pooler`` for 'cls_pooler', ``proj``
    by ``proj_type``. A checkpoint's tree, whose shapes may differ (RoBERTa's
    one token type), loads through ``module_from_tree`` instead."""

    def __init__(self, cfg: HFTextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.transformer = BertEncoder(cfg.bert)
        if cfg.pooler_type == "cls_pooler":
            self.pooler = nn.Module()
            self.pooler.w, self.pooler.b = _p(h, h), _p(h)
        if cfg.proj_type == "linear":
            self.proj = nn.Module()
            self.proj.w = _p(cfg.output_dim, h)
        elif cfg.proj_type == "mlp":
            mid = (h + cfg.output_dim) // 2
            self.proj = nn.Module()
            self.proj.w0, self.proj.w1 = _p(mid, h), _p(cfg.output_dim, mid)


def hf_text_config(model_name: str, output_dim: int,
                   proj_type: Optional[str] = None) -> HFTextConfig:
    """The config of an HF name the model configs reach (tabulated: nothing
    is fetched)."""
    known = {
        "roberta-base": dict(model_type="roberta"),
        "roberta-large": dict(model_type="roberta", hidden_size=1024, num_layers=24,
                              num_heads=16, intermediate_size=4096),
        "xlm-roberta-base": dict(model_type="xlm-roberta", vocab_size=250002),
        "xlm-roberta-large": dict(model_type="xlm-roberta", vocab_size=250002,
                                  hidden_size=1024, num_layers=24, num_heads=16,
                                  intermediate_size=4096),
        "bert-base-uncased": dict(model_type="bert", vocab_size=30522,
                                  max_position_embeddings=512),
    }
    if model_name not in known:
        raise NotImplementedError(
            f"HF text tower '{model_name}' is not tabulated (known: {sorted(known)}; "
            "encoder-decoder archs like mt5/m2m_100 are out of scope).")
    kw = dict(known[model_name])
    arch = _ARCH[kw["model_type"]]
    kw.setdefault("pad_token_id", arch["pad_token_id"])
    kw.setdefault("layer_norm_eps", arch["layer_norm_eps"])
    return HFTextConfig(output_dim=output_dim, pooler_type=arch["pooler"],
                        proj_type=proj_type, **kw)


def _position_ids(input_ids: torch.Tensor, cfg: HFTextConfig) -> Optional[torch.Tensor]:
    """RoBERTa's create_position_ids_from_input_ids; None (0..L-1) for BERT."""
    if cfg.model_type in ("roberta", "xlm-roberta"):
        mask = (input_ids != cfg.pad_token_id).long()
        return torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
    return None


def _pool(hidden: torch.Tensor, mask: torch.Tensor, p, cfg: HFTextConfig) -> torch.Tensor:
    m = mask.float()[..., None]
    if cfg.pooler_type == "mean_pooler":
        return ((hidden.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)).to(hidden.dtype)
    if cfg.pooler_type == "max_pooler":
        neg = torch.where(m > 0, hidden.float(), torch.tensor(-torch.inf, device=m.device))
        return neg.amax(1).to(hidden.dtype)
    if cfg.pooler_type == "cls_pooler":
        if hasattr(p, "pooler"):
            return torch.tanh(linear(hidden[:, 0], p.pooler.w, p.pooler.b))
        return hidden[:, 0]
    if cfg.pooler_type == "cls_last_hidden_state_pooler":
        return hidden[:, 0]
    raise ValueError(f"Unknown pooler '{cfg.pooler_type}' (reference hf_model.py _POOLERS)")


def _project(pooled: torch.Tensor, p, cfg: HFTextConfig) -> torch.Tensor:
    if not hasattr(p, "proj"):
        return pooled
    if cfg.proj_type == "linear":
        return linear(pooled, p.proj.w)
    return linear(linear(pooled, p.proj.w0, act=gelu), p.proj.w1)


def hf_text_encode(p: nn.Module, input_ids, cfg: HFTextConfig, output_tokens: bool = False):
    """ids [B, L] -> projected [B, output_dim]: the attention mask from the
    pad id, pool, project; with ``output_tokens`` also the token features
    (without the CLS position under ``cls_pooler``)."""
    ids = torch.as_tensor(input_ids).to(p.transformer.embeddings.word.device).long()
    mask = (ids != cfg.pad_token_id).long()
    hidden = bert_encode(p.transformer, ids, mask, cfg.bert,
                         position_ids=_position_ids(ids, cfg))
    projected = _project(_pool(hidden, mask, p, cfg), p, cfg)
    if not output_tokens:
        return projected
    return projected, (hidden[:, 1:] if cfg.pooler_type == "cls_pooler" else hidden)


def init_hf_text_params(gen: torch.Generator, cfg: HFTextConfig) -> nn.Module:
    """Random fp32 weights on the CPU from ``gen`` with the JAX init's
    shapes and scales (rs_ov/nn/hf_text.py:173-209): N(0, 0.02) matrices and
    embeddings, zero biases and token types, unit LayerNorms."""
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def lin(o, i):
        return (torch.randn(o, i, generator=gen) * 0.02).numpy()

    def ln(n):
        return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}

    def layer():
        out = {}
        for name in ("q", "k", "v", "attn_out"):
            out[f"{name}_w"], out[f"{name}_b"] = lin(h, h), np.zeros(h, np.float32)
        out.update(attn_ln=ln(h), inter_w=lin(inter, h), inter_b=np.zeros(inter, np.float32),
                   out_w=lin(h, inter), out_b=np.zeros(h, np.float32), out_ln=ln(h))
        return out

    tree = {"transformer": {
        "embeddings": {"word": lin(cfg.vocab_size, h),
                       "position": lin(cfg.max_position_embeddings, h),
                       "token_type": np.zeros((2, h), np.float32), "ln": ln(h)},
        "layers": [layer() for _ in range(cfg.num_layers)]}}
    if cfg.pooler_type == "cls_pooler":
        tree["pooler"] = {"w": lin(h, h), "b": np.zeros(h, np.float32)}
    if cfg.proj_type == "linear":
        tree["proj"] = {"w": lin(cfg.output_dim, h)}
    elif cfg.proj_type == "mlp":
        mid = (h + cfg.output_dim) // 2
        tree["proj"] = {"w0": lin(mid, h), "w1": lin(cfg.output_dim, mid)}
    elif cfg.proj_type is None and h != cfg.output_dim:
        raise ValueError(f"hidden_size {h} != output_dim {cfg.output_dim} requires "
                         "proj_type 'linear' or 'mlp' (reference hf_model.py:144-154)")
    return module_from_tree(tree)


def _hf_text_tree(sd: Mapping[str, np.ndarray], cfg: Optional[HFTextConfig] = None,
                  prefix: str = "") -> dict:
    """An HF transformers state dict as the JAX pytree (numpy leaves)."""
    def a(name):
        return np.asarray(sd[name], np.float32)

    def ln(stem):
        return {"scale": a(f"{stem}.weight"), "bias": a(f"{stem}.bias")}

    tp = next((f"{enc}{base}" for enc in (f"{prefix}transformer.", prefix)
               for base in ("", "roberta.", "bert.", "xlm-roberta.")
               if f"{enc}{base}embeddings.word_embeddings.weight" in sd), None)
    if tp is None:
        raise KeyError(f"No HF text encoder found under prefix '{prefix}' "
                       "(looked for [transformer.][roberta.|bert.]embeddings.*)")
    emb = {"word": a(f"{tp}embeddings.word_embeddings.weight"),
           "position": a(f"{tp}embeddings.position_embeddings.weight"),
           "ln": ln(f"{tp}embeddings.LayerNorm")}
    if f"{tp}embeddings.token_type_embeddings.weight" in sd:
        emb["token_type"] = a(f"{tp}embeddings.token_type_embeddings.weight")
    names = (("q", "attention.self.query"), ("k", "attention.self.key"),
             ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
             ("inter", "intermediate.dense"), ("out", "output.dense"))
    layers = []
    while f"{tp}encoder.layer.{len(layers)}.attention.self.query.weight" in sd:
        pre = f"{tp}encoder.layer.{len(layers)}"
        layer = {"attn_ln": ln(f"{pre}.attention.output.LayerNorm"),
                 "out_ln": ln(f"{pre}.output.LayerNorm")}
        for ours, theirs in names:
            layer[f"{ours}_w"] = a(f"{pre}.{theirs}.weight")
            layer[f"{ours}_b"] = a(f"{pre}.{theirs}.bias")
        layers.append(layer)
    if cfg is not None and len(layers) != cfg.num_layers:
        raise ValueError(f"state dict has {len(layers)} encoder layers, config expects "
                         f"{cfg.num_layers}")
    tree = {"transformer": {"embeddings": emb, "layers": layers}, "pooler": None, "proj": None}
    if f"{tp}pooler.dense.weight" in sd:
        tree["pooler"] = {"w": a(f"{tp}pooler.dense.weight"), "b": a(f"{tp}pooler.dense.bias")}
    if f"{prefix}proj.weight" in sd:  # nn.Linear(d, out, bias=False)
        tree["proj"] = {"w": a(f"{prefix}proj.weight")}
    elif f"{prefix}proj.0.weight" in sd:  # the mlp Sequential
        tree["proj"] = {"w0": a(f"{prefix}proj.0.weight"), "w1": a(f"{prefix}proj.2.weight")}
    return tree


def hf_text_params_from_state_dict(sd: Mapping[str, np.ndarray],
                                   cfg: Optional[HFTextConfig] = None,
                                   prefix: str = "") -> nn.Module:
    """An HF transformers state dict (a saved RobertaModel / BertModel,
    under ``roberta.`` / ``bert.`` too, or an HFTextEncoder at ``prefix``,
    its tower at ``{prefix}transformer.*`` and ``{prefix}proj.*``) as a CPU
    fp32 module."""
    return module_from_tree(_hf_text_tree(sd, cfg, prefix))
