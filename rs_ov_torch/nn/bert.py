"""BERT text encoder, the BLIP text tower (rs_ov/nn/bert.py:40-155).

Embeddings (word + position [+ token type 0], LayerNorm eps 1e-12), then
post-LN layers with separate q / k / v projections. ``encoder_hidden_states``
runs the MED 'multimodal' mode (a cross-attention over the image tokens after
each self-attention, through the layer's ``x*`` weights); ``causal`` masks
the self-attention lower-triangular, the decoder mode. Scores, softmax and
context run in fp32, one cast back to the input's dtype.

The parameters are ``nn.Module``s whose leaves carry the JAX pytree's names
(``embeddings.word``, ``layers.3.q_w``, ...), so the weight bridge is
``core.params.load_numpy_tree``. The KV-cached decode (rs_ov/nn/bert.py:158-252)
is ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rs_ov_torch.core.params import LayerNorm, _p
from rs_ov_torch.nn.layers import gelu, layer_norm, linear

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertEncoder", "bert_encode"]

_LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = _LN_EPS


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, max_pos: int, token_type: bool = True):
        super().__init__()
        self.word = _p(vocab, hidden)
        self.position = _p(max_pos, hidden)
        if token_type:
            self.token_type = _p(2, hidden)
        self.ln = LayerNorm(hidden)


_SELF = ("q", "k", "v", "attn_out")
_CROSS = ("xq", "xk", "xv", "x_out")


class BertLayer(nn.Module):
    """One post-LN layer; with ``cross`` also the MED cross-attention's
    ``xq`` / ``xk`` / ``xv`` / ``x_out`` projections and ``x_ln``."""

    def __init__(self, hidden: int, inter: int, cross: bool = False):
        super().__init__()
        for name in _SELF + (_CROSS if cross else ()):
            setattr(self, f"{name}_w", _p(hidden, hidden))
            setattr(self, f"{name}_b", _p(hidden))
        self.attn_ln = LayerNorm(hidden)
        if cross:
            self.x_ln = LayerNorm(hidden)
        self.inter_w = _p(inter, hidden)
        self.inter_b = _p(inter)
        self.out_w = _p(hidden, inter)
        self.out_b = _p(hidden)
        self.out_ln = LayerNorm(hidden)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, cross: bool = False, token_type: bool = True):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg.vocab_size, cfg.hidden_size,
                                         cfg.max_position_embeddings, token_type)
        self.layers = nn.ModuleList(BertLayer(cfg.hidden_size, cfg.intermediate_size, cross)
                                    for _ in range(cfg.num_layers))


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)


def _mha(q_in, kv_in, names, layer, heads: int, scale: float, mask, eps: float):
    """Project, attend in fp32, dense, LayerNorm of the residual
    (rs_ov/nn/bert.py:50-80). names: the (q, k, v, out) prefixes and the
    LayerNorm's name."""
    (qn, kn, vn, on), lnn = names
    b, lq, h = q_in.shape

    def proj(x, n):
        return linear(x, getattr(layer, f"{n}_w"), getattr(layer, f"{n}_b"))

    q = _split_heads(proj(q_in, qn), heads).float()
    k = _split_heads(proj(kv_in, kn), heads).float()
    v = _split_heads(proj(kv_in, vn), heads).float()
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale + mask, dim=-1)
    ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, h).to(q_in.dtype)
    return layer_norm(q_in + proj(ctx, on), getattr(layer, lnn), eps=eps)


def bert_encode(p: BertEncoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: BertConfig, position_ids: torch.Tensor | None = None,
                encoder_hidden_states: torch.Tensor | None = None,
                encoder_attention_mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
    """input_ids / attention_mask [B, L] -> the last hidden state [B, L, H]
    in the weights' dtype. ``position_ids`` replaces the positions 0..L-1."""
    eps = cfg.layer_norm_eps
    emb = p.embeddings
    input_ids = input_ids.long()
    x = emb.word[input_ids]
    if position_ids is None:
        x = x + emb.position[:input_ids.shape[1]].to(x.dtype)[None]
    else:
        x = x + emb.position[position_ids.long()].to(x.dtype)
    if hasattr(emb, "token_type"):
        x = x + emb.token_type[0].to(x.dtype)
    x = layer_norm(x, emb.ln, eps=eps)

    # additive masks: 0 where attended, -10000 where not (the HF convention)
    mask = (1.0 - attention_mask.float())[:, None, None, :] * -10000.0
    if causal:
        n = input_ids.shape[1]
        tri = torch.tril(torch.ones((n, n), device=x.device))
        mask = mask + (1.0 - tri)[None, None] * -10000.0
    if encoder_hidden_states is not None:
        xmask = (torch.zeros((x.shape[0], 1, 1, encoder_hidden_states.shape[1]), device=x.device)
                 if encoder_attention_mask is None else
                 (1.0 - encoder_attention_mask.float())[:, None, None, :] * -10000.0)
    heads = cfg.num_heads
    scale = (cfg.hidden_size // heads) ** -0.5
    for layer in p.layers:
        x = _mha(x, x, (_SELF, "attn_ln"), layer, heads, scale, mask, eps)
        if encoder_hidden_states is not None:
            x = _mha(x, encoder_hidden_states.to(x.dtype), (_CROSS, "x_ln"), layer, heads,
                     scale, xmask, eps)
        inter = gelu(linear(x, layer.inter_w, layer.inter_b))
        x = layer_norm(x + linear(inter, layer.out_w, layer.out_b), layer.out_ln, eps=eps)
    return x
