"""BERT text encoder, the BLIP text tower (rs_ov/nn/bert.py:40-155).

Embeddings (word + position [+ token type 0], LayerNorm eps 1e-12), then
post-LN layers with separate q / k / v projections. ``encoder_hidden_states``
runs the MED 'multimodal' mode (a cross-attention over the image tokens after
each self-attention, through the layer's ``x*`` weights); ``causal`` masks
the self-attention lower-triangular, the decoder mode. Scores, softmax and
context run in fp32, one cast back to the input's dtype.

The parameters are ``nn.Module``s whose leaves carry the JAX pytree's names
(``embeddings.word``, ``layers.3.q_w``, ...), so the weight bridge is
``core.params.load_numpy_tree``. A layer's cross-attention reads encoder
states of their own width (the vision tower's for captioning); the NLVR
layers carry two such streams (``x0*`` / ``x1*``) and, from the merge layer
on, ``merge_w`` / ``merge_b``.

The KV-cached decode (rs_ov/nn/bert.py:158-252): ``bert_decode_init_cache``
allocates per-layer self K/V buffers [B, heads, max_len, dh] in the weights'
dtype and projects the cross K/V of the encoder states once;
``bert_decode_step`` writes the new token's K/V at ``pos`` and attends slots
0..pos, the tail masked at -10000 (exact fp32 zeros after the softmax, so
the step sums as the full-prefix forward does).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rs_ov_torch.core.params import LayerNorm, _p
from rs_ov_torch.nn.layers import gelu, layer_norm, linear

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertEncoder", "bert_encode",
           "bert_decode_init_cache", "bert_decode_step", "gather_cache"]

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


def _cross_names(stream: str) -> tuple:
    """The projections of one cross-attention stream: ``x`` (MED) or ``x0`` /
    ``x1`` (the NLVR twins)."""
    return (f"{stream}q", f"{stream}k", f"{stream}v", f"{stream}_out")


_CROSS = _cross_names("x")


class BertLayer(nn.Module):
    """One post-LN layer; with ``cross`` also the MED cross-attention's
    ``xq`` / ``xk`` / ``xv`` / ``x_out`` projections and ``x_ln`` over
    encoder states ``encoder_width`` wide (default: the hidden width); with
    ``twin`` the NLVR pair ``x0*`` / ``x1*`` instead, and with ``merge`` the
    [2H -> H] ``merge_w`` / ``merge_b``."""

    def __init__(self, hidden: int, inter: int, cross: bool = False,
                 encoder_width: int | None = None, twin: bool = False, merge: bool = False):
        super().__init__()
        for name in _SELF:
            setattr(self, f"{name}_w", _p(hidden, hidden))
            setattr(self, f"{name}_b", _p(hidden))
        streams = ("x0", "x1") if twin else ("x",) if cross else ()
        width = encoder_width or hidden
        for stream in streams:
            for name, w_in in zip(_cross_names(stream), (hidden, width, width, hidden)):
                setattr(self, f"{name}_w", _p(hidden, w_in))
                setattr(self, f"{name}_b", _p(hidden))
        self.attn_ln = LayerNorm(hidden)
        if streams:
            self.x_ln = LayerNorm(hidden)
        if merge:
            self.merge_w = _p(hidden, 2 * hidden)
            self.merge_b = _p(hidden)
        self.inter_w = _p(inter, hidden)
        self.inter_b = _p(inter)
        self.out_w = _p(hidden, inter)
        self.out_b = _p(hidden)
        self.out_ln = LayerNorm(hidden)


class BertEncoder(nn.Module):
    """``merge_from``: the first NLVR layer with a merge head (twin only)."""

    def __init__(self, cfg: BertConfig, cross: bool = False, token_type: bool = True,
                 encoder_width: int | None = None, twin: bool = False,
                 merge_from: int | None = None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg.vocab_size, cfg.hidden_size,
                                         cfg.max_position_embeddings, token_type)
        self.layers = nn.ModuleList(
            BertLayer(cfg.hidden_size, cfg.intermediate_size, cross, encoder_width, twin,
                      merge=twin and merge_from is not None and i >= merge_from)
            for i in range(cfg.num_layers))


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)


def _proj(layer, x, name):
    return linear(x, getattr(layer, f"{name}_w"), getattr(layer, f"{name}_b"))


def _softmax_context(q, k, v, scale: float, mask, dtype):
    """fp32 scores plus the additive mask, an fp32 softmax, the context
    [B, Lq, H] cast once to ``dtype`` (rs_ov/nn/bert.py:65-70, :205-213)."""
    attn = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + mask,
                         dim=-1)
    ctx = torch.matmul(attn, v.float())
    b, h, lq, dh = ctx.shape
    return ctx.transpose(1, 2).reshape(b, lq, h * dh).to(dtype)


def _attend(q_in, kv_in, names, layer, heads: int, scale: float, mask):
    """The projected multi-head context [B, Lq, H] before the output dense
    (rs_ov/nn/bert.py:50-70); names: the (q, k, v) prefixes."""
    qn, kn, vn = names[:3]
    q = _split_heads(_proj(layer, q_in, qn), heads)
    k = _split_heads(_proj(layer, kv_in, kn), heads)
    v = _split_heads(_proj(layer, kv_in, vn), heads)
    return _softmax_context(q, k, v, scale, mask, q_in.dtype)


def _mha(q_in, kv_in, names, layer, heads: int, scale: float, mask, eps: float):
    """Project, attend in fp32, dense, LayerNorm of the residual
    (rs_ov/nn/bert.py:73-80). names: the (q, k, v, out) prefixes and the
    LayerNorm's name."""
    names, lnn = names
    ctx = _attend(q_in, kv_in, names, layer, heads, scale, mask)
    return layer_norm(q_in + _proj(layer, ctx, names[3]), getattr(layer, lnn), eps=eps)


def _ffn(layer, x, eps: float):
    inter = linear(x, layer.inter_w, layer.inter_b, act=gelu)
    return layer_norm(x + linear(inter, layer.out_w, layer.out_b), layer.out_ln, eps=eps)


def embed(p: BertEncoder, input_ids: torch.Tensor, eps: float,
          position_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Word + position (0..L-1 unless given) + token type 0, LayerNorm."""
    emb = p.embeddings
    input_ids = input_ids.long()
    x = emb.word[input_ids]
    if position_ids is None:
        x = x + emb.position[:input_ids.shape[1]].to(x.dtype)[None]
    else:
        x = x + emb.position[position_ids.long()].to(x.dtype)
    if hasattr(emb, "token_type"):
        x = x + emb.token_type[0].to(x.dtype)
    return layer_norm(x, emb.ln, eps=eps)


def bert_encode(p: BertEncoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: BertConfig, position_ids: torch.Tensor | None = None,
                encoder_hidden_states: torch.Tensor | None = None,
                encoder_attention_mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
    """input_ids / attention_mask [B, L] -> the last hidden state [B, L, H]
    in the weights' dtype. ``position_ids`` replaces the positions 0..L-1."""
    eps = cfg.layer_norm_eps
    x = embed(p, input_ids, eps, position_ids)

    # additive masks: 0 where attended, -10000 where not (the HF convention)
    mask = (1.0 - attention_mask.float())[:, None, None, :] * -10000.0
    if causal:
        n = x.shape[1]
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
        x = _ffn(layer, x, eps)
    return x


# ---------------------------------------------------------------------------
# KV-cached incremental decoding (rs_ov/nn/bert.py:158-252)
# ---------------------------------------------------------------------------

def bert_decode_init_cache(p: BertEncoder, cfg: BertConfig, batch: int, max_len: int,
                           encoder_hidden_states: torch.Tensor | None = None,
                           dtype: torch.dtype = torch.float32) -> dict:
    """Zeroed self K/V [B, heads, max_len, dh] per layer in ``dtype``, and
    the per-layer cross K/V of ``encoder_hidden_states``, projected once."""
    heads = cfg.num_heads
    dh = cfg.hidden_size // heads
    dev = p.embeddings.word.device
    layers = []
    for layer in p.layers:
        entry = {"k": torch.zeros((batch, heads, max_len, dh), dtype=dtype, device=dev),
                 "v": torch.zeros((batch, heads, max_len, dh), dtype=dtype, device=dev)}
        if encoder_hidden_states is not None:
            enc = encoder_hidden_states.to(dtype)
            entry["xk"] = _split_heads(_proj(layer, enc, "xk"), heads)
            entry["xv"] = _split_heads(_proj(layer, enc, "xv"), heads)
        layers.append(entry)
    return {"layers": layers}


def gather_cache(cache: dict, parent: torch.Tensor) -> dict:
    """Every row of a decode cache (a dict of lists of dicts of [B, ...]
    tensors) reordered by ``parent`` [B]: beam b continues from row
    parent[b]."""
    return {part: [{k: t.index_select(0, parent) for k, t in lc.items()} for lc in layers]
            for part, layers in cache.items()}


def bert_decode_step(p: BertEncoder, token_ids: torch.Tensor, pos: int, cache: dict,
                     cfg: BertConfig, encoder_attention_mask: torch.Tensor | None = None,
                     ) -> tuple[torch.Tensor, dict]:
    """One decoder step: token_ids [B] at position ``pos`` -> (the hidden
    state [B, H] there, the cache). The new K/V are written into the
    cache's buffers at ``pos`` (in place: the caller's beam gather makes
    fresh buffers each step). ``encoder_attention_mask`` [B, Lenc] gates the
    cross-attention; None attends every encoder position."""
    eps = cfg.layer_norm_eps
    pos = int(pos)
    x = embed(p, token_ids.reshape(-1, 1), eps, torch.full(
        (1, 1), pos, dtype=torch.long, device=token_ids.device))
    max_len = cache["layers"][0]["k"].shape[2]
    slots = torch.arange(max_len, device=x.device)
    mask = torch.where(slots <= pos, 0.0, -10000.0)[None, None, None, :]
    xmask = None if encoder_attention_mask is None else \
        (1.0 - encoder_attention_mask.float())[:, None, None, :] * -10000.0
    heads = cfg.num_heads
    scale = (cfg.hidden_size // heads) ** -0.5
    for layer, lc in zip(p.layers, cache["layers"]):
        q = _split_heads(_proj(layer, x, "q"), heads)
        lc["k"][:, :, pos] = _split_heads(_proj(layer, x, "k"), heads)[:, :, 0].to(lc["k"].dtype)
        lc["v"][:, :, pos] = _split_heads(_proj(layer, x, "v"), heads)[:, :, 0].to(lc["v"].dtype)
        ctx = _softmax_context(q, lc["k"], lc["v"], scale, mask, x.dtype)
        x = layer_norm(x + _proj(layer, ctx, "attn_out"), layer.attn_ln, eps=eps)
        if "xk" in lc:
            xq = _split_heads(_proj(layer, x, "xq"), heads)
            xm = 0.0 if xmask is None else xmask
            xctx = _softmax_context(xq, lc["xk"], lc["xv"], scale, xm, x.dtype)
            x = layer_norm(x + _proj(layer, xctx, "x_out"), layer.x_ln, eps=eps)
        x = _ffn(layer, x, eps)
    return x[:, 0], cache
