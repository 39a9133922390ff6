"""CoCa (Contrastive Captioner) on the port (rs_ov/nn/coca.py).

- ``attentional_pool``: learned queries over the image tokens, with separate
  q / k / v projections (k and v ``ctx_dim`` wide) and one fused bias.
- The vision tower: a ViT trunk, then the attentional pool, ``ln_post``, and
  the first token / the rest through the square ``proj``.
- The text tower: a learned CLS appended at the END of the sequence, a
  pad-aware mask on the CLS row added to the causal mask, ``ln_final`` after
  pooling the last token, the tokens returned un-normed; a config with
  ``hf_model_name`` takes the HF tower (``nn.hf_text``) instead.
- The multimodal decoder: per layer a causal self-attention block, then a
  cross-attention block over ``ln_1_kv`` of the image tokens, then
  ``ln_final`` and the [width, vocab] projection.
- ``coca_generate``: a plain length-normalised beam search (``min_seq_len``
  counted on the sequence), or top-k / top-p sampling from an explicit
  ``np.random.RandomState(seed)``, on float64 host logits. It decodes on the
  KV-cached step (``make_coca_cached_decoder``) unless the text tower is an
  HF one or ``seq_len`` passes the context, where the full prefix runs
  again each step, with the JAX package's sliding window.

The parameters are ``core.params.CoCa`` (the JAX pytree's names).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rs_ov_torch.core.config import CoCaConfig, MultimodalConfig
from rs_ov_torch.core.params import CoCa, init_coca_params
from rs_ov_torch.nn.attention import _bmm, _merge_heads, _softmax32, _split_heads, \
    standard_attention
from rs_ov_torch.nn.bert import gather_cache as _gather_cache
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, mlp, quick_gelu
from rs_ov_torch.nn.vit import _patchify
from rs_ov_torch.text.encoder import causal_mask

__all__ = ["MultimodalConfig", "CoCaConfig", "attentional_pool", "coca_encode_image",
           "coca_encode_text", "multimodal_decoder", "coca_forward", "coca_generate",
           "init_coca_params", "coca_decode_init_cache", "coca_decode_step",
           "make_coca_cached_decoder"]


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 / x32.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(x.dtype)


def _act(cfg: CoCaConfig):
    return quick_gelu if cfg.quick_gelu else gelu


def _block(blk, x, heads, act, mask=None):
    x = x + standard_attention(blk.attn, layer_norm(x, blk.ln_1), heads, mask=mask)[0]
    return x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)


def attentional_pool(p, x: torch.Tensor, heads: int) -> torch.Tensor:
    """x [B, L, ctx_dim] -> [B, n_queries, d_model] (rs_ov/nn/coca.py:97-115)."""
    d_model = p.query.shape[-1]
    k_in = layer_norm(x, p.ln_k)
    q_in = layer_norm(p.query, p.ln_q)
    bq, bk, bv = p.in_proj_b.chunk(3)
    q = linear(q_in, p.q_proj_w, bq)[None]
    k = linear(k_in, p.k_proj_w, bk)
    v = linear(k_in, p.v_proj_w, bv)
    q = _split_heads(q.expand(x.shape[0], *q.shape[1:]), heads)
    k, v = _split_heads(k, heads), _split_heads(v, heads)
    scale = (d_model // heads) ** -0.5
    attn = _softmax32(_bmm(q * scale, k.transpose(-1, -2)))
    out = _merge_heads(_bmm(attn, v.float()).to(x.dtype))
    return linear(out, p.out_proj_w, p.out_proj_b)


def coca_encode_image(p: CoCa, images: torch.Tensor, cfg: CoCaConfig, normalize: bool = True):
    """[B, 3, H, W] -> (image_latent [B, D], image_embs [B, n_queries - 1, D])."""
    v, vcfg = p.visual, cfg.vision
    act = _act(cfg)
    x = _patchify(images, v.conv1_w)
    cls = v.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(x.dtype)[None]
    x = layer_norm(x, v.ln_pre)
    for blk in v.blocks:
        x = _block(blk, x, vcfg.heads, act)
    x = layer_norm(attentional_pool(v.attn_pool, x, cfg.attn_pooler_heads), v.ln_post)
    pooled = x[:, 0] @ v.proj.to(x.dtype)
    tokens = x[:, 1:] @ v.proj.to(x.dtype)
    return (_l2norm(pooled) if normalize else pooled), tokens


def _hf_config(cfg: CoCaConfig):
    from rs_ov_torch.nn.hf_text import hf_text_config

    return hf_text_config(cfg.text.hf_model_name, output_dim=cfg.embed_dim,
                          proj_type=cfg.text.hf_proj_type)


def coca_encode_text(p: CoCa, text_ids: torch.Tensor, cfg: CoCaConfig, normalize: bool = True):
    """int [B, L] -> (text_latent [B, D], token_embs [B, L, width], un-normed)
    (rs_ov/nn/coca.py:153-205); an HF text tower for a config with
    ``hf_model_name``."""
    t, tcfg = p.text, cfg.text
    text_ids = text_ids.long()
    if tcfg.hf_model_name:
        from rs_ov_torch.nn.hf_text import hf_text_encode

        pooled, tokens = hf_text_encode(t, text_ids, _hf_config(cfg), output_tokens=True)
        return (_l2norm(pooled) if normalize else pooled), tokens
    b, seq = text_ids.shape
    x = t.token_embedding[text_ids]
    x = torch.cat([x, t.cls_emb.to(x.dtype).expand(b, 1, -1)], dim=1)
    # the causal mask, and on the appended CLS row only the pad columns
    # masked (a column of 0 put first: the reference's build_cls_mask)
    keep = torch.nn.functional.pad(text_ids != cfg.pad_id, (1, 0), value=True)
    cls_mask = torch.zeros((b, seq + 1, seq + 1), device=x.device)
    cls_mask[:, -1, :] = torch.where(keep, 0.0, float("-inf"))
    mask = causal_mask(seq + 1, x.device)[None] + cls_mask
    x = x + t.positional_embedding[:seq + 1].to(x.dtype)[None]
    act = _act(cfg)
    for blk in t.blocks:
        x = _block(blk, x, tcfg.heads, act, mask=mask[:, None])
    pooled, tokens = x[:, -1], x[:, :-1]
    pooled = layer_norm(pooled, t.ln_final) @ t.text_projection.to(x.dtype)
    return (_l2norm(pooled) if normalize else pooled), tokens


def _cross_attention(p, q_x: torch.Tensor, kv: torch.Tensor, heads: int) -> torch.Tensor:
    """MultiheadAttention(q, k, v) with the fused in_proj split in three."""
    d = q_x.shape[-1]
    wq, wk, wv = p.in_proj_w.chunk(3, dim=0)
    bq, bk, bv = p.in_proj_b.chunk(3)
    q = _split_heads(linear(q_x, wq, bq), heads)
    k = _split_heads(linear(kv, wk, bk), heads)
    v = _split_heads(linear(kv, wv, bv), heads)
    attn = _softmax32(_bmm(q * (d // heads) ** -0.5, k.transpose(-1, -2)))
    out = _merge_heads(_bmm(attn, v.float()).to(q_x.dtype))
    return linear(out, p.out_proj_w, p.out_proj_b)


def multimodal_decoder(p: CoCa, image_embs: torch.Tensor, text_embs: torch.Tensor,
                       cfg: CoCaConfig) -> torch.Tensor:
    """Caption logits [B, L, vocab] (rs_ov/nn/coca.py:223-242). Image tokens
    of another width than the decoder's raise the JAX package's error
    (coca_roberta-ViT-B-32, whose reference caption forward is broken)."""
    m, mcfg = p.multimodal, cfg.multimodal
    if image_embs.shape[-1] != mcfg.width:
        raise ValueError(f"Incompatible shapes for broadcasting: shapes="
                         f"[{tuple(image_embs.shape)}, ({mcfg.width},)]")
    act = _act(cfg)
    seq = text_embs.shape[1]
    mask = causal_mask(mcfg.context_length, text_embs.device)[:seq, :seq]
    x = text_embs
    for blk, xblk in zip(m.blocks, m.cross_blocks):
        x = _block(blk, x, mcfg.heads, act, mask=mask)
        kv = layer_norm(image_embs, xblk.ln_1_kv)
        x = x + _cross_attention(xblk.attn, layer_norm(x, xblk.ln_1), kv, mcfg.heads)
        x = x + mlp(layer_norm(x, xblk.ln_2), xblk.mlp, act=act)
    x = layer_norm(x, m.ln_final)
    return x @ m.text_projection.to(x.dtype)


def coca_forward(p: CoCa, images, texts, cfg: CoCaConfig, image_latent=None,
                 image_embs=None) -> dict:
    """The reference CoCa.forward's output dict (rs_ov/nn/coca.py:245-257)."""
    if image_latent is None or image_embs is None:
        image_latent, image_embs = coca_encode_image(p, images, cfg)
    if texts is None:
        return {"image_features": image_latent, "image_embs": image_embs}
    text_latent, token_embs = coca_encode_text(p, texts, cfg)
    labels = texts[:, -token_embs.shape[1]:]
    logits = multimodal_decoder(p, image_embs, token_embs, cfg)
    return {"image_features": image_latent, "text_features": text_latent, "logits": logits,
            "labels": labels, "logit_scale": torch.exp(p.logit_scale)}


# ---------------------------------------------------------------------------
# KV-cached incremental decoding (rs_ov/nn/coca.py:260-399). Token rows are
# causal in both towers (the appended CLS sits at the end, where no token
# row can see it, and generation never reads the pooled latent), so a step
# runs one token through the text tower and the decoder against the cache.
# ---------------------------------------------------------------------------

def _cached_self_attn(attn_p, x_ln: torch.Tensor, k_cache, v_cache, pos: int, heads: int,
                      out_dtype):
    """standard_attention at one query over the cached K/V, the new K/V
    written at ``pos`` (in place); -inf past ``pos``. Returns attn_out [B, 1, D]."""
    q, k_new, v_new = linear(x_ln, attn_p.in_proj_w, attn_p.in_proj_b).chunk(3, dim=-1)
    q = _split_heads(q, heads)
    k_cache[:, :, pos] = _split_heads(k_new, heads)[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = _split_heads(v_new, heads)[:, :, 0].to(v_cache.dtype)
    scale = (x_ln.shape[-1] // heads) ** -0.5
    slots = torch.arange(k_cache.shape[2], device=x_ln.device)
    mask = torch.where(slots <= pos, 0.0, float("-inf"))
    attn = _softmax32(_bmm(q * scale, k_cache.transpose(-1, -2)) + mask)
    out = _merge_heads(_bmm(attn.to(v_cache.dtype), v_cache).to(out_dtype))
    return linear(out, attn_p.out_proj_w, attn_p.out_proj_b)


def coca_decode_init_cache(p: CoCa, image_embs: torch.Tensor, cfg: CoCaConfig,
                           max_len: int) -> dict:
    """Zeroed self K/V for every text-tower and decoder layer in the
    weights' dtype, and each cross block's K/V of ln_1_kv(image_embs),
    projected once."""
    tcfg, mcfg = cfg.text, cfg.multimodal
    b = image_embs.shape[0]
    dtype = p.text.token_embedding.dtype

    def zeros(heads, width):
        return torch.zeros((b, heads, max_len, width // heads), dtype=dtype,
                           device=image_embs.device)

    text = [{"k": zeros(tcfg.heads, tcfg.width), "v": zeros(tcfg.heads, tcfg.width)}
            for _ in p.text.blocks]
    mm = []
    for xblk in p.multimodal.cross_blocks:
        kvin = layer_norm(image_embs, xblk.ln_1_kv)
        _, wk, wv = xblk.attn.in_proj_w.chunk(3, dim=0)
        _, bk, bv = xblk.attn.in_proj_b.chunk(3)
        mm.append({"k": zeros(mcfg.heads, mcfg.width), "v": zeros(mcfg.heads, mcfg.width),
                   "xk": _split_heads(linear(kvin, wk, bk), mcfg.heads),
                   "xv": _split_heads(linear(kvin, wv, bv), mcfg.heads)})
    return {"text": text, "mm": mm}


def coca_decode_step(p: CoCa, tokens: torch.Tensor, pos: int, cache: dict, cfg: CoCaConfig):
    """tokens [B] at position ``pos`` -> (next-token logits [B, vocab] fp32,
    the cache, its self K/V written at ``pos``)."""
    t, m = p.text, p.multimodal
    tcfg, mcfg = cfg.text, cfg.multimodal
    act = _act(cfg)
    pos = int(pos)
    x = t.token_embedding[tokens.long()][:, None]
    x = x + t.positional_embedding[pos:pos + 1].to(x.dtype)[None]
    for blk, lc in zip(t.blocks, cache["text"]):
        x = x + _cached_self_attn(blk.attn, layer_norm(x, blk.ln_1), lc["k"], lc["v"], pos,
                                  tcfg.heads, x.dtype)
        x = x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)
    scale = (mcfg.width // mcfg.heads) ** -0.5
    for blk, xblk, lc in zip(m.blocks, m.cross_blocks, cache["mm"]):
        x = x + _cached_self_attn(blk.attn, layer_norm(x, blk.ln_1), lc["k"], lc["v"], pos,
                                  mcfg.heads, x.dtype)
        x = x + mlp(layer_norm(x, blk.ln_2), blk.mlp, act=act)
        wq = xblk.attn.in_proj_w.chunk(3, dim=0)[0]
        bq = xblk.attn.in_proj_b.chunk(3)[0]
        q = _split_heads(linear(layer_norm(x, xblk.ln_1), wq, bq), mcfg.heads)
        attn = _softmax32(_bmm(q * scale, lc["xk"].transpose(-1, -2)))
        out = _merge_heads(_bmm(attn, lc["xv"].float()).to(x.dtype))
        x = x + linear(out, xblk.attn.out_proj_w, xblk.attn.out_proj_b)
        x = x + mlp(layer_norm(x, xblk.ln_2), xblk.mlp, act=act)
    x = layer_norm(x, m.ln_final)
    return (x @ m.text_projection.to(x.dtype))[:, 0].float(), cache


def make_coca_cached_decoder(p: CoCa, cfg: CoCaConfig, max_length: int):
    """(init, step) as ``blip_lm.make_cached_decoder``: init(image_embs
    [B, n, D]) -> cache; step(tokens [B], pos, cache, parent [B]) ->
    (logits [B, V] fp32, cache'), ``parent`` gathering the cache rows first."""
    dev = p.logit_scale.device

    @torch.no_grad()
    def init(image_embs):
        return coca_decode_init_cache(p, image_embs, cfg, max_length)

    @torch.no_grad()
    def step(tokens, pos, cache, parent):
        cache = _gather_cache(cache, torch.as_tensor(np.asarray(parent), device=dev).long())
        return coca_decode_step(p, torch.as_tensor(np.asarray(tokens), device=dev), pos,
                                cache, cfg)

    return init, step


# ---------------------------------------------------------------------------
# generation (rs_ov/nn/coca.py:406-584)
# ---------------------------------------------------------------------------

def _warp_top_k(logits: np.ndarray, k: int) -> np.ndarray:
    kth = np.sort(logits, axis=-1)[:, -k][:, None]
    return np.where(logits < kth, -np.inf, logits)


def _warp_top_p(logits: np.ndarray, top_p: float) -> np.ndarray:
    """HF TopPLogitsWarper: keep the least top set with mass >= top_p (the
    top-1 token always: its exclusive cumsum is 0)."""
    order = np.argsort(-logits, axis=-1)
    sorted_logits = np.take_along_axis(logits, order, axis=-1)
    probs = np.exp(sorted_logits - sorted_logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cum = np.cumsum(probs, axis=-1)
    drop_sorted = cum - probs >= top_p
    drop = np.zeros_like(drop_sorted)
    np.put_along_axis(drop, order, drop_sorted, axis=-1)
    return np.where(drop, -np.inf, logits)


def _rep_penalise(logits: np.ndarray, seqs, penalty: float) -> np.ndarray:
    """HF RepetitionPenaltyLogitsProcessor: seen tokens' logits divided (if
    positive) or multiplied (if negative) by the penalty, in place."""
    if penalty == 1.0:
        return logits
    for i, s in enumerate(seqs):
        seen = np.unique(np.asarray(s))
        pos = logits[i, seen] > 0
        logits[i, seen] = np.where(pos, logits[i, seen] / penalty, logits[i, seen] * penalty)
    return logits


def _beam_step(beams, logits, num_beams, min_seq_len, eos_token_id, done):
    """One step of the length-normalised beam: each beam's top num_beams
    continuations (EOS banned while the sequence has <= min_seq_len tokens),
    sorted by score / length; EOS ones before the cut finish into ``done``,
    the first num_beams others go on."""
    m = logits.max(-1, keepdims=True)
    logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    cand = []
    for bi, ((score, toks_b, _), row) in enumerate(zip(beams, logp)):
        if len(toks_b) <= min_seq_len:
            row = row.copy()
            row[eos_token_id] = -np.inf
        for tok in np.argsort(-row)[:num_beams]:
            cand.append((score + float(row[tok]), toks_b + [int(tok)], bi))
    cand.sort(key=lambda sc: sc[0] / len(sc[1]), reverse=True)
    kept = []
    for sc in cand:
        if sc[1][-1] == eos_token_id:
            done.append(sc)
        else:
            kept.append(sc)
        if len(kept) == num_beams:
            break
    return kept


@torch.no_grad()
def coca_generate(p: CoCa, images, cfg: CoCaConfig, *, seq_len: int = 30,
                  temperature: float = 1.0, generation_type: str = "beam_search",
                  top_p: float = 0.1, top_k: int = 1, num_beams: int = 6,
                  min_seq_len: int = 5, repetition_penalty: float = 1.0,
                  sot_token_id: int = 49406, eos_token_id: int = 49407,
                  pad_token_id: Optional[int] = None, seed: int = 0,
                  fixed_output_length: bool = False, use_cache: bool = True) -> np.ndarray:
    """Captions as int32 token rows [B, <= seq_len]. 'beam_search' per
    image (length-normalised), 'top_k' / 'top_p' sampling drawn from
    ``np.random.RandomState(seed)``. ``use_cache`` False, an HF text tower
    or ``seq_len`` past min(text, multimodal context) re-run the full
    prefix (its window clamped to that context)."""
    dev = p.logit_scale.device
    pad_token_id = cfg.pad_id if pad_token_id is None else pad_token_id
    images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
    _, image_embs = coca_encode_image(p, images.to(dev, p.logit_scale.dtype), cfg)
    b = image_embs.shape[0]
    rng = np.random.RandomState(seed)
    window = min(cfg.text.context_length, cfg.multimodal.context_length)
    cacheable = use_cache and not cfg.text.hf_model_name and seq_len <= window
    if cacheable:
        initf, stepf = make_coca_cached_decoder(p, cfg, seq_len)

        def make_stepper(embs_rows):
            state = {"cache": initf(embs_rows)}

            def stepc(toks, pos, parent) -> np.ndarray:
                logits, state["cache"] = stepf(toks, pos, state["cache"], parent)
                return logits.cpu().numpy().astype(np.float64)

            return stepc

    def step_logits(out: np.ndarray, embs) -> np.ndarray:
        texts = torch.as_tensor(out[:, -window:], device=dev)
        d = coca_forward(p, None, texts, cfg, image_latent=torch.zeros((out.shape[0], 1)),
                         image_embs=embs)
        logits = d["logits"][:, -1].float().cpu().numpy().astype(np.float64)
        return _rep_penalise(logits, list(out), repetition_penalty)

    if generation_type == "beam_search":
        finished = []
        for i in range(b):
            embs_i = image_embs[i:i + 1]
            stepc = make_stepper(embs_i.repeat_interleave(num_beams, 0)) if cacheable else None
            beams = [(0.0, [sot_token_id], 0)]  # (score, seq, cache row)
            done = []
            for it in range(seq_len - 1):
                if cacheable:
                    toks = np.zeros(num_beams, np.int32)
                    par = np.zeros(num_beams, np.int32)
                    for bi, (_, s, row_i) in enumerate(beams):
                        toks[bi] = s[-1]
                        par[bi] = row_i
                    logits = stepc(toks, it, par)[:len(beams)]
                    logits = _rep_penalise(logits, [s for _, s, _ in beams],
                                           repetition_penalty)
                else:
                    out = np.asarray([bm[1] for bm in beams], np.int32)
                    logits = step_logits(out, embs_i.repeat_interleave(len(beams), 0))
                beams = _beam_step(beams, logits, num_beams, min_seq_len, eos_token_id, done)
                if not beams:
                    break
            done.extend(beams)
            finished.append(max(done, key=lambda sc: sc[0] / len(sc[1]))[1])
        width = seq_len if fixed_output_length else max(len(f) for f in finished)
        out = np.full((b, width), pad_token_id, np.int32)
        for i, f in enumerate(finished):
            out[i, :min(len(f), width)] = f[:width]
        return out

    if generation_type not in ("top_k", "top_p"):
        raise ValueError("generation_type has to be one of | beam_search | top_p | top_k |.")
    out = np.full((b, 1), sot_token_id, np.int32)
    stepc = make_stepper(image_embs) if cacheable else None
    arange = np.arange(b, dtype=np.int32)
    while out.shape[1] < seq_len:
        if cacheable:
            logits = _rep_penalise(stepc(out[:, -1], out.shape[1] - 1, arange), list(out),
                                   repetition_penalty)
        else:
            logits = step_logits(out, image_embs)
        logits = logits / max(temperature, 1e-8)
        if out.shape[1] < min_seq_len:
            logits[:, eos_token_id] = -np.inf
        logits = (_warp_top_k(logits, top_k) if generation_type == "top_k"
                  else _warp_top_p(logits, top_p))
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        nxt = np.array([rng.choice(len(pr), p=pr) for pr in probs], np.int32)
        stopped = (out[:, -1] == eos_token_id) | (out[:, -1] == pad_token_id)
        nxt = np.where(stopped, pad_token_id, nxt)
        out = np.concatenate([out, nxt[:, None]], axis=1)
        if bool(np.all((out[:, -1] == eos_token_id) | (out[:, -1] == pad_token_id))):
            break
    return out
