"""BLIP's MED-decoder family on the port (rs_ov/nn/blip_lm.py): captioning,
VQA, NLVR.

- The LM head (dense -> GELU -> LayerNorm -> decoder) over the causal MED
  decoder, which cross-attends over the image tokens (captioning) or over
  the image-grounded question states (VQA).
- Captioning: ``generate_captions`` beam-searches (length-unnormalised, HF's
  MinLength counting the prompt, early stop on EOS) or nucleus-samples on
  the host from an explicit ``np.random.RandomState``, with the same numpy
  arithmetic on the same fp32 logits as the JAX package.
- VQA: ``vqa_rank_answers`` (first-token top-k, then the full LM score)
  and ``vqa_generate_answers`` (beam search from a bare bos).
- NLVR: each layer cross-attends over two image streams through twin
  weights, merged by averaging or by the merge layer, then a 2-way head.

Decoding runs on the KV-cached step (``make_cached_decoder``): per-layer self
K/V buffers [B, heads, max_length, dh], the cross K/V projected once, a
``parent`` gather of every cache row before each step (beam reordering).
``use_cache=False`` re-runs the full padded prefix (``make_caption_step``),
the parity oracle. The training losses: ``lm_loss`` (the rank path's
per-sequence score is its ``'none'`` reduction), ``blip_caption_loss``,
``blip_vqa_loss`` and ``blip_nlvr_forward`` with ``targets``.

The parameters are ``nn.Module``s with the JAX pytree's names
(``BlipDecoder``: ``visual``, ``text_decoder``, ``lm_head``; ``BlipVQA``
adds ``text_encoder``; ``BlipNLVR``: ``visual``, ``text_encoder``,
``cls_head``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from rs_ov_torch.core.params import LayerNorm, _p, load_numpy_tree
from rs_ov_torch.nn.bert import (BertConfig, BertEncoder, _attend, _ffn, _mha, _SELF,
                                 bert_decode_init_cache, bert_decode_step, bert_encode, embed)
from rs_ov_torch.nn.bert import gather_cache as _gather_cache
from rs_ov_torch.nn.blip import (Blip, BlipConfig, _bert_module, _bert_tree, _visual_module,
                                 _visual_tree, init_blip_params)
from rs_ov_torch.nn.blip_vit import BlipVisionTower, blip_vit_forward
from rs_ov_torch.nn.layers import gelu, layer_norm, linear

__all__ = [
    "LMHead", "DecSelfAttn", "add_pretrain_decoder", "BlipDecoder", "BlipVQA", "BlipNLVR",
    "init_lm_head", "lm_head_from_state_dict", "lm_logits", "add_cross_attention_params",
    "init_blip_decoder_params", "blip_decoder_params_from_state_dict",
    "init_blip_vqa_params", "blip_vqa_params_from_state_dict", "init_blip_itm_params",
    "init_blip_nlvr_params", "blip_nlvr_params_from_state_dict",
    "make_caption_step", "make_cached_decoder", "generate_captions",
    "vqa_rank_answers", "vqa_generate_answers", "nlvr_encode", "blip_nlvr_forward",
    "IGNORE_INDEX", "lm_loss", "caption_targets", "blip_caption_loss", "blip_vqa_loss",
]

IGNORE_INDEX = -100


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class LMHead(nn.Module):
    def __init__(self, hidden: int, vocab: int):
        super().__init__()
        self.t_w = _p(hidden, hidden)
        self.t_b = _p(hidden)
        self.t_ln = LayerNorm(hidden)
        self.dec_w = _p(vocab, hidden)
        self.dec_b = _p(vocab)


class DecSelfAttn(nn.Module):
    """One pretraining decoder layer's own (untied) self-attention."""

    def __init__(self, hidden: int):
        super().__init__()
        for name in ("q", "k", "v", "attn_out"):
            setattr(self, f"{name}_w", _p(hidden, hidden))
            setattr(self, f"{name}_b", _p(hidden))
        self.attn_ln = LayerNorm(hidden)


def add_pretrain_decoder(params: nn.Module, hidden: int, vocab: int, layers: int) -> nn.Module:
    """BLIP pretraining's own decoder leaves on a retrieval ``Blip``: each
    layer's self-attention (``dec_self_attn``) and the LM head; every other
    decoder leaf is the text encoder's (rs_ov/train/blip_pretrain.py)."""
    params.dec_self_attn = nn.ModuleList(DecSelfAttn(hidden) for _ in range(layers))
    params.lm_head = LMHead(hidden, vocab)
    return params


class BlipDecoder(nn.Module):
    def __init__(self, visual: BlipVisionTower, text_decoder: BertEncoder):
        super().__init__()
        self.visual = visual
        self.text_decoder = text_decoder
        word = text_decoder.embeddings.word
        self.lm_head = LMHead(word.shape[1], word.shape[0])


class BlipVQA(BlipDecoder):
    def __init__(self, visual: BlipVisionTower, text_encoder: BertEncoder,
                 text_decoder: BertEncoder):
        super().__init__(visual, text_decoder)
        self.text_encoder = text_encoder


class ClsHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.w1 = _p(hidden, hidden)
        self.b1 = _p(hidden)
        self.w2 = _p(2, hidden)
        self.b2 = _p(2)


class BlipNLVR(nn.Module):
    def __init__(self, visual: BlipVisionTower, text_encoder: BertEncoder):
        super().__init__()
        self.visual = visual
        self.text_encoder = text_encoder
        self.cls_head = ClsHead(text_encoder.embeddings.word.shape[1])


def blip_decoder_from_tree(tree) -> BlipDecoder:
    """A JAX caption pytree (numpy leaves) as an fp32 BlipDecoder on the CPU."""
    return load_numpy_tree(BlipDecoder(_visual_module(tree["visual"]),
                                       _bert_module(tree["text_decoder"])), tree)


def blip_vqa_from_tree(tree) -> BlipVQA:
    return load_numpy_tree(BlipVQA(_visual_module(tree["visual"]),
                                   _bert_module(tree["text_encoder"]),
                                   _bert_module(tree["text_decoder"])), tree)


def blip_nlvr_from_tree(tree) -> BlipNLVR:
    return load_numpy_tree(BlipNLVR(_visual_module(tree["visual"]),
                                    _bert_module(tree["text_encoder"])), tree)


# ---------------------------------------------------------------------------
# init and the checkpoint names (rs_ov/nn/blip_lm.py:69-182, :483-503, :678-703)
# ---------------------------------------------------------------------------

def _draw(m: nn.Module, gen: torch.Generator) -> nn.Module:
    """The JAX inits' rule: LayerNorm scales 1; biases, token types and the
    CLS token 0; every other leaf N(0, 0.02)."""
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "b", "cls_token", "token_type", "b1", "b2") or leaf.endswith("_b"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return m


@torch.no_grad()
def init_lm_head(gen: torch.Generator, cfg: BertConfig) -> LMHead:
    return _draw(LMHead(cfg.hidden_size, cfg.vocab_size), gen)


def lm_head_from_state_dict(sd, prefix: str = "text_decoder.cls.predictions") -> LMHead:
    """BertLMPredictionHead's weights (``{prefix}.transform.dense`` /
    ``.LayerNorm``, ``{prefix}.decoder``, ``{prefix}.bias``) as an fp32 LMHead."""
    return load_numpy_tree(*_lm_head(sd, prefix))


def _lm_head(sd, prefix):
    def a(name):
        return np.asarray(sd[f"{prefix}.{name}"], np.float32)

    tree = {"t_w": a("transform.dense.weight"), "t_b": a("transform.dense.bias"),
            "t_ln": {"scale": a("transform.LayerNorm.weight"),
                     "bias": a("transform.LayerNorm.bias")},
            "dec_w": a("decoder.weight"), "dec_b": a("bias")}
    return LMHead(tree["t_w"].shape[0], tree["dec_w"].shape[0]), tree


@torch.no_grad()
def add_cross_attention_params(gen: torch.Generator, text: BertEncoder, cfg: BlipConfig,
                               twin: bool = False, merge_from: int | None = None) -> BertEncoder:
    """``text`` with the MED cross-attention over image tokens
    ``cfg.vision.width`` wide added to every layer, drawn from ``gen``
    (rs_ov/nn/blip_lm.py:128-161); ``twin`` the NLVR pair with a merge head
    from ``merge_from`` (default num_layers // 2) on. Self-attention, FFN
    and embeddings keep their values."""
    if merge_from is None:
        merge_from = cfg.text.num_layers // 2
    out = BertEncoder(cfg.text, cross=not twin, token_type=hasattr(text.embeddings, "token_type"),
                      encoder_width=cfg.vision.width, twin=twin,
                      merge_from=merge_from if twin else None)
    _draw(out, gen)
    out.load_state_dict(text.state_dict(), strict=False)
    return out


def _blip_base(gen: torch.Generator, cfg: BlipConfig):
    base = init_blip_params(gen, cfg)
    return base.visual, base.text


@torch.no_grad()
def init_blip_decoder_params(gen: torch.Generator, cfg: BlipConfig) -> BlipDecoder:
    """Random fp32 caption weights on the CPU (rs_ov/nn/blip_lm.py:168-173)."""
    visual, text = _blip_base(gen, cfg)
    m = BlipDecoder(visual, add_cross_attention_params(gen, text, cfg))
    m.lm_head = init_lm_head(gen, cfg.text)
    return m


@torch.no_grad()
def init_blip_vqa_params(gen: torch.Generator, cfg: BlipConfig) -> BlipVQA:
    """Random fp32 VQA weights: the answer decoder cross-attends over the
    hidden-width question states (rs_ov/nn/blip_lm.py:483-496)."""
    visual, text = _blip_base(gen, cfg)
    enc = add_cross_attention_params(gen, text, cfg)
    dec_cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, width=cfg.text.hidden_size))
    dec = add_cross_attention_params(gen, init_blip_params(gen, cfg).text, dec_cfg)
    m = BlipVQA(visual, enc, dec)
    m.lm_head = init_lm_head(gen, cfg.text)
    return m


@torch.no_grad()
def init_blip_itm_params(gen: torch.Generator, cfg: BlipConfig) -> Blip:
    """Random fp32 ITM / retrieval weights (the ``params`` of the JAX
    package's init_blip_retrieval_state): BLIP with the MED cross-attention
    in its text tower and the 2-way ITM head."""
    base = init_blip_params(gen, cfg)
    m = Blip(base.visual, add_cross_attention_params(gen, base.text, cfg), cfg.embed_dim,
             itm_head=True)
    m.load_state_dict(base.state_dict(), strict=False)
    _draw(m.itm_head, gen)
    return m


@torch.no_grad()
def init_blip_nlvr_params(gen: torch.Generator, cfg: BlipConfig) -> BlipNLVR:
    """Random fp32 NLVR weights (rs_ov/nn/blip_lm.py:678-690)."""
    visual, text = _blip_base(gen, cfg)
    m = BlipNLVR(visual, add_cross_attention_params(gen, text, cfg, twin=True))
    _draw(m.cls_head, gen)
    return m


def blip_decoder_params_from_state_dict(sd) -> BlipDecoder:
    """A BLIP caption checkpoint (``visual_encoder.*``, ``text_decoder.bert.*``,
    ``text_decoder.cls.predictions.*``) as an fp32 BlipDecoder on the CPU."""
    return blip_decoder_from_tree(_decoder_tree(sd))


def _decoder_tree(sd) -> dict:
    return {"visual": _visual_tree(sd, "visual_encoder"),
            "text_decoder": _bert_tree(sd, "text_decoder"),
            "lm_head": _lm_head(sd, "text_decoder.cls.predictions")[1]}


def blip_vqa_params_from_state_dict(sd) -> BlipVQA:
    return blip_vqa_from_tree({**_decoder_tree(sd),
                               "text_encoder": _bert_tree(sd, "text_encoder")})


def blip_nlvr_params_from_state_dict(sd) -> BlipNLVR:
    """A BLIP-NLVR checkpoint: the text encoder's twin streams (``self0`` /
    ``self1``, ``dense0`` / ``dense1``, ``merge_layer``) and ``cls_head.0`` /
    ``cls_head.2``."""
    def a(name):
        return np.asarray(sd[name], np.float32)

    return blip_nlvr_from_tree({
        "visual": _visual_tree(sd, "visual_encoder"),
        "text_encoder": _bert_tree(sd, "text_encoder"),
        "cls_head": {"w1": a("cls_head.0.weight"), "b1": a("cls_head.0.bias"),
                     "w2": a("cls_head.2.weight"), "b2": a("cls_head.2.bias")}})


# ---------------------------------------------------------------------------
# the LM head and the rank path's score
# ---------------------------------------------------------------------------

def lm_logits(head: LMHead, hidden: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """[B, L, H] -> vocabulary logits [B, L, V] in the hidden's dtype."""
    x = layer_norm(linear(hidden, head.t_w, head.t_b, act=gelu), head.t_ln, eps=eps)
    return linear(x, head.dec_w, head.dec_b)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean",
            label_smoothing: float = 0.1) -> torch.Tensor:
    """Shift-by-one, label-smoothed next-token CE with -100 ignored
    (rs_ov/nn/blip_lm.py:108-125): (1 - eps) nll + eps mean_c(-log p_c);
    'mean' averages over the kept tokens, 'none' sums per sequence (the
    score the VQA rank path takes for each candidate)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    per_tok = ((1.0 - label_smoothing) * nll + label_smoothing * (-logp).mean(-1)) * valid
    if reduction == "none":
        return per_tok.sum(-1)
    return per_tok.sum() / valid.sum().clamp_min(1)


def caption_targets(input_ids: torch.Tensor, pad_token_id: int,
                    prompt_length: int) -> torch.Tensor:
    """Decoder targets: pad tokens and the prompt prefix -> -100
    (rs_ov/nn/blip_lm.py:185-191)."""
    t = torch.where(input_ids == pad_token_id, IGNORE_INDEX, input_ids)
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return torch.where(pos < prompt_length, IGNORE_INDEX, t)


def blip_caption_loss(params: BlipDecoder, images, input_ids, attention_mask,
                      cfg: BlipConfig, pad_token_id: int = 0, prompt_length: int = 4,
                      reduction: str = "mean") -> torch.Tensor:
    """The image-conditioned LM loss (rs_ov/nn/blip_lm.py:194-207);
    input_ids[:, 0] must already be the [DEC] bos token."""
    input_ids = _as(input_ids, params)
    image_embeds = blip_vit_forward(params.visual, _as(images, params), cfg.vision)
    hidden = bert_encode(params.text_decoder, input_ids, _as(attention_mask, params), cfg.text,
                         encoder_hidden_states=image_embeds, causal=True)
    logits = lm_logits(params.lm_head, hidden)
    return lm_loss(logits, caption_targets(input_ids, pad_token_id, prompt_length),
                   reduction=reduction)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _penalised(logits, ids_so_far, penalty):
    """HF RepetitionPenaltyLogitsProcessor on host logits (rs_ov/nn/blip_lm.py:210-217)."""
    if penalty != 1.0 and len(ids_so_far):
        prev = np.unique(np.asarray(ids_so_far, np.int64))
        sel = logits[prev]
        logits = logits.copy()
        logits[prev] = np.where(sel > 0, sel / penalty, sel * penalty)
    return logits


def _nucleus_pick(logits, seq, pos, eos, min_length, top_p, rng) -> int:
    """One nucleus-sampling step on host logits: repetition penalty 1.1,
    EOS banned below min_length (the prompt counts), the least top set of
    mass > top_p (at least one token), one ``rng.choice``."""
    logits = _penalised(logits, seq, 1.1)
    if pos + 1 < min_length:
        logits[eos] = -1e9
    p = np.exp(logits - logits.max())
    p /= p.sum()
    order = np.argsort(-p)
    keep = np.cumsum(p[order]) <= top_p
    keep[0] = True
    p2 = np.zeros_like(p)
    p2[order[keep]] = p[order[keep]]
    p2 /= p2.sum()
    return int(rng.choice(len(p2), p=p2))


def _expand(beams, logits, pos, eos, num_beams, min_length, repetition_penalty, finished):
    """One step of the length-unnormalised beam: each beam's top-num_beams
    continuations; EOS ones finish, the best num_beams others go on. EOS is
    banned while the whole sequence (prompt included) is shorter than
    min_length (HF MinLength)."""
    nxt_beams = []
    for b, beam in enumerate(beams):
        score, s = beam[0], beam[1]
        lg = _penalised(logits[b], s, repetition_penalty)
        if pos + 1 < min_length:
            lg[eos] = -1e9
        logp = lg - np.log(np.exp(lg - lg.max()).sum()) - lg.max()
        for t in np.argsort(-logp)[:num_beams]:
            cand = (score + float(logp[t]), s + [int(t)], b)
            if t == eos:
                finished.append(cand)
            else:
                nxt_beams.append(cand)
    return sorted(nxt_beams, key=lambda c: -c[0])[:num_beams]


def _beams_done(beams, finished, num_beams) -> bool:
    return not beams or (len(finished) >= num_beams and finished[0][0] >= beams[0][0])


def _beam_search(step1, prefix, eos, num_beams, max_length, min_length,
                 repetition_penalty):
    """The plain beam over a full-prefix step (rs_ov/nn/blip_lm.py:220-254):
    step1(ids [B, max_length], pos) -> [B, V] host logits; returns the best
    finished sequence."""
    beams = [(0.0, list(prefix))]
    finished = []
    for pos in range(len(prefix) - 1, max_length - 1):
        ids = np.zeros((len(beams), max_length), np.int32)
        for b, (_, s, *_) in enumerate(beams):
            ids[b, :len(s)] = s
        beams = _expand(beams, step1(ids, pos), pos, eos, num_beams, min_length,
                        repetition_penalty, finished)
        if _beams_done(beams, finished, num_beams):
            break
    finished.extend(beams)
    return max(finished, key=lambda c: c[0])[1]


def _beam_search_cached(init, step, encoder_states, prefix, eos, num_beams, max_length,
                        min_length, repetition_penalty):
    """_beam_search over the KV-cached step (rs_ov/nn/blip_lm.py:326-371):
    cache row b follows beam b through the ``parent`` gather each step;
    encoder_states [1, Lenc, D] is tiled to the beams once at init."""
    nb = num_beams
    cache = init(encoder_states.repeat_interleave(nb, 0))
    arange = np.arange(nb, dtype=np.int32)

    def stepc(tokens, pos, parent):
        nonlocal cache
        logits, cache = step(tokens, pos, cache, parent)
        return logits.cpu().numpy()

    for t in range(len(prefix) - 1):  # the prompt prefix, every row alike
        stepc(np.full(nb, prefix[t], np.int32), t, arange)
    beams = [(0.0, list(prefix), 0)]  # (score, seq, cache row after the step)
    finished = []
    for pos in range(len(prefix) - 1, max_length - 1):
        toks = np.zeros(nb, np.int32)
        par = np.zeros(nb, np.int32)
        for b, (_, s, p_row) in enumerate(beams):
            toks[b] = s[pos]
            par[b] = p_row
        beams = _expand(beams, stepc(toks, pos, par), pos, eos, num_beams, min_length,
                        repetition_penalty, finished)
        if _beams_done(beams, finished, num_beams):
            break
    finished.extend(beams)
    return max(finished, key=lambda c: c[0])[1]


def _device(params: nn.Module) -> torch.device:
    return params.visual.cls_token.device


def _as(x, params: nn.Module, dtype=None) -> torch.Tensor:
    """An input (numpy or tensor) on the weights' device, in ``dtype`` (the
    weights' dtype for float inputs, else as given)."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if dtype is None:
        dtype = params.visual.cls_token.dtype if x.is_floating_point() else torch.long
    return x.to(_device(params), dtype)


def make_cached_decoder(params: BlipDecoder, cfg: BlipConfig, max_length: int):
    """(init, step) of the KV-cached decode (rs_ov/nn/blip_lm.py:279-323):
    init(encoder_states [B, Lenc, D]) -> cache, zeroed self K/V [B, heads,
    max_length, dh] in the weights' dtype and the cross K/V projected once;
    step(tokens [B], pos, cache, parent [B]) -> (logits [B, V] fp32,
    cache'), ``parent`` gathering the cache rows first (arange for none).
    Cross-attention attends every encoder position."""
    text = params.text_decoder
    dtype = text.embeddings.word.dtype

    @torch.no_grad()
    def init(encoder_states):
        return bert_decode_init_cache(text, cfg.text, encoder_states.shape[0], max_length,
                                      encoder_states, dtype=dtype)

    @torch.no_grad()
    def step(tokens, pos, cache, parent):
        cache = _gather_cache(cache, _as(parent, params))
        hidden, cache = bert_decode_step(text, _as(tokens, params), pos, cache, cfg.text)
        return lm_logits(params.lm_head, hidden[:, None])[:, 0].float(), cache

    return init, step


def make_caption_step(params: BlipDecoder, cfg: BlipConfig, max_length: int):
    """The full-prefix step (rs_ov/nn/blip_lm.py:374-389): (ids [B,
    max_length] padded, pos, image_embeds) -> the fp32 logits [B, V] at pos."""
    slots = torch.arange(max_length, device=_device(params))

    @torch.no_grad()
    def step(ids, pos, image_embeds):
        mask = (slots[None] <= pos).long()
        hidden = bert_encode(params.text_decoder, _as(ids, params), mask, cfg.text,
                             encoder_hidden_states=image_embeds, causal=True)
        return lm_logits(params.lm_head, hidden)[:, pos].float()

    return step


@torch.no_grad()
def generate_captions(params: BlipDecoder, images, cfg: BlipConfig, tokenizer,
                      prompt: str = "a picture of ", sample: bool = False,
                      num_beams: int = 3, max_length: int = 30, min_length: int = 10,
                      top_p: float = 0.9, repetition_penalty: float = 1.0,
                      rng: np.random.RandomState | None = None,
                      use_cache: bool = True) -> list[str]:
    """Beam-search or nucleus-sampling captions, one image at a time
    (rs_ov/nn/blip_lm.py:392-476): beam search per image, plain and
    length-unnormalised; nucleus sampling with repetition penalty 1.1,
    drawn by ``rng.choice`` on the host probabilities (RandomState(0) when
    ``rng`` is None). ``use_cache`` False re-runs the full prefix."""
    image_embeds = blip_vit_forward(params.visual, _as(images, params), cfg.vision)
    n_img = image_embeds.shape[0]
    enc = tokenizer([prompt] * n_img, max_length=max_length)
    prompt_ids = enc["input_ids"][0]
    # bos replaces [CLS], the trailing [SEP] is dropped
    plen = int(enc["attention_mask"][0].sum()) - 1
    prefix = np.concatenate([[tokenizer.bos_token_id], prompt_ids[1:plen]])
    eos = tokenizer.sep_token_id
    if use_cache:
        cinit, cstep = make_cached_decoder(params, cfg, max_length)
    else:
        step = make_caption_step(params, cfg, max_length)
    if sample and rng is None:
        rng = np.random.RandomState(0)
    zero = np.zeros(1, np.int32)

    captions = []
    for i in range(n_img):
        embs_i = image_embeds[i:i + 1]
        if sample:
            seq = list(prefix)
            if use_cache:
                cache = cinit(embs_i)

                def logits_at(pos):
                    nonlocal cache
                    lg, cache = cstep(np.asarray([seq[pos]], np.int32), pos, cache, zero)
                    return lg.cpu().numpy()[0]
            else:
                ids = np.zeros((1, max_length), np.int32)
                ids[0, :len(prefix)] = prefix

                def logits_at(pos):
                    ids[0, :len(seq)] = seq
                    return step(ids, pos, embs_i).cpu().numpy()[0]
            for pos in range(len(prefix) - 1):  # the prompt into the cache
                if use_cache:
                    logits_at(pos)
            for pos in range(len(prefix) - 1, max_length - 1):
                nxt = _nucleus_pick(logits_at(pos), seq, pos, eos, min_length, top_p, rng)
                seq.append(nxt)
                if nxt == eos:
                    break
        elif use_cache:
            seq = _beam_search_cached(cinit, cstep, embs_i, prefix, eos, num_beams,
                                      max_length, min_length, repetition_penalty)
        else:
            def step1(ids, pos):
                return step(ids, pos, embs_i.repeat_interleave(len(ids), 0)).cpu().numpy()

            seq = _beam_search(step1, prefix, eos, num_beams, max_length, min_length,
                               repetition_penalty)
        text = tokenizer.decode(seq, skip_special_tokens=True)
        captions.append(text[len(prompt):] if text.startswith(prompt) else text)
    return captions


# ---------------------------------------------------------------------------
# VQA (rs_ov/nn/blip_lm.py:531-628)
# ---------------------------------------------------------------------------

def _question_states(params: BlipVQA, images, q_ids, q_mask, cfg: BlipConfig):
    image_embeds = blip_vit_forward(params.visual, _as(images, params), cfg.vision)
    return bert_encode(params.text_encoder, _as(q_ids, params), _as(q_mask, params), cfg.text,
                       encoder_hidden_states=image_embeds)


def blip_vqa_loss(params: BlipVQA, images, q_ids, q_mask, a_ids, a_mask, answer_to_question,
                  weights, cfg: BlipConfig, pad_token_id: int = 0) -> torch.Tensor:
    """The VQA training loss (rs_ov/nn/blip_lm.py:506-528): question b's
    states gathered for each of its answers by ``answer_to_question`` [Na],
    the per-answer LM loss weighted by ``weights`` [Na], summed over the
    answers and divided by the number of images. q_ids[:, 0] must be [ENC],
    a_ids[:, 0] the bos token."""
    q_mask = _as(q_mask, params)
    a_ids, a2q = _as(a_ids, params), _as(answer_to_question, params)
    q_states = _question_states(params, images, q_ids, q_mask, cfg)
    hidden = bert_encode(params.text_decoder, a_ids, _as(a_mask, params), cfg.text,
                         encoder_hidden_states=q_states[a2q], encoder_attention_mask=q_mask[a2q],
                         causal=True)
    logits = lm_logits(params.lm_head, hidden)
    targets = torch.where(a_ids == pad_token_id, IGNORE_INDEX, a_ids)
    per_answer = lm_loss(logits, targets, reduction="none")
    return (_as(weights, params, torch.float32) * per_answer).sum() / q_states.shape[0]


@torch.no_grad()
def vqa_rank_answers(params: BlipVQA, images, q_ids, q_mask, answer_ids, answer_mask,
                     cfg: BlipConfig, k: int = 128, pad_token_id: int = 0) -> torch.Tensor:
    """'rank' inference: each question's k candidates of highest first-token
    probability (a stable descending sort: ties in index order, as
    ``jax.lax.top_k`` gives them), scored by the full LM log-probability
    over the question states under the real question mask; returns
    [num_questions] indices into the answer list."""
    q_mask = _as(q_mask, params)
    answer_ids, answer_mask = _as(answer_ids, params), _as(answer_mask, params)
    q_states = _question_states(params, images, q_ids, q_mask, cfg)
    nq = q_states.shape[0]
    start = answer_ids[0, 0].expand(nq, 1)
    h0 = bert_encode(params.text_decoder, start, torch.ones_like(start), cfg.text,
                     encoder_hidden_states=q_states, encoder_attention_mask=q_mask, causal=True)
    probs = torch.softmax(lm_logits(params.lm_head, h0)[:, 0].float(), dim=-1)
    p_first = probs[:, answer_ids[:, 1]]
    topk_ids = torch.sort(p_first, dim=1, descending=True, stable=True).indices[:, :k]
    flat = topk_ids.reshape(-1)
    cand_ids, cand_mask = answer_ids[flat], answer_mask[flat]
    hidden = bert_encode(params.text_decoder, cand_ids, cand_mask, cfg.text,
                         encoder_hidden_states=q_states.repeat_interleave(k, 0),
                         encoder_attention_mask=q_mask.repeat_interleave(k, 0), causal=True)
    logits = lm_logits(params.lm_head, hidden)
    targets = torch.where(cand_ids == pad_token_id, IGNORE_INDEX, cand_ids)
    logp = -lm_loss(logits, targets, reduction="none").reshape(nq, k)
    return torch.gather(topk_ids, 1, logp.argmax(1, keepdim=True))[:, 0]


@torch.no_grad()
def vqa_generate_answers(params: BlipVQA, images, q_ids, q_mask, cfg: BlipConfig, tokenizer,
                         num_beams: int = 3, max_length: int = 10, min_length: int = 1,
                         use_cache: bool = True) -> list[str]:
    """'generate' inference: the answer decoder beam-searches from a bare
    bos over the image-grounded question states, EOS = [SEP]. The decoder
    attends every question position (an all-ones mask, as the reference's
    generate path builds it), unlike the rank path."""
    q_states = _question_states(params, images, q_ids, q_mask, cfg)
    ones = torch.ones(q_states.shape[:2], dtype=torch.long, device=q_states.device)
    if use_cache:
        cinit, cstep = make_cached_decoder(params, cfg, max_length)
    else:
        slots = torch.arange(max_length, device=q_states.device)

        def step(ids, pos, qs, qm):
            mask = (slots[None] <= pos).long()
            hidden = bert_encode(params.text_decoder, _as(ids, params), mask, cfg.text,
                                 encoder_hidden_states=qs, encoder_attention_mask=qm,
                                 causal=True)
            return lm_logits(params.lm_head, hidden)[:, pos].float()

    eos = tokenizer.sep_token_id
    prefix = np.asarray([tokenizer.bos_token_id], np.int64)
    answers = []
    for i in range(q_states.shape[0]):
        qs_i, qm_i = q_states[i:i + 1], ones[i:i + 1]
        if use_cache:
            seq = _beam_search_cached(cinit, cstep, qs_i, prefix, eos, num_beams, max_length,
                                      min_length, 1.0)
        else:
            def step1(ids, pos):
                n = len(ids)
                return step(ids, pos, qs_i.repeat_interleave(n, 0),
                            qm_i.repeat_interleave(n, 0)).cpu().numpy()

            seq = _beam_search(step1, prefix, eos, num_beams, max_length, min_length, 1.0)
        answers.append(tokenizer.decode(seq, skip_special_tokens=True))
    return answers


# ---------------------------------------------------------------------------
# NLVR (rs_ov/nn/blip_lm.py:635-725)
# ---------------------------------------------------------------------------

def nlvr_encode(p: BertEncoder, input_ids, attention_mask, emb0: torch.Tensor,
                emb1: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """The BERT encoder whose layers cross-attend over two image streams
    through the twin weights: (dense0(ctx0) + dense1(ctx1)) / 2, or the
    merge layer over their concatenation where the layer has one, then
    LayerNorm of the residual and the FFN."""
    eps = cfg.layer_norm_eps
    x = embed(p, input_ids, eps)
    mask = (1.0 - attention_mask.float())[:, None, None, :] * -10000.0
    heads = cfg.num_heads
    scale = (cfg.hidden_size // heads) ** -0.5
    for layer in p.layers:
        x = _mha(x, x, (_SELF, "attn_ln"), layer, heads, scale, mask, eps)
        ctx0 = _attend(x, emb0.to(x.dtype), ("x0q", "x0k", "x0v"), layer, heads, scale, 0.0)
        ctx1 = _attend(x, emb1.to(x.dtype), ("x1q", "x1k", "x1v"), layer, heads, scale, 0.0)
        h0 = linear(ctx0, layer.x0_out_w, layer.x0_out_b)
        h1 = linear(ctx1, layer.x1_out_w, layer.x1_out_b)
        if hasattr(layer, "merge_w"):
            h = linear(torch.cat([h0, h1], dim=-1), layer.merge_w, layer.merge_b)
        else:
            h = (h0 + h1) / 2
        x = _ffn(layer, layer_norm(x + h, layer.x_ln, eps=eps), eps)
    return x


def blip_nlvr_forward(params: BlipNLVR, images, input_ids, attention_mask,
                      cfg: BlipConfig, targets=None) -> torch.Tensor:
    """images [2B, 3, S, S] (the two scenes stacked), text [B, L] with
    input_ids[:, 0] = [ENC] -> [B, 2] logits under ``no_grad``; with
    ``targets`` [B] the mean cross-entropy, with gradient
    (rs_ov/nn/blip_lm.py:706-725)."""
    with torch.set_grad_enabled(targets is not None and torch.is_grad_enabled()):
        image_embeds = blip_vit_forward(params.visual, _as(images, params), cfg.vision)
        input_ids = _as(input_ids, params)
        b = input_ids.shape[0]
        hidden = nlvr_encode(params.text_encoder, input_ids, _as(attention_mask, params),
                             image_embeds[:b], image_embeds[b:], cfg.text)
        ch = params.cls_head
        logits = linear(torch.relu(linear(hidden[:, 0], ch.w1, ch.b1)), ch.w2, ch.b2)
        if targets is None:
            return logits
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, 1, _as(targets, params)[:, None]).mean()
