"""BLIP retrieval training: ITC with momentum encoders and a feature queue, ITM
with hard negatives (rs_ov/train/blip_retrieval.py).

The state is ``{"params": Blip (cross-attention text tower, itm_head,
temp), "params_m": the momentum copies of visual / vision_proj / text /
text_proj, "queue": {"image" [D, Q], "text" [D, Q], "idx" [1, Q], "ptr"}}``.
A step:

1. the EMA of the momentum copies, before their forward, in fp32 cast back
   to each leaf's dtype (blip_retrieval.py:253-261);
2. ITC against the momentum features of the batch and the queue, ``temp``
   clamped to [0.001, 0.5] inside the loss, soft targets mixing the
   momentum similarities with the duplicate-``idx`` mass (:151-177);
3. ITM over the positive pairs and one hard negative text and image per
   row, drawn from the whole batch's similarities with -1e9 on pairs of one
   ``idx`` (:179-211): ``torch.multinomial`` from an explicit
   ``torch.Generator`` (``_sample_negatives``) where JAX draws
   ``jax.random.categorical``;
4. the queue ring written at ``ptr`` with the momentum features (:268-281).

With ``lm_cfg`` the step is BLIP pretraining's (``train.blip_pretrain``).
Over a mesh the step is data-parallel with whole leaves: each rank encodes
its rows, the queue, the targets and the negatives see the whole batch
(gathers; the negative image tokens through the differentiable gather),
each loss is its rows' share and the gradients are averaged over "data".
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rs_ov_torch.core.params import cast_floating, momentum_copy
from rs_ov_torch.nn.bert import bert_encode
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_lm import init_blip_itm_params, lm_logits, lm_loss, IGNORE_INDEX
from rs_ov_torch.nn.blip_vit import blip_vit_forward
from rs_ov_torch.nn.layers import linear
from rs_ov_torch.parallel.collectives import (all_gather, all_gather_with_grad, mean_over,
                                              mean_share)
from rs_ov_torch.parallel.mesh import mesh_groups
from rs_ov_torch.train import optim
from rs_ov_torch.train.step import reduce_grads

__all__ = ["init_blip_retrieval_state", "make_blip_retrieval_train_step", "ENC_TOKEN_ID"]

# BLIP's tokenizer: bert-base-uncased (30522) + [DEC] = 30522 + [ENC] = 30523
ENC_TOKEN_ID = 30523


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return x32 / x32.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _queue(gen: torch.Generator, d: int, queue_size: int) -> dict:
    return {"image": _l2norm(torch.randn(queue_size, d, generator=gen)).t().contiguous(),
            "text": _l2norm(torch.randn(queue_size, d, generator=gen)).t().contiguous(),
            "idx": torch.full((1, queue_size), -100, dtype=torch.long),
            "ptr": torch.zeros((), dtype=torch.long)}


def init_blip_retrieval_state(gen: torch.Generator, cfg: BlipConfig,
                              queue_size: int = 57600) -> dict:
    """Random fp32 training state on the CPU (rs_ov/train/blip_retrieval.py:47-99):
    trainable params with ``temp`` 0.07, momentum copies, the L2-normalised
    random queue with ``idx`` -100 and ``ptr`` 0."""
    params = init_blip_itm_params(gen, cfg)
    params.temp = nn.Parameter(torch.tensor(0.07))
    params.requires_grad_()
    return {"params": params, "params_m": momentum_copy(params),
            "queue": _queue(gen, cfg.embed_dim, queue_size)}


def _encode(params, images, input_ids, attn_mask, cfg: BlipConfig):
    """(image_embeds [B, L, W], image_feat [B, D], text_feat [B, D]),
    the features L2-normalised in fp32."""
    image_embeds = blip_vit_forward(params.visual, images, cfg.vision)
    image_feat = _l2norm(linear(image_embeds[:, 0], params.vision_proj.w, params.vision_proj.b))
    text_hidden = bert_encode(params.text, input_ids, attn_mask, cfg.text)
    text_feat = _l2norm(linear(text_hidden[:, 0], params.text_proj.w, params.text_proj.b))
    return image_embeds, image_feat, text_feat


@torch.no_grad()
def _ema_update(pairs, momentum: float) -> None:
    """pm <- pm * m + p * (1 - m), in fp32, cast back to pm's dtype."""
    for pm, p in pairs:
        pm.copy_((pm.float() * momentum + p.float() * (1.0 - momentum)).to(pm.dtype))


def _sample_negatives(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One column per row, drawn from softmax(logits) (-1e9 never drawn)."""
    return torch.multinomial(torch.softmax(logits.float(), dim=1), 1, generator=gen)[:, 0]


def decoder_view(text, dec_self_attn):
    """The weight-tied decoder (blip_retrieval.py:217-242): a view of the
    text encoder's leaves with each layer's self-attention replaced by the
    decoder's own; every tied leaf is the encoder's tensor itself."""
    from rs_ov_torch.core.params import leaf_view

    view = leaf_view(text)
    for layer, own in zip(view.layers, dec_self_attn):
        vars(layer).update(vars(leaf_view(own)))
    return view


def make_blip_retrieval_train_step(cfg: BlipConfig, mesh=None, optimizer=None,
                                   momentum: float = 0.995, enc_token_id: int = ENC_TOKEN_ID,
                                   compute_dtype=None, lm_cfg: dict | None = None):
    """(step, init_opt): ``step(state, opt, images, input_ids, attn_mask, idx,
    alpha, gen) -> (state, opt, (loss_ita, loss_itm[, loss_lm]))``, the
    state updated in place; images [b, 3, S, S], input_ids / attn_mask
    [b, L] with [CLS] in slot 0, idx [b] the image ids, this rank's rows;
    ``alpha`` the soft-target weight; ``gen`` a ``torch.Generator`` on the
    params' device for the negatives. The global batch must divide the
    queue. ``step.backward`` runs steps 1-4 without the update and returns
    the losses. ``lm_cfg={'bos_token_id', 'pad_token_id'}``: BLIP
    pretraining's LM branch (the state of ``init_blip_pretrain_state``)."""
    optimizer = optimizer or optim.adamw(1e-5)
    group, _ = mesh_groups(mesh)
    world = 1 if group is None else dist.get_world_size(group)

    def maybe_cast(tree):
        return tree if compute_dtype is None else cast_floating(tree, compute_dtype)

    def backward(state, images, input_ids, attn_mask, idx, alpha, gen):
        params, params_m, queue = state["params"], state["params_m"], state["queue"]
        dev = params.temp.device
        images = torch.as_tensor(images).to(dev, torch.float32)
        input_ids = torch.as_tensor(input_ids).to(dev).long()
        attn_mask = torch.as_tensor(attn_mask).to(dev).long()
        idx = torch.as_tensor(idx).to(dev).long()
        b = images.shape[0]
        q = queue["image"].shape[1]
        if q % (b * world):
            raise ValueError(f"queue size {q} must divide by the global batch {b * world}")

        live = dict(params.named_parameters())
        _ema_update([(pm, live[n]) for n, pm in params_m.named_parameters()],
                    momentum)  # before the momentum forward

        temp = params.temp.float().clamp(0.001, 0.5)
        cparams = maybe_cast(params)
        cimages = images if compute_dtype is None else images.to(compute_dtype)
        image_embeds, image_feat, text_feat = _encode(cparams, cimages, input_ids, attn_mask,
                                                      cfg)

        # ITC (blip_retrieval.py:151-177)
        idx_g = all_gather(idx, group)
        idx_all = torch.cat([idx_g[None], queue["idx"]], dim=1)
        pos = (idx[:, None] == idx_all).float()
        sim_targets = pos / pos.sum(1, keepdim=True)
        with torch.no_grad():
            _, image_feat_m, text_feat_m = _encode(maybe_cast(params_m), cimages, input_ids,
                                                   attn_mask, cfg)
            feat_m_g = (all_gather(image_feat_m, group), all_gather(text_feat_m, group))
            image_all = torch.cat([feat_m_g[0].t(), queue["image"]], dim=1)
            text_all = torch.cat([feat_m_g[1].t(), queue["text"]], dim=1)
            i2t_targets = (alpha * torch.softmax(image_feat_m @ text_all / temp, dim=1)
                           + (1 - alpha) * sim_targets)
            t2i_targets = (alpha * torch.softmax(text_feat_m @ image_all / temp, dim=1)
                           + (1 - alpha) * sim_targets)
        loss_i2t = -(torch.log_softmax(image_feat @ text_all / temp, dim=1)
                     * i2t_targets).sum(1).mean()
        loss_t2i = -(torch.log_softmax(text_feat @ image_all / temp, dim=1)
                     * t2i_targets).sum(1).mean()
        loss_ita = (loss_i2t + loss_t2i) / 2

        # ITM with hard negatives from the whole batch (blip_retrieval.py:179-211)
        enc_ids = input_ids.clone()
        enc_ids[:, 0] = enc_token_id
        with torch.no_grad():
            same = idx[:, None] == idx_g[None, :]
            sim_i2t = image_feat @ all_gather(text_feat.detach(), group).t() / temp
            sim_t2i = text_feat @ all_gather(image_feat.detach(), group).t() / temp
            neg_text = _sample_negatives(sim_i2t.masked_fill(same, -1e9), gen)
            neg_img = _sample_negatives(sim_t2i.masked_fill(same, -1e9), gen)
        embeds_g = image_embeds if group is None else all_gather_with_grad(image_embeds, group)
        img_atts = torch.ones(image_embeds.shape[:2], dtype=torch.long, device=dev)
        vl_hidden = bert_encode(
            cparams.text, torch.cat([enc_ids, enc_ids, all_gather(enc_ids, group)[neg_text]]),
            torch.cat([attn_mask, attn_mask, all_gather(attn_mask, group)[neg_text]]), cfg.text,
            encoder_hidden_states=torch.cat([image_embeds, embeds_g[neg_img], image_embeds]),
            encoder_attention_mask=img_atts.repeat(3, 1))
        vl_logits = linear(vl_hidden[:, 0].float(), params.itm_head.w.float(),
                           params.itm_head.b.float())
        itm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=dev),
                                torch.zeros(2 * b, dtype=torch.long, device=dev)])
        loss_itm = F.cross_entropy(vl_logits, itm_labels)
        losses = [loss_ita, loss_itm]

        if lm_cfg is not None:  # BLIP pretraining's LM branch (blip_retrieval.py:213-245)
            dec_ids = input_ids.clone()
            dec_ids[:, 0] = lm_cfg["bos_token_id"]
            dec_hidden = bert_encode(decoder_view(cparams.text, cparams.dec_self_attn),
                                     dec_ids, attn_mask, cfg.text,
                                     encoder_hidden_states=image_embeds,
                                     encoder_attention_mask=img_atts, causal=True)
            targets = torch.where(dec_ids == lm_cfg["pad_token_id"], IGNORE_INDEX, dec_ids)
            per_seq = lm_loss(lm_logits(cparams.lm_head, dec_hidden), targets, reduction="none")
            losses.append(mean_share(per_seq.sum(), (targets[:, 1:] != IGNORE_INDEX).sum(), group))
        sum(losses).backward()
        reduce_grads(params, group)

        with torch.no_grad():  # the queue ring (blip_retrieval.py:268-281)
            ptr = queue["ptr"]
            cols = (ptr + torch.arange(b * world, device=ptr.device)) % q
            queue["image"].index_copy_(1, cols, feat_m_g[0].t().to(queue["image"].dtype))
            queue["text"].index_copy_(1, cols, feat_m_g[1].t().to(queue["text"].dtype))
            queue["idx"].index_copy_(1, cols, idx_g[None])
            queue["ptr"] = (ptr + b * world) % q
        return tuple(mean_over(x, group) for x in losses)

    def step(state, opt, images, input_ids, attn_mask, idx, alpha, gen):
        opt.zero_grad()
        losses = backward(state, images, input_ids, attn_mask, idx, alpha, gen)
        opt.step()
        return state, opt, losses

    step.backward = backward
    return step, optimizer.init
