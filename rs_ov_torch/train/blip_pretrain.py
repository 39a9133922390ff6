"""BLIP pretraining: ITC (momentum + queue) + ITM (hard negatives) + the
caption LM through a weight-tied decoder (rs_ov/train/blip_pretrain.py).

The decoder shares every leaf with the text encoder but each layer's
self-attention (the reference's ``tie_encoder_decoder_weights`` with
``skip_key='/attention'``): ``params.dec_self_attn`` holds the decoder's own
self-attention layers and ``params.lm_head`` its head, and the step builds
the decoder as a view of the encoder's leaves (``blip_retrieval.decoder_view``)
at every forward. So each tied leaf exists once and AdamW cannot untie it.
The step is the retrieval step with its LM branch on.
"""

from __future__ import annotations

import torch

from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_lm import _draw, add_pretrain_decoder
from rs_ov_torch.train.blip_retrieval import (ENC_TOKEN_ID, init_blip_retrieval_state,
                                              make_blip_retrieval_train_step)

__all__ = ["init_blip_pretrain_state", "make_blip_pretrain_train_step", "BOS_TOKEN_ID"]

# BLIP's tokenizer: [DEC] = 30522
BOS_TOKEN_ID = 30522


@torch.no_grad()
def init_blip_pretrain_state(gen: torch.Generator, cfg: BlipConfig,
                             queue_size: int = 57600) -> dict:
    """The retrieval state with the decoder's self-attention layers
    (N(0, 0.02) weights, zero biases) and LM head added to ``params``."""
    state = init_blip_retrieval_state(gen, cfg, queue_size=queue_size)
    params = add_pretrain_decoder(state["params"], cfg.text.hidden_size,
                                  cfg.text.vocab_size, cfg.text.num_layers)
    for layer in params.dec_self_attn:
        _draw(layer, gen)
    _draw(params.lm_head, gen)
    params.requires_grad_()
    return state


def make_blip_pretrain_train_step(cfg: BlipConfig, mesh=None, optimizer=None,
                                  momentum: float = 0.995, enc_token_id: int = ENC_TOKEN_ID,
                                  bos_token_id: int = BOS_TOKEN_ID, pad_token_id: int = 0,
                                  compute_dtype=None):
    """``step(state, opt, images, input_ids, attn_mask, idx, alpha, gen) ->
    (state, opt, (loss_ita, loss_itm, loss_lm))``; input_ids carry [CLS] in
    slot 0 (rewritten to [ENC] for ITM and to [DEC] for the LM)."""
    return make_blip_retrieval_train_step(
        cfg, mesh, optimizer=optimizer, momentum=momentum, enc_token_id=enc_token_id,
        compute_dtype=compute_dtype,
        lm_cfg={"bos_token_id": bos_token_id, "pad_token_id": pad_token_id})

