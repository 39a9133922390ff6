"""The CLIP / SigLIP / CoCa training steps (rs_ov/train/step.py).

A step takes this rank's module of fp32 master leaves (``requires_grad_()``)
and its ``Optimizer`` (``train.optim``), updates both in place and returns
``(params, opt, loss)`` as the JAX step returns its new state.

- ``compute_dtype`` (bf16): the forward and backward run on a
  ``cast_floating`` copy, whose gradients come back into the fp32 masters;
  LayerNorms, the embeddings' L2 norms, the loss and ``logit_scale`` stay in
  fp32 (rs_ov/train/step.py:110-118).
- ``remat``: each transformer block under ``torch.utils.checkpoint``
  (non-reentrant); nothing in a block draws a random number, so no RNG
  state is kept.
- ``accum_steps`` > 1: gradient accumulation with full-batch negatives
  (open_clip's ``--accum-freq``): a no-grad pass caches every micro-batch's
  features, then each micro-batch is encoded again with gradient, spliced
  into the cache and the full-batch loss differentiated; the gradients'
  sum is the full batch's. The ``logit_scale`` / ``logit_bias`` path
  carries gradient at micro-step 0 only (``_scale_live``), and the step
  returns micro-step 0's loss.
- ``mesh`` (``parallel.mesh.make_mesh``): each rank encodes its own rows of
  the global batch (rank-major over "data"); the losses see every rank's
  features through the differentiable gather (CLIP) or ring (SigLIP); the
  gradients are averaged over "data" (every rank differentiates the same
  global CLIP loss, and the gather's backward sums each rank's share, so
  the mean is the global batch's gradient; SigLIP's ring gives each rank
  its own rows' share, whose sum over ranks is the global loss times the
  group's size). Over "model" the CLIP blocks run Megatron's tensor
  parallelism on ``parallel.sharding.shard_params``' leaves. CoCa is
  data-parallel with whole leaves, as in JAX (step.py:198-212).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rs_ov_torch.core.config import CLIPConfig
from rs_ov_torch.core.params import cast_floating
from rs_ov_torch.nn.attention import _bmm, _merge_heads, _softmax32, qkv_projection
from rs_ov_torch.nn.layers import gelu, layer_norm, linear, matmul32, quick_gelu
from rs_ov_torch.nn.vit import _patchify
from rs_ov_torch.parallel.collectives import (all_reduce_mean_, copy_to_group, group_size,
                                              mean_over, reduce_from_group)
from rs_ov_torch.parallel.mesh import mesh_groups
from rs_ov_torch.parallel.sharding import clip_param_shardings
from rs_ov_torch.text.encoder import causal_mask
from rs_ov_torch.train import optim
from rs_ov_torch.train.losses import clip_loss, coca_loss, siglip_loss

__all__ = ["encode_image_train", "encode_text_train", "make_clip_train_step",
           "make_coca_train_step", "reduce_grads"]


def _row_parallel(x, w, b, group):
    """linear() over a column-split weight: fp32 partial products summed over
    the group, then the bias once, one cast to x's dtype."""
    y = reduce_from_group(matmul32(x, w.t()), group) + b.float()
    return y.to(x.dtype)


def _block(blk, x, heads, act, mask, tp_group):
    """One pre-LN block in Megatron's form: this rank's heads and MLP columns
    (all of them without a group), whole activations between."""
    h = copy_to_group(layer_norm(x, blk.ln_1), tp_group)
    q, k, v = qkv_projection(blk.attn, h, heads // group_size(tp_group))
    attn = _bmm(q * (x.shape[-1] // heads) ** -0.5, k.transpose(-1, -2))
    attn = _softmax32(attn if mask is None else attn + mask)
    ctx = _merge_heads(_bmm(attn.to(v.dtype), v).to(x.dtype))
    y = x + _row_parallel(ctx, blk.attn.out_proj_w, blk.attn.out_proj_b, tp_group)
    h = copy_to_group(layer_norm(y, blk.ln_2), tp_group)
    inner = act(linear(h, blk.mlp.c_fc_w, blk.mlp.c_fc_b))
    return y + _row_parallel(inner, blk.mlp.c_proj_w, blk.mlp.c_proj_b, tp_group)


def _run_blocks(x, blocks, heads, act, mask=None, remat=True, tp_group=None):
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, blk, x, heads, act, mask, tp_group, use_reentrant=False)
        else:
            x = _block(blk, x, heads, act, mask, tp_group)
    return x


def _l2norm32(pooled: torch.Tensor) -> torch.Tensor:
    p32 = pooled.float()
    return p32 / p32.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def encode_image_train(params, images: torch.Tensor, cfg: CLIPConfig, remat: bool = True,
                       tp_group=None) -> torch.Tensor:
    """The CLIP image embedding of the training path: [B, 3, H, W] -> [B, D]
    fp32, L2-normalised (rs_ov/train/step.py:44-61)."""
    v, vcfg = params.visual, cfg.vision
    act = quick_gelu if cfg.quick_gelu else gelu
    x = _patchify(images, v.conv1_w)
    cls = v.class_embedding[None, None, :].expand(images.shape[0], 1, vcfg.width).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(x.dtype)[None]
    x = layer_norm(x, v.ln_pre)
    x = _run_blocks(x, v.blocks, vcfg.heads, act, remat=remat, tp_group=tp_group)
    x = layer_norm(x, v.ln_post)
    return _l2norm32(x[:, 0] @ v.proj.to(x.dtype))


def encode_text_train(params, text_ids: torch.Tensor, cfg: CLIPConfig, remat: bool = True,
                      tp_group=None) -> torch.Tensor:
    """The CLIP text embedding of the training path: [B, L] ids -> [B, D] fp32,
    L2-normalised, pooled at the highest id (rs_ov/train/step.py:64-77)."""
    t, tcfg = params.text, cfg.text
    act = quick_gelu if cfg.quick_gelu else gelu
    x = t.token_embedding[text_ids]
    x = x + t.positional_embedding.to(x.dtype)[None]
    mask = None if tcfg.no_causal_mask else causal_mask(tcfg.context_length, x.device)
    x = _run_blocks(x, t.blocks, tcfg.heads, act, mask=mask, remat=remat, tp_group=tp_group)
    x = layer_norm(x, t.ln_final)
    eot = text_ids.argmax(-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot] @ t.text_projection.to(x.dtype)
    return _l2norm32(pooled)


def _scale_live(micro_step: int) -> bool:
    """Whether the logit_scale / logit_bias path carries gradient at this
    micro-step: only the first, so it is counted once."""
    return micro_step == 0


def reduce_grads(params, group) -> None:
    """Average the trainable leaves' gradients over ``group`` (a missing
    gradient counts as zero, as JAX's tree has one for every leaf)."""
    if group is None:
        return
    ps = [p for p in params.parameters() if p.requires_grad]
    for p in ps:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_([p.grad for p in ps], group)


def _device_of(params) -> torch.device:
    return params.logit_scale.device


def _init_opt(optimizer, tp_group):
    def init(params):
        sharded = []
        if tp_group is not None:
            specs = clip_param_shardings(params)
            sharded = [p for n, p in params.named_parameters() if specs.get(n)]
        return optimizer.init(params, shard_group=tp_group, sharded=sharded)

    return init


def make_clip_train_step(cfg: CLIPConfig, mesh=None, optimizer=None, remat: bool = True,
                         compute_dtype=None, loss: str = "clip", accum_steps: int = 1):
    """(step, init_opt): ``step(params, opt, images, texts) -> (params, opt,
    loss)``, images [b, 3, S, S] and texts [b, L] this rank's rows (all of
    them without a mesh); ``step.backward(params, images, texts)`` leaves the
    step's (reduced) gradients in ``.grad`` and returns the loss, without
    the update. ``loss='siglip'`` needs ``params.logit_bias``. The global
    batch must divide into ``accum_steps`` micro-batches."""
    optimizer = optimizer or optim.adamw(1e-5)
    data_group, model_group = mesh_groups(mesh)
    tp_group = model_group if group_size(model_group) > 1 else None
    tp = group_size(tp_group)
    if cfg.vision.heads % tp or cfg.text.heads % tp:
        raise ValueError(f"{tp}-way tensor parallelism needs the heads to divide by {tp}")

    def encode_pair(params, images, texts):
        cparams = params
        if compute_dtype is not None:
            cparams = cast_floating(params, compute_dtype)
            images = images.to(compute_dtype)
        return (encode_image_train(cparams, images, cfg, remat=remat, tp_group=tp_group),
                encode_text_train(cparams, texts, cfg, remat=remat, tp_group=tp_group))

    def full_loss(params, img_f, txt_f, live: bool):
        scale = torch.exp(params.logit_scale.float())  # from the master leaf, in fp32
        scale = scale if live else scale.detach()
        if loss == "siglip":
            bias = params.logit_bias.float()
            bias = bias if live else bias.detach()
            return siglip_loss(img_f, txt_f, scale, bias, group=data_group)
        return clip_loss(img_f, txt_f, scale, group=data_group)

    def backward(params, images, texts):
        dev = _device_of(params)
        images = torch.as_tensor(images).to(dev, torch.float32)
        texts = torch.as_tensor(texts).to(dev).long()
        if accum_steps == 1:
            out = full_loss(params, *encode_pair(params, images, texts), True)
            out.backward()
            first = out.detach()
        else:
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not divide into {accum_steps} micro-batches")
            mb = b // accum_steps
            ims, txs = images.split(mb), texts.split(mb)
            with torch.no_grad():  # pass 1: every micro-batch's features
                cached = [encode_pair(params, im, tx) for im, tx in zip(ims, txs)]
            img_all = torch.stack([c[0] for c in cached])
            txt_all = torch.stack([c[1] for c in cached])
            for i, (im, tx) in enumerate(zip(ims, txs)):  # pass 2, one micro-batch live
                f_i, t_i = encode_pair(params, im, tx)
                ia = torch.cat([img_all[:i], f_i[None], img_all[i + 1:]]).reshape(b, -1)
                ta = torch.cat([txt_all[:i], t_i[None], txt_all[i + 1:]]).reshape(b, -1)
                out = full_loss(params, ia, ta, _scale_live(i))
                out.backward()
                if i == 0:
                    first = out.detach()
        reduce_grads(params, data_group)
        return mean_over(first, data_group) if loss == "siglip" else first

    def step(params, opt, images, texts):
        opt.zero_grad()
        out = backward(params, images, texts)
        opt.step()
        return params, opt, out

    step.backward = backward
    return step, _init_opt(optimizer, tp_group)


def make_coca_train_step(cfg, mesh=None, optimizer=None, compute_dtype=None,
                         caption_weight: float = 2.0, clip_weight: float = 1.0):
    """(step, init_opt) of the CoCa step (rs_ov/train/step.py:198-253):
    contrastive + caption cross-entropy over ``nn.coca.coca_forward``;
    ``step(params, opt, images, texts) -> (params, opt, (contrastive,
    caption))``, ``step.backward`` as the CLIP step's. Data-parallel over
    the mesh's "data" axis with whole leaves."""
    from rs_ov_torch.nn.coca import coca_forward

    optimizer = optimizer or optim.adamw(1e-5)
    data_group, _ = mesh_groups(mesh)

    def backward(params, images, texts):
        dev = _device_of(params)
        images = torch.as_tensor(images).to(dev, torch.float32)
        texts = torch.as_tensor(texts).to(dev).long()
        cparams = params
        if compute_dtype is not None:
            cparams = cast_floating(params, compute_dtype)
            images = images.to(compute_dtype)
        out = coca_forward(cparams, images, texts, cfg)
        scale = torch.exp(params.logit_scale.float())
        contrastive, caption = coca_loss(
            out["image_features"].float(), out["text_features"].float(), out["logits"],
            out["labels"], scale, caption_weight=caption_weight, clip_weight=clip_weight,
            pad_id=cfg.pad_id, group=data_group)
        (contrastive + caption).backward()
        reduce_grads(params, data_group)
        return contrastive.detach(), mean_over(caption, data_group)

    def step(params, opt, images, texts):
        opt.zero_grad()
        parts = backward(params, images, texts)
        opt.step()
        return params, opt, parts

    step.backward = backward
    return step, optimizer.init
