"""Contrastive training losses over a ``torch.distributed`` group
(rs_ov/train/losses.py).

Where the JAX package binds a mesh axis (``axis_name``), these take a process
``group``: ``clip_loss`` gathers the features through
``parallel.collectives.all_gather_with_grad`` (gradients flow through the
gather, the reference's ``gather_with_grad=True``), and ``siglip_loss`` sends
the text features around the ring with ``neighbour_exchange``, whose
backward sends their gradients back. Without a group each is the
single-process loss.

Every rank of a group computes the same ``clip_loss`` (the global batch's);
``siglip_loss`` gives each rank its own image rows' share, whose mean over
the ranks is the global loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rs_ov_torch.parallel.collectives import (all_gather_with_grad, mean_share,
                                              neighbour_exchange)

__all__ = ["clip_loss", "siglip_loss", "coca_loss", "distill_clip_loss"]


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels[:, None]).mean()


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, group=None, local_loss: bool = False) -> torch.Tensor:
    """Symmetric InfoNCE over L2-normalised [b_local, D] features
    (rs_ov/train/losses.py:35-67); ``local_loss`` scores this rank's rows
    against the gathered columns only."""
    b_local = image_features.shape[0]
    if group is not None:
        import torch.distributed as dist

        all_img = all_gather_with_grad(image_features, group)
        all_txt = all_gather_with_grad(text_features, group)
        rank = dist.get_rank(group)
    else:
        all_img, all_txt, rank = image_features, text_features, 0
    dev = image_features.device
    if local_loss and group is not None:
        logits_i = logit_scale * image_features @ all_txt.t()
        logits_t = logit_scale * text_features @ all_img.t()
        labels = b_local * rank + torch.arange(b_local, device=dev)
    else:
        logits_i = logit_scale * all_img @ all_txt.t()
        logits_t = logits_i.t()
        labels = torch.arange(all_img.shape[0], device=dev)
    return 0.5 * (_ce(logits_i, labels) + _ce(logits_t, labels))


def coca_loss(image_features, text_features, caption_logits, caption_labels, logit_scale, *,
              caption_weight: float = 2.0, clip_weight: float = 1.0, pad_id: int = 0,
              group=None):
    """CoCa: (contrastive, caption cross-entropy) (rs_ov/train/losses.py:70-86);
    caption_logits [B, L, V], caption_labels [B, L] with ``pad_id`` ignored.
    With a group the caption term is this rank's token sum over the group's
    token count, times the group size: its mean over the ranks is the
    global batch's mean."""
    contrastive = clip_loss(image_features, text_features, logit_scale, group=group) * clip_weight
    logp = torch.log_softmax(caption_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, caption_labels.long()[..., None])[..., 0]
    mask = (caption_labels != pad_id).float()
    caption = mean_share((nll * mask).sum(), mask.sum(), group) * caption_weight
    return contrastive, caption


def distill_clip_loss(image_features, text_features, logit_scale, dist_image_features,
                      dist_text_features, dist_logit_scale, *, group=None):
    """(contrastive, distillation) against a teacher's softened logits
    (rs_ov/train/losses.py:89-121)."""
    contrastive = clip_loss(image_features, text_features, logit_scale, group=group)
    if group is not None:
        image_features = all_gather_with_grad(image_features, group)
        text_features = all_gather_with_grad(text_features, group)
        dist_image_features = all_gather_with_grad(dist_image_features, group)
        dist_text_features = all_gather_with_grad(dist_text_features, group)
    logits_i = logit_scale * image_features @ text_features.t()
    t_logits_i = dist_logit_scale * dist_image_features @ dist_text_features.t()

    def ce_soft(student, teacher):
        teacher_p = torch.softmax(teacher.float(), dim=-1)
        return -(teacher_p * torch.log_softmax(student.float(), dim=-1)).sum(-1).mean()

    distill = 0.5 * (ce_soft(logits_i, t_logits_i) + ce_soft(logits_i.t(), t_logits_i.t()))
    return contrastive, distill


def _siglip_local(image_features, text_features, logit_scale, logit_bias,
                  negative_only: bool) -> torch.Tensor:
    logits = logit_scale * image_features @ text_features.t() + logit_bias
    n = logits.shape[0]
    if negative_only:
        labels = -torch.ones_like(logits)
    else:
        labels = 2.0 * torch.eye(n, dtype=logits.dtype, device=logits.device) - 1.0
    return F.softplus(-labels * logits).sum() / n


def siglip_loss(image_features, text_features, logit_scale, logit_bias, *,
                group=None) -> torch.Tensor:
    """Pairwise sigmoid loss (rs_ov/train/losses.py:133-160): the local block
    with +1 on the diagonal, then world - 1 ring steps, each scoring the
    text features received from the left as all-negative."""
    loss = _siglip_local(image_features, text_features, logit_scale, logit_bias, False)
    if group is None:
        return loss
    import torch.distributed as dist

    neighbour = text_features
    for _ in range(dist.get_world_size(group) - 1):
        neighbour = neighbour_exchange(neighbour, group)
        loss = loss + _siglip_local(image_features, neighbour, logit_scale, logit_bias, True)
    return loss
