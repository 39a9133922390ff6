"""The optimiser pieces the JAX package takes from optax: ``adamw`` with a
decay mask, ``warmup_cosine_decay_schedule``, ``clip_by_global_norm``.

``adamw(...)`` is a recipe like ``optax.adamw``; ``.init(params)`` gives the
``Optimizer`` of one module: ``torch.optim.AdamW`` over two parameter groups
(decayed where ``mask(p)``, every leaf without a mask, as optax's default),
the learning rate set from the schedule at each update's count (the first
update takes ``schedule(0)``, as optax's), and optax's clipping first where
asked. optax's defaults are kept: weight decay 1e-4 (``torch.optim.AdamW``'s
is 1e-2), betas (0.9, 0.999), eps 1e-8. Leaves without a gradient take a
zero one, as every leaf of a JAX gradient tree is there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

__all__ = ["adamw", "AdamW", "Optimizer", "warmup_cosine_decay_schedule", "warmup_steps",
           "clip_by_global_norm", "decay_matrices"]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax's schedule: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_steps(warmup: int, steps: int) -> int:
    """The CLIs' clamp (train.py:185-188): the cosine needs decay_steps >
    warmup_steps, so a short run warms up over at most steps - 1."""
    return min(warmup, max(steps - 1, 0))


def decay_matrices(p: torch.Tensor) -> bool:
    """open_clip's recipe: decay matrices and embeddings (ndim >= 2) only."""
    return p.dim() >= 2


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, shard_group=None, sharded=()) -> torch.Tensor:
    """optax's formula: g * max_norm / norm where norm >= max_norm, else g.
    ``sharded`` gradients hold one rank's shard of a leaf split over
    ``shard_group``; their squares are summed over it. Returns the norm."""
    grads = list(grads)
    sharded = {id(g) for g in sharded}
    whole = [g for g in grads if id(g) not in sharded]
    parts = [g for g in grads if id(g) in sharded]
    zero = torch.zeros((), device=grads[0].device)
    sq = sum((g.float().square().sum() for g in whole), zero)
    if parts:
        import torch.distributed as dist

        sq_parts = sum((g.float().square().sum() for g in parts), zero)
        dist.all_reduce(sq_parts, group=shard_group)
        sq = sq + sq_parts
    norm = sq.sqrt()
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


# optax.adamw's b1, b2, eps
BETAS, EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(learning_rate, weight_decay=..., mask=...), optionally
    chained after clip_by_global_norm(clip_norm)."""
    learning_rate: float | Callable = 1e-5
    weight_decay: float = 1e-4
    mask: Callable | None = None
    clip_norm: float | None = None

    def init(self, params: nn.Module, shard_group=None, sharded=()) -> "Optimizer":
        return Optimizer(self, params, shard_group, sharded)


def adamw(learning_rate=1e-5, weight_decay: float = 1e-4, mask: Callable | None = None,
          clip_norm: float | None = None) -> AdamW:
    return AdamW(learning_rate, weight_decay, mask, clip_norm)


class Optimizer:
    """The state of one ``AdamW`` recipe over one module's trainable leaves."""

    def __init__(self, spec: AdamW, params: nn.Module, shard_group=None, sharded=()):
        self.spec = spec
        self.params = [p for p in params.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError("no leaf requires a gradient: switch them on with requires_grad_()")
        decayed = [p for p in self.params if spec.mask is None or spec.mask(p)]
        ids = {id(p) for p in decayed}
        rest = [p for p in self.params if id(p) not in ids]
        groups = [{"params": ps, "weight_decay": wd}
                  for ps, wd in ((decayed, spec.weight_decay), (rest, 0.0)) if ps]
        self.opt = torch.optim.AdamW(groups, lr=0.0, betas=BETAS, eps=EPS)
        self.shard_group = shard_group
        self.sharded = list(sharded)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.spec.clip_norm:
            ids = {id(p) for p in self.sharded}
            clip_by_global_norm([p.grad for p in self.params], self.spec.clip_norm,
                                self.shard_group, [p.grad for p in self.params if id(p) in ids])
        lr = self.spec.learning_rate
        lr = lr(self.count) if callable(lr) else lr
        for g in self.opt.param_groups:
            g["lr"] = lr
        self.opt.step()
        self.count += 1
