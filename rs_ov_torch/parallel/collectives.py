"""Differentiable collectives over a ``torch.distributed`` process group.

What ``jax.lax`` gives the JAX package by construction (rs_ov/train/losses.py,
GSPMD's inserted all-reduces) written as autograd functions:

- ``all_gather_with_grad``: the rank-major concatenation of every rank's
  tensor; the backward sums each rank's gradient of the whole and hands back
  its own rows (an all-reduce, then a slice).
- ``neighbour_exchange``: send to the right neighbour, receive from the
  left (``jax.lax.ppermute`` around the ring); the backward sends the
  gradient to the left and receives from the right.
- ``copy_to_group`` / ``reduce_from_group``: Megatron's pair around a
  sharded product: identity forward with an all-reduce backward, and an
  all-reduce forward with an identity backward.

And the no-grad helpers the steps share: ``all_gather`` (a batch's rows from
every rank), ``mean_over`` (a loss's mean over the ranks, to report it),
``mean_share`` (a rank's share of a mean over the whole batch) and
``sum_over`` (``jax.lax.psum``: the eval's confusion states summed over the
"data" ranks, for ``IoUMetric.merge``). These and
the Megatron pair take ``group=None`` as one process: the tensor as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_gather_with_grad", "neighbour_exchange", "copy_to_group",
           "reduce_from_group", "all_reduce_mean_", "group_size", "all_gather", "mean_over",
           "mean_share", "sum_over"]


def group_size(group) -> int:
    """The ranks in ``group``; 1 for None (one process, no collective)."""
    return 1 if group is None else dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = g.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * n:(r + 1) * n], None


def all_gather_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on each rank -> [world * b, ...], rank-major."""
    return _AllGather.apply(x, group)


def _exchange(x: torch.Tensor, group, to_right: bool) -> torch.Tensor:
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = (rank + (1 if to_right else -1)) % world
    src = (rank - (1 if to_right else -1)) % world
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _NeighbourExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, to_right=True)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, to_right=False), None


def neighbour_exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Rank r's ``x`` arrives at rank r + 1 (mod world)."""
    return _NeighbourExchange.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated input of a column-sharded product."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a row-sharded product's partial results."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


@torch.no_grad()
def all_reduce_mean_(tensors, group) -> None:
    """Replace each tensor by its mean over ``group``, in one flat all-reduce."""
    tensors = list(tensors)
    if not tensors or group is None:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on each rank -> [world * b, ...], rank-major, no gradient."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


@torch.no_grad()
def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of a (detached) tensor over the group's ranks."""
    x = x.detach()
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def mean_share(total: torch.Tensor, count: torch.Tensor, group) -> torch.Tensor:
    """``total`` over the group's mean ``count``: this rank's share of the
    whole batch's sum / count, whose mean over the ranks is that quotient
    (``total / count`` without a group)."""
    return total / mean_over(count.float(), group).clamp_min(1)


@torch.no_grad()
def sum_over(state, group):
    """The sum of ``state`` over the group's ranks, in its own dtype: a tensor
    (the device confusion state, fp32) on its device, or a numpy array (the
    host state, float64), summed on the device the group's backend takes
    (the card for NCCL) and returned as numpy. The state as it is without a
    group."""
    if group is None:
        return state
    if torch.is_tensor(state):
        out = state.clone()
        dist.all_reduce(out, group=group)
        return out
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    out = torch.tensor(np.asarray(state), device=dev)
    dist.all_reduce(out, group=group)
    return out.cpu().numpy()
