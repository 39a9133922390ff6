"""Tensor-parallel placements of the CLIP towers over the mesh's "model" axis
(rs_ov/parallel/sharding.py): Megatron's head / width split.

- attention ``in_proj`` (3w, w): rows; each rank holds the q, k and v rows
  of its own heads (the three w-blocks split alike, so a rank's rows are
  whole heads), and the bias likewise;
- attention ``out_proj`` (w, w): columns, the bias replicated and added once
  after the sum;
- MLP ``c_fc`` (4w, w): rows, the bias split alike; ``c_proj`` (w, 4w):
  columns, the bias replicated;
- everything else (embeddings, LayerNorms, projections, ``logit_scale``,
  ``logit_bias``) replicated.

GSPMD splits ``in_proj``'s 3w rows into contiguous blocks and re-lays them
out itself; explicit operators need whole heads on each rank, hence the
per-block split. ``shard_params`` gives this rank's module, ``gather_params``
the whole one back.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["clip_param_shardings", "shard_params", "gather_params", "load_sharded"]

# leaf (under a block) -> the split: ("qkv", 0) q / k / v blocks each split
# along their rows, ("dim", d) contiguous along dim d
_BLOCK_SPEC = {
    "attn.in_proj_w": ("qkv", 0), "attn.in_proj_b": ("qkv", 0),
    "attn.out_proj_w": ("dim", 1),
    "mlp.c_fc_w": ("dim", 0), "mlp.c_fc_b": ("dim", 0),
    "mlp.c_proj_w": ("dim", 1),
}


def clip_param_shardings(params: nn.Module) -> dict:
    """{parameter name: split, or None where replicated} for a CLIP module."""
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        spec = None
        if len(parts) >= 5 and parts[0] in ("visual", "text") and parts[1] == "blocks":
            spec = _BLOCK_SPEC.get(".".join(parts[3:]))
        out[name] = spec
    return out


def _shard(t: torch.Tensor, spec, rank: int, n: int) -> torch.Tensor:
    kind, dim = spec
    if kind == "qkv":
        blocks = t.reshape(3, t.shape[0] // 3, *t.shape[1:])
        return blocks.chunk(n, dim=1)[rank].reshape(-1, *t.shape[1:]).clone()
    return t.chunk(n, dim=dim)[rank].clone()


def _unshard(parts: list, spec) -> torch.Tensor:
    kind, dim = spec
    if kind == "qkv":
        blocks = [p.reshape(3, p.shape[0] // 3, *p.shape[1:]) for p in parts]
        full = torch.cat(blocks, dim=1)
        return full.reshape(-1, *parts[0].shape[1:])
    return torch.cat(parts, dim=dim)


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p) if not p.isdigit() else module[int(p)]
    return module, leaf


def shard_params(params: nn.Module, mesh) -> nn.Module:
    """This rank's copy of a CLIP module: the leaves of ``clip_param_shardings``
    cut to its shard of the "model" axis, the rest copied whole."""
    group = mesh.get_group("model")
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    local = copy.deepcopy(params)
    for name, spec in clip_param_shardings(params).items():
        if spec is not None:
            owner, leaf = _owner(local, name)
            p = getattr(owner, leaf)
            setattr(owner, leaf, nn.Parameter(_shard(p.data, spec, rank, n),
                                              requires_grad=p.requires_grad))
    return local


@torch.no_grad()
def gather_params(local: nn.Module, mesh) -> nn.Module:
    """The whole CLIP module from every rank's shard (a collective: each
    rank of the "model" axis calls it)."""
    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    full = copy.deepcopy(local)
    for name, spec in clip_param_shardings(local).items():
        if spec is not None:
            owner, leaf = _owner(full, name)
            p = getattr(owner, leaf)
            parts = [torch.empty_like(p.data) for _ in range(n)]
            dist.all_gather(parts, p.data.contiguous(), group=group)
            setattr(owner, leaf, nn.Parameter(_unshard(parts, spec),
                                              requires_grad=p.requires_grad))
    return full


@torch.no_grad()
def load_sharded(local: nn.Module, tree, mesh) -> nn.Module:
    """Copy a whole CLIP tree (numpy leaves, the JAX package's paths) into
    this rank's module, each split leaf cut to its shard."""
    from rs_ov_torch.core.params import _flatten

    group = mesh.get_group("model")
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    flat = _flatten(tree)
    want = dict(local.named_parameters())
    if set(flat) != set(want):
        raise KeyError(f"sharded load: missing {sorted(set(want) - set(flat))}, "
                       f"unused {sorted(set(flat) - set(want))}")
    specs = clip_param_shardings(local)
    for name, p in want.items():
        t = torch.as_tensor(flat[name]).float()
        p.copy_(t if specs[name] is None else _shard(t, specs[name], rank, n))
    return local
