"""CLIP's ModifiedResNet vision tower (rs_ov/nn/modified_resnet.py): a
3-conv stem with an average pool, Bottleneck blocks whose strided convs are
stride-1 convs followed by an average pool (anti-aliasing), and a QKV
attention-pool head. BatchNorms run in eval mode (an affine map from the
running statistics); convs and the pool's attention run in fp32. The
parameters are a module tree with the JAX pytree's names."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rs_ov_torch.core.params import module_from_tree
from rs_ov_torch.nn.layers import linear

__all__ = ["ModifiedResNetConfig", "modified_resnet_forward", "resnet_params_from_state_dict"]


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: tuple[int, int, int, int] = (3, 4, 6, 3)
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224
    width: int = 64


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x.float(), w.float(), stride=stride, padding=padding).to(x.dtype)


def _bn(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    scale = p.scale.float() / torch.sqrt(p.var.float() + eps)
    bias = p.bias.float() - p.mean.float() * scale
    return (x.float() * scale[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 1:
        return x
    b, c, h, w = x.shape
    return x.reshape(b, c, h // k, k, w // k, k).mean(dim=(3, 5))


def _bottleneck(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    out = torch.relu(_bn(_conv(x, p.conv1_w), p.bn1))
    out = torch.relu(_bn(_conv(out, p.conv2_w, padding=1), p.bn2))
    out = _bn(_conv(_avgpool(out, stride), p.conv3_w), p.bn3)
    identity = (_bn(_conv(_avgpool(x, stride), p.down_conv_w), p.down_bn)
                if hasattr(p, "down_conv_w") else x)
    return torch.relu(out + identity)


def _attention_pool(x: torch.Tensor, p, heads: int) -> torch.Tensor:
    """The mean token prepended, a per-token pos-embed, separate q / k / v;
    only the mean token queries (reference modified_resnet.py:58-94)."""
    b, c, h, w = x.shape
    tokens = x.reshape(b, c, h * w).transpose(1, 2)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p.positional_embedding.to(tokens.dtype)[None]
    hd = c // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2).float()

    q = split(linear(tokens[:, :1], p.q_w, p.q_b))
    k = split(linear(tokens, p.k_w, p.k_b))
    v = split(linear(tokens, p.v_w, p.v_b))
    attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, 1, c).to(x.dtype)
    return linear(ctx[:, 0], p.c_w, p.c_b)


def modified_resnet_forward(p: nn.Module, images: torch.Tensor,
                            cfg: ModifiedResNetConfig) -> torch.Tensor:
    """[B, 3, S, S] -> the pooled embedding [B, output_dim]."""
    x = images
    for i in (1, 2, 3):
        x = torch.relu(_bn(_conv(x, getattr(p, f"stem_conv{i}_w"), stride=2 if i == 1 else 1,
                                 padding=1), getattr(p, f"stem_bn{i}")))
    x = _avgpool(x, 2)
    for li, blocks in enumerate(p.layers):
        for bi, blk in enumerate(blocks):
            x = _bottleneck(x, blk, (2 if li > 0 else 1) if bi == 0 else 1)
    return _attention_pool(x, p.attnpool, cfg.heads)


def _resnet_tree(sd: Mapping[str, np.ndarray], prefix: str = "") -> dict:
    """A torch ModifiedResNet state dict as the JAX pytree (numpy leaves)."""
    def a(name):
        return np.asarray(sd[f"{prefix}{name}"], np.float32)

    def bn(name):
        return {"scale": a(f"{name}.weight"), "bias": a(f"{name}.bias"),
                "mean": a(f"{name}.running_mean"), "var": a(f"{name}.running_var")}

    tree = {f"stem_conv{i}_w": a(f"conv{i}.weight") for i in (1, 2, 3)}
    tree.update({f"stem_bn{i}": bn(f"bn{i}") for i in (1, 2, 3)})
    tree["layers"] = []
    for li in range(1, 5):
        blocks = []
        while f"{prefix}layer{li}.{len(blocks)}.conv1.weight" in sd:
            pre = f"layer{li}.{len(blocks)}"
            blk = {f"conv{j}_w": a(f"{pre}.conv{j}.weight") for j in (1, 2, 3)}
            blk.update({f"bn{j}": bn(f"{pre}.bn{j}") for j in (1, 2, 3)})
            if f"{prefix}{pre}.downsample.0.weight" in sd:
                blk["down_conv_w"] = a(f"{pre}.downsample.0.weight")
                blk["down_bn"] = bn(f"{pre}.downsample.1")
            blocks.append(blk)
        tree["layers"].append(blocks)
    tree["attnpool"] = {"positional_embedding": a("attnpool.positional_embedding")}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj")):
        tree["attnpool"][f"{ours}_w"] = a(f"attnpool.{theirs}.weight")
        tree["attnpool"][f"{ours}_b"] = a(f"attnpool.{theirs}.bias")
    return tree


def resnet_params_from_state_dict(sd: Mapping[str, np.ndarray], prefix: str = "") -> nn.Module:
    """A torch ModifiedResNet state dict (keys under ``prefix``) as a CPU fp32
    module."""
    return module_from_tree(_resnet_tree(sd, prefix))
