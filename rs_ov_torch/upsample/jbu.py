"""SimFeatUp ``jbu_one`` upsampler, channel-last with the classifier fused
into the last stage (rs_ov/upsample/jbu.py:231-358, split route).

Each stage: range projection of the guidance (1x1 -> GELU -> 1x1, in fp32)
-> reflect pad -> range logits (kernel K1) -> bicubic 2x of the source ->
reflect pad -> epilogue (K2), or for the last stage the epilogue with the
final fixup, L2 norm and cosine classifier (K3). The source is NHWC, the
guidance channel-first, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from rs_ov_torch.core.params import init_jbu_one_params  # noqa: F401  (re-export)
from rs_ov_torch.kernels.jbu_epilogue import jbu_epilogue, jbu_epilogue_classify
from rs_ov_torch.kernels.range_logits import range_logits
from rs_ov_torch.utils.resize import (adaptive_avg_pool2d, reflect_pad_2d,
                                      reflect_pad_nhwc, resize_bicubic_nhwc)

__all__ = ["jbu_module_forward_nhwc", "jbu_module_forward_nhwc_classify",
           "jbu_one_forward_nhwc_classify", "init_jbu_one_params"]


@functools.lru_cache(maxsize=None)
def _tap_sq_dist(diameter: int, device: torch.device) -> torch.Tensor:
    """x^2 + y^2 over a [-1, 1]^2 window, flattened in meshgrid 'ij' order
    (tap u*d + v); cached on the device (no per-call host copy)."""
    dist = np.linspace(-1.0, 1.0, diameter, dtype=np.float32)
    return torch.from_numpy((dist[:, None] ** 2 + dist[None, :] ** 2).reshape(-1)).to(device)


def _spatial_kernel(diameter: int, sigma_spatial: torch.Tensor) -> torch.Tensor:
    """exp(-(x^2 + y^2) / (2 sigma^2)) per tap -> [d*d] fp32."""
    sigma = sigma_spatial.float()
    return torch.exp(-_tap_sq_dist(diameter, sigma.device) / (2.0 * sigma ** 2))


def _conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1x1 conv on [B, C, H, W] in fp32, returned in x's dtype."""
    y = torch.einsum("oc,bchw->bohw", w.reshape(w.shape[0], -1).float(), x.float())
    return (y + b.float()[None, :, None, None]).to(x.dtype)


def _proj2(x: torch.Tensor, p) -> torch.Tensor:
    """conv1x1 -> exact GELU -> conv1x1 (the guidance range projection)."""
    return _conv1x1(F.gelu(_conv1x1(x, p.w0, p.b0)), p.w1, p.b1)


def _stage_operands(p, source, guidance_cf, radius):
    """Everything a stage's epilogue takes, up to the fixup weights."""
    d = radius * 2 + 1
    gh, gw = guidance_cf.shape[-2:]
    proj = _proj2(guidance_cf, p.range_proj).float().contiguous()
    logits = range_logits(reflect_pad_2d(proj, radius).contiguous(), proj, d)
    hr_padded = reflect_pad_nhwc(resize_bicubic_nhwc(source, (gh, gw)), radius)
    pos_temp = torch.exp(p.range_temp.float()).clamp(1e-4, 1e4)
    fx = p.fixup_proj
    return (hr_padded.contiguous(), logits.permute(0, 2, 3, 1).contiguous(),
            guidance_cf.permute(0, 2, 3, 1).contiguous(),
            _spatial_kernel(d, p.sigma_spatial), pos_temp,
            fx.w0.reshape(fx.w0.shape[0], -1), fx.b0,
            fx.w1.reshape(fx.w1.shape[0], -1), fx.b1)


def jbu_module_forward_nhwc(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """One JBU step: source [B, h, w, C] + guidance [B, G, GH, GW] ->
    [B, GH, GW, C]."""
    return jbu_epilogue(*_stage_operands(p, source, guidance_cf, radius),
                        radius * 2 + 1)


def jbu_module_forward_nhwc_classify(p, source: torch.Tensor,
                                     guidance_cf: torch.Tensor, final_fixup,
                                     query_features: torch.Tensor,
                                     radius: int) -> torch.Tensor:
    """The last JBU step with the final fixup, L2 norm and cosine classifier
    fused -> [B, GH, GW, Q] fp32 logits."""
    c = source.shape[-1]
    return jbu_epilogue_classify(*_stage_operands(p, source, guidance_cf, radius),
                                 final_fixup.w.reshape(c, c), final_fixup.b,
                                 query_features, radius * 2 + 1)


def jbu_one_forward_nhwc_classify(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                                  query_features: torch.Tensor, radius: int = 5,
                                  stages: int = 4) -> torch.Tensor:
    """JBUOne: source [B, h, w, C] + guidance [B, G, GH, GW] + queries [Q, C]
    -> [B, 2^stages h, 2^stages w, Q] fp32 cosine logits. With stages < 4 the
    caller's bilinear logit resize covers the remaining factor."""
    x = source
    for _ in range(stages - 1):
        h, w = x.shape[1], x.shape[2]
        x = jbu_module_forward_nhwc(p.up, x, adaptive_avg_pool2d(guidance_cf, (h * 2, w * 2)),
                                    radius)
    h, w = x.shape[1], x.shape[2]
    return jbu_module_forward_nhwc_classify(
        p.up, x, adaptive_avg_pool2d(guidance_cf, (h * 2, w * 2)), p.final_fixup,
        query_features, radius)
