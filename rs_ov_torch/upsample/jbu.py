"""SimFeatUp JBU upsamplers, ``jbu_one`` and ``jbu_stack`` (rs_ov/upsample/jbu.py).

Two layouts, as in the JAX package:

* channel-first (``jbu_one_forward`` / ``jbu_stack_forward``, :140-206,
  :445-470). Each stage: range projection of the guidance (1x1 -> GELU ->
  1x1) -> range logits (kernel K1) -> tap softmax x spatial kernel,
  normalise, fixup MLP (plain torch) -> bicubic 2x of the source -> reflect
  pad -> adaptive conv (K4a for bf16, K4b for fp32). The JAX package's fused
  bf16 branch of this form (K2 between permutes) is the channel-last route
  here, which the segmentor picks for bf16 on the card.
* channel-last (``*_nhwc``, :231-442): the source is [B, h, w, C] and every
  stage's epilogue is K2, or for the classify forms K3 in the last stage
  (final fixup, L2 norm and cosine classifier fused). With
  ``RS_OV_JBU_FUSED_RANGE=1`` (read at each call, off by default as in the
  JAX package, :245-262, :301-313) each stage is one fused-range kernel
  instead, K5a or K5b in the last classify stage: it takes the projection
  channel-last (``_proj2_nhwc``) and the unpadded bicubic source, and
  computes the range logits and both reflect pads itself.

The guidance stays channel-first in both. On the CPU every kernel wrapper
takes its plain version.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from rs_ov_torch.core.params import init_jbu_one_params, init_jbu_stack_params
from rs_ov_torch.kernels.adaptive_conv import adaptive_conv_tapmajor
from rs_ov_torch.kernels.jbu_epilogue import (jbu_epilogue, jbu_epilogue_classify,
                                              jbu_epilogue_fused,
                                              jbu_epilogue_fused_classify)
from rs_ov_torch.kernels.range_logits import range_logits
from rs_ov_torch.utils.resize import (adaptive_avg_pool2d, reflect_pad_2d,
                                      reflect_pad_nhwc, resize_bicubic,
                                      resize_bicubic_nhwc, resize_bilinear)

__all__ = ["unfold", "adaptive_conv", "jbu_module_forward", "jbu_one_forward",
           "jbu_stack_forward", "bilinear_upsample", "jbu_module_forward_nhwc",
           "jbu_module_forward_nhwc_classify", "jbu_one_forward_nhwc",
           "jbu_stack_forward_nhwc", "jbu_one_forward_nhwc_classify",
           "jbu_stack_forward_nhwc_classify", "get_upsampler", "get_upsampler_nhwc",
           "get_upsampler_nhwc_classify", "init_jbu_one_params", "init_jbu_stack_params"]


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


def unfold(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """torch nn.Unfold(kernel) on [B, C, H, W] -> [B, C, k*k, H-k+1, W-k+1]."""
    oh, ow = x.shape[-2] - kernel + 1, x.shape[-1] - kernel + 1
    return torch.stack([x[:, :, u:u + oh, v:v + ow]
                        for u in range(kernel) for v in range(kernel)], dim=2)


def adaptive_conv(inp: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Spatially varying convolution: inp [B, C, H1, W1], filters
    [B, H2, W2, f, f] with H2 = H1 - f + 1 -> [B, C, H2, W2]. The filters go
    tap-major ([B, f*f, H2, W2]) and through the adaptive-conv wrapper: its
    plain loop on the CPU, K4a / K4b on the card (which take the filters in
    inp's dtype)."""
    b, h2, w2, f1, f2 = filters.shape
    if f1 != f2:
        raise ValueError(f"adaptive_conv: square filters only, got {f1}x{f2}")
    filt_t = filters.reshape(b, h2, w2, f1 * f1).permute(0, 3, 1, 2).contiguous()
    return adaptive_conv_tapmajor(inp.contiguous(), filt_t, f1)


def _conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1x1 conv on [B, C, H, W] in fp32, returned in x's dtype."""
    y = torch.einsum("oc,bchw->bohw", w.reshape(w.shape[0], -1).float(), x.float())
    return (y + b.float()[None, :, None, None]).to(x.dtype)


def _proj2(x: torch.Tensor, p) -> torch.Tensor:
    """conv1x1 -> exact GELU -> conv1x1 (the guidance range projection)."""
    return _conv1x1(F.gelu(_conv1x1(x, p.w0, p.b0)), p.w1, p.b1)


def _conv1x1_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1x1 conv on [B, H, W, C] in fp32, returned in x's dtype."""
    y = torch.matmul(x.float(), w.reshape(w.shape[0], -1).float().t())
    return (y + b.float()).to(x.dtype)


def _proj2_nhwc(x: torch.Tensor, p) -> torch.Tensor:
    """_proj2 on [B, H, W, G]: the same fp32 math and round trips through
    x's dtype (rs_ov/upsample/jbu.py:118-128)."""
    return _conv1x1_nhwc(F.gelu(_conv1x1_nhwc(x, p.w0, p.b0)), p.w1, p.b1)


def _range_logits(p, guidance_cf: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, d*d, GH, GW] fp32 local self-correlation of the range projection."""
    proj = _proj2(guidance_cf, p.range_proj).float().contiguous()
    return range_logits(reflect_pad_2d(proj, radius).contiguous(), proj, radius * 2 + 1)


def _fixup_weights(fx):
    return (fx.w0.reshape(fx.w0.shape[0], -1), fx.b0,
            fx.w1.reshape(fx.w1.shape[0], -1), fx.b1)


def jbu_module_forward(p, source: torch.Tensor, guidance: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """One learned-range JBU step, channel-first: source [B, C, h, w] +
    guidance [B, G, GH, GW] -> [B, C, GH, GW] (rs_ov/upsample/jbu.py:140-206)."""
    d = radius * 2 + 1
    gh, gw = guidance.shape[-2:]
    logits = _range_logits(p, guidance, radius)
    pos_temp = torch.exp(p.range_temp.float()).clamp(1e-4, 1e4)
    hr_padded = reflect_pad_2d(resize_bicubic(source, (gh, gw)), radius)
    range_kernel = torch.softmax(logits * pos_temp, dim=1)
    combined = range_kernel * _spatial_kernel(d, p.sigma_spatial)[None, :, None, None]
    combined = combined / combined.sum(1, keepdim=True).clamp_min(1e-7)
    fixup_in = torch.cat([combined.to(guidance.dtype), guidance], dim=1)
    combined = combined + 0.1 * _proj2(fixup_in, p.fixup_proj).float()
    # tap-major filters in the source's dtype: bf16 taps are rounded here,
    # before the kernel (K4a), as rs_ov/upsample/jbu.py:190 does
    combined = combined.to(hr_padded.dtype).contiguous()
    return adaptive_conv_tapmajor(hr_padded.contiguous(), combined, d)


def _final_fixup(x: torch.Tensor, p) -> torch.Tensor:
    """conv1x1 in fp32, cast to x's dtype, then * 0.1 + x in that dtype
    (rs_ov/upsample/jbu.py:209-211)."""
    return _conv1x1(x, p.w, p.b) * 0.1 + x


def _staged_upsample(source, guidance, step_fn, stages: int = 4):
    """stages x2 steps, guidance adaptively pooled to each target size."""
    x = source
    for stage in range(stages):
        h, w = x.shape[-2:]
        x = step_fn(stage, x, adaptive_avg_pool2d(guidance, (h * 2, w * 2)))
    return x


def jbu_one_forward(p, source: torch.Tensor, guidance: torch.Tensor,
                    radius: int = 5, stages: int = 4) -> torch.Tensor:
    """JBUOne: one shared module per stage, then the final fixup."""
    out = _staged_upsample(source, guidance,
                           lambda _s, x, g: jbu_module_forward(p.up, x, g, radius), stages)
    return _final_fixup(out, p.final_fixup)


def jbu_stack_forward(p, source: torch.Tensor, guidance: torch.Tensor,
                      radius: int = 3, stages: int = 4) -> torch.Tensor:
    """JBUStack: module ``ups[stage]`` at each stage, then the final fixup."""
    out = _staged_upsample(source, guidance,
                           lambda s, x, g: jbu_module_forward(p.ups[s], x, g, radius), stages)
    return _final_fixup(out, p.final_fixup)


def bilinear_upsample(_p, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """'bilinear' upsampler: resize the features to the guidance size."""
    return resize_bilinear(source, (guidance.shape[-2], guidance.shape[-1]))


# ---------------------------------------------------------------------------
# channel-last (NHWC)
# ---------------------------------------------------------------------------

def _stage_operands(p, source, guidance_cf, radius):
    """Everything a stage's epilogue kernel takes, up to the fixup weights."""
    d = radius * 2 + 1
    gh, gw = guidance_cf.shape[-2:]
    logits = _range_logits(p, guidance_cf, radius)
    hr_padded = reflect_pad_nhwc(resize_bicubic_nhwc(source, (gh, gw)), radius)
    pos_temp = torch.exp(p.range_temp.float()).clamp(1e-4, 1e4)
    return (hr_padded.contiguous(), logits.permute(0, 2, 3, 1).contiguous(),
            guidance_cf.permute(0, 2, 3, 1).contiguous(),
            _spatial_kernel(d, p.sigma_spatial), pos_temp, *_fixup_weights(p.fixup_proj))


def _fused_range() -> bool:
    return os.environ.get("RS_OV_JBU_FUSED_RANGE", "0") == "1"


def _fused_stage_operands(p, source, guidance_cf, radius):
    """What a fused-range stage's kernel takes, up to the fixup weights: the
    unpadded bicubic source, the channel-last projection in fp32 and the
    channel-first guidance."""
    gh, gw = guidance_cf.shape[-2:]
    proj = _proj2_nhwc(guidance_cf.permute(0, 2, 3, 1), p.range_proj).float().contiguous()
    pos_temp = torch.exp(p.range_temp.float()).clamp(1e-4, 1e4)
    return (resize_bicubic_nhwc(source, (gh, gw)).contiguous(), proj,
            guidance_cf.contiguous(), _spatial_kernel(radius * 2 + 1, p.sigma_spatial),
            pos_temp, *_fixup_weights(p.fixup_proj))


def jbu_module_forward_nhwc(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """One JBU step: source [B, h, w, C] + guidance [B, G, GH, GW] ->
    [B, GH, GW, C]."""
    if _fused_range():
        return jbu_epilogue_fused(*_fused_stage_operands(p, source, guidance_cf, radius),
                                  radius * 2 + 1)
    return jbu_epilogue(*_stage_operands(p, source, guidance_cf, radius),
                        radius * 2 + 1)


def jbu_module_forward_nhwc_classify(p, source: torch.Tensor,
                                     guidance_cf: torch.Tensor, final_fixup,
                                     query_features: torch.Tensor,
                                     radius: int) -> torch.Tensor:
    """The last JBU step with the final fixup, L2 norm and cosine classifier
    fused -> [B, GH, GW, Q] fp32 logits."""
    c = source.shape[-1]
    tail = (final_fixup.w.reshape(c, c), final_fixup.b, query_features, radius * 2 + 1)
    if _fused_range():
        return jbu_epilogue_fused_classify(
            *_fused_stage_operands(p, source, guidance_cf, radius), *tail)
    return jbu_epilogue_classify(*_stage_operands(p, source, guidance_cf, radius), *tail)


def _final_fixup_nhwc(x: torch.Tensor, p) -> torch.Tensor:
    """_final_fixup on [B, H, W, C]: operands in x's dtype, fp32 products and
    sums (exact for bf16 operands), ``* 0.1`` in fp32, rounded, then + x
    (rs_ov/upsample/jbu.py:395-403)."""
    w2 = p.w.reshape(p.w.shape[0], -1)
    y = torch.matmul(x.float(), w2.to(x.dtype).float().t()) + p.b.float()
    return (y * 0.1).to(x.dtype) + x


def _staged_nhwc(modules, source, guidance_cf, radius):
    """One NHWC JBU step per module, guidance pooled to each target size."""
    x = source
    for m in modules:
        h, w = x.shape[1], x.shape[2]
        x = jbu_module_forward_nhwc(m, x, adaptive_avg_pool2d(guidance_cf, (h * 2, w * 2)),
                                    radius)
    return x


def _classify_last_nhwc(m, x, guidance_cf, final_fixup, query_features, radius):
    h, w = x.shape[1], x.shape[2]
    return jbu_module_forward_nhwc_classify(
        m, x, adaptive_avg_pool2d(guidance_cf, (h * 2, w * 2)), final_fixup,
        query_features, radius)


def jbu_one_forward_nhwc(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                         radius: int = 5, stages: int = 4) -> torch.Tensor:
    """JBUOne channel-last: [B, h, w, C] -> [B, 2^stages h, 2^stages w, C]."""
    x = _staged_nhwc([p.up] * stages, source, guidance_cf, radius)
    return _final_fixup_nhwc(x, p.final_fixup)


def jbu_stack_forward_nhwc(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                           radius: int = 3, stages: int = 4) -> torch.Tensor:
    """JBUStack channel-last: ``ups[stage]`` at each stage."""
    x = _staged_nhwc(list(p.ups)[:stages], source, guidance_cf, radius)
    return _final_fixup_nhwc(x, p.final_fixup)


def jbu_one_forward_nhwc_classify(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                                  query_features: torch.Tensor, radius: int = 5,
                                  stages: int = 4) -> torch.Tensor:
    """JBUOne: source [B, h, w, C] + guidance [B, G, GH, GW] + queries [Q, C]
    -> [B, 2^stages h, 2^stages w, Q] fp32 cosine logits. With stages < 4 the
    caller's bilinear logit resize covers the remaining factor."""
    x = _staged_nhwc([p.up] * (stages - 1), source, guidance_cf, radius)
    return _classify_last_nhwc(p.up, x, guidance_cf, p.final_fixup, query_features, radius)


def jbu_stack_forward_nhwc_classify(p, source: torch.Tensor, guidance_cf: torch.Tensor,
                                    query_features: torch.Tensor, radius: int = 3,
                                    stages: int = 4) -> torch.Tensor:
    """JBUStack with the fused classifier tail: stages < 4 uses the first
    stages-1 modules and then the LAST module, trained for the final scale,
    for the classify stage (rs_ov/upsample/jbu.py:361-379)."""
    x = _staged_nhwc(list(p.ups)[:stages - 1], source, guidance_cf, radius)
    return _classify_last_nhwc(p.ups[3], x, guidance_cf, p.final_fixup, query_features,
                               radius)


# ---------------------------------------------------------------------------
# registries (rs_ov/upsample/jbu.py:382-392, :433-442, :533-567)
# ---------------------------------------------------------------------------

def _init_none(_gen: torch.Generator, _dim: int) -> torch.nn.Module:
    return torch.nn.Module()  # bilinear has no parameters


def get_upsampler(name: str, stages: int = 4):
    """(forward, init): forward(params, source [B,C,h,w], guidance [B,G,GH,GW])
    -> upsampled features; init(gen, feat_dim) -> parameter module."""
    if name == "bilinear":
        return bilinear_upsample, _init_none
    if name == "jbu_one":
        return (lambda p, s, g: jbu_one_forward(p, s, g, radius=5, stages=stages),
                lambda gen, dim: init_jbu_one_params(gen, dim))
    if name == "jbu_stack":
        return (lambda p, s, g: jbu_stack_forward(p, s, g, radius=3, stages=stages),
                lambda gen, dim: init_jbu_stack_params(gen, dim))
    if name in ("resize_conv", "ifa", "carafe", "sapa"):
        raise NotImplementedError(f"upsampler '{name}' is not ported yet "
                                  f"(ROADMAP queue 1 item 8)")
    raise ValueError(f"Unknown upsampler '{name}' (known: bilinear, jbu_one, jbu_stack, "
                     f"resize_conv, ifa, carafe, sapa)")


def get_upsampler_nhwc(name: str, stages: int = 4):
    """Channel-last forward(params, source [B,h,w,C], guidance_cf) ->
    [B,GH,GW,C] for the JBU upsamplers, else None."""
    if name == "jbu_one":
        return lambda p, s, g: jbu_one_forward_nhwc(p, s, g, radius=5, stages=stages)
    if name == "jbu_stack":
        return lambda p, s, g: jbu_stack_forward_nhwc(p, s, g, radius=3, stages=stages)
    return None


def get_upsampler_nhwc_classify(name: str, stages: int = 4):
    """Channel-last forward with the classifier fused into the last stage,
    forward(params, source, guidance_cf, query_features) -> [B,GH,GW,Q] fp32,
    for the JBU upsamplers, else None."""
    if name == "jbu_one":
        return lambda p, s, g, qf: jbu_one_forward_nhwc_classify(
            p, s, g, qf, radius=5, stages=stages)
    if name == "jbu_stack":
        return lambda p, s, g, qf: jbu_stack_forward_nhwc_classify(
            p, s, g, qf, radius=3, stages=stages)
    return None
