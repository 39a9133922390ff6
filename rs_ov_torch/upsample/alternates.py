"""The alternate SimFeatUp upsamplers (rs_ov/upsample/alternates.py).

  * resize_conv (LayeredResizeConv): four 2x stages of bilinear resize + a
    conv over [features ; resized guidance] with a residual.
  * carafe (CARAFE): per stage a channel compressor and a content encoder
    predict k_up x k_up reassembly kernels per output pixel (pixel-shuffled,
    softmaxed), applied as a spatially varying conv over the source grid.
  * sapa (SAPA): per upsampled pixel, attention logits between a query from
    the LayerNormed pooled guidance and keys of the K x K low-res window
    around its source cell; the softmaxed window reassembles the raw source
    (out-of-range neighbours give zero logits and zero values).
  * ifa (IFA): one 2x step, nearest upsample + sin/cos encodings of a
    [-1, 1] grid and the raw coordinate offsets through a 1x1-conv MLP with
    an eval BatchNorm and LeakyReLU.

No Pallas kernel lies under any of them in the JAX package, so plain torch
ops are their port. Their parameters are ``nn.Module``s with the leaves of
the JAX pytrees under the same names (so a JAX tree crosses with
``core.params.load_numpy_tree``); the ``init_*`` functions draw from an
explicit CPU ``torch.Generator`` with the JAX shapes and scales. Every sum
runs in fp32; each stage returns the source's dtype, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rs_ov_torch.core.params import LayerNorm, _p
from rs_ov_torch.nn.layers import layer_norm
from rs_ov_torch.utils.resize import adaptive_avg_pool2d, resize_bilinear

__all__ = ["resize_conv_forward", "init_resize_conv_params", "ifa_forward", "init_ifa_params",
           "carafe_forward", "carafe_reassemble", "init_carafe_params", "sapa_forward",
           "sapa_sim", "sapa_atn", "init_sapa_params"]


def _conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' conv in fp32, returned in x's dtype."""
    y = F.conv2d(x.float(), w.float(), padding=(w.shape[-1] - 1) // 2)
    return (y + b.float()[None, :, None, None]).to(x.dtype)


def _normal(p: nn.Parameter, std: float, gen: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=gen) * std)


def _nearest2(x: torch.Tensor, scale: int, dims=(-2, -1)) -> torch.Tensor:
    return x.repeat_interleave(scale, dim=dims[0]).repeat_interleave(scale, dim=dims[1])


# ---------------------------------------------------------------------------
# LayeredResizeConv
# ---------------------------------------------------------------------------

class _Conv(nn.Module):
    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.w = _p(cout, cin, k, k)
        self.b = _p(cout)


class ResizeConv(nn.Module):
    def __init__(self, dim: int, kernel: int = 1):
        super().__init__()
        self.convs = nn.ModuleList(_Conv(dim, dim + 3, kernel) for _ in range(4))


def resize_conv_forward(p, source: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """source [B, C, h, w] + guidance [B, 3, H, W] -> [B, C, 16h, 16w]."""
    x = source
    for i, stage in enumerate(p.convs):
        h, w = x.shape[-2:]
        big = resize_bilinear(x, (h * 2, w * 2))
        out = _conv2d_same(torch.cat([big, resize_bilinear(guidance, (h * 2, w * 2))], 1),
                           stage.w, stage.b)
        x = big + (torch.relu(out) if i < 3 else out)
    return x


@torch.no_grad()
def init_resize_conv_params(gen: torch.Generator, dim: int, kernel: int = 1) -> ResizeConv:
    m = ResizeConv(dim, kernel)
    for conv in m.convs:
        _normal(conv.w, (dim + 3) ** -0.5, gen)
        conv.b.zero_()
    return m


# ---------------------------------------------------------------------------
# CARAFE
# ---------------------------------------------------------------------------

class _CarafeStage(nn.Module):
    def __init__(self, dim: int, compressed: int, k2s2: int, encoder_kernel: int):
        super().__init__()
        self.comp_w = _p(compressed, dim, 1, 1)
        self.comp_b = _p(compressed)
        self.enc_w = _p(k2s2, compressed, encoder_kernel, encoder_kernel)
        self.enc_b = _p(k2s2)


class Carafe(nn.Module):
    def __init__(self, dim: int, compressed: int = 64, up_kernel: int = 3,
                 encoder_kernel: int = 3, scale: int = 2):
        super().__init__()
        k2s2 = up_kernel * up_kernel * scale * scale
        self.stages = nn.ModuleList(_CarafeStage(dim, compressed, k2s2, encoder_kernel)
                                    for _ in range(4))


def carafe_reassemble(x: torch.Tensor, masks: torch.Tensor, scale: int,
                      up_kernel: int) -> torch.Tensor:
    """out[b,c,i,j] = sum_{p,q} masks[b, p*k+q, i, j] * x[b, c, i//s + p - r,
    j//s + q - r], r = k // 2, zero outside: x [B, C, H, W], masks
    [B, k*k, sH, sW] -> [B, C, sH, sW] in x's dtype, summed tap by tap in fp32."""
    h, w = x.shape[-2:]
    r = up_kernel // 2
    xp = F.pad(x, (r, r, r, r))
    out = None
    for p in range(up_kernel):
        for q in range(up_kernel):
            up = _nearest2(xp[:, :, p:p + h, q:q + w], scale).float()
            term = masks[:, p * up_kernel + q][:, None].float() * up
            out = term if out is None else out + term
    return out.to(x.dtype)


def carafe_forward(p, source: torch.Tensor, guidance: torch.Tensor, scale: int = 2,
                   up_kernel: int = 3) -> torch.Tensor:
    """Four stacked 2x CARAFE stages; the guidance is unused, as in the
    reference's CarafeUpsampler."""
    del guidance
    x = source
    k2 = up_kernel * up_kernel
    for stage in p.stages:
        mask = _conv2d_same(_conv2d_same(x, stage.comp_w, stage.comp_b),
                            stage.enc_w, stage.enc_b)
        b, _, h, w = mask.shape
        # pixel shuffle [B, k2*s*s, H, W] -> [B, k2, H*s, W*s]
        mask = mask.reshape(b, k2, scale, scale, h, w).permute(0, 1, 4, 2, 5, 3)
        mask = torch.softmax(mask.reshape(b, k2, h * scale, w * scale).float(), dim=1)
        x = carafe_reassemble(x, mask, scale, up_kernel)
    return x


@torch.no_grad()
def init_carafe_params(gen: torch.Generator, dim: int, compressed: int = 64,
                       up_kernel: int = 3, encoder_kernel: int = 3, scale: int = 2) -> Carafe:
    m = Carafe(dim, compressed, up_kernel, encoder_kernel, scale)
    for stage in m.stages:
        _normal(stage.comp_w, dim ** -0.5, gen)
        stage.comp_b.zero_()
        _normal(stage.enc_w, (compressed * encoder_kernel ** 2) ** -0.5, gen)
        stage.enc_b.zero_()
    return m


# ---------------------------------------------------------------------------
# SAPA
# ---------------------------------------------------------------------------

class _SapaStage(nn.Module):
    def __init__(self, dim: int, guidance_dim: int, embedding_dim: int):
        super().__init__()
        self.norm_y = LayerNorm(guidance_dim)
        self.norm_x = LayerNorm(dim)
        self.q_w = _p(embedding_dim, guidance_dim)
        self.q_b = _p(embedding_dim)
        self.k_w = _p(embedding_dim, dim)
        self.k_b = _p(embedding_dim)


class Sapa(nn.Module):
    def __init__(self, dim: int, guidance_dim: int = 3, embedding_dim: int = 64):
        super().__init__()
        self.stages = nn.ModuleList(_SapaStage(dim, guidance_dim, embedding_dim)
                                    for _ in range(4))


def _window_taps(lr: torch.Tensor, up_kernel: int, scale: int):
    """Each tap (u, v) of the K x K window around every source cell, nearest
    upsampled to the output grid: lr [B, h, w, C] -> [B, sh, sw, C] per tap,
    zero outside."""
    hl, wl = lr.shape[1:3]
    r = up_kernel // 2
    lp = F.pad(lr, (0, 0, r, r, r, r))
    for u in range(up_kernel):
        for v in range(up_kernel):
            yield _nearest2(lp[:, u:u + hl, v:v + wl], scale, dims=(1, 2)).float()


def sapa_sim(q: torch.Tensor, k: torch.Tensor, up_kernel: int, scale: int) -> torch.Tensor:
    """q [B, sH, sW, E] x k [B, H, W, E] -> [B, sH, sW, K*K] window
    dot-product logits (the ``sapa.sim`` op)."""
    return torch.stack([(q.float() * up).sum(-1) for up in _window_taps(k, up_kernel, scale)],
                       dim=-1)


def sapa_atn(attn: torch.Tensor, v: torch.Tensor, up_kernel: int, scale: int) -> torch.Tensor:
    """attn [B, sH, sW, K*K] x v [B, H, W, C] -> [B, sH, sW, C] fp32 (the
    ``sapa.atn`` op), summed tap by tap."""
    out = None
    for t, up in enumerate(_window_taps(v, up_kernel, scale)):
        term = attn[..., t, None].float() * up
        out = term if out is None else out + term
    return out


def sapa_forward(p, source: torch.Tensor, guidance: torch.Tensor, up_kernel: int = 5,
                 scale: int = 2) -> torch.Tensor:
    """Four stacked 2x SAPA stages: queries from the LayerNormed adaptively
    pooled guidance, keys from the LayerNormed source, values the raw
    source."""
    x = source
    for stage in p.stages:
        h, w = x.shape[-2:]
        y_n = layer_norm(adaptive_avg_pool2d(guidance, (h * 2, w * 2)).permute(0, 2, 3, 1),
                         stage.norm_y)
        x_nhwc = x.permute(0, 2, 3, 1)
        x_n = layer_norm(x_nhwc, stage.norm_x)
        q = y_n.float() @ stage.q_w.float().t() + stage.q_b.float()
        k = x_n.float() @ stage.k_w.float().t() + stage.k_b.float()
        attn = torch.softmax(sapa_sim(q, k, up_kernel, scale), dim=-1)
        x = sapa_atn(attn, x_nhwc, up_kernel, scale).permute(0, 3, 1, 2).to(source.dtype)
    return x


@torch.no_grad()
def init_sapa_params(gen: torch.Generator, dim: int, guidance_dim: int = 3,
                     embedding_dim: int = 64) -> Sapa:
    """trunc_normal(std=.02) linears cut at +-2 std, zero biases, unit
    LayerNorms (the reference SAPAModule's init)."""
    m = Sapa(dim, guidance_dim, embedding_dim)
    for stage in m.stages:
        for ln in (stage.norm_y, stage.norm_x):
            ln.scale.fill_(1.0)
            ln.bias.zero_()
        for w, b in ((stage.q_w, stage.q_b), (stage.k_w, stage.k_b)):
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0, -2.0, 2.0,
                                          generator=gen) * 0.02)
            b.zero_()
    return m


# ---------------------------------------------------------------------------
# IFA
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = _p(dim)
        self.bias = _p(dim)
        self.mean = _p(dim)
        self.var = _p(dim)


class Ifa(nn.Module):
    def __init__(self, dim: int, n_freqs: int = 20):
        super().__init__()
        cin = dim + 4 * n_freqs + 2
        self.w0 = _p(dim, cin, 1, 1)
        self.b0 = _p(dim)
        self.bn = BatchNorm(dim)
        self.w1 = _p(dim, dim, 1, 1)
        self.b1 = _p(dim)


def _implicit_encodings(h: int, w: int, n_freqs: int) -> np.ndarray:
    """sin / cos of the featurizer's own [-1, 1] grid times e^[-2, 10]
    frequencies, [4 n_freqs, h, w], evaluated in float64 (the phases reach
    e^10, where fp32 sin is chaotic) and rounded to fp32, as the JAX package does."""
    yy, xx = np.meshgrid(np.linspace(-1.0, 1.0, h), np.linspace(-1.0, 1.0, w), indexing="ij")
    freqs = np.exp(np.linspace(-2.0, 10.0, n_freqs)).reshape(n_freqs, 1, 1, 1)
    feats = (np.stack([yy, xx])[None] * freqs).reshape(n_freqs * 2, h, w)
    return np.concatenate([np.sin(feats), np.cos(feats)]).astype(np.float32)


def _bn2d(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Eval BatchNorm; the scale is formed in the weights' dtype."""
    scale = (p.scale / torch.sqrt(p.var + eps)).float()
    bias = p.bias.float() - p.mean.float() * scale
    return (x.float() * scale[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)


def ifa_forward(p, source: torch.Tensor, guidance: torch.Tensor,
                n_freqs: int = 20) -> torch.Tensor:
    """One 2x IFA step (the reference's IFA doubles the resolution once):
    source [B, C, h, w] -> [B, C, 2h, 2w]; the guidance is unused."""
    del guidance
    b, _, h, w = source.shape
    up = _nearest2(source, 2)
    # the coordinate offset of each output pixel from its nearest source cell
    coords = []
    for n in (h, w):
        lr = np.linspace(0.0, float(n), n, dtype=np.float32)
        hr = np.linspace(0.0, float(n), 2 * n, dtype=np.float32)
        coords.append(np.repeat(lr, 2) - hr)
    diff = np.stack(np.broadcast_arrays(coords[0][:, None], coords[1][None, :]))
    feats = np.concatenate([_implicit_encodings(2 * h, 2 * w, n_freqs),
                            diff.astype(np.float32)])
    feats = torch.from_numpy(feats).to(source.device, source.dtype)
    x = torch.cat([up, feats.expand(b, -1, -1, -1)], dim=1)
    x = _bn2d(_conv2d_same(x, p.w0, p.b0), p.bn)
    x = torch.where(x >= 0, x, 0.01 * x)  # LeakyReLU's default slope
    return _conv2d_same(x, p.w1, p.b1)


@torch.no_grad()
def init_ifa_params(gen: torch.Generator, dim: int, n_freqs: int = 20) -> Ifa:
    m = Ifa(dim, n_freqs)
    cin = dim + 4 * n_freqs + 2
    _normal(m.w0, cin ** -0.5, gen)
    m.b0.zero_()
    m.bn.scale.fill_(1.0)
    m.bn.bias.zero_()
    m.bn.mean.zero_()
    m.bn.var.fill_(1.0)
    _normal(m.w1, dim ** -0.5, gen)
    m.b1.zero_()
    return m
