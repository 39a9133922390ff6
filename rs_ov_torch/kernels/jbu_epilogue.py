"""The JBU stage epilogue and its classify variant.

``jbu_epilogue`` computes, per output pixel,

    rk    = softmax(logits * temp)                  over the d*d taps
    comb  = rk * spatial;  comb /= max(sum_taps(comb), 1e-7)
    fix   = conv1x1(gelu(conv1x1([comb -> guidance dtype, guidance])))
    comb' = (comb + 0.1 * fix) -> input dtype
    out[p, c] = sum_t comb'[p, t] * inp[h+u, w+v, c]      (t = u*d + v)

``jbu_epilogue_classify`` continues from the fp32 ``out`` with the pipeline
tail (rs_ov/kernels/jbu_epilogue.py:121-134): yb = out -> dtype; res =
((yb @ Wf^T + bf) * 0.1) -> dtype + yb; L2 normalisation (rsqrt, clamp
1e-24) -> dtype; cosine logits against the queries with fp32 sums.

Each dispatches on the device: a CPU tensor takes the plain version, a CUDA
tensor the hand-written kernel in ``rs_ov_torch/csrc/jbu_epilogue.cu``, which
replaces the TPU kernels ``jbu_epilogue_pallas(nhwc=True)``
(rs_ov/kernels/jbu_epilogue.py:212) and ``jbu_epilogue_classify_pallas``
(:333). The kernels take bf16 features and guidance; fp32 runs take the
channel-first route (plain epilogue + adaptive-conv kernel K4b), as in the
JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rs_ov_torch.kernels.build import check, load_library

__all__ = ["jbu_epilogue", "jbu_epilogue_classify", "jbu_epilogue_plain",
           "jbu_epilogue_classify_plain"]


def _comb_fixed(logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1, dtype):
    """comb' [B, H, W, d*d] in ``dtype`` (the casts of the TPU kernel)."""
    comb = torch.softmax(logits_t.float() * pos_temp.float(), dim=-1) * spatial.float()
    comb = comb / comb.sum(-1, keepdim=True).clamp_min(1e-7)
    x = torch.cat([comb.to(guid_t.dtype).float(), guid_t.float()], dim=-1)
    mid = F.gelu(torch.matmul(x, w0.float().t()) + b0.float())
    fix = torch.matmul(mid, w1.float().t()) + b1.float()
    return (comb + 0.1 * fix).to(dtype)


def _adaptive_conv_nhwc(inp: torch.Tensor, comb: torch.Tensor, d: int) -> torch.Tensor:
    """fp32 sum over taps of comb[..., t] * inp[:, h+u, w+v, :], as a loop of
    shifted multiply-adds (an unfold would materialise d*d copies of inp)."""
    b, h, w, _ = comb.shape
    acc = torch.zeros((b, h, w, inp.shape[-1]), dtype=torch.float32, device=inp.device)
    cf = comb.float()
    for t in range(d * d):
        u, v = divmod(t, d)
        acc += cf[..., t:t + 1] * inp[:, u:u + h, v:v + w, :].float()
    return acc


def jbu_epilogue_plain(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1,
                       diameter: int) -> torch.Tensor:
    """inp [B, H+d-1, W+d-1, C]; logits_t [B, H, W, d*d] fp32; guid_t
    [B, H, W, G]; spatial [d*d]; pos_temp scalar; fixup convs w0 [cmid,
    d*d+G], b0, w1 [d*d, cmid], b1 -> [B, H, W, C] in inp's dtype."""
    comb = _comb_fixed(logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1, inp.dtype)
    return _adaptive_conv_nhwc(inp, comb, diameter).to(inp.dtype)


def jbu_epilogue_classify_plain(inp, logits_t, guid_t, spatial, pos_temp, w0, b0,
                                w1, b1, fixup_w, fixup_b, query_features,
                                diameter: int) -> torch.Tensor:
    """As jbu_epilogue_plain, then the classify tail; fixup_w [C, C], fixup_b
    [C], query_features [Q, C] -> [B, H, W, Q] fp32."""
    dt = inp.dtype
    comb = _comb_fixed(logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1, dt)
    yb = _adaptive_conv_nhwc(inp, comb, diameter).to(dt)
    fx = torch.matmul(yb.float(), fixup_w.to(dt).float().t())
    res = ((fx + fixup_b.float()) * 0.1).to(dt) + yb
    r32 = res.float()
    inv = torch.rsqrt(r32.square().sum(-1, keepdim=True).clamp_min(1e-24))
    rb = (r32 * inv).to(dt)
    return torch.matmul(rb.float(), query_features.to(dt).float().t())


def _check_operands(inp, logits_t, guid_t, spatial, pos_temp, diameter):
    b, hp, wp, c = inp.shape
    _, h, w, dd = logits_t.shape
    d = diameter
    if inp.dtype != torch.bfloat16 or guid_t.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA JBU epilogue takes bf16 features and guidance; fp32 takes "
            "the channel-first route (plain epilogue + adaptive conv K4b), as "
            "rs_ov/upsample/jbu.py does")
    want = {"inp": (inp, (b, h + d - 1, w + d - 1, c), torch.bfloat16),
            "logits_t": (logits_t, (b, h, w, d * d), torch.float32),
            "guid_t": (guid_t, (b, h, w, guid_t.shape[-1]), torch.bfloat16),
            "spatial": (spatial, (d * d,), torch.float32),
            "pos_temp": (pos_temp, (), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != inp.device):
            raise ValueError(f"jbu_epilogue: {name} must be contiguous {dtype} "
                             f"{shape} on {inp.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if c % 2:
        raise ValueError(f"jbu_epilogue kernel takes an even channel count, got {c}")
    return b, h, w, c


def _on(t: torch.Tensor, device: torch.device, name: str) -> torch.Tensor:
    # a host pointer handed to the kernel would fault asynchronously, where
    # no error code reaches the wrapper
    if t.device != device:
        raise ValueError(f"jbu_epilogue: {name} is on {t.device}, the kernel's "
                         f"operands on {device}")
    return t


def _f32(t: torch.Tensor, shape: tuple, device: torch.device) -> torch.Tensor:
    if tuple(t.shape) != shape:
        raise ValueError(f"jbu_epilogue: weight of shape {tuple(t.shape)}, want {shape}")
    return _on(t, device, f"weight {shape}").float().contiguous()


def _fixup_weights(w0, b0, w1, b1, dd, g, device):
    cmid = w0.shape[0]
    return cmid, (_f32(w0, (cmid, dd + g), device), _f32(b0, (cmid,), device),
                  _f32(w1, (dd, cmid), device), _f32(b1, (dd,), device))


def _jbu_epilogue_cuda(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1,
                       diameter):
    b, h, w, c = _check_operands(inp, logits_t, guid_t, spatial, pos_temp, diameter)
    g = guid_t.shape[-1]
    cmid, ws = _fixup_weights(w0, b0, w1, b1, diameter * diameter, g, inp.device)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=inp.device)
    lib = load_library()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.rs_jbu_epilogue(
            inp.data_ptr(), logits_t.data_ptr(), guid_t.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
            b, h, w, c, g, cmid, diameter, stream), "rs_jbu_epilogue")
    jbu_epilogue.launches += 1
    return out


def _jbu_epilogue_classify_cuda(inp, logits_t, guid_t, spatial, pos_temp, w0, b0,
                                w1, b1, fixup_w, fixup_b, query_features, diameter):
    b, h, w, c = _check_operands(inp, logits_t, guid_t, spatial, pos_temp, diameter)
    g = guid_t.shape[-1]
    q = query_features.shape[0]
    cmid, ws = _fixup_weights(w0, b0, w1, b1, diameter * diameter, g, inp.device)
    if tuple(fixup_w.shape) != (c, c) or tuple(query_features.shape) != (q, c):
        raise ValueError(f"jbu_epilogue_classify: fixup_w {tuple(fixup_w.shape)} / "
                         f"queries {tuple(query_features.shape)} do not match C={c}")
    # the kernel reads the fixup conv transposed ([C_in, C_out]) so that
    # threads over output channels load consecutive addresses
    fwt = _on(fixup_w, inp.device, "fixup_w").to(torch.bfloat16).t().contiguous()
    fb = _f32(fixup_b, (c,), inp.device)
    qf = _on(query_features, inp.device, "query_features").to(torch.bfloat16).contiguous()
    out = torch.empty((b, h, w, q), dtype=torch.float32, device=inp.device)
    lib = load_library()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.rs_jbu_epilogue_classify(
            inp.data_ptr(), logits_t.data_ptr(), guid_t.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws), fwt.data_ptr(),
            fb.data_ptr(), qf.data_ptr(), out.data_ptr(),
            b, h, w, c, g, cmid, diameter, q, stream), "rs_jbu_epilogue_classify")
    jbu_epilogue_classify.launches += 1
    return out


def _route(inp: torch.Tensor) -> str:
    if inp.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"jbu_epilogue: no route for {inp.device}")
    return inp.device.type


def jbu_epilogue(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1,
                 diameter: int) -> torch.Tensor:
    """See jbu_epilogue_plain. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if _route(inp) == "cpu":
        return jbu_epilogue_plain(inp, logits_t, guid_t, spatial, pos_temp,
                                  w0, b0, w1, b1, diameter)
    return _jbu_epilogue_cuda(inp, logits_t, guid_t, spatial, pos_temp,
                              w0, b0, w1, b1, diameter)


def jbu_epilogue_classify(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1,
                          fixup_w, fixup_b, query_features, diameter: int) -> torch.Tensor:
    """See jbu_epilogue_classify_plain. CPU tensors take the plain version,
    CUDA tensors the kernel (any number of queries)."""
    if _route(inp) == "cpu":
        return jbu_epilogue_classify_plain(inp, logits_t, guid_t, spatial, pos_temp,
                                           w0, b0, w1, b1, fixup_w, fixup_b,
                                           query_features, diameter)
    return _jbu_epilogue_classify_cuda(inp, logits_t, guid_t, spatial, pos_temp,
                                       w0, b0, w1, b1, fixup_w, fixup_b,
                                       query_features, diameter)


jbu_epilogue.launches = 0  # CUDA kernel launches, for the chip smoke run
jbu_epilogue_classify.launches = 0
