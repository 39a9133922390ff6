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

``jbu_epilogue_fused`` and ``jbu_epilogue_fused_classify`` are the whole
stage of the fused-range route (rs_ov/kernels/jbu_epilogue.py:456-718): from
the UNpadded source ``inp [B, H, W, C]`` and range projection ``proj
[B, H, W, K]`` they compute the logits themselves,

    logits[p, u*d+v] = sum_k proj[h, w, k] * proj[h+u-r, w+v-r, k]

at reflected indices (i < 0 -> -i, i >= n -> 2n-2-i), and reflect-pad the
source inside, then continue as the two above. The guidance comes
channel-first, ``guid_cf [B, G, H, W]``.

Each dispatches on the device: a CPU tensor takes the plain version, a CUDA
tensor the hand-written kernel, which replaces a TPU kernel:
``jbu_epilogue_pallas(nhwc=True)`` (rs_ov/kernels/jbu_epilogue.py:212),
``jbu_epilogue_classify_pallas`` (:333), ``jbu_epilogue_fused_pallas``
(:640) and ``jbu_epilogue_fused_classify_pallas`` (:675), all four in
``rs_ov_torch/csrc/jbu_classify_sm90.cu`` on one block design (the adaptive
conv, and the classify tail's fixup and cosine products, on the tensor
cores; the fused stages compute their range logits in the block first).
Each is declared as ``build.Kernel`` (the operator ``rs_ov::<its name>``).
They take d <= 17 (odd for the fused stages), an even C and Q <= 128, the
TPU kernels' limits, and bf16 features and guidance; fp32 runs take the
channel-first route (plain epilogue + adaptive-conv kernel K4b), as in the
JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rs_ov_torch.kernels.build import Kernel
from rs_ov_torch.utils.resize import reflect_pad_nhwc

__all__ = ["jbu_epilogue", "jbu_epilogue_classify", "jbu_epilogue_plain",
           "jbu_epilogue_classify_plain", "jbu_epilogue_fused",
           "jbu_epilogue_fused_classify", "jbu_epilogue_fused_plain",
           "jbu_epilogue_fused_classify_plain"]

SMEM_MAX = 232448  # bytes of shared memory a block may use on Hopper
MAX_D = 17  # the largest diameter K2, K3, K5a and K5b take
CLASSIFY_MAX_Q = 128  # the most queries K3 and K5b take
# the blocks of csrc/jbu_classify_sm90.cu, for _block_smem_bytes: rows and
# columns of output pixels, fixup-MLP weight rows and conv channels a stage,
# a tail stage's columns and row stride, the repair queue, window channels
_ROWS, _COLS, _KC, _CCH, _NB, _KBS, _QCAP, _KCH = 2, 16, 32, 512, 128, 72, 512, 32


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


def _cls_tail(y, fixup_w, fixup_b, query_features, dt):
    """The classify tail on the fp32 conv output y [..., C] -> [..., Q] fp32."""
    yb = y.to(dt)
    fx = torch.matmul(yb.float(), fixup_w.to(dt).float().t())
    res = ((fx + fixup_b.float()) * 0.1).to(dt) + yb
    r32 = res.float()
    inv = torch.rsqrt(r32.square().sum(-1, keepdim=True).clamp_min(1e-24))
    rb = (r32 * inv).to(dt)
    return torch.matmul(rb.float(), query_features.to(dt).float().t())


def jbu_epilogue_classify_plain(inp, logits_t, guid_t, spatial, pos_temp, w0, b0,
                                w1, b1, fixup_w, fixup_b, query_features,
                                diameter: int) -> torch.Tensor:
    """As jbu_epilogue_plain, then the classify tail; fixup_w [C, C], fixup_b
    [C], query_features [Q, C] -> [B, H, W, Q] fp32."""
    dt = inp.dtype
    comb = _comb_fixed(logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1, dt)
    return _cls_tail(_adaptive_conv_nhwc(inp, comb, diameter), fixup_w, fixup_b,
                     query_features, dt)


def _pad_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """The fused stage's padding of the source and the projection: reflect."""
    return reflect_pad_nhwc(x, r)


def _fused_logits(proj: torch.Tensor, d: int) -> torch.Tensor:
    """proj [B, H, W, K] -> [B, H, W, d*d] fp32 local self-correlation.

    Summed over k = 0..K-1 in order, each step one fused multiply-add (the
    exact product, held in fp64, added and rounded once), as the kernel and
    K1's kernel sum: another order moves the logits' last bits, and those
    flip the bf16 rounding of comb' taps, which the tight bound of the
    classify tail would count against the kernel."""
    b, h, w, k = proj.shape
    p32 = proj.float()
    # [B, H, W, K, d, d]: the d x d window of every pixel, a view
    win = _pad_nhwc(p32, d // 2).unfold(1, d, 1).unfold(2, d, 1)
    acc = torch.zeros((b, h, w, d * d), dtype=torch.float32, device=proj.device)
    for i in range(k):
        nb = win[:, :, :, i].reshape(b, h, w, d * d).double()
        acc = (acc.double() + nb * p32[..., i:i + 1].double()).float()
    return acc


def _fused_front(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1, d):
    """(padded source, comb') of one fused stage."""
    comb = _comb_fixed(_fused_logits(proj, d), guid_cf.permute(0, 2, 3, 1), spatial,
                       pos_temp, w0, b0, w1, b1, inp.dtype)
    return _pad_nhwc(inp, d // 2), comb


def jbu_epilogue_fused_plain(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1,
                             diameter: int) -> torch.Tensor:
    """inp [B, H, W, C] unpadded source; proj [B, H, W, K] range projection
    (fp32); guid_cf [B, G, H, W]; the other operands as jbu_epilogue_plain ->
    [B, H, W, C] in inp's dtype."""
    padded, comb = _fused_front(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1,
                                diameter)
    return _adaptive_conv_nhwc(padded, comb, diameter).to(inp.dtype)


def jbu_epilogue_fused_classify_plain(inp, proj, guid_cf, spatial, pos_temp, w0, b0,
                                      w1, b1, fixup_w, fixup_b, query_features,
                                      diameter: int) -> torch.Tensor:
    """jbu_epilogue_fused_plain, then the classify tail -> [B, H, W, Q] fp32."""
    padded, comb = _fused_front(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1,
                                diameter)
    return _cls_tail(_adaptive_conv_nhwc(padded, comb, diameter), fixup_w, fixup_b,
                     query_features, inp.dtype)


def _require(who: str, device: torch.device, want: dict) -> None:
    """Each operand {name: (tensor, shape, dtype)} as the kernel reads it."""
    for name, (t, shape, dtype) in want.items():
        if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{who}: {name} must be contiguous {dtype} {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_operands(inp, logits_t, guid_t, spatial, pos_temp, diameter):
    b, hp, wp, c = inp.shape
    _, h, w, dd = logits_t.shape
    d = diameter
    if inp.dtype != torch.bfloat16 or guid_t.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA JBU epilogue takes bf16 features and guidance; fp32 takes "
            "the channel-first route (plain epilogue + adaptive conv K4b), as "
            "rs_ov/upsample/jbu.py does")
    _require("jbu_epilogue", inp.device, {
        "inp": (inp, (b, h + d - 1, w + d - 1, c), torch.bfloat16),
        "logits_t": (logits_t, (b, h, w, d * d), torch.float32),
        "guid_t": (guid_t, (b, h, w, guid_t.shape[-1]), torch.bfloat16),
        "spatial": (spatial, (d * d,), torch.float32),
        "pos_temp": (pos_temp, (), torch.float32)})
    return b, h, w, c


def _on(t: torch.Tensor, device: torch.device, name: str) -> torch.Tensor:
    # a host pointer handed to the kernel would fault asynchronously, where
    # no error code reaches the wrapper
    if t.device != device:
        raise ValueError(f"jbu_epilogue: {name} is on {t.device}, the kernel's "
                         f"operands on {device}")
    return t


def _epilogue_limits(who: str, c: int, d: int) -> None:
    """What K2 and K3 take: an even channel count and d <= 17 (the TPU
    kernels' limit: the band of 16 + d - 1 columns fits 32)."""
    if c % 2:
        raise ValueError(f"{who} kernel takes an even channel count, got {c}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{who} kernel takes d <= {MAX_D}, got {d}")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of dtype (itself when it is one already)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _mlp_weights(who, ws, shapes, device):
    """The range MLP's weights and biases (and K3's fixup bias) as K2 and K3
    read them: in their dtype when all are fp32 or all bf16, else cast to
    fp32 (exactly), so the usual call casts nothing. Returns (tensors, 1
    for bf16 or 0)."""
    for t, shape in zip(ws, shapes):
        if t.shape != shape:
            raise ValueError(f"{who}: weight of shape {tuple(t.shape)}, want {shape}")
        _on(t, device, f"weight {shape}")
    wdt = (ws[0].dtype if ws[0].dtype in (torch.float32, torch.bfloat16)
           and all(t.dtype == ws[0].dtype for t in ws) else torch.float32)
    return tuple(_as(t, wdt) for t in ws), int(wdt == torch.bfloat16)


def _epilogue_operands(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1, diameter):
    """K2's operands checked and its output allocated. Returns (out, entry,
    args, keep): args are the library entry's arguments up to the stream,
    keep the tensors they point into (the caller's own, unless a dtype had to
    be cast)."""
    d = diameter
    _epilogue_limits("jbu_epilogue", inp.shape[-1], d)
    b, h, w, c = _check_operands(inp, logits_t, guid_t, spatial, pos_temp, d)
    g, cmid = guid_t.shape[-1], w0.shape[0]
    ws, wbf16 = _mlp_weights("jbu_epilogue", (w0, b0, w1, b1),
                             ((cmid, d * d + g), (cmid,), (d * d, cmid), (d * d,)), inp.device)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=inp.device)
    args = (inp.data_ptr(), logits_t.data_ptr(), guid_t.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
            b, h, w, c, g, cmid, d, wbf16)
    return out, "rs_jbu_epilogue", args, ws


def _classify_weights(who, mlp, fixup_w, fixup_b, query_features, c, g, d, dev):
    """K3's and K5b's weights as they read them: (ws, wbf16, fw, qf), ws the
    range MLP's four tensors and the fixup bias in one dtype (``_mlp_weights``),
    fw the fixup conv in bf16 as it is held, [C_out, C_in] (mma's B operand
    in .col form), qf the queries in fp32 or bf16."""
    q, cmid = query_features.shape[0], mlp[0].shape[0]
    if fixup_w.shape != (c, c) or query_features.shape != (q, c):
        raise ValueError(f"{who}: fixup_w {tuple(fixup_w.shape)} / queries "
                         f"{tuple(query_features.shape)} do not match C={c}")
    ws, wbf16 = _mlp_weights(who, (*mlp, fixup_b),
                             ((cmid, d * d + g), (cmid,), (d * d, cmid), (d * d,), (c,)), dev)
    qf = _on(query_features, dev, "query_features")
    qf = _as(qf, qf.dtype if qf.dtype in (torch.float32, torch.bfloat16) else torch.float32)
    return ws, wbf16, _as(_on(fixup_w, dev, "fixup_w"), torch.bfloat16), qf


def _classify_operands(inp, logits_t, guid_t, spatial, pos_temp, w0, b0, w1, b1,
                       fixup_w, fixup_b, query_features, diameter):
    """K3's operands checked and its output allocated; returns (out, entry,
    args, keep) as ``_epilogue_operands``, the weights as
    ``_classify_weights`` gives them."""
    q, d = query_features.shape[0], diameter
    _epilogue_limits("jbu_epilogue_classify", inp.shape[-1], d)
    if not 1 <= q <= CLASSIFY_MAX_Q:
        raise ValueError(f"jbu_epilogue_classify kernel takes 1 to {CLASSIFY_MAX_Q} "
                         f"queries, got {q}")
    b, h, w, c = _check_operands(inp, logits_t, guid_t, spatial, pos_temp, d)
    g, cmid, dev = guid_t.shape[-1], w0.shape[0], inp.device
    ws, wbf16, fw, qf = _classify_weights("jbu_epilogue_classify", (w0, b0, w1, b1), fixup_w,
                                          fixup_b, query_features, c, g, d, dev)
    out = torch.empty((b, h, w, q), dtype=torch.float32, device=dev)
    args = (inp.data_ptr(), logits_t.data_ptr(), guid_t.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws[:4]), fw.data_ptr(),
            ws[4].data_ptr(), qf.data_ptr(), out.data_ptr(), b, h, w, c, g, cmid, d, q,
            wbf16, int(qf.dtype == torch.bfloat16))
    return out, "rs_jbu_epilogue_classify", args, (ws, fw, qf)


def _block_smem_bytes(d: int, g: int, cmid: int, c: int, k: int = 0) -> int:
    """Shared memory of a block of K2 / K3 (k = 0) or K5a / K5b (k the
    projection's channels): the mirror of ``make_layout`` in
    ``csrc/jbu_classify_sm90.cu`` (``rs_jbu_block_smem`` returns the
    library's own count)."""
    up = lambda x: (x + 127) // 128 * 128  # noqa: E731
    dd, m = d * d, _COLS * _ROWS
    ldy, nin = (c + 127) // 128 * 128 + 8, dd + g
    ldw = (max(cmid, dd) + 3) // 4 * 4 + 1
    fixed = up(m * ldy * 2) + up(m * dd * 2) + up(4 * (1 + _QCAP))
    comb = up(m * dd * 4)
    work = [comb + up(nin * m * 4) + up(cmid * m * 4) + up(_KC * ldw * 4),
            2 * up(32 * (_CCH + 8) * 2), up(m * ldy * 2) + 2 * up(_NB * _KBS * 2)]
    if k > 0:
        kc = min(k, _KCH)
        stride = 4 * (((kc + 3) // 4) | 1)
        work.append(comb + up((_ROWS + d - 1) * (_COLS + d - 1) * stride * 4))
    return fixed + max(work)


def _check_fused_operands(who, inp, proj, guid_cf, spatial, pos_temp, w0, diameter):
    """What K5a and K5b take, checked before the library is loaded: bf16
    features and guidance, K2's limits (even C, d <= 17, odd here, the
    reflection's r <= min(H, W) - 1), K >= 1 and a block that fits in
    shared memory."""
    if inp.dim() != 4 or proj.dim() != 4 or guid_cf.dim() != 4:
        raise ValueError(f"{who}: inp, proj and guid_cf must be 4-D, got "
                         f"{tuple(inp.shape)}, {tuple(proj.shape)}, {tuple(guid_cf.shape)}")
    b, h, w, c = inp.shape
    k, g, d = proj.shape[-1], guid_cf.shape[1], diameter
    if inp.dtype != torch.bfloat16 or guid_cf.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA fused JBU stage takes bf16 features and guidance; fp32 takes "
            "the channel-first route (plain epilogue + adaptive conv K4b), as "
            "rs_ov/upsample/jbu.py does")
    _require(who, inp.device, {
        "inp": (inp, (b, h, w, c), torch.bfloat16),
        "proj": (proj, (b, h, w, k), torch.float32),
        "guid_cf": (guid_cf, (b, g, h, w), torch.bfloat16),
        "spatial": (spatial, (d * d,), torch.float32),
        "pos_temp": (pos_temp, (), torch.float32)})
    _epilogue_limits(who, c, d)
    if k < 1:
        raise ValueError(f"{who} kernel takes K >= 1 projection channels, got K={k}")
    if d % 2 == 0 or d // 2 > min(h, w) - 1:
        raise ValueError(f"{who}: reflect padding by r = d // 2 needs an odd d and "
                         f"r <= min(H, W) - 1, got d={d} on {h}x{w}")
    smem = _block_smem_bytes(d, g, w0.shape[0], c, k)
    if smem > SMEM_MAX:
        raise ValueError(f"{who}: a block needs {smem} bytes of shared memory at d={d}, "
                         f"C={c}, K={k}; the card gives {SMEM_MAX}")
    return b, h, w, c, k, g


def _fused_operands(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1, diameter):
    """K5a's operands checked and its output allocated; returns (out, entry,
    args, keep) as ``_epilogue_operands``."""
    d = diameter
    b, h, w, c, k, g = _check_fused_operands("jbu_epilogue_fused", inp, proj, guid_cf,
                                             spatial, pos_temp, w0, d)
    cmid = w0.shape[0]
    ws, wbf16 = _mlp_weights("jbu_epilogue_fused", (w0, b0, w1, b1),
                             ((cmid, d * d + g), (cmid,), (d * d, cmid), (d * d,)), inp.device)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=inp.device)
    args = (inp.data_ptr(), proj.data_ptr(), guid_cf.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws), out.data_ptr(),
            b, h, w, c, g, cmid, d, k, wbf16)
    return out, "rs_jbu_epilogue_fused", args, ws


def _fused_classify_operands(inp, proj, guid_cf, spatial, pos_temp, w0, b0, w1, b1,
                             fixup_w, fixup_b, query_features, diameter):
    """K5b's operands checked and its output allocated; returns (out, entry,
    args, keep) as ``_classify_operands``."""
    who, q, d = "jbu_epilogue_fused_classify", query_features.shape[0], diameter
    if not 1 <= q <= CLASSIFY_MAX_Q:
        raise ValueError(f"{who} kernel takes 1 to {CLASSIFY_MAX_Q} queries, got {q}")
    b, h, w, c, k, g = _check_fused_operands(who, inp, proj, guid_cf, spatial, pos_temp, w0, d)
    cmid, dev = w0.shape[0], inp.device
    ws, wbf16, fw, qf = _classify_weights(who, (w0, b0, w1, b1), fixup_w, fixup_b,
                                          query_features, c, g, d, dev)
    out = torch.empty((b, h, w, q), dtype=torch.float32, device=dev)
    args = (inp.data_ptr(), proj.data_ptr(), guid_cf.data_ptr(), spatial.data_ptr(),
            pos_temp.data_ptr(), *(t.data_ptr() for t in ws[:4]), fw.data_ptr(),
            ws[4].data_ptr(), qf.data_ptr(), out.data_ptr(), b, h, w, c, g, cmid, d, k, q,
            wbf16, int(qf.dtype == torch.bfloat16))
    return out, "rs_jbu_epilogue_fused_classify", args, (ws, fw, qf)


_STAGE = "Tensor spatial, Tensor pos_temp, Tensor w0, Tensor b0, Tensor w1, Tensor b1"
_TAIL = "Tensor fixup_w, Tensor fixup_b, Tensor query_features"


def _features_fake(inp, front, *rest):
    """[B, H, W, C] in inp's dtype, the grid from the logits or projection."""
    return inp.new_empty((*front.shape[:3], inp.shape[-1]))


def _logits_fake(inp, front, *rest):
    """[B, H, W, Q] fp32, Q the queries' rows (``rest[-2]``)."""
    return inp.new_empty((*front.shape[:3], rest[-2].shape[0]), dtype=torch.float32)


jbu_epilogue = Kernel(
    "jbu_epilogue", f"(Tensor inp, Tensor logits_t, Tensor guid_t, {_STAGE}, int diameter) -> "
    "Tensor", jbu_epilogue_plain, _epilogue_operands, _features_fake,
    doc="""See jbu_epilogue_plain. CPU tensors take the plain version, CUDA
    tensors the kernel (d <= 17, even C; it shares K3's blocks, so the
    library refuses C past 1408, or past 896 at d = 17, as K3's does).""")
jbu_epilogue_classify = Kernel(
    "jbu_epilogue_classify", f"(Tensor inp, Tensor logits_t, Tensor guid_t, {_STAGE}, "
    f"{_TAIL}, int diameter) -> Tensor", jbu_epilogue_classify_plain, _classify_operands,
    _logits_fake,
    doc="""See jbu_epilogue_classify_plain. CPU tensors take the plain version,
    CUDA tensors the kernel (Q <= 128 queries, d <= 17).""")
jbu_epilogue_fused = Kernel(
    "jbu_epilogue_fused", f"(Tensor inp, Tensor proj, Tensor guid_cf, {_STAGE}, int diameter) -> "
    "Tensor", jbu_epilogue_fused_plain, _fused_operands, _features_fake,
    doc="""See jbu_epilogue_fused_plain. CPU tensors take the plain version, CUDA
    tensors the kernel (odd d <= 17, even C, any K; K2's blocks, so C past
    1408, or past 896 at d = 17, is refused as for K2).""")
jbu_epilogue_fused_classify = Kernel(
    "jbu_epilogue_fused_classify", f"(Tensor inp, Tensor proj, Tensor guid_cf, {_STAGE}, "
    f"{_TAIL}, int diameter) -> Tensor", jbu_epilogue_fused_classify_plain,
    _fused_classify_operands, _logits_fake,
    doc="""See jbu_epilogue_fused_classify_plain. CPU tensors take the plain
    version, CUDA tensors the kernel (Q <= 128 queries, odd d <= 17).""")
