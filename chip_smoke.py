#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises, prints its traceback and exits non-zero):

  1. device   - a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    - compiles rs_ov_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
                per source, all at once.
  3. kernels  - each CUDA kernel (K1-K3, K4a, K4b) against its plain PyTorch
                version on the card, at the shapes every driven path gives
                it (jbu_one's d=11, jbu_stack's d=7 on 28^2 to 224^2);
                prints the error beside that of the plain version with its
                last tap dropped (which must exceed the bound), the median
                times (CUDA events, in turns) and the bound from the shapes.
  4. slice    - SegmentorEx from configs/base_config.py (CLIP ViT-B/16,
                random weights) on the Potsdam vocabulary: predict_raw on
                three 512x512 images on each route: bf16 channel-last (K1,
                K2, K3), fp32 channel-first (K1, K4b), bf16 channel-first
                with RS_OV_JBU_FUSED=0 (K1, K4a), and jbu_stack at 4 stages
                (K1, K2, K3 at d=7, two images). Checks outputs and that
                every launch counter moved by exactly the expected amount;
                prints tiles/s per route over the requests after the first.
  5. e2e      - one 336x336 image through every route on the card and
                through the fp32 CPU route, with the same weights and
                queries: argmax agreement >= 0.95 between routes and with
                the CPU, >= 0.999 between fp32 on the card and on the CPU;
                jbu_stack at 4 stages on the card against the same
                configuration in fp32 on the CPU, >= 0.95.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CARD = {}
# Each bound is on max|kernel - plain| / max|plain|. K3's logits here reach
# only ~0.18, so its bound is relative and tight: a few bf16 rounding flips
# fit, while leaving out the 512x512 fixup product (1.1e-1), its bias
# (1.1e-2) or the bf16 rounding of the normalised vector (1.9e-3) does not.
# K4b (fp32) and K4a (bf16) are held to 1e-5 and 1e-2 of max|ref|: K4a's
# bound is one or two bf16 flips of an output (a step is 2^-8 of the value).
# For every kernel and shape, the plain version without its last tap, on the
# same inputs, is printed beside the bound, and must land above it.
K1_TOL, K2_TOL, K3_TOL, K4B_TOL, K4A_TOL = 1e-5, 1e-2, 1e-3, 1e-5, 1e-2
B, D, K, C, G, Q = 2, 11, 32, 512, 3, 8
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
CHUNKS = 8  # 16 crops of a 512x512 image in chunks of 2
DEV = torch.device("cuda")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    CARD["smi"] = smi
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    # fp32 products on the card run in full fp32 (no TF32) in every phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from rs_ov_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(lib._name)}")


def _median_ms(fn, reps: int = 20) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed_pair(kernel, plain):
    """Median ms of kernel and plain version, warmed up, measured in turns."""
    for _ in range(3):
        kernel()
        plain()
    torch.cuda.synchronize()
    k, p = [], []
    for i in range(4):
        order = (kernel, plain) if i % 2 else (plain, kernel)
        for fn in order:
            (k if fn is kernel else p).append(_median_ms(fn, reps=10))
    return float(np.median(k)), float(np.median(p))


def _bound(nbytes: float, fp32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate of their operand type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = fp32_ops / FP32_FLOPS + bf16_ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _epilogue_bound(h, w, with_classify, d=D):
    """K2 / K3 at B, C, G (fixup MLP width d*d): bytes of every input read
    once and the output written once; the conv and the classify products
    have bf16 operands, the tap softmax and the fixup MLP fp32."""
    dd, px = d * d, B * h * w
    nbytes = (B * (h + d - 1) * (w + d - 1) * C * 2 + px * dd * 4 + px * G * 2
              + (dd * (dd + G) + dd * dd + 2 * dd + 1) * 4)
    fp32_ops = px * (6 * dd + 2 * dd * (dd + G) + 2 * dd * dd)
    bf16_ops = 2 * px * dd * C
    if with_classify:
        nbytes += C * C * 2 + C * 4 + Q * C * 2 + px * Q * 4
        bf16_ops += 2 * px * C * C + 2 * px * C * Q
    else:
        nbytes += px * C * 2
    return _bound(nbytes, fp32_ops, bf16_ops)


def _epilogue_inputs(rng, h, w, dev, d=D):
    bf = torch.bfloat16

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    dd = d * d
    return dict(
        inp=t(rng.randn(B, h + d - 1, w + d - 1, C), bf),
        logits_t=t(rng.randn(B, h, w, dd) * 3.0),
        guid_t=t(rng.randn(B, h, w, G), bf),
        spatial=t(np.exp(-np.add.outer(np.linspace(-1, 1, d) ** 2,
                                       np.linspace(-1, 1, d) ** 2).reshape(-1) / 2.0)),
        pos_temp=t(np.float32(1.3)),
        w0=t(rng.randn(dd, dd + G) / np.sqrt(dd + G), bf),
        b0=t(rng.randn(dd) * 0.1, bf),
        w1=t(rng.randn(dd, dd) / np.sqrt(dd), bf),
        b1=t(rng.randn(dd) * 0.1, bf))


def _check(label, tol, kernel, plain, faulty, bound):
    """kernel() against plain() as max|d|/max|ref|, beside faulty(): the plain
    version with its last tap dropped, on the same inputs, which must land
    above the bound. Returns the row's measured numbers."""
    got, ref, bad = kernel().float(), plain().float(), faulty().float()
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel, fault_rel = err / scale, (bad - ref).abs().max().item() / scale
    ms, plain_ms = _timed_pair(kernel, plain)
    print(f"[kernels] {label}: max|d|={err:.3e} max|d|/max|ref|={rel:.3e} (tol {tol}; "
          f"without the last tap {fault_rel:.3e}; max|ref| {scale:.4g}) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms by {bound[1]}")
    assert rel <= tol, f"{label} disagrees: {rel}"
    assert fault_rel > tol, f"{label}: the bound does not catch a dropped tap: {fault_rel}"
    return dict(max_abs_err=err, fault_rel=fault_rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def _row(name, source, replaces, checks):
    """The JSON row of a kernel from its (shape, numbers) checks: the first
    is at the main path's shape, the others are kept under ``also``."""
    main, *also = checks
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                **main[1], library_ms=None, shape=main[0],
                also=[dict(shape=s, **c) for s, c in also])


@contextlib.contextmanager
def _epilogue_conv_without_last_tap():
    """The plain epilogues' adaptive conv with its last tap dropped."""
    from rs_ov_torch.kernels import jbu_epilogue as mod

    conv = mod._adaptive_conv_nhwc

    def faulty(inp, comb, d):
        comb = comb.clone()
        comb[..., -1] = 0
        return conv(inp, comb, d)

    mod._adaptive_conv_nhwc = faulty
    try:
        yield
    finally:
        mod._adaptive_conv_nhwc = conv


def _last_tap_dropped(t):
    t = t.clone()
    t[:, -1] = 0
    return t


def phase_kernels():
    """K1-K3 at jbu_one's shapes (d=11) and at jbu_stack's (d=7, grids 28^2 to
    224^2, 4 stages), K4a/K4b at the channel-first route's."""
    from rs_ov_torch.kernels.jbu_epilogue import (jbu_epilogue, jbu_epilogue_classify,
                                                  jbu_epilogue_classify_plain,
                                                  jbu_epilogue_plain)
    from rs_ov_torch.kernels.range_logits import range_logits, range_logits_plain
    from rs_ov_torch.utils.resize import reflect_pad_2d

    dev = DEV
    rng = np.random.RandomState(0)

    k1 = []
    for d, hw in ((11, 56), (11, 28), (7, 28), (7, 224)):
        proj = torch.from_numpy(rng.randn(B, K, hw, hw).astype(np.float32)).to(dev)
        padded = reflect_pad_2d(proj, d // 2).contiguous()
        bound = _bound(4 * B * K * ((hw + d - 1) ** 2 + hw * hw) + 4 * B * d * d * hw * hw,
                       fp32_ops=2 * B * K * d * d * hw * hw)
        k1.append((f"B={B} K={K} d={d} H=W={hw}", _check(
            f"K1 range_logits d={d} H=W={hw}", K1_TOL,
            lambda: range_logits(padded, proj, d),
            lambda: range_logits_plain(padded, proj, d),
            lambda: _last_tap_dropped(range_logits_plain(padded, proj, d)), bound)))

    k2 = []
    for d, hw in ((11, 28), (7, 28), (7, 112)):
        a = _epilogue_inputs(rng, hw, hw, dev, d)

        def faulty():
            with _epilogue_conv_without_last_tap():
                return jbu_epilogue_plain(**a, diameter=d)

        k2.append((f"B={B} d={d} C={C} G={G} H=W={hw}", _check(
            f"K2 jbu_epilogue d={d} H=W={hw}", K2_TOL,
            lambda: jbu_epilogue(**a, diameter=d),
            lambda: jbu_epilogue_plain(**a, diameter=d), faulty,
            _epilogue_bound(hw, hw, False, d))))

    fw = torch.from_numpy((rng.randn(C, C) / np.sqrt(C)).astype(np.float32)).to(dev, torch.bfloat16)
    fb = torch.from_numpy((rng.randn(C) * 0.1).astype(np.float32)).to(dev, torch.bfloat16)
    qf = torch.from_numpy(rng.randn(Q, C).astype(np.float32)).to(dev)
    qf = qf / qf.norm(dim=-1, keepdim=True)
    tail = dict(fixup_w=fw, fixup_b=fb, query_features=qf)
    k3 = []
    for d, hw in ((11, 56), (7, 224)):
        a = {**_epilogue_inputs(rng, hw, hw, dev, d), **tail}

        def faulty():
            with _epilogue_conv_without_last_tap():
                return jbu_epilogue_classify_plain(**a, diameter=d)

        k3.append((f"B={B} d={d} C={C} G={G} Q={Q} H=W={hw}", _check(
            f"K3 jbu_epilogue_classify d={d} H=W={hw}", K3_TOL,
            lambda: jbu_epilogue_classify(**a, diameter=d),
            lambda: jbu_epilogue_classify_plain(**a, diameter=d), faulty,
            _epilogue_bound(hw, hw, True, d))))

    rows = {
        "range_logits": _row("range_logits", "rs_ov_torch/csrc/range_logits.cu",
                             "rs_ov/kernels/range_logits.py:64", k1),
        "jbu_epilogue": _row("jbu_epilogue", "rs_ov_torch/csrc/jbu_epilogue.cu",
                             "rs_ov/kernels/jbu_epilogue.py:212", k2),
        "jbu_epilogue_classify": _row("jbu_epilogue_classify",
                                      "rs_ov_torch/csrc/jbu_epilogue.cu",
                                      "rs_ov/kernels/jbu_epilogue.py:333", k3)}
    rows.update(_adaptive_conv_kernels(rng, dev))
    return rows


def _adaptive_conv_kernels(rng, dev):
    """K4b (fp32) and K4a (bf16) against the plain loop, on normal-distributed
    taps, at the channel-first route's shapes: jbu_one's two stages (d=11 at
    56^2 and 28^2) and jbu_stack's d=7 at 56^2. The rows lead with d=11, 56^2."""
    from rs_ov_torch.kernels.adaptive_conv import (adaptive_conv_tapmajor,
                                                   adaptive_conv_tapmajor_plain)

    rows = {}
    for dtype, key, tol, name, tpu_line in (
            (torch.float32, "K4b", K4B_TOL, "adaptive_conv_f32",
             "rs_ov/kernels/adaptive_conv_v2.py:99"),
            (torch.bfloat16, "K4a", K4A_TOL, "adaptive_conv_bf16",
             "rs_ov/kernels/adaptive_conv_v5.py:68")):
        esz = torch.finfo(dtype).bits // 8
        checks = []
        for d, hw in ((11, 56), (11, 28), (7, 56)):
            inp = torch.from_numpy(rng.randn(B, C, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dtype), filt.to(dev, dtype)
            ops = 2 * B * C * hw * hw * d * d
            nbytes = esz * (inp.numel() + filt.numel() + B * C * hw * hw)
            bound = (_bound(nbytes, fp32_ops=ops) if dtype == torch.float32
                     else _bound(nbytes, bf16_ops=ops))
            checks.append((f"B={B} C={C} d={d} H=W={hw}", _check(
                f"{key} {name} d={d} H=W={hw}", tol,
                lambda: adaptive_conv_tapmajor(inp, filt, d),
                lambda: adaptive_conv_tapmajor_plain(inp, filt, d),
                lambda: adaptive_conv_tapmajor_plain(inp, _last_tap_dropped(filt), d),
                bound)))
        rows[name] = _row(name, "rs_ov_torch/csrc/adaptive_conv.cu", tpu_line, checks)
    return rows


def _base_model_cfg():
    from rs_ov_torch.evalsuite.config import load_config

    cfg = dict(load_config("configs/base_config.py")["model"])
    assert cfg.pop("type") == "SegmentorEx"
    cfg["name_path"] = "configs/cls_potsdam.txt"
    return cfg


KERNELS = ("range_logits", "jbu_epilogue", "jbu_epilogue_classify", "adaptive_conv_bf16",
           "adaptive_conv_f32")


def _launches():
    from rs_ov_torch.kernels.adaptive_conv import adaptive_conv_tapmajor
    from rs_ov_torch.kernels.jbu_epilogue import jbu_epilogue, jbu_epilogue_classify
    from rs_ov_torch.kernels.range_logits import range_logits

    return dict(zip(KERNELS, (range_logits.launches, jbu_epilogue.launches,
                              jbu_epilogue_classify.launches,
                              adaptive_conv_tapmajor.launches[torch.bfloat16],
                              adaptive_conv_tapmajor.launches[torch.float32])))


def _reset_launches():
    from rs_ov_torch.kernels.adaptive_conv import adaptive_conv_tapmajor
    from rs_ov_torch.kernels.jbu_epilogue import jbu_epilogue, jbu_epilogue_classify
    from rs_ov_torch.kernels.range_logits import range_logits

    range_logits.launches = jbu_epilogue.launches = jbu_epilogue_classify.launches = 0
    for dt in adaptive_conv_tapmajor.launches:
        adaptive_conv_tapmajor.launches[dt] = 0


@contextlib.contextmanager
def _env(name, value):
    """Set an environment variable for the block, restore it afterwards."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _drive(route, seg, images, want):
    """predict_raw on each image with every launch counter at 0 before and
    read after; checks the outputs and the counts; prints the tiles/s of the
    requests after the first; returns the counts."""
    _reset_launches()
    secs = []
    for img in images:
        t0 = time.perf_counter()
        res = seg.predict_raw(img)[0]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        probs, pred = res["seg_logits"], res["pred_sem_seg"]
        assert tuple(pred.shape) == (1, 512, 512), pred.shape
        assert tuple(probs.shape) == (seg.num_classes, 512, 512), probs.shape
        assert bool(torch.isfinite(probs).all()), f"{route}: non-finite probabilities"
        assert 0 <= int(pred.min()) and int(pred.max()) < seg.num_classes, "label range"
    launches = _launches()
    want = {k: want.get(k, 0) for k in KERNELS}
    print(f"[slice] {route}: launches over {len(images)} image(s) {launches} "
          f"(expected {want})")
    assert launches == want, (route, launches, want)
    steady = float(np.median(secs[1:] if len(secs) > 1 else secs))
    print(f"[slice] {route}: request seconds {[round(x, 4) for x in secs]}; "
          f"{16 / steady:.2f} tiles/s (16 crops of 224 per 512x512 image) on {CARD['smi']}")
    return launches


def phase_slice(rows):
    """Each route through SegmentorEx.predict_raw, counters read per route."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    t0 = time.perf_counter()
    seg = SegmentorEx(**_base_model_cfg(), device=DEV)
    torch.cuda.synchronize()
    print(f"[slice] SegmentorEx built in {time.perf_counter() - t0:.2f} s: "
          f"{seg.cfg.vision.width} wide, {seg.cfg.vision.layers} layers, "
          f"Q={seg.num_queries}, {seg.num_classes} classes, stages={seg.jbu_stages}, "
          f"tile_chunk={seg.tile_chunk}, dtype={seg.param_dtype}")
    assert 16 // seg.tile_chunk == CHUNKS
    qf = seg.query_features.cpu().numpy()
    seg32 = SegmentorEx(**_base_model_cfg(), param_dtype=torch.float32, device=DEV,
                        query_features=qf)
    stack = SegmentorEx(**{**_base_model_cfg(), "sim_feat_up_cfg": dict(
        model_name="jbu_stack", num_stages=4)}, device=DEV, query_features=qf)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (1, 512, 512, 3), np.uint8) for _ in range(3)]
    s = seg.jbu_stages
    by_path = {
        "bf16 channel-last": _drive("bf16 channel-last (K1 K2 K3)", seg, images, {
            "range_logits": 3 * s * CHUNKS, "jbu_epilogue": 3 * (s - 1) * CHUNKS,
            "jbu_epilogue_classify": 3 * CHUNKS}),
        "fp32 channel-first": _drive("fp32 channel-first (K1 K4b)", seg32, images, {
            "range_logits": 3 * s * CHUNKS, "adaptive_conv_f32": 3 * s * CHUNKS})}
    with _env("RS_OV_JBU_FUSED", "0"):
        by_path["bf16 channel-first"] = _drive(
            "bf16 channel-first, RS_OV_JBU_FUSED=0 (K1 K4a)", seg, images,
            {"range_logits": 3 * s * CHUNKS, "adaptive_conv_bf16": 3 * s * CHUNKS})
    by_path["jbu_stack 4 stages"] = _drive(
        "jbu_stack 4 stages bf16 channel-last (K1 K2 K3 at d=7)", stack, images[:2], {
            "range_logits": 2 * 4 * CHUNKS, "jbu_epilogue": 2 * 3 * CHUNKS,
            "jbu_epilogue_classify": 2 * CHUNKS})
    own = {"range_logits": "bf16 channel-last", "jbu_epilogue": "bf16 channel-last",
           "jbu_epilogue_classify": "bf16 channel-last",
           "adaptive_conv_f32": "fp32 channel-first", "adaptive_conv_bf16": "bf16 channel-first"}
    for k in KERNELS:
        rows[k]["launches"] = by_path[own[k]][k]
        rows[k]["launches_by_path"] = {p: c[k] for p, c in by_path.items()}
    return seg, seg32, stack


def phase_e2e(seg, seg32, stack):
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    qf = seg.query_features.cpu().numpy()
    seg_cpu = SegmentorEx(**_base_model_cfg(), device="cpu", query_features=qf)
    stack_cpu = SegmentorEx(**{**_base_model_cfg(), "sim_feat_up_cfg": dict(
        model_name="jbu_stack", num_stages=4)}, device="cpu", query_features=qf)
    img = np.random.RandomState(2).randint(0, 256, (1, 336, 336, 3), np.uint8)
    out = {"bf16 channel-last": seg.predict_raw(img)[0],
           "fp32 channel-first": seg32.predict_raw(img)[0],
           "jbu_stack 4 stages bf16 channel-last": stack.predict_raw(img)[0]}
    with _env("RS_OV_JBU_FUSED", "0"):
        out["bf16 channel-first"] = seg.predict_raw(img)[0]
    t0 = time.perf_counter()
    out["fp32 CPU"] = seg_cpu.predict_raw(img)[0]
    out["jbu_stack 4 stages fp32 CPU"] = stack_cpu.predict_raw(img)[0]
    cpu_s = time.perf_counter() - t0
    for a, b, need in (("bf16 channel-first", "bf16 channel-last", 0.95),
                       ("fp32 channel-first", "bf16 channel-last", 0.95),
                       ("fp32 channel-first", "fp32 CPU", 0.999),
                       ("bf16 channel-last", "fp32 CPU", 0.95),
                       ("jbu_stack 4 stages bf16 channel-last",
                        "jbu_stack 4 stages fp32 CPU", 0.95)):
        pa, pb = out[a]["pred_sem_seg"].cpu(), out[b]["pred_sem_seg"].cpu()
        agree = (pa == pb).float().mean().item()
        dprob = (out[a]["seg_logits"].cpu() - out[b]["seg_logits"].cpu()).abs().max().item()
        print(f"[e2e] 336x336 (4 crops): {a} vs {b}: argmax agreement {agree:.6f} "
              f"(need >= {need}), max |d prob| {dprob:.4f}")
        assert agree >= need, f"{a} vs {b}: agreement {agree}"
    print(f"[e2e] CPU runs {cpu_s:.1f} s")


def main():
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_e2e(*phase_slice(rows))
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
