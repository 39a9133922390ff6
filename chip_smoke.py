#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises, prints its traceback and exits non-zero):

  1. device   - a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    - compiles rs_ov_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
                per source, all at once.
  3. kernels  - each CUDA kernel (K1-K3, K4a-K4f, K5a, K5b, K6) against its
                plain PyTorch version on the card, at the shapes every driven
                path gives it (jbu_one's d=11, jbu_stack's d=7 on 28^2 to
                224^2; K6 in each of its six modes, with and without a sim
                map, in bf16 and fp32, at 16 crops x 12 heads x 197 tokens x
                64); prints the error beside that of the plain version with
                its last tap (K6: its last key) dropped, and for K5a/K5b also
                with zero padding in place of reflection, each of which must
                exceed the bound, the median times (CUDA events, in turns),
                the bound from the shapes and, for K6's vanilla and ClearCLIP
                modes, the time of one scaled_dot_product_attention call.
                K5a and K5b are also held against the split pair they replace
                (K1 + reflect pads + K2 / K3) on the card, and timed beside it.
                K4e and K4f (both operands rounded to bf16) at d=11 on 28^2
                and 56^2 and d=7 on 224^2 (K4f: two column chunks), with fp32,
                bf16 and bf16-input/fp32-tap operands, also beside K4b's
                unrounded function (fp32) and timed beside K4b/K4a and K4c.
  4. slice    - SegmentorEx from configs/base_config.py (CLIP ViT-B/16,
                random weights) on the Potsdam vocabulary: predict_raw on
                three 512x512 images on each route: bf16 channel-last (K1,
                K2, K3), fp32 channel-first (K1, K4b), bf16 channel-first
                with RS_OV_JBU_FUSED=0 (K1, K4a), and jbu_stack at 4 stages
                (K1, K2, K3 at d=7, two images); then with
                RS_OV_FUSED_ATTN=1 (K6 once per request, K1 K2 K3 as on the
                bf16 channel-last route): (a) the base config, (b) the full
                stack (SegEarth, CTD, self-attention enhancement, SOM and
                cross-tile fusion on top of it), (c) ClearCLIP with layer
                fusion and outlier suppression; then with
                RS_OV_JBU_FUSED_RANGE=1: (d) the base config (K5a, K5b) and
                jbu_stack at 4 stages (K5a, K5b at d=7, two images);
                predict_batch_raw on the three images as one batch, with the
                fused-range switch off (K1 K2 K3) and on (K5a K5b); and the
                adaptive-conv entry points K4c and K4d on the stage operands
                of one fp32 channel-first request, against K4b's outputs, and
                K4e and K4f on the same operands against their plain version.
                Checks outputs and that every launch counter moved by
                exactly the expected amount; prints tiles/s per route over
                the requests after the first (batches: the second call).
  5. e2e      - one 336x336 image through every route on the card and
                through the fp32 CPU route, with the same weights and
                queries: argmax agreement >= 0.95 between routes and with
                the CPU, >= 0.999 between fp32 on the card and on the CPU;
                jbu_stack at 4 stages on the card against the same
                configuration in fp32 on the CPU, >= 0.95; (a) and (b) with
                RS_OV_FUSED_ATTN=1 against 0 on the card, >= 0.99; (b) in fp32
                on the card against the CPU, >= 0.99; (a), (b) and (c) in bf16
                against the CPU, >= 0.95 (with the share of CTD's DBSCAN
                labels that agree between the runs of (b)); (d) against the
                split channel-last route, >= 0.99, and against the CPU, >=
                0.95; jbu_stack with fused range against the CPU, >= 0.95;
                predict_batch_raw of two copies of the image and another
                against predict_raw of each, >= 0.999 per image, and the same
                with path (b)'s cross-tile fusion, >= 0.99 in fp32 and >= 0.95
                in bf16.
  6. eval     - twelve 512x512 images with Potsdam labels written as PNG
                under a temporary RS_OV_DATA_ROOT in configs/cfg_potsdam.py's
                layout; the port's run_eval from cfg_potsdam (ViT-B/16 at full
                width, random weights, bf16 on the card) with batch_images 1
                and 3: the on-device confusion state must equal the host
                confusion_update summed over the same segmentor's per-image
                predict_raw exactly, batch 3 must lie within 1e-3 of the
                pixels of batch 1 per entry, two shards merged must equal the
                single run, result_dir must get one PNG per image; prints the
                sustained img/s and tiles/s; then rs_ov_torch.eval_all with
                RS_OV_DATA_ROOT=data_synth, where the seven configs with
                committed data must give metrics.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
# K5a and K5b take K2's and K3's bounds, K4c and K4d K4b's in fp32 and K4a's
# with a bf16 input.
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


def _epilogue_bound(h, w, with_classify, d=D, fused=False):
    """K2 / K3 (or K5a / K5b with ``fused``) at B, C, G, K (fixup MLP width
    d*d): bytes of every input read once and the output written once; the
    conv and the classify products have bf16 operands, the range logits, the
    tap softmax and the fixup MLP fp32. K2/K3 read the padded source and the
    logits, K5 the unpadded source and the projection."""
    dd, px = d * d, B * h * w
    nbytes = ((px * C * 2 + px * K * 4) if fused
              else (B * (h + d - 1) * (w + d - 1) * C * 2 + px * dd * 4))
    nbytes += px * G * 2 + (dd * (dd + G) + dd * dd + 2 * dd + 1) * 4
    fp32_ops = px * (6 * dd + 2 * dd * (dd + G) + 2 * dd * dd + (2 * dd * K if fused else 0))
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


def _check(label, tol, kernel, plain, faulty, bound, dropped="tap", faults=()):
    """kernel() against plain() as max|d|/max|ref|, beside faulty(): the plain
    version with its last tap (or key) dropped, on the same inputs, and each
    (name, fault) of ``faults``, all of which must land above the bound.
    Returns the row's measured numbers."""
    got, ref, bad = kernel().float(), plain().float(), faulty().float()
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel, fault_rel = err / scale, (bad - ref).abs().max().item() / scale
    more = {name: (fn().float() - ref).abs().max().item() / scale for name, fn in faults}
    ms, plain_ms = _timed_pair(kernel, plain)
    shown = "".join(f"; with {name} {v:.3e}" for name, v in more.items())
    print(f"[kernels] {label}: max|d|={err:.3e} max|d|/max|ref|={rel:.3e} (tol {tol}; "
          f"without the last {dropped} {fault_rel:.3e}{shown}; max|ref| {scale:.4g}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound[0]:.4f} ms by {bound[1]}")
    assert rel <= tol, f"{label} disagrees: {rel}"
    assert fault_rel > tol, f"{label}: the bound does not catch a dropped {dropped}: {fault_rel}"
    for name, v in more.items():
        assert v > tol, f"{label}: the bound does not catch {name}: {v}"
    return dict(max_abs_err=err, fault_rel=fault_rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                **{f"fault_rel_{name.replace(' ', '_')}": v for name, v in more.items()})


def _row(name, source, replaces, checks):
    """The JSON row of a kernel from its (shape, numbers) checks: the first
    is at the main path's shape, the others are kept under ``also``."""
    main, *also = checks
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                **{"library_ms": None, **main[1]}, shape=main[0],
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
    rows.update(_fused_range_kernels(rng, dev, tail))
    rows.update(_adaptive_layout_kernels(rng, dev))
    rows.update(_bf16_conv_kernels(rng, dev))
    rows["fused_selfself_attention"] = _selfself_attention_kernel(rng, dev)
    return rows


@contextlib.contextmanager
def _zero_padding():
    """The fused plain versions with zero padding in place of reflection."""
    from rs_ov_torch.kernels import jbu_epilogue as mod

    pad = mod._pad_nhwc
    mod._pad_nhwc = lambda x, r: torch.nn.functional.pad(x, (0, 0, r, r, r, r))
    try:
        yield
    finally:
        mod._pad_nhwc = pad


def _fused_inputs(rng, hw, dev, d):
    """One fused-range stage's operands: the unpadded bf16 source, the fp32
    projection [B, H, W, K] (scaled so that the tap softmax spreads over the
    window) and the channel-first bf16 guidance; the rest as K2's."""
    a = _epilogue_inputs(rng, hw, hw, dev, d)
    del a["logits_t"], a["guid_t"]
    a["inp"] = torch.from_numpy(rng.randn(B, hw, hw, C).astype(np.float32)).to(dev, torch.bfloat16)
    a["proj"] = torch.from_numpy((rng.randn(B, hw, hw, K) * 0.3).astype(np.float32)).to(dev)
    a["guid_cf"] = torch.from_numpy(rng.randn(B, G, hw, hw).astype(np.float32)).to(
        dev, torch.bfloat16)
    return {k: a[k] for k in ("inp", "proj", "guid_cf", "spatial", "pos_temp",
                              "w0", "b0", "w1", "b1")}


def _split_stage(a, d, tail=None):
    """The split route's stage on the fused operands, on the card: K1 on the
    reflect-padded channel-first projection, the reflect-padded source, then
    K2 (or K3 with the classify tail)."""
    from rs_ov_torch.kernels.jbu_epilogue import jbu_epilogue, jbu_epilogue_classify
    from rs_ov_torch.kernels.range_logits import range_logits
    from rs_ov_torch.utils.resize import reflect_pad_2d, reflect_pad_nhwc

    r = d // 2
    pcf = a["proj"].permute(0, 3, 1, 2).contiguous()
    logits = range_logits(reflect_pad_2d(pcf, r).contiguous(), pcf, d)
    args = (reflect_pad_nhwc(a["inp"], r).contiguous(), logits.permute(0, 2, 3, 1).contiguous(),
            a["guid_cf"].permute(0, 2, 3, 1).contiguous(), a["spatial"], a["pos_temp"],
            a["w0"], a["b0"], a["w1"], a["b1"])
    if tail is None:
        return jbu_epilogue(*args, d)
    return jbu_epilogue_classify(*args, **tail, diameter=d)


def _fused_range_kernels(rng, dev, tail):
    """K5a at K2's shapes (d=11 28^2, d=7 28^2 and 112^2) and K5b at K3's
    (d=11 56^2, d=7 224^2), B=2, C=512, K=32, G=3, Q=8, within K2's and K3's
    bounds of their plain versions, beside two faults (the last tap dropped;
    zero padding in place of reflection); then against the split pair each
    replaces (K1 + reflect pads + K2 / K3) on the card, within the same
    bound, with the pair's time beside the kernel's."""
    from rs_ov_torch.kernels.jbu_epilogue import (jbu_epilogue_fused,
                                                  jbu_epilogue_fused_classify,
                                                  jbu_epilogue_fused_classify_plain,
                                                  jbu_epilogue_fused_plain)

    rows = {}
    for key, tol, name, tpu_line, shapes, extra in (
            ("K5a", K2_TOL, "jbu_epilogue_fused", "rs_ov/kernels/jbu_epilogue.py:640",
             ((11, 28), (7, 28), (7, 112)), None),
            ("K5b", K3_TOL, "jbu_epilogue_fused_classify", "rs_ov/kernels/jbu_epilogue.py:675",
             ((11, 56), (7, 224)), tail)):
        checks = []
        for d, hw in shapes:
            a = _fused_inputs(rng, hw, dev, d)
            t = {} if extra is None else extra
            if extra is None:
                kernel = lambda: jbu_epilogue_fused(**a, diameter=d)  # noqa: E731
                plain = lambda: jbu_epilogue_fused_plain(**a, diameter=d)  # noqa: E731
            else:
                kernel = lambda: jbu_epilogue_fused_classify(**a, **t, diameter=d)  # noqa: E731
                plain = lambda: jbu_epilogue_fused_classify_plain(**a, **t, diameter=d)  # noqa: E731

            def dropped():
                with _epilogue_conv_without_last_tap():
                    return plain()

            def zero_padded():
                with _zero_padding():
                    return plain()

            c = _check(f"{key} {name} d={d} H=W={hw}", tol, kernel, plain, dropped,
                       _epilogue_bound(hw, hw, extra is not None, d, fused=True),
                       faults=[("zero padding", zero_padded)])
            split = lambda: _split_stage(a, d, extra)  # noqa: E731
            got, ref = kernel().float(), split().float()
            c["split_rel"] = (got - ref).abs().max().item() / ref.abs().max().item()
            c["split_ms"] = _median_ms(split)
            print(f"[kernels] {key} d={d} H=W={hw} against the split pair K1 + pads + "
                  f"{'K3' if extra is not None else 'K2'}: max|d|/max|ref|={c['split_rel']:.3e} "
                  f"(tol {tol}); split pair {c['split_ms']:.4f} ms, kernel {c['ms']:.4f} ms")
            assert c["split_rel"] <= tol, f"{key} disagrees with the split pair"
            checks.append((f"B={B} d={d} C={C} K={K} G={G}"
                           + (f" Q={Q}" if extra is not None else "") + f" H=W={hw}", c))
        rows[name] = _row(name, "rs_ov_torch/csrc/jbu_epilogue.cu", tpu_line, checks)
    return rows


def _adaptive_layout_kernels(rng, dev):
    """K4c (planes) and K4d (channels-last) at K4b's shapes (B=2, C=512, d=11
    at 56^2 and 28^2, d=7 at 56^2) in fp32, a bf16 input with fp32 taps at
    d=11 56^2, and for K4d C=96 at d=7 56^2; fp32 within 1e-5, bf16 input
    within 1e-2 of max|ref|, each beside the plain version with its last tap
    dropped. fp32 products either way, so operations count at the fp32
    rate."""
    from rs_ov_torch.kernels.adaptive_conv import (adaptive_conv_cl, adaptive_conv_planes,
                                                   adaptive_conv_tapmajor_plain)

    f32, bf = torch.float32, torch.bfloat16
    rows = {}
    for key, name, fn, tpu_line, cases in (
            ("K4c", "adaptive_conv_planes", adaptive_conv_planes,
             "rs_ov/kernels/adaptive_conv.py:189", []),
            ("K4d", "adaptive_conv_cl", adaptive_conv_cl,
             "rs_ov/kernels/adaptive_conv.py:70", [(7, 56, 96, f32)])):
        checks = []
        for d, hw, c, dt_in in [(11, 56, C, f32), (11, 28, C, f32), (7, 56, C, f32),
                                (11, 56, C, bf)] + cases:
            inp = torch.from_numpy(rng.randn(B, c, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dt_in), filt.to(dev)
            nbytes = (inp.numel() + B * c * hw * hw) * inp.element_size() + filt.numel() * 4
            tol = K4B_TOL if dt_in == f32 else K4A_TOL
            checks.append((f"B={B} C={c} d={d} H=W={hw} inp {str(dt_in)[6:]} taps float32",
                           _check(f"{key} {name} d={d} H=W={hw} C={c} inp {str(dt_in)[6:]}", tol,
                                  lambda: fn(inp, filt, d),
                                  lambda: adaptive_conv_tapmajor_plain(inp, filt, d),
                                  lambda: adaptive_conv_tapmajor_plain(
                                      inp, _last_tap_dropped(filt), d),
                                  _bound(nbytes, fp32_ops=2 * B * c * hw * hw * d * d))))
        rows[name] = _row(name, "rs_ov_torch/csrc/adaptive_conv_layouts.cu", tpu_line, checks)
    return rows


def _bf16_conv_kernels(rng, dev):
    """K4e (adaptive_conv_v3) and K4f (adaptive_conv_v4), both operands
    rounded to bf16, against their plain version at B=2, C=512: d=11 on 56^2
    and 28^2 (jbu_one's stages), d=7 on 224^2 (jbu_stack's last; K4f in two
    column chunks of 112), each with fp32 operands, bf16 operands and a bf16
    input with fp32 taps. fp32 output within 1e-5, bf16 within 1e-2 of
    max|ref|, beside the last tap dropped and, for fp32, K4b's unrounded
    function. The bound: each operand's bytes at its dtype, the output at
    the input's, and 2*d^2*C*H*W*B operations on bf16 operands. K4c and,
    where the two dtypes match, K4b / K4a are timed on the same operands,
    in turns with the plain version as the kernels are."""
    from rs_ov_torch.kernels.adaptive_conv import (adaptive_conv_bf16_plain,
                                                   adaptive_conv_planes, adaptive_conv_tapmajor,
                                                   adaptive_conv_tapmajor_plain,
                                                   adaptive_conv_v3, adaptive_conv_v4)

    f32, bf = torch.float32, torch.bfloat16
    checks = {"K4e": [], "K4f": []}
    for d, hw in ((11, 56), (11, 28), (7, 224)):
        for dt_in, dt_f in ((f32, f32), (bf, bf), (bf, f32)):
            inp = torch.from_numpy(rng.randn(B, C, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dt_in), filt.to(dev, dt_f)
            nbytes = ((inp.numel() + B * C * hw * hw) * inp.element_size()
                      + filt.numel() * filt.element_size())
            bound = _bound(nbytes, bf16_ops=2 * B * C * hw * hw * d * d)
            tag = f"inp {str(dt_in)[6:]} taps {str(dt_f)[6:]}"
            faults = ([("unrounded operands", lambda: adaptive_conv_tapmajor_plain(inp, filt, d))]
                      if dt_in == f32 else [])
            yard = {"K4c": lambda: adaptive_conv_planes(inp, filt, d)}
            if dt_in == dt_f:
                yard["K4b" if dt_in == f32 else "K4a"] = lambda: adaptive_conv_tapmajor(inp, filt, d)
            plain = lambda: adaptive_conv_bf16_plain(inp, filt, d)  # noqa: E731
            # timed as the kernels are: in turns with the plain version
            yard_ms = {f"{k}_ms": _timed_pair(fn, plain)[0] for k, fn in yard.items()}
            print(f"[kernels] d={d} H=W={hw} {tag}: on the same operands "
                  + ", ".join(f"{k[:-3]} {v:.4f} ms" for k, v in yard_ms.items()))
            for key, fn in (("K4e", adaptive_conv_v3), ("K4f", adaptive_conv_v4)):
                c = _check(f"{key} {fn.__name__} d={d} H=W={hw} {tag}",
                           K4B_TOL if dt_in == f32 else K4A_TOL,
                           lambda: fn(inp, filt, d), plain,
                           lambda: adaptive_conv_bf16_plain(inp, _last_tap_dropped(filt), d),
                           bound, faults=faults)
                checks[key].append((f"B={B} C={C} d={d} H=W={hw} {tag}", {**c, **yard_ms}))
    src = "rs_ov_torch/csrc/adaptive_conv_bf16.cu"
    return {"adaptive_conv_v3": _row("adaptive_conv_v3", src,
                                     "rs_ov/kernels/adaptive_conv_v3.py:96", checks["K4e"]),
            "adaptive_conv_v4": _row("adaptive_conv_v4", src,
                                     "rs_ov/kernels/adaptive_conv_v4.py:80", checks["K4f"])}


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


K6_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
K6_SCORES = {"vanilla": 1, "ClearCLIP": 1, "SCLIP": 2, "SegEarth": 3, "SFP": 2,
             "Experimental": 2}


def _selfself_attention_kernel(rng, dev):
    """K6 at the main path's shapes (16 crops of a 512x512 image, 12 heads,
    L=197, hd=64) in each mode, with and without the sim map, in bf16
    (within 1e-2 of max|ref|: a bf16 step of the output) and fp32 (1e-5).
    The row leads with the base config's case: Experimental, bf16, sim map.
    The fault is the plain version with its last key masked out of every
    softmax, through a -inf in the sim map's last column. For vanilla and
    ClearCLIP one scaled_dot_product_attention call (in the inputs' dtype;
    its bf16 version rounds the weights, so it is a yardstick of time, not
    of numbers) is timed as the library call; no single call computes the
    other modes."""
    from rs_ov_torch.kernels.selfself_attention import (SUPPORTED_MODES,
                                                        fused_selfself_attention,
                                                        fused_selfself_attention_plain)

    b, h, l, hd = 16, 12, 197, 64
    q32, k32, v32 = (torch.from_numpy(rng.randn(b, h, l, hd).astype(np.float32)).to(dev)
                     for _ in range(3))
    sim = torch.from_numpy(np.pad((rng.randn(b, l - 1, l - 1) * 0.5).astype(np.float32),
                                  ((0, 0), (1, 0), (1, 0)))).to(dev)
    cases = [(m, dt, s) for dt in (torch.bfloat16, torch.float32) for m in SUPPORTED_MODES
             for s in (True, False)]
    cases.remove(("Experimental", torch.bfloat16, True))
    checks = []
    for mode, dtype, with_sim in [("Experimental", torch.bfloat16, True)] + cases:
        q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
        sm = sim if with_sim else None
        masked = (sim if with_sim else torch.zeros_like(sim)).clone()
        masked[..., -1] = float("-inf")
        prod = 2 * b * h * l * l * hd
        nbytes = 4 * b * h * l * hd * q.element_size() + (4 * b * l * l if with_sim else 0)
        n = K6_SCORES[mode]
        bound = (_bound(nbytes, fp32_ops=prod, bf16_ops=n * prod) if dtype == torch.bfloat16
                 else _bound(nbytes, fp32_ops=(n + 1) * prod))
        tag = f"{mode} {str(dtype)[6:]} {'sim' if with_sim else 'no sim'}"
        c = _check(f"K6 fused_selfself_attention {tag}", K6_TOL[dtype],
                   lambda: fused_selfself_attention(q, k, v, sm, mode=mode),
                   lambda: fused_selfself_attention_plain(q, k, v, sm, mode=mode),
                   lambda: fused_selfself_attention_plain(q, k, v, masked, mode=mode),
                   bound, dropped="key")
        if mode in ("vanilla", "ClearCLIP"):
            keys = k if mode == "vanilla" else q
            mask = None if sm is None else sm[:, None].to(dtype)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, keys, v, attn_mask=mask, scale=hd ** -0.5)
            sdpa()
            c["library_ms"] = _median_ms(sdpa)
            c["library"] = f"scaled_dot_product_attention ({str(dtype)[6:]})"
            print(f"[kernels] {tag}: scaled_dot_product_attention {c['library_ms']:.4f} ms")
        checks.append((f"B={b} H={h} L={l} hd={hd} {tag}", c))
    return _row("fused_selfself_attention", "rs_ov_torch/csrc/selfself_attention.cu",
                "rs_ov/kernels/selfself_attention.py:78", checks)


def _base_model_cfg():
    from rs_ov_torch.evalsuite.config import load_config

    cfg = dict(load_config("configs/base_config.py")["model"])
    assert cfg.pop("type") == "SegmentorEx"
    cfg["name_path"] = "configs/cls_potsdam.txt"
    return cfg


def _stack_cfg():
    """Path (b): the full decontamination stack on top of the base config."""
    return {**_base_model_cfg(), "model_type": "SegEarth", "apply_ctd": True,
            "apply_self_attn_enhancement": True, "apply_som": True,
            "apply_cross_tile_fusion": True}


def _clearclip_cfg():
    """Path (c): ClearCLIP with layer fusion; the base config's outlier
    suppression then re-weights through the fused attention."""
    return {**_base_model_cfg(), "model_type": "ClearCLIP", "apply_layer_fusion": True}


KERNELS = ("range_logits", "jbu_epilogue", "jbu_epilogue_classify", "adaptive_conv_bf16",
           "adaptive_conv_f32", "fused_selfself_attention", "jbu_epilogue_fused",
           "jbu_epilogue_fused_classify", "adaptive_conv_planes", "adaptive_conv_cl",
           "adaptive_conv_v3", "adaptive_conv_v4")


def _counted():
    """(module-level function, key of its launches dict or None) per kernel."""
    from rs_ov_torch.kernels import adaptive_conv as ac
    from rs_ov_torch.kernels import jbu_epilogue as epi
    from rs_ov_torch.kernels.range_logits import range_logits
    from rs_ov_torch.kernels.selfself_attention import fused_selfself_attention

    return dict(zip(KERNELS, (
        (range_logits, None), (epi.jbu_epilogue, None), (epi.jbu_epilogue_classify, None),
        (ac.adaptive_conv_tapmajor, torch.bfloat16), (ac.adaptive_conv_tapmajor, torch.float32),
        (fused_selfself_attention, None), (epi.jbu_epilogue_fused, None),
        (epi.jbu_epilogue_fused_classify, None), (ac.adaptive_conv_planes, None),
        (ac.adaptive_conv_cl, None), (ac.adaptive_conv_v3, None), (ac.adaptive_conv_v4, None))))


def _launches():
    return {k: (fn.launches if key is None else fn.launches[key])
            for k, (fn, key) in _counted().items()}


def _reset_launches():
    for fn, key in _counted().values():
        if key is None:
            fn.launches = 0
        else:
            fn.launches[key] = 0


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


def _check_results(route, seg, results):
    for res in results:
        probs, pred = res["seg_logits"], res["pred_sem_seg"]
        assert tuple(pred.shape) == (1, 512, 512), pred.shape
        assert tuple(probs.shape) == (seg.num_classes, 512, 512), probs.shape
        assert bool(torch.isfinite(probs).all()), f"{route}: non-finite probabilities"
        assert 0 <= int(pred.min()) and int(pred.max()) < seg.num_classes, "label range"


def _expect_launches(route, n_images, want):
    launches = _launches()
    want = {k: want.get(k, 0) for k in KERNELS}
    print(f"[slice] {route}: launches over {n_images} image(s) {launches} "
          f"(expected {want})")
    assert launches == want, (route, launches, want)
    return launches


def _drive(route, seg, images, want):
    """predict_raw on each image with every launch counter at 0 before and
    read after; checks the outputs and the counts; prints the tiles/s of the
    requests after the first; returns the counts."""
    _reset_launches()
    secs = []
    for img in images:
        t0 = time.perf_counter()
        res = seg.predict_raw(img)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check_results(route, seg, res)
    launches = _expect_launches(route, len(images), want)
    steady = float(np.median(secs[1:] if len(secs) > 1 else secs))
    print(f"[slice] {route}: request seconds {[round(x, 4) for x in secs]}; "
          f"{16 / steady:.2f} tiles/s (16 crops of 224 per 512x512 image) on {CARD['smi']}")
    return launches


def _drive_batch(route, seg, images, want):
    """predict_batch_raw on all images as one batch, twice: the counters are
    set to 0 before the second call and read after it, and the second call
    is timed."""
    batch = np.concatenate(images)
    seg.predict_batch_raw(batch)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = seg.predict_batch_raw(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert len(res) == len(images)
    _check_results(route, seg, res)
    launches = _expect_launches(route, len(images), want)
    n = 16 * len(images)
    print(f"[slice] {route}: {secs:.4f} s for the batch; {n / secs:.2f} tiles/s "
          f"({n} crops of 224) on {CARD['smi']}")
    return launches


@contextlib.contextmanager
def _recording(module, name):
    """Record (args, result) of every call of ``module.name``."""
    fn, calls = getattr(module, name), []

    def recording(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _drive_entry_points(seg, image):
    """K4c, K4d, K4e and K4f are the adaptive conv's own entry points, which
    no request calls (as in the JAX package): they are driven on the stage
    operands of one fp32 channel-first request, recorded at its adaptive
    conv (K4b). K4c and K4d are held against K4b's outputs, K4e and K4f
    against their plain version of the bf16-rounded operands (1e-5 of
    max|ref|)."""
    from rs_ov_torch.kernels.adaptive_conv import (adaptive_conv_bf16_plain, adaptive_conv_cl,
                                                   adaptive_conv_planes, adaptive_conv_v3,
                                                   adaptive_conv_v4)
    from rs_ov_torch.upsample import jbu

    with _recording(jbu, "adaptive_conv_tapmajor") as calls:
        seg.predict_raw(image)
    refs = [adaptive_conv_bf16_plain(*args) for args, _ in calls]
    _reset_launches()
    worst = {"K4c K4d": 0.0, "K4e K4f": 0.0}
    for ((inp, filt, d), ref), ref16 in zip(calls, refs):
        for key, fns, want in (("K4c K4d", (adaptive_conv_planes, adaptive_conv_cl), ref),
                               ("K4e K4f", (adaptive_conv_v3, adaptive_conv_v4), ref16)):
            for fn in fns:
                err = ((fn(inp, filt, d) - want).abs().max() / want.abs().max()).item()
                worst[key] = max(worst[key], err)
    torch.cuda.synchronize()
    route = "entry points K4c K4d K4e K4f on one fp32 channel-first request's stage operands"
    launches = _expect_launches(route, 1, {k: len(calls) for k in (
        "adaptive_conv_planes", "adaptive_conv_cl", "adaptive_conv_v3", "adaptive_conv_v4")})
    print(f"[slice] {route}: {len(calls)} stages, max|d|/max|ref| K4c K4d against K4b "
          f"{worst['K4c K4d']:.3e}, K4e K4f against their plain version {worst['K4e K4f']:.3e} "
          f"(tol {K4B_TOL})")
    assert max(worst.values()) <= K4B_TOL, worst
    return launches


def phase_slice(rows):
    """Each route through SegmentorEx.predict_raw, counters read per route.
    Returns the segmentors on the card, by name, for the e2e phase."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    t0 = time.perf_counter()
    seg = SegmentorEx(**_base_model_cfg(), device=DEV)
    torch.cuda.synchronize()
    print(f"[slice] SegmentorEx built in {time.perf_counter() - t0:.2f} s: "
          f"{seg.cfg.vision.width} wide, {seg.cfg.vision.layers} layers, "
          f"Q={seg.num_queries}, {seg.num_classes} classes, stages={seg.jbu_stages}, "
          f"tile_chunk={seg._chunk_size()}, dtype={seg.param_dtype}")
    assert 16 // seg._chunk_size() == CHUNKS
    qf = seg.query_features.cpu().numpy()
    segs = {"base": seg,
            "base fp32": SegmentorEx(**_base_model_cfg(), param_dtype=torch.float32,
                                     device=DEV, query_features=qf),
            "jbu_stack": SegmentorEx(**{**_base_model_cfg(), "sim_feat_up_cfg": dict(
                model_name="jbu_stack", num_stages=4)}, device=DEV, query_features=qf),
            "stack": SegmentorEx(**_stack_cfg(), device=DEV, query_features=qf),
            "clearclip": SegmentorEx(**_clearclip_cfg(), device=DEV, query_features=qf)}
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (1, 512, 512, 3), np.uint8) for _ in range(3)]
    s = seg.jbu_stages
    channel_last = {"range_logits": 3 * s * CHUNKS, "jbu_epilogue": 3 * (s - 1) * CHUNKS,
                    "jbu_epilogue_classify": 3 * CHUNKS}
    by_path = {
        "bf16 channel-last": _drive("bf16 channel-last (K1 K2 K3)", seg, images, channel_last),
        "fp32 channel-first": _drive("fp32 channel-first (K1 K4b)", segs["base fp32"], images, {
            "range_logits": 3 * s * CHUNKS, "adaptive_conv_f32": 3 * s * CHUNKS})}
    with _env("RS_OV_JBU_FUSED", "0"):
        by_path["bf16 channel-first"] = _drive(
            "bf16 channel-first, RS_OV_JBU_FUSED=0 (K1 K4a)", seg, images,
            {"range_logits": 3 * s * CHUNKS, "adaptive_conv_bf16": 3 * s * CHUNKS})
    by_path["jbu_stack 4 stages"] = _drive(
        "jbu_stack 4 stages bf16 channel-last (K1 K2 K3 at d=7)", segs["jbu_stack"],
        images[:2], {"range_logits": 2 * 4 * CHUNKS, "jbu_epilogue": 2 * 3 * CHUNKS,
                     "jbu_epilogue_classify": 2 * CHUNKS})
    k6 = {**channel_last, "fused_selfself_attention": 3}
    with _env("RS_OV_FUSED_ATTN", "1"):
        by_path["(a) fused attention"] = _drive(
            "(a) base config, RS_OV_FUSED_ATTN=1 (K6 K1 K2 K3)", seg, images, k6)
        by_path["(b) full stack"] = _drive(
            "(b) SegEarth + CTD + self-attn enhancement + SOM + cross-tile fusion, "
            "RS_OV_FUSED_ATTN=1 (K6 K1 K2 K3)", segs["stack"], images, k6)
        by_path["(c) ClearCLIP"] = _drive(
            "(c) ClearCLIP + layer fusion + outlier suppression, RS_OV_FUSED_ATTN=1 "
            "(K6 K1 K2 K3)", segs["clearclip"], images, k6)
    fused = {"jbu_epilogue_fused": 3 * (s - 1) * CHUNKS, "jbu_epilogue_fused_classify": 3 * CHUNKS}
    with _env("RS_OV_JBU_FUSED_RANGE", "1"):
        by_path["(d) fused range"] = _drive(
            "(d) base config, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b)", seg, images, fused)
        by_path["jbu_stack fused range"] = _drive(
            "jbu_stack 4 stages, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b at d=7)", segs["jbu_stack"],
            images[:2], {"jbu_epilogue_fused": 2 * 3 * CHUNKS,
                         "jbu_epilogue_fused_classify": 2 * CHUNKS})
        by_path["batch, fused range"] = _drive_batch(
            "predict_batch_raw of 3 images, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b)", seg, images,
            fused)
    by_path["batch"] = _drive_batch("predict_batch_raw of 3 images (K1 K2 K3)", seg, images,
                                    channel_last)
    by_path["entry points"] = _drive_entry_points(segs["base fp32"], images[0])
    own = {"range_logits": "bf16 channel-last", "jbu_epilogue": "bf16 channel-last",
           "jbu_epilogue_classify": "bf16 channel-last",
           "adaptive_conv_f32": "fp32 channel-first", "adaptive_conv_bf16": "bf16 channel-first",
           "fused_selfself_attention": "(a) fused attention",
           "jbu_epilogue_fused": "(d) fused range",
           "jbu_epilogue_fused_classify": "(d) fused range",
           "adaptive_conv_planes": "entry points", "adaptive_conv_cl": "entry points",
           "adaptive_conv_v3": "entry points", "adaptive_conv_v4": "entry points"}
    for k in KERNELS:
        rows[k]["launches"] = by_path[own[k]][k]
        rows[k]["launches_by_path"] = {p: c[k] for p, c in by_path.items()}
    return segs


@contextlib.contextmanager
def _dbscan_labels():
    """Record the labels of every CTD clustering the segmentors run."""
    from rs_ov_torch.pipeline import segmentor as mod

    with _recording(mod, "cluster_patch_tokens_dbscan") as calls:
        labels = []
        yield labels
    labels += [out[1].cpu() for _, out in calls]


def phase_e2e(segs):
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    qf = segs["base"].query_features.cpu().numpy()
    img = np.random.RandomState(2).randint(0, 256, (1, 336, 336, 3), np.uint8)
    labels = {}
    out = {"bf16 channel-last": segs["base"].predict_raw(img)[0],
           "fp32 channel-first": segs["base fp32"].predict_raw(img)[0],
           "jbu_stack 4 stages bf16 channel-last": segs["jbu_stack"].predict_raw(img)[0]}
    with _env("RS_OV_JBU_FUSED", "0"):
        out["bf16 channel-first"] = segs["base"].predict_raw(img)[0]
    with _dbscan_labels() as labels["(b) bf16 switch off"]:
        out["(b) bf16 switch off"] = segs["stack"].predict_raw(img)[0]
    stack32 = SegmentorEx(**_stack_cfg(), param_dtype=torch.float32, device=DEV,
                          query_features=qf)
    with _env("RS_OV_FUSED_ATTN", "1"):
        out["(a) bf16"] = segs["base"].predict_raw(img)[0]
        with _dbscan_labels() as labels["(b) bf16"]:
            out["(b) bf16"] = segs["stack"].predict_raw(img)[0]
        with _dbscan_labels() as labels["(b) fp32"]:
            out["(b) fp32"] = stack32.predict_raw(img)[0]
        out["(c) bf16"] = segs["clearclip"].predict_raw(img)[0]
    with _env("RS_OV_JBU_FUSED_RANGE", "1"):
        out["(d) fused range"] = segs["base"].predict_raw(img)[0]
        out["jbu_stack fused range"] = segs["jbu_stack"].predict_raw(img)[0]
    other = np.random.RandomState(3).randint(0, 256, (1, 336, 336, 3), np.uint8)
    batch = np.concatenate([img, img, other])
    # path (b) in bf16 sums its GEMMs differently at another batch size, and
    # its chain of thresholds amplifies that as it does against the CPU
    for name, seg in (("base", segs["base"]), ("(b) fp32", stack32), ("(b) bf16", segs["stack"])):
        one = [seg.predict_raw(x[None])[0] for x in batch]
        for i, res in enumerate(seg.predict_batch_raw(batch)):
            out[f"{name} batch {i}"], out[f"{name} single {i}"] = res, one[i]
    t0 = time.perf_counter()
    cpu = dict(device="cpu", query_features=qf)
    out["fp32 CPU"] = SegmentorEx(**_base_model_cfg(), **cpu).predict_raw(img)[0]
    stack_cfg = {**_base_model_cfg(),
                 "sim_feat_up_cfg": dict(model_name="jbu_stack", num_stages=4)}
    out["jbu_stack 4 stages fp32 CPU"] = SegmentorEx(**stack_cfg, **cpu).predict_raw(img)[0]
    with _dbscan_labels() as labels["(b) fp32 CPU"]:
        out["(b) fp32 CPU"] = SegmentorEx(**_stack_cfg(), **cpu).predict_raw(img)[0]
    out["(c) fp32 CPU"] = SegmentorEx(**_clearclip_cfg(), **cpu).predict_raw(img)[0]
    cpu_s = time.perf_counter() - t0
    for a, b, need in (("bf16 channel-first", "bf16 channel-last", 0.95),
                       ("fp32 channel-first", "bf16 channel-last", 0.95),
                       ("fp32 channel-first", "fp32 CPU", 0.999),
                       ("bf16 channel-last", "fp32 CPU", 0.95),
                       ("jbu_stack 4 stages bf16 channel-last",
                        "jbu_stack 4 stages fp32 CPU", 0.95),
                       ("(a) bf16", "bf16 channel-last", 0.99),
                       ("(b) bf16", "(b) bf16 switch off", 0.99),
                       ("(b) fp32", "(b) fp32 CPU", 0.99),
                       ("(a) bf16", "fp32 CPU", 0.95),
                       ("(b) bf16", "(b) fp32 CPU", 0.95),
                       ("(c) bf16", "(c) fp32 CPU", 0.95),
                       ("(d) fused range", "bf16 channel-last", 0.99),
                       ("(d) fused range", "fp32 CPU", 0.95),
                       ("jbu_stack fused range", "jbu_stack 4 stages fp32 CPU", 0.95),
                       *((f"base batch {i}", f"base single {i}", 0.999) for i in range(3)),
                       *((f"(b) fp32 batch {i}", f"(b) fp32 single {i}", 0.99) for i in range(3)),
                       *((f"(b) bf16 batch {i}", f"(b) bf16 single {i}", 0.95) for i in range(3))):
        pa, pb = out[a]["pred_sem_seg"].cpu(), out[b]["pred_sem_seg"].cpu()
        agree = (pa == pb).float().mean().item()
        dprob = (out[a]["seg_logits"].cpu() - out[b]["seg_logits"].cpu()).abs().max().item()
        same = ""
        if a in labels and b in labels:
            la, lb = torch.cat(labels[a]), torch.cat(labels[b])
            same = f", CTD labels equal {(la == lb).float().mean().item():.4f}"
        print(f"[e2e] 336x336 (4 crops): {a} vs {b}: argmax agreement {agree:.6f} "
              f"(need >= {need}), max |d prob| {dprob:.4f}{same}")
        assert agree >= need, f"{a} vs {b}: agreement {agree}"
    print(f"[e2e] CPU runs {cpu_s:.1f} s")


EVAL_IMAGES = 12  # batch 3 then gives 4 batches: the sustained rates leave out the first 2
EVAL_CFG = "configs/cfg_potsdam.py"
SYNTH_CONFIGS = ("cfg_chn6-cug", "cfg_deepglobe_road", "cfg_massachusetts_road",
                 "cfg_spacenet_road", "cfg_openearthmap", "cfg_whu_sat_II", "cfg_wbs-si")


def _write_potsdam(root, rng):
    """EVAL_IMAGES 512x512 RGB images and Potsdam labels (0 ignored, 1-6 the
    six classes, in blocks of 32 pixels) as PNG in cfg_potsdam's layout."""
    from rs_ov_torch.data.palette import save_png

    base = os.path.join(root, "payload", "datasets", "Potsdam")
    img_dir = os.path.join(base, "images", "validation")
    ann_dir = os.path.join(base, "annotations", "validation")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    for i in range(EVAL_IMAGES):
        save_png(rng.randint(0, 256, (512, 512, 3), np.uint8), os.path.join(img_dir, f"{i:02d}.png"))
        blocks = rng.randint(0, 7, (16, 16)).astype(np.uint8)
        save_png(np.kron(blocks, np.ones((32, 32), np.uint8)), os.path.join(ann_dir, f"{i:02d}.png"))
    return img_dir, ann_dir


def _state(work_dir):
    return np.load(os.path.join(work_dir, "metric_state.npz"))["state"]


def phase_eval(rows):
    """run_eval on cfg_potsdam at full ViT-B/16 width on the card, checked
    against the host metric, across batch sizes and shards; result_dir; then
    eval_all over the committed data_synth configs."""
    from rs_ov_torch import eval_all
    from rs_ov_torch.data.loader import SegDataset
    from rs_ov_torch.evalsuite.config import load_config
    from rs_ov_torch.evalsuite.metrics import IoUMetric
    from rs_ov_torch.evalsuite.runner import (build_segmentor_from_config, merge_eval_results,
                                              run_eval)

    n, pixels = EVAL_IMAGES, EVAL_IMAGES * 512 * 512
    with tempfile.TemporaryDirectory() as tmp, _env("RS_OV_DATA_ROOT", os.path.join(tmp, "root")):
        img_dir, ann_dir = _write_potsdam(os.path.join(tmp, "root"), np.random.RandomState(4))
        seg = build_segmentor_from_config(load_config(EVAL_CFG),
                                          {"device": DEV, "pred_dtype": "uint8"})
        s = seg.jbu_stages
        want = {"range_logits": n * s * CHUNKS, "jbu_epilogue": n * (s - 1) * CHUNKS,
                "jbu_epilogue_classify": n * CHUNKS}
        results, states = {}, {}
        for batch in (1, 3):
            work = os.path.join(tmp, f"batch{batch}")
            _reset_launches()
            results[batch] = run_eval(EVAL_CFG, work_dir=work, segmentor=seg,
                                      batch_images=batch, verbose=False)
            launches = _expect_launches(f"eval: run_eval batch_images={batch} (K1 K2 K3)", n, want)
            for k in KERNELS:
                rows[k]["launches_by_path"][f"eval batch {batch}"] = launches[k]
            states[batch] = _state(work)
            r = results[batch]
            print(f"[eval] cfg_potsdam, {n} images of 512x512, batch_images={batch}: "
                  f"aAcc {r['aAcc']:.4f} mIoU {r['mIoU']:.4f} mAcc {r['mAcc']:.4f}; "
                  f"img_per_sec_sustained {r['img_per_sec_sustained']:.4f} "
                  f"tiles512_per_sec_sustained {r['tiles512_per_sec_sustained']:.4f} "
                  f"(tiles512_per_sec {r['tiles512_per_sec']:.4f}) on {CARD['smi']}")

        host = IoUMetric(num_classes=seg.num_classes)
        for sample in SegDataset("ISPRSDataset", img_dir, ann_dir, raw=True):
            pred = seg.predict_raw(sample.img[None], [sample.meta])[0]["pred_sem_seg"]
            host.process(pred[0].cpu().numpy(), sample.seg)
        dev13 = np.abs(states[3] - states[1]).max()
        print(f"[eval] device state equals the host confusion_update over per-image "
              f"predict_raw: {np.array_equal(host.state, states[1])}; batch 3 vs batch 1: "
              f"max |d entry| {dev13:.0f} of {pixels} pixels (need <= {1e-3 * pixels:.0f})")
        assert np.array_equal(host.state, states[1]), (host.state, states[1])
        assert dev13 <= 1e-3 * pixels, dev13

        dist = os.path.join(tmp, "dist")
        for rank in (0, 1):
            run_eval(EVAL_CFG, work_dir=os.path.join(dist, f"rank{rank}"), shard=(rank, 2),
                     segmentor=seg, verbose=False)
        merged = merge_eval_results(dist, verbose=False)
        shards = sum(_state(os.path.join(dist, f"rank{r}")) for r in (0, 1))
        print(f"[eval] two shards merged: mIoU {merged['mIoU']:.4f}, state equal to the "
              f"single run: {np.array_equal(shards, states[1])}")
        assert np.array_equal(shards, states[1]) and merged["mIoU"] == results[1]["mIoU"]

        seg_dir = os.path.join(tmp, "seg")
        run_eval(EVAL_CFG, work_dir=os.path.join(tmp, "dump"), model_overrides={"device": DEV},
                 save_seg_dir=seg_dir, verbose=False)
        pngs = sorted(os.listdir(seg_dir))
        dump13 = np.abs(_state(os.path.join(tmp, "dump")) - states[1]).max()
        print(f"[eval] result_dir with run_eval's own segmentor: {len(pngs)} PNGs; "
              f"max |d entry| against batch 1 {dump13:.0f}")
        assert pngs == [f"{i:02d}.png" for i in range(n)], pngs
        assert dump13 <= 1e-3 * pixels, dump13

    with _env("RS_OV_DATA_ROOT", "data_synth"), tempfile.TemporaryDirectory() as tmp:
        summary = eval_all.main(["--device", DEV.type, "--work-dir", tmp])
    for name in SYNTH_CONFIGS:
        r = summary[f"./configs/{name}.py"]
        assert "mIoU" in r, (name, r)
        print(f"[eval] eval_all {name}: {r['num_images']} images, mIoU {r['mIoU']:.4f}")


def main():
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_e2e(phase_slice(rows))
    phase_eval(rows)
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
