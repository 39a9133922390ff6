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
                with zero padding in place of reflection, and for K3 also
                with its fixup bias left out and with the normalised vector
                unrounded, each of which must exceed the bound; the bare
                library call of K1, K2, K3, K4a-K4f, K5a, K5b and K6 beside
                the wrapper's; the median times (CUDA events, in turns),
                the bound from the shapes and, for K6's vanilla and ClearCLIP
                modes, the time of one scaled_dot_product_attention call.
                K5a and K5b are also held against the split pair they replace
                (K1 + reflect pads + K2 / K3) on the card, with the count of
                outputs that differ from it, and timed in turns with it.
                K4e and K4f (both operands rounded to bf16) at d=11 on 28^2
                and 56^2 and d=7 on 224^2, in all four operand pairs (bf16 or
                fp32 each), also beside K4b's unrounded function (fp32
                input) and timed beside K4b/K4a and K4c. K3 and K5b are held
                against their plain version with every fp32 product summed
                in order (the order in which K3 re-takes a sum near a bf16
                midpoint; cuBLAS picks its own by size), the gap to the
                plain version as cuBLAS sums it printed beside. Then each
                at the other towers' shapes (TOWER_STAGES) beside the
                dropped tap: K1 at d=11 on 14^2, 32^2 and 64^2; K2 and K5a
                at C=512 14^2 (ViT-B/32), 768 and 1024 32^2 (ViT-L/14,
                ViT-H/14), 256 28^2 (BLIP); K3 and K5b at their last
                stages (28^2, 64^2, 64^2, 56^2); K4b and K4a at C=768 and
                1024 on 32^2 and 64^2; K6 in bf16 and fp32, each mode with
                the sim map, at L=50 hd=64 (12 heads), L=257 hd=64 and
                L=257 hd=80 (16 heads).
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
                fusion and outlier suppression, and the base config in fp32
                (fp32 K6 once per request, K1 K4b as on the fp32
                channel-first route); then with
                RS_OV_JBU_FUSED_RANGE=1: (d) the base config (K5a, K5b) and
                jbu_stack at 4 stages (K5a, K5b at d=7, two images);
                predict_batch_raw on the three images as one batch, with the
                fused-range switch off (K1 K2 K3) and on (K5a K5b); and the
                adaptive-conv entry points K4c and K4d on the stage operands
                of one fp32 channel-first request, against K4b's outputs, and
                K4e and K4f on the same operands against their plain version;
                K3 on one default request's last-stage operands: how many of
                its rounded sums land near a bf16 midpoint (the kernel takes
                those again in order) and its time on them.
                Then the other towers at full width, random weights (a
                warm-up and two timed requests each): one tower of each
                arch the segmentor resolves (ViT-B-32, ViT-B-16,
                ViT-B-16-quickgelu, ViT-L-14, ViT-L-14-quickgelu, ViT-H-14)
                on the bf16 channel-last route, ViT-L-14 and ViT-H-14 also
                with RS_OV_FUSED_ATTN=1 and in fp32 channel-first with and
                without it; GEM on CLIP ViT-B/16 (gem_depth 7) in bf16
                channel-last and fp32 channel-first; BLIP base in bf16
                channel-last (the committed WordPiece vocabulary).
                Checks outputs and that every launch counter moved by
                exactly the expected amount; prints crops/s (224²) and 512²
                tiles/s (crops/s / 16) per route over the requests after the
                first (batches: the second call).
  5. e2e      - one 336x336 image through every route on the card and
                through the fp32 CPU route, with the same weights and
                queries, compared pair by pair (E2E_PAIRS): fp32 on the card
                against the CPU, the base config in fp32 with
                RS_OV_FUSED_ATTN=1 against 0, and predict_batch_raw of two
                copies of the image and another against predict_raw of each,
                argmax agreement >= 0.999 on all pixels; the pairs whose runs
                round differently (bf16 against the CPU, routes against each
                other, the switches, jbu_stack, path (b) in fp32 and its
                batch) on the pixels the reference run decides (top-1 minus
                top-2 class probability >= TAU): agreement >= 0.999 there,
                on at least half of the image. Each pair prints the all-pixel
                agreement, the decided agreement and share (also at each of
                TAUS) and, for path (b), the share of CTD's DBSCAN labels
                that agree. A planted fault (one of the last block's 12
                attention heads zeroed, bf16 default route) must fail the
                decided-pixel gate against the fp32 CPU run. GEM, BLIP
                base (on BLIP_CLASSES; on Potsdam's printed, not gated) and
                ViT-L-14 in bf16 on the card against their fp32 CPU runs on
                the decided pixels; one head of GEM's gem stream zeroed
                must fail that gate.
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
  7. entry    - the open_clip entry (rs_ov_torch.factory, gem_api, hub) at
                full width on random weights from seed 0: ViT-B-16 through
                create_model_and_transforms (8 uint8 images of 256x320
                through its preprocess, 8 prompts, the zero-shot logits),
                on the card in fp32 against the CPU's fp32 (max|d|/max|ref|
                <= ENTRY_TOL on the pooled and token embeddings, the text
                embeddings and the logits; one head of the last block
                zeroed must land above it) and in bf16 against the card's
                fp32 (cosine >= ENTRY_COS per embedding); ViT-L-14-CLIPA
                (avg pool, no ln_pre, the LN after the pool; fault: the LN
                before the pool) and ViT-M-16-alt (LayerScale; fault: the
                gammas left out) likewise; encode_image images/s at batch
                64 in fp32 and bf16 for each; encode_image(model_type=
                "Experimental") with RS_OV_FUSED_ATTN=1 launching K6
                exactly once, against the plain route within K6's bounds;
                create_gem_model's heatmaps on a 448² image against the
                CPU; save_for_hub loaded back by create_model with equal
                outputs; SegmentorEx with each of resize_conv, ifa, carafe
                and sapa (base config otherwise): a 512² request each,
                crops/s beside the default route, no kernel launched; and
                carafe's 336² bf16 run against its fp32 CPU run on phase
                5's decided-pixel gate, one zeroed head failing it.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# (1.1e-2) or the bf16 rounding of the normalised vector (1.9e-3) does not;
# the last two are measured beside the bound on every K3 check.
# K4b (fp32) and K4a (bf16) are held to 1e-5 and 1e-2 of max|ref|: K4a's
# bound is one or two bf16 flips of an output (a step is 2^-8 of the value).
# For every kernel and shape, the plain version without its last tap, on the
# same inputs, is printed beside the bound, and must land above it.
# K5a and K5b take K2's and K3's bounds, K4c-K4f K4b's with an fp32 input
# and K4a's with a bf16 input. K3's and K5b's plain version sums its fp32
# products in order there (_in_order), as K3 re-takes a sum near a bf16
# midpoint; cuBLAS's own order could move it ~1.5e-3.
K1_TOL, K2_TOL, K3_TOL, K4B_TOL, K4A_TOL = 1e-5, 1e-2, 1e-3, 1e-5, 1e-2
B, D, K, C, G, Q = 2, 11, 32, 512, 3, 8
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BPS, FP32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12
CHUNKS = 8  # 16 crops of a 512x512 image in chunks of 2
DEV = torch.device("cuda")
# The stages the other towers give the JBU kernels (jbu_one, d=11, two
# stages): (C, the first stage's output grid, the last stage's); ViT-B/32
# 512 channels on a 7^2 token grid, ViT-L/14 768 and ViT-H/14 1024 on 16^2,
# BLIP 256 on 14^2.
TOWER_STAGES = ((512, 14, 28), (768, 32, 64), (1024, 32, 64), (256, 28, 56))


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


def _bound(nbytes: float, fp32_ops: float = 0.0, bf16_ops: float = 0.0,
           tf32_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the peak rate of their operand type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = fp32_ops / FP32_FLOPS + bf16_ops / BF16_FLOPS + tf32_ops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _epilogue_bound(h, w, with_classify, d=D, fused=False, C=C):
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


def _epilogue_inputs(rng, h, w, dev, d=D, C=C):
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


def _check(label, tol, kernel, plain, faulty, bound, dropped="tap", faults=(), oracle=None):
    """kernel() against oracle() (default: plain()) as max|d|/max|ref|,
    beside faulty(): the plain version with its last tap (or key) dropped,
    on the same inputs, and each (name, fault) of ``faults``, all of which
    must land above the bound; where an oracle is given, the kernel's gap
    to plain() is printed beside. plain() is what is timed. Returns the
    row's measured numbers."""
    got, ref, bad = kernel().float(), (oracle or plain)().float(), faulty().float()
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel, fault_rel = err / scale, (bad - ref).abs().max().item() / scale
    more = {name: (fn().float() - ref).abs().max().item() / scale for name, fn in faults}
    gaps = {}
    if oracle is not None:
        ref_plain = plain().float()
        gaps = {"rel_to_plain": (got - ref_plain).abs().max().item() / scale,
                "oracle_to_plain": (ref - ref_plain).abs().max().item() / scale}
        print(f"[kernels] {label}: {rel:.3e} of max|ref| from the plain version with its "
              f"products summed in order, {gaps['rel_to_plain']:.3e} from it as cuBLAS sums "
              f"them; the two plain versions {gaps['oracle_to_plain']:.3e} apart")
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
                **{f"fault_rel_{name.replace(' ', '_')}": v for name, v in more.items()},
                **gaps)


def _matmul_in_order(x, wt):
    """x [..., K] @ wt [K, N] in fp32 with the sum over k taken in order, one
    rounding per step (each fma held exactly in fp64): the order in which K3
    re-takes a sum near a bf16 rounding midpoint; cuBLAS picks its order by
    size, and its own bf16 rounding flips alone can reach K3's bound."""
    x2 = x.reshape(-1, x.shape[-1])
    acc = torch.zeros((x2.shape[0], wt.shape[1]), dtype=torch.float64, device=x.device)
    for k in range(x2.shape[1]):
        acc = (acc + x2[:, k:k + 1].double() * wt[k].double()).float().double()
    return acc.float().reshape(*x.shape[:-1], wt.shape[1])


def _in_order(plain):
    """plain() with every torch.matmul of the plain epilogues summed in order."""
    def run():
        matmul, torch.matmul = torch.matmul, _matmul_in_order
        try:
            return plain()
        finally:
            torch.matmul = matmul
    return run


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


@contextlib.contextmanager
def _tail_without_rounding():
    """The plain classify tail with the bf16 rounding of the normalised
    vector left out."""
    from rs_ov_torch.kernels import jbu_epilogue as mod

    tail = mod._cls_tail

    def faulty(y, fixup_w, fixup_b, query_features, dt):
        yb = y.to(dt)
        fx = torch.matmul(yb.float(), fixup_w.to(dt).float().t())
        r32 = (((fx + fixup_b.float()) * 0.1).to(dt) + yb).float()
        rn = r32 * torch.rsqrt(r32.square().sum(-1, keepdim=True).clamp_min(1e-24))
        return torch.matmul(rn, query_features.to(dt).float().t())

    mod._cls_tail = faulty
    try:
        yield
    finally:
        mod._cls_tail = tail


def _classify_check(rng, dev, tail, d, hw, c=C, more_faults=True):
    """K3 at d, hw, c channels against its plain version with every product
    summed in order (_in_order), beside the plain version with its last tap
    dropped and, with ``more_faults``, two more faults of it (the fixup bias
    left out, the normalised vector left unrounded), each of which must land
    above K3_TOL; then the bare library call (one launch on operands checked
    once) timed in turns with the wrapper's call, whose operand checks and
    allocation add host time to the events' window. The row's ``ms`` is the
    wrapper's, as in every row; ``kernel_ms`` the bare call's."""
    from rs_ov_torch.kernels import jbu_epilogue as mod

    a = {**_epilogue_inputs(rng, hw, hw, dev, d, c), **tail}
    plain = lambda: mod.jbu_epilogue_classify_plain(**a, diameter=d)  # noqa: E731
    wrapper = lambda: mod.jbu_epilogue_classify(**a, diameter=d)  # noqa: E731

    def dropped():
        with _epilogue_conv_without_last_tap():
            return plain()

    def unrounded():
        with _tail_without_rounding():
            return plain()

    faults = [("the fixup bias left out", lambda: mod.jbu_epilogue_classify_plain(
        **{**a, "fixup_b": torch.zeros_like(a["fixup_b"])}, diameter=d)),
              ("the normalised vector unrounded", unrounded)]
    tag = f"d={d} H=W={hw}" + ("" if c == C else f" C={c}")
    r = _check(f"K3 jbu_epilogue_classify {tag}", K3_TOL, wrapper, plain, dropped,
               _epilogue_bound(hw, hw, True, d, C=c), faults=faults if more_faults else (),
               oracle=_in_order(plain))
    _out, args, _keep = mod._classify_operands(**a, diameter=d)  # _out outlives the calls
    _bare_beside_wrapper(f"K3 {tag}", r, "rs_jbu_epilogue_classify", args, wrapper)
    return r


def _tail(rng, dev, c=C):
    """The classify tail at c channels: a bf16 fixup conv and bias, Q unit
    query vectors."""
    fw = torch.from_numpy((rng.randn(c, c) / np.sqrt(c)).astype(np.float32)).to(dev, torch.bfloat16)
    fb = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)).to(dev, torch.bfloat16)
    qf = torch.from_numpy(rng.randn(Q, c).astype(np.float32)).to(dev)
    return dict(fixup_w=fw, fixup_b=fb, query_features=qf / qf.norm(dim=-1, keepdim=True))


def _bare_beside_wrapper(label, c, entry, args, wrapper):
    """The bare library call ``entry(*args, stream)`` (one launch on operands
    checked once, no launch count) timed in turns with the wrapper's call,
    whose operand checks and allocation add host time to the events'
    window; into c["kernel_ms"]."""
    from rs_ov_torch.kernels.build import load_library

    fn, stream = getattr(load_library(), entry), torch.cuda.current_stream().cuda_stream
    c["kernel_ms"], wrapper_ms = _timed_pair(lambda: fn(*args, stream), wrapper)
    print(f"[kernels] {label}: bare library call {c['kernel_ms']:.4f} ms, "
          f"wrapper {wrapper_ms:.4f} ms in turns on {CARD['smi']}")


def _last_tap_dropped(t):
    t = t.clone()
    t[:, -1] = 0
    return t


def phase_kernels():
    """K1-K3 at jbu_one's shapes (d=11) and at jbu_stack's (d=7, grids 28^2 to
    224^2, 4 stages), K4a/K4b at the channel-first route's."""
    from rs_ov_torch.kernels.jbu_epilogue import (_epilogue_operands, jbu_epilogue,
                                                  jbu_epilogue_plain)
    from rs_ov_torch.kernels.range_logits import (_range_logits_operands, range_logits,
                                                  range_logits_plain)
    from rs_ov_torch.utils.resize import reflect_pad_2d

    dev = DEV
    rng = np.random.RandomState(0)

    k1 = []
    for d, hw in ((11, 56), (11, 28), (7, 28), (7, 224), (11, 14), (11, 32), (11, 64)):
        proj = torch.from_numpy(rng.randn(B, K, hw, hw).astype(np.float32)).to(dev)
        padded = reflect_pad_2d(proj, d // 2).contiguous()
        bound = _bound(4 * B * K * ((hw + d - 1) ** 2 + hw * hw) + 4 * B * d * d * hw * hw,
                       fp32_ops=2 * B * K * d * d * hw * hw)
        wrapper = lambda: range_logits(padded, proj, d)  # noqa: E731
        c = _check(f"K1 range_logits d={d} H=W={hw}", K1_TOL, wrapper,
                   lambda: range_logits_plain(padded, proj, d),
                   lambda: _last_tap_dropped(range_logits_plain(padded, proj, d)), bound)
        _out, args = _range_logits_operands(padded, proj, d)  # _out outlives the calls
        _bare_beside_wrapper(f"K1 d={d} H=W={hw}", c, "rs_range_logits", args, wrapper)
        k1.append((f"B={B} K={K} d={d} H=W={hw}", c))

    k2 = []
    for d, hw, c in ((11, 28, C), (7, 28, C), (7, 112, C),
                     *((11, first, c) for c, first, _ in TOWER_STAGES)):
        a = _epilogue_inputs(rng, hw, hw, dev, d, c)

        def faulty():
            with _epilogue_conv_without_last_tap():
                return jbu_epilogue_plain(**a, diameter=d)

        tag = f"d={d} H=W={hw}" + ("" if c == C else f" C={c}")
        wrapper = lambda: jbu_epilogue(**a, diameter=d)  # noqa: E731
        r = _check(f"K2 jbu_epilogue {tag}", K2_TOL, wrapper,
                   lambda: jbu_epilogue_plain(**a, diameter=d), faulty,
                   _epilogue_bound(hw, hw, False, d, C=c))
        _out, args, _keep = _epilogue_operands(**a, diameter=d)  # _out outlives the calls
        _bare_beside_wrapper(f"K2 {tag}", r, "rs_jbu_epilogue", args, wrapper)
        k2.append((f"B={B} d={d} C={c} G={G} H=W={hw}", r))

    tail = _tail(rng, dev)
    k3 = [(f"B={B} d={d} C={C} G={G} Q={Q} H=W={hw}", _classify_check(rng, dev, tail, d, hw))
          for d, hw in ((11, 56), (7, 224))]
    k3 += [(f"B={B} d=11 C={c} G={G} Q={Q} H=W={last}",
            _classify_check(rng, dev, _tail(rng, dev, c), 11, last, c, more_faults=False))
           for c, _, last in TOWER_STAGES]

    rows = {
        "range_logits": _row("range_logits", "rs_ov_torch/csrc/range_logits.cu",
                             "rs_ov/kernels/range_logits.py:64", k1),
        "jbu_epilogue": _row("jbu_epilogue", "rs_ov_torch/csrc/jbu_classify_sm90.cu",
                             "rs_ov/kernels/jbu_epilogue.py:212", k2),
        "jbu_epilogue_classify": _row("jbu_epilogue_classify",
                                      "rs_ov_torch/csrc/jbu_classify_sm90.cu",
                                      "rs_ov/kernels/jbu_epilogue.py:333", k3)}
    rows.update(_adaptive_conv_kernels(rng, dev))
    rows.update(_fused_range_kernels(rng, dev))
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


def _fused_inputs(rng, hw, dev, d, c=C):
    """One fused-range stage's operands: the unpadded bf16 source, the fp32
    projection [B, H, W, K] (scaled so that the tap softmax spreads over the
    window) and the channel-first bf16 guidance; the rest as K2's."""
    a = _epilogue_inputs(rng, hw, hw, dev, d, c)
    del a["logits_t"], a["guid_t"]
    a["inp"] = torch.from_numpy(rng.randn(B, hw, hw, c).astype(np.float32)).to(dev, torch.bfloat16)
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


def _fused_range_kernels(rng, dev):
    """K5a at K2's shapes (d=11 28^2, d=7 28^2 and 112^2, and the other
    towers' first stages) and K5b at K3's (d=11 56^2, d=7 224^2, and the
    other towers' last stages), B=2, K=32, G=3, Q=8, C=512 or the tower's,
    within K2's and K3's bounds of their plain versions, beside two faults
    (the last tap dropped; at C=512 zero padding in place of reflection),
    with the bare library call timed beside the wrapper; then against the
    split pair each replaces (K1 + reflect pads + K2 / K3) on the card,
    within the same bound, with the count of outputs that differ from it at
    all and the pair's time and the kernel's taken in turns."""
    from rs_ov_torch.kernels import jbu_epilogue as mod

    rows = {}
    for key, tol, name, tpu_line, shapes, classify in (
            ("K5a", K2_TOL, "jbu_epilogue_fused", "rs_ov/kernels/jbu_epilogue.py:640",
             ((11, 28, C), (7, 28, C), (7, 112, C),
              *((11, first, c) for c, first, _ in TOWER_STAGES)), False),
            ("K5b", K3_TOL, "jbu_epilogue_fused_classify", "rs_ov/kernels/jbu_epilogue.py:675",
             ((11, 56, C), (7, 224, C), *((11, last, c) for c, _, last in TOWER_STAGES)), True)):
        checks = []
        for d, hw, c in shapes:
            a = _fused_inputs(rng, hw, dev, d, c)
            extra = _tail(rng, dev, c) if classify else None
            t = {} if extra is None else extra
            if extra is None:
                kernel = lambda: mod.jbu_epilogue_fused(**a, diameter=d)  # noqa: E731
                plain = lambda: mod.jbu_epilogue_fused_plain(**a, diameter=d)  # noqa: E731
                operands, entry = mod._fused_operands, "rs_jbu_epilogue_fused"
            else:
                kernel = lambda: mod.jbu_epilogue_fused_classify(**a, **t, diameter=d)  # noqa: E731
                plain = lambda: mod.jbu_epilogue_fused_classify_plain(**a, **t, diameter=d)  # noqa: E731
                operands, entry = mod._fused_classify_operands, "rs_jbu_epilogue_fused_classify"

            def dropped():
                with _epilogue_conv_without_last_tap():
                    return plain()

            def zero_padded():
                with _zero_padding():
                    return plain()

            label = f"{key} d={d} H=W={hw}" + ("" if c == C else f" C={c}")
            r = _check(f"{key} {name} {label[4:]}", tol, kernel, plain, dropped,
                       _epilogue_bound(hw, hw, extra is not None, d, fused=True, C=c),
                       faults=[("zero padding", zero_padded)] if c == C else (),
                       oracle=None if extra is None else _in_order(plain))
            _out, args, _keep = operands(**a, **t, diameter=d)  # _out outlives the calls
            _bare_beside_wrapper(label, r, entry, args, kernel)
            split = lambda: _split_stage(a, d, extra)  # noqa: E731
            got, ref = kernel().float(), split().float()
            r["split_rel"] = (got - ref).abs().max().item() / ref.abs().max().item()
            r["split_ndiff"] = int((got != ref).sum())
            r["split_ms"], r["split_kernel_ms"] = _timed_pair(split, kernel)
            print(f"[kernels] {label} against the split pair K1 + pads + "
                  f"{'K3' if extra is not None else 'K2'}: max|d|/max|ref|={r['split_rel']:.3e} "
                  f"(tol {tol}), {r['split_ndiff']} of {ref.numel()} outputs differ; in turns: "
                  f"split pair {r['split_ms']:.4f} ms, kernel {r['split_kernel_ms']:.4f} ms "
                  f"on {CARD['smi']}")
            assert r["split_rel"] <= tol, f"{key} disagrees with the split pair"
            checks.append((f"B={B} d={d} C={c} K={K} G={G}"
                           + (f" Q={Q}" if extra is not None else "") + f" H=W={hw}", r))
        rows[name] = _row(name, "rs_ov_torch/csrc/jbu_classify_sm90.cu", tpu_line, checks)
    return rows


def _adaptive_layout_kernels(rng, dev):
    """K4c (planes) and K4d (channels-last) at K4b's shapes (B=2, C=512, d=11
    at 56^2 and 28^2, d=7 at 56^2) in fp32, at d=11 56^2 with a bf16 input
    and fp32 taps, bf16 for both, and an fp32 input with bf16 taps, and for
    K4d C=96 at d=7 56^2; fp32 input within 1e-5, bf16 input within 1e-2 of
    max|ref|, each beside the plain version with its last tap dropped and
    with the bare library call timed beside the wrapper. The bound counts
    what the kernel multiplies on the tensor cores: bf16 x bf16 once at the
    bf16 rate, with an fp32 operand two TF32 products (three where both are
    fp32); beside it the fp32 cores' reckoning, every product once."""
    from rs_ov_torch.kernels.adaptive_conv import (_layout_operands, adaptive_conv_cl,
                                                   adaptive_conv_planes,
                                                   adaptive_conv_tapmajor_plain)

    f32, bf = torch.float32, torch.bfloat16
    rows = {}
    for key, name, fn, source, tpu_line, cases in (
            ("K4c", "adaptive_conv_planes", adaptive_conv_planes,
             "rs_ov_torch/csrc/adaptive_conv.cu", "rs_ov/kernels/adaptive_conv.py:189", []),
            ("K4d", "adaptive_conv_cl", adaptive_conv_cl,
             "rs_ov_torch/csrc/adaptive_conv_cl.cu", "rs_ov/kernels/adaptive_conv.py:70",
             [(7, 56, 96, f32, f32)])):
        channels_last = key == "K4d"
        checks = []
        for d, hw, c, dt_in, dt_f in [(11, 56, C, f32, f32), (11, 28, C, f32, f32),
                                      (7, 56, C, f32, f32), (11, 56, C, bf, f32),
                                      (11, 56, C, bf, bf), (11, 56, C, f32, bf)] + cases:
            inp = torch.from_numpy(rng.randn(B, c, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dt_in), filt.to(dev, dt_f)
            nbytes = ((inp.numel() + B * c * hw * hw) * inp.element_size()
                      + filt.numel() * filt.element_size())
            ops = 2 * B * c * hw * hw * d * d
            bound = (_bound(nbytes, bf16_ops=ops) if dt_in == dt_f == bf else
                     _bound(nbytes, tf32_ops=(3 if dt_in == dt_f else 2) * ops))
            tol = K4B_TOL if dt_in == f32 else K4A_TOL
            tag = f"inp {str(dt_in)[6:]} taps {str(dt_f)[6:]}"
            label = f"{key} {name} d={d} H=W={hw} C={c} {tag}"
            wrapper = lambda: fn(inp, filt, d)  # noqa: E731
            c_ = _check(label, tol, wrapper,
                        lambda: adaptive_conv_tapmajor_plain(inp, filt, d),
                        lambda: adaptive_conv_tapmajor_plain(inp, _last_tap_dropped(filt), d),
                        bound)
            _out, entry, args, _src = _layout_operands(inp, filt, d, channels_last)  # outlive them
            _bare_beside_wrapper(label, c_, entry, args, wrapper)
            c_["tiling"] = list(args[-2:])
            c_["bound_ms_fp32_cores"] = _bound(nbytes, fp32_ops=ops)[0]
            print(f"[kernels] {label}: bound {bound[0]:.4f} ms by {bound[1]} (tensor cores); "
                  f"{c_['bound_ms_fp32_cores']:.4f} ms reckoned with every product once at the "
                  f"fp32 cores' rate; tiling R x channels/warp {args[-2]} x {args[-1]}")
            checks.append((f"B={B} C={c} d={d} H=W={hw} {tag}", c_))
        rows[name] = _row(name, source, tpu_line, checks)
    return rows


def _bf16_conv_kernels(rng, dev):
    """K4e (adaptive_conv_v3) and K4f (adaptive_conv_v4), both operands
    rounded to bf16, against their plain version at B=2, C=512: d=11 on 56^2
    and 28^2 (jbu_one's stages), d=7 on 224^2 (jbu_stack's last; two column
    chunks of 112 in the JAX K4f), each with fp32 operands, bf16 operands, a
    bf16 input with fp32 taps and an fp32 input with bf16 taps. fp32 output
    within 1e-5, bf16 within 1e-2 of max|ref|, beside the last tap dropped
    and, for an fp32 input, K4b's unrounded function; the bare library call
    timed beside the wrapper. The bound: each operand's bytes at its dtype,
    the output at the input's, and 2*d^2*C*H*W*B operations at the bf16
    tensor-core rate (the kernel's product); beside it the fp32 cores'
    reckoning, every product once. K4c and, where the two dtypes match, K4b
    / K4a are timed on the same operands, in turns with the plain version as
    the kernels are."""
    from rs_ov_torch.kernels.adaptive_conv import (_rounded_operands, adaptive_conv_bf16_plain,
                                                   adaptive_conv_planes, adaptive_conv_tapmajor,
                                                   adaptive_conv_tapmajor_plain,
                                                   adaptive_conv_v3, adaptive_conv_v4)

    f32, bf = torch.float32, torch.bfloat16
    checks = {"K4e": [], "K4f": []}
    for d, hw in ((11, 56), (11, 28), (7, 224)):
        for dt_in, dt_f in ((f32, f32), (bf, bf), (bf, f32), (f32, bf)):
            inp = torch.from_numpy(rng.randn(B, C, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dt_in), filt.to(dev, dt_f)
            nbytes = ((inp.numel() + B * C * hw * hw) * inp.element_size()
                      + filt.numel() * filt.element_size())
            ops = 2 * B * C * hw * hw * d * d
            bound = _bound(nbytes, bf16_ops=ops)
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
                label = f"{key} {fn.__name__} d={d} H=W={hw} {tag}"
                wrapper = lambda: fn(inp, filt, d)  # noqa: E731
                c = _check(label, K4B_TOL if dt_in == f32 else K4A_TOL, wrapper, plain,
                           lambda: adaptive_conv_bf16_plain(inp, _last_tap_dropped(filt), d),
                           bound, faults=faults)
                _out, entry, args = _rounded_operands(inp, filt, d, key == "K4f")  # outlives them
                _bare_beside_wrapper(label, c, entry, args, wrapper)
                c["tiling"] = list(args[-2:])
                c["bound_ms_fp32_cores"] = _bound(nbytes, fp32_ops=ops)[0]
                print(f"[kernels] {label}: bound {bound[0]:.4f} ms by {bound[1]} (bf16 tensor "
                      f"cores); {c['bound_ms_fp32_cores']:.4f} ms reckoned with every product "
                      f"once at the fp32 cores' rate; tiling R x channels/warp {args[-2]} x "
                      f"{args[-1]}")
                checks[key].append((f"B={B} C={C} d={d} H=W={hw} {tag}", {**c, **yard_ms}))
    src = "rs_ov_torch/csrc/adaptive_conv.cu"
    return {"adaptive_conv_v3": _row("adaptive_conv_v3", src,
                                     "rs_ov/kernels/adaptive_conv_v3.py:96", checks["K4e"]),
            "adaptive_conv_v4": _row("adaptive_conv_v4", src,
                                     "rs_ov/kernels/adaptive_conv_v4.py:80", checks["K4f"])}


def _adaptive_conv_kernels(rng, dev):
    """K4b (fp32) and K4a (bf16) against the plain loop, on normal-distributed
    taps, at the channel-first route's shapes: jbu_one's two stages (d=11 at
    56^2 and 28^2) and jbu_stack's d=7 at 56^2, and ViT-L/14's and ViT-H/14's
    two stages (C=768 and 1024 at 32^2 and 64^2), the bare library call timed
    beside the wrapper's. The rows lead with d=11, 56^2. K4b's bound counts
    every product as 3 TF32 products (3xTF32 on the tensor cores), with the
    fp32 cores' reckoning beside it."""
    from rs_ov_torch.kernels import adaptive_conv as ac

    rows = {}
    for dtype, key, tol, name, tpu_line in (
            (torch.float32, "K4b", K4B_TOL, "adaptive_conv_f32",
             "rs_ov/kernels/adaptive_conv_v2.py:99"),
            (torch.bfloat16, "K4a", K4A_TOL, "adaptive_conv_bf16",
             "rs_ov/kernels/adaptive_conv_v5.py:68")):
        esz = torch.finfo(dtype).bits // 8
        checks = []
        for d, hw, c in ((11, 56, C), (11, 28, C), (7, 56, C),
                         *((11, hw, c) for c, first, last in TOWER_STAGES if c > C
                           for hw in (first, last))):
            inp = torch.from_numpy(rng.randn(B, c, hw + d - 1, hw + d - 1).astype(np.float32))
            filt = torch.from_numpy(rng.randn(B, d * d, hw, hw).astype(np.float32))
            inp, filt = inp.to(dev, dtype), filt.to(dev, dtype)
            ops = 2 * B * c * hw * hw * d * d
            nbytes = esz * (inp.numel() + filt.numel() + B * c * hw * hw)
            bound = (_bound(nbytes, tf32_ops=3 * ops) if dtype == torch.float32
                     else _bound(nbytes, bf16_ops=ops))
            wrapper = lambda: ac.adaptive_conv_tapmajor(inp, filt, d)  # noqa: E731
            label = f"{key} {name} d={d} H=W={hw}" + ("" if c == C else f" C={c}")
            r = _check(label, tol, wrapper,
                       lambda: ac.adaptive_conv_tapmajor_plain(inp, filt, d),
                       lambda: ac.adaptive_conv_tapmajor_plain(inp, _last_tap_dropped(filt), d),
                       bound)
            _out, entry, args = ac._adaptive_conv_operands(inp, filt, d)  # _out outlives them
            _bare_beside_wrapper(label, r, entry, args, wrapper)
            r["tiling"] = list(args[-2:])
            if dtype == torch.float32:
                r["bound_ms_fp32_cores"] = _bound(nbytes, fp32_ops=ops)[0]
                print(f"[kernels] {label}: bound {bound[0]:.4f} ms by {bound[1]} (3xTF32 on the "
                      f"tensor cores); {r['bound_ms_fp32_cores']:.4f} ms reckoned with every "
                      f"product once at the fp32 cores' rate; tiling R x channels/warp "
                      f"{args[-2]} x {args[-1]}")
            else:
                print(f"[kernels] {label}: tiling R x channels/warp {args[-2]} x {args[-1]}")
            checks.append((f"B={B} C={c} d={d} H=W={hw}", r))
        rows[name] = _row(name, "rs_ov_torch/csrc/adaptive_conv.cu", tpu_line, checks)
    return rows


K6_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
K6_SCORES = {"vanilla": 1, "ClearCLIP": 1, "SCLIP": 2, "SegEarth": 3, "SFP": 2,
             "Experimental": 2}
K6_TERMS = {"SCLIP": 2, "SegEarth": 3}  # softmaxes whose weights meet v apart (others: 1)
K6_SOURCE = {torch.bfloat16: "rs_ov_torch/csrc/selfself_attention_sm90.cu",
             torch.float32: "rs_ov_torch/csrc/selfself_attention_f32_sm90.cu"}


def _selfself_attention_kernel(rng, dev):
    """K6 at the main path's shapes (16 crops of a 512x512 image, 12 heads,
    L=197, hd=64) in each mode, with and without the sim map, in bf16
    (within 1e-2 of max|ref|: a bf16 step of the output) and fp32 (1e-5);
    then at the other towers' shapes with the sim map, in each mode and
    both dtypes: ViT-B/32 (12 heads, L=50, hd=64), ViT-L/14 (16 heads,
    L=257, hd=64) and ViT-H/14 (16 heads, L=257, hd=80; fp32 stages the
    score operands in turn in one slot). The row leads with the base
    config's case: Experimental, bf16, sim map; the fp32 cases name their
    own source. The fault is the plain version with its last key masked out
    of every softmax, through a -inf in the sim map's last column. Each case
    times the bare library call beside the wrapper. For vanilla and
    ClearCLIP one scaled_dot_product_attention call (in the inputs' dtype;
    its bf16 version rounds the weights, so it is a yardstick of time, not
    of numbers) is timed as the library call; no single call computes the
    other modes. Each bound counts what the kernel multiplies on the tensor
    cores: in bf16 the score products and, per softmax term, weights @ v as
    the pair hi + lo; in fp32 the score products and weights @ v per term,
    each as three TF32 products (3xTF32). Beside each, the earlier
    reckoning: bf16 with weights @ v once at the fp32 rate, fp32 with every
    product once at the fp32 cores' rate."""
    from rs_ov_torch.kernels.selfself_attention import SUPPORTED_MODES

    checks = []
    cases = [(m, dt, s) for dt in (torch.bfloat16, torch.float32) for m in SUPPORTED_MODES
             for s in (True, False)]
    cases.remove(("Experimental", torch.bfloat16, True))
    for b, h, l, hd, shape_cases in (
            (16, 12, 197, 64, [("Experimental", torch.bfloat16, True)] + cases),
            *((16, h, l, hd, [(m, dt, True) for dt in (torch.bfloat16, torch.float32)
                              for m in SUPPORTED_MODES])
              for h, l, hd in ((12, 50, 64), (16, 257, 64), (16, 257, 80)))):
        q32, k32, v32 = (torch.from_numpy(rng.randn(b, h, l, hd).astype(np.float32)).to(dev)
                         for _ in range(3))
        sim = torch.from_numpy(np.pad((rng.randn(b, l - 1, l - 1) * 0.5).astype(np.float32),
                                      ((0, 0), (1, 0), (1, 0)))).to(dev)
        for mode, dtype, with_sim in shape_cases:
            c = _k6_case(q32.to(dtype), k32.to(dtype), v32.to(dtype), sim if with_sim else None,
                         mode)
            tag = f"{mode} {str(dtype)[6:]} {'sim' if with_sim else 'no sim'}"
            checks.append((f"B={b} H={h} L={l} hd={hd} {tag}", c))
    return _row("fused_selfself_attention", K6_SOURCE[torch.bfloat16],
                "rs_ov/kernels/selfself_attention.py:78", checks)


def _k6_case(q, k, v, sm, mode):
    """One K6 check (``_selfself_attention_kernel``); sm is the sim map or None."""
    from rs_ov_torch.kernels.selfself_attention import (_attention_operands,
                                                        fused_selfself_attention,
                                                        fused_selfself_attention_plain)

    b, h, l, hd = q.shape
    dtype = q.dtype
    masked = (sm if sm is not None else torch.zeros((b, l, l), device=q.device)).clone()
    masked[..., -1] = float("-inf")
    prod = 2 * b * h * l * l * hd
    nbytes = 4 * b * h * l * hd * q.element_size() + (4 * b * l * l if sm is not None else 0)
    n = K6_SCORES[mode]
    if dtype == torch.bfloat16:
        bound = _bound(nbytes, bf16_ops=(n + 2 * K6_TERMS.get(mode, 1)) * prod)
        earlier = _bound(nbytes, fp32_ops=prod, bf16_ops=n * prod)
    else:
        bound = _bound(nbytes, tf32_ops=3 * (n + K6_TERMS.get(mode, 1)) * prod)
        earlier = _bound(nbytes, fp32_ops=(n + 1) * prod)
    tag = f"{mode} {str(dtype)[6:]} {'sim' if sm is not None else 'no sim'}"
    if (l, hd) != (197, 64):
        tag += f" L={l} hd={hd} H={h}"
    wrapper = lambda: fused_selfself_attention(q, k, v, sm, mode=mode)  # noqa: E731
    c = _check(f"K6 fused_selfself_attention {tag}", K6_TOL[dtype], wrapper,
               lambda: fused_selfself_attention_plain(q, k, v, sm, mode=mode),
               lambda: fused_selfself_attention_plain(q, k, v, masked, mode=mode),
               bound, dropped="key")
    _out, entry, args = _attention_operands(q, k, v, sm, mode, 1.0)  # _out outlives them
    _bare_beside_wrapper(f"K6 {tag}", c, entry, args, wrapper)
    if dtype == torch.bfloat16:
        c["bound_ms_weights_v_fp32"] = earlier[0]
        print(f"[kernels] K6 {tag}: bound {bound[0]:.4f} ms by {bound[1]} (weights @ v on "
              f"the tensor cores); {earlier[0]:.4f} ms by {earlier[1]} reckoned with "
              f"weights @ v at the fp32 rate")
    else:
        c["source"] = K6_SOURCE[dtype]
        c["bound_ms_fp32_cores"] = earlier[0]
        print(f"[kernels] K6 {tag}: bound {bound[0]:.4f} ms by {bound[1]} (3xTF32 on the "
              f"tensor cores); {earlier[0]:.4f} ms by {earlier[1]} reckoned with every "
              f"product once at the fp32 cores' rate")
    if mode in ("vanilla", "ClearCLIP"):
        keys = k if mode == "vanilla" else q
        mask = None if sm is None else sm[:, None].to(dtype)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, keys, v, attn_mask=mask, scale=hd ** -0.5)
        sdpa()
        c["library_ms"] = _median_ms(sdpa)
        c["library"] = f"scaled_dot_product_attention ({str(dtype)[6:]})"
        print(f"[kernels] {tag}: scaled_dot_product_attention {c['library_ms']:.4f} ms")
    return c


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


# Phase 4's other towers, each the base config on its clip_type and vit_type
# (random weights from the seed): one of each arch _resolve_arch returns
# besides the base config's ViT-B/16, as (clip_type, vit_type, arch).
TOWERS = (("RemoteCLIP", "ViT-B/32", "ViT-B-32"), ("OpenCLIP", "ViT-B/16", "ViT-B-16"),
          ("MetaCLIP", "ViT-B/16", "ViT-B-16-quickgelu"),
          ("RemoteCLIP", "ViT-L/14", "ViT-L-14"),
          ("MetaCLIP", "ViT-L/14", "ViT-L-14-quickgelu"),
          ("GeoRSCLIP", "ViT-H/14", "ViT-H-14"))
WIDE = ("ViT-L-14", "ViT-H-14")  # also fp32 channel-first, and each with fused attention
BLIP_VOCAB = "tests/fixtures/blip_decode_vocab.txt"
# Classes whose names the committed 61-entry WordPiece vocabulary spells
# (Potsdam's "parking lot", "low vegetation", "car", "clutter" and
# "background" are all [UNK] strings there, so their queries are equal and
# their pixels exact ties): phase 5's BLIP pair.
BLIP_CLASSES = "road\nbuilding\ntree\nwater\ngreen\n"


def _tower_cfg(clip_type, vit_type):
    return {**_base_model_cfg(), "clip_type": clip_type, "vit_type": vit_type}


def _gem_cfg():
    """GEM on the base config's CLIP ViT-B/16 (gem_depth 7) as GEM's own API
    runs it (rs_ov/gem_api.py: the gem stream keeps its residual,
    ignore_residual=False), without the global CLS debias: GEM gives no CLS
    token. With the base config's ignore_residual the random-weights gem
    stream is near-constant over a crop (a 336² image then has 9 distinct
    regions), and phase 5's gate did not see a zeroed head on the H100."""
    return {**_base_model_cfg(), "model_type": "GEM", "global_debias_factor": 0.0,
            "ignore_residual": False}


def _blip_cfg(**kw):
    """BLIP base (crops at its 224) on the base config, its text queries
    through the committed WordPiece vocabulary, without the global CLS
    debias: BLIP's path gives no CLS token."""
    return {**_base_model_cfg(), "clip_type": "BLIP", "global_debias_factor": 0.0,
            "blip_vocab_path": BLIP_VOCAB, **kw}


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
    read after; checks the outputs and the counts; prints the crops/s and
    512² tiles/s of the requests after the first; returns the counts."""
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
          f"{16 / steady:.2f} crops/s (224²), {1 / steady:.2f} 512² tiles/s (16 crops per "
          f"512x512 image) on {CARD['smi']}")
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
    print(f"[slice] {route}: {secs:.4f} s for the batch; {n / secs:.2f} crops/s (224²), "
          f"{n / 16 / secs:.2f} 512² tiles/s ({n} crops) on {CARD['smi']}")
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


# The classify kernel's repair rule (rs_ov_torch/csrc/jbu_classify_sm90.cu):
# a rounded sum within NEAR fp32 ulps of a bf16 midpoint is queued and taken
# again in order; a block of ROWS x COLS pixels holds QCAP of them, past which
# it takes every sum of the phase again.
NEAR, QCAP, K3_ROWS, K3_COLS = 128, 512, 2, 16


def _near_midpoint(v):
    low = (v.float().contiguous().view(torch.int32) & 0xffff) - 0x8000 + NEAR
    return (low >= 0) & (low < 2 * NEAR)


def _per_block(near):
    """[B, H, W, C] bool -> near sums per kernel block [B, H/2, W/16]."""
    b, h, w, _ = near.shape
    n = torch.nn.functional.pad(near.sum(-1), (0, -w % K3_COLS, 0, -h % K3_ROWS))
    return n.reshape(b, n.shape[1] // K3_ROWS, K3_ROWS, -1, K3_COLS).sum((2, 4))


def _classify_repairs(seg, image, rows):
    """K3 on the operands of one default-route request's last stage (random
    weights at full width): the sums of y and of t = (yb Wf^T + bf) * 0.1
    that land near a bf16 midpoint (read on the plain version's sums), the
    blocks whose queue overflows, and the bare kernel's time on these
    operands beside its time on phase 3's random ones. Its launches are
    outside every driven path's count."""
    from rs_ov_torch.kernels import jbu_epilogue as mod
    from rs_ov_torch.kernels.build import load_library
    from rs_ov_torch.upsample import jbu

    with _recording(jbu, "jbu_epilogue_classify") as calls:
        seg.predict_raw(image)
    args = calls[0][0]
    inp, d, fw, fb = args[0], args[-1], args[9], args[10]
    y = mod._adaptive_conv_nhwc(inp, mod._comb_fixed(*args[1:9], inp.dtype), d)
    yb = y.to(inp.dtype)
    t = (torch.matmul(yb.float(), fw.to(inp.dtype).float().t()) + fb.float()) * 0.1
    _out, largs, _keep = mod._classify_operands(*args)  # _out outlives the calls
    lib, stream = load_library(), torch.cuda.current_stream().cuda_stream
    ms = _median_ms(lambda: lib.rs_jbu_epilogue_classify(*largs, stream))
    out = {"shape": list(inp.shape[:1]) + list(y.shape[1:]) + [d], "kernel_ms": ms}
    for name, v in (("y", y), ("t", t)):
        near = _near_midpoint(v)
        blocks = _per_block(near)
        out[name] = dict(near=int(near.sum()), of=near.numel(),
                         blocks_past_queue=int((blocks > QCAP).sum()), blocks=blocks.numel(),
                         most_in_a_block=int(blocks.max()))
    print(f"[slice] K3 on one request's last-stage operands (B, H, W, C, d = "
          f"{out['shape']}): near a bf16 midpoint y {out['y']['near']} of {out['y']['of']}, "
          f"t {out['t']['near']}; blocks past the queue's {QCAP}: y "
          f"{out['y']['blocks_past_queue']}, t {out['t']['blocks_past_queue']} of "
          f"{out['y']['blocks']} (most in a block {out['y']['most_in_a_block']} / "
          f"{out['t']['most_in_a_block']}); bare kernel {ms:.4f} ms on them, "
          f"{rows['jbu_epilogue_classify']['kernel_ms']:.4f} ms on phase 3's operands "
          f"({rows['jbu_epilogue_classify']['shape']}) on {CARD['smi']}")
    rows["jbu_epilogue_classify"]["request_operands"] = out


def _segmentors():
    """The segmentors phases 4 and 5 drive on the card, by name, with the
    base config's weights and queries."""
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
    return {"base": seg,
            "base fp32": SegmentorEx(**_base_model_cfg(), param_dtype=torch.float32,
                                     device=DEV, query_features=qf),
            "jbu_stack": SegmentorEx(**{**_base_model_cfg(), "sim_feat_up_cfg": dict(
                model_name="jbu_stack", num_stages=4)}, device=DEV, query_features=qf),
            "stack": SegmentorEx(**_stack_cfg(), device=DEV, query_features=qf),
            "clearclip": SegmentorEx(**_clearclip_cfg(), device=DEV, query_features=qf)}


def _build(label, **kw):
    """A SegmentorEx, its build time printed with its widths."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    t0 = time.perf_counter()
    seg = SegmentorEx(**kw)
    torch.cuda.synchronize()
    v = seg.cfg.vision
    print(f"[slice] {label}: SegmentorEx built in {time.perf_counter() - t0:.2f} s: "
          f"{v.width} wide, {v.layers} layers, {v.heads} heads, patch {v.patch_size}, "
          f"embed {seg.cfg.embed_dim}, dtype={seg.param_dtype}")
    return seg


def _drive_towers(images, s, by_path):
    """The other towers at full width on random weights, each route with a
    warm-up and two timed requests: one tower of each arch of TOWERS on the
    bf16 channel-last route, ViT-L-14 and ViT-H-14 also with
    RS_OV_FUSED_ATTN=1 and in fp32 channel-first with and without it; GEM
    on CLIP ViT-B/16 in bf16 channel-last and fp32 channel-first; BLIP base
    in bf16 channel-last. Each model is freed before the next but those
    phase 5 compares: returned by name."""
    from rs_ov_torch.core.config import get_model_config

    n = len(images)
    cl = {"range_logits": n * s * CHUNKS, "jbu_epilogue": n * (s - 1) * CHUNKS,
          "jbu_epilogue_classify": n * CHUNKS}
    cf = {"range_logits": n * s * CHUNKS, "adaptive_conv_f32": n * s * CHUNKS}
    k6 = {"fused_selfself_attention": n}
    kept = {}
    for clip_type, vit_type, arch in TOWERS:
        name = f"{clip_type} {arch}"
        seg = _build(name, **_tower_cfg(clip_type, vit_type), device=DEV)
        assert seg.cfg == get_model_config(arch), (name, seg.cfg)
        by_path[name] = _drive(f"{name} bf16 channel-last (K1 K2 K3)", seg, images, cl)
        if arch in WIDE:
            with _env("RS_OV_FUSED_ATTN", "1"):
                by_path[f"{name} fused attention"] = _drive(
                    f"{name} bf16 channel-last, RS_OV_FUSED_ATTN=1 (K6 K1 K2 K3)", seg, images,
                    {**cl, **k6})
            seg32 = _build(f"{name} fp32", **_tower_cfg(clip_type, vit_type),
                           param_dtype=torch.float32, device=DEV,
                           query_features=seg.query_features.cpu().numpy())
            by_path[f"{name} fp32 channel-first"] = _drive(
                f"{name} fp32 channel-first (K1 K4b)", seg32, images, cf)
            with _env("RS_OV_FUSED_ATTN", "1"):
                by_path[f"{name} fp32 fused attention"] = _drive(
                    f"{name} fp32 channel-first, RS_OV_FUSED_ATTN=1 (fp32 K6, K1, K4b)", seg32,
                    images, {**cf, **k6})
            del seg32
        if arch == "ViT-L-14":
            kept["ViT-L-14"] = seg
        del seg
        torch.cuda.empty_cache()
    gem = kept["GEM"] = _build("GEM on CLIP ViT-B/16", **_gem_cfg(), device=DEV)
    by_path["GEM"] = _drive("GEM (CLIP ViT-B/16, gem_depth 7) bf16 channel-last (K1 K2 K3)",
                            gem, images, cl)
    gem32 = _build("GEM fp32", **_gem_cfg(), param_dtype=torch.float32, device=DEV,
                   query_features=gem.query_features.cpu().numpy())
    by_path["GEM fp32 channel-first"] = _drive("GEM fp32 channel-first (K1 K4b)", gem32, images,
                                               cf)
    del gem32
    kept["BLIP"] = _build("BLIP base", **_blip_cfg(), device=DEV)
    by_path["BLIP"] = _drive("BLIP base bf16 channel-last (K1 K2 K3)", kept["BLIP"], images, cl)
    torch.cuda.empty_cache()
    return kept


def phase_slice(rows):
    """Each route through SegmentorEx.predict_raw, counters read per route.
    Returns the segmentors on the card, by name, for the e2e phase."""
    segs = _segmentors()
    seg = segs["base"]
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
        by_path["fp32 fused attention"] = _drive(
            "fp32 channel-first, RS_OV_FUSED_ATTN=1 (fp32 K6, K1, K4b)", segs["base fp32"],
            images, {"fused_selfself_attention": 3, "range_logits": 3 * s * CHUNKS,
                     "adaptive_conv_f32": 3 * s * CHUNKS})
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
    _classify_repairs(seg, images[0], rows)
    segs.update(_drive_towers(images, s, by_path))
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


# Phase 5's pairs: (run, reference run, bound). A bound of 0.999 holds the
# all-pixel argmax agreement (runs that sum alike up to their order: fp32 on
# the card and on the CPU, the fused attention in fp32, a batch against its
# images). The pairs bounded by 0.95 or 0.99 compare runs that round
# differently (bf16 against fp32, one route against another, path (b)'s chain
# of thresholds); with random weights their classes tie at many pixels, where
# any valid change of a sum may flip the argmax. They are held instead on
# the pixels the reference decides: agreement >= DECIDED_AGREE there, on a
# share of the image >= DECIDED_SHARE.
E2E_PAIRS = (("bf16 channel-first", "bf16 channel-last", 0.95),
             ("fp32 channel-first", "bf16 channel-last", 0.95),
             ("fp32 channel-first", "fp32 CPU", 0.999),
             ("fp32 fused attention", "fp32 channel-first", 0.999),
             ("bf16 channel-last", "fp32 CPU", 0.95),
             ("jbu_stack 4 stages bf16 channel-last", "jbu_stack 4 stages fp32 CPU", 0.95),
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
             *((f"(b) bf16 batch {i}", f"(b) bf16 single {i}", 0.95) for i in range(3)),
             ("GEM bf16", "GEM fp32 CPU", 0.95),
             ("BLIP bf16", "BLIP fp32 CPU", 0.95),
             ("ViT-L-14 bf16", "ViT-L-14 fp32 CPU", 0.95))
# A pixel is decided where the reference's top-1 minus top-2 class
# probability (seg_logits) is >= TAU. TAU is the smallest of TAUS at which
# every pair bounded by 0.95 or 0.99 passed both conditions with the ViT's
# products still upcast to fp32 (rs_ov_torch/tools/margin_calibration.py on
# the H100, PERF.md §2); every pair prints its numbers at each of TAUS too.
TAU = 0.005
TAUS = (0.005, 0.01, 0.02, 0.05, 0.1)
DECIDED_AGREE, DECIDED_SHARE = 0.999, 0.5


def decided_agreement(pred, ref_pred, ref_probs, tau):
    """(all-pixel agreement, decided-pixel agreement, decided share) of the
    labels ``pred`` [1, H, W] against a reference run's labels and class
    probabilities ``ref_probs`` [classes, H, W]: a pixel is decided where
    the reference's top-1 minus top-2 probability is >= tau. With no pixel
    decided the decided agreement is nan."""
    top = ref_probs.float().topk(2, dim=0).values
    decided = (top[0] - top[1]) >= tau
    same = (pred == ref_pred).reshape(decided.shape)
    agree = same[decided].float().mean().item() if bool(decided.any()) else float("nan")
    return same.float().mean().item(), agree, decided.float().mean().item()


def pair_passes(need, agree_all, agree_decided, share):
    """A 0.999 pair on all pixels; the others on the decided pixels (nan,
    no pixel decided, fails)."""
    if need >= 0.999:
        return agree_all >= need
    return share >= DECIDED_SHARE and agree_decided >= DECIDED_AGREE


def _e2e_image(seed=2):
    return np.random.RandomState(seed).randint(0, 256, (1, 336, 336, 3), np.uint8)


def _e2e_outputs(segs):
    """Phase 5's runs of one 336x336 image, by name: every route on the card,
    the switches, batches against their images and the fp32 CPU references.
    Returns (outputs, CTD labels by run, seconds of the CPU runs)."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    qf = segs["base"].query_features.cpu().numpy()
    img = _e2e_image()
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
        out["fp32 fused attention"] = segs["base fp32"].predict_raw(img)[0]
        out["(a) bf16"] = segs["base"].predict_raw(img)[0]
        with _dbscan_labels() as labels["(b) bf16"]:
            out["(b) bf16"] = segs["stack"].predict_raw(img)[0]
        with _dbscan_labels() as labels["(b) fp32"]:
            out["(b) fp32"] = stack32.predict_raw(img)[0]
        out["(c) bf16"] = segs["clearclip"].predict_raw(img)[0]
    with _env("RS_OV_JBU_FUSED_RANGE", "1"):
        out["(d) fused range"] = segs["base"].predict_raw(img)[0]
        out["jbu_stack fused range"] = segs["jbu_stack"].predict_raw(img)[0]
    batch = np.concatenate([img, img, _e2e_image(3)])
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
    out.update(_e2e_towers(segs, img))
    return out, labels, cpu_s


def _e2e_towers(segs, img):
    """GEM, BLIP base and ViT-L-14 (RemoteCLIP) in bf16 on the card and in
    fp32 on the CPU, from the same seed and queries. BLIP on BLIP_CLASSES,
    and on Potsdam's (printed, not gated: its classes tie)."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    def pair(name, seg, cfg):
        out[f"{name} bf16"] = seg.predict_raw(img)[0]
        cpu = SegmentorEx(**cfg, device="cpu", query_features=seg.query_features.cpu().numpy())
        out[f"{name} fp32 CPU"] = cpu.predict_raw(img)[0]

    t0 = time.perf_counter()
    out = {}
    pair("GEM", segs["GEM"], _gem_cfg())
    pair("BLIP Potsdam", segs["BLIP"], _blip_cfg())
    pair("ViT-L-14", segs["ViT-L-14"], _tower_cfg("RemoteCLIP", "ViT-L/14"))
    with tempfile.TemporaryDirectory() as tmp:
        classes = os.path.join(tmp, "cls_blip.txt")
        with open(classes, "w") as f:
            f.write(BLIP_CLASSES)
        cfg = _blip_cfg(name_path=classes)
        pair("BLIP", SegmentorEx(**cfg, device=DEV), cfg)
    print(f"[e2e] GEM, BLIP and ViT-L-14 on the card and the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _pair_numbers(run, ref, tau):
    return decided_agreement(run["pred_sem_seg"].cpu(), ref["pred_sem_seg"].cpu(),
                             ref["seg_logits"].cpu(), tau)


def _at_taus(run, ref):
    return "; ".join("{}: {:.6f} on {:.4f}".format(t, *_pair_numbers(run, ref, t)[1:])
                     for t in TAUS)


class _HeadZeroed:
    """An attention's parameters with one head's columns of the
    out-projection zeroed: that head's context reaches nothing."""

    def __init__(self, p, head, heads):
        hd = p.out_proj_w.shape[1] // heads
        self._p, self.out_proj_w = p, p.out_proj_w.detach().clone()
        self.out_proj_w[:, head * hd:(head + 1) * hd] = 0

    def __getattr__(self, name):
        return getattr(self._p, name)


@contextlib.contextmanager
def _one_head_zeroed(head=0):
    """The ViT's custom attention (in the base config the last block's
    alone) with one of its heads zeroed."""
    from rs_ov_torch.nn import vit

    fn = vit.custom_attn

    def faulty(p, x, *, heads, **kw):
        return fn(_HeadZeroed(p, head, heads), x, heads=heads, **kw)

    vit.custom_attn = faulty
    try:
        yield
    finally:
        vit.custom_attn = fn


@contextlib.contextmanager
def _gem_head_zeroed(head=0):
    """GEM's self-self attention with one head of its gem stream zeroed (the
    ori stream, which feeds the next block, untouched)."""
    from rs_ov_torch.nn import gem

    fn = gem.self_self_attention

    def faulty(p, x, heads, **kw):
        return fn(_HeadZeroed(p, head, heads), x, heads, **kw)[0], fn(p, x, heads, **kw)[1]

    gem.self_self_attention = faulty
    try:
        yield
    finally:
        gem.self_self_attention = fn


def phase_e2e(segs):
    out, labels, cpu_s = _e2e_outputs(segs)
    for a, b, need in E2E_PAIRS:
        agree, decided, share = _pair_numbers(out[a], out[b], TAU)
        dprob = (out[a]["seg_logits"].cpu() - out[b]["seg_logits"].cpu()).abs().max().item()
        same = ""
        if a in labels and b in labels:
            la, lb = torch.cat(labels[a]), torch.cat(labels[b])
            same = f", CTD labels equal {(la == lb).float().mean().item():.4f}"
        gate = (f"need >= {need}" if need >= 0.999 else
                f"need decided >= {DECIDED_AGREE} on >= {DECIDED_SHARE}; all pixels once "
                f"held to {need}")
        print(f"[e2e] 336x336 (4 crops): {a} vs {b}: argmax agreement {agree:.6f}, on the "
              f"pixels {b} decides (margin >= {TAU}) {decided:.6f}, decided share "
              f"{share:.4f} ({gate}); max |d prob| {dprob:.4f}{same}; decided agreement on "
              f"share at margin {_at_taus(out[a], out[b])}")
        assert pair_passes(need, agree, decided, share), f"{a} vs {b}: {agree} {decided} {share}"
    # the gate must see a fault: one head of the last block zeroed, bf16
    with _one_head_zeroed():
        bad = segs["base"].predict_raw(_e2e_image())[0]
    agree, decided, share = _pair_numbers(bad, out["fp32 CPU"], TAU)
    print(f"[e2e] planted fault, one of 12 heads of the last block's attention zeroed, "
          f"bf16 default route vs fp32 CPU: argmax agreement {agree:.6f}, decided "
          f"{decided:.6f} on {share:.4f} of the pixels (must fail: decided < "
          f"{DECIDED_AGREE}); at margin {_at_taus(bad, out['fp32 CPU'])}")
    assert not pair_passes(0.95, agree, decided, share), "the gate does not see the fault"
    a, b = "BLIP Potsdam bf16", "BLIP Potsdam fp32 CPU"
    agree, decided, share = _pair_numbers(out[a], out[b], TAU)
    print(f"[e2e] {a} vs {b} (not gated: Potsdam's names are [UNK] strings in the committed "
          f"vocabulary, so their queries tie): argmax agreement {agree:.6f}, decided {decided:.6f} "
          f"on {share:.4f}; at margin {_at_taus(out[a], out[b])}")
    # and for GEM: one head of the last block's gem stream zeroed, bf16
    with _gem_head_zeroed():
        bad = segs["GEM"].predict_raw(_e2e_image())[0]
    agree, decided, share = _pair_numbers(bad, out["GEM fp32 CPU"], TAU)
    print(f"[e2e] planted fault, one of 12 heads of the gem stream zeroed, GEM bf16 vs GEM "
          f"fp32 CPU: argmax agreement {agree:.6f}, decided {decided:.6f} on {share:.4f} of "
          f"the pixels (must fail: decided < {DECIDED_AGREE}); at margin "
          f"{_at_taus(bad, out['GEM fp32 CPU'])}")
    assert not pair_passes(0.95, agree, decided, share), "the gate does not see the GEM fault"
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


# Phase 7, the open_clip entry (rs_ov_torch.factory, gem_api, hub) and the
# alternate upsamplers. Embeddings on the card in fp32 are held to
# max|card - CPU| / max|CPU| <= ENTRY_TOL against the CPU's fp32 run (the
# ViT's fp32 products on both, TF32 off; the sums' order alone differs);
# ViT-B-16's bf16 to a cosine >= ENTRY_COS per embedding against the card's
# fp32 (the other towers' printed). K6 on the entry takes its kernel bounds
# (K6_TOL) against the plain route. GEM's min-max heatmaps divide by each
# map's range, so they take tools/parity_check.py's gem_stream 1e-3.
ENTRY_TOL, ENTRY_COS, GEM_TOL = 1e-4, 0.99, 1e-3
ENTRY_BATCH, ENTRY_TIMED_BATCH = 8, 64
ENTRY_PROMPTS = ("road", "building", "tree", "water", "car", "field", "river", "parking lot")
ALTERNATES = ("resize_conv", "ifa", "carafe", "sapa")


def _rel(got, ref) -> float:
    ref = ref.float().cpu()
    return float((got.float().cpu() - ref).abs().max() / ref.abs().max())


def _min_cos(a, b) -> float:
    a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def _encode(model, images, ids, **kw):
    """(pooled, tokens, text, zero-shot logits) of a CLIPModel."""
    pooled, tokens = model.encode_image(images, output_cls_token=True, **kw)
    text = model.encode_text(ids, normalize=True).float()
    img = pooled.float() / pooled.float().norm(dim=-1, keepdim=True)
    return pooled, tokens, text, model.logit_scale.float() * img @ text.t()


def _entry_errs(card, cpu):
    return [_rel(a, b) for a, b in zip(card, cpu)]


def _images_per_s(model, images):
    """encode_image of one batch, median of CUDA-event times after a warm-up."""
    model.encode_image(images)
    torch.cuda.synchronize()
    ms = _median_ms(lambda: model.encode_image(images), reps=5)
    return images.shape[0] / ms * 1e3


def _text_ids(cfg, rng):
    """BPE ids of ENTRY_PROMPTS for a BPE tower; seeded random ids ending in
    the EOT-like highest id for a tower whose tokenizer is an HF asset."""
    from rs_ov_torch.factory import get_tokenizer

    t = cfg.text
    if t.hf_tokenizer_name is None:
        return get_tokenizer("", context_length=t.context_length)(
            [f"a photo of a {c}." for c in ENTRY_PROMPTS])
    ids = rng.randint(1, t.vocab_size - 1, (len(ENTRY_PROMPTS), t.context_length))
    ids[:, -1] = t.vocab_size - 1
    return ids.astype(np.int32)


def _entry_tower(name, images, ids, fault, fault_label, gate_cos):
    """One tower through create_model at full width: card fp32 against the
    CPU's fp32 on ``images``, the planted fault above the bound, card bf16
    against card fp32 (gated where ``gate_cos``); images/s of encode_image at
    batch ENTRY_TIMED_BATCH in fp32 and bf16. Returns the card's fp32 and
    bf16 models."""
    from rs_ov_torch.factory import create_model

    t0 = time.perf_counter()
    m32 = create_model(name, precision="fp32", seed=0)
    m16 = create_model(name, precision="bf16", seed=0)
    cpu = create_model(name, device="cpu", seed=0)
    built = time.perf_counter() - t0
    card = _encode(m32, images, ids)
    t0 = time.perf_counter()
    ref = _encode(cpu, images, ids)
    cpu_s = time.perf_counter() - t0
    errs = _entry_errs(card, ref)
    with fault(m32):
        bad = _entry_errs(_encode(m32, images, ids), ref)
    cos = [_min_cos(a, b) for a, b in zip(_encode(m16, images, ids)[:3], card[:3])]
    v = m32.cfg.vision
    print(f"[entry] {name} ({v.width} wide, {v.layers} layers, {v.heads} heads, pool "
          f"{v.pool_type}, ln_pre {not v.no_ln_pre}, LN after pool {v.final_ln_after_pool}, "
          f"LayerScale {v.ls_init_value}; built x3 in {built:.1f} s, CPU fp32 run "
          f"{cpu_s:.1f} s): {images.shape[0]} images {tuple(images.shape[-2:])}, "
          f"{len(ids)} prompts; card fp32 vs CPU fp32 max|d|/max|ref| pooled {errs[0]:.3e} "
          f"tokens {errs[1]:.3e} text {errs[2]:.3e} logits {errs[3]:.3e} (bound "
          f"{ENTRY_TOL}); planted fault, {fault_label}: pooled {bad[0]:.3e} tokens "
          f"{bad[1]:.3e} (must exceed the bound); bf16 vs fp32 on the card, least cosine "
          f"pooled {cos[0]:.5f} tokens {cos[1]:.5f} text {cos[2]:.5f} "
          f"({f'need >= {ENTRY_COS}' if gate_cos else 'not gated'})")
    assert max(errs) <= ENTRY_TOL, (name, errs)
    assert max(bad[:2]) > ENTRY_TOL, (name, "the bound does not see the fault", bad)
    assert min(cos) >= ENTRY_COS or not gate_cos, (name, cos)
    assert all(bool(torch.isfinite(x).all()) for x in card)
    big = torch.randn(ENTRY_TIMED_BATCH, 3, v.image_size, v.image_size,
                      generator=torch.Generator().manual_seed(5))
    rates = {p: _images_per_s(m, big.to(DEV, m.dtype)) for p, m in (("fp32", m32),
                                                                   ("bf16", m16))}
    print(f"[entry] {name} encode_image at batch {ENTRY_TIMED_BATCH}, "
          f"{v.image_size}²: fp32 {rates['fp32']:.1f} images/s, bf16 "
          f"{rates['bf16']:.1f} images/s on {CARD['smi']}")
    del cpu
    return m32, m16


@contextlib.contextmanager
def _head_zeroed_model(model):
    with _one_head_zeroed():
        yield


@contextlib.contextmanager
def _ln_before_pool(model):
    """CLIPA's tower with the LN taken before the pool, as the plain towers do."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, final_ln_after_pool=False))
    try:
        yield
    finally:
        model.cfg = cfg


@contextlib.contextmanager
def _layerscale_left_out(model):
    gammas = {}
    for i, blk in enumerate(model.clip.visual.blocks):
        for k in ("ls_1", "ls_2"):
            p = getattr(blk, k)
            gammas[(i, k)] = p.detach().clone()
            p.data.fill_(1.0)
    try:
        yield
    finally:
        for (i, k), g in gammas.items():
            getattr(model.clip.visual.blocks[i], k).data.copy_(g)


def _fused_entry(models, images, rows):
    """encode_image(model_type="Experimental") with RS_OV_FUSED_ATTN=1: K6
    once (counters at 0 before, read after), against the plain route."""
    for dtype, model in models:
        plain = model.encode_image(images, model_type="Experimental", output_cls_token=True)
        with _env("RS_OV_FUSED_ATTN", "1"):
            _reset_launches()
            fused = model.encode_image(images, model_type="Experimental",
                                       output_cls_token=True)
            torch.cuda.synchronize()
            label = f"entry: ViT-B-16 encode_image Experimental {dtype}, RS_OV_FUSED_ATTN=1 (K6)"
            launches = _expect_launches(label, images.shape[0], {"fused_selfself_attention": 1})
        rows["fused_selfself_attention"]["launches_by_path"][f"entry {dtype}"] = \
            launches["fused_selfself_attention"]
        errs = [_rel(f, p) for f, p in zip(fused, plain)]
        tol = K6_TOL[model.dtype]
        print(f"[entry] {label}: against the plain route max|d|/max|ref| pooled "
              f"{errs[0]:.3e} tokens {errs[1]:.3e} (bound {tol})")
        assert max(errs) <= tol, (dtype, errs)


def _gem_entry():
    """create_gem_model("ViT-B-16") on a 448² image, the card's fp32
    heatmaps against the CPU's."""
    from rs_ov_torch.gem_api import create_gem_model, get_gem_img_transform

    raw = np.random.RandomState(6).randint(0, 256, (500, 460, 3), np.uint8)
    image = get_gem_img_transform((448, 448))(raw)[None]
    card = create_gem_model("ViT-B-16")(image, list(ENTRY_PROMPTS))
    t0 = time.perf_counter()
    cpu = create_gem_model("ViT-B-16", device="cpu")(image, list(ENTRY_PROMPTS))
    err = float((card.cpu() - cpu).abs().max())
    print(f"[entry] create_gem_model('ViT-B-16') heatmaps [1, {len(ENTRY_PROMPTS)}, 448, 448], "
          f"card fp32 vs CPU fp32 (CPU {time.perf_counter() - t0:.1f} s): max |d| {err:.3e} "
          f"on [0, 1] maps (bound {GEM_TOL})")
    assert card.shape == (1, len(ENTRY_PROMPTS), 448, 448) and err <= GEM_TOL, err


def _hub_entry(model, images):
    """save_for_hub, then create_model(name, path) on the card: outputs equal."""
    from rs_ov_torch.factory import create_model
    from rs_ov_torch.hub import HF_SAFE_WEIGHTS_NAME, save_for_hub

    with tempfile.TemporaryDirectory() as tmp:
        save_for_hub(model, "ViT-B-16", tmp)
        back = create_model("ViT-B-16", os.path.join(tmp, HF_SAFE_WEIGHTS_NAME))
    same = [torch.equal(a, b) for a, b in zip(back.encode_image(images, output_cls_token=True),
                                              model.encode_image(images, output_cls_token=True))]
    print(f"[entry] save_for_hub -> create_model('ViT-B-16', path) on the card: pooled and "
          f"tokens equal to the saved model's: {same}")
    assert all(same), same


def _alternates_entry(images):
    """SegmentorEx with each alternate upsampler (base config otherwise, bf16
    on the card): a warm-up and a timed 512² request each beside the
    default route, no kernel launched; then carafe's phase-5 pair."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    base = SegmentorEx(**_base_model_cfg(), device=DEV)
    qf = base.query_features.cpu().numpy()
    rates = {}
    for name in ("jbu_one (default)",) + ALTERNATES:
        seg = base if name.startswith("jbu_one") else SegmentorEx(
            **{**_base_model_cfg(), "sim_feat_up_cfg": {"model_name": name}}, device=DEV,
            query_features=qf)
        seg.predict_raw(images[0])
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        res = seg.predict_raw(images[1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _check_results(name, seg, res)
        if name in ALTERNATES:
            _expect_launches(f"entry: SegmentorEx with {name}", 1, {})
        rates[name] = 16 / secs
        print(f"[entry] SegmentorEx {name}, bf16: {secs:.4f} s for a 512² request, "
              f"{rates[name]:.2f} crops/s (224²) on {CARD['smi']}")
        if name == "carafe":
            carafe = seg
    img = _e2e_image()
    run = carafe.predict_raw(img)[0]
    ref = SegmentorEx(**{**_base_model_cfg(), "sim_feat_up_cfg": {"model_name": "carafe"}},
                      device="cpu", query_features=qf).predict_raw(img)[0]
    agree, decided, share = _pair_numbers(run, ref, TAU)
    print(f"[entry] 336x336: carafe bf16 vs carafe fp32 CPU: argmax agreement {agree:.6f}, "
          f"decided {decided:.6f} on {share:.4f} (need decided >= {DECIDED_AGREE} on >= "
          f"{DECIDED_SHARE}); at margin {_at_taus(run, ref)}")
    assert pair_passes(0.95, agree, decided, share), (agree, decided, share)
    with _one_head_zeroed():
        bad = carafe.predict_raw(img)[0]
    agree, decided, share = _pair_numbers(bad, ref, TAU)
    print(f"[entry] planted fault, one of 12 heads of the last block zeroed, carafe bf16 vs "
          f"fp32 CPU: argmax agreement {agree:.6f}, decided {decided:.6f} on {share:.4f} "
          f"(must fail)")
    assert not pair_passes(0.95, agree, decided, share), "the gate does not see the fault"


def phase_entry(rows):
    """The open_clip entry at full width on random weights from seed 0:
    ViT-B-16 through create_model_and_transforms (8 images of 256x320
    through its preprocess, 8 prompts, zero-shot logits), ViT-L-14-CLIPA and
    ViT-M-16-alt through create_model, K6 on encode_image, GEM, the hub round
    trip and SegmentorEx with each alternate upsampler."""
    from rs_ov_torch.factory import create_model_and_transforms

    rng = np.random.RandomState(7)
    _, preprocess, _ = create_model_and_transforms("ViT-B-16", device="cpu")
    raw = [rng.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(ENTRY_BATCH)]
    images = torch.from_numpy(np.stack([preprocess(r) for r in raw]))
    from rs_ov_torch.core.config import get_model_config

    ids = _text_ids(get_model_config("ViT-B-16"), rng)
    b32, b16 = _entry_tower("ViT-B-16", images, ids, _head_zeroed_model,
                            "one of 12 heads of the last block zeroed", True)
    _fused_entry((("fp32", b32), ("bf16", b16)), images.to(DEV), rows)
    _hub_entry(b32, images.to(DEV))
    del b32, b16
    small = torch.from_numpy(rng.randn(2, 3, 224, 224).astype(np.float32))
    for name, fault, label in (
            ("ViT-L-14-CLIPA", _ln_before_pool, "the LN taken before the pool"),
            ("ViT-M-16-alt", _layerscale_left_out, "LayerScale left out")):
        _entry_tower(name, small, _text_ids(get_model_config(name), rng), fault, label, False)
        torch.cuda.empty_cache()
    _gem_entry()
    seg_images = [rng.randint(0, 256, (1, 512, 512, 3), np.uint8) for _ in range(2)]
    _alternates_entry(seg_images)


def main():
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_e2e(phase_slice(rows))
    phase_eval(rows)
    phase_entry(rows)
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
