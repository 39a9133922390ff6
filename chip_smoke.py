#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure raises, prints its traceback and exits non-zero):

  1. device   - a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    - compiles rs_ov_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
                per source, all at once.
  3. kernels  - each CUDA kernel (K1-K3, K4a-K4f, K5a, K5b, K6, K7, K8) against its
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
                L=257 hd=80 (16 heads). K7 (LayerNorm) at the tower's
                shapes in bf16: 25216 x 768 and 32896 x 1024 (a call of 8
                tiles), 3152 x 768 and 4112 x 1024 (one tile), at most one
                bf16 step from the plain version, beside it with the last
                column's scale left out, F.layer_norm timed beside. K8 (a
                linear's epilogue) on the product of ViT-B/16's in_proj
                (25216 x 2304) and c_fc with QuickGELU (25216 x 3072),
                ViT-L/14's c_fc with GELU (32896 x 4096) and one tile's
                out_proj (3152 x 768), equal to the plain chain bit for
                bit, beside it with the last column's bias left out; timed
                alone and in streams, torch.addmm timed beside the port's
                whole linear.
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
                exactly the expected amount (K7 LN_PER_PASS[arch] and K8
                LINEAR_PER_PASS[arch] a request or batch call, one fewer K8
                in fp32); prints crops/s (224²) and 512²
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
                that agree. Planted faults (each of the last block's 12
                attention heads zeroed in turn, bf16 default route): each
                of FAULT_HEADS (all but heads 0 and 8, which move under 1%
                of the decided pixels) must fail the decided-pixel gate
                against the fp32 CPU run. GEM, BLIP
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
                crops/s beside the default route, no kernel but K7 and
                K8 launched (once a LayerNorm, once a linear); and
                carafe's 336² bf16 run against its fp32 CPU run on phase
                5's decided-pixel gate, one zeroed head failing it.
  8. timm     - the timm towers (rs_ov_torch.nn.timm_tower) through
                create_model at full width on random weights from seed 0,
                every LayerNorm scale, ConvNeXt gamma, bias and CLS token
                drawn anew from one seeded RandomState in each model:
                convnext_large_d (256², 'mlp' head), ViT-B-16-SigLIP (224²,
                MAP head, logit_bias) and EVA02-B-16 (224², RoPE, SwiGLU,
                inner norms, split qkv, the trunk's head). For each: two
                images and 8 prompts (seeded ids where the tokenizer is an
                HF asset) on the card in fp32 against the CPU's fp32
                (max|d|/max|ref| <= ENTRY_TOL on the image and text
                embeddings and the logits) with no kernel but K7 and K8
                launched, a
                planted fault above the bound (ConvNeXt's gammas left out,
                the MAP head's MLP residual left out, RoPE left out), bf16
                against the card's fp32 (cosine >= ENTRY_COS), and
                encode_image images/s at batch 64 in fp32 and bf16.
  9. generate - generation at full width on random weights, every leaf
                drawn anew: BLIP base captioning at 384² (beam 3 and nucleus
                top-p 0.9, max_length 30, min_length 10, a synthetic
                30522-entry vocabulary), VQA at 480² (rank over 128
                candidates, beam-3 generate), ITM (itm, itc) and NLVR at
                384², evaluate_captions and blip_retrieval_evaluation,
                create_model("coca_ViT-L-14") at 224² in fp32 and bf16
                (encoders, forward, beam-6 and top-p generate, seq_len 30),
                coca_roberta-ViT-B-32's encoders, and the committed decode
                golden. Gates, each beside a planted fault that must fail
                it: card fp32 against CPU fp32 (GEN_TOL); the KV-cached
                step against the full prefix under a parent permutation
                (GEN_TOL; faults: the parent gather skipped, the cross K/V
                zeroed, CoCa's CLS put first); tokens against the CPU and
                the full prefix on every step the reference decides by at
                least GEN_TAU (the decided share printed); bf16 logits
                against fp32 (GEN_COS); the golden on the card. Prints
                captions/s with each decode step's CUDA-event span and host
                ms, VQA questions/s and ITM pairs/s. No kernel but K7 and
                K8 is launched, once for each LayerNorm and each linear on
                the card.
 10. train    - training (rs_ov_torch.train) at full width on drawn weights:
                CLIP ViT-B/16 (224², context 77), BLIP base (224², queue
                57600), coca_ViT-B-32. Gates, each number printed beside its
                limit: (a) one step at batch 8, remat on, card fp32 against
                CPU fp32 (loss, per-leaf-group gradient max|d|/max|ref| <=
                TRAIN_TOL); (b) remat on against off (REMAT_TOL); (c)
                accum_steps 4 against 1 on one batch of 32 (ACCUM_TOL); (d)
                bf16 against fp32 (per-group gradient cosine >= TRAIN_COS,
                loss within TRAIN_LOSS_REL); (e) one bf16 step each of SigLIP,
                CoCa, BLIP retrieval and pretrain (ptr advanced by B, the EMA
                equal to its formula, the queue's new columns equal to the
                momentum features), caption, VQA and NLVR, and BLIP retrieval
                at batch 2 card fp32 against CPU fp32; (f) a single-rank NCCL
                group (file:// store): the data-parallel step against the
                plain one. Planted faults, each failing its gate: the scale
                path live at every micro-step (c), matmul32's backward with
                the right operand's gradient zeroed (d), the EMA after the
                momentum forward (e). Rates (no gate): pairs/s and peak memory
                of the ViT-B/16 step in bf16 and fp32 at batch 256, its model
                FLOPs against the bf16 / fp32 peaks, BLIP retrieval
                examples/s at batch 32. No kernel but K7 and K8 is
                launched, K7 once for each LayerNorm on the card, K8 once
                for each linear on the card, with a gradient or without.
 11. serve    - the serving export (rs_ov_torch.pipeline.export) of the base
                config at 512² (ViT-B/16, Potsdam Q=8, weights drawn from
                seed 0): export_predict and load_predict on the bf16
                channel-last route and the fp32 channel-first one (export
                and load seconds, bytes, nodes); the served program against
                live predict_raw (probabilities within SERVE_TOL, every
                label the live run decides equal, K1 / K2 / K3 or K1 / K4b
                launched as often as live); the artifact loaded in a fresh
                interpreter that imports only the loader; an artifact
                exported after one drawn weight was changed must fail that
                gate; served and live 512² tiles/s in turns. Then
                SegmentorEx(mesh=make_mesh(1, 1)) on a one-rank NCCL group
                against the meshless segmentor (predict_raw and
                predict_batch_raw, MESH_TOL, the same launches; one card
                holds one rank), and utils.profiling.trace of one live and
                one served request: each trace names its span and the
                kernels K1-K3, the served one K1's operator, the live one
                no operator (eager calls launch directly); kernel launches,
                device ms and host span printed.

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

from rs_ov_torch.kernels.build import launch_counts

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
# K7 (LayerNorm, bf16 out): one bf16 step of the largest output (2^-7 of it
# at most); the kernel and the plain version differ only in the order of the
# fp32 sums, so each output is at most one step of its own apart beside 1e-5
# of max|ref|, which _layer_norm_kernel also checks.
K7_TOL = 2.0 ** -7
# K8 (a linear's epilogue) rounds each step where the plain chain rounds it:
# equal bit for bit
K8_TOL = 0.0
B, D, K, C, G, Q = 2, 11, 32, 512, 3, 8
# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BPS, FP32_FLOPS, TF32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 495e12, 989e12
# decontam / JBU / classify chunks a call runs on the card: its crops (16 a
# 512x512 image) in one at 2 stages, whatever the batch; in chunks of 2 with CTD
CHUNKS, CTD_CHUNKS = 1, 8
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
    _out, entry, args, _keep = mod._classify_operands(**a, diameter=d)  # they outlive the calls
    _bare_beside_wrapper(f"K3 {tag}", r, entry, args, wrapper)
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
        _out, entry, args, _keep = _range_logits_operands(padded, proj, d)  # outlive the calls
        _bare_beside_wrapper(f"K1 d={d} H=W={hw}", c, entry, args, wrapper)
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
        _out, entry, args, _keep = _epilogue_operands(**a, diameter=d)  # outlive the calls
        _bare_beside_wrapper(f"K2 {tag}", r, entry, args, wrapper)
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
    rows["layer_norm"] = _layer_norm_kernel(rng, dev)
    rows["linear_epilogue"] = _linear_epilogue_kernel(rng, dev)
    return rows


def _bf16_step(v):
    """One bf16 step at each |v| of an fp32 tensor (0 at 0)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8) * (v != 0)


LN_STREAM = 200  # calls back to back in one timed stream (_stream_ms)


def _stream_ms(fn, n=LN_STREAM, reps=5):
    """Median over reps of the ms per call of n calls of fn made back to
    back between one pair of CUDA events, after a warm-up stream."""
    times = []
    for rep in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        if rep:
            times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def _layer_norm_kernel(rng, dev):
    """K7 at the tower's shapes, bf16 with bf16 parameters as the tower holds
    them: ViT-B/16 and ViT-L/14 over a call of 8 tiles (128 crops: 25216 x
    768, 32896 x 1024) and over one tile (16 crops: 3152 x 768, 4112 x 1024).
    Each against the plain version within K7_TOL of max|ref| and at most one
    bf16 step apart (beside 1e-5 of max|ref| for the order of the fp32
    sums), beside the plain version with the last column's scale
    left out; the bare library call beside the wrapper; one
    F.layer_norm call (fp32 statistics, bf16 out) timed as the library call.
    The bound is bytes: x read and the output written once, the parameters
    once. Each call is timed alone (CUDA events around it, in turns), which
    holds one launch's latency and the wrapper's host time; then in streams
    of LN_STREAM calls back to back between one pair of events (_stream_ms),
    as the tower makes them, where the launches overlap the kernels: the
    bare call's stream time per call against the bound is the kernel's
    share of it; the wrapper's (eager, no dispatch) beside the operator's
    call (torch.ops.rs_ov.layer_norm, as an exported program makes it)
    gives the dispatch's host time where the host bounds the stream."""
    import torch.nn.functional as F

    from rs_ov_torch.kernels.build import load_library
    from rs_ov_torch.kernels.layer_norm import (_layer_norm_operands, layer_norm,
                                                layer_norm_plain)

    bf = torch.bfloat16
    checks = []
    for rows, d in ((25216, 768), (32896, 1024), (3152, 768), (4112, 1024)):
        x = torch.from_numpy(rng.randn(rows, d).astype(np.float32)).to(dev, bf) * 3 + 1
        scale = torch.from_numpy((1 + 0.5 * rng.randn(d)).astype(np.float32)).to(dev, bf)
        bias = torch.from_numpy((0.3 * rng.randn(d)).astype(np.float32)).to(dev, bf)
        cut = scale.clone()
        cut[-1] = 0
        wrapper = lambda: layer_norm(x, scale, bias, 1e-5)  # noqa: E731
        plain = lambda: layer_norm_plain(x, scale, bias, 1e-5)  # noqa: E731
        label = f"K7 layer_norm {rows}x{d}"
        c = _check(label, K7_TOL, wrapper, plain,
                   lambda: layer_norm_plain(x, cut, bias, 1e-5),  # noqa: B023
                   _bound(2 * rows * d * 2 + 2 * d * 2), dropped="column's scale")
        # each output one bf16 step of its own from the plain version, beside
        # 1e-5 of max|ref|: an output near zero is a cancellation in
        # y * scale + bias, where fp32 sums in another order move it by more
        # than its own step
        ref = plain().float()
        diff, step = (wrapper().float() - ref).abs(), _bf16_step(ref)
        c["bf16_gap"] = float((diff / (step + 1e-5 * ref.abs().max())).max())
        c["outputs_past_one_step"] = int((diff > step).sum())
        assert c["bf16_gap"] <= 1, (label, c["bf16_gap"])
        _out, entry, args, _keep = _layer_norm_operands(x, scale, bias, 1e-5)  # outlive them
        _bare_beside_wrapper(label, c, entry, args, wrapper)
        library = lambda: F.layer_norm(x, (d,), scale, bias, 1e-5)  # noqa: E731
        c["library_ms"], _ = _timed_pair(library, wrapper)
        fn, stream = getattr(load_library(), entry), torch.cuda.current_stream()
        bare = lambda: fn(*args, stream.cuda_stream)  # noqa: E731
        operator = lambda: torch.ops.rs_ov.layer_norm(x, scale, bias, 1e-5)  # noqa: E731
        for key, call in (("kernel_stream_ms", bare), ("stream_ms", wrapper),
                          ("operator_stream_ms", operator), ("library_stream_ms", library)):
            c[key] = _stream_ms(call)
        print(f"[kernels] {label}: {c['bf16_gap']:.3f} of one bf16 step (+1e-5 of max|ref|) "
              f"from the plain version, {c['outputs_past_one_step']} of {ref.numel()} outputs "
              f"past one step of their own; F.layer_norm {c['library_ms']:.4f} ms; alone the "
              f"bare call is {c['bound_ms'] / c['kernel_ms']:.1%} of the bound; in streams of "
              f"{LN_STREAM} calls, per call: bare {c['kernel_stream_ms']:.4f} ms "
              f"({c['bound_ms'] / c['kernel_stream_ms']:.1%} of the bound), wrapper "
              f"{c['stream_ms']:.4f} ms, through the operator's dispatch "
              f"{c['operator_stream_ms']:.4f} ms, F.layer_norm {c['library_stream_ms']:.4f} ms, "
              f"on {CARD['smi']}")
        checks.append((f"x=[{rows}, {d}] bf16, eps=1e-5", c))
    return _row("layer_norm", "rs_ov_torch/csrc/layer_norm.cu",
                "none: XLA fused rs_ov/nn/layers.py:layer_norm", checks)


def _linear_epilogue_kernel(rng, dev):
    """K8 at the tower's shapes, on the product matmul32 makes, bf16 out with
    the bf16 bias the tower holds: ViT-B/16's in_proj [25216, 2304] (no
    activation) and c_fc [25216, 3072] (QuickGELU) and ViT-L/14's c_fc
    [32896, 4096] (GELU) over a call of 8 tiles, ViT-B/16's out_proj over
    one tile [3152, 768]; and the fp32 routes' instantiation, fp32 out with
    an fp32 bias, at ViT-B/16's c_fc [25216, 3072] (QuickGELU). Each equal
    to the plain chain bit for bit (K8_TOL), beside the chain with the last
    column's bias left out; the bare library call beside the wrapper. The
    bound is bytes: the fp32 product read and the output written once, the
    bias once. Timed
    alone (CUDA events around each call, in turns) and in streams of
    LN_STREAM calls (_stream_ms), as the tower issues them: the bare call,
    the wrapper, the plain chain; beside them the library yardstick
    torch.addmm (operands, bias and output in the row's dtype: the product
    and its epilogue in one call, which the port never calls) and the port's whole
    linear (matmul32's product, then K8)."""
    from rs_ov_torch.kernels.build import load_library
    from rs_ov_torch.kernels.linear_epilogue import (ACTIVATIONS, _linear_epilogue_operands,
                                                     linear_epilogue, linear_epilogue_plain)
    from rs_ov_torch.nn.layers import linear, matmul32

    bf, f32 = torch.bfloat16, torch.float32
    checks = []
    for rows, k_in, n, act, dt in ((25216, 768, 2304, "none", bf),
                                   (25216, 768, 3072, "quick_gelu", bf),
                                   (32896, 1024, 4096, "gelu", bf), (3152, 768, 768, "none", bf),
                                   (25216, 768, 3072, "quick_gelu", f32)):
        x = torch.from_numpy(rng.randn(rows, k_in).astype(np.float32)).to(dev, dt)
        w = torch.from_numpy((rng.randn(n, k_in) * k_in ** -0.5).astype(np.float32)).to(dev, dt)
        b = torch.from_numpy((0.5 * rng.randn(n)).astype(np.float32)).to(dev, dt)
        cut = b.clone()
        cut[-1] = 0
        y = matmul32(x, w.t())
        wrapper = lambda: linear_epilogue(y, b, act, dt)  # noqa: E731
        plain = lambda: linear_epilogue_plain(y, b, act, dt)  # noqa: E731
        size = 2 if dt == bf else 4
        label = f"K8 linear_epilogue [{rows}, {n}] {act}" + ("" if dt == bf else " fp32")
        c = _check(label, K8_TOL, wrapper, plain,
                   lambda: linear_epilogue_plain(y, cut, act, dt),  # noqa: B023
                   _bound(rows * n * (4 + size) + n * size), dropped="column's bias")
        c["bit_equal"] = bool(torch.equal(wrapper(), plain()))
        assert c["bit_equal"], label
        _out, entry, args, _keep = _linear_epilogue_operands(y, b, act, dt)  # outlive them
        _bare_beside_wrapper(label, c, entry, args, wrapper)
        library = lambda: torch.addmm(b, x, w.t())  # noqa: E731
        port = lambda: linear(x, w, b, act=ACTIVATIONS[act])  # noqa: E731
        c["library_ms"], c["linear_ms"] = _timed_pair(library, port)
        fn, stream = getattr(load_library(), entry), torch.cuda.current_stream()
        bare = lambda: fn(*args, stream.cuda_stream)  # noqa: E731
        for key, call in (("kernel_stream_ms", bare), ("stream_ms", wrapper),
                          ("plain_stream_ms", plain), ("library_stream_ms", library),
                          ("linear_stream_ms", port)):
            c[key] = _stream_ms(call)
        print(f"[kernels] {label}: equal to the plain chain bit for bit; alone the bare call "
              f"is {c['bound_ms'] / c['kernel_ms']:.1%} of the bound; in streams of "
              f"{LN_STREAM} calls, per call: bare {c['kernel_stream_ms']:.4f} ms "
              f"({c['bound_ms'] / c['kernel_stream_ms']:.1%} of the bound "
              f"{c['bound_ms']:.4f} ms), wrapper {c['stream_ms']:.4f} ms, plain chain "
              f"{c['plain_stream_ms']:.4f} ms; the whole linear: the port's (product + K8) "
              f"{c['linear_stream_ms']:.4f} ms, torch.addmm {c['library_stream_ms']:.4f} ms "
              f"(alone {c['linear_ms']:.4f} / {c['library_ms']:.4f}) on {CARD['smi']}")
        name = "bf16" if dt == bf else "fp32"
        checks.append((f"y=[{rows}, {n}] fp32, bias [{n}] {name}, act {act} -> {name}", c))
    return _row("linear_epilogue", "rs_ov_torch/csrc/linear_epilogue.cu",
                "none: XLA fused rs_ov/nn/layers.py:linear's bias add and cast and the "
                "MLP's activation", checks)


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
                operands = mod._fused_operands
            else:
                kernel = lambda: mod.jbu_epilogue_fused_classify(**a, **t, diameter=d)  # noqa: E731
                plain = lambda: mod.jbu_epilogue_fused_classify_plain(**a, **t, diameter=d)  # noqa: E731
                operands = mod._fused_classify_operands

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
            _out, entry, args, _keep = operands(**a, **t, diameter=d)  # outlive the calls
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
                _out, entry, args, _keep = _rounded_operands(inp, filt, d, key == "K4f")
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
            (torch.float32, "K4b", K4B_TOL, "adaptive_conv_tapmajor.f32",
             "rs_ov/kernels/adaptive_conv_v2.py:99"),
            (torch.bfloat16, "K4a", K4A_TOL, "adaptive_conv_tapmajor.bf16",
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
            _out, entry, args, _keep = ac._adaptive_conv_operands(inp, filt, d)  # outlive them
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
    _out, entry, args, _keep = _attention_operands(q, k, v, sm, mode, 1.0)  # outlive them
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


KERNELS = tuple(launch_counts())  # every kernel, by its launch counter's name
# K7's launches in one image-tower pass (one a call: every crop of a request or
# a batch goes through the tower at once), read from the towers' code: ln_pre,
# ln_1 and ln_2 of each front block, the last block's ln_1 alone (the base
# config's ignore_residual), ln_post; ClearCLIP's layer fusion runs the last
# block whole too (27); GEM runs every block whole (26); BLIP has no ln_pre (24).
LN_PER_PASS = {"ViT-B-16": 25, "ViT-B-32": 25, "ViT-B-16-quickgelu": 25, "ViT-L-14": 49,
               "ViT-L-14-quickgelu": 49, "ViT-H-14": 65, "SOM": 25, "ClearCLIP": 27, "GEM": 26,
               "BLIP": 24}
# K8's launches in one image-tower pass, read from the same code (and counted
# at tiny widths on the CPU): the patch embedding, the in_proj, out_proj, c_fc
# and c_proj of each front block, the last block's in_proj and out_proj alone:
# 47 B/16 and B/32, 95 L/14, 127 H/14; SOM projects the last block's q and k
# once more (48); ClearCLIP's layer fusion runs the last block whole too (51);
# GEM 55; BLIP 48. In fp32 the patch embedding, which has no bias, is its
# product as it is: one fewer (_per_pass).
LINEAR_PER_PASS = {"ViT-B-16": 47, "ViT-B-32": 47, "ViT-B-16-quickgelu": 47, "ViT-L-14": 95,
                   "ViT-L-14-quickgelu": 95, "ViT-H-14": 127, "SOM": 48, "ClearCLIP": 51,
                   "GEM": 55, "BLIP": 48}


def _per_pass(n, arch, fp32=False):
    """K7's and K8's launches in n image-tower passes of ``arch``."""
    return {"layer_norm": n * LN_PER_PASS[arch],
            "linear_epilogue": n * (LINEAR_PER_PASS[arch] - fp32)}


@contextlib.contextmanager
def _tower_kernels_on_the_card():
    """Count the LayerNorm calls (nn.layers.layer_norm) and the linear
    epilogues (nn.layers.linear's calls of K8) on CUDA tensors in the block:
    K7's and K8's expected launches where no tower's LN_PER_PASS and
    LINEAR_PER_PASS fix them (text towers, decoders, timm towers, training,
    the alternate upsamplers' norms). Yields the counts by kernel."""
    from rs_ov_torch.nn import layers

    wrapped = {"layer_norm": "_layer_norm", "linear_epilogue": "_linear_epilogue"}
    saved = {k: getattr(layers, attr) for k, attr in wrapped.items()}
    calls = dict.fromkeys(wrapped, 0)

    def counting(k, fn):
        def call(x, *args, **kwargs):
            calls[k] += x.is_cuda
            return fn(x, *args, **kwargs)
        return call

    for k, attr in wrapped.items():
        setattr(layers, attr, counting(k, saved[k]))
    try:
        yield calls
    finally:
        for k, attr in wrapped.items():
            setattr(layers, attr, saved[k])


def _since(before):
    """Each kernel's launches since ``before``, a snapshot of launch_counts()."""
    return {k: n - before[k] for k, n in launch_counts().items()}


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


def _expect_launches(route, n_images, want, before):
    """The launches since ``before`` against ``want`` (0 for a kernel it
    leaves out); a name that is no kernel's fails the gate."""
    launches = _since(before)
    want = {**dict.fromkeys(KERNELS, 0), **want}
    print(f"[slice] {route}: launches over {n_images} image(s) {launches} "
          f"(expected {want})")
    assert launches == want, (route, launches, want)
    return launches


def _drive(route, seg, images, want):
    """predict_raw on each image, the launches counted from before the first
    to after the last; checks the outputs and the counts; prints the crops/s
    and 512² tiles/s of the requests after the first; returns the counts."""
    before = launch_counts()
    secs = []
    for img in images:
        t0 = time.perf_counter()
        res = seg.predict_raw(img)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        _check_results(route, seg, res)
    launches = _expect_launches(route, len(images), want, before)
    steady = float(np.median(secs[1:] if len(secs) > 1 else secs))
    print(f"[slice] {route}: request seconds {[round(x, 4) for x in secs]}; "
          f"{16 / steady:.2f} crops/s (224²), {1 / steady:.2f} 512² tiles/s (16 crops per "
          f"512x512 image) on {CARD['smi']}")
    return launches


def _drive_batch(route, seg, images, want):
    """predict_batch_raw on all images as one batch, twice: the second call's
    launches are counted, and the second call is timed."""
    batch = np.concatenate(images)
    seg.predict_batch_raw(batch)
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    res = seg.predict_batch_raw(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert len(res) == len(images)
    _check_results(route, seg, res)
    launches = _expect_launches(route, len(images), want, before)
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
    before = launch_counts()
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
        "adaptive_conv_planes", "adaptive_conv_cl", "adaptive_conv_v3", "adaptive_conv_v4")},
                                before)
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
    _out, _entry, largs, _keep = mod._classify_operands(*args)  # they outlive the calls
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


def _call_chunk(seg, crops=16):
    """The crops in each decontam / JBU / classify chunk of a call of
    ``crops`` 224² crops, by the segmentor's default on the card."""
    grid = 224 // seg.patch_size
    tokens = torch.empty((crops, grid * grid, seg.query_features.shape[1]),
                         dtype=seg.param_dtype, device=DEV)
    return seg._chunk_size(tokens, (grid, grid), (224, 224))


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
          f"chunk={_call_chunk(seg)} of a 512x512 image's 16 crops, dtype={seg.param_dtype}")
    assert -(-16 // _call_chunk(seg)) == CHUNKS
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
    jbu_cl = {"range_logits": n * s * CHUNKS, "jbu_epilogue": n * (s - 1) * CHUNKS,
              "jbu_epilogue_classify": n * CHUNKS}
    jbu_cf = {"range_logits": n * s * CHUNKS, "adaptive_conv_tapmajor.f32": n * s * CHUNKS}
    k6 = {"fused_selfself_attention": n}
    kept = {}
    for clip_type, vit_type, arch in TOWERS:
        name = f"{clip_type} {arch}"
        seg = _build(name, **_tower_cfg(clip_type, vit_type), device=DEV)
        assert seg.cfg == get_model_config(arch), (name, seg.cfg)
        cl, cf = {**jbu_cl, **_per_pass(n, arch)}, {**jbu_cf, **_per_pass(n, arch, fp32=True)}
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
                            gem, images, {**jbu_cl, **_per_pass(n, "GEM")})
    gem32 = _build("GEM fp32", **_gem_cfg(), param_dtype=torch.float32, device=DEV,
                   query_features=gem.query_features.cpu().numpy())
    by_path["GEM fp32 channel-first"] = _drive("GEM fp32 channel-first (K1 K4b)", gem32, images,
                                               {**jbu_cf, **_per_pass(n, "GEM", fp32=True)})
    del gem32
    kept["BLIP"] = _build("BLIP base", **_blip_cfg(), device=DEV)
    by_path["BLIP"] = _drive("BLIP base bf16 channel-last (K1 K2 K3)", kept["BLIP"], images,
                             {**jbu_cl, **_per_pass(n, "BLIP")})
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
    # K7, K8: one tower pass a request
    ln, ln32 = _per_pass(3, "ViT-B-16"), _per_pass(3, "ViT-B-16", fp32=True)
    channel_last = {"range_logits": 3 * s * CHUNKS, "jbu_epilogue": 3 * (s - 1) * CHUNKS,
                    "jbu_epilogue_classify": 3 * CHUNKS, **ln}
    by_path = {
        "bf16 channel-last": _drive("bf16 channel-last (K1 K2 K3 K7 K8)", seg, images,
                                    channel_last),
        "fp32 channel-first": _drive("fp32 channel-first (K1 K4b K7 K8)", segs["base fp32"],
                                     images, {"range_logits": 3 * s * CHUNKS,
                                              "adaptive_conv_tapmajor.f32": 3 * s * CHUNKS,
                                              **ln32})}
    with _env("RS_OV_JBU_FUSED", "0"):
        by_path["bf16 channel-first"] = _drive(
            "bf16 channel-first, RS_OV_JBU_FUSED=0 (K1 K4a K7 K8)", seg, images,
            {"range_logits": 3 * s * CHUNKS, "adaptive_conv_tapmajor.bf16": 3 * s * CHUNKS, **ln})
    by_path["jbu_stack 4 stages"] = _drive(
        "jbu_stack 4 stages bf16 channel-last (K1 K2 K3 at d=7, K7 K8)", segs["jbu_stack"],
        images[:2], {"range_logits": 2 * 4 * CHUNKS, "jbu_epilogue": 2 * 3 * CHUNKS,
                     "jbu_epilogue_classify": 2 * CHUNKS, **_per_pass(2, "ViT-B-16")})
    k6 = {**channel_last, "fused_selfself_attention": 3}
    ctd = {"range_logits": 3 * s * CTD_CHUNKS, "jbu_epilogue": 3 * (s - 1) * CTD_CHUNKS,
           "jbu_epilogue_classify": 3 * CTD_CHUNKS, "fused_selfself_attention": 3,
           **_per_pass(3, "SOM")}
    with _env("RS_OV_FUSED_ATTN", "1"):
        by_path["(a) fused attention"] = _drive(
            "(a) base config, RS_OV_FUSED_ATTN=1 (K6 K1 K2 K3)", seg, images, k6)
        by_path["(b) full stack"] = _drive(
            "(b) SegEarth + CTD + self-attn enhancement + SOM + cross-tile fusion, "
            "RS_OV_FUSED_ATTN=1 (K6 K1 K2 K3)", segs["stack"], images, ctd)
        by_path["(c) ClearCLIP"] = _drive(
            "(c) ClearCLIP + layer fusion + outlier suppression, RS_OV_FUSED_ATTN=1 "
            "(K6 K1 K2 K3)", segs["clearclip"], images,
            {**k6, **_per_pass(3, "ClearCLIP")})
        by_path["fp32 fused attention"] = _drive(
            "fp32 channel-first, RS_OV_FUSED_ATTN=1 (fp32 K6, K1, K4b)", segs["base fp32"],
            images, {"fused_selfself_attention": 3, "range_logits": 3 * s * CHUNKS,
                     "adaptive_conv_tapmajor.f32": 3 * s * CHUNKS, **ln32})
    fused = {"jbu_epilogue_fused": 3 * (s - 1) * CHUNKS, "jbu_epilogue_fused_classify": 3 * CHUNKS,
             **ln}
    with _env("RS_OV_JBU_FUSED_RANGE", "1"):
        by_path["(d) fused range"] = _drive(
            "(d) base config, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b)", seg, images, fused)
        by_path["jbu_stack fused range"] = _drive(
            "jbu_stack 4 stages, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b at d=7)", segs["jbu_stack"],
            images[:2], {"jbu_epilogue_fused": 2 * 3 * CHUNKS,
                         "jbu_epilogue_fused_classify": 2 * CHUNKS,
                         **_per_pass(2, "ViT-B-16")})
        by_path["batch, fused range"] = _drive_batch(
            "predict_batch_raw of 3 images, RS_OV_JBU_FUSED_RANGE=1 (K5a K5b)", seg, images,
            {k: v // 3 for k, v in fused.items()})
    by_path["batch"] = _drive_batch("predict_batch_raw of 3 images (K1 K2 K3)", seg, images,
                                    {k: v // 3 for k, v in channel_last.items()})
    by_path["entry points"] = _drive_entry_points(segs["base fp32"], images[0])
    _classify_repairs(seg, images[0], rows)
    segs.update(_drive_towers(images, s, by_path))
    own = {"range_logits": "bf16 channel-last", "jbu_epilogue": "bf16 channel-last",
           "jbu_epilogue_classify": "bf16 channel-last",
           "adaptive_conv_tapmajor.f32": "fp32 channel-first",
           "adaptive_conv_tapmajor.bf16": "bf16 channel-first",
           "fused_selfself_attention": "(a) fused attention",
           "jbu_epilogue_fused": "(d) fused range",
           "jbu_epilogue_fused_classify": "(d) fused range",
           "adaptive_conv_planes": "entry points", "adaptive_conv_cl": "entry points",
           "adaptive_conv_v3": "entry points", "adaptive_conv_v4": "entry points",
           "layer_norm": "bf16 channel-last", "linear_epilogue": "bf16 channel-last"}
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
# The last block's heads whose zeroing phase 5's gate must catch (phase_e2e):
# with the base config's random weights each moves 35-75% of the decided
# pixels, with K7 and with the plain LayerNorm chain alike; heads 0 and 8 move
# under 1% and are printed, not gated.
FAULT_HEADS = (1, 2, 3, 4, 5, 6, 7, 9, 10, 11)


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
    # the gate must see a fault: each head of the last block zeroed in turn,
    # bf16; each of FAULT_HEADS must fail it
    missed = []
    for head in range(12):
        with _one_head_zeroed(head):
            bad = segs["base"].predict_raw(_e2e_image())[0]
        agree, decided, share = _pair_numbers(bad, out["fp32 CPU"], TAU)
        fails = not pair_passes(0.95, agree, decided, share)
        if head in FAULT_HEADS and not fails:
            missed.append(head)
        gated = "must fail" if head in FAULT_HEADS else "not gated"
        print(f"[e2e] planted fault, head {head} of 12 of the last block's attention zeroed, "
              f"bf16 default route vs fp32 CPU: argmax agreement {agree:.6f}, decided "
              f"{decided:.6f} on {share:.4f} of the pixels: the gate "
              f"{'fails' if fails else 'passes'} ({gated}); "
              f"at margin {_at_taus(bad, out['fp32 CPU'])}")
    assert not missed, f"the gate does not see head(s) {missed} zeroed"
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
        results, states = {}, {}
        for batch in (1, 3):
            calls = n // batch
            want = {"range_logits": calls * s * CHUNKS,
                    "jbu_epilogue": calls * (s - 1) * CHUNKS,
                    "jbu_epilogue_classify": calls * CHUNKS, **_per_pass(calls, "ViT-B-16")}
            work = os.path.join(tmp, f"batch{batch}")
            before = launch_counts()
            results[batch] = run_eval(EVAL_CFG, work_dir=work, segmentor=seg,
                                      batch_images=batch, verbose=False)
            launches = _expect_launches(f"eval: run_eval batch_images={batch} (K1-K3 K7 K8)",
                                        n, want, before)
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
    launched once, against the plain route."""
    for dtype, model in models:
        plain = model.encode_image(images, model_type="Experimental", output_cls_token=True)
        with _env("RS_OV_FUSED_ATTN", "1"), _tower_kernels_on_the_card() as lns:
            before = launch_counts()
            fused = model.encode_image(images, model_type="Experimental",
                                       output_cls_token=True)
            torch.cuda.synchronize()
            label = f"entry: ViT-B-16 encode_image Experimental {dtype}, RS_OV_FUSED_ATTN=1 (K6)"
            launches = _expect_launches(label, images.shape[0], {"fused_selfself_attention": 1,
                                                                 **lns}, before)
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
    default route, no kernel but K7 and K8 launched (once for each LayerNorm
    and each linear: the tower's and the upsampler's); then carafe's phase-5
    pair."""
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
        before = launch_counts()
        t0 = time.perf_counter()
        with _tower_kernels_on_the_card() as lns:
            res = seg.predict_raw(images[1])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _check_results(name, seg, res)
        if name in ALTERNATES:  # the tower's norms and sapa's own
            assert all(lns[k] >= n for k, n in _per_pass(1, "ViT-B-16").items()), (name, lns)
            _expect_launches(f"entry: SegmentorEx with {name} (K7 K8 alone)", 1, lns, before)
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


# Phase 8, the timm towers (rs_ov_torch.nn.timm_tower) through create_model at
# full width, held to phase 7's ENTRY_TOL (card fp32 against CPU fp32) and
# ENTRY_COS (card bf16 against card fp32). Before any comparison every
# LayerNorm scale, ConvNeXt gamma, bias and CLS token of each model is drawn
# anew from one seeded RandomState (the same values in every model): at the
# init's ones and zeros a tower that dropped one of them would still match.
TIMM_TOWERS = ("convnext_large_d", "ViT-B-16-SigLIP", "EVA02-B-16")
TIMM_CPU_BATCH = 2


@torch.no_grad()
def _redraw_leaves(model, seed=11):
    rng = np.random.RandomState(seed)
    for name, p in model.clip.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            new = 1.0 + 0.1 * rng.randn(*p.shape)
        elif leaf == "gamma":
            new = 0.5 + 0.1 * rng.randn(*p.shape)
        elif leaf in ("bias", "cls_token") or leaf.endswith("_b"):
            new = 0.02 * rng.randn(*p.shape)
        else:
            continue
        p.copy_(torch.from_numpy(new.astype(np.float32)))
    return model


@contextlib.contextmanager
def _saved_params(model, names, value):
    """The named parameters of ``model.clip`` filled with ``value`` for the block."""
    params = {n: p for n, p in model.clip.named_parameters() if n.endswith(names)}
    saved = {n: p.detach().clone() for n, p in params.items()}
    assert params, names
    for p in params.values():
        p.data.fill_(value)
    try:
        yield
    finally:
        for n, p in params.items():
            p.data.copy_(saved[n])


@contextlib.contextmanager
def _gamma_left_out(model):
    with _saved_params(model, ("gamma",), 1.0):
        yield


@contextlib.contextmanager
def _map_mlp_left_out(model):
    """The MAP head's residual MLP contributing nothing (its output zeroed)."""
    with _saved_params(model, ("attn_pool.mlp.c_proj_w", "attn_pool.mlp.c_proj_b"), 0.0):
        yield


@contextlib.contextmanager
def _rope_left_out(model):
    from rs_ov_torch.nn import timm_tower

    name = model.cfg.vision.timm_model_name
    arch = timm_tower.TIMM_ARCHS[name]
    timm_tower.TIMM_ARCHS[name] = dataclasses.replace(arch, rope=False)
    try:
        yield
    finally:
        timm_tower.TIMM_ARCHS[name] = arch


TIMM_FAULTS = {"convnext_large_d": (_gamma_left_out, "ConvNeXt's gammas left out"),
               "ViT-B-16-SigLIP": (_map_mlp_left_out, "the MAP head's MLP residual left out"),
               "EVA02-B-16": (_rope_left_out, "RoPE left out")}


def _encode_pooled(model, images, ids):
    """(image embedding, normalised text embedding, logits with the bias
    where the model has one) of a timm-towered CLIPModel."""
    image = model.encode_image(images)
    text = model.encode_text(ids, normalize=True).float()
    img = image.float() / image.float().norm(dim=-1, keepdim=True)
    logits = model.logit_scale.float() * img @ text.t()
    if hasattr(model.clip, "logit_bias"):
        logits = logits + model.clip.logit_bias.float()
    return image, text, logits


def _timm_tower(name, rng):
    """One timm tower through create_model at full width: card fp32 against
    CPU fp32 with no kernel but K7 and K8 launched, its planted fault above the bound,
    card bf16 against card fp32, images/s at batch ENTRY_TIMED_BATCH."""
    from rs_ov_torch.core.config import get_model_config
    from rs_ov_torch.factory import create_model

    cfg = get_model_config(name)
    size = cfg.vision.image_size
    t0 = time.perf_counter()
    m32 = _redraw_leaves(create_model(name, precision="fp32", seed=0))
    m16 = _redraw_leaves(create_model(name, precision="bf16", seed=0))
    cpu = _redraw_leaves(create_model(name, device="cpu", seed=0))
    built = time.perf_counter() - t0
    images = torch.from_numpy(rng.randn(TIMM_CPU_BATCH, 3, size, size).astype(np.float32))
    ids = _text_ids(cfg, rng)
    before = launch_counts()
    with _tower_kernels_on_the_card() as lns:
        card = _encode_pooled(m32, images, ids)
        torch.cuda.synchronize()
    _expect_launches(f"timm: {name} encode_image / encode_text fp32 (K7 K8 alone)",
                     TIMM_CPU_BATCH, lns, before)
    t0 = time.perf_counter()
    ref = _encode_pooled(cpu, images, ids)
    cpu_s = time.perf_counter() - t0
    errs = _entry_errs(card, ref)
    fault, fault_label = TIMM_FAULTS[name]
    with fault(m32):
        bad = _entry_errs(_encode_pooled(m32, images, ids), ref)
    cos = [_min_cos(a, b) for a, b in zip(_encode_pooled(m16, images, ids)[:2], card[:2])]
    params = sum(p.numel() for p in m32.clip.visual.parameters())
    print(f"[timm] {name} ({cfg.vision.timm_model_name}, head "
          f"{cfg.vision.timm_proj}, {params / 1e6:.1f} M vision parameters; built x3 in "
          f"{built:.1f} s, CPU fp32 run {cpu_s:.1f} s): {TIMM_CPU_BATCH} images {size}², "
          f"{len(ids)} prompts; card fp32 vs CPU fp32 max|d|/max|ref| image {errs[0]:.3e} "
          f"text {errs[1]:.3e} logits {errs[2]:.3e} (bound {ENTRY_TOL}); planted fault, "
          f"{fault_label}: image {bad[0]:.3e} (must exceed the bound); bf16 vs fp32 on the "
          f"card, least cosine image {cos[0]:.5f} text {cos[1]:.5f} (need >= {ENTRY_COS})")
    assert tuple(card[0].shape) == (TIMM_CPU_BATCH, cfg.embed_dim), card[0].shape
    assert all(bool(torch.isfinite(x).all()) for x in card)
    assert max(errs) <= ENTRY_TOL, (name, errs)
    assert bad[0] > ENTRY_TOL, (name, "the bound does not see the fault", bad)
    assert min(cos) >= ENTRY_COS, (name, cos)
    del cpu
    big = torch.randn(ENTRY_TIMED_BATCH, 3, size, size, generator=torch.Generator().manual_seed(5))
    rates = {p: _images_per_s(m, big.to(DEV, m.dtype)) for p, m in (("fp32", m32),
                                                                   ("bf16", m16))}
    print(f"[timm] {name} encode_image at batch {ENTRY_TIMED_BATCH}, {size}²: fp32 "
          f"{rates['fp32']:.1f} images/s, bf16 {rates['bf16']:.1f} images/s on {CARD['smi']}")


def phase_timm():
    """The timm towers through create_model at full width, random weights
    from seed 0 with the small leaves drawn anew: convnext_large_d (256²,
    'mlp' head), ViT-B-16-SigLIP (224², MAP head, logit_bias) and
    EVA02-B-16 (224², RoPE, SwiGLU, inner norms, split qkv, the trunk's
    head)."""
    rng = np.random.RandomState(8)
    for name in TIMM_TOWERS:
        _timm_tower(name, rng)
        torch.cuda.empty_cache()


# Phase 9, generation (rs_ov_torch.nn.blip_lm, nn.coca, the evaluations) at
# full width on random weights, every leaf drawn anew from one seeded
# RandomState (_redraw_module): at the inits' N(0, 0.02) the logits are so
# flat that most decode steps are near ties. Gates, each beside a planted
# fault that must fail it:
# - the card in fp32 against the port on the CPU in fp32: max|d|/max|ref| <=
#   GEN_TOL (phase 7's ENTRY_TOL) on image and text embeddings, teacher-forced
#   decoder logits, ITM and NLVR logits;
# - the KV-cached step against the full-prefix step on the card, rows
#   reordered by a parent permutation before each step: <= GEN_TOL;
# - tokens: two runs agree on every decode step before the first one whose
#   decision margin in the reference run is below GEN_TAU (the log-probability
#   gap that decides the step: top-1 minus top-2 for sampling; for a beam,
#   the gap at the cut between the kept beams and the next candidate, at the
#   top-k cut of each beam that reaches the kept ones, and between the best
#   finished and the best kept score; the kept beams compared as a set);
#   random weights make many steps near ties, so the decided share of steps
#   is printed;
# - bf16 teacher-forced logits against the card's fp32: least cosine >= GEN_COS;
# - the committed decode golden on the card in fp32: the CPU run gives the
#   golden, the card run agrees with it on every decided step.
GEN_TOL, GEN_COS, GEN_TAU = ENTRY_TOL, ENTRY_COS, 1e-4
GEN_VOCAB = 30522  # bert-base-uncased; the tokenizer adds [DEC] and [ENC]
GEN_IMAGES, GEN_CPU_IMAGES = 4, 2
VQA_QUESTIONS, VQA_CANDIDATES, ITM_PAIRS = 4, 128, 16
GEN_COCA, GEN_COCA_HF = "coca_ViT-L-14", "coca_roberta-ViT-B-32"
GOLDEN = "tests/fixtures/blip_decode_golden"
GOLDEN_VISION = dict(image_size=32, patch_size=8, width=24, layers=2, heads=2)
GOLDEN_TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                   intermediate_size=32, max_position_embeddings=40)


def _blip_gen_cfg(image_size):
    """BLIP base at ``image_size`` (a function, so a rehearsal can cut it)."""
    from rs_ov_torch.nn.blip import BlipConfig

    return BlipConfig.base(image_size)


@torch.no_grad()
def _redraw_module(m, seed=11):
    """Every leaf drawn anew from one seeded CPU generator: LayerNorm scales
    1 + N(0, 0.1), biases, CLS tokens and token types N(0, 0.02), every
    other array N(0, 1 / fan-in) (fan-in: the product of its dims after the
    first, or the first for the [in, out] ``proj`` / ``text_projection``);
    scalars kept."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 0:
            continue
        new = torch.randn(p.shape, generator=gen)
        if leaf == "scale":
            new = 1.0 + 0.1 * new
        elif leaf in ("bias", "b", "b1", "b2", "cls_token", "token_type") or leaf.endswith("_b"):
            new = 0.02 * new
        else:
            in_out = leaf in ("proj", "text_projection") or p.dim() == 1
            new = new * (p.shape[0] if in_out else int(np.prod(p.shape[1:]))) ** -0.5
        p.copy_(new)
    return m


class _Steps:
    """Each decode step's (margin, decision), one list per decoded sequence
    (a new one where the step position starts over)."""

    def __init__(self):
        self.runs = []

    def add(self, new_run, margin, decision):
        if new_run or not self.runs:
            self.runs.append([])
        self.runs[-1].append((float(margin), decision))


def _beam_margin(cands, k, finished, kept, eos_in_cut=False):
    """The least score gap that decides one beam step. ``cands``: (score,
    beam, rank in the beam, is EOS, the token's own log-prob share) of each
    beam's k + 1 best tokens (rank k is not a candidate). The cut: the kept
    (the k best non-EOS candidates; with ``eos_in_cut`` the candidates taken
    in score order until k are kept, EOS ones finishing) against the next;
    each beam's rank k-1 / k gap where its rank k-1 token reaches the cut
    or is EOS; the best finished score against the best kept one."""
    live = sorted((c for c in cands if c[2] < k and (eos_in_cut or not c[3])),
                  key=lambda c: -c[0])
    if eos_in_cut:
        n, taken = 0, 0
        while taken < len(live) and n < k:
            n += not live[taken][3]
            taken += 1
    else:
        taken = min(k, len(live))
    gaps = [live[taken - 1][0] - live[taken][0]] if 0 < taken < len(live) else []
    cut = live[taken - 1][0] if taken else np.inf
    by_beam = {}
    for c in cands:
        by_beam.setdefault(c[1], {})[c[2]] = c
    for ranks in by_beam.values():
        if k in ranks and k - 1 in ranks and (ranks[k - 1][0] >= cut or ranks[k - 1][3]
                                              or ranks[k][3]):
            gaps.append(ranks[k - 1][4] - ranks[k][4])
    if finished and kept:
        gaps.append(abs(finished[0][0] - kept[0][0]))
    return min(gaps) if gaps else np.inf


@contextlib.contextmanager
def _recorded_steps():
    """Record the decisions of the port's per-step functions: BLIP's beam
    (``_expand``) and nucleus (``_nucleus_pick``) steps, CoCa's beam step
    (``_beam_step``) and its top-p / top-k warpers (the margins; the tokens
    come from the output)."""
    from rs_ov_torch.nn import blip_lm, coca

    steps = _Steps()
    orig = {(blip_lm, "_expand"): blip_lm._expand, (blip_lm, "_nucleus_pick"):
            blip_lm._nucleus_pick, (coca, "_beam_step"): coca._beam_step,
            (coca, "_warp_top_p"): coca._warp_top_p, (coca, "_warp_top_k"): coca._warp_top_k}
    last = {"pos": None}

    def expand(beams, logits, pos, eos, num_beams, min_length, penalty, finished):
        cands = []  # (score, beam, rank in the beam, eos)
        for b, beam in enumerate(beams):
            lg = blip_lm._penalised(logits[b], beam[1], penalty)
            if pos + 1 < min_length:
                lg[eos] = -1e9
            logp = lg - np.log(np.exp(lg - lg.max()).sum()) - lg.max()
            order = np.argsort(-logp)[:num_beams + 1]
            cands += [(beam[0] + float(logp[t]), b, r, t == eos, float(logp[t]))
                      for r, t in enumerate(order)]
        kept = orig[(blip_lm, "_expand")](beams, logits, pos, eos, num_beams, min_length,
                                          penalty, finished)
        margin = _beam_margin(cands, num_beams, finished, kept)
        new = last["pos"] is None or pos <= last["pos"]
        last["pos"] = pos
        steps.add(new, margin, (tuple(sorted(tuple(c[1]) for c in kept)), len(finished)))
        return kept

    def nucleus(logits, seq, pos, eos, min_length, top_p, rng):
        lg = blip_lm._penalised(logits, seq, 1.1)
        if pos + 1 < min_length:
            lg[eos] = -1e9
        nxt = orig[(blip_lm, "_nucleus_pick")](logits, seq, pos, eos, min_length, top_p, rng)
        new = last["pos"] is None or pos <= last["pos"]
        last["pos"] = pos
        srt = np.sort(lg)[::-1]
        steps.add(new, srt[0] - srt[1], nxt)
        return nxt

    def beam_step(beams, logits, num_beams, min_seq_len, eos, done):
        m = logits.max(-1, keepdims=True)
        logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
        cands = []
        for b, ((score, toks, _), row) in enumerate(zip(beams, logp)):
            if len(toks) <= min_seq_len:
                row = row.copy()
                row[eos] = -np.inf
            order = np.argsort(-row)[:num_beams + 1]
            cands += [((score + float(row[t])) / (len(toks) + 1), b, r, t == eos,
                       float(row[t]) / (len(toks) + 1)) for r, t in enumerate(order)]
        n_done = len(done)
        kept = orig[(coca, "_beam_step")](beams, logits, num_beams, min_seq_len, eos, done)
        margin = _beam_margin(cands, num_beams, None, kept, eos_in_cut=True)
        steps.add(len(beams[0][1]) == 1, margin,
                  (tuple(sorted(tuple(c[1]) for c in kept)), len(done) - n_done))
        return kept

    def warp(name):
        def f(logits, arg):
            srt = np.sort(logits, axis=-1)
            steps.add(not steps.runs, 0.0, None)  # one entry per step: [B] margins
            steps.runs[-1][-1] = (srt[:, -1] - srt[:, -2], None)
            return orig[(coca, name)](logits, arg)
        return f

    blip_lm._expand, blip_lm._nucleus_pick = expand, nucleus
    coca._beam_step, coca._warp_top_p, coca._warp_top_k = beam_step, warp("_warp_top_p"), \
        warp("_warp_top_k")
    try:
        yield steps
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)


def _sampled_runs(steps, out):
    """CoCa sampling: per row, (margin, token) of each step from the
    recorded [B] margins and the output tokens."""
    recs = steps.runs[0] if steps.runs else []
    return [[(float(m[r]), int(out[r, k + 1]) if k + 1 < out.shape[1] else None)
             for k, (m, _) in enumerate(recs)] for r in range(out.shape[0])]


def _decided(ref_runs, runs):
    """(decided steps, all steps, agree): the runs agree on every step before
    the first one the reference decides by less than GEN_TAU, and, where
    every step is decided, on their length."""
    assert len(ref_runs) == len(runs), (len(ref_runs), len(runs))
    decided = total = 0
    agree = True
    for ref, run in zip(ref_runs, runs):
        d = next((i for i, (m, _) in enumerate(ref) if m < GEN_TAU), len(ref))
        decided, total = decided + d, total + len(ref)
        same = all(i < len(run) and run[i][1] == ref[i][1] for i in range(d))
        agree &= same and (d < len(ref) or len(run) == len(ref))
    return decided, total, agree


def _token_gate(label, ref_runs, runs, fault_runs=None):
    d, n, agree = _decided(ref_runs, runs)
    line = (f"[generate] {label}: tokens agree on every decided step: {agree} (decided "
            f"{d}/{n} steps, {d / max(n, 1):.3f}, margin >= {GEN_TAU})")
    if fault_runs is not None:
        fd, _, fagree = _decided(ref_runs, fault_runs)
        line += f"; planted fault, the cross K/V zeroed: agree {fagree} (must be False)"
    print(line)
    assert agree, label
    assert fault_runs is None or not fagree, (label, "the gate does not see the fault")


class _Tokens:
    """A WordPiece tokenizer whose decode also records the token ids."""

    def __init__(self, tok):
        self.tok, self.decoded = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def __call__(self, *a, **kw):
        return self.tok(*a, **kw)

    def decode(self, ids, **kw):
        self.decoded.append([int(i) for i in ids])
        return self.tok.decode(ids, **kw)


@contextlib.contextmanager
def _patched(mod, name, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _no_gather(cache, parent):
    return cache


def _cross_kv_zeroed():
    """The decoders' init with the projected cross K/V zeroed."""
    from rs_ov_torch.nn import blip_lm, coca

    bert_init, coca_init = blip_lm.bert_decode_init_cache, coca.coca_decode_init_cache

    def zero(cache):
        for part in ([cache["layers"]] if "layers" in cache else cache.values()):
            for lc in part:
                for k in ("xk", "xv"):
                    if k in lc:
                        lc[k] = torch.zeros_like(lc[k])
        return cache

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(blip_lm, "bert_decode_init_cache",
                                 lambda *a, **kw: zero(bert_init(*a, **kw))))
    stack.enter_context(_patched(coca, "coca_decode_init_cache",
                                 lambda *a, **kw: zero(coca_init(*a, **kw))))
    return stack


def _step_off_by_one():
    """BLIP's cached step at position pos + 1 (its embedding, its cache slot
    and its mask), an off-by-one."""
    from rs_ov_torch.nn import blip_lm

    step = blip_lm.bert_decode_step
    return _patched(blip_lm, "bert_decode_step",
                    lambda p, tokens, pos, *a, **kw: step(p, tokens, pos + 1, *a, **kw))


def _cls_first():
    """CoCa's text tower with the CLS put first (the token rows then see it)."""
    from rs_ov_torch.nn import coca
    from rs_ov_torch.nn.layers import layer_norm
    from rs_ov_torch.text.encoder import causal_mask

    def encode_text(p, text_ids, cfg, normalize=True):
        t = p.text
        b, seq = text_ids.shape
        x = t.token_embedding[text_ids.long()]
        x = torch.cat([t.cls_emb.to(x.dtype).expand(b, 1, -1), x], dim=1)
        x = x + t.positional_embedding[:seq + 1].to(x.dtype)[None]
        mask = causal_mask(seq + 1, x.device)
        for blk in t.blocks:
            x = coca._block(blk, x, cfg.text.heads, coca._act(cfg), mask=mask)
        pooled = layer_norm(x[:, 0], t.ln_final) @ t.text_projection.to(x.dtype)
        return pooled, x[:, 1:]

    return _patched(coca, "coca_encode_text", encode_text)


class _StepClock:
    """Wraps a decoder maker's step: CUDA events around each step (the
    span from its first launch to its last kernel) and the host's wall
    time over the run."""

    def __init__(self, mod, name):
        self.mod, self.name, self.events = mod, name, []

    def __enter__(self):
        make = self.orig = getattr(self.mod, self.name)

        def timed_make(*a, **kw):
            init, step = make(*a, **kw)

            def timed_step(*sa, **skw):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = step(*sa, **skw)
                end.record()
                self.events.append((start, end))
                return out
            return init, timed_step

        setattr(self.mod, self.name, timed_make)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        setattr(self.mod, self.name, self.orig)
        self.steps = len(self.events)
        self.step_ms = sum(s.elapsed_time(e) for s, e in self.events) / max(self.steps, 1)


def _rate_line(label, n_out, unit, clock):
    host_ms = clock.wall * 1e3 / max(clock.steps, 1)
    print(f"[generate] {label}: {n_out / clock.wall:.3f} {unit}/s ({n_out} in {clock.wall:.3f} "
          f"s), {clock.steps} decode steps: {clock.step_ms:.3f} ms a step on the card "
          f"(CUDA-event span of the step's launches), {host_ms:.3f} ms a step on the host's "
          f"clock (the whole loop), span share {clock.step_ms / host_ms:.3f}, on {CARD['smi']}")


def _on(x, model_dtype=torch.float32):
    return torch.as_tensor(x).to(DEV, model_dtype)


def _cached_vs_full(label, init, step, full, embs, vocab, n_steps, rows=3, faults=()):
    """The cached step against the full prefix on the card: rows reordered
    by a parent permutation before each step after the first, teacher-forced
    random tokens; max|d|/max|ref| over the steps. ``full(seqs [R, n],
    embs [R, ...]) -> logits at the last position``. Each fault (a context
    and its label) must land above the bound."""
    def run():
        rng = np.random.RandomState(4)
        cache = init(embs)
        seqs = np.zeros((rows, 0), np.int32)
        order = np.arange(rows)
        worst = 0.0
        for pos in range(n_steps):
            parent = (rng.permutation(rows) if pos else np.arange(rows)).astype(np.int32)
            seqs, order = seqs[parent], order[parent]
            seqs = np.concatenate([seqs, rng.randint(1, vocab, (rows, 1)).astype(np.int32)], 1)
            got, cache = step(seqs[:, -1], pos, cache, parent)
            want = full(seqs, embs[torch.from_numpy(order).to(embs.device)])
            worst = max(worst, _rel(got, want))
        return worst

    err = run()
    bad = []
    for ctx, flabel in faults:
        with ctx():
            bad.append((flabel, run()))
    print(f"[generate] {label}: cached step vs full prefix on the card, {n_steps} steps, "
          f"{rows} rows reordered each step: max|d|/max|ref| {err:.3e} (bound {GEN_TOL}); "
          + "; ".join(f"planted fault, {f}: {e:.3e}" for f, e in bad) + " (must exceed it)")
    assert err <= GEN_TOL, (label, err)
    assert all(e > GEN_TOL for _, e in bad), (label, "the bound does not see a fault", bad)


def _blip_models(init, size, seed):
    """(card fp32, card bf16, CPU fp32) copies of one random BLIP model."""
    import copy

    cfg = _blip_gen_cfg(size)
    cpu = _redraw_module(init(torch.Generator().manual_seed(seed), cfg), seed)
    return cfg, copy.deepcopy(cpu).to(DEV), copy.deepcopy(cpu).to(DEV, torch.bfloat16), cpu


def _caption_logits(m, cfg, images, ids):
    """Teacher-forced decoder logits [B, L, V] (causal, over the image tokens)."""
    from rs_ov_torch.nn.bert import bert_encode
    from rs_ov_torch.nn.blip_lm import lm_logits
    from rs_ov_torch.nn.blip_vit import blip_vit_forward

    with torch.no_grad():
        leaf = m.visual.cls_token
        embs = blip_vit_forward(m.visual, torch.as_tensor(images).to(leaf.device, leaf.dtype),
                                cfg.vision)
        ids = torch.as_tensor(ids).to(embs.device)
        hidden = bert_encode(m.text_decoder, ids, torch.ones_like(ids), cfg.text,
                             encoder_hidden_states=embs, causal=True)
        return embs, lm_logits(m.lm_head, hidden)


def _blip_caption(rng, tok):
    """BLIP base captioning at 384²: card fp32 vs CPU fp32 (image tokens,
    teacher-forced logits), bf16 vs fp32, cached vs full prefix, beam and
    nucleus tokens against the CPU and the full prefix, the rates."""
    from rs_ov_torch.evalsuite.caption import evaluate_captions
    from rs_ov_torch.nn import blip_lm

    cfg, m32, m16, cpu = _blip_models(blip_lm.init_blip_decoder_params, 384, 11)
    images = rng.randn(GEN_IMAGES, 3, 384, 384).astype(np.float32)
    small = images[:GEN_CPU_IMAGES]
    ids = rng.randint(1, GEN_VOCAB, (GEN_CPU_IMAGES, 30))
    card = _caption_logits(m32, cfg, small, ids)
    ref = _caption_logits(cpu, cfg, small, ids)
    errs = [_rel(a, b) for a, b in zip(card, ref)]
    last = m32.text_decoder.layers[-1]
    saved = last.x_out_w.detach().clone()
    last.x_out_w.data.zero_()
    bad = _rel(_caption_logits(m32, cfg, small, ids)[1], ref[1])
    last.x_out_w.data.copy_(saved)
    cos = _min_cos(_caption_logits(m16, cfg, small, ids)[1], card[1])
    print(f"[generate] BLIP base caption decoder, 384², vocabulary {cfg.text.vocab_size}: card "
          f"fp32 vs CPU fp32 max|d|/max|ref| image tokens {errs[0]:.3e} teacher-forced logits "
          f"{errs[1]:.3e} (bound {GEN_TOL}); planted fault, the last layer's cross-attention "
          f"output zeroed: logits {bad:.3e} (must exceed it); bf16 vs fp32 on the card, least "
          f"cosine of the logits {cos:.5f} (need >= {GEN_COS})")
    assert max(errs) <= GEN_TOL and bad > GEN_TOL and cos >= GEN_COS, (errs, bad, cos)

    init, step = blip_lm.make_cached_decoder(m32, cfg, 30)
    full_step = blip_lm.make_caption_step(m32, cfg, 30)

    def full(seqs, embs):
        ids_p = np.zeros((len(seqs), 30), np.int32)
        ids_p[:, :seqs.shape[1]] = seqs
        return full_step(ids_p, seqs.shape[1] - 1, embs)

    _cached_vs_full("BLIP caption", init, step, full, card[0][[0, 1, 0]],
                    GEN_VOCAB, 30, faults=((lambda: _patched(blip_lm, "_gather_cache",
                                                              _no_gather), "parent gather skipped"),
                                           (_cross_kv_zeroed, "the cross K/V zeroed")))

    kw = dict(num_beams=3, max_length=30, min_length=10)
    for mode, extra in (("beam 3", {}), ("nucleus top_p 0.9", dict(sample=True, top_p=0.9))):
        runs = {}
        for name, model, use_cache, fault in (("cpu", cpu, True, None), ("card", m32, True, None),
                                              ("card full", m32, False, None),
                                              ("card fault", m32, True, _cross_kv_zeroed)):
            if name == "card full" and "sample" in extra:
                continue
            t = _Tokens(tok)
            with _recorded_steps() as steps, (fault() if fault else contextlib.nullcontext()):
                blip_lm.generate_captions(model, small, cfg, t, use_cache=use_cache,
                                          rng=np.random.RandomState(5), **kw, **extra)
            runs[name] = steps.runs
        _token_gate(f"BLIP {mode}, card fp32 vs CPU fp32", runs["cpu"], runs["card"],
                    runs["card fault"])
        if "card full" in runs:
            _token_gate(f"BLIP {mode}, card cached vs card full prefix", runs["card full"],
                        runs["card"])
        for prec, model in (("fp32", m32), ("bf16", m16)):
            blip_lm.generate_captions(model, images[:1], cfg, tok, **kw, **extra)  # warm-up
            before = launch_counts()
            with _StepClock(blip_lm, "make_cached_decoder") as clock, \
                    _tower_kernels_on_the_card() as lns:
                caps = blip_lm.generate_captions(model, images, cfg, tok,
                                                 rng=np.random.RandomState(6), **kw, **extra)
            _expect_launches(f"generate: BLIP {mode} {prec} (K7 K8 alone)", GEN_IMAGES, lns,
                             before)
            assert len(caps) == GEN_IMAGES and all(isinstance(c, str) for c in caps)
            _rate_line(f"BLIP {mode} {prec}, {GEN_IMAGES} images", GEN_IMAGES, "captions",
                       clock)
    recs = evaluate_captions(m16, cfg, images[:3], [7, 8, 9], tok, batch=2, num_beams=3,
                             max_length=20, min_length=5)
    print(f"[generate] evaluate_captions, BLIP bf16, 3 images in batches of 2: {recs}")
    assert [r["image_id"] for r in recs] == [7, 8, 9]
    del m32, m16, cpu


def _blip_vqa(rng, tok):
    """BLIP VQA at 480²: rank over VQA_CANDIDATES and beam-3 generate, card
    fp32 against the CPU; questions/s in fp32 and bf16."""
    from rs_ov_torch.nn import blip_lm

    cfg, m32, m16, cpu = _blip_models(blip_lm.init_blip_vqa_params, 480, 12)
    images = rng.randn(VQA_QUESTIONS, 3, 480, 480).astype(np.float32)
    enc = tok([f"what is in the picture w{i}?" for i in range(VQA_QUESTIONS)], max_length=35)
    q_ids = enc["input_ids"].astype(np.int32)
    q_ids[:, 0] = tok.enc_token_id
    q_mask = enc["attention_mask"]
    ans = rng.randint(1, GEN_VOCAB, (VQA_CANDIDATES, 8)).astype(np.int32)
    ans[:, 0] = tok.bos_token_id
    ans[:, 5:] = 0
    ans_mask = (ans != 0).astype(np.int32)
    n = GEN_CPU_IMAGES
    want = blip_lm.vqa_rank_answers(cpu, images[:n], q_ids[:n], q_mask[:n], ans, ans_mask, cfg,
                                    k=VQA_CANDIDATES)
    got = blip_lm.vqa_rank_answers(m32, images[:n], q_ids[:n], q_mask[:n], ans, ans_mask, cfg,
                                   k=VQA_CANDIDATES)
    runs = {}
    for name, model, fault in (("cpu", cpu, None), ("card", m32, None),
                               ("card fault", m32, _cross_kv_zeroed)):
        with _recorded_steps() as steps, (fault() if fault else contextlib.nullcontext()):
            blip_lm.vqa_generate_answers(model, images[:n], q_ids[:n], q_mask[:n], cfg, tok,
                                         num_beams=3, max_length=10)
        runs[name] = steps.runs
    print(f"[generate] BLIP VQA, 480²: rank over {VQA_CANDIDATES} candidates, card fp32 "
          f"{got.tolist()} CPU fp32 {want.tolist()}")
    assert got.tolist() == want.tolist()
    _token_gate("BLIP VQA generate beam 3, card fp32 vs CPU fp32", runs["cpu"], runs["card"],
                runs["card fault"])
    for prec, model in (("fp32", m32), ("bf16", m16)):
        blip_lm.vqa_rank_answers(model, images[:1], q_ids[:1], q_mask[:1], ans, ans_mask, cfg,
                                 k=VQA_CANDIDATES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = blip_lm.vqa_rank_answers(model, images, q_ids, q_mask, ans, ans_mask, cfg,
                                       k=VQA_CANDIDATES)
        torch.cuda.synchronize()
        rank_s = time.perf_counter() - t0
        assert tuple(idx.shape) == (VQA_QUESTIONS,)
        with _StepClock(blip_lm, "make_cached_decoder") as clock:
            answers = blip_lm.vqa_generate_answers(model, images, q_ids, q_mask, cfg, tok,
                                                   num_beams=3, max_length=10)
        assert len(answers) == VQA_QUESTIONS
        print(f"[generate] BLIP VQA {prec}: rank {VQA_QUESTIONS / rank_s:.3f} questions/s "
              f"({VQA_QUESTIONS} questions x {VQA_CANDIDATES} candidates in {rank_s:.3f} s) on "
              f"{CARD['smi']}")
        _rate_line(f"BLIP VQA generate beam 3 {prec}, {VQA_QUESTIONS} questions",
                   VQA_QUESTIONS, "questions", clock)
    del m32, m16, cpu


def _blip_itm_nlvr(rng, tok):
    """ITM (itm and itc heads) and NLVR at 384²: card fp32 vs CPU fp32,
    ITM pairs/s; then the retrieval evaluation on a small set."""
    from rs_ov_torch.evalsuite.retrieval import blip_retrieval_evaluation
    from rs_ov_torch.nn import blip, blip_lm

    cfg, m32, m16, cpu = _blip_models(blip_lm.init_blip_itm_params, 384, 13)
    images = rng.randn(ITM_PAIRS, 3, 384, 384).astype(np.float32)
    enc = tok([f"a picture of w{i} and w{i + 7}" for i in range(ITM_PAIRS)], max_length=35)
    ids, mask = enc["input_ids"].astype(np.int64), enc["attention_mask"].astype(np.int64)
    n = GEN_CPU_IMAGES

    def heads(m):
        leaf = m.visual.cls_token
        with torch.no_grad():
            args = (torch.as_tensor(images[:n]).to(leaf.device, leaf.dtype),
                    torch.as_tensor(ids[:n]).to(leaf.device),
                    torch.as_tensor(mask[:n]).to(leaf.device), cfg)
            return [blip.blip_itm_score(m, *args, match_head=h) for h in ("itm", "itc")]

    errs = [_rel(a, b) for a, b in zip(heads(m32), heads(cpu))]
    ncfg, n32, _, ncpu = _blip_models(blip_lm.init_blip_nlvr_params, 384, 14)
    nl_ids = ids[:n].copy()
    nl_ids[:, 0] = tok.enc_token_id
    nl = [blip_lm.blip_nlvr_forward(m, images[:2 * n], nl_ids, mask[:n], ncfg)
          for m in (n32, ncpu)]
    nl_err = _rel(*nl)
    print(f"[generate] BLIP ITM 384²: card fp32 vs CPU fp32 max|d|/max|ref| itm {errs[0]:.3e} "
          f"itc {errs[1]:.3e}; NLVR (twin cross-attention, the merge layer from layer "
          f"{ncfg.text.num_layers // 2}) logits "
          f"{nl_err:.3e} (bound {GEN_TOL})")
    assert max(errs + [nl_err]) <= GEN_TOL, (errs, nl_err)
    del n32, ncpu
    for prec, model in (("fp32", m32), ("bf16", m16)):
        args = (_on(images, model.visual.cls_token.dtype), torch.as_tensor(ids).to(DEV),
                torch.as_tensor(mask).to(DEV), cfg)
        with torch.no_grad():
            blip.blip_itm_score(model, *args)
            torch.cuda.synchronize()
            ms = _median_ms(lambda: blip.blip_itm_score(model, *args), reps=5)
        print(f"[generate] BLIP ITM itm head {prec}: {ITM_PAIRS / ms * 1e3:.1f} pairs/s "
              f"({ITM_PAIRS} pairs, 384², {ms:.3f} ms) on {CARD['smi']}")
    txt2img = [t % 4 for t in range(8)]
    img2txt = [[t for t in range(8) if t % 4 == i] for i in range(4)]
    enc = tok([f"a picture of w{i}" for i in range(8)], max_length=35)
    res = blip_retrieval_evaluation(m16, cfg, images[:4], enc["input_ids"], enc["attention_mask"],
                                    tok.enc_token_id, txt2img, img2txt, k_test=2,
                                    rows_per_chunk=2)
    print(f"[generate] blip_retrieval_evaluation, bf16, 4 images x 8 captions, k_test 2: {res}")
    assert all(np.isfinite(v) for v in res.values())
    del m32, m16, cpu


@contextlib.contextmanager
def _cls_mask_dropped(model):
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, pad_id=-1)
    try:
        yield
    finally:
        model.cfg = cfg


def _coca_encode(model, images, ids):
    out = model(images, ids)
    return (out["image_features"], out["text_features"], out["logits"])


def _coca(rng):
    """create_model("coca_ViT-L-14") at 224² in fp32 and bf16: encoders and
    forward against the CPU, cached vs full prefix, beam and top-p tokens,
    the rates; coca_roberta-ViT-B-32's encoders against the CPU."""
    from rs_ov_torch.factory import create_model, get_tokenizer
    from rs_ov_torch.nn import coca, hf_text

    t0 = time.perf_counter()
    m32 = create_model(GEN_COCA, precision="fp32", seed=0)
    m16 = create_model(GEN_COCA, precision="bf16", seed=0)
    cpu = create_model(GEN_COCA, device="cpu", seed=0)
    for m in (m32, m16, cpu):
        _redraw_module(m.coca)
    built = time.perf_counter() - t0
    cfg = m32.cfg
    size = cfg.vision.image_size
    images = rng.randn(GEN_IMAGES, 3, size, size).astype(np.float32)
    small = images[:GEN_CPU_IMAGES]
    ids = get_tokenizer(GEN_COCA)(list(ENTRY_PROMPTS[:GEN_CPU_IMAGES]))
    card, ref = _coca_encode(m32, small, ids), _coca_encode(cpu, small, ids)
    errs = [_rel(a, b) for a, b in zip(card, ref)]
    with _cls_mask_dropped(m32):
        bad = _rel(_coca_encode(m32, small, ids)[1], ref[1])
    cos = [_min_cos(a, b) for a, b in zip(_coca_encode(m16, small, ids), card)]
    print(f"[generate] {GEN_COCA} ({cfg.vision.width} wide, {cfg.vision.layers} layers, "
          f"pooler {cfg.attn_pooler_heads} heads x {cfg.attn_pooler_queries} queries; built x3 "
          f"in {built:.1f} s), {size}²: card fp32 vs CPU fp32 max|d|/max|ref| image "
          f"{errs[0]:.3e} text {errs[1]:.3e} teacher-forced logits {errs[2]:.3e} (bound "
          f"{GEN_TOL}); planted fault, the CLS row's pad mask dropped: text {bad:.3e} (must "
          f"exceed it); bf16 vs fp32 on the card, least cosine image {cos[0]:.5f} text "
          f"{cos[1]:.5f} logits {cos[2]:.5f} (need >= {GEN_COS})")
    assert max(errs) <= GEN_TOL and bad > GEN_TOL and min(cos) >= GEN_COS, (errs, bad, cos)

    _, embs = coca.coca_encode_image(m32.coca, _on(small[:2]), cfg)
    init, step = coca.make_coca_cached_decoder(m32.coca, cfg, 30)

    def full(seqs, e):
        with torch.no_grad():
            return coca.coca_forward(m32.coca, None, torch.as_tensor(seqs).to(DEV), cfg,
                                     image_latent=torch.zeros(1), image_embs=e)["logits"][:, -1]

    _cached_vs_full(GEN_COCA, init, step, full, embs[[0, 1, 0, 1, 0, 1]],
                    cfg.multimodal.vocab_size, 30, rows=6,
                    faults=((lambda: _patched(coca, "_gather_cache", _no_gather),
                             "parent gather skipped"),
                            (_cross_kv_zeroed, "the cross K/V zeroed"),
                            (_cls_first, "the CLS put first")))

    for mode, kw in (("beam_search", dict(num_beams=6)), ("top_p", dict(top_p=0.9))):
        kw = dict(kw, generation_type=mode, seq_len=30, seed=3)
        runs = {}
        for name, model, use_cache, fault in (("cpu", cpu, True, None), ("card", m32, True, None),
                                              ("card full", m32, False, None),
                                              ("card fault", m32, True, _cross_kv_zeroed)):
            if name == "card full" and mode != "beam_search":
                continue
            with _recorded_steps() as steps, (fault() if fault else contextlib.nullcontext()):
                out = model.generate(small, use_cache=use_cache, **kw)
            runs[name] = steps.runs if mode == "beam_search" else _sampled_runs(steps, out)
        _token_gate(f"{GEN_COCA} {mode}, card fp32 vs CPU fp32", runs["cpu"], runs["card"],
                    runs["card fault"])
        if "card full" in runs:
            _token_gate(f"{GEN_COCA} {mode}, card cached vs card full prefix",
                        runs["card full"], runs["card"])
    for prec, model in (("fp32", m32), ("bf16", m16)):
        kw = dict(generation_type="beam_search", num_beams=6, seq_len=30)
        model.generate(images[:1], **kw)
        before = launch_counts()
        with _StepClock(coca, "make_coca_cached_decoder") as clock, \
                _tower_kernels_on_the_card() as lns:
            out = model.generate(images, **kw)
        _expect_launches(f"generate: {GEN_COCA} beam {prec} (K7 K8 alone)", GEN_IMAGES, lns,
                         before)
        assert out.shape[0] == GEN_IMAGES and out.dtype == np.int32
        _rate_line(f"{GEN_COCA} beam 6 {prec}, {GEN_IMAGES} images", GEN_IMAGES, "captions",
                   clock)
    del m32, m16, cpu
    torch.cuda.empty_cache()

    h32 = create_model(GEN_COCA_HF, precision="fp32", seed=0)
    hcpu = create_model(GEN_COCA_HF, device="cpu", seed=0)
    for m in (h32, hcpu):
        _redraw_module(m.coca)
    hcfg = hf_text.hf_text_config(h32.cfg.text.hf_model_name, output_dim=h32.cfg.embed_dim,
                                  proj_type=h32.cfg.text.hf_proj_type)
    hids = rng.randint(2, hcfg.vocab_size, (GEN_CPU_IMAGES, 20)).astype(np.int32)
    hids[1, 12:] = hcfg.pad_token_id
    hsize = h32.cfg.vision.image_size
    himg = rng.randn(GEN_CPU_IMAGES, 3, hsize, hsize).astype(np.float32)

    def enc(m):
        return m.encode_image(himg), m.encode_text(hids)

    ref = enc(hcpu)
    errs = [_rel(a, b) for a, b in zip(enc(h32), ref)]
    with _patched(hf_text, "_position_ids", lambda ids, c: None):
        bad = _rel(enc(h32)[1], ref[1])
    print(f"[generate] {GEN_COCA_HF} (HF text tower {h32.cfg.text.hf_model_name}), encoders "
          f"only: card fp32 vs CPU fp32 max|d|/max|ref| image {errs[0]:.3e} text {errs[1]:.3e} "
          f"(bound {GEN_TOL}); planted fault, BERT's positions 0..L-1 for RoBERTa's: text "
          f"{bad:.3e} (must exceed it)")
    assert max(errs) <= GEN_TOL and bad > GEN_TOL, (errs, bad)
    del h32, hcpu


def _golden_tree(flat, prefix):
    root = {}
    for path, arr in flat.items():
        if not path.startswith(prefix):
            continue
        node = root
        parts = path[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _golden(tok_path):
    """The committed decode golden on the card in fp32 (the four cases of
    tests/test_decode_golden.py): the CPU run gives the golden strings, the
    card run agrees with them on every decided step; a run whose cached step
    takes the position after its own must not."""
    from rs_ov_torch.core.params import blip_decoder_params_from_numpy, blip_vqa_params_from_numpy
    from rs_ov_torch.nn import blip_lm
    from rs_ov_torch.nn.bert import BertConfig
    from rs_ov_torch.nn.blip import BlipConfig
    from rs_ov_torch.nn.blip_vit import BlipVisionConfig
    from rs_ov_torch.text.wordpiece import WordPieceTokenizer

    cfg = BlipConfig(vision=BlipVisionConfig(**GOLDEN_VISION), text=BertConfig(**GOLDEN_TEXT),
                     embed_dim=8)
    flat = dict(np.load(GOLDEN + ".npz"))
    with open(GOLDEN + ".json") as f:
        expect = json.load(f)
    cap_cpu = blip_decoder_params_from_numpy(_golden_tree(flat, "cap/"))
    vqa_cpu = blip_vqa_params_from_numpy(_golden_tree(flat, "vqa/"))
    cap, vqa = cap_cpu.to(DEV), vqa_cpu.to(DEV)
    tok = WordPieceTokenizer(tok_path)
    rng = np.random.RandomState(0)
    images = rng.randn(2, 3, 32, 32).astype(np.float32)
    q_ids = rng.randint(4, 60, size=(2, 6)).astype(np.int32)
    q_ids[:, 0] = tok.enc_token_id
    q_mask = np.ones((2, 6), np.int32)
    q_mask[1, 4:] = 0
    ans_ids = rng.randint(4, 60, size=(4, 5)).astype(np.int32)
    ans_ids[:, 0] = tok.bos_token_id
    ans_mask = np.ones((4, 5), np.int32)
    cases = {
        "beam_captions": lambda m, _: blip_lm.generate_captions(
            m, images, cfg, tok, prompt="a picture of ", max_length=14, min_length=3,
            num_beams=3),
        "nucleus_captions": lambda m, _: blip_lm.generate_captions(
            m, images, cfg, tok, prompt="a picture of ", sample=True, max_length=14,
            min_length=3, rng=np.random.RandomState(7)),
        "vqa_generated_answers": lambda _, m: blip_lm.vqa_generate_answers(
            m, images, q_ids, q_mask, cfg, tok, num_beams=2, max_length=8)}
    for key, run in cases.items():
        outs = {}
        for name, (c, v), fault in (("cpu", (cap_cpu, vqa_cpu), None), ("card", (cap, vqa), None),
                                    ("card fault", (cap, vqa), _step_off_by_one)):
            with _recorded_steps() as steps, (fault() if fault else contextlib.nullcontext()):
                outs[name] = (run(c, v), steps.runs)
        assert outs["cpu"][0] == expect[key], (key, outs["cpu"][0], expect[key])
        d, n, agree = _decided(outs["cpu"][1], outs["card"][1])
        fd, _, fagree = _decided(outs["cpu"][1], outs["card fault"][1])
        print(f"[generate] decode golden {key} on the card fp32: {outs['card'][0]} (golden "
              f"{expect[key]}); agrees on every decided step: {agree} (decided {d}/{n}); "
              f"planted fault, the step's position off by one: agrees {fagree} (must be False)")
        assert agree and (d < n or outs["card"][0] == expect[key]), key
        assert not fagree, (key, "the gate does not see the fault")
    got = blip_lm.vqa_rank_answers(vqa, images, q_ids, q_mask, ans_ids, ans_mask, cfg, k=4)
    print(f"[generate] decode golden vqa_rank_indices on the card fp32: {got.tolist()} (golden "
          f"{expect['vqa_rank_indices']})")
    assert got.tolist() == expect["vqa_rank_indices"]


def phase_generate():
    """Generation at full width on random weights: BLIP base captioning at
    384² (beam 3 / nucleus, max_length 30, min_length 10, 4 images), VQA at
    480² (rank over 128 candidates, beam-3 generate), ITM (itm / itc) and
    NLVR at 384², the caption and retrieval evaluations, coca_ViT-L-14 at
    224² in fp32 and bf16 (encoders, forward, beam 6 / top-p generate,
    seq_len 30) and coca_roberta-ViT-B-32's encoders; then the decode
    golden on the card. The BLIP vocabulary is a synthetic 30522-entry
    vocab.txt in a temporary directory."""
    from rs_ov_torch.text.wordpiece import WordPieceTokenizer, write_synthetic_vocab

    t0 = time.perf_counter()
    rng = np.random.RandomState(9)
    with tempfile.TemporaryDirectory() as tmp:
        tok = WordPieceTokenizer(write_synthetic_vocab(os.path.join(tmp, "vocab.txt"),
                                                       GEN_VOCAB))
    _blip_caption(rng, tok)
    torch.cuda.empty_cache()
    _blip_vqa(rng, tok)
    torch.cuda.empty_cache()
    _blip_itm_nlvr(rng, tok)
    torch.cuda.empty_cache()
    _coca(rng)
    torch.cuda.empty_cache()
    _golden(BLIP_VOCAB)
    print(f"[generate] phase 9 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: training (ROADMAP queue 1 item 10a)
# ---------------------------------------------------------------------------
# Gates, each on a leaf group's gradient (visual / text blocks, the rest of
# each tower, logit_scale; BLIP: its top-level modules):
# (a) one ViT-B/16 step, card fp32 against CPU fp32, batch 8, remat on:
#     loss and per-group max|d|/max|ref| <= TRAIN_TOL;
# (b) remat on against off on the card: <= REMAT_TOL;
# (c) accum_steps 4 against 1 on one batch of 32: <= ACCUM_TOL; planted
#     fault: the scale path live at every micro-step;
# (d) bf16 against fp32 on the card: per-group cosine >= TRAIN_COS, the loss
#     within TRAIN_LOSS_REL; planted fault: matmul32's backward with the
#     right operand's gradient zeroed;
# (e) SigLIP, CoCa, BLIP retrieval / pretrain, caption / VQA / NLVR: one step
#     each at full width in bf16, finite; BLIP retrieval and pretrain: ptr
#     advanced by B, the EMA equal to its formula (<= EMA_TOL), the queue's
#     new columns equal to the new momentum copies' features (<= QUEUE_TOL);
#     planted fault: the EMA after the momentum forward; BLIP retrieval at
#     batch 2 card fp32 against CPU fp32 (argmax negatives) <= TRAIN_TOL;
# (f) a single-rank NCCL group (file:// store): the data-parallel step
#     against the plain one on the card, <= DP_TOL.
TRAIN_TOL, REMAT_TOL, ACCUM_TOL, DP_TOL = 1e-4, 1e-6, 1e-4, 1e-6
TRAIN_COS, TRAIN_LOSS_REL, EMA_TOL, QUEUE_TOL = 0.99, 1e-2, 1e-6, 1e-5
TRAIN_BATCH, ACCUM_BATCH, RATE_BATCH, BLIP_RATE_BATCH = 8, 32, 256, 32
TRAIN_QUEUE, RATE_STEPS = 57600, 3


def _train_clip_cfg():
    from rs_ov_torch.core.config import get_model_config

    return get_model_config("ViT-B-16")


def _train_coca_cfg():
    from rs_ov_torch.core.config import get_coca_config

    return get_coca_config("coca_ViT-B-32")


def _train_blip_cfg():
    from rs_ov_torch.nn.blip import BlipConfig

    return BlipConfig.base(224)


def _clip_batch(cfg, b, seed):
    """Seeded images and token ids, each row's eot the highest id."""
    rng = np.random.RandomState(seed)
    s, ctx, vocab = cfg.vision.image_size, cfg.text.context_length, cfg.text.vocab_size
    images = rng.randn(b, 3, s, s).astype(np.float32)
    texts = rng.randint(1, vocab - 1, size=(b, ctx)).astype(np.int64)
    ends = rng.randint(4, ctx, size=b)
    texts[np.arange(b), ends] = vocab - 1
    texts[np.arange(ctx)[None] > ends[:, None]] = 0
    return images, texts


def _group(name):
    head = name.split(".")[0]
    return f"{head}.blocks" if ".blocks." in name or ".layers." in name else head


def _grad_groups(module):
    out = {}
    for n, p in module.named_parameters():
        if p.requires_grad:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out.setdefault(_group(n), []).append(g.detach().float().reshape(-1).cpu())
    return {k: torch.cat(v) for k, v in out.items()}


def _errs(got, ref):
    return {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max().clamp_min(1e-30))
            for k in ref}


def _coss(got, ref):
    """Cosines summed in float64 (fp32 sums over ~1e8 products drift past 1)."""
    return {k: float(torch.nn.functional.cosine_similarity(got[k].double(), ref[k].double(),
                                                           dim=0)) for k in ref}


def _fmt(d):
    return ", ".join(f"{k} {v:.3e}" for k, v in d.items())


def _clip_params(cfg, seed, bias=False):
    """CPU fp32 trainable CLIP with every leaf drawn anew (``_redraw_module``)."""
    from rs_ov_torch.core.params import init_clip_params

    m = init_clip_params(torch.Generator().manual_seed(seed), cfg)
    if bias:
        m.logit_bias = torch.nn.Parameter(torch.tensor(-10.0), requires_grad=False)
    return _redraw_module(m, seed).requires_grad_()


def _clip_grads(params, cfg, images, texts, **kw):
    from rs_ov_torch.train import step

    fn, _ = step.make_clip_train_step(cfg, **kw)
    for p in params.parameters():
        p.grad = None
    loss = float(fn.backward(params, images, texts))
    return loss, _grad_groups(params)


def _gate(label, value, limit, above=False):
    ok = value >= limit if above else value <= limit
    print(f"[train] {label}: {value:.6e} (limit {'>=' if above else '<='} {limit})")
    assert ok, (label, value, limit)


def _fault(label, value, limit, above=False):
    failed = value < limit if above else value > limit
    print(f"[train] planted fault, {label}: {value:.6e} (must fail the limit "
          f"{'>=' if above else '<='} {limit}: {'fails' if failed else 'PASSES'})")
    assert failed, (label, "the gate does not see the fault", value)


def _clip_gates():
    """Gates (a)-(d) and (f) on ViT-B/16; returns the card fp32 grads of (a)."""
    import copy

    from rs_ov_torch.nn import layers
    from rs_ov_torch.train import step

    cfg = _train_clip_cfg()
    cpu = _clip_params(cfg, 21)
    card = copy.deepcopy(cpu).to(DEV)
    images, texts = _clip_batch(cfg, TRAIN_BATCH, 22)
    t0 = time.perf_counter()
    l_cpu, g_cpu = _clip_grads(cpu, cfg, images, texts)
    cpu_s = time.perf_counter() - t0
    l32, g32 = _clip_grads(card, cfg, images, texts)
    _gate(f"(a) card fp32 vs CPU fp32 loss ({l32:.6f} / {l_cpu:.6f}), relative",
          abs(l32 - l_cpu) / abs(l_cpu), TRAIN_TOL)
    errs = _errs(g32, g_cpu)
    print(f"[train] (a) per-group max|d|/max|ref|: {_fmt(errs)} (CPU step {cpu_s:.1f} s)")
    _gate("(a) worst group", max(errs.values()), TRAIN_TOL)
    _, g_off = _clip_grads(card, cfg, images, texts, remat=False)
    errs = _errs(g_off, g32)
    print(f"[train] (b) remat off vs on: {_fmt(errs)}")
    _gate("(b) worst group", max(errs.values()), REMAT_TOL)

    big_i, big_t = _clip_batch(cfg, ACCUM_BATCH, 23)
    l1, g1 = _clip_grads(card, cfg, big_i, big_t)
    l4, g4 = _clip_grads(card, cfg, big_i, big_t, accum_steps=4)
    errs = _errs(g4, g1)
    print(f"[train] (c) accum 4 vs 1 at batch {ACCUM_BATCH} (losses {l4:.6f} / {l1:.6f}): "
          f"{_fmt(errs)}")
    _gate("(c) loss, relative", abs(l4 - l1) / abs(l1), ACCUM_TOL)
    _gate("(c) worst group", max(errs.values()), ACCUM_TOL)
    with _patched(step, "_scale_live", lambda i: True):
        _, gf = _clip_grads(card, cfg, big_i, big_t, accum_steps=4)
    _fault("(c) the scale path live at every micro-step, worst group",
           max(_errs(gf, g1).values()), ACCUM_TOL)

    l16, g16 = _clip_grads(card, cfg, images, texts, compute_dtype=torch.bfloat16)
    coss = _coss(g16, g32)
    print(f"[train] (d) bf16 vs fp32 on the card, per-group cosine: "
          + ", ".join(f"{k} {v:.6f}" for k, v in coss.items())
          + " (the backward's products: bf16 cotangent x bf16 operand on the tensor cores, "
            "fp32 sums, cast to the operand's dtype)")
    _gate(f"(d) loss ({l16:.6f} / {l32:.6f}), relative", abs(l16 - l32) / abs(l32),
          TRAIN_LOSS_REL)
    _gate("(d) least group cosine", min(coss.values()), TRAIN_COS, above=True)

    def right_zeroed(a, b, g, need_a, need_b):
        ga, gb = real(a, b, g, need_a, need_b)
        return ga, None if gb is None else torch.zeros_like(gb)

    real = layers._matmul32_grads
    with _patched(layers, "_matmul32_grads", right_zeroed):
        _, gf = _clip_grads(card, cfg, images, texts, compute_dtype=torch.bfloat16)
    _fault("(d) matmul32's right-operand gradient zeroed, least group cosine",
           min(_coss(gf, g32).values()), TRAIN_COS, above=True)

    from rs_ov_torch.parallel.mesh import initialize_distributed, make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", world_size=1, rank=0, device=DEV)
        try:
            mesh = make_mesh(1, 1, device_type=DEV.type)
            ld, gd = _clip_grads(card, cfg, images, texts, mesh=mesh)
        finally:
            torch.distributed.destroy_process_group()
    errs = _errs(gd, g32)
    print(f"[train] (f) one-rank {'NCCL' if DEV.type == 'cuda' else 'gloo'} data-parallel "
          f"step vs plain: loss {ld:.6f} / {l32:.6f}, {_fmt(errs)}")
    _gate("(f) worst group", max(errs.values()), DP_TOL)
    del cpu, card
    torch.cuda.empty_cache()


def _finite(label, losses, module):
    vals = [float(x) for x in (losses if isinstance(losses, (tuple, list)) else [losses])]
    grads = all(bool(torch.isfinite(p).all()) for p in module.parameters())
    print(f"[train] (e) {label}: losses {', '.join(f'{v:.4f}' for v in vals)}; leaves finite "
          f"after the update {grads}")
    assert all(np.isfinite(vals)) and grads, label


def _other_clip_steps():
    """(e): SigLIP on ViT-B/16 and the CoCa step, one bf16 step each."""
    from rs_ov_torch.core.params import init_coca_params
    from rs_ov_torch.train import step

    cfg = _train_clip_cfg()
    params = _clip_params(cfg, 24, bias=True).to(DEV)
    fn, init = step.make_clip_train_step(cfg, compute_dtype=torch.bfloat16, loss="siglip")
    images, texts = _clip_batch(cfg, TRAIN_BATCH, 25)
    _, _, loss = fn(params, init(params), images, texts)
    _finite("SigLIP ViT-B/16 step", loss, params)
    del params
    ccfg = _train_coca_cfg()
    coca = _redraw_module(init_coca_params(torch.Generator().manual_seed(26), ccfg),
                          26).requires_grad_().to(DEV)
    fn, init = step.make_coca_train_step(ccfg, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(27)
    images = rng.randn(TRAIN_BATCH, 3, ccfg.vision.image_size,
                       ccfg.vision.image_size).astype(np.float32)
    texts = rng.randint(1, ccfg.text.vocab_size, (TRAIN_BATCH, ccfg.text.context_length))
    _, _, parts = fn(coca, init(coca), images, texts)
    _finite("CoCa coca_ViT-B-32 step (contrastive, caption)", parts, coca)
    del coca
    torch.cuda.empty_cache()


def _blip_batch(cfg, b, seed, ln=30):
    rng = np.random.RandomState(seed)
    s = cfg.vision.image_size
    ids = rng.randint(4, cfg.text.vocab_size - 2, size=(b, ln)).astype(np.int64)
    mask = np.ones((b, ln), np.int64)
    mask[0, ln // 2:] = 0
    ids[0, ln // 2:] = 0
    return (rng.randn(b, 3, s, s).astype(np.float32), ids, mask,
            np.arange(b, dtype=np.int64) // 2)  # pairs of one image id


def _blip_tokens(cfg, pretrain):
    """[ENC] and [DEC]: the vocabulary's last two ids (30523, 30522 in BLIP's)."""
    v = cfg.text.vocab_size
    return {"enc_token_id": v - 1, **({"bos_token_id": v - 2} if pretrain else {})}


def _blip_state(pretrain, seed, queue=None):
    from rs_ov_torch.train import blip_pretrain, blip_retrieval

    cfg = _train_blip_cfg()
    init = (blip_pretrain.init_blip_pretrain_state if pretrain
            else blip_retrieval.init_blip_retrieval_state)
    state = init(torch.Generator().manual_seed(seed), cfg, queue_size=queue or TRAIN_QUEUE)
    _redraw_module(state["params"], seed)
    _redraw_module(state["params_m"], seed + 1)  # apart from params, so the EMA moves it
    return cfg, state


def _state_to(state, dev):
    state["params"].to(dev)
    state["params_m"].to(dev)
    state["queue"] = {k: v.to(dev) for k, v in state["queue"].items()}
    return state


def _blip_step_checks(label, pretrain, ema_late=False):
    """One bf16 step: ptr advanced by B, the EMA equal to its formula, the
    new queue columns equal to the new momentum copies' features. With
    ``ema_late`` the step runs with the EMA applied after it (the fault)."""
    from rs_ov_torch.core.params import cast_floating
    from rs_ov_torch.train import blip_pretrain, blip_retrieval

    cfg, state = _blip_state(pretrain, 31)
    state = _state_to(state, DEV)
    make = (blip_pretrain.make_blip_pretrain_train_step if pretrain
            else blip_retrieval.make_blip_retrieval_train_step)
    fn, init = make(cfg, compute_dtype=torch.bfloat16, **_blip_tokens(cfg, pretrain))
    opt = init(state["params"])
    images, ids, mask, idx = _blip_batch(cfg, TRAIN_BATCH, 32)
    live = dict(state["params"].named_parameters())
    pairs = [(pm, live[n]) for n, pm in state["params_m"].named_parameters()]
    with torch.no_grad():
        want = [(pm.float() * 0.995 + p.float() * 0.005).to(pm.dtype) for pm, p in pairs]
    ptr0 = int(state["queue"]["ptr"])
    gen = torch.Generator(device=DEV).manual_seed(33)
    if ema_late:
        with _patched(blip_retrieval, "_ema_update", lambda pairs, m: None):
            _, _, losses = fn(state, opt, images, ids, mask, idx, 0.4, gen)
        with torch.no_grad():
            for (pm, _), w in zip(pairs, want):
                pm.copy_(w)
    else:
        _, _, losses = fn(state, opt, images, ids, mask, idx, 0.4, gen)
    ema = max(float((pm - w).abs().max()) for (pm, _), w in zip(pairs, want))
    with torch.no_grad():
        x = torch.as_tensor(images).to(DEV, torch.bfloat16)
        _, fm, tm = blip_retrieval._encode(cast_floating(state["params_m"], torch.bfloat16), x,
                                           torch.as_tensor(ids).to(DEV),
                                           torch.as_tensor(mask).to(DEV), cfg)
    cols = slice(ptr0, ptr0 + TRAIN_BATCH)
    queue = max(float((state["queue"]["image"][:, cols] - fm.t()).abs().max()),
                float((state["queue"]["text"][:, cols] - tm.t()).abs().max()))
    ptr = int(state["queue"]["ptr"])
    if not ema_late:
        _finite(label, losses, state["params"])
        print(f"[train] (e) {label}: ptr {ptr0} -> {ptr} (B {TRAIN_BATCH})")
        assert ptr == (ptr0 + TRAIN_BATCH) % TRAIN_QUEUE
        _gate(f"(e) {label} EMA against its formula, max|d|", ema, EMA_TOL)
        _gate(f"(e) {label} queue columns against the momentum features, max|d|", queue,
              QUEUE_TOL)
    else:
        _fault(f"(e) {label} with the EMA after the momentum forward, queue columns max|d|",
               queue, QUEUE_TOL)
    del state, opt
    torch.cuda.empty_cache()


def _blip_card_vs_cpu():
    """(e): BLIP retrieval at batch 2, card fp32 against CPU fp32, argmax negatives."""
    import copy

    from rs_ov_torch.train import blip_retrieval

    cfg, cpu = _blip_state(False, 41)
    card = _state_to({"params": copy.deepcopy(cpu["params"]),
                      "params_m": copy.deepcopy(cpu["params_m"]),
                      "queue": {k: v.clone() for k, v in cpu["queue"].items()}}, DEV)
    batch = _blip_batch(cfg, 2, 42)
    batch = (batch[0], batch[1], batch[2], np.asarray([0, 1]))
    out = {}
    with _patched(blip_retrieval, "_sample_negatives", lambda logits, gen: logits.argmax(1)):
        for name, state in (("cpu", cpu), ("card", card)):
            fn, _ = blip_retrieval.make_blip_retrieval_train_step(cfg,
                                                                  **_blip_tokens(cfg, False))
            losses = fn.backward(state, *batch, 0.4, None)
            out[name] = ([float(x) for x in losses], _grad_groups(state["params"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["card"][0], out["cpu"][0]))
    errs = _errs(out["card"][1], out["cpu"][1])
    print(f"[train] (e) BLIP retrieval batch 2, card fp32 vs CPU fp32: losses {out['card'][0]} / "
          f"{out['cpu'][0]}; {_fmt(errs)}")
    _gate("(e) BLIP card vs CPU loss, relative", rel, TRAIN_TOL)
    _gate("(e) BLIP card vs CPU worst group", max(errs.values()), TRAIN_TOL)
    del cpu, card
    torch.cuda.empty_cache()


def _blip_lm_steps():
    """(e): the caption / VQA / NLVR losses, one bf16 step each at full width."""
    from rs_ov_torch.core.params import cast_floating
    from rs_ov_torch.nn import blip_lm
    from rs_ov_torch.train import optim

    cfg = _train_blip_cfg()
    images, ids, mask, _ = _blip_batch(cfg, TRAIN_BATCH, 51)
    rng = np.random.RandomState(52)
    runs = {
        "caption": (blip_lm.init_blip_decoder_params, lambda p: blip_lm.blip_caption_loss(
            p, images, ids, mask, cfg)),
        "VQA": (blip_lm.init_blip_vqa_params, lambda p: blip_lm.blip_vqa_loss(
            p, images, ids, mask, ids[:, :8], mask[:, :8], np.arange(TRAIN_BATCH),
            np.ones(TRAIN_BATCH, np.float32), cfg)),
        "NLVR": (blip_lm.init_blip_nlvr_params, lambda p: blip_lm.blip_nlvr_forward(
            p, np.concatenate([images, images[::-1]]), ids, mask, cfg,
            targets=rng.randint(0, 2, TRAIN_BATCH))),
    }
    for label, (init, loss_fn) in runs.items():
        params = _redraw_module(init(torch.Generator().manual_seed(53), cfg),
                                53).requires_grad_().to(DEV)
        opt = optim.adamw(1e-5).init(params)
        loss = loss_fn(cast_floating(params, torch.bfloat16))
        loss.backward()
        opt.step()
        _finite(f"BLIP {label} loss step", loss.detach(), params)
        del params, opt
        torch.cuda.empty_cache()


def _clip_step_flops(cfg, b):
    """Model FLOPs of one CLIP step (forward + backward = 3 forwards; the
    remat recompute not counted): 2 per multiply-add of every product."""
    def tower(tokens, width, layers, mlp_ratio=4.0):
        per_token = 2 * (4 * width * width + 2 * mlp_ratio * width * width) + 4 * tokens * width
        return tokens * layers * per_token

    v, t = cfg.vision, cfg.text
    n = (v.image_size // v.patch_size) ** 2
    fwd = (tower(n + 1, v.width, v.layers, v.mlp_ratio) + 2 * n * 3 * v.patch_size ** 2 * v.width
           + 2 * v.width * cfg.embed_dim
           + tower(t.context_length, t.width, t.layers, t.mlp_ratio) + 2 * t.width * cfg.embed_dim)
    return 3 * b * fwd


def _train_rates():
    """pairs/s and peak memory of the ViT-B/16 step (remat on) in bf16 and
    fp32 at batch RATE_BATCH, its model FLOPs against the card's peaks;
    BLIP retrieval examples/s at batch BLIP_RATE_BATCH."""
    from rs_ov_torch.train import blip_retrieval, step

    cfg = _train_clip_cfg()
    images, texts = _clip_batch(cfg, RATE_BATCH, 61)
    images, texts = torch.from_numpy(images).to(DEV), torch.from_numpy(texts).to(DEV)
    flops = _clip_step_flops(cfg, RATE_BATCH)
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS), (None, FP32_FLOPS)):
        params = _clip_params(cfg, 62).to(DEV)
        fn, init = step.make_clip_train_step(cfg, compute_dtype=dtype)
        opt = init(params)
        fn(params, opt, images, texts)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(RATE_STEPS):
            fn(params, opt, images, texts)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / RATE_STEPS
        name = "bf16" if dtype else "fp32"
        print(f"[train] rate: ViT-B/16 CLIP step, {name}, batch {RATE_BATCH}, remat on: "
              f"{RATE_BATCH / dt:.2f} pairs/s ({dt * 1e3:.1f} ms a step, host clock over "
              f"{RATE_STEPS} steps after a warm-up), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, model FLOPs "
              f"{flops / 1e12:.3f} T a step: {flops / dt / 1e12:.1f} TFLOP/s, "
              f"{flops / dt / peak:.4f} of the {peak / 1e12:.0f} TFLOP/s {name} peak, "
              f"on {CARD['smi']}")
        del params, opt
        torch.cuda.empty_cache()
    del images, texts
    bcfg, state = _blip_state(False, 63)
    state = _state_to(state, DEV)
    fn, init = blip_retrieval.make_blip_retrieval_train_step(bcfg, compute_dtype=torch.bfloat16,
                                                             **_blip_tokens(bcfg, False))
    opt = init(state["params"])
    batch = [torch.as_tensor(x).to(DEV) for x in _blip_batch(bcfg, BLIP_RATE_BATCH, 64)]
    gen = torch.Generator(device=DEV).manual_seed(65)
    fn(state, opt, *batch, 0.4, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RATE_STEPS):
        fn(state, opt, *batch, 0.4, gen)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / RATE_STEPS
    print(f"[train] rate: BLIP base retrieval step, bf16, batch {BLIP_RATE_BATCH}, queue "
          f"{TRAIN_QUEUE}: {BLIP_RATE_BATCH / dt:.2f} examples/s ({dt * 1e3:.1f} ms a step), "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on "
          f"{CARD['smi']}")
    del state, opt
    torch.cuda.empty_cache()


def phase_train():
    """Training at full width on drawn weights: gates (a)-(f) with their
    planted faults, then the rates. No kernel but K7 and K8 is launched: K7
    once for each LayerNorm on the card, K8 once for each linear on the card,
    with a gradient or without."""
    t0 = time.perf_counter()
    before = launch_counts()
    with _tower_kernels_on_the_card() as lns:
        _clip_gates()
        _other_clip_steps()
        _blip_step_checks("BLIP retrieval step", pretrain=False)
        _blip_step_checks("BLIP retrieval step", pretrain=False, ema_late=True)
        _blip_step_checks("BLIP pretrain step", pretrain=True)
        _blip_card_vs_cpu()
        _blip_lm_steps()
        _train_rates()
    want = {**before, **{k: before[k] + n for k, n in lns.items()}}
    print(f"[train] K7 launched {launch_counts()['layer_norm'] - before['layer_norm']} "
          f"times, once for each of the {lns['layer_norm']} LayerNorms on the card; K8 "
          f"{launch_counts()['linear_epilogue'] - before['linear_epilogue']} times, once for "
          f"each of the {lns['linear_epilogue']} linears on the card")
    assert launch_counts() == want, "a kernel other than K7 and K8 launched in training"
    print(f"[train] phase 10 took {time.perf_counter() - t0:.1f} s")


# Phase 11: the serving export, the mesh on one card, the profiler.
SERVE_TOL = 1e-3  # served probabilities against live (expected 0: the same kernels)
MESH_TOL = 1e-5   # a one-rank mesh against the meshless segmentor
# the served program in a fresh interpreter that imports rs_ov_torch's loader
# alone: its output and launches, and whether the segmentor, jax or rs_ov
# came in with it
SERVE_CHILD = """
import json, sys
import numpy as np
from rs_ov_torch.pipeline.export import load_predict
from rs_ov_torch.kernels.build import launch_counts
path, image, out, device = sys.argv[1:5]
fn = load_predict(path, device=device)
res = fn(np.load(image))
np.savez(out, probs=res["probs"].float().cpu().numpy(), pred=res["pred_sem_seg"].cpu().numpy())
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "rs_ov")
              or m == "rs_ov_torch.pipeline.segmentor")
print(json.dumps({"launches": launch_counts(), "modules": mods}))
"""


def _serve_gate(label, probs, pred, live):
    """(max|probs - live|, decided agreement, decided share) of a served
    output against the live one; the gate: the probabilities within
    SERVE_TOL and every pixel the live run decides (margin >= TAU) given
    its label."""
    err = (probs.float() - live["seg_logits"].float()).abs().max().item()
    _, agree, share = decided_agreement(pred, live["pred_sem_seg"], live["seg_logits"], TAU)
    ok = err <= SERVE_TOL and agree == 1.0
    print(f"[serve] {label}: max|probs - live| {err:.3e} (limit {SERVE_TOL}), labels equal on "
          f"{agree:.6f} of the decided pixels (share {share:.4f}; limit 1.0): "
          f"{'passes' if ok else 'FAILS'}")
    return ok


def _export_timed(seg, path):
    from rs_ov_torch.pipeline.export import export_predict, load_predict

    t0 = time.perf_counter()
    export_predict(seg, (512, 512), path)
    t1 = time.perf_counter()
    fn = load_predict(path, device=DEV)
    t2 = time.perf_counter()
    return fn, t1 - t0, t2 - t1


def _live_and_served(seg, fn, image):
    """(live result, its launches, served result, its launches)."""
    before = launch_counts()
    live = seg.predict_raw(image[None])[0]
    torch.cuda.synchronize()
    live_n, before = _since(before), launch_counts()
    served = fn(image)
    torch.cuda.synchronize()
    return live, live_n, served, _since(before)


def _serve_route(label, seg, images, want, tmp, rows):
    """Export and load ``seg``'s 512² program, then each image live and
    served: the gate, equal launch counts (``want`` per request), and the
    tiles/s of both in turns. Returns the loaded program."""
    path = os.path.join(tmp, label.split()[0] + ".rsovt")
    fn, export_s, load_s = _export_timed(seg, path)
    nodes = [str(n.target) for n in fn.program.graph.nodes if n.op == "call_function"]
    print(f"[serve] {label}: exported in {export_s:.2f} s ({len(nodes)} nodes: "
          f"{sum(t.startswith('rs_ov.') for t in nodes)} kernel operators, "
          f"{nodes.count('aten._assert_tensor_metadata.default')} metadata asserts, "
          f"{sum(t.startswith('aten.to.') for t in nodes)} casts), "
          f"{os.path.getsize(path)} bytes, loaded in {load_s:.2f} s")
    want = {**dict.fromkeys(KERNELS, 0), **want}
    for i, img in enumerate(images):
        live, live_n, served, served_n = _live_and_served(seg, fn, img)
        print(f"[serve] {label} image {i}: launches live {live_n}, served {served_n}")
        assert live_n == served_n == want, (label, live_n, served_n, want)
        assert _serve_gate(f"{label} image {i}", served["probs"], served["pred_sem_seg"], live)
    for k in KERNELS:
        if want[k]:
            rows[k].setdefault("launches_by_path", {})[f"served {label}"] = served_n[k]
    secs = {"live": [], "served": []}
    for turn in ("live", "served", "served", "live", "live", "served"):
        t0 = time.perf_counter()
        (seg.predict_raw(images[0][None]) if turn == "live" else fn(images[0]))
        torch.cuda.synchronize()
        secs[turn].append(time.perf_counter() - t0)
    live_s, served_s = (float(np.median(secs[k])) for k in ("live", "served"))
    print(f"[serve] {label}: 512² tiles/s live {1 / live_s:.3f}, served {1 / served_s:.3f} "
          f"(seconds in turns: live {[round(x, 4) for x in secs['live']]}, served "
          f"{[round(x, 4) for x in secs['served']]}) on {CARD['smi']}")
    return fn, path


def _served_in_a_fresh_process(path, image, live, tmp):
    """load_predict in a new interpreter: its output against the live one,
    K1 / K2 / K3 / K7 / K8 launched as in this process, no segmentor module loaded."""
    img_path, out = os.path.join(tmp, "image.npy"), os.path.join(tmp, "child.npz")
    np.save(img_path, image)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", SERVE_CHILD, path, img_path, out, DEV.type],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    info = json.loads(run.stdout.strip().splitlines()[-1])
    with np.load(out) as f:
        probs, pred = torch.from_numpy(f["probs"]), torch.from_numpy(f["pred"])
    print(f"[serve] fresh process: {time.perf_counter() - t0:.2f} s, launches K1 K2 K3 K7 K8 "
          f"{info['launches']}, modules of the segmentor / jax / rs_ov loaded: "
          f"{info['modules']}")
    assert info["modules"] == [] and info["launches"] == {
        **dict.fromkeys(KERNELS, 0), "range_logits": 2 * CHUNKS, "jbu_epilogue": CHUNKS,
        "jbu_epilogue_classify": CHUNKS, **_per_pass(1, "ViT-B-16")}, info
    assert _serve_gate("fresh process", probs, pred, {k: v.cpu() for k, v in live.items()})


def _mesh_on_one_card(seg, images):
    """SegmentorEx(mesh=make_mesh(1, 1)) on a one-rank NCCL group against the
    meshless segmentor: predict_raw and predict_batch_raw, labels equal,
    probabilities within MESH_TOL, the same launches."""
    from rs_ov_torch.parallel.mesh import initialize_distributed, make_mesh
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    batch = np.stack(images)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", world_size=1, rank=0, device=DEV)
        try:
            meshed = SegmentorEx(**_base_model_cfg(), device=DEV, mesh=make_mesh(
                1, 1, device_type=DEV.type), query_features=seg.query_features.cpu().numpy())
            for entry in ("predict_raw", "predict_batch_raw"):
                counts, outs = [], []
                for s in (seg, meshed):
                    before = launch_counts()
                    outs.append(getattr(s, entry)(batch[:1] if entry == "predict_raw"
                                                  else batch))
                    torch.cuda.synchronize()
                    counts.append(_since(before))
                err = max((a["seg_logits"].float() - b["seg_logits"].float()).abs().max().item()
                          for a, b in zip(*outs))
                same = all(torch.equal(a["pred_sem_seg"], b["pred_sem_seg"])
                           for a, b in zip(*outs))
                print(f"[serve] mesh (1, 1) on one NCCL rank, {entry} of {len(outs[0])} "
                      f"image(s): max|probs - meshless| {err:.3e} (limit {MESH_TOL}), labels "
                      f"equal {same}, launches {counts[1]} (meshless {counts[0]})")
                assert err <= MESH_TOL and same and counts[0] == counts[1], entry
        finally:
            torch.distributed.destroy_process_group()
    print("[serve] one card holds one NCCL rank: several ranks are shown by the CPU tests "
          "(tests/test_torch_segmentor_mesh.py, 2 gloo ranks)")


def _profiled_request(seg, fn, image, tmp):
    """utils.profiling.trace around one annotated live request and one
    served: each trace file names its span and the kernels K1, K2 and K3,
    the served one K1's operator too, the live one no operator (its eager
    calls launch the kernels directly); prints each one's kernel launches,
    their device ms and the span's host ms."""
    import glob

    from rs_ov_torch.utils.profiling import annotate, trace

    for label, call in (("live", lambda: seg.predict_raw(image[None])),
                        ("served", lambda: fn(image))):
        span = f"rs_ov_serve_{label}"
        logdir = os.path.join(tmp, f"trace_{label}")
        with trace(logdir):
            annotate(span)(call)()
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        want = {span: True, "rs_ov::range_logits": label == "served", "range_logits_kernel": True,
                "jbu_epilogue_kernel": True, "jbu_classify_kernel": True}
        found = {k: any(k in n for n in names) for k in want}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        host_ms = max(e.get("dur", 0) for e in events if e.get("name") == span) / 1e3
        print(f"[serve] trace of one {label} request ({os.path.basename(files[0])}): "
              f"{len(kernels)} kernel launches, {sum(e['dur'] for e in kernels) / 1e3:.3f} "
              f"device ms, span {host_ms:.3f} host ms; found {found}")
        assert found == want, (label, found, want)


@contextlib.contextmanager
def _one_weight_changed(seg, seed=5):
    """One drawn weight of the tower (the first block's MLP output
    projection, which every later block reads) moved by 0.05 x N(0, 1),
    restored afterwards."""
    w = seg.clip.visual.blocks[0].mlp.c_proj_w
    saved = w.detach().clone()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        w += (0.05 * torch.randn(w.shape, generator=g)).to(w.device, w.dtype)
    try:
        yield
    finally:
        with torch.no_grad():
            w.copy_(saved)


def phase_serve(rows):
    """(a) the export on the default and the fp32 channel-first route, a
    fresh process, a planted fault; (b) a one-rank mesh; (c) a profiled
    live and served request."""
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    t0 = time.perf_counter()
    seg = SegmentorEx(**_base_model_cfg(), device=DEV)
    seg32 = SegmentorEx(**_base_model_cfg(), param_dtype=torch.float32, device=DEV,
                        query_features=seg.query_features.cpu().numpy())
    rng = np.random.RandomState(11)
    images = [rng.randint(0, 256, (512, 512, 3), np.uint8) for _ in range(3)]
    s = seg.jbu_stages
    with tempfile.TemporaryDirectory() as tmp:
        served, path = _serve_route("bf16 channel-last (K1 K2 K3 K7 K8)", seg, images[:2], {
            "range_logits": s * CHUNKS, "jbu_epilogue": (s - 1) * CHUNKS,
            "jbu_epilogue_classify": CHUNKS, **_per_pass(1, "ViT-B-16")}, tmp, rows)
        live = seg.predict_raw(images[0][None])[0]
        _served_in_a_fresh_process(path, images[0], live, tmp)
        _serve_route("fp32 channel-first (K1 K4b K7 K8)", seg32, images[:1], {
            "range_logits": s * CHUNKS, "adaptive_conv_tapmajor.f32": s * CHUNKS,
            **_per_pass(1, "ViT-B-16", fp32=True)}, tmp, rows)
        del seg32
        torch.cuda.empty_cache()
        with _one_weight_changed(seg):
            fault, _, _ = _export_timed(seg, os.path.join(tmp, "fault.rsovt"))
        out = fault(images[0])
        failed = not _serve_gate("planted fault (an artifact exported after one drawn weight "
                                 "was changed)", out["probs"], out["pred_sem_seg"], live)
        assert failed, "the served gate does not see the changed weight"
        del fault
        _mesh_on_one_card(seg, images)
        _profiled_request(seg, served, images[0], tmp)
    print(f"[serve] phase 11 took {time.perf_counter() - t0:.1f} s")


def main():
    phase_device()
    phase_build()
    rows = phase_kernels()
    phase_e2e(phase_slice(rows))
    phase_eval(rows)
    phase_entry(rows)
    phase_timm()
    phase_generate()
    torch.cuda.empty_cache()
    phase_train()
    torch.cuda.empty_cache()
    phase_serve(rows)
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
