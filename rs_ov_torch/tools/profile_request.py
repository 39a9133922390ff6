"""Where a request's device time goes, from one ``torch.profiler`` pass.

    python3 -m rs_ov_torch.tools.profile_request [--requests 3] [--fused-attn]
        [--route default|fp32-channel-first|bf16-channel-first]
        [--clip-type CLIP] [--vit-type ViT-B/16] [--gem] [--upsampler NAME]
        [--encode-image ARCH [--batch 64]] [--generate blip-caption|coca]
        [--train clip|blip-retrieval [--batch N]]
        [--out work_dirs/profile_request.json]

Builds ``SegmentorEx`` from ``configs/base_config.py`` (CLIP ViT-B/16 at full
width, random weights from its seed, the Potsdam vocabulary) on the card,
or the same config on another tower (``--clip-type`` / ``--vit-type``; BLIP
with the committed WordPiece vocabulary) or GEM (``--gem``: gem_depth 7 with
its residual), both without the global CLS debias, which they refuse,
runs two warm-up requests of one 512x512 image, then profiles ``--requests``
more, and prints the device time per request split by kernel group (the
port's kernels by name, GEMMs, elementwise casts and copies, softmax and
reductions, the rest), the device's busy share of the profiled wall time,
the peak device memory and the card's name and power limit. ``--route``:
``default`` is the card's default precision (bf16, the channel-last JBU
route: K1, K2, K3), ``fp32-channel-first`` the weights in fp32
(``param_dtype=torch.float32``: K1, K4b), ``bf16-channel-first`` bf16 with
``RS_OV_JBU_FUSED=0`` (K1, K4a). With ``--fused-attn`` the last block's
attention takes K6 (``RS_OV_FUSED_ATTN=1``); with ``RS_OV_JBU_FUSED_RANGE=1``
in the environment the bf16 channel-last stages take the fused-range
kernels K5a and K5b. ``--upsampler`` names the SimFeatUp upsampler
(``sim_feat_up_cfg["model_name"]``: ``jbu_stack``, ``bilinear`` or an
alternate, ``resize_conv``, ``ifa``, ``carafe``, ``sapa``). With
``--encode-image ARCH`` it profiles ``create_model(ARCH)``'s
``encode_image`` on ``--batch`` random images at the arch's image size
instead (a timm tower too, e.g. ``convnext_large_d``; one call a "request";
the route's precision, bf16 unless ``fp32-channel-first``). With
``--generate`` one "request" is one generate call on one image, in the
route's precision: ``blip-caption`` BLIP base's caption decoder at 384²
(beam 3, max_length 30, min_length 10, a synthetic 30522-entry vocabulary),
``coca`` ``create_model("coca_ViT-L-14")`` at 224² (beam search, 6 beams,
seq_len 30); random weights from seed 0. Its busy share is the decode
loop's: each step ends with the logits copied to the host for the beam.
With ``--train`` one "request" is one training step at ``--batch`` in the
route's precision (bf16 compute over fp32 masters unless
``fp32-channel-first``): ``clip`` the ViT-B/16 CLIP step (remat on, AdamW),
``blip-retrieval`` BLIP base's retrieval step at 224² with its 57600-slot
queue; random weights from seed 0, random batches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

# kernel-name substrings of each group, first match wins
GROUPS = (
    ("K5b jbu_epilogue_fused_classify", ("jbu_classify_kernel<true, true>",
                                         "jbu_classify_kernel<false, true>")),
    ("K5a jbu_epilogue_fused", ("jbu_epilogue_kernel<true, true>",
                                "jbu_epilogue_kernel<false, true>")),
    ("K3 jbu_epilogue_classify", ("jbu_classify_kernel",)),
    ("K2 jbu_epilogue", ("jbu_epilogue_kernel",)),
    ("K1 range_logits", ("range_logits",)),
    ("K6 fused_selfself_attention", ("selfself_attention",)),
    ("K4a adaptive_conv (bf16)", ("adaptive_conv_kernel<__nv_bfloat16",)),
    ("K4b adaptive_conv (fp32)", ("adaptive_conv_kernel<float",)),
    ("K7 layer_norm", ("layer_norm_warp", "layer_norm_block")),
    ("K8 linear_epilogue", ("linear_epilogue_kernel",)),
    ("GEMMs", ("gemm", "Gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_", "sm80_")),
    ("softmax", ("softmax", "Softmax", "SoftMax")),
    ("reductions", ("reduce", "Reduce")),
    ("casts and copies", ("copy", "Copy", "cast", "Cast", "convert")),
    ("other elementwise", ("elementwise", "Elementwise")),
)


ROUTES = ("default", "fp32-channel-first", "bf16-channel-first")


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _generate_run(which: str, dtype: torch.dtype):
    """One generate call on one random image, on the card in ``dtype``."""
    rng = np.random.RandomState(1)
    if which == "coca":
        from rs_ov_torch.factory import create_model

        model = create_model("coca_ViT-L-14", precision="fp32" if dtype == torch.float32
                             else "bf16")
        image = rng.randn(1, 3, 224, 224).astype(np.float32)
        return lambda: model.generate(image, generation_type="beam_search", num_beams=6,
                                      seq_len=30)
    import tempfile

    from rs_ov_torch.nn.blip import BlipConfig
    from rs_ov_torch.nn.blip_lm import generate_captions, init_blip_decoder_params
    from rs_ov_torch.text.wordpiece import WordPieceTokenizer, write_synthetic_vocab

    cfg = BlipConfig.base(384)
    params = init_blip_decoder_params(torch.Generator().manual_seed(0), cfg).to("cuda", dtype)
    with tempfile.TemporaryDirectory() as tmp:
        tok = WordPieceTokenizer(write_synthetic_vocab(f"{tmp}/vocab.txt"))
    image = rng.randn(1, 3, 384, 384).astype(np.float32)
    return lambda: generate_captions(params, image, cfg, tok, num_beams=3, max_length=30,
                                     min_length=10)


def _train_run(which: str, dtype: torch.dtype, batch: int):
    """One training step at ``batch`` on random data, on the card."""
    rng = np.random.RandomState(1)
    gen = torch.Generator().manual_seed(0)
    compute = None if dtype == torch.float32 else dtype
    if which == "clip":
        from rs_ov_torch.core.config import get_model_config
        from rs_ov_torch.core.params import init_clip_params
        from rs_ov_torch.train.step import make_clip_train_step

        cfg = get_model_config("ViT-B-16")
        params = init_clip_params(gen, cfg).requires_grad_().to("cuda")
        fn, init = make_clip_train_step(cfg, compute_dtype=compute)
        opt = init(params)
        size = cfg.vision.image_size
        images = torch.randn(batch, 3, size, size, generator=gen).to("cuda")
        texts = torch.from_numpy(rng.randint(1, cfg.text.vocab_size,
                                             (batch, cfg.text.context_length))).to("cuda")
        return lambda: fn(params, opt, images, texts)
    from rs_ov_torch.nn.blip import BlipConfig
    from rs_ov_torch.train.blip_retrieval import (init_blip_retrieval_state,
                                                  make_blip_retrieval_train_step)

    cfg = BlipConfig.base(224)
    state = init_blip_retrieval_state(gen, cfg)
    state["params"].to("cuda")
    state["params_m"].to("cuda")
    state["queue"] = {k: v.to("cuda") for k, v in state["queue"].items()}
    fn, init = make_blip_retrieval_train_step(cfg, compute_dtype=compute)
    opt = init(state["params"])
    images = torch.randn(batch, 3, 224, 224, generator=gen).to("cuda")
    ids = torch.from_numpy(rng.randint(4, cfg.text.vocab_size - 2, (batch, 30))).to("cuda")
    idx = torch.arange(batch, device="cuda")
    sampler = torch.Generator(device="cuda").manual_seed(2)
    return lambda: fn(state, opt, images, ids, torch.ones_like(ids), idx, 0.4, sampler)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--fused-attn", action="store_true")
    ap.add_argument("--route", choices=ROUTES, default="default")
    ap.add_argument("--clip-type", default="CLIP")
    ap.add_argument("--vit-type", default="ViT-B/16")
    ap.add_argument("--gem", action="store_true")
    ap.add_argument("--upsampler", default=None)
    ap.add_argument("--encode-image", default=None, metavar="ARCH")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--generate", choices=("blip-caption", "coca"), default=None)
    ap.add_argument("--train", choices=("clip", "blip-retrieval"), default=None)
    ap.add_argument("--out", default=os.path.join("work_dirs", "profile_request.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from rs_ov_torch.evalsuite.config import load_config
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if opts.fused_attn:
        os.environ["RS_OV_FUSED_ATTN"] = "1"
    if opts.route == "bf16-channel-first":
        os.environ["RS_OV_JBU_FUSED"] = "0"
    dtype = torch.float32 if opts.route == "fp32-channel-first" else torch.bfloat16
    if opts.train:
        run = _train_run(opts.train, dtype, opts.batch)
    elif opts.generate:
        run = _generate_run(opts.generate, dtype)
    elif opts.encode_image:
        from rs_ov_torch.factory import create_model

        model = create_model(opts.encode_image, precision="fp32" if opts.route ==
                             "fp32-channel-first" else "bf16")
        size = model.cfg.vision.image_size
        batch = torch.randn(opts.batch, 3, size, size, generator=torch.Generator().manual_seed(1))
        batch = batch.to("cuda", model.dtype)

        def run():
            model.encode_image(batch)
    else:
        cfg = dict(load_config("configs/base_config.py")["model"])
        cfg.pop("type")
        cfg.update(name_path="configs/cls_potsdam.txt", clip_type=opts.clip_type,
                   vit_type=opts.vit_type)
        if opts.gem or opts.clip_type == "BLIP":
            cfg["global_debias_factor"] = 0.0
        if opts.gem:
            cfg.update(model_type="GEM", ignore_residual=False)
        if opts.clip_type == "BLIP":
            cfg["blip_vocab_path"] = "tests/fixtures/blip_decode_vocab.txt"
        if opts.route == "fp32-channel-first":
            cfg["param_dtype"] = torch.float32
        if opts.upsampler:
            cfg["sim_feat_up_cfg"] = {"model_name": opts.upsampler}
        seg = SegmentorEx(**cfg, device=torch.device("cuda"))
        image = np.random.RandomState(1).randint(0, 256, (1, 512, 512, 3), np.uint8)

        def run():
            seg.predict_raw(image)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(opts.requests):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = opts.requests
    per_kernel, groups = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if (not us or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):  # a span, not a kernel
            continue
        ms = us / 1e3 / n
        per_kernel[evt.key] = {"ms_per_request": ms, "calls_per_request": evt.count / n}
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(groups.values())
    fused_range = os.environ.get("RS_OV_JBU_FUSED_RANGE", "0") == "1"
    tower = (f"{opts.train} train step, batch {opts.batch}" if opts.train else
             f"{opts.generate} generate, one image" if opts.generate else
             f"{opts.encode_image} encode_image, batch {opts.batch}" if opts.encode_image else
             f"{opts.clip_type} {opts.vit_type}{' GEM' if opts.gem else ''}"
             f"{' ' + opts.upsampler if opts.upsampler else ''}")
    result = {"card": card, "requests": n, "route": opts.route, "fused_attn": opts.fused_attn,
              "fused_range": fused_range, "tower": tower,
              "wall_ms_per_request": wall * 1e3 / n, "device_ms_per_request": device_ms,
              "busy_share": device_ms / (wall * 1e3 / n),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "groups_ms_per_request": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              "kernels": dict(sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1]["ms_per_request"])[:40])}
    print(card)
    what = "calls" if opts.encode_image or opts.generate or opts.train else \
        "requests of one 512x512 image (16 crops of 224²)"
    print(f"[profile] {tower}: {n} {what}, "
          f"route {opts.route}{', K6 on' if opts.fused_attn else ''}"
          f"{', RS_OV_JBU_FUSED_RANGE=1' if fused_range else ''}: wall "
          f"{result['wall_ms_per_request']:.3f} ms, device {device_ms:.3f} ms per request "
          f"(busy {100 * result['busy_share']:.1f}%), peak {result['peak_memory_gib']:.3f} GiB")
    for g, ms in result["groups_ms_per_request"].items():
        print(f"[profile]   {g}: {ms:.3f} ms")
    for k, v in list(result["kernels"].items())[:25]:
        print(f"[profile]   {v['ms_per_request']:.4f} ms x{v['calls_per_request']:.0f}  {k[:110]}")
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
