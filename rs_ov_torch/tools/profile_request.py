"""Where a request's device time goes, from one ``torch.profiler`` pass.

    python3 -m rs_ov_torch.tools.profile_request [--requests 3] [--fused-attn]
        [--route default|fp32-channel-first|bf16-channel-first]
        [--clip-type CLIP] [--vit-type ViT-B/16] [--gem]
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
kernels K5a and K5b.
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--fused-attn", action="store_true")
    ap.add_argument("--route", choices=ROUTES, default="default")
    ap.add_argument("--clip-type", default="CLIP")
    ap.add_argument("--vit-type", default="ViT-B/16")
    ap.add_argument("--gem", action="store_true")
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
    seg = SegmentorEx(**cfg, device=torch.device("cuda"))
    image = np.random.RandomState(1).randint(0, 256, (1, 512, 512, 3), np.uint8)
    for _ in range(2):
        seg.predict_raw(image)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(opts.requests):
            seg.predict_raw(image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = opts.requests
    per_kernel, groups = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if not us or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = us / 1e3 / n
        per_kernel[evt.key] = {"ms_per_request": ms, "calls_per_request": evt.count / n}
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(groups.values())
    fused_range = os.environ.get("RS_OV_JBU_FUSED_RANGE", "0") == "1"
    tower = f"{opts.clip_type} {opts.vit_type}{' GEM' if opts.gem else ''}"
    result = {"card": card, "requests": n, "route": opts.route, "fused_attn": opts.fused_attn,
              "fused_range": fused_range, "tower": tower,
              "wall_ms_per_request": wall * 1e3 / n, "device_ms_per_request": device_ms,
              "busy_share": device_ms / (wall * 1e3 / n),
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "groups_ms_per_request": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              "kernels": dict(sorted(per_kernel.items(),
                                     key=lambda kv: -kv[1]["ms_per_request"])[:40])}
    print(card)
    print(f"[profile] {tower}: {n} requests of one 512x512 image (16 crops of 224²), "
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
