"""Peaks, least times, and the operations and bytes the benchmark divides by.

Frozen with the benchmark. ``bound_s`` is ``_bound`` of ``chip_smoke.py``
(the larger of the bytes over the memory rate and the operations over the
peak of their operand type), and the JBU stage's epilogue counts are
``_epilogue_bound``'s; both are summed here over a layer's interface: its
own inputs read once and its outputs written once, weights included, never
what passes between its stages, so a fusion inside a layer cannot push its
share over 100%. The model's operations rewrite ``flops_512_image`` /
``_vit_crop_macs`` of ``benchmarks/mfu.py`` (a TPU v5e's peak and the JAX
package's shapes) for the port's shapes and the H100. Useful operations
only: each product once (no 3xTF32, no recomputation), 2 per multiply-add;
the tap softmax and the fixup MLP as ``_epilogue_bound`` counts them; layer
norms, other softmaxes, casts and the logit resize, stitch and postprocess
not counted.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

PEAK = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BPS = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") for ``nbytes`` moved and
    ``ops`` = {operand type: operations}."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _add(*parts: dict) -> dict:
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


def crops_per_image(config: dict, traffic: dict) -> int:
    """The sliding window's crops of one image of the traffic."""
    r = config["recipe"]
    stride, crop = r["slide_stride"], r["slide_crop"]
    h, w = traffic["image_hw"]
    return ((max(h - crop + stride - 1, 0) // stride + 1)
            * (max(w - crop + stride - 1, 0) // stride + 1))


def _grid(config: dict) -> int:
    return config["recipe"]["slide_crop"] // config["tower"]["patch_size"]


def vit_crop_ops(config: dict, queries: int) -> dict:
    """Operations of one crop through the tower: patch embedding, the
    ordinary blocks, the self-self last block (qkv, k k^T, q q^T, weights @
    v, out-projection; no MLP), in the configuration's type; the
    similarity map, the projection of every token and the CLS logits in
    fp32, as the program computes them."""
    t = config["tower"]
    d, p, e, m = t["width"], t["patch_size"], t["embed_dim"], t["mlp_ratio"]
    n_p = _grid(config) ** 2
    n = n_p + 1
    front = (8 + 4 * m) * n * d * d + 4 * n * n * d
    last = 8 * n * d * d + 6 * n * n * d
    products = 2 * n_p * 3 * p * p * d + (t["layers"] - 1) * front + last
    fp32 = 2 * n_p * n_p * d + 2 * n * d * e + 2 * e * queries
    return _add({config["dtype"]: products}, {"float32": fp32})


def vit_params(config: dict) -> int:
    t = config["tower"]
    d, p, e = t["width"], t["patch_size"], t["embed_dim"]
    mlp = int(d * t["mlp_ratio"])
    block = 4 * d + 3 * d * d + 3 * d + d * d + d + 2 * mlp * d + mlp + d
    tokens = (t["image_size"] // p) ** 2 + 1
    return d * 3 * p * p + d + tokens * d + 4 * d + t["layers"] * block + d * e


def vit_call(config: dict, crops: int, calls: int, queries: int) -> tuple[dict, float]:
    """(operations, bytes) of ``calls`` tower calls over ``crops`` crops in
    all: crops and weights in, patch tokens, CLS embeddings and CLS logits
    out."""
    b = ITEMSIZE[config["dtype"]]
    s, e = config["recipe"]["slide_crop"], config["tower"]["embed_dim"]
    n_p = _grid(config) ** 2
    ops = {k: v * crops for k, v in vit_crop_ops(config, queries).items()}
    nbytes = (crops * (3 * s * s * b + n_p * e * b + e * 4 + queries * 4)
              + calls * (vit_params(config) * b + queries * e * 4))
    return ops, nbytes


def jbu_stage_ops(config: dict, side: int, last: bool, queries: int) -> dict:
    """Operations of one crop's 2x stage to ``side`` x ``side``: the range
    projection, range logits, tap softmax and fixup MLP in fp32, the
    source's 4-tap bicubic 2x in fp32, the adaptive conv (and in the last
    stage the final fixup and cosine classifier) in the configuration's
    type."""
    u, c = config["upsampler"], config["tower"]["embed_dim"]
    g, k, dd = u["guidance_dim"], u["key_dim"], (2 * u["radius"] + 1) ** 2
    px = side * side
    fp32 = (2 * px * (g * k + k * k) + 2 * px * dd * k
            + px * (6 * dd + 2 * dd * (dd + g) + 2 * dd * dd)
            + 8 * side * (side // 2) * c + 8 * px * c)
    products = 2 * px * dd * c + ((2 * px * c * c + 2 * px * c * queries) if last else 0)
    return _add({config["dtype"]: products}, {"float32": fp32})


def jbu_crop_ops(config: dict, queries: int) -> dict:
    stages = config["recipe"]["sim_feat_up_cfg"]["num_stages"]
    return _add(*(jbu_stage_ops(config, _grid(config) * 2 ** s, s == stages, queries)
                  for s in range(1, stages + 1)))


def jbu_params(config: dict) -> int:
    u, c = config["upsampler"], config["tower"]["embed_dim"]
    g, k, dd = u["guidance_dim"], u["key_dim"], (2 * u["radius"] + 1) ** 2
    return 2 + k * g + k + k * k + k + dd * (g + dd) + dd + dd * dd + dd + c * c + c


def jbu_call(config: dict, crops: int, calls: int, queries: int) -> tuple[dict, float]:
    """(operations, bytes) of ``calls`` upsample-and-classify calls over
    ``crops`` crops in all: patch tokens, guidance crops, weights and
    queries in, the last stage's fp32 logits out."""
    b = ITEMSIZE[config["dtype"]]
    s, c = config["recipe"]["slide_crop"], config["tower"]["embed_dim"]
    g = _grid(config)
    side = g * 2 ** config["recipe"]["sim_feat_up_cfg"]["num_stages"]
    ops = {k: v * crops for k, v in jbu_crop_ops(config, queries).items()}
    nbytes = (crops * (g * g * c * b + 3 * s * s * b + side * side * queries * 4)
              + calls * (jbu_params(config) * b + queries * c * 4))
    return ops, nbytes


def image_flops(config: dict, traffic: dict, queries: int) -> float:
    """The model's operations for one image of the traffic: its crops
    through the tower and the upsampler with the classifier."""
    per_crop = _add(vit_crop_ops(config, queries), jbu_crop_ops(config, queries))
    return crops_per_image(config, traffic) * sum(per_crop.values())
