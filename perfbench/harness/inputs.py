"""Everything a run feeds the program, made from ``--seed``.

* Weights: every leaf of the public checkpoints the program loads, an
  OpenAI / open_clip CLIP state dict (``visual.*`` drawn, the text tower's
  leaves zero: it is not run) and a SimFeatUp ``jbu_one`` one
  (``upsampler.*``), drawn on the device in one call from one generator,
  scaled to each leaf's spread in two more, and rounded to the served type.
* Query embeddings: one per vocabulary entry, L2-normalised, in place of
  the text tower's (which runs once per vocabulary, at start-up).
* Images: a pool of distinct uint8 RGB images (smooth fields at two scales
  plus fine noise), and the order the traffic cycles through them.

Each draw has its own stream, split off the seed by ``numpy.random.SeedSequence``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Seeds:
    weights: int
    queries: int
    images: int
    order: int
    sample: int


def seeds(seed: int) -> Seeds:
    return Seeds(*(int(s) for s in np.random.SeedSequence(seed % 2 ** 64).generate_state(5)))


def _ln(name: str, width: int) -> list:
    return [(f"{name}.weight", (width,), 0.05, 1.0), (f"{name}.bias", (width,), 0.02, 0.0)]


def _block(pre: str, d: int, mlp: int) -> list:
    """A residual block's leaves with the spreads of the CLIP init (biases
    and LayerNorms perturbed, so that a fault in them shows)."""
    s = d ** -0.5
    return (_ln(f"{pre}.ln_1", d) + [
        (f"{pre}.attn.in_proj_weight", (3 * d, d), s, 0.0),
        (f"{pre}.attn.in_proj_bias", (3 * d,), 0.02, 0.0),
        (f"{pre}.attn.out_proj.weight", (d, d), 0.5 * s, 0.0),
        (f"{pre}.attn.out_proj.bias", (d,), 0.02, 0.0)] + _ln(f"{pre}.ln_2", d) + [
        (f"{pre}.mlp.c_fc.weight", (mlp, d), (2 * d) ** -0.5, 0.0),
        (f"{pre}.mlp.c_fc.bias", (mlp,), 0.02, 0.0),
        (f"{pre}.mlp.c_proj.weight", (d, mlp), 0.5 * s, 0.0),
        (f"{pre}.mlp.c_proj.bias", (d,), 0.02, 0.0)])


def vision_leaves(config: dict) -> list:
    """(name, shape, std, mean) of every vision-tower leaf, public names."""
    t = config["tower"]
    d, p, e = t["width"], t["patch_size"], t["embed_dim"]
    tokens = (t["image_size"] // p) ** 2 + 1
    out = [("visual.conv1.weight", (d, 3, p, p), d ** -0.5, 0.0),
           ("visual.class_embedding", (d,), d ** -0.5, 0.0),
           ("visual.positional_embedding", (tokens, d), d ** -0.5, 0.0)]
    out += _ln("visual.ln_pre", d)
    for i in range(t["layers"]):
        out += _block(f"visual.transformer.resblocks.{i}", d, int(d * t["mlp_ratio"]))
    return out + _ln("visual.ln_post", d) + [("visual.proj", (d, e), d ** -0.5, 0.0)]


def text_leaves(config: dict) -> list:
    """(name, shape) of the text tower's leaves, which the program's strict
    loader wants and no request reads."""
    t, e = config["text"], config["tower"]["embed_dim"]
    w = t["width"]
    out = [("token_embedding.weight", (t["vocab_size"], w)),
           ("positional_embedding", (t["context_length"], w)), ("logit_scale", ())]
    for i in range(t["layers"]):
        out += [(n, s) for n, s, _, _ in _block(f"transformer.resblocks.{i}", w, 4 * w)]
    return out + [(n, s) for n, s, _, _ in _ln("ln_final", w)] + [("text_projection", (w, e))]


def upsampler_leaves(config: dict) -> list:
    """(name, shape, std, mean) of the SimFeatUp ``jbu_one`` checkpoint's
    leaves (range temperature and spatial sigma scalars, the range and fixup
    projections, the final fixup)."""
    u, c = config["upsampler"], config["tower"]["embed_dim"]
    g, k, dd = u["guidance_dim"], u["key_dim"], (2 * u["radius"] + 1) ** 2
    pre = "upsampler.up"
    return [(f"{pre}.range_temp", (), 0.1, 0.0), (f"{pre}.sigma_spatial", (), 0.1, 1.0),
            (f"{pre}.range_proj.0.weight", (k, g, 1, 1), g ** -0.5, 0.0),
            (f"{pre}.range_proj.0.bias", (k,), 0.02, 0.0),
            (f"{pre}.range_proj.3.weight", (k, k, 1, 1), k ** -0.5, 0.0),
            (f"{pre}.range_proj.3.bias", (k,), 0.02, 0.0),
            (f"{pre}.fixup_proj.0.weight", (dd, g + dd, 1, 1), (g + dd) ** -0.5, 0.0),
            (f"{pre}.fixup_proj.0.bias", (dd,), 0.02, 0.0),
            (f"{pre}.fixup_proj.3.weight", (dd, dd, 1, 1), dd ** -0.5, 0.0),
            (f"{pre}.fixup_proj.3.bias", (dd,), 0.02, 0.0),
            ("upsampler.fixup_proj.1.weight", (c, c, 1, 1), c ** -0.5, 0.0),
            ("upsampler.fixup_proj.1.bias", (c,), 0.02, 0.0)]


def draw(leaves: list, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """The leaves as one flat buffer, drawn N(mean, std) in one randn from
    one generator on ``device``, rounded to ``dtype``."""
    numel = [math.prod(shape) for _, shape, _, _ in leaves]
    total = sum(numel)
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(numel, device=device)
    std = torch.repeat_interleave(torch.tensor([s for _, _, s, _ in leaves], device=device),
                                  counts, output_size=total)
    mean = torch.repeat_interleave(torch.tensor([m for _, _, _, m in leaves], device=device),
                                   counts, output_size=total)
    return torch.randn(total, generator=gen, device=device).mul_(std).add_(mean).to(dtype)


def views(flat, leaves: list) -> dict:
    """{name: a view of ``flat`` shaped as the leaf} (tensors or arrays)."""
    out, at = {}, 0
    for name, shape, *_ in leaves:
        n = math.prod(shape)
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def weights(config: dict, seed: int, device) -> tuple[torch.Tensor, list]:
    """(flat buffer in the served type, its leaves) of the vision tower and
    the upsampler, drawn from ``seed``: the same call gives the same values."""
    leaves = vision_leaves(config) + upsampler_leaves(config)
    return draw(leaves, seed, device, getattr(torch, config["dtype"])), leaves


def queries(config: dict, n: int, seed: int, device) -> torch.Tensor:
    """[n, embed_dim] fp32 L2-normalised query embeddings."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((n, config["tower"]["embed_dim"]), generator=gen, device=device)
    return q / q.norm(dim=-1, keepdim=True)


def images(traffic: dict, seed: int, device) -> np.ndarray:
    """[pool, H, W, 3] uint8 on the host: smooth random fields at two scales
    plus fine noise, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, (h, w) = traffic["pool"], traffic["image_hw"]

    def field(side):
        x = torch.rand((n, 3, side, side), generator=gen, device=device)
        return F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)

    x = 0.6 * field(8) + 0.3 * field(48) + 0.1 * torch.rand((n, 3, h, w), generator=gen,
                                                             device=device)
    x = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def order(traffic: dict, seed: int) -> np.ndarray:
    """The pool's images in the order the traffic cycles through them."""
    return np.random.default_rng(seed).permutation(traffic["pool"])
