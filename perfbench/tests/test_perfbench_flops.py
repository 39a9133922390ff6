"""The yardstick's operation and byte counts against hand counts: every
product of a ViT-B/16 and a ViT-L/14 crop listed by its (m, k, n), one JBU
stage term by term, one JBU call's interface bytes, the towers' published
parameter counts, and the bound's arithmetic."""

import math

import pytest

from perfbench.harness import flops, inputs, spec


def _config(name):
    return spec.load_json(f"{spec.REPO}/perfbench/configs/{name}.json")


def _products(*mkn):
    return sum(2 * m * k * n * count for m, k, n, count in mkn)


def _vit_crop(p, d, layers, e, q=8):
    """(m, k, n, count) of every product of one 224² crop, listed by hand."""
    g = 224 // p
    n_p, n = g * g, g * g + 1
    heads, hd = d // 64, 64
    block = [(n, d, 3 * d, 1), (n, hd, n, heads), (n, n, hd, heads), (n, d, d, 1),
             (n, d, 4 * d, 1), (n, 4 * d, d, 1)]
    last = [(n, d, 3 * d, 1), (n, hd, n, heads), (n, hd, n, heads), (n, n, hd, heads),
            (n, d, d, 1)]
    bf16 = (_products((n_p, 3 * p * p, d, 1)) + (layers - 1) * _products(*block)
            + _products(*last))
    fp32 = _products((n_p, d, n_p, 1), (n, d, e, 1), (1, e, q, 1))
    return bf16, fp32


@pytest.mark.parametrize("name, p, d, layers, e", [
    ("clip-vitb16-segearth", 16, 768, 12, 512),
    ("remoteclip-vitl14-segearth", 14, 1024, 24, 768)])
def test_vit_crop_operations_match_a_hand_count(name, p, d, layers, e):
    bf16, fp32 = _vit_crop(p, d, layers, e)
    ops = flops.vit_crop_ops(_config(name), 8)
    assert ops == {"bfloat16": bf16, "float32": fp32}


def test_vit_b16_crop_total():
    # ViT-B/16: 11 ordinary blocks of 24 L D^2 + 4 L^2 D, the self-self
    # block's 8 L D^2 + 6 L^2 D, the patch product, at L = 197, D = 768
    ops = flops.vit_crop_ops(_config("clip-vitb16-segearth"), 8)
    assert ops["bfloat16"] == 11 * (24 * 197 * 768 ** 2 + 4 * 197 ** 2 * 768) \
        + 8 * 197 * 768 ** 2 + 6 * 197 ** 2 * 768 + 2 * 196 * 768 * 768
    assert ops["bfloat16"] == 33_326_605_824


@pytest.mark.parametrize("name, published", [("clip-vitb16-segearth", 86_192_640),
                                             ("remoteclip-vitl14-segearth", 303_966_208)])
def test_tower_parameters_are_the_published_counts(name, published):
    config = _config(name)
    assert flops.vit_params(config) == published
    assert sum(math.prod(s) for _, s, _, _ in inputs.vision_leaves(config)) == published


def test_jbu_params_match_the_checkpoint_leaves():
    config = _config("clip-vitb16-segearth")
    assert flops.jbu_params(config) == sum(
        math.prod(s) for _, s, _, _ in inputs.upsampler_leaves(config))


def test_one_jbu_stage_matches_a_hand_count():
    # ViT-B/16's second (last) stage: 56 x 56 pixels, d = 11 (121 taps),
    # C = 512, range key 32, RGB guidance, 8 queries
    px, dd, c = 56 * 56, 121, 512
    fp32 = (px * 2 * (3 * 32 + 32 * 32)           # range projection, 1x1 -> 1x1
            + px * 2 * dd * 32                     # range logits
            + px * (6 * dd + 2 * dd * (dd + 3) + 2 * dd * dd)   # tap softmax, fixup MLP
            + 8 * 56 * 28 * c + 8 * px * c)        # 4-tap bicubic, rows then columns
    bf16 = px * 2 * dd * c + px * 2 * c * c + px * 2 * c * 8   # conv, final fixup, cosine
    ops = flops.jbu_stage_ops(_config("clip-vitb16-segearth"), 56, True, 8)
    assert ops == {"float32": fp32, "bfloat16": bf16}
    assert bf16 == 2_058_420_224


def test_one_jbu_call_moves_its_interface_bytes():
    config = _config("clip-vitb16-segearth")
    _, nbytes = flops.jbu_call(config, crops=2, calls=1, queries=8)
    tokens, guidance, logits = 2 * 196 * 512 * 2, 2 * 3 * 224 * 224 * 2, 2 * 56 * 56 * 8 * 4
    weights = (2 + 32 * 3 + 32 + 32 * 32 + 32 + 121 * 124 + 121 + 121 * 121 + 121
               + 512 * 512 + 512) * 2
    assert nbytes == tokens + guidance + logits + weights + 8 * 512 * 4


def test_the_bound_takes_the_larger_side():
    t, by = flops.bound_s(3.35e12, {"bfloat16": 989e12 / 2})
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = flops.bound_s(1.0, {"bfloat16": 989e12, "float32": 67e12})
    assert (t, by) == (pytest.approx(2.0), "operations")


def test_image_flops_b16():
    config = _config("clip-vitb16-segearth")
    traffic = {"image_hw": [512, 512]}
    assert flops.crops_per_image(config, traffic) == 16
    per_crop = sum(flops.vit_crop_ops(config, 8).values()) + sum(
        flops.jbu_crop_ops(config, 8).values())
    assert flops.image_flops(config, traffic, 8) == 16 * per_crop
