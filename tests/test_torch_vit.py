"""The port's resize ops, decontaminating ViT and decontamination stages vs
the JAX package, on the CPU in fp32, from the same seeded inputs and weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.decontam.global_debias import global_debias as jax_global_debias
from rs_ov.decontam.outlier import outlier_suppress as jax_outlier_suppress
from rs_ov.decontam.similarity import compute_similarity_map as jax_similarity
from rs_ov.nn.vit import VitCallConfig as JaxCall, vit_forward as jax_vit_forward
from rs_ov.utils import resize as jr
from rs_ov_torch.core.params import clip_params_from_numpy
from rs_ov_torch.decontam.global_debias import global_debias
from rs_ov_torch.decontam.outlier import outlier_suppress
from rs_ov_torch.decontam.similarity import compute_similarity_map
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward
from rs_ov_torch.utils import resize as tr

torch.set_num_threads(1)

# tiny arch of tools/parity_check.py:68-70
CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                        output_dim=32, head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                    layers=2, output_dim=32))


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(np.asarray, init_clip_params(jax.random.PRNGKey(0), CFG))
    return tree, clip_params_from_numpy(tree, CFG)


RESIZES = [
    ("resize_bilinear", (2, 3, 7, 9), ((14, 4),)),
    ("resize_bilinear", (3, 56, 56), ((224, 224),)),
    ("resize_bicubic", (2, 3, 7, 9), ((14, 18),)),
    ("resize_bicubic_scaled", (5, 4, 4), ((6, 7), (4 / 6.1, 4 / 7.1))),
    ("adaptive_avg_pool2d", (2, 3, 64, 48), ((28, 12),)),
    ("reflect_pad_2d", (2, 3, 6, 7), (5,)),
    ("resize_bicubic_nhwc", (2, 7, 9, 5), ((14, 18),)),
    ("reflect_pad_nhwc", (2, 6, 7, 5), (5,)),
]


@pytest.mark.parametrize("name,shape,args", RESIZES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(RESIZES)])
def test_resize_matches_jax(name, shape, args):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(getattr(jr, name)(jnp.asarray(x), *args))
    got = getattr(tr, name)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("size,top_k,ignore_residual", [
    (64, 3, True),     # the pretrained grid, top-k below the 16 patches
    (96, 30, True),    # the production top-k on a 6x6 grid (pos-embed interpolated)
    (80, 5, False),    # the residual branch of the last block, 5x5 grid
])
def test_vit_forward_matches_jax(weights, size, top_k, ignore_residual):
    """Main-path ViT (Experimental + similarity enhancement + outlier
    suppression): tokens and pooled CLS within 5e-4."""
    tree, clip = weights
    images = np.random.RandomState(1).randn(2, 3, size, size).astype(np.float32)
    kw = dict(model_type="Experimental", ignore_residual=ignore_residual,
              apply_similarity_enhancement=True, apply_outlier_suppression=True,
              outlier_top_k=top_k)
    jp, jt = jax_vit_forward(jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
                             jnp.asarray(images), CFG.vision,
                             JaxCall(output_cls_token=True, **kw))
    with torch.no_grad():
        tp, tt = vit_forward(clip.visual, torch.from_numpy(images), CFG.vision,
                             VitCallConfig(**kw))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-4, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-4, rtol=0)


VIT_CASES = {
    **{f"mode-{m}": dict(model_type=m) for m in (
        "vanilla", "MaskCLIP", "SCLIP", "SegEarth", "SFP", "Experimental", "ClearCLIP",
        "NACLIP", "NOnly", "GAV")},
    "last_n_layers-2": dict(last_n_layers=2, ignore_residual=False),
    "source-last": dict(outlier_source_layers=(-1,)),
    "source-front-two": dict(outlier_source_layers=(0, 2)),
    "layer_fusion": dict(apply_layer_fusion=True, layer_fusion_lambda=0.6),
    "som": dict(apply_som=True, som_consensus_threshold=0.3),
    "self_attn-feature": dict(apply_self_attn_enhancement=True, self_attn_top_k=4),
    "self_attn-attention-alone": dict(apply_self_attn_enhancement=True,
                                      apply_outlier_suppression=False,
                                      self_attn_mode="attention", self_attn_strength=0.5,
                                      self_attn_threshold=0.5),
}


@pytest.mark.parametrize("case", list(VIT_CASES), ids=list(VIT_CASES))
def test_vit_options_match_jax(weights, case):
    """Each attention mode in the last block (a 6x5 grid: the Gaussian modes
    see a non-square one), the last two blocks, the outlier source layers,
    layer fusion, SOM and self-attention enhancement with and without
    outlier suppression (the capture rule of rs_ov/nn/vit.py:170-171), on
    top of similarity enhancement and outlier suppression: within 5e-4."""
    tree, clip = weights
    images = np.random.RandomState(6).randn(2, 3, 96, 80).astype(np.float32)
    kw = dict(model_type="Experimental", apply_similarity_enhancement=True,
              apply_outlier_suppression=True, outlier_top_k=4, gaussian_std=0.8)
    kw.update(VIT_CASES[case])
    jp, jt = jax_vit_forward(jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
                             jnp.asarray(images), CFG.vision,
                             JaxCall(output_cls_token=True, **kw))
    with torch.no_grad():
        tp, tt = vit_forward(clip.visual, torch.from_numpy(images), CFG.vision,
                             VitCallConfig(**kw))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=5e-4, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-4, rtol=0)


def test_vit_call_config_defaults_match_jax():
    """Every field the port keeps has the JAX package's default (a caller
    that leaves model_type out gets ClearCLIP in both)."""
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(VitCallConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxCall)}
    assert set(ours) == set(theirs) - {"output_cls_token"}
    assert ours == {k: theirs[k] for k in ours}
    assert VitCallConfig().model_type == "ClearCLIP"


def test_last_block_stream_feeds_a_tail_capture(weights, monkeypatch):
    """The last block's ordinary stream runs when a capture reads it (here
    outlier detection from the last layer) and not otherwise."""
    from rs_ov_torch.nn import vit

    calls = []
    real = vit._resblock
    monkeypatch.setattr(vit, "_resblock",
                        lambda *a, **k: calls.append(k.get("need_weights")) or real(*a, **k))
    _, clip = weights
    images = torch.from_numpy(np.random.RandomState(8).randn(1, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        vit_forward(clip.visual, images, CFG.vision,
                    VitCallConfig(model_type="Experimental", apply_outlier_suppression=True))
        assert calls == [False, False, True]
        calls.clear()
        vit_forward(clip.visual, images, CFG.vision,
                    VitCallConfig(model_type="Experimental", apply_outlier_suppression=True,
                                  outlier_source_layers=(-1,)))
        assert calls == [False, False, False, True]


@pytest.mark.parametrize("temperature,add_self", [(1.0, True), (0.5, False)])
def test_similarity_map_matches_jax(temperature, add_self):
    f = np.random.RandomState(2).randn(2, 36, 16).astype(np.float32)
    want = np.asarray(jax_similarity(jnp.asarray(f), temperature=temperature,
                                     add_self_similarity=add_self))
    got = compute_similarity_map(torch.from_numpy(f), temperature=temperature,
                                 add_self_similarity=add_self).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_k", [4, 30])
def test_outlier_suppress_matches_jax(top_k):
    """Top-k, inverse-similarity replacement and last-write-wins collisions
    (top_k=30 on 36 patches makes many neighbour writes collide)."""
    rng = np.random.RandomState(3)
    b, c, gh, gw = 2, 8, 6, 6
    feats = rng.randn(b, c, gh, gw).astype(np.float32)
    logits = rng.randn(b, gh * gw + 1, gh * gw + 1).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = np.asarray(jax_outlier_suppress(jnp.asarray(feats), jnp.asarray(attn), gh, gw,
                                           top_k=top_k, contamination_temp=0.1))
    got = outlier_suppress(torch.from_numpy(feats), torch.from_numpy(attn), gh, gw,
                           top_k=top_k, contamination_temp=0.1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_global_debias_matches_jax():
    rng = np.random.RandomState(4)
    f = rng.randn(3, 16, 8).astype(np.float32)
    cls = rng.randn(3, 8).astype(np.float32)
    cls /= np.linalg.norm(cls, axis=-1, keepdims=True)
    want = np.asarray(jax_global_debias(jnp.asarray(f), jnp.asarray(cls), 0.2))
    got = global_debias(torch.from_numpy(f), torch.from_numpy(cls), 0.2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
