"""The port's decontamination stages vs the JAX package's, on the CPU in
fp32 from the same seeded inputs: DBSCAN and CTD, cross-tile fusion, SOM,
layer fusion and self-attention enhancement."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.decontam import cross_tile as jct
from rs_ov.decontam import ctd as jctd
from rs_ov.decontam import layer_fusion as jlf
from rs_ov.decontam import self_attn_enhance as jsae
from rs_ov.decontam import som as jsom
from rs_ov_torch.core.params import clip_params_from_numpy
from rs_ov_torch.decontam import cross_tile, ctd, layer_fusion, self_attn_enhance, som
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward

torch.set_num_threads(1)

# tiny arch of tools/parity_check.py:68-70
CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                        output_dim=32, head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                    layers=2, output_dim=32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(seed, n=120, d=8, k=4, scattered=30):
    """n points around k directions, and scattered ones in any direction."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    pts = centers[rng.randint(0, k, n)] * 3.0 + rng.randn(n, d) * 0.6
    return np.concatenate([pts, rng.randn(scattered, d)]).astype(np.float32)


@pytest.mark.parametrize("metric,eps,min_samples", [
    ("euclidean", 0.5, 5), ("euclidean", 0.3, 4), ("cosine", 0.12, 5), ("cosine", 0.05, 3)])
def test_dbscan_labels_equal_jax(metric, eps, min_samples):
    pts = _blobs(1)
    want = np.asarray(jctd.dbscan(jnp.asarray(pts), eps=eps, min_samples=min_samples,
                                  metric=metric))
    got = ctd.dbscan(_t(pts), eps=eps, min_samples=min_samples, metric=metric).numpy()
    assert len(set(want) - {-1}) >= 2 and (want == -1).any()  # clusters and noise
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def vit_tokens():
    """196 patch tokens per crop of two 224x224 crops through the tiny ViT
    (the production recipe's toggles), and their normalised CLS."""
    tree = jax.tree_util.tree_map(np.asarray, init_clip_params(jax.random.PRNGKey(0), CFG))
    clip = clip_params_from_numpy(tree, CFG)
    images = np.random.RandomState(2).randn(2, 3, 224, 224).astype(np.float32)
    call = VitCallConfig(model_type="Experimental", apply_similarity_enhancement=True,
                         apply_outlier_suppression=True, outlier_top_k=30)
    with torch.no_grad():
        pooled, tokens = vit_forward(clip.visual, _t(images), CFG.vision, call)
    cls = pooled / pooled.norm(dim=-1, keepdim=True)
    return tokens.numpy(), cls.numpy()


PRODUCTION = dict(max_points=8192, metric="euclidean", eps=1.1, min_samples=11)


@pytest.mark.parametrize("cfg", [
    PRODUCTION,
    dict(PRODUCTION, refine_tokens=True),
    dict(PRODUCTION, cls_subtract=True, cls_subtract_scale=0.7),
    dict(PRODUCTION, cls_subtract=True, cls_subtract_use_unit_cls=False, refine_tokens=True),
    dict(PRODUCTION, use_spatial=True, spatial_weight=0.5, eps=0.25),
    dict(metric="cosine", eps=0.05, min_samples=6, refine_tokens=True),
], ids=["production", "refine", "cls_subtract", "refine+cls_subtract_raw", "spatial",
        "cosine"])
def test_cluster_patch_tokens_matches_jax(vit_tokens, cfg):
    """Labels equal, tokens within 1e-6 (the production config: eps 1.1,
    min_samples 11, euclidean, on 196 tiny-ViT tokens per crop)."""
    tokens, cls = vit_tokens
    w_tok, w_lab = jctd.cluster_patch_tokens_dbscan(jnp.asarray(tokens), (14, 14), cfg,
                                                    cls_token=jnp.asarray(cls))
    g_tok, g_lab = ctd.cluster_patch_tokens_dbscan(_t(tokens), (14, 14), cfg,
                                                   cls_token=_t(cls))
    w_lab = np.asarray(w_lab)
    assert len(set(w_lab.ravel()) - {-1}) >= 1  # the clustering is not empty
    np.testing.assert_array_equal(g_lab.numpy(), w_lab)
    np.testing.assert_allclose(g_tok.numpy(), np.asarray(w_tok), atol=1e-6, rtol=0)


def test_cluster_patch_tokens_skip_guards(vit_tokens):
    tokens, _ = vit_tokens
    for grid, cfg in (((13, 14), PRODUCTION), ((14, 14), dict(PRODUCTION, max_points=100))):
        out, labels = ctd.cluster_patch_tokens_dbscan(_t(tokens), grid, cfg)
        assert labels is None and out is not None


def test_adaptive_debiasing_matches_jax(vit_tokens):
    tokens, cls = vit_tokens
    _, labels = jctd.cluster_patch_tokens_dbscan(jnp.asarray(tokens), (14, 14), PRODUCTION)
    want = np.asarray(jctd.adaptive_debiasing(jnp.asarray(tokens), labels,
                                              jnp.asarray(cls), factor=-1.5))
    got = ctd.adaptive_debiasing(_t(tokens), _t(np.asarray(labels)), _t(cls),
                                 factor=-1.5).numpy()
    assert np.abs(want - tokens).max() > 1e-3  # the debias moved the tokens
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid,patch,cfg", [
    ((2, 3), (4, 5), dict(fusion_mode="weighted")),
    ((2, 3), (4, 5), dict(fusion_mode="attention")),
    ((3, 2), (4, 4), dict(fusion_mode="weighted", cache_boundary_width=1)),
    ((3, 2), (4, 4), dict(fusion_mode="attention", cache_boundary_width=1)),
    ((2, 2), (5, 6), dict(fusion_mode="weighted", adaptive_fusion=False,
                          similarity_threshold=0.1)),
    ((2, 3), (3, 2), dict(fusion_mode="weighted", cache_boundary_width=1)),
    ((2, 3), (3, 2), dict(fusion_mode="attention", cache_boundary_width=1)),
    ((2, 2), (4, 2), dict(fusion_mode="weighted", cache_boundary_width=2)),
], ids=["weighted-bw2", "attention-bw2", "weighted-bw1", "attention-bw1", "fixed-threshold",
        "walk-weighted", "walk-attention", "bw_eq_pw"])
def test_fuse_tile_grid_matches_jax(grid, patch, cfg):
    """Both modes, the fixed threshold, bw 1 and 2, the column walk of bw == 1
    with pw <= 2, and bw == pw; within 1e-5."""
    gh, gw = grid
    ph, pw = patch
    feats = np.random.RandomState(4).randn(gh * gw, ph * pw, 16).astype(np.float32)
    want = np.asarray(jct.fuse_tile_grid(jnp.asarray(feats), grid, patch,
                                         jct.CrossTileFusionConfig(**cfg)))
    got = cross_tile.fuse_tile_grid(_t(feats), grid, patch,
                                    cross_tile.CrossTileFusionConfig(**cfg)).numpy()
    assert np.abs(want - feats).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("mode", ["cls_comparison", "self_sufficiency", "both", "either"])
def test_som_matches_jax(mode):
    """Each detection mode on a 5x6 grid (border neighbours included): the
    mask equal, tokens and confidence within 1e-6."""
    rng = np.random.RandomState(5)
    gh, gw, heads = 5, 6, 3
    tokens = rng.randn(2, gh * gw, 8).astype(np.float32)
    logits = rng.randn(2, heads, gh * gw + 1, gh * gw + 1) * 1.5
    logits[..., np.arange(1, gh * gw + 1), np.arange(1, gh * gw + 1)] += 1.0
    attn = _softmax(logits)
    kw = dict(consensus_threshold=0.4, detection_mode=mode, self_sufficiency_ratio=0.8)
    w_tok, w_mask, w_conf = jsom.suppress_outlier_module(jnp.asarray(tokens),
                                                         jnp.asarray(attn), gh, gw, **kw)
    g_tok, g_mask, g_conf = som.suppress_outlier_module(_t(tokens), _t(attn), gh, gw, **kw)
    w_mask = np.asarray(w_mask)
    assert 0 < w_mask.sum() < w_mask.size
    np.testing.assert_array_equal(g_mask.numpy(), w_mask)
    np.testing.assert_allclose(g_tok.numpy(), np.asarray(w_tok), atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_conf.numpy(), np.asarray(w_conf), atol=1e-6, rtol=0)


def test_layer_fusion_matches_jax():
    rng = np.random.RandomState(6)
    l = 17
    maps = [_softmax(rng.randn(2, l, l) * 2.0) for _ in range(3)]
    output = rng.randn(2, l, 8).astype(np.float32)
    acc_j = acc_t = None
    for m in maps:
        acc_j = jlf.fuse_attention_ema(acc_j, jnp.asarray(m), 0.6)
        acc_t = layer_fusion.fuse_attention_ema(acc_t, _t(m), 0.6)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-6, rtol=0)
    want = np.asarray(jlf.layer_fusion_reweight(jnp.asarray(output), acc_j, 4))
    got = layer_fusion.layer_fusion_reweight(_t(output), acc_t, 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode,heads", [("feature", 0), ("feature", 2), ("attention", 0),
                                        ("attention", 2)])
def test_self_attention_enhance_matches_jax(mode, heads):
    """Both modes, from a head-averaged map and from per-head maps; 1e-6."""
    rng = np.random.RandomState(7)
    gh, gw = 4, 5
    n = gh * gw + 1
    feats = rng.randn(2, 8, gh, gw).astype(np.float32)
    shape = (2, heads, n, n) if heads else (2, n, n)
    attn = _softmax(rng.randn(*shape) * 3.0)
    kw = dict(mode=mode, enhancement_strength=0.5, min_self_attn_threshold=0.3, top_k=6)
    want = np.asarray(jsae.self_attention_enhance(jnp.asarray(feats), jnp.asarray(attn),
                                                  gh, gw, **kw))
    got = self_attn_enhance.self_attention_enhance(_t(feats), _t(attn), gh, gw, **kw).numpy()
    assert np.abs(want - feats).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
