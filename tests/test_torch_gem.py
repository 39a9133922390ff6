"""GEM on the port against the JAX package, on the CPU in fp32 with the same
weights: the antialiased bicubic resample (1e-5), the self-self attention
and the GEM forward (gem_stream, 1e-3), the whole slice with SimFeatUp
(2e-3), and the guard that refuses what reads the CLS token
(tools/parity_check.py:72-85)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.nn.gem import gem_vit_forward as jax_gem_vit_forward
from rs_ov.nn.gem import self_self_attention as jax_self_self_attention
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov.utils.resize import resize_bicubic_antialias as jax_resize
from rs_ov_torch.core.params import clip_params_from_numpy
from rs_ov_torch.nn.gem import gem_vit_forward, self_self_attention
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.utils.resize import resize_bicubic_antialias

torch.set_num_threads(1)

CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4, output_dim=32,
                        head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2, layers=2,
                    output_dim=32))
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(np.asarray, init_clip_params(jax.random.PRNGKey(0), CFG))
    return tree, clip_params_from_numpy(tree, CFG)


@pytest.mark.parametrize("shape,out_hw", [((3, 14, 14), (7, 7)), ((2, 7, 7), (14, 18)),
                                          ((5, 16, 16), (14, 9)), ((4, 4, 4), (4, 4))],
                         ids=["down", "up", "mixed", "same"])
def test_resize_bicubic_antialias_matches_jax(shape, out_hw):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw))
    got = resize_bicubic_antialias(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ss_attn_temp", [None, 0.5], ids=["adaptive", "t0.5"])
@pytest.mark.parametrize("ss_attn_iter", [1, 2])
def test_self_self_attention_matches_jax(weights, ss_attn_iter, ss_attn_temp):
    tree, model = weights
    x = np.random.RandomState(1).randn(2, 17, 64).astype(np.float32)
    p = tree["visual"]["blocks"][-1]["attn"]
    want = jax_self_self_attention(p, jnp.asarray(x), 2, ss_attn_iter=ss_attn_iter,
                                   ss_attn_temp=ss_attn_temp)
    got = self_self_attention(model.visual.blocks[-1].attn, torch.from_numpy(x), 2,
                              ss_attn_iter=ss_attn_iter, ss_attn_temp=ss_attn_temp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)


@pytest.mark.parametrize("ignore_residual", [False, True])
def test_gem_vit_forward_matches_jax(weights, ignore_residual):
    """An 80x96 input (a 5x6 grid against the pos-embed's 4x4): the pos-embed
    is resampled with antialiased bicubic; depth 3 leaves 2 plain blocks."""
    tree, model = weights
    img = np.random.RandomState(2).randn(2, 3, 80, 96).astype(np.float32)
    kw = dict(depth=3, ignore_residual=ignore_residual, quick_gelu_act=True)
    want = np.asarray(jax_gem_vit_forward(tree["visual"], jnp.asarray(img), CFG.vision, **kw))
    got = gem_vit_forward(model.visual, torch.from_numpy(img), CFG.vision, **kw).numpy()
    assert got.shape == want.shape == (2, 30, 32)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _gem_kwargs(weights):
    tree, _ = weights
    return dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="GEM", name_path=POTSDAM,
                ignore_residual=True, slide_stride=32, slide_crop=64, gem_depth=3,
                apply_sim_feat_up=True, prob_thd=0.1, bg_idx=5, clip_config=CFG, params=tree,
                upsampler_params=jax.tree_util.tree_map(
                    np.asarray, init_jbu_one_params(jax.random.PRNGKey(1), 32)))


def test_gem_slice_matches_jax(weights):
    """SegmentorEx with model_type="GEM" (gem_depth 3, ignore_residual),
    SimFeatUp on: probabilities within 2e-3, argmax agreement >= 0.999;
    forward_feature on an 80x96 image (its pos-embed resampled) within 2e-3."""
    kw = _gem_kwargs(weights)
    img = np.random.RandomState(3).randint(0, 256, (1, 96, 128, 3), np.uint8)
    jax_seg = JaxSegmentorEx(**kw)
    want = jax_seg.predict_raw(img)[0]
    seg = SegmentorEx(**kw, device="cpu")
    got = seg.predict_raw(img)[0]
    probs = got["seg_logits"].numpy()
    assert probs.shape == (6, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999

    x = np.random.RandomState(4).randn(1, 3, 80, 96).astype(np.float32)
    want = np.asarray(jax_seg.forward_feature(jnp.asarray(x), logit_size=(40, 48)))
    got = seg.forward_feature(x, logit_size=(40, 48)).numpy()
    assert got.shape == want.shape == (1, 8, 40, 48)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("option", [dict(global_debias_factor=0.2),
                                    dict(cls_token_lambda=0.3), dict(apply_ctd=True)],
                         ids=["global_debias", "cls_token_lambda", "ctd"])
@pytest.mark.parametrize("tower", ["GEM", "BLIP"])
def test_gem_and_blip_refuse_what_reads_the_cls_token(weights, tower, option):
    """GEM and BLIP give patch tokens only: global debias, the CLS-logit
    blend and CTD raise ValueError, as in the JAX package."""
    kw = {**_gem_kwargs(weights), **option}
    if tower == "BLIP":
        kw.update(clip_type="BLIP", model_type="Experimental", params=None, clip_config=None)
    with pytest.raises(ValueError, match="GEM/BLIP"):
        SegmentorEx(**kw, device="cpu")
