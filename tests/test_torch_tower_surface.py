"""The CLIP tower surface on the port against the JAX package, on the CPU in
fp32 with the same weights: LayerScale (ViT-M-16-alt), CLIPA's pooling (no
ln_pre, avg pool, the LN after the pool), output_cls_token, every text
pool_type with no_causal_mask, norm_eps and the projection bias, and the
towers that stay refused. Tolerances of tools/parity_check.py:72-85:
vit_tokens 5e-4 on the ViT's outputs, query_features 2e-5 on normalised text
embeddings."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.core import params as jax_params
from rs_ov.core.config import get_model_config as jax_model_config
from rs_ov.factory import CLIPModel as JaxCLIPModel
from rs_ov.nn.vit import VitCallConfig as JaxCall
from rs_ov.nn.vit import vit_forward as jax_vit_forward
from rs_ov.text.encoder import text_forward as jax_text_forward
from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig, get_model_config
from rs_ov_torch.core.params import CLIP, clip_params_from_numpy, init_clip_params
from rs_ov_torch.factory import CLIPModel
from rs_ov_torch.nn.vit import VitCallConfig, vit_forward
from rs_ov_torch.text.encoder import text_forward

torch.set_num_threads(1)

VIT_TOL, TEXT_TOL = 5e-4, 2e-5

# the tiny arch of tools/parity_check.py:67-68
TINY = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4, output_dim=32,
                        head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2, layers=2,
                    output_dim=32))
LAYERSCALE = dataclasses.replace(TINY, vision=dataclasses.replace(TINY.vision,
                                                                  ls_init_value=1e-4))
CLIPA = dataclasses.replace(TINY, vision=dataclasses.replace(
    TINY.vision, no_ln_pre=True, pool_type="avg", final_ln_after_pool=True))


def _tree(cfg, seed=0):
    """JAX init weights as numpy, with every LayerNorm, LayerScale gamma and
    projection bias drawn at random: at their init values (1, 0, 1e-4)
    leaving one out would hardly move the outputs."""
    tree = jax.tree_util.tree_map(np.asarray, jax_params._init_clip_params_impl(
        jax.random.PRNGKey(seed), cfg, "float32"))
    rng = np.random.RandomState(seed + 10)

    def rand(path, leaf):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-1] in ("scale", "ls_1", "ls_2"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if keys[-1] in ("bias", "text_projection_b"):
            return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(rand, tree)


def _images(seed=1, size=64, n=2):
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


def _vit_pair(cfg, tree, images, **kw):
    jp, jt = jax_vit_forward(jax.tree_util.tree_map(jnp.asarray, tree["visual"]),
                             jnp.asarray(images), cfg.vision,
                             JaxCall(output_cls_token=True, **kw))
    with torch.no_grad():
        tp, tt = vit_forward(clip_params_from_numpy(tree, cfg).visual,
                             torch.from_numpy(images), cfg.vision, VitCallConfig(**kw))
    return (tp.numpy(), tt.numpy()), (np.asarray(jp), np.asarray(jt))


@pytest.mark.parametrize("kw", [dict(model_type="vanilla", ignore_residual=False),
                                dict(model_type="Experimental", apply_outlier_suppression=True,
                                     outlier_top_k=4)],
                         ids=["vanilla-residual", "experimental-decontam"])
def test_layerscale_tower_matches_jax(kw):
    """LayerScale scales both branches of every ordinary block; the
    decontaminated last block's own output leaves it out
    (rs_ov/nn/vit.py:245-256). Dropping the gammas lands far above the bound."""
    tree = _tree(LAYERSCALE)
    images = _images(size=80)  # a 5x5 grid: the pos-embed is interpolated
    got, want = _vit_pair(LAYERSCALE, tree, images, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=VIT_TOL, rtol=0)
    plain = {**tree, "visual": {**tree["visual"], "blocks": [
        {k: v for k, v in blk.items() if k not in ("ls_1", "ls_2")}
        for blk in tree["visual"]["blocks"]]}}
    dropped, _ = _vit_pair(TINY, plain, images, **kw)
    assert np.abs(dropped[0] - want[0]).max() > 100 * VIT_TOL


@pytest.mark.parametrize("model_type", ["vanilla", "ClearCLIP"])
def test_clipa_pooling_matches_jax(model_type):
    """No ln_pre, the mean of the patch tokens as the pooled vector, ln_post
    on the pooled vector only, the tokens un-normalised; the pre-LN applied,
    or the LN taken before the pool, lands above the bound."""
    tree = _tree(CLIPA)
    images = _images(seed=2)
    got, want = _vit_pair(CLIPA, tree, images, model_type=model_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=VIT_TOL, rtol=0)
    for wrong in (dict(no_ln_pre=False), dict(final_ln_after_pool=False)):
        cfg = dataclasses.replace(CLIPA, vision=dataclasses.replace(CLIPA.vision, **wrong))
        faulty, _ = _vit_pair(cfg, tree, images, model_type=model_type)
        assert max(np.abs(f - w).max() for f, w in zip(faulty, want)) > 100 * VIT_TOL


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("output_cls_token", [False, True])
def test_encode_image_output_cls_token_matches_jax(output_cls_token, normalize):
    """CLIPModel.encode_image gives the tokens, or (pooled, tokens) with
    output_cls_token, as rs_ov/factory.py:41-75 does."""
    tree = _tree(TINY)
    images = _images(seed=3)
    want = JaxCLIPModel(cfg=TINY, params=jax.tree_util.tree_map(jnp.asarray, tree)
                        ).encode_image(images, output_cls_token=output_cls_token,
                                       normalize=normalize)
    got = CLIPModel(TINY, clip_params_from_numpy(tree, TINY)).encode_image(
        images, output_cls_token=output_cls_token, normalize=normalize)
    want = want if output_cls_token else (want,)
    got = got if output_cls_token else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VIT_TOL, rtol=0)


TEXT_CASES = [dict(pool_type=p, no_causal_mask=m) for p in ("argmax", "first", "last")
              for m in (False, True)] + [
    dict(pool_type="last", no_causal_mask=True, proj_bias=True, norm_eps=1e-6),
    dict(pool_type="argmax", proj_bias=True)]


@pytest.mark.parametrize("case", TEXT_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_text_tower_options_match_jax(case):
    """A 1000-token vocabulary; rows of 5, 12 and 77 tokens, each ending in
    its highest id (the EOT argmax pools)."""
    cfg = dataclasses.replace(TINY, text=dataclasses.replace(TINY.text, vocab_size=1000,
                                                             **case))
    tree = _tree(cfg, seed=4)
    ids = np.zeros((3, 77), np.int32)
    rng = np.random.RandomState(5)
    for i, n in enumerate((5, 12, 77)):
        ids[i, :n] = rng.randint(1, 998, n)
        ids[i, n - 1] = 999
    for normalize, tol in ((True, TEXT_TOL), (False, VIT_TOL)):
        want = jax_text_forward(jax.tree_util.tree_map(jnp.asarray, tree["text"]),
                                jnp.asarray(ids), cfg.text, quick_gelu_act=True,
                                normalize=normalize)
        with torch.no_grad():
            got = text_forward(clip_params_from_numpy(tree, cfg).text,
                               torch.from_numpy(ids).long(), cfg.text, quick_gelu_act=True,
                               normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def test_vit_m_16_alt_builds_and_matches_jax():
    """ViT-M-16-alt (LayerScale, ls_init_value 1e-4) resolves to the JAX
    config and builds in the port with the JAX init's leaves (it raised
    NotImplementedError before); at its full widths, cut to two layers a
    tower, both packages agree on encode_image and encode_text."""
    cfg = get_model_config("ViT-M-16-alt")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_model_config("ViT-M-16-alt"))
    with torch.device("meta"):
        model = CLIP(cfg)
    shapes = jax.eval_shape(lambda k: jax_params._init_clip_params_impl(k, cfg, "float32"),
                            jax.random.PRNGKey(0))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == flat
    assert "visual.blocks.11.ls_2" in flat
    ours = init_clip_params(torch.Generator().manual_seed(0), dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=1),
        text=dataclasses.replace(cfg.text, layers=1)))
    assert float(ours.visual.blocks[0].ls_1[0]) == pytest.approx(1e-4)

    short = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=2),
                                text=dataclasses.replace(cfg.text, layers=2))
    tree = _tree(short, seed=6)
    jm = JaxCLIPModel(cfg=short, params=jax.tree_util.tree_map(jnp.asarray, tree))
    tm = CLIPModel(short, clip_params_from_numpy(tree, short))
    images = _images(seed=7, size=224, n=1)
    for g, w in zip(tm.encode_image(images, output_cls_token=True),
                    jm.encode_image(images, output_cls_token=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VIT_TOL, rtol=0)
    ids = np.zeros((2, 77), np.int32)
    ids[:, :4] = [[49406, 320, 1929, 49407], [49406, 2368, 269, 49407]]
    np.testing.assert_allclose(tm.encode_text(ids, normalize=True).numpy(),
                               np.asarray(jm.encode_text(ids, normalize=True)),
                               atol=TEXT_TOL, rtol=0)


def test_unported_towers_name_their_item():
    """The timm and HF towers name ROADMAP queue 1 item 8e, CoCa's
    attentional pool and text CLS item 9."""
    base = get_model_config("ViT-B-16")
    for cfg, item in (
            (get_model_config("ViT-B-16-SigLIP"), "8e"),
            (get_model_config("convnext_base"), "8e"),
            (get_model_config("EVA02-B-16"), "8e"),
            (dataclasses.replace(base, text=dataclasses.replace(
                base.text, hf_model_name="roberta-base")), "8e"),
            (dataclasses.replace(base, vision=dataclasses.replace(
                base.vision, attentional_pool=True)), "item 9"),
            (dataclasses.replace(base, text=dataclasses.replace(
                base.text, embed_cls=True)), "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            CLIP(cfg)
