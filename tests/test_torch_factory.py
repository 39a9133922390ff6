"""The open_clip entry on the port against the JAX package, on the CPU in
fp32: the registry, create_model from a checkpoint path, a staged registry
tag and a timm-named export, create_model_and_transforms, the device rules,
the inference and train transforms (exactly equal arrays), the GEM API and
SegmentorEx with a timm-named checkpoint. Tiny towers (tools/parity_check.py:67-68's
arch, registered under test names in both packages for the test's length);
tolerances of tools/parity_check.py:72-85: vit_tokens 5e-4 on the image
embeddings, query_features 2e-5 on normalised text embeddings, gem_stream
1e-3 on GEM's heatmaps, logits 2e-3 on the segmentor's probabilities."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from rs_ov import factory as jax_factory
from rs_ov import gem_api as jax_gem_api
from rs_ov import pretrained as jax_pretrained
from rs_ov.core import config as jax_config
from rs_ov.core.params import init_clip_params as jax_init_clip_params
from rs_ov.data.augment import AugmentationCfg as JaxAugmentationCfg
from rs_ov.hub import clip_state_dict as jax_clip_state_dict
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov_torch import factory, gem_api, pretrained
from rs_ov_torch.core import config
from rs_ov_torch.core.checkpoint import (clip_params_from_state_dict,
                                         infer_clip_config_from_state_dict)
from rs_ov_torch.data.augment import AugmentationCfg
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.utils.safetensors import save_safetensors

torch.set_num_threads(1)

VIT_TOL, TEXT_TOL, GEM_TOL, LOGITS_TOL = 5e-4, 2e-5, 1e-3, 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTSDAM = os.path.join(REPO, "configs", "cls_potsdam.txt")

TINY = config.CLIPConfig(
    embed_dim=32,
    vision=config.VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                               output_dim=32, head_width=32),
    text=config.TextConfig(context_length=77, vocab_size=49408, width=48, heads=2, layers=2,
                           output_dim=32))
# each registry arch cut to the tiny widths, its tower options kept
TINY_ARCHS = {
    "tiny-ViT-B-16": TINY,
    "tiny-ViT-M-16-alt": dataclasses.replace(TINY, vision=dataclasses.replace(
        TINY.vision, ls_init_value=1e-4)),
    "tiny-ViT-L-14-CLIPA": dataclasses.replace(
        TINY, vision=dataclasses.replace(TINY.vision, no_ln_pre=True, pool_type="avg",
                                         final_ln_after_pool=True),
        text=dataclasses.replace(TINY.text, context_length=32, vocab_size=1000,
                                 pool_type="last", no_causal_mask=True)),
}


# a tiny arch whose heads the inferred config gets right (64-wide heads,
# QuickGELU): the timm-named exports
TIMM_TINY = config.CLIPConfig(
    embed_dim=32,
    vision=config.VisionConfig(image_size=64, patch_size=16, width=128, layers=2,
                               output_dim=32),
    text=config.TextConfig(context_length=77, vocab_size=49408, width=64, heads=1, layers=1,
                           output_dim=32),
    quick_gelu=True)


@pytest.fixture
def tiny_registry(monkeypatch):
    """The tiny archs in both registries, removed again after the test."""
    for name, cfg in TINY_ARCHS.items():
        monkeypatch.setitem(config._MODEL_CONFIGS, name, cfg)
        monkeypatch.setitem(jax_config._MODEL_CONFIGS, name, cfg)


def _export(name, seed=0):
    """An open_clip-named state dict of JAX init weights for a tiny arch,
    its LayerScale gammas, LayerNorms and biases drawn at random (at their
    init values leaving one out would hardly move the outputs)."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip_params(
        jax.random.PRNGKey(seed), TINY_ARCHS[name]))
    sd = jax_clip_state_dict(tree)
    rng = np.random.RandomState(seed + 1)
    for k, v in sd.items():
        if k.endswith((".gamma", "ln_post.weight", "ln_final.weight")):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("ln_post.bias", "ln_1.bias", "in_proj_bias")):
            sd[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
    return sd


def _save(sd, path):
    save_safetensors(sd, str(path))
    return str(path)


def _ids(n_ctx, vocab):
    ids = np.zeros((2, n_ctx), np.int32)
    ids[0, :4] = [vocab - 2, 5, 7, vocab - 1]
    ids[1, :6] = [vocab - 2, 9, 3, 11, 4, vocab - 1]
    return ids


def _assert_models_agree(tm, jm, images, ids):
    for g, w in zip(tm.encode_image(images, output_cls_token=True),
                    jm.encode_image(images, output_cls_token=True)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VIT_TOL, rtol=0)
    np.testing.assert_allclose(tm.encode_text(ids, normalize=True).numpy(),
                               np.asarray(jm.encode_text(ids, normalize=True)),
                               atol=TEXT_TOL, rtol=0)
    assert float(tm.logit_scale) == pytest.approx(float(jm.logit_scale), rel=1e-6)
    assert tm.visual_patch_size == jm.visual_patch_size


def test_registry_matches_jax():
    """list_models() is the JAX list; every CLIP name resolves to a config
    equal field for field, '/' spellings included; CoCa names name item 9."""
    assert config.list_models() == jax_config.list_models()
    for name in config.list_models() + ["ViT-B/16", "ViT-L/14-quickgelu"]:
        if name in config.COCA_MODELS:
            with pytest.raises(NotImplementedError, match="item 9"):
                config.get_model_config(name)
        else:
            assert dataclasses.asdict(config.get_model_config(name)) == \
                dataclasses.asdict(jax_config.get_model_config(name)), name
    with pytest.raises(KeyError):
        config.get_model_config("ViT-Z-99")


@pytest.mark.parametrize("name", list(TINY_ARCHS))
def test_create_model_and_transforms_from_a_checkpoint_match_jax(name, tiny_registry, tmp_path):
    """create_model_and_transforms(name, path) in both packages on one
    safetensors export: the preprocess gives equal arrays (CLIPA's by its
    family's style), encode_image / encode_text agree."""
    path = _save(_export(name), tmp_path / "w.safetensors")
    tm, tpre, tval = factory.create_model_and_transforms(name, path, device="cpu")
    jm, jpre, _ = jax_factory.create_model_and_transforms(name, path)
    assert tpre is tval and isinstance(tm, factory.CLIPModel)
    assert tm.device.type == "cpu" and tm.dtype == torch.float32
    rng = np.random.RandomState(2)
    raw = [rng.randint(0, 256, (90, 120, 3), np.uint8), rng.randint(0, 256, (80, 64, 3),
                                                                    np.uint8)]
    images = np.stack([tpre(r) for r in raw])
    np.testing.assert_array_equal(images, np.stack([jpre(r) for r in raw]))
    cfg = TINY_ARCHS[name]
    _assert_models_agree(tm, jm, images, _ids(cfg.text.context_length, cfg.text.vocab_size))


def test_create_model_device_and_precision(tiny_registry, monkeypatch):
    """No device means the card: without one create_model raises, nothing
    falls back; device='cpu' runs on the CPU; 'bf16' and 'fp16' give bf16
    weights; random weights come from the seed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.create_model("tiny-ViT-B-16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gem_api.create_gem_model("tiny-ViT-B-16")
    a = factory.create_model("tiny-ViT-B-16", device="cpu", seed=3)
    b = factory.create_model("tiny-ViT-B-16", device="cpu", seed=3)
    c = factory.create_model("tiny-ViT-B-16", device="cpu", seed=4)
    assert torch.equal(a.clip.visual.proj, b.clip.visual.proj)
    assert not torch.equal(a.clip.visual.proj, c.clip.visual.proj)
    for precision in ("bf16", "fp16"):
        m = factory.create_model("tiny-ViT-M-16-alt", precision=precision, device="cpu")
        assert m.dtype == torch.bfloat16
        out = m.encode_image(np.zeros((1, 3, 64, 64), np.float32))
        assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 32)
    sized = factory.create_model("tiny-ViT-B-16", device="cpu", force_image_size=96)
    assert sized.cfg.vision.image_size == 96
    assert sized.encode_image(np.zeros((1, 3, 96, 96), np.float32)).shape == (1, 36, 32)
    assert factory.create_model("tiny-ViT-B-16", device="cpu",
                                force_quick_gelu=True).cfg.quick_gelu


def test_unported_names_and_losses_name_their_items(tiny_registry, tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        factory.create_model("coca_ViT-B-32", device="cpu")
    for name in ("ViT-B-16-SigLIP", "convnext_base", "EVA02-B-16"):
        with pytest.raises(NotImplementedError, match="8e"):
            factory.create_model(name, device="cpu")
    npz = tmp_path / "w.npz"
    np.savez(npz, x=np.zeros(1))
    with pytest.raises(NotImplementedError, match="8e"):
        factory.create_model("ViT-B-16-SigLIP", str(npz), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        factory.create_loss(None)


def test_registry_tag_resolves_through_the_staged_cache_only(tiny_registry, tmp_path,
                                                             monkeypatch):
    """A tag not staged in the cache raises FileNotFoundError naming its
    source in both packages; staged at <cache>/<org>/<model>/ it loads, and
    both packages agree on it."""
    entry = {"tinytag": pretrained._e(hf_hub="org/tiny-model/")}
    monkeypatch.setitem(pretrained.PRETRAINED, "tiny-ViT-B-16", entry)
    monkeypatch.setitem(jax_pretrained.PRETRAINED, "tiny-ViT-B-16",
                        {"tinytag": jax_pretrained._e(hf_hub="org/tiny-model/")})
    monkeypatch.setenv("RS_OV_CACHE_DIR", str(tmp_path))
    for create in (lambda: factory.create_model("tiny-ViT-B-16", "tinytag", device="cpu"),
                   lambda: jax_factory.create_model("tiny-ViT-B-16", "tinytag")):
        with pytest.raises(FileNotFoundError, match="tinytag"):
            create()
    staged = tmp_path / "org" / "tiny-model" / pretrained.HF_WEIGHTS_NAME
    staged.parent.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in _export("tiny-ViT-B-16", 5).items()},
               str(staged))
    tm = factory.create_model("tiny-ViT-B-16", "tinytag", device="cpu")
    jm = jax_factory.create_model("tiny-ViT-B-16", "tinytag")
    images = np.random.RandomState(3).randn(1, 3, 64, 64).astype(np.float32)
    _assert_models_agree(tm, jm, images, _ids(77, 49408))


def _timm_export(tree, with_cls: bool):
    """The JAX tree's vision tower in timm's names (fused qkv, norm1/2,
    fc1/2, norm, head.proj) under visual.trunk., its text tower in
    open_clip's; without CLS the pos_embed table has no CLS row and there
    is no cls_token; no norm_pre (the tree's ln_pre is the identity)."""
    v = tree["visual"]
    p = "visual.trunk."
    sd = {p + "patch_embed.proj.weight": v["conv1_w"],
          p + "pos_embed": (v["positional_embedding"] if with_cls
                            else v["positional_embedding"][1:])[None],
          p + "norm.weight": v["ln_post"]["scale"], p + "norm.bias": v["ln_post"]["bias"],
          p + "head.proj.weight": v["proj"].T}
    if with_cls:
        sd[p + "cls_token"] = v["class_embedding"][None, None]
    for i, blk in enumerate(v["blocks"]):
        b = f"{p}blocks.{i}."
        sd.update({b + "norm1.weight": blk["ln_1"]["scale"], b + "norm1.bias": blk["ln_1"]["bias"],
                   b + "attn.qkv.weight": blk["attn"]["in_proj_w"],
                   b + "attn.qkv.bias": blk["attn"]["in_proj_b"],
                   b + "attn.proj.weight": blk["attn"]["out_proj_w"],
                   b + "attn.proj.bias": blk["attn"]["out_proj_b"],
                   b + "norm2.weight": blk["ln_2"]["scale"], b + "norm2.bias": blk["ln_2"]["bias"],
                   b + "mlp.fc1.weight": blk["mlp"]["c_fc_w"],
                   b + "mlp.fc1.bias": blk["mlp"]["c_fc_b"],
                   b + "mlp.fc2.weight": blk["mlp"]["c_proj_w"],
                   b + "mlp.fc2.bias": blk["mlp"]["c_proj_b"]})
    sd.update({k: v for k, v in jax_clip_state_dict(tree).items()
               if not k.startswith("visual.")})
    return {k: np.array(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("with_cls", [True, False], ids=["cls", "no-cls"])
def test_timm_named_export_matches_jax(with_cls, tmp_path):
    """A timm-named ViT export: the inferred config equals the JAX one (the
    grid from either count of positions), the weights load to the JAX
    tree's values (a zero CLS row and a zero class embedding where the
    export has none, the identity pre-LN), and create_model on it agrees."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip_params(jax.random.PRNGKey(7),
                                                                    TIMM_TINY))
    sd = _timm_export(tree, with_cls)
    cfg = infer_clip_config_from_state_dict(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_factory.infer_clip_config_from_state_dict(sd))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(TIMM_TINY)
    clip = clip_params_from_state_dict(sd)
    want = jax.tree_util.tree_map(np.asarray, jax_factory.clip_params_from_state_dict(sd))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(clip.named_parameters())
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if not with_cls:
        assert not got["visual.positional_embedding"][0].any()
        assert not got["visual.class_embedding"].any()
    path = _save(sd, tmp_path / "timm.safetensors")
    images = np.random.RandomState(8).randn(2, 3, 64, 64).astype(np.float32)
    _assert_models_agree(factory.create_model("timm-export", path, device="cpu"),
                         jax_factory.create_model("timm-export", path), images,
                         _ids(77, 49408))


def test_segmentor_takes_a_timm_named_checkpoint(tmp_path):
    """SegmentorEx(checkpoint_path=...) on a timm-named export, as the JAX
    segmentor takes it: probabilities within 2e-3, argmax agreement >= 0.999."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init_clip_params(jax.random.PRNGKey(9),
                                                                    TIMM_TINY))
    path = _save(_timm_export(tree, with_cls=False), tmp_path / "timm.safetensors")
    kw = dict(model_type="ClearCLIP", name_path=POTSDAM, slide_stride=32, slide_crop=64,
              clip_config=TIMM_TINY, checkpoint_path=path)
    img = np.random.RandomState(0).randint(0, 256, (1, 80, 96, 3), np.uint8)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    np.testing.assert_allclose(got["seg_logits"].numpy(), np.asarray(want["seg_logits"]),
                               atol=LOGITS_TOL, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999


TRANSFORM_CASES = [
    (224, "shortest", "bicubic", 0), (224, "longest", "bicubic", 0),
    (224, "squash", "bilinear", 0), ((224, 160), "shortest", "bilinear", 0),
    ((160, 224), "longest", "bicubic", 127), ((200, 240), "squash", "bicubic", 0)]


@pytest.mark.parametrize("size,mode,interp,fill", TRANSFORM_CASES,
                         ids=[f"{s}-{m}-{i}-{f}" for s, m, i, f in TRANSFORM_CASES])
def test_image_transform_equals_jax(size, mode, interp, fill):
    """Each resize mode on images wider, taller and smaller than the target,
    a grey image among them: arrays exactly equal (PIL on the uint8 image;
    the scalar 'shortest' mode truncates the long side)."""
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 256, hw + (3,), np.uint8) for hw in ((301, 407), (407, 301),
                                                                 (150, 97))]
    images.append(rng.randint(0, 256, (333, 250), np.uint8))
    kw = dict(image_size=size, resize_mode=mode, interpolation=interp, fill_color=fill,
              mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    ours, theirs = factory.image_transform(**kw), jax_factory.image_transform(**kw)
    for img in images:
        got, want = ours(img), theirs(img)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    cfg = factory.PreprocessCfg(size=size, resize_mode=mode, interpolation=interp,
                                fill_color=fill)
    jcfg = jax_factory.PreprocessCfg(size=size, resize_mode=mode, interpolation=interp,
                                     fill_color=fill)
    np.testing.assert_array_equal(factory.image_transform_v2(cfg, False)(images[0]),
                                  jax_factory.image_transform_v2(jcfg, False)(images[0]))
    for crop in ((50, 60), (400, 500), (120, 500)):
        np.testing.assert_array_equal(factory.center_crop_or_pad(images[0], crop, fill=3),
                                      jax_factory.center_crop_or_pad(images[0], crop, fill=3))


def test_train_transform_equals_jax():
    """The train transform under one seed (random-resized crop, flip,
    colour jitter, grayscale): every draw and so every array equal."""
    aug = dict(scale=(0.5, 1.0), color_jitter=(0.4, 0.4, 0.4), gray_scale_prob=0.3,
               horizontal_flip_prob=0.5)
    ours = factory.image_transform(96, is_train=True, aug_cfg=aug)
    theirs = jax_factory.image_transform(96, is_train=True, aug_cfg=aug)
    rng = np.random.RandomState(5)
    for _ in range(4):
        img = rng.randint(0, 256, (130, 170, 3), np.uint8)
        np.testing.assert_array_equal(ours(img), theirs(img))
    assert dataclasses.asdict(AugmentationCfg()) == dataclasses.asdict(JaxAugmentationCfg())
    assert factory.preprocess_style("ViT-L-14-CLIPA") == jax_factory.preprocess_style(
        "ViT-L-14-CLIPA")
    assert factory.preprocess_style("ViT-L-14", "laion2b_s32b_b82k") == \
        jax_factory.preprocess_style("ViT-L-14", "laion2b_s32b_b82k")


def test_gem_api_matches_jax(tiny_registry, tmp_path):
    """create_gem_model's heatmaps (gem_depth 3, a 96x80 image) within 1e-3,
    the GEM image transform within 1e-5, and visualize's overlays equal."""
    path = _save(_export("tiny-ViT-B-16", 11), tmp_path / "w.safetensors")
    tg = gem_api.create_gem_model("tiny-ViT-B-16", path, gem_depth=3, device="cpu")
    jg = jax_gem_api.create_gem_model("tiny-ViT-B-16", path, gem_depth=3)
    raw = np.random.RandomState(6).randint(0, 256, (70, 90, 3), np.uint8)
    tx, jx = gem_api.get_gem_img_transform((96, 80)), jax_gem_api.get_gem_img_transform((96, 80))
    np.testing.assert_allclose(tx(raw), jx(raw), atol=1e-5, rtol=0)
    image = jx(raw)[None]
    classes = ["road", "building", "tree"]
    np.testing.assert_allclose(tg.encode_text(classes).numpy(),
                               np.asarray(jg.encode_text(classes)), atol=TEXT_TOL, rtol=0)
    want = np.asarray(jg(image, classes))
    got = tg(image, classes)
    assert got.shape == (1, 3, 96, 80) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=GEM_TOL, rtol=0)
    rgb = np.random.RandomState(7).randint(0, 256, (96, 80, 3), np.uint8)
    ours = gem_api.visualize(rgb, classes, want, save_path=str(tmp_path) + os.sep)
    theirs = jax_gem_api.visualize(rgb, classes, want)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o, t)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["w.safetensors"] + [f"heatmap_{c}.png" for c in classes])
