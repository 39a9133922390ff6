"""HF-hub packaging on the port against the JAX package, on the CPU: the
open_clip-named export (LayerScale and the text projection bias included),
the save_for_hub directory (config JSON and README equal to the JAX
package's), its round trip through create_model in both packages (outputs
equal in the port, within tools/parity_check.py:72-85's vit_tokens 5e-4 and
query_features 2e-5 against the JAX package), and the upload's refusal."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from rs_ov import factory as jax_factory
from rs_ov import hub as jax_hub
from rs_ov.core import config as jax_config
from rs_ov.core.params import _init_clip_params_impl as jax_init_impl
from rs_ov_torch import factory, hub
from rs_ov_torch.core import config
from rs_ov_torch.core.params import clip_params_from_numpy
from rs_ov_torch.utils.safetensors import load_safetensors

torch.set_num_threads(1)

VIT_TOL, TEXT_TOL = 5e-4, 2e-5
TINY = config.CLIPConfig(
    embed_dim=32,
    vision=config.VisionConfig(image_size=64, patch_size=16, width=64, layers=2,
                               output_dim=32, head_width=32, ls_init_value=1e-4),
    text=config.TextConfig(context_length=77, vocab_size=49408, width=48, heads=2, layers=1,
                           output_dim=32, proj_bias=True))
NAME = "tiny-hub-ViT-M-16-alt"
CARD = {"description": "A tiny tower.", "details": {"Dataset": "LAION-2B", "Size": [1, 2]},
        "tags": ("clip", "remote-sensing"), "citation": "@misc{x}"}


@pytest.fixture
def model(monkeypatch):
    """A port model of JAX init weights (LayerScale gammas and the text
    projection bias drawn at random), registered under NAME in both
    packages for the test's length."""
    monkeypatch.setitem(config._MODEL_CONFIGS, NAME, TINY)
    monkeypatch.setitem(jax_config._MODEL_CONFIGS, NAME, TINY)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_impl(jax.random.PRNGKey(0), TINY,
                                                            "float32"))
    rng = np.random.RandomState(1)
    for blk in tree["visual"]["blocks"]:
        blk["ls_1"], blk["ls_2"] = (rng.uniform(0.5, 1.5, 64).astype(np.float32)
                                    for _ in range(2))
    tree["text"]["text_projection_b"] = rng.randn(32).astype(np.float32)
    return tree, factory.CLIPModel(TINY, clip_params_from_numpy(tree, TINY))


def test_clip_state_dict_equals_jax(model):
    tree, m = model
    ours, theirs = hub.clip_state_dict(m), jax_hub.clip_state_dict(tree)
    assert sorted(ours) == sorted(theirs)
    assert "visual.transformer.resblocks.1.ls_2.gamma" in ours
    assert "text_projection.bias" in ours and "text_projection" not in ours
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert hub.clip_state_dict(m.clip).keys() == ours.keys()


def test_save_for_hub_round_trips(model, tmp_path):
    """save_for_hub writes the JAX package's config JSON and README; the
    weights load back through create_model(name, path) in the port with
    equal outputs, and in the JAX package within the stated tolerances."""
    tree, m = model
    out = hub.save_for_hub(m, NAME, str(tmp_path / "ours"), model_card=CARD)
    jax_out = jax_hub.save_for_hub(jax_factory.CLIPModel(cfg=TINY, params=tree), NAME,
                                   str(tmp_path / "theirs"), model_card=CARD)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == sorted(
        [hub.HF_CONFIG_NAME, hub.HF_SAFE_WEIGHTS_NAME, "README.md"])
    for name in (hub.HF_CONFIG_NAME, "README.md"):
        with open(os.path.join(out, name)) as a, open(os.path.join(jax_out, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out, hub.HF_CONFIG_NAME)) as f:
        assert json.load(f)["preprocess_cfg"]["resize_mode"] == "shortest"
    assert hub.generate_readme(CARD, NAME) == jax_hub.generate_readme(CARD, NAME)

    weights = os.path.join(out, hub.HF_SAFE_WEIGHTS_NAME)
    saved = load_safetensors(weights)
    assert saved["logit_scale"].shape == () and saved["logit_scale"].dtype == torch.float32
    back = factory.create_model(NAME, weights, device="cpu")
    images = np.random.RandomState(2).randn(2, 3, 64, 64).astype(np.float32)
    ids = np.zeros((2, 77), np.int32)
    ids[:, :4] = [[49406, 320, 1929, 49407], [49406, 2368, 269, 49407]]
    for a, b in zip(back.encode_image(images, output_cls_token=True),
                    m.encode_image(images, output_cls_token=True)):
        assert torch.equal(a, b)
    assert torch.equal(back.encode_text(ids), m.encode_text(ids))
    jm = jax_factory.create_model(NAME, weights)
    for a, b in zip(back.encode_image(images, output_cls_token=True),
                    jm.encode_image(images, output_cls_token=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=VIT_TOL, rtol=0)
    np.testing.assert_allclose(back.encode_text(ids, normalize=True).numpy(),
                               np.asarray(jm.encode_text(ids, normalize=True)),
                               atol=TEXT_TOL, rtol=0)


def test_push_to_hf_hub_stages_then_refuses(model, tmp_path):
    _, m = model
    staged = tmp_path / "staged"
    with pytest.raises(RuntimeError, match="huggingface-cli upload org/tiny"):
        hub.push_to_hf_hub(m, NAME, "org/tiny", save_directory=str(staged))
    assert sorted(os.listdir(staged)) == sorted(
        [hub.HF_CONFIG_NAME, hub.HF_SAFE_WEIGHTS_NAME, "README.md"])


def test_model_cfg_of_a_clipa_export_equals_jax(tmp_path):
    """The family's preprocess config goes with a CLIPA name ('squash',
    ImageNet statistics), as in the JAX package."""
    cfg = dataclasses.replace(TINY, vision=dataclasses.replace(
        TINY.vision, ls_init_value=None, no_ln_pre=True, pool_type="avg",
        final_ln_after_pool=True))
    tree = jax.tree_util.tree_map(np.asarray, jax_init_impl(jax.random.PRNGKey(3), cfg,
                                                            "float32"))
    tree["text"]["text_projection_b"] = np.zeros(32, np.float32)
    m = factory.CLIPModel(cfg, clip_params_from_numpy(tree, cfg))
    hub.save_for_hub(m, "tiny-ViT-L-14-CLIPA", str(tmp_path / "a"))
    jax_hub.save_for_hub(jax_factory.CLIPModel(cfg=cfg, params=tree), "tiny-ViT-L-14-CLIPA",
                         str(tmp_path / "b"))
    configs = [json.load(open(tmp_path / d / hub.HF_CONFIG_NAME)) for d in ("a", "b")]
    assert configs[0] == configs[1]
    assert configs[0]["preprocess_cfg"]["resize_mode"] == "squash"
