"""The port's checkpoint loaders (rs_ov_torch.core.checkpoint) against the
JAX package's, on state dicts in the reference's names that the tests write
themselves from one set of tiny JAX weights: the same trees (exactly), the
same inferred config, and SegmentorEx(checkpoint_path=..., model_path=...)
with the same predictions (probs within 2e-3, argmax >= 0.999)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core import checkpoint as jax_ckpt
from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params, init_jbu_stack_params
from rs_ov.utils.safetensors import load_safetensors as jax_load_safetensors
from rs_ov_torch.core import checkpoint as ckpt
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.utils.safetensors import load_safetensors, save_safetensors

torch.set_num_threads(1)

# the tiny arch of tools/parity_check.py:68-70
CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                        output_dim=32, head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=64, heads=1,
                    layers=2, output_dim=32))
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]


def _blocks(sd, prefix, blocks):
    for i, b in enumerate(blocks):
        q = f"{prefix}.transformer.resblocks.{i}" if prefix else f"transformer.resblocks.{i}"
        _ln(sd, f"{q}.ln_1", b["ln_1"])
        _ln(sd, f"{q}.ln_2", b["ln_2"])
        a, m = b["attn"], b["mlp"]
        sd[f"{q}.attn.in_proj_weight"], sd[f"{q}.attn.in_proj_bias"] = a["in_proj_w"], a["in_proj_b"]
        sd[f"{q}.attn.out_proj.weight"], sd[f"{q}.attn.out_proj.bias"] = (a["out_proj_w"],
                                                                          a["out_proj_b"])
        sd[f"{q}.mlp.c_fc.weight"], sd[f"{q}.mlp.c_fc.bias"] = m["c_fc_w"], m["c_fc_b"]
        sd[f"{q}.mlp.c_proj.weight"], sd[f"{q}.mlp.c_proj.bias"] = m["c_proj_w"], m["c_proj_b"]


def _clip_state_dict(tree):
    """The JAX CLIP pytree in open_clip's names."""
    v, t = tree["visual"], tree["text"]
    sd = {"visual.conv1.weight": v["conv1_w"], "visual.class_embedding": v["class_embedding"],
          "visual.positional_embedding": v["positional_embedding"], "visual.proj": v["proj"],
          "token_embedding.weight": t["token_embedding"],
          "positional_embedding": t["positional_embedding"],
          "text_projection": t["text_projection"], "logit_scale": tree["logit_scale"]}
    _ln(sd, "visual.ln_pre", v["ln_pre"])
    _ln(sd, "visual.ln_post", v["ln_post"])
    _ln(sd, "ln_final", t["ln_final"])
    _blocks(sd, "visual", v["blocks"])
    _blocks(sd, "", t["blocks"])
    return sd


def _jbu_module(sd, prefix, m):
    sd[f"{prefix}.range_temp"], sd[f"{prefix}.sigma_spatial"] = m["range_temp"], m["sigma_spatial"]
    for name in ("range_proj", "fixup_proj"):
        p = m[name]
        sd[f"{prefix}.{name}.0.weight"], sd[f"{prefix}.{name}.0.bias"] = p["w0"], p["b0"]
        sd[f"{prefix}.{name}.3.weight"], sd[f"{prefix}.{name}.3.bias"] = p["w1"], p["b1"]


def _jbu_state_dict(tree):
    """A SimFeatUp checkpoint as the reference saves it: under 'upsampler.'."""
    sd = {"upsampler.fixup_proj.1.weight": tree["final_fixup"]["w"],
          "upsampler.fixup_proj.1.bias": tree["final_fixup"]["b"]}
    if "up" in tree:
        _jbu_module(sd, "upsampler.up", tree["up"])
    else:
        for i, m in enumerate(tree["ups"], 1):
            _jbu_module(sd, f"upsampler.up{i}", m)
    return sd


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def trees():
    return (_np_tree(init_clip_params(jax.random.PRNGKey(0), CFG)),
            _np_tree(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)),
            _np_tree(init_jbu_stack_params(jax.random.PRNGKey(2), CFG.embed_dim)))


def _write(sd, path, fmt):
    tensors = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    if fmt == "safetensors":
        save_safetensors(tensors, path)
    else:
        torch.save({"state_dict": tensors} if fmt == "wrapped" else tensors, path)


@pytest.fixture(scope="module")
def files(trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for fmt, ext in (("torch", ".pt"), ("safetensors", ".safetensors"), ("wrapped", ".ckpt")):
        for name, sd in (("clip", _clip_state_dict(trees[0])), ("jbu_one", _jbu_state_dict(trees[1])),
                         ("jbu_stack", _jbu_state_dict(trees[2]))):
            out[name, fmt] = str(d / f"{name}_{fmt}{ext}")
            _write(sd, out[name, fmt], fmt)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _assert_module_equals_tree(module, tree):
    flat = _flat(tree)
    params = {k: v.numpy() for k, v in module.named_parameters()}
    assert sorted(params) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(params[k], v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("fmt", ["torch", "safetensors", "wrapped"])
def test_loaders_give_the_jax_trees(files, fmt):
    """load_torch_state_dict, the CLIP and JBU mappings and the inferred
    config equal the JAX package's exactly, for a torch.save'd dict, a
    .safetensors file and a {'state_dict': ...} wrapper."""
    sd = ckpt.load_torch_state_dict(files["clip", fmt])
    want_sd = jax_ckpt.load_torch_state_dict(files["clip", fmt])
    assert sorted(sd) == sorted(want_sd)
    for k in sd:
        assert sd[k].dtype == want_sd[k].dtype, k
        np.testing.assert_array_equal(sd[k], want_sd[k], err_msg=k)

    cfg = ckpt.infer_clip_config_from_state_dict(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_ckpt.infer_clip_config_from_state_dict(want_sd))
    want = _np_tree(jax_ckpt.clip_params_from_state_dict(want_sd))
    for key, fn in (("visual", ckpt.vision_params_from_state_dict),
                    ("text", ckpt.text_params_from_state_dict)):
        got, ref = _flat(fn(sd, "visual." if key == "visual" else "")), _flat(want[key])
        assert sorted(got) == sorted(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _assert_module_equals_tree(ckpt.clip_params_from_state_dict(sd), want)

    for name in ("jbu_one", "jbu_stack"):
        up_sd = ckpt.load_torch_state_dict(files[name, fmt])
        _assert_module_equals_tree(
            ckpt.jbu_params_from_state_dict(up_sd, name),
            _np_tree(jax_ckpt.jbu_params_from_state_dict(
                jax_ckpt.load_torch_state_dict(files[name, fmt]), name)))


def test_segmentor_from_checkpoints_matches_jax(files):
    """SegmentorEx(checkpoint_path=..., sim_feat_up_cfg={'model_path': ...})
    in both packages: probs within 2e-3, argmax agreement >= 0.999."""
    kw = dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
              name_path=POTSDAM, slide_stride=32, slide_crop=64, global_debias_factor=0.2,
              apply_sim_feat_up=True, prob_thd=0.1, bg_idx=5, clip_config=CFG,
              checkpoint_path=files["clip", "torch"],
              sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=2,
                                   model_path=files["jbu_one", "safetensors"]))
    img = np.random.RandomState(3).randint(0, 256, (1, 96, 128, 3), np.uint8)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    np.testing.assert_allclose(got["seg_logits"].numpy(), np.asarray(want["seg_logits"]),
                               atol=2e-3, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999


def test_misnamed_extra_and_misshapen_keys_raise(trees, monkeypatch):
    sd = _clip_state_dict(trees[0])
    misnamed = dict(sd)
    misnamed["visual.ln_post.gamma"] = misnamed.pop("visual.ln_post.weight")
    with pytest.raises(KeyError, match="visual.ln_post.weight"):
        ckpt.clip_params_from_state_dict(misnamed, CFG)
    extra = {**sd, "visual.transformer.resblocks.0.ls_1.gamma": np.ones(64, np.float32)}
    with pytest.raises(KeyError, match="unused.*visual.blocks.0.ls_1"):
        ckpt.clip_params_from_state_dict(extra, CFG)
    wrong = {**sd, "visual.proj": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="visual.proj"):
        ckpt.clip_params_from_state_dict(wrong, CFG)
    up = _jbu_state_dict(trees[1])
    del up["upsampler.up.range_temp"]
    with pytest.raises(KeyError, match="up.range_temp"):
        ckpt.jbu_params_from_state_dict(up, "jbu_one")
    # a timm-named ViT export takes the timm loader (item 8d), strict too;
    # a ConvNeXt trunk export (item 8e) loads under its config, and one cut
    # short raises KeyError
    timm = {"visual.trunk.patch_embed.proj.weight": np.zeros((8, 3, 16, 16), np.float32)}
    with pytest.raises(KeyError, match="pos_embed"):
        ckpt.clip_params_from_state_dict(timm)
    with pytest.raises(KeyError, match="pos_embed"):
        ckpt.infer_clip_config_from_state_dict(timm)
    from test_torch_timm_checkpoint import export
    from test_torch_timm_towers import CONVNEXT, jax_tree, register, timm_cfg

    cfg = timm_cfg("tiny-convnext", 64, proj="linear")
    register(monkeypatch, "tiny-convnext", CONVNEXT, cfg)
    convnext = export(jax_tree(cfg), CONVNEXT)
    clip = ckpt.clip_params_from_state_dict(convnext, cfg)
    np.testing.assert_array_equal(clip.visual.trunk.stem_conv_w.numpy(),
                                  convnext["visual.trunk.stem.0.weight"])
    del convnext["visual.trunk.stages.3.blocks.0.gamma"]
    with pytest.raises(KeyError, match="stages.3.blocks.0.gamma"):
        ckpt.clip_params_from_state_dict(convnext, cfg)
    with pytest.raises(KeyError):  # without the config's timm name: read as a timm ViT
        ckpt.clip_params_from_state_dict(convnext)


def test_safetensors_round_trip_with_the_jax_reader(tmp_path):
    """The port's writer is read back by both readers, bf16 included."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g).bfloat16(),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "d": np.arange(4, dtype=np.uint8)}
    path = str(tmp_path / "t.safetensors")
    save_safetensors(tensors, path, metadata={"format": "pt"})
    ours, theirs = load_safetensors(path), jax_load_safetensors(path)
    assert sorted(ours) == sorted(theirs) == ["a", "b", "c", "d"]
    for k, v in tensors.items():
        v = torch.as_tensor(v)
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
        np.testing.assert_array_equal(np.asarray(theirs[k], np.float64),
                                      v.double().numpy(), err_msg=k)
