"""The timm towers' checkpoint loaders on the port against the JAX
package's, on synthetic checkpoints written here: an open_clip TimmModel
export (``visual.trunk.*`` in timm's names, ``visual.head.*``) of each
family, and big_vision ``.npz`` files (a classic ViT and a SigLIP). Both
packages load each file; the trees must be equal, and create_model(name,
pretrained=path) in both must agree within max|d|/max|ref| <= 1e-5 (the
tolerance of tools/parity_check.py:72-85 for a tower output). The trees are
drawn from a seeded RandomState (test_torch_timm_towers.draw)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from rs_ov import factory as jax_factory
from rs_ov.core import checkpoint as jax_ckpt
from rs_ov.hub import _export_block as jax_export_block
from rs_ov_torch import factory
from rs_ov_torch.core import checkpoint as ckpt
from rs_ov_torch.core import config
from rs_ov_torch.core.params import VisionTower, load_numpy_tree
from rs_ov_torch.nn import timm_tower as tt
from rs_ov_torch.utils.safetensors import save_safetensors
from test_siglip_npz import _export_blocks as bv_export_blocks
from test_timm_tower_ckpt import _export_convnext
from test_torch_timm_towers import (CONVNEXT, SIGLIP, TEXT, _eva, _images, assert_agree, draw,
                                    jax_tree, register, text_ids, timm_cfg)

torch.set_num_threads(1)


def assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}.{i}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _np(a):
    return np.array(a, np.float32)  # a contiguous copy; 0-d stays 0-d


def _export_siglip(tr, sd, t="visual.trunk."):
    ap = tr["attn_pool"]
    sd.update({t + "patch_embed.proj.weight": _np(tr["patch_embed_w"]),
               t + "patch_embed.proj.bias": _np(tr["patch_embed_b"]),
               t + "pos_embed": _np(tr["pos_embed"])[None],
               t + "norm.weight": _np(tr["norm"]["scale"]),
               t + "norm.bias": _np(tr["norm"]["bias"]),
               t + "attn_pool.latent": _np(ap["latent"])[None],
               t + "attn_pool.norm.weight": _np(ap["norm"]["scale"]),
               t + "attn_pool.norm.bias": _np(ap["norm"]["bias"])})
    for k in ("q", "kv", "proj"):
        sd[t + f"attn_pool.{k}.weight"] = _np(ap[f"{k}_w"])
        sd[t + f"attn_pool.{k}.bias"] = _np(ap[f"{k}_b"])
    for ours, theirs in (("c_fc", "fc1"), ("c_proj", "fc2")):
        sd[t + f"attn_pool.mlp.{theirs}.weight"] = _np(ap["mlp"][f"{ours}_w"])
        sd[t + f"attn_pool.mlp.{theirs}.bias"] = _np(ap["mlp"][f"{ours}_b"])
    for i, blk in enumerate(tr["blocks"]):
        pre = t + f"blocks.{i}."
        for ours, theirs in (("ln_1", "norm1"), ("ln_2", "norm2")):
            sd[pre + f"{theirs}.weight"] = _np(blk[ours]["scale"])
            sd[pre + f"{theirs}.bias"] = _np(blk[ours]["bias"])
        sd[pre + "attn.qkv.weight"] = _np(blk["attn"]["in_proj_w"])
        sd[pre + "attn.qkv.bias"] = _np(blk["attn"]["in_proj_b"])
        sd[pre + "attn.proj.weight"] = _np(blk["attn"]["out_proj_w"])
        sd[pre + "attn.proj.bias"] = _np(blk["attn"]["out_proj_b"])
        for ours, theirs in (("c_fc", "fc1"), ("c_proj", "fc2")):
            sd[pre + f"mlp.{theirs}.weight"] = _np(blk["mlp"][f"{ours}_w"])
            sd[pre + f"mlp.{theirs}.bias"] = _np(blk["mlp"][f"{ours}_b"])


def _export_eva(tr, arch, sd, t="visual.trunk."):
    """timm eva.py names; a fused qkv as ``qkv.weight`` with ``q_bias`` /
    ``v_bias`` (no k bias, whose slot in the tree is then zeroed)."""
    sd.update({t + "patch_embed.proj.weight": _np(tr["patch_embed_w"]),
               t + "patch_embed.proj.bias": _np(tr["patch_embed_b"]),
               t + "cls_token": _np(tr["cls_token"])[None, None],
               t + "pos_embed": _np(tr["pos_embed"])[None],
               t + "norm.weight": _np(tr["norm"]["scale"]),
               t + "norm.bias": _np(tr["norm"]["bias"]),
               t + "head.weight": _np(tr["head_w"]), t + "head.bias": _np(tr["head_b"])})
    w = arch.width
    for i, blk in enumerate(tr["blocks"]):
        pre = t + f"blocks.{i}."
        for ours, theirs in (("ln_1", "norm1"), ("ln_2", "norm2"), ("inner_norm", "attn.norm")):
            if ours in blk:
                sd[pre + f"{theirs}.weight"] = _np(blk[ours]["scale"])
                sd[pre + f"{theirs}.bias"] = _np(blk[ours]["bias"])
        if arch.fused_qkv:
            blk["in_proj_b"][w:2 * w] = 0.0
            sd[pre + "attn.qkv.weight"] = _np(blk["in_proj_w"])
            sd[pre + "attn.q_bias"] = _np(blk["in_proj_b"][:w])
            sd[pre + "attn.v_bias"] = _np(blk["in_proj_b"][2 * w:])
        else:
            for k in ("q", "k", "v"):
                sd[pre + f"attn.{k}_proj.weight"] = _np(blk[f"{k}_w"])
            sd[pre + "attn.q_proj.bias"] = _np(blk["q_b"])
            sd[pre + "attn.v_proj.bias"] = _np(blk["v_b"])
        sd[pre + "attn.proj.weight"] = _np(blk["out_proj_w"])
        sd[pre + "attn.proj.bias"] = _np(blk["out_proj_b"])
        m = blk["mlp"]
        for ours, theirs in (("fc1g", "fc1_g"), ("fc1x", "fc1_x"), ("fc1", "fc1"), ("fc2", "fc2")):
            if f"{ours}_w" in m:
                sd[pre + f"mlp.{theirs}.weight"] = _np(m[f"{ours}_w"])
                sd[pre + f"mlp.{theirs}.bias"] = _np(m[f"{ours}_b"])
        if "mlp_norm" in m:
            sd[pre + "mlp.norm.weight"] = _np(m["mlp_norm"]["scale"])
            sd[pre + "mlp.norm.bias"] = _np(m["mlp_norm"]["bias"])


def export(tree, arch):
    """A drawn tree as an open_clip timm-tower state dict: visual.trunk.*,
    visual.head.*, the text tower in open_clip's names, logit scale / bias."""
    sd = {}
    trunk = tree["visual"]["trunk"]
    if arch.family == "convnext":
        _export_convnext(trunk, arch, sd)
    elif arch.family == "siglip_vit":
        _export_siglip(trunk, sd)
    else:
        _export_eva(trunk, arch, sd)
    head = tree["visual"].get("head", {})
    if "mlp" in head:
        for ours, theirs in (("c_fc", "fc1"), ("c_proj", "fc2")):
            sd[f"visual.head.mlp.{theirs}.weight"] = _np(head["mlp"][f"{ours}_w"])
            sd[f"visual.head.mlp.{theirs}.bias"] = _np(head["mlp"][f"{ours}_b"])
    for k in ("proj_w", "proj_b"):
        if k in head:
            sd[f"visual.head.proj.{'weight' if k == 'proj_w' else 'bias'}"] = _np(head[k])
    t = tree["text"]
    sd["token_embedding.weight"] = _np(t["token_embedding"])
    sd["positional_embedding"] = _np(t["positional_embedding"])
    for i, blk in enumerate(t["blocks"]):
        jax_export_block(blk, f"transformer.resblocks.{i}.", sd)
    sd["ln_final.weight"] = _np(t["ln_final"]["scale"])
    sd["ln_final.bias"] = _np(t["ln_final"]["bias"])
    if "text_projection_b" in t:
        sd["text_projection.weight"] = _np(t["text_projection"]).T.copy()
        sd["text_projection.bias"] = _np(t["text_projection_b"])
    else:
        sd["text_projection"] = _np(t["text_projection"])
    sd["logit_scale"] = _np(tree["logit_scale"])
    if "logit_bias" in tree:
        sd["logit_bias"] = _np(tree["logit_bias"])
    return {k: _np(v) for k, v in sd.items()}


CASES = {
    "convnext-linear": (CONVNEXT, dict(image_size=64, proj="linear"), False),
    "convnext-linear-bias": (CONVNEXT, dict(image_size=64, proj="linear"), True),
    "convnext-mlp": (CONVNEXT, dict(image_size=64, proj="mlp"), False),
    "siglip": (SIGLIP, dict(image_size=32, pool="map", proj="none", embed=32,
                            logit_bias=-10.0), False),
    "eva02": (_eva("eva02"), dict(image_size=32, pool="token"), False),
    "eva-fused-qv-bias": (_eva("giant"), dict(image_size=32, pool="token"), False),
    "eva-post-norm": (_eva("post-norm"), dict(image_size=32, pool="token"), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_timm_trunk_export_loads_as_in_jax(case, monkeypatch, tmp_path):
    """Each family's visual.trunk.* export: timm_tower_params_from_state_dict
    gives the JAX package's tree (ConvNeXt's convs HWIO; a head bias where
    the export has one; EVA's fused q_bias / v_bias with a zero k slot), and
    create_model(name, path) in both packages agrees."""
    arch, kw, head_bias = CASES[case]
    name = "tiny-timm"
    cfg = timm_cfg(name, kw.pop("image_size"), **kw)
    register(monkeypatch, name, arch, cfg)
    tree = jax_tree(cfg, seed=3)
    if head_bias:
        tree["visual"]["head"]["proj_b"] = draw({"proj_b": np.zeros(16)}, 4)["proj_b"]
    sd = export(tree, arch)
    got = ckpt.timm_tower_params_from_state_dict(sd, name)
    assert_trees_equal(got, jax.tree_util.tree_map(
        np.asarray, jax_ckpt.timm_tower_params_from_state_dict(sd, name)))
    if arch.family == "eva":
        assert all("k_b" not in b for b in got["trunk"]["blocks"])
    path = str(tmp_path / "timm.safetensors")
    save_safetensors(sd, path)
    tm = factory.create_model(name, path, device="cpu")
    jm = jax_factory.create_model(name, path)
    assert hasattr(getattr(tm.clip.visual, "head", None), "proj_b") == head_bias
    size = cfg.vision.image_size
    assert_agree(tm, jm, _images((2, 3, size, size)), text_ids(cfg))


def test_forced_size_on_a_checkpoint_resamples_the_pos_embed(monkeypatch, tmp_path):
    """A SigLIP export at 32² with force_image_size=48: both packages keep
    the checkpoint's table and resample it at run time."""
    cfg = timm_cfg("tiny-siglip", 32, pool="map", proj="none", embed=32, logit_bias=-10.0)
    register(monkeypatch, "tiny-siglip", SIGLIP, cfg)
    path = str(tmp_path / "siglip.safetensors")
    save_safetensors(export(jax_tree(cfg, seed=5), SIGLIP), path)
    tm = factory.create_model("tiny-siglip", path, device="cpu", force_image_size=48)
    jm = jax_factory.create_model("tiny-siglip", path, force_image_size=48)
    assert tm.cfg.vision.image_size == jm.cfg.vision.image_size == 48
    assert tuple(tm.clip.visual.trunk.pos_embed.shape) == (16, 32)
    assert_agree(tm, jm, _images((2, 3, 48, 48)), text_ids(cfg))


# ---------------------------------------------------------------------------
# big_vision .npz
# ---------------------------------------------------------------------------

SIGLIP_TEXT = dataclasses.replace(TEXT, output_dim=32, pool_type="last", no_causal_mask=True,
                                  proj_bias=True, norm_eps=1e-6)


def _bv_heads(kernel, bias, width, heads, out, pre, name):
    hd = width // heads
    out[pre + f"{name}/kernel"] = kernel.T.reshape(width, heads, hd)
    out[pre + f"{name}/bias"] = bias.reshape(heads, hd)


def _siglip_npz(tree, path, with_t_b=True):
    """A SigLIP tree in big_vision's names (params/img/... with MAPHead_0,
    params/txt/... with Encoder_0 and a head dense)."""
    tr, t = tree["visual"]["trunk"], tree["text"]
    w, heads = SIGLIP.width, SIGLIP.heads
    p, m = "params/img/", "params/img/MAPHead_0/"
    out = {p + "embedding/kernel": tr["patch_embed_w"].transpose(2, 3, 1, 0),
           p + "embedding/bias": tr["patch_embed_b"],
           p + "Transformer/posembed_input/pos_embedding": tr["pos_embed"][None],
           p + "Transformer/encoder_norm/scale": tr["norm"]["scale"],
           p + "Transformer/encoder_norm/bias": tr["norm"]["bias"]}
    bv_export_blocks(tr["blocks"], w, heads, out, p + "Transformer")
    ap = tr["attn_pool"]
    mha = m + "MultiHeadDotProductAttention_0/"
    out[m + "probe"] = ap["latent"][None]
    _bv_heads(ap["q_w"], ap["q_b"], w, heads, out, mha, "query")
    _bv_heads(ap["kv_w"][:w], ap["kv_b"][:w], w, heads, out, mha, "key")
    _bv_heads(ap["kv_w"][w:], ap["kv_b"][w:], w, heads, out, mha, "value")
    out[mha + "out/kernel"] = ap["proj_w"].T.reshape(heads, w // heads, w)
    out[mha + "out/bias"] = ap["proj_b"]
    out[m + "LayerNorm_0/scale"], out[m + "LayerNorm_0/bias"] = (ap["norm"]["scale"],
                                                                 ap["norm"]["bias"])
    for i, leaf in ((0, "c_fc"), (1, "c_proj")):
        out[m + f"MlpBlock_0/Dense_{i}/kernel"] = ap["mlp"][f"{leaf}_w"].T
        out[m + f"MlpBlock_0/Dense_{i}/bias"] = ap["mlp"][f"{leaf}_b"]
    x = "params/txt/"
    out[x + "Embed_0/embedding"] = t["token_embedding"]
    out[x + "pos_embedding"] = t["positional_embedding"][None]
    bv_export_blocks(t["blocks"], SIGLIP_TEXT.width, SIGLIP_TEXT.heads, out, x + "Encoder_0")
    out[x + "Encoder_0/encoder_norm/scale"] = t["ln_final"]["scale"]
    out[x + "Encoder_0/encoder_norm/bias"] = t["ln_final"]["bias"]
    out[x + "head/kernel"] = t["text_projection"]
    out[x + "head/bias"] = t["text_projection_b"]
    if with_t_b:
        out["params/t"] = np.asarray(1.5, np.float32)
        out["params/b"] = np.asarray(-7.0, np.float32)
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    return path


@pytest.mark.parametrize("with_t_b", [True, False], ids=["t-and-b", "defaults"])
def test_siglip_npz_loads_as_in_jax(with_t_b, monkeypatch, tmp_path):
    """siglip_params_from_big_vision_npz gives the JAX tree; create_model on
    the file agrees with the JAX one, logit_scale from ``t`` (else log 10)
    and logit_bias from ``b`` (else the config's)."""
    cfg = dataclasses.replace(
        timm_cfg("tiny-siglip", 32, pool="map", proj="none", embed=32, logit_bias=-10.0),
        text=SIGLIP_TEXT)
    register(monkeypatch, "tiny-siglip", SIGLIP, cfg)
    path = _siglip_npz(jax_tree(cfg, seed=6), str(tmp_path / "siglip.npz"), with_t_b)
    got = ckpt.siglip_params_from_big_vision_npz(path)
    assert_trees_equal(got, jax.tree_util.tree_map(
        np.asarray, jax_ckpt.siglip_params_from_big_vision_npz(path)))
    tm = factory.create_model("tiny-siglip", path, device="cpu")
    jm = jax_factory.create_model("tiny-siglip", path)
    scale, bias = (1.5, -7.0) if with_t_b else (np.log(10.0), -10.0)
    assert float(tm.clip.logit_scale) == pytest.approx(scale, rel=1e-6)
    assert float(tm.clip.logit_bias) == pytest.approx(bias, rel=1e-6)
    assert_agree(tm, jm, _images((2, 3, 32, 32)), text_ids(cfg))


@pytest.mark.parametrize("with_cls", [True, False], ids=["cls", "no-cls"])
def test_big_vision_vit_npz_loads_as_in_jax(with_cls, tmp_path):
    """vision_params_from_big_vision_npz gives the JAX tree (a zero CLS token
    and a zero pos-embed row for a CLS-less tower; identity ln_pre), which
    the port's ViT tower loads strictly."""
    width, heads, hidden, grid = 32, 2, 128, 2
    vit = draw({"conv1_w": np.zeros((width, 3, 16, 16)), "cls": np.zeros(width),
                "pos": np.zeros((grid * grid + with_cls, width)), "proj": np.zeros((width, 24)),
                "norm": {"scale": np.zeros(width), "bias": np.zeros(width)}}, 7)
    blocks = [draw({"ln_1": {"scale": np.zeros(width), "bias": np.zeros(width)},
                    "ln_2": {"scale": np.zeros(width), "bias": np.zeros(width)},
                    "attn": {"in_proj_w": np.zeros((3 * width, width)),
                             "in_proj_b": np.zeros(3 * width),
                             "out_proj_w": np.zeros((width, width)),
                             "out_proj_b": np.zeros(width)},
                    "mlp": {"c_fc_w": np.zeros((hidden, width)), "c_fc_b": np.zeros(hidden),
                            "c_proj_w": np.zeros((width, hidden)),
                            "c_proj_b": np.zeros(width)}}, 8 + i) for i in range(2)]
    p = "params/img/"
    out = {p + "embedding/kernel": vit["conv1_w"].transpose(2, 3, 1, 0),
           p + "Transformer/posembed_input/pos_embedding": vit["pos"][None],
           p + "Transformer/encoder_norm/scale": vit["norm"]["scale"],
           p + "Transformer/encoder_norm/bias": vit["norm"]["bias"],
           p + "head/kernel": vit["proj"]}
    if with_cls:
        out[p + "cls"] = vit["cls"][None, None]
    blk_out = {}
    bv_export_blocks(blocks, width, heads, blk_out, p + "Transformer")
    # the classic ViT names its second LayerNorm LayerNorm_2
    out.update({k.replace("LayerNorm_1", "LayerNorm_2"): v for k, v in blk_out.items()})
    path = str(tmp_path / "bv.npz")
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    got = ckpt.vision_params_from_big_vision_npz(path)
    assert_trees_equal(got, jax.tree_util.tree_map(
        np.asarray, jax_ckpt.vision_params_from_big_vision_npz(path)))
    assert got["positional_embedding"].shape == (grid * grid + 1, width)
    vcfg = config.VisionConfig(image_size=32, patch_size=16, width=width, layers=2,
                               output_dim=24, head_width=16)
    load_numpy_tree(VisionTower(vcfg), got)


def test_hub_export_of_a_timm_tower_refuses(monkeypatch):
    """save_for_hub / clip_state_dict keep refusing a timm tower, as the JAX
    package's hub does."""
    from rs_ov_torch.hub import clip_state_dict

    register(monkeypatch, "tiny-eva", _eva("giant"), timm_cfg("tiny-eva", 32, pool="token"))
    with pytest.raises(NotImplementedError, match="timm-family"):
        clip_state_dict(factory.create_model("tiny-eva", device="cpu"))
    assert isinstance(tt.timm_arch("tiny-eva"), tt.EvaArch)
