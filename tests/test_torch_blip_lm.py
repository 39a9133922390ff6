"""BLIP's generation surface on the port (rs_ov_torch.nn.blip_lm, nn.blip)
against rs_ov.nn.blip_lm / rs_ov.nn.blip on the CPU in fp32, on the decode
golden's tiny config with weights drawn from a seed (every leaf drawn, so
no identity LayerNorm or zero bias hides a fault): captions by beam search
and nucleus sampling, cached and full-prefix, and VQA rank and generate give
JAX's tokens; NLVR and ITM / ITC logits and the multimodal features agree
within 2e-5 (tools/parity_check.py's blip_qq); the NLVR twin checkpoint
names load as the JAX loader loads them."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.nn import blip as jax_blip
from rs_ov.nn import blip_lm as jax_lm
from rs_ov.nn.bert import BertConfig as JaxBertConfig
from rs_ov.nn.blip_vit import BlipVisionConfig as JaxVisionConfig
from rs_ov.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from rs_ov_torch.core.params import (blip_decoder_params_from_numpy, blip_nlvr_params_from_numpy,
                                     blip_params_from_numpy, blip_vqa_params_from_numpy)
from rs_ov_torch.nn import blip, blip_lm
from rs_ov_torch.nn.bert import BertConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig
from rs_ov_torch.text.wordpiece import WordPieceTokenizer
from test_torch_timm_checkpoint import assert_trees_equal
from test_torch_timm_towers import draw

torch.set_num_threads(1)

ATOL = 2e-5  # tools/parity_check.py: blip_qq
VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "blip_decode_vocab.txt")
VISION = dict(image_size=32, patch_size=8, width=24, layers=2, heads=2)
TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=40)
CFG = blip.BlipConfig(vision=BlipVisionConfig(**VISION), text=BertConfig(**TEXT), embed_dim=8)
JAX_CFG = jax_blip.BlipConfig(vision=JaxVisionConfig(**VISION), text=JaxBertConfig(**TEXT),
                              embed_dim=8)


def _drawn(init, seed):
    shapes = jax.eval_shape(lambda k: init(k, JAX_CFG), jax.random.PRNGKey(0))
    tree = draw(shapes, seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def cap():
    jp, tree = _drawn(jax_lm.init_blip_decoder_params, 11)
    return jp, blip_decoder_params_from_numpy(tree)


@pytest.fixture(scope="module")
def vqa():
    jp, tree = _drawn(jax_lm.init_blip_vqa_params, 12)
    return jp, blip_vqa_params_from_numpy(tree)


@pytest.fixture(scope="module")
def toks():
    return JaxWordPiece(VOCAB), WordPieceTokenizer(VOCAB)


def _images(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def _questions(tok):
    rng = np.random.RandomState(1)
    q_ids = rng.randint(4, 60, size=(3, 6)).astype(np.int32)
    q_ids[:, 0] = tok.enc_token_id
    q_mask = np.ones((3, 6), np.int32)
    q_mask[1, 4:] = 0
    ans_ids = rng.randint(4, 60, size=(6, 5)).astype(np.int32)
    ans_ids[:, 0] = tok.bos_token_id
    ans_mask = np.ones((6, 5), np.int32)
    ans_mask[2, 3:] = 0
    ans_ids[2, 3:] = 0
    return q_ids, q_mask, ans_ids, ans_mask


CAPTION_MODES = {"beam": dict(num_beams=3, repetition_penalty=1.2),
                 "nucleus": dict(sample=True, top_p=0.8)}


@pytest.mark.parametrize("mode", list(CAPTION_MODES))
def test_generate_captions_match_jax(cap, toks, mode):
    """The JAX package's cached run against the port's cached and
    full-prefix runs: the same strings (the same tokens: every word of the
    vocabulary decodes apart)."""
    jp, tp = cap
    kw = dict(prompt="a picture of ", max_length=14, min_length=5, **CAPTION_MODES[mode])
    images = _images(3)

    def rng():
        return np.random.RandomState(9) if mode == "nucleus" else None

    want = jax_lm.generate_captions(jp, jnp.asarray(images), JAX_CFG, toks[0], rng=rng(), **kw)
    for use_cache in (True, False):
        got = blip_lm.generate_captions(tp, images, CFG, toks[1], rng=rng(),
                                        use_cache=use_cache, **kw)
        assert got == want, (use_cache, got, want)
    assert len(set(want)) > 1  # the images do not all decode alike


def test_vqa_rank_answers_match_jax(vqa, toks):
    jp, tp = vqa
    q_ids, q_mask, ans_ids, ans_mask = _questions(toks[1])
    images = _images(3, seed=2)
    for k in (3, 6):
        want = jax_lm.vqa_rank_answers(jp, jnp.asarray(images), jnp.asarray(q_ids),
                                       jnp.asarray(q_mask), jnp.asarray(ans_ids),
                                       jnp.asarray(ans_mask), JAX_CFG, k=k)
        got = blip_lm.vqa_rank_answers(tp, images, q_ids, q_mask, ans_ids, ans_mask, CFG, k=k)
        assert got.tolist() == np.asarray(want).tolist(), k


def test_vqa_rank_breaks_ties_in_index_order(vqa, toks):
    """Candidates whose first tokens tie come out lowest index first, as
    jax.lax.top_k gives them: with every answer alike, k=1 takes answer 0."""
    _, tp = vqa
    q_ids, q_mask, ans_ids, ans_mask = _questions(toks[1])
    same = np.repeat(ans_ids[:1], 6, 0)
    got = blip_lm.vqa_rank_answers(tp, _images(3, seed=2), q_ids, q_mask, same,
                                   np.ones_like(same), CFG, k=1)
    assert got.tolist() == [0, 0, 0]


def test_vqa_generate_answers_match_jax(vqa, toks):
    jp, tp = vqa
    q_ids, q_mask, _, _ = _questions(toks[1])
    images = _images(3, seed=2)
    want = jax_lm.vqa_generate_answers(jp, jnp.asarray(images), jnp.asarray(q_ids),
                                       jnp.asarray(q_mask), JAX_CFG, toks[0], num_beams=2,
                                       max_length=8)
    for use_cache in (True, False):
        got = blip_lm.vqa_generate_answers(tp, images, q_ids, q_mask, CFG, toks[1],
                                           num_beams=2, max_length=8, use_cache=use_cache)
        assert got == want, (use_cache, got, want)


def _retrieval_tree(seed):
    """The JAX retrieval tree: BLIP, the MED cross-attention, the ITM head."""
    def init(key, cfg):
        k1, k2, k3 = jax.random.split(key, 3)
        tree = jax_blip.init_blip_params(k1, cfg)
        tree["text"] = jax_lm.add_cross_attention_params(k2, tree["text"], cfg)
        tree["itm_head"] = {"w": jax.random.normal(k3, (2, cfg.text.hidden_size)),
                            "b": jnp.zeros((2,))}
        return tree

    return _drawn(init, seed)


def test_itm_itc_and_multimodal_features_match_jax(toks):
    jtree, tree = _retrieval_tree(13)
    ours = blip_params_from_numpy(tree)
    tok = toks[1]
    enc = tok(["a picture of a tree", "road", "two green build"], max_length=10)
    ids, mask = enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)
    images = _images(3, seed=4)
    args = (jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask), JAX_CFG)
    targs = (torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask), CFG)
    want = jax_blip.blip_multimodal_features(jtree, *args)
    got = blip.blip_multimodal_features(ours, *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for head in ("itm", "itc"):
        want = jax_blip.blip_itm_score(jtree, *args, match_head=head)
        got = blip.blip_itm_score(ours, *targs, match_head=head)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0, err_msg=head)
    with pytest.raises(ValueError, match="match_head"):
        blip.blip_itm_score(ours, *targs, match_head="x")


def _nlvr_inputs(tok):
    enc = tok(["two green trees", "a road of water"], max_length=8)
    ids = enc["input_ids"].astype(np.int32)
    ids[:, 0] = tok.enc_token_id
    return _images(4, seed=5), ids, enc["attention_mask"].astype(np.int32)


def test_nlvr_logits_match_jax(toks):
    """Layer 0 averages the twin streams, layer 1 (num_layers // 2 on) takes
    the merge layer."""
    jtree, tree = _drawn(jax_lm.init_blip_nlvr_params, 14)
    ours = blip_nlvr_params_from_numpy(tree)
    assert not hasattr(ours.text_encoder.layers[0], "merge_w")
    assert hasattr(ours.text_encoder.layers[1], "merge_w")
    images, ids, mask = _nlvr_inputs(toks[1])
    want = jax_lm.blip_nlvr_forward(jtree, jnp.asarray(images), jnp.asarray(ids),
                                    jnp.asarray(mask), JAX_CFG)
    got = blip_lm.blip_nlvr_forward(ours, images, ids, mask, CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _ln_sd(sd, name, p):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]


def _visual_sd(sd, v):
    """The BLIP ViT's timm names (visual_encoder.*) for a JAX visual tree."""
    sd["visual_encoder.patch_embed.proj.weight"] = v["patch_embed"]["w"]
    sd["visual_encoder.patch_embed.proj.bias"] = v["patch_embed"]["b"]
    sd["visual_encoder.cls_token"] = v["cls_token"].reshape(1, 1, -1)
    sd["visual_encoder.pos_embed"] = v["pos_embed"][None]
    for i, b in enumerate(v["blocks"]):
        pre = f"visual_encoder.blocks.{i}"
        _ln_sd(sd, f"{pre}.norm1", b["norm1"])
        _ln_sd(sd, f"{pre}.norm2", b["norm2"])
        for ours, theirs in (("in_proj", "attn.qkv"), ("out_proj", "attn.proj")):
            sd[f"{pre}.{theirs}.weight"] = b["attn"][f"{ours}_w"]
            sd[f"{pre}.{theirs}.bias"] = b["attn"][f"{ours}_b"]
        for ours, theirs in (("c_fc", "mlp.fc1"), ("c_proj", "mlp.fc2")):
            sd[f"{pre}.{theirs}.weight"] = b["mlp"][f"{ours}_w"]
            sd[f"{pre}.{theirs}.bias"] = b["mlp"][f"{ours}_b"]
    _ln_sd(sd, "visual_encoder.norm", v["norm"])


def _bert_sd(sd, t, tp):
    """The MED BertModel names under ``tp`` for a JAX BERT tree: the MED
    cross-attention, or the NLVR twins (self0 / self1, dense0 / dense1,
    merge_layer)."""
    sd[f"{tp}.embeddings.word_embeddings.weight"] = t["embeddings"]["word"]
    sd[f"{tp}.embeddings.position_embeddings.weight"] = t["embeddings"]["position"]
    sd[f"{tp}.embeddings.token_type_embeddings.weight"] = t["embeddings"]["token_type"]
    _ln_sd(sd, f"{tp}.embeddings.LayerNorm", t["embeddings"]["ln"])
    for i, layer in enumerate(t["layers"]):
        pre = f"{tp}.encoder.layer.{i}"
        names = {"q": "attention.self.query", "k": "attention.self.key",
                 "v": "attention.self.value", "attn_out": "attention.output.dense",
                 "inter": "intermediate.dense", "out": "output.dense"}
        for s in ("", "0", "1"):
            if f"x{s}q_w" in layer:
                names.update({f"x{s}q": f"crossattention.self{s}.query",
                              f"x{s}k": f"crossattention.self{s}.key",
                              f"x{s}v": f"crossattention.self{s}.value",
                              f"x{s}_out": f"crossattention.output.dense{s}"})
        if "merge_w" in layer:
            names["merge"] = "crossattention.output.merge_layer"
        for ours, theirs in names.items():
            sd[f"{pre}.{theirs}.weight"] = layer[f"{ours}_w"]
            sd[f"{pre}.{theirs}.bias"] = layer[f"{ours}_b"]
        _ln_sd(sd, f"{pre}.attention.output.LayerNorm", layer["attn_ln"])
        _ln_sd(sd, f"{pre}.crossattention.output.LayerNorm", layer["x_ln"])
        _ln_sd(sd, f"{pre}.output.LayerNorm", layer["out_ln"])


def _nlvr_state_dict(tree):
    sd = {}
    _visual_sd(sd, tree["visual"])
    _bert_sd(sd, tree["text_encoder"], "text_encoder")
    ch = tree["cls_head"]
    sd.update({"cls_head.0.weight": ch["w1"], "cls_head.0.bias": ch["b1"],
               "cls_head.2.weight": ch["w2"], "cls_head.2.bias": ch["b2"]})
    return sd


def test_nlvr_twin_state_dict_loader_matches_jax(toks):
    """The reference's NLVR names (self0 / self1, dense0 / dense1,
    merge_layer, cls_head.0 / .2) load into the tree the JAX loader makes,
    and the loaded model gives the tree's logits."""
    _, tree = _drawn(jax_lm.init_blip_nlvr_params, 15)
    sd = _nlvr_state_dict(tree)
    ours = blip_lm.blip_nlvr_params_from_state_dict(sd)
    want = jax.tree_util.tree_map(np.asarray, jax_lm.blip_nlvr_params_from_state_dict(sd))
    assert_trees_equal({k: v.numpy() for k, v in ours.state_dict().items()},
                       {k: np.asarray(v) for k, v in _flat(want).items()})
    images, ids, mask = _nlvr_inputs(toks[1])
    np.testing.assert_array_equal(
        blip_lm.blip_nlvr_forward(ours, images, ids, mask, CFG).numpy(),
        blip_lm.blip_nlvr_forward(blip_nlvr_params_from_numpy(tree), images, ids, mask,
                                  CFG).numpy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_caption_and_vqa_state_dict_loaders_match_jax():
    """A caption checkpoint's names (text_decoder.bert.*, the LM head under
    text_decoder.cls.predictions) and a VQA one's (text_encoder.* besides)
    through both packages' loaders: equal trees, equal to the tree written."""
    _, tree = _drawn(jax_lm.init_blip_vqa_params, 16)
    sd = {}
    _visual_sd(sd, tree["visual"])
    _bert_sd(sd, tree["text_decoder"], "text_decoder.bert")
    h, pre = tree["lm_head"], "text_decoder.cls.predictions"
    sd.update({f"{pre}.transform.dense.weight": h["t_w"], f"{pre}.transform.dense.bias": h["t_b"],
               f"{pre}.transform.LayerNorm.weight": h["t_ln"]["scale"],
               f"{pre}.transform.LayerNorm.bias": h["t_ln"]["bias"],
               f"{pre}.decoder.weight": h["dec_w"], f"{pre}.bias": h["dec_b"]})
    got = blip_lm.blip_decoder_params_from_state_dict(sd)
    want = jax.tree_util.tree_map(np.asarray, jax_lm.blip_decoder_params_from_state_dict(sd))
    got = {k: v.numpy() for k, v in got.state_dict().items()}
    assert_trees_equal(got, _flat(want))
    assert_trees_equal(got, _flat({k: tree[k] for k in ("visual", "text_decoder", "lm_head")}))
    _bert_sd(sd, tree["text_encoder"], "text_encoder")
    got = blip_lm.blip_vqa_params_from_state_dict(sd)
    want = jax.tree_util.tree_map(np.asarray, jax_lm.blip_vqa_params_from_state_dict(sd))
    assert_trees_equal({k: v.numpy() for k, v in got.state_dict().items()}, _flat(want))
