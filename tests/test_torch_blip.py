"""BLIP on the port against the JAX package, on the CPU in fp32 with the same
weights: the WordPiece tokenizer (exact), the BERT encoder (5e-4), the BLIP
ViT's q.q last block (blip_qq, 2e-5), the checkpoint loaders (one synthetic
state dict with the reference's names through both) and the whole slice
with SimFeatUp (2e-3) (tools/parity_check.py:72-85)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.nn import blip as jax_blip
from rs_ov.nn.bert import BertConfig as JaxBertConfig
from rs_ov.nn.bert import bert_encode as jax_bert_encode
from rs_ov.nn.blip_vit import BlipVisionConfig as JaxVisionConfig
from rs_ov.nn.blip_vit import blip_vit_forward as jax_blip_vit_forward
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.text.templates import OPENAI_IMAGENET_TEMPLATES
from rs_ov.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.core.params import blip_params_from_numpy
from rs_ov_torch.nn import blip
from rs_ov_torch.nn.bert import BertConfig, bert_encode
from rs_ov_torch.nn.blip_vit import BlipVisionConfig, blip_vit_forward
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.text.wordpiece import WordPieceTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "tests", "fixtures", "blip_decode_vocab.txt")
POTSDAM = os.path.join(REPO, "configs", "cls_potsdam.txt")
VISION = dict(image_size=64, patch_size=16, width=32, layers=2, heads=2)
TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=40)
CFG = blip.BlipConfig(vision=BlipVisionConfig(**VISION), text=BertConfig(**TEXT), embed_dim=16)
JAX_CFG = jax_blip.BlipConfig(vision=JaxVisionConfig(**VISION), text=JaxBertConfig(**TEXT),
                              embed_dim=16)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(np.asarray, jax_blip.init_blip_params(jax.random.PRNGKey(0),
                                                                          JAX_CFG))
    return tree, blip_params_from_numpy(tree)


def test_wordpiece_matches_jax():
    """ids and masks equal over the 80 templates of a few words and over
    strings with punctuation, accents, CJK, control characters and an
    overlong word, at the classifier's max_length 35 and at a cut of 8."""
    words = ["road", "building", "water", "tree", "low vegetation", "clutter"]
    texts = [t.format(w) for w in words for t in OPENAI_IMAGENET_TEMPLATES]
    texts += ["Roads, trees & water!", "a picture of a tree's roots.", "Café crème brûlée",
              "道路 和 建筑", "tab\there\x00 zero", "x" * 150, "roads...building--yes?",
              "TWO green W3 w44 w45"]
    ours, theirs = WordPieceTokenizer(VOCAB), JaxWordPiece(VOCAB)
    for max_length in (35, 8):
        got, want = ours(texts, max_length=max_length), theirs(texts, max_length=max_length)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])
    assert ours.decode(got["input_ids"][1]) == theirs.decode(want["input_ids"][1])


def _state_dict(seed=0, cross=True):
    """A BLIP checkpoint of the tiny config with the reference's names
    (visual_encoder.* timm, text_encoder.* BertModel with the MED
    cross-attention), random values, LayerNorms near 1."""
    rng = np.random.RandomState(seed)
    d, p, h, e = VISION["width"], VISION["patch_size"], TEXT["hidden_size"], 16
    sd = {}

    def put(name, *shape, ln=False):
        sd[name] = ((1.0 if ln else 0.0) + rng.randn(*shape) * (0.1 if ln else 0.05)
                    ).astype(np.float32)

    def lin(name, o, i):
        put(f"{name}.weight", o, i)
        put(f"{name}.bias", o)

    def norm(name, n):
        put(f"{name}.weight", n, ln=True)
        put(f"{name}.bias", n)

    v = "visual_encoder"
    put(f"{v}.patch_embed.proj.weight", d, 3, p, p)
    put(f"{v}.patch_embed.proj.bias", d)
    put(f"{v}.cls_token", 1, 1, d)
    put(f"{v}.pos_embed", 1, (VISION["image_size"] // p) ** 2 + 1, d)
    for i in range(VISION["layers"]):
        b = f"{v}.blocks.{i}"
        norm(f"{b}.norm1", d)
        lin(f"{b}.attn.qkv", 3 * d, d)
        lin(f"{b}.attn.proj", d, d)
        norm(f"{b}.norm2", d)
        lin(f"{b}.mlp.fc1", 4 * d, d)
        lin(f"{b}.mlp.fc2", d, 4 * d)
    norm(f"{v}.norm", d)
    lin("vision_proj", e, d)
    t = "text_encoder"
    put(f"{t}.embeddings.word_embeddings.weight", TEXT["vocab_size"], h)
    put(f"{t}.embeddings.position_embeddings.weight", TEXT["max_position_embeddings"], h)
    put(f"{t}.embeddings.token_type_embeddings.weight", 2, h)
    norm(f"{t}.embeddings.LayerNorm", h)
    for i in range(TEXT["num_layers"]):
        b = f"{t}.encoder.layer.{i}"
        for kind in ("attention", "crossattention")[:2 if cross else 1]:
            for proj in ("query", "key", "value"):
                lin(f"{b}.{kind}.self.{proj}", h, h)
            lin(f"{b}.{kind}.output.dense", h, h)
            norm(f"{b}.{kind}.output.LayerNorm", h)
        lin(f"{b}.intermediate.dense", TEXT["intermediate_size"], h)
        lin(f"{b}.output.dense", h, TEXT["intermediate_size"])
        norm(f"{b}.output.LayerNorm", h)
    lin("text_proj", e, h)
    lin("itm_head", 2, h)
    sd["temp"] = np.float32(0.07)
    return sd


def _ids(seed, n=3, length=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 63, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    mask[1, 7:] = 0  # a padded row
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("case", ["padding", "encoder_states", "causal_positions"])
def test_bert_encode_matches_jax(case):
    """bert_encode with a padding mask; with encoder states through the MED
    cross-attention (and their own mask); and causal with explicit
    position ids: within 5e-4."""
    sd = _state_dict(1)
    tree = jax_blip.bert_params_from_state_dict(sd, "text_encoder")
    ours = blip.bert_params_from_state_dict(sd, "text_encoder")
    ids, mask = _ids(2)
    kw, tkw = {}, {}
    if case == "encoder_states":
        rng = np.random.RandomState(3)
        enc = rng.randn(3, 5, TEXT["hidden_size"]).astype(np.float32)
        emask = np.ones((3, 5), np.int32)
        emask[0, 4:] = 0
        kw = dict(encoder_hidden_states=jnp.asarray(enc),
                  encoder_attention_mask=jnp.asarray(emask))
        tkw = dict(encoder_hidden_states=torch.from_numpy(enc),
                   encoder_attention_mask=torch.from_numpy(emask))
    elif case == "causal_positions":
        pos = np.stack([np.arange(12) + 2] * 3).astype(np.int32)
        kw = dict(causal=True, position_ids=jnp.asarray(pos))
        tkw = dict(causal=True, position_ids=torch.from_numpy(pos))
    want = np.asarray(jax_bert_encode(tree, jnp.asarray(ids), jnp.asarray(mask),
                                      JAX_CFG.text, **kw))
    got = bert_encode(ours, torch.from_numpy(ids), torch.from_numpy(mask), CFG.text,
                      **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("ignore_residual", [False, True])
def test_blip_vit_forward_matches_jax(ignore_residual):
    """The BLIP ViT, its last block plain or the residual-free q.q one:
    within 2e-5 (blip_qq)."""
    sd = _state_dict(4)
    tree = jax_blip.blip_visual_params_from_state_dict(sd)
    ours = blip.blip_visual_params_from_state_dict(sd)
    img = np.random.RandomState(5).randn(2, 3, 64, 64).astype(np.float32)
    want = np.asarray(jax_blip_vit_forward(tree, jnp.asarray(img), JAX_CFG.vision,
                                           ignore_residual=ignore_residual))
    got = blip_vit_forward(ours, torch.from_numpy(img), CFG.vision,
                           ignore_residual=ignore_residual).numpy()
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_blip_params_from_state_dict_matches_jax():
    """One synthetic checkpoint with the reference's names through both
    loaders: every leaf equal, and equal image and text encodings."""
    sd = _state_dict(6)
    tree = jax.tree_util.tree_map(np.asarray, jax_blip.blip_params_from_state_dict(sd))
    ours = blip.blip_params_from_state_dict(sd)
    again = blip_params_from_numpy(tree)  # the JAX loader's tree through the bridge
    for name, p in again.named_parameters():
        torch.testing.assert_close(dict(ours.named_parameters())[name], p, rtol=0, atol=0)
    img = np.random.RandomState(7).randn(2, 3, 64, 64).astype(np.float32)
    want = np.asarray(jax_blip.blip_encode_image(tree, jnp.asarray(img), JAX_CFG))
    got = blip.blip_encode_image(ours, torch.from_numpy(img), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    ids, mask = _ids(8)
    want = np.asarray(jax_blip.blip_encode_text(tree, jnp.asarray(ids), jnp.asarray(mask),
                                                JAX_CFG))
    got = blip.blip_encode_text(ours, torch.from_numpy(ids), torch.from_numpy(mask), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_nlvr_twin_checkpoint_is_refused():
    sd = _state_dict(9, cross=False)
    sd["text_encoder.encoder.layer.0.crossattention.self0.query.weight"] = np.zeros((16, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        blip.bert_params_from_state_dict(sd, "text_encoder")


def test_blip_slice_matches_jax(weights):
    """SegmentorEx with clip_type="BLIP" (crops resized to the tower's 64,
    the q.q last block), the text classifier from the committed WordPiece
    vocabulary through each package's BERT tower, SimFeatUp on:
    probabilities within 2e-3, argmax agreement >= 0.999."""
    tree, _ = weights
    kw = dict(clip_type="BLIP", vit_type="ViT-B/16", name_path=POTSDAM, ignore_residual=True,
              slide_stride=40, slide_crop=80, apply_sim_feat_up=True, prob_thd=0.1, bg_idx=5,
              blip_vocab_path=VOCAB, params=tree,
              upsampler_params=jax.tree_util.tree_map(
                  np.asarray, init_jbu_one_params(jax.random.PRNGKey(1), 16)))
    img = np.random.RandomState(10).randint(0, 256, (1, 96, 128, 3), np.uint8)
    jax_seg = JaxSegmentorEx(**kw, clip_config=JAX_CFG)
    want = jax_seg.predict_raw(img)[0]
    seg = SegmentorEx(**kw, clip_config=CFG, device="cpu")
    got = seg.predict_raw(img)[0]
    np.testing.assert_allclose(seg.query_features.numpy(), np.asarray(jax_seg.query_features),
                               atol=2e-5, rtol=0)
    probs = got["seg_logits"].numpy()
    assert probs.shape == (6, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999
