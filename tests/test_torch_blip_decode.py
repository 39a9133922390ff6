"""The KV-cached BERT decode on the port (rs_ov_torch.nn.bert) against
rs_ov.nn.bert on the CPU in fp32, with the same drawn weights: the cache's
cross K/V and every step's hidden state and self K/V at atol 2e-5
(tools/parity_check.py's blip_qq), with and without an encoder mask; and
the port's cached step against its full-prefix step when a beam reorders
the cache rows (a non-trivial ``parent`` permutation each step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.nn import bert as jax_bert
from rs_ov.nn import blip_lm as jax_lm
from rs_ov.nn.blip import BlipConfig as JaxBlipConfig
from rs_ov.nn.blip_vit import BlipVisionConfig as JaxVisionConfig
from rs_ov_torch.core.params import blip_decoder_params_from_numpy
from rs_ov_torch.nn import bert, blip_lm
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig
from test_torch_timm_towers import draw

torch.set_num_threads(1)

ATOL = 2e-5  # tools/parity_check.py: blip_qq
VISION = dict(image_size=32, patch_size=8, width=24, layers=2, heads=2)
TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=40)
CFG = BlipConfig(vision=BlipVisionConfig(**VISION), text=bert.BertConfig(**TEXT), embed_dim=8)
JAX_CFG = JaxBlipConfig(vision=JaxVisionConfig(**VISION), text=jax_bert.BertConfig(**TEXT),
                        embed_dim=8)
MAX_LEN = 9


@pytest.fixture(scope="module")
def weights():
    shapes = jax.eval_shape(lambda k: jax_lm.init_blip_decoder_params(k, JAX_CFG),
                            jax.random.PRNGKey(0))
    tree = draw(shapes, 3)
    return jax.tree_util.tree_map(jnp.asarray, tree), blip_decoder_params_from_numpy(tree)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["all-encoder", "encoder-mask"])
def test_cache_and_steps_match_jax(weights, masked):
    jp, tp = weights
    rng = np.random.RandomState(1)
    enc = rng.randn(2, 5, VISION["width"]).astype(np.float32)
    tokens = rng.randint(0, TEXT["vocab_size"], (MAX_LEN, 2)).astype(np.int32)
    emask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32) if masked else None
    jc = jax_bert.bert_decode_init_cache(jp["text_decoder"], JAX_CFG.text, 2, MAX_LEN,
                                         jnp.asarray(enc))
    tc = bert.bert_decode_init_cache(tp.text_decoder, CFG.text, 2, MAX_LEN, torch.from_numpy(enc))
    for j, t in zip(jc["layers"], tc["layers"]):
        for key in ("xk", "xv"):
            np.testing.assert_allclose(t[key].numpy(), _np(j[key]), atol=ATOL, rtol=0)
    for pos in range(MAX_LEN):
        jh, jc = jax_bert.bert_decode_step(
            jp["text_decoder"], jnp.asarray(tokens[pos]), jnp.asarray(pos, jnp.int32), jc,
            JAX_CFG.text, None if emask is None else jnp.asarray(emask))
        th, tc = bert.bert_decode_step(
            tp.text_decoder, torch.from_numpy(tokens[pos]), pos, tc, CFG.text,
            None if emask is None else torch.from_numpy(emask))
        np.testing.assert_allclose(th.numpy(), _np(jh), atol=ATOL, rtol=0, err_msg=str(pos))
    for j, t in zip(jc["layers"], tc["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), _np(j[key]), atol=ATOL, rtol=0)


def test_cached_step_matches_full_prefix_under_a_parent_permutation(weights):
    """Rows reorder by a different permutation before every step (beams
    swapping parents): each cached step's logits equal the full-prefix
    step's on the reordered sequences, within 2e-5; the tail slots masked at
    -10000 contribute exact fp32 zeros. Skipping the gather breaks it."""
    _, tp = weights
    rng = np.random.RandomState(2)
    embs = torch.from_numpy(rng.randn(3, 5, VISION["width"]).astype(np.float32))
    full = blip_lm.make_caption_step(tp, CFG, MAX_LEN)
    init, step = blip_lm.make_cached_decoder(tp, CFG, MAX_LEN)

    def run(gather):
        cache = init(embs)
        seqs = np.zeros((3, MAX_LEN), np.int32)
        rows = np.arange(3)
        worst = 0.0
        for pos in range(MAX_LEN):
            parent = rng_perm.permutation(3).astype(np.int32) if pos else np.arange(3, dtype=np.int32)
            seqs, rows = seqs[parent], rows[parent]
            seqs[:, pos] = rng_tok.randint(0, TEXT["vocab_size"], 3)
            got, cache = step(seqs[:, pos], pos, cache, parent if gather else np.arange(3))
            want = full(seqs, pos, embs[torch.from_numpy(rows)])
            worst = max(worst, float((got - want).abs().max()))
        return worst

    rng_perm, rng_tok = np.random.RandomState(3), np.random.RandomState(4)
    assert run(True) <= ATOL
    rng_perm, rng_tok = np.random.RandomState(3), np.random.RandomState(4)
    assert run(False) > 1e-3  # the planted fault: the parent gather skipped


def test_cached_decoder_matches_jax_under_a_parent_permutation(weights):
    """make_cached_decoder of both packages on the same steps and parents:
    logits within 2e-5."""
    jp, tp = weights
    rng = np.random.RandomState(5)
    embs = rng.randn(3, 5, VISION["width"]).astype(np.float32)
    jinit, jstep = jax_lm.make_cached_decoder(jp, JAX_CFG, MAX_LEN)
    tinit, tstep = blip_lm.make_cached_decoder(tp, CFG, MAX_LEN)
    jc, tc = jinit(jnp.asarray(embs)), tinit(torch.from_numpy(embs))
    for pos in range(MAX_LEN):
        parent = rng.permutation(3).astype(np.int32)
        toks = rng.randint(0, TEXT["vocab_size"], 3).astype(np.int32)
        jl, jc = jstep(jnp.asarray(toks), pos, jc, jnp.asarray(parent))
        tl, tc = tstep(toks, pos, tc, parent)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=0, err_msg=str(pos))
