"""The caption and retrieval evaluations on the port
(rs_ov_torch.evalsuite.caption / .retrieval) against rs_ov.evalsuite's on
the CPU in fp32, with the same drawn weights: the caption records (batched
with tail padding, equal to JAX's strings), the shard files and their
merge, the retrieval embeddings and rerank scores (2e-5,
tools/parity_check.py's blip_qq), the dense matrices and recall metrics
(equal), images and videos; two shards merged equal one run."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.evalsuite import caption as jax_caption
from rs_ov.evalsuite import retrieval as jax_retrieval
from rs_ov.nn import blip as jax_blip
from rs_ov.nn import blip_lm as jax_lm
from rs_ov.nn.bert import BertConfig as JaxBertConfig
from rs_ov.nn.blip_vit import BlipVisionConfig as JaxVisionConfig
from rs_ov.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from rs_ov_torch.core.params import blip_decoder_params_from_numpy, blip_params_from_numpy
from rs_ov_torch.evalsuite import caption, retrieval
from rs_ov_torch.nn.bert import BertConfig
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig
from rs_ov_torch.text.wordpiece import WordPieceTokenizer
from test_torch_blip_lm import VOCAB
from test_torch_timm_towers import draw

torch.set_num_threads(1)

ATOL = 2e-5
VISION = dict(image_size=32, patch_size=16, width=24, layers=2, heads=2)
TEXT = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=16)
CFG = BlipConfig(vision=BlipVisionConfig(**VISION), text=BertConfig(**TEXT), embed_dim=8)
JAX_CFG = jax_blip.BlipConfig(vision=JaxVisionConfig(**VISION), text=JaxBertConfig(**TEXT),
                              embed_dim=8)
N_IMG, N_TXT, L, K, ENC = 5, 8, 7, 3, 63


def _drawn(init, seed):
    tree = draw(jax.eval_shape(lambda k: init(k, JAX_CFG), jax.random.PRNGKey(0)), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def test_evaluate_captions_matches_jax(tmp_path):
    """Batches of 2 over 5 images (the tail padded): JAX's records exactly."""
    jp, tree = _drawn(jax_lm.init_blip_decoder_params, 31)
    ours = blip_decoder_params_from_numpy(tree)
    images = np.random.RandomState(0).randn(5, 3, 32, 32).astype(np.float32)
    ids = [107, 12, 54, 3, 99]
    kw = dict(batch=2, num_beams=2, max_length=10, min_length=3)
    lines = []
    got = caption.evaluate_captions(ours, CFG, images, ids, WordPieceTokenizer(VOCAB),
                                    log=lines.append, **kw)
    want = jax_caption.evaluate_captions(jp, JAX_CFG, images, ids, JaxWordPiece(VOCAB), **kw)
    assert got == want and [r["image_id"] for r in got] == ids
    assert lines[-1] == "captioned 5/5"
    with pytest.raises(ValueError, match="image_ids"):
        caption.evaluate_captions(ours, CFG, images, ids[:4], WordPieceTokenizer(VOCAB))


def test_save_and_merge_rank_shards_match_jax(tmp_path):
    r0 = [{"image_id": 1, "caption": "a"}, {"image_id": 2, "caption": "b"}]
    r1 = [{"image_id": 2, "caption": "b"}, {"image_id": 3, "caption": "c"}]
    for pkg, d in ((caption, tmp_path / "ours"), (jax_caption, tmp_path / "jax")):
        pkg.save_result(r0, str(d), "val", rank=0)
        pkg.save_result(r1, str(d), "val", rank=1)
        pkg.merge_results(str(d), "val", world=2)
    for name in ("val_rank0.json", "val_rank1.json", "val.json"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert [r["image_id"] for r in json.loads((tmp_path / "ours" / "val.json").read_text())] \
        == [1, 2, 3]


@pytest.fixture(scope="module")
def retrieval_setup():
    def init(key, cfg):
        k1, k2, k3 = jax.random.split(key, 3)
        tree = jax_blip.init_blip_params(k1, cfg)
        tree["text"] = jax_lm.add_cross_attention_params(k2, tree["text"], cfg)
        tree["itm_head"] = {"w": jax.random.normal(k3, (2, cfg.text.hidden_size)),
                            "b": jnp.zeros((2,))}
        return tree

    jp, tree = _drawn(init, 32)
    rng = np.random.RandomState(1)
    images = rng.randn(N_IMG, 3, 32, 32).astype(np.float32)
    ids = rng.randint(4, 60, (N_TXT, L)).astype(np.int32)
    atts = np.ones((N_TXT, L), np.int32)
    atts[2, 5:] = 0
    return jp, blip_params_from_numpy(tree), images, ids, atts


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0)


def test_retrieval_encodes_and_rerank_match_jax(retrieval_setup):
    jp, ours, images, ids, atts = retrieval_setup
    t_got = retrieval.encode_retrieval_texts(ours, CFG, ids, atts, ENC, batch=3)
    t_want = jax_retrieval.encode_retrieval_texts(jp, JAX_CFG, ids, atts, ENC, batch=3)
    _close(t_got["text_embeds"], t_want["text_embeds"])
    np.testing.assert_array_equal(t_got["enc_ids"], t_want["enc_ids"])
    i_got = retrieval.encode_retrieval_images(ours, CFG, images, batch=2)
    i_want = jax_retrieval.encode_retrieval_images(jp, JAX_CFG, images, batch=2)
    for key in ("image_feats", "image_embeds"):
        _close(i_got[key], i_want[key])
    # the same encodings into both reranks, so the top-k lists are the same
    args = (i_want["image_feats"], i_want["image_embeds"], t_want["text_embeds"],
            t_want["enc_ids"], t_want["text_atts"], K)
    lines = []
    got = retrieval.retrieval_rerank(ours, CFG, *args, rows_per_chunk=2, log=lines.append)
    want = jax_retrieval.retrieval_rerank(jp, JAX_CFG, *args, rows_per_chunk=2)
    for key in want:
        if key.startswith("scores") or key == "sims":
            _close(got[key], want[key])
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert lines[-1] == f"t2i rerank {N_TXT}/{N_TXT}"
    # two shards joined give the single run's rows and scores
    shards = [retrieval.retrieval_rerank(ours, CFG, *args, rows_per_chunk=2, shard=(r, 2))
              for r in range(2)]
    for d in ("i2t", "t2i"):
        n = (N_IMG, N_TXT) if d == "i2t" else (N_TXT, N_IMG)
        dense = [retrieval.densify(s[f"scores_{d}"], s[f"idx_{d}"], s[f"rows_{d}"], n)
                 for s in shards]
        joined = np.where(dense[0] > -100, dense[0], dense[1])
        np.testing.assert_array_equal(
            joined, retrieval.densify(got[f"scores_{d}"], got[f"idx_{d}"], got[f"rows_{d}"], n))
    with pytest.raises(ValueError, match="k_test"):
        retrieval.retrieval_rerank(ours, CFG, *args[:-1], 99)


def test_itm_eval_and_end_to_end_match_jax(retrieval_setup):
    jp, ours, images, ids, atts = retrieval_setup
    rng = np.random.RandomState(2)
    s_i2t, s_t2i = rng.randn(N_IMG, N_TXT), rng.randn(N_TXT, N_IMG)
    txt2img = [t % N_IMG for t in range(N_TXT)]
    img2txt = [[t for t in range(N_TXT) if t % N_IMG == i] for i in range(N_IMG)]
    for median in (False, True):
        assert retrieval.itm_eval(s_i2t, s_t2i, txt2img, img2txt, median) == \
            jax_retrieval.itm_eval(s_i2t, s_t2i, txt2img, img2txt, median)
    got = retrieval.blip_retrieval_evaluation(ours, CFG, images, ids, atts, ENC, txt2img,
                                              img2txt, k_test=K, rows_per_chunk=2)
    want = jax_retrieval.blip_retrieval_evaluation(jp, JAX_CFG, images, ids, atts, ENC,
                                                   txt2img, img2txt, k_test=K, rows_per_chunk=2)
    assert got == want


def test_video_encode_and_evaluation_match_jax(retrieval_setup):
    jp, ours, _, ids, atts = retrieval_setup
    videos = np.random.RandomState(3).randn(3, 2, 3, 32, 32).astype(np.float32)
    got = retrieval.encode_retrieval_videos(ours, CFG, videos, batch=4)
    want = jax_retrieval.encode_retrieval_videos(jp, JAX_CFG, videos, batch=4)
    for key in want:
        _close(got[key], want[key])
    assert got["image_feats"].shape == (3, 2 * 5, VISION["width"])
    txt2img = [t % 3 for t in range(N_TXT)]
    img2txt = [[t for t in range(N_TXT) if t % 3 == i] for i in range(3)]
    kw = dict(k_test=2, video=True, rows_per_chunk=3)
    assert retrieval.blip_retrieval_evaluation(ours, CFG, videos, ids, atts, ENC, txt2img,
                                               img2txt, **kw) == \
        jax_retrieval.blip_retrieval_evaluation(jp, JAX_CFG, videos, ids, atts, ENC, txt2img,
                                                img2txt, **kw)
