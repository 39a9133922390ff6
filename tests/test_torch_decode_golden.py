"""The committed decode golden (tests/fixtures/blip_decode_golden.{npz,json})
through the port on the CPU in fp32: beam-search and nucleus captioning,
VQA ranking and VQA beam generation must give the committed strings and
indices byte for byte, as tests/test_decode_golden.py requires of the JAX
package; the captions on the full-prefix path too."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rs_ov_torch.core.params import blip_decoder_params_from_numpy, blip_vqa_params_from_numpy
from rs_ov_torch.nn import blip_lm
from rs_ov_torch.nn.bert import BertConfig
from rs_ov_torch.nn.blip import BlipConfig
from rs_ov_torch.nn.blip_vit import BlipVisionConfig
from rs_ov_torch.text.wordpiece import WordPieceTokenizer

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def golden():
    sys.path.insert(0, os.path.join(os.path.dirname(FIXDIR), "..", "tools"))
    from make_blip_decode_golden import tiny_cfg, unflatten

    jcfg = tiny_cfg()
    cfg = BlipConfig(vision=BlipVisionConfig(**jcfg.vision.__dict__),
                     text=BertConfig(**jcfg.text.__dict__), embed_dim=jcfg.embed_dim)
    flat = dict(np.load(os.path.join(FIXDIR, "blip_decode_golden.npz")))

    def tree(prefix):
        t = unflatten({k[4:]: v for k, v in flat.items() if k.startswith(prefix)})
        return jax.tree_util.tree_map(np.asarray, t)

    with open(os.path.join(FIXDIR, "blip_decode_golden.json")) as f:
        expect = json.load(f)
    return (cfg, blip_decoder_params_from_numpy(tree("cap/")),
            blip_vqa_params_from_numpy(tree("vqa/")), expect)


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(os.path.join(FIXDIR, "blip_decode_vocab.txt"))


def _inputs(tok):
    rng = np.random.RandomState(0)
    images = rng.randn(2, 3, 32, 32).astype(np.float32)
    q_ids = rng.randint(4, 60, size=(2, 6)).astype(np.int32)
    q_ids[:, 0] = tok.enc_token_id
    q_mask = np.ones((2, 6), np.int32)
    q_mask[1, 4:] = 0
    ans_ids = rng.randint(4, 60, size=(4, 5)).astype(np.int32)
    ans_ids[:, 0] = tok.bos_token_id
    return images, q_ids, q_mask, ans_ids, np.ones((4, 5), np.int32)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "full-prefix"])
def test_beam_caption_golden(golden, tok, use_cache):
    cfg, cap, _, expect = golden
    got = blip_lm.generate_captions(cap, _inputs(tok)[0], cfg, tok, prompt="a picture of ",
                                    max_length=14, min_length=3, num_beams=3,
                                    use_cache=use_cache)
    assert got == expect["beam_captions"]


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "full-prefix"])
def test_nucleus_caption_golden(golden, tok, use_cache):
    cfg, cap, _, expect = golden
    got = blip_lm.generate_captions(cap, _inputs(tok)[0], cfg, tok, prompt="a picture of ",
                                    sample=True, max_length=14, min_length=3,
                                    rng=np.random.RandomState(7), use_cache=use_cache)
    assert got == expect["nucleus_captions"]


def test_vqa_rank_golden(golden, tok):
    cfg, _, vqa, expect = golden
    images, q_ids, q_mask, ans_ids, ans_mask = _inputs(tok)
    got = blip_lm.vqa_rank_answers(vqa, images, q_ids, q_mask, ans_ids, ans_mask, cfg, k=4)
    assert [int(i) for i in got] == expect["vqa_rank_indices"]


def test_vqa_generate_golden(golden, tok):
    cfg, _, vqa, expect = golden
    images, q_ids, q_mask, _, _ = _inputs(tok)
    got = blip_lm.vqa_generate_answers(vqa, images, q_ids, q_mask, cfg, tok, num_beams=2,
                                       max_length=8)
    assert got == expect["vqa_generated_answers"]
