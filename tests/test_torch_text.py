"""The port's text side vs the JAX package: tokens exact, query features
within 2e-5 (tools/parity_check.py:73)."""

import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import TextConfig
from rs_ov.core.params import init_text_params
from rs_ov.text.classifier import build_text_classifier as jax_build, get_cls_idx as jax_cls_idx
from rs_ov.text.templates import OPENAI_IMAGENET_TEMPLATES as JAX_TEMPLATES
from rs_ov.text.tokenizer import tokenize as jax_tokenize
from rs_ov_torch.core.params import TextTower, load_numpy_tree
from rs_ov_torch.text.classifier import build_text_classifier, get_cls_idx
from rs_ov_torch.text.templates import OPENAI_IMAGENET_TEMPLATES
from rs_ov_torch.text.tokenizer import tokenize

torch.set_num_threads(1)

POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


def test_templates_and_vocabulary_match():
    assert OPENAI_IMAGENET_TEMPLATES == JAX_TEMPLATES
    assert get_cls_idx(POTSDAM) == jax_cls_idx(POTSDAM)


def test_tokenizer_exact_over_templates_and_potsdam_words():
    words, _ = get_cls_idx(POTSDAM)
    prompts = [t.format(w) for w in words for t in OPENAI_IMAGENET_TEMPLATES]
    prompts += ["Road &amp;  parking-lot's 2nd   view", "x" * 400]  # unescape, truncation
    np.testing.assert_array_equal(tokenize(prompts), jax_tokenize(prompts))


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_build_text_classifier_matches_jax(quick_gelu):
    cfg = TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                     layers=2, output_dim=32)
    tree = jax.tree_util.tree_map(np.asarray, init_text_params(jax.random.PRNGKey(3), cfg))
    words = ["road", "parking lot", "tree"]
    want = np.asarray(jax_build(tree, words, cfg, quick_gelu=quick_gelu))
    tower = load_numpy_tree(TextTower(cfg), tree)
    got = build_text_classifier(tower, words, cfg, quick_gelu=quick_gelu).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
