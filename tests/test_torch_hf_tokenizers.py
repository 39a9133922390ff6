"""The tokenizers on the port against the JAX package, ids exactly equal:
HFTokenizer and SigLipTokenizer on a tiny local tokenizer.json built with
the `tokenizers` library (skipped where transformers is absent),
get_tokenizer's routing, and the BPE tokenizer's cleaning modes and
token-dropping masks (each drawing from one seeded RandomState)."""

import numpy as np
import pytest

from rs_ov.factory import get_tokenizer as jax_get_tokenizer
from rs_ov.text import tokenizer as jax_tok
from rs_ov_torch.factory import get_tokenizer
from rs_ov_torch.text import tokenizer as tok

TEXTS = ["A Photo, of a BUILDING!", "road", "the water of a road   building",
         "a_photo of the &amp; building"]
LONG = ["a photo of a red car parked beside the tall grey building near the wide road "
        "in the centre of the old town with trees and water and a bridge " * 2]


@pytest.fixture(scope="module")
def tiny_tokenizer_json(tmp_path_factory):
    """A tiny WordPiece fast-tokenizer file with [CLS] / [SEP] specials."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, processors
    from tokenizers.models import WordPiece
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"[PAD]": 0, "<eos>": 1, "[UNK]": 2, "[CLS]": 3, "[SEP]": 4, "a": 5, "photo": 6,
             "of": 7, "building": 8, "road": 9, "water": 10, "the": 11, ",": 12, "!": 13}
    t = Tokenizer(WordPiece(vocab=vocab, unk_token="[UNK]"))
    t.pre_tokenizer = Whitespace()
    t.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 3), ("[SEP]", 4)])
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    t.save(str(path))
    return str(path)


def test_hf_tokenizers_equal_jax(tiny_tokenizer_json):
    from rs_ov.text.hf_tokenizers import HFTokenizer as JaxHF
    from rs_ov.text.hf_tokenizers import SigLipTokenizer as JaxSigLip
    from rs_ov_torch.text.hf_tokenizers import HFTokenizer, SigLipTokenizer

    for kw in (dict(context_length=8), dict(context_length=6, strip_sep_token=True),
               dict(context_length=10, clean="lower")):
        ours, theirs = HFTokenizer(tiny_tokenizer_json, **kw), JaxHF(tiny_tokenizer_json, **kw)
        got = ours(TEXTS)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, theirs(TEXTS))
        np.testing.assert_array_equal(ours(TEXTS[1], context_length=4),
                                      theirs(TEXTS[1], context_length=4))
    ours, theirs = SigLipTokenizer(tiny_tokenizer_json, 8), JaxSigLip(tiny_tokenizer_json, 8)
    np.testing.assert_array_equal(ours(TEXTS), theirs(TEXTS))
    assert ours(["road"])[0, -1] == 1  # pad == eos == 1
    for make in (lambda: SigLipTokenizer("c4-en"), lambda: HFTokenizer("bert-base-uncased")):
        with pytest.raises(FileNotFoundError, match="No implicit downloads"):
            make()


def test_get_tokenizer_routing_equals_jax(tiny_tokenizer_json):
    """canonicalize-cleaned HF names get SigLipTokenizer, other HF names
    HFTokenizer with the config's strip_sep_token, the rest the BPE
    tokenizer; the ids equal the JAX package's."""
    from rs_ov_torch.text.hf_tokenizers import HFTokenizer, SigLipTokenizer

    cases = (("ViT-B-16-SigLIP", SigLipTokenizer, 64),
             ("ViT-L-14-CLIPA", HFTokenizer, 32),
             ("ViT-B-16", tok.SimpleTokenizer, 77),
             ("", tok.SimpleTokenizer, 77),
             ("coca_ViT-B-32", tok.SimpleTokenizer, 77))
    for name, cls, ctx in cases:
        ours = get_tokenizer(name, local_tokenizer_path=tiny_tokenizer_json)
        assert type(ours) is cls and ours.context_length == ctx, name
        if name != "coca_ViT-B-32":  # CoCa's config is item 9's: the JAX one is 76 long
            np.testing.assert_array_equal(
                ours(TEXTS), jax_get_tokenizer(name, local_tokenizer_path=tiny_tokenizer_json)(
                    TEXTS))
    assert get_tokenizer("ViT-L-14-CLIPA", local_tokenizer_path=tiny_tokenizer_json
                         ).strip_sep_token
    assert get_tokenizer("ViT-B-16", context_length=20).context_length == 20


@pytest.mark.parametrize("clean", ["lower", "whitespace", "canonicalize"])
def test_bpe_cleaning_equals_jax(clean):
    ours, theirs = tok.SimpleTokenizer(clean=clean), jax_tok.SimpleTokenizer(clean=clean)
    for t in TEXTS:
        assert tok.get_clean_fn(clean)(t) == jax_tok.get_clean_fn(clean)(t)
    np.testing.assert_array_equal(ours(TEXTS), theirs(TEXTS))
    np.testing.assert_array_equal(ours(LONG, context_length=16), theirs(LONG, context_length=16))
    assert ours.decode(ours(TEXTS[0])[0, 1:5]) == theirs.decode(theirs(TEXTS[0])[0, 1:5])
    with pytest.raises(ValueError, match="Invalid clean"):
        tok.get_clean_fn("nope")
    assert tok.DEFAULT_CONTEXT_LENGTH == jax_tok.DEFAULT_CONTEXT_LENGTH


@pytest.mark.parametrize("mask", ["simple", "random", "shuffle"])
def test_reduction_masks_equal_jax(mask):
    """Each token-dropping mask with one RandomState seed in both packages
    (the JAX functions take it as their rng argument), through the
    tokenizer's reduction_mask in the port."""
    bpe = tok.SimpleTokenizer()
    texts = LONG + TEXTS
    got = tok.SimpleTokenizer(reduction_mask=mask, rng=np.random.RandomState(3))(texts, 12)
    want = jax_tok.get_reduction_mask_fn(mask)(
        bpe.encode, texts, 12, bpe.sot_token_id, bpe.eot_token_id,
        rng=np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == bpe.sot_token_id).all()


def test_syntax_mask_equals_jax(monkeypatch):
    """The part-of-speech mask's ordering with nltk's tokenizer and tagger
    stood in for (their data is not installed here): nouns, adjectives,
    verbs, then the rest."""
    nltk = pytest.importorskip("nltk")
    tags = {"photo": "NN", "car": "NN", "building": "NNS", "red": "JJ", "tall": "JJ",
            "parked": "VBN"}
    monkeypatch.setattr(nltk.tokenize, "word_tokenize", lambda text: text.split())
    monkeypatch.setattr(nltk, "pos_tag", lambda words: [(w, tags.get(w, "DT")) for w in words])
    bpe = tok.SimpleTokenizer()
    args = (bpe.encode, LONG + ["a red photo"], 8, bpe.sot_token_id, bpe.eot_token_id)
    got = tok.SimpleTokenizer(reduction_mask="syntax")(LONG + ["a red photo"], 8)
    np.testing.assert_array_equal(got, jax_tok.syntax_mask_tokenize(*args))
    np.testing.assert_array_equal(tok.syntax_mask_tokenize(*args), got)
