"""The pretrained-weights registry on the port against the JAX package: the
entries and lookups exactly equal, the cache-dir precedence, the SHA-256
prefix check on staged files, the URL and HF dispatch, and the refusal to
download (nothing leaves the machine: the fetch raises with its URL)."""

import hashlib
import os

import pytest

from rs_ov import pretrained as jax_pretrained
from rs_ov_torch import pretrained

PAIRS = jax_pretrained.list_pretrained(include_rs=True)


def test_registry_entries_equal_jax():
    assert pretrained.list_pretrained() == jax_pretrained.list_pretrained()
    assert pretrained.list_pretrained(as_str=True) == jax_pretrained.list_pretrained(as_str=True)
    assert pretrained.list_pretrained(include_rs=True) == PAIRS
    assert pretrained.PRETRAINED == jax_pretrained.PRETRAINED
    assert pretrained.RS_PRETRAINED == jax_pretrained.RS_PRETRAINED


@pytest.mark.parametrize("spell", [lambda m, t: (m, t), lambda m, t: (m.replace("-", "/", 1),
                                                                      t.upper())],
                         ids=["as-listed", "slash-upper"])
def test_lookups_equal_jax(spell):
    """Every (model, tag) pair, also spelled with '/' and in upper case,
    and names that are not there."""
    for model, tag in PAIRS + [("ViT-B-16", "nope"), ("nope", "openai")]:
        m, t = spell(model, tag)
        assert pretrained.get_pretrained_cfg(m, t) == jax_pretrained.get_pretrained_cfg(m, t)
        assert pretrained.is_pretrained_cfg(m, t) == jax_pretrained.is_pretrained_cfg(m, t)
        assert pretrained.get_pretrained_url(m, t) == jax_pretrained.get_pretrained_url(m, t)
        url = pretrained.get_pretrained_url(m, t)
        assert pretrained.expected_sha256_for_url(url) == \
            jax_pretrained.expected_sha256_for_url(url)
    for model in {m for m, _ in PAIRS} | {"nope"}:
        assert pretrained.list_pretrained_tags_by_model(model) == \
            jax_pretrained.list_pretrained_tags_by_model(model)
    for tag in {t for _, t in PAIRS} | {"laion2b-s34b-b88k"}:
        assert pretrained.list_pretrained_models_by_tag(tag) == \
            jax_pretrained.list_pretrained_models_by_tag(tag)


def test_cache_dir_precedence(monkeypatch, tmp_path):
    """An explicit argument, then RS_OV_CACHE_DIR, then ~/.cache/clip."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("RS_OV_CACHE_DIR", raising=False)
    for mod in (pretrained, jax_pretrained):
        assert mod.resolve_cache_dir() == str(tmp_path / "home" / ".cache" / "clip")
        assert mod.resolve_cache_dir("/x") == "/x"
    monkeypatch.setenv("RS_OV_CACHE_DIR", str(tmp_path / "env"))
    for mod in (pretrained, jax_pretrained):
        assert mod.resolve_cache_dir() == str(tmp_path / "env")
        assert mod.resolve_cache_dir("/x") == "/x"


def _stage(path, data: bytes) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return hashlib.sha256(data).hexdigest()


def test_url_download_checks_the_staged_file(tmp_path):
    """A staged file whose SHA-256 starts with the URL's prefix resolves; a
    corrupt one warns, then the fetch is refused with the URL; a URL with no
    hash in it takes any staged file."""
    data = b"weights" * 100
    digest = hashlib.sha256(data).hexdigest()
    url = f"https://github.com/mlfoundations/open_clip/releases/download/v0.2-weights/m-{digest[:8]}.pt"
    target = str(tmp_path / os.path.basename(url))
    _stage(target, data)
    for mod in (pretrained, jax_pretrained):
        assert mod.verify_sha256_prefix(target, digest[:8])
        assert not mod.verify_sha256_prefix(target, "0" * 8 if digest[0] != "0" else "1" * 8)
        assert mod.download_pretrained_from_url(url, cache_dir=str(tmp_path)) == target
    _stage(target, b"corrupt")
    for mod in (pretrained, jax_pretrained):
        with pytest.warns(UserWarning, match="SHA-256"):
            with pytest.raises(RuntimeError, match="cannot .* " + url.replace(".", r"\.")):
                mod.download_pretrained_from_url(url, cache_dir=str(tmp_path))
    plain = "https://dl.fbaipublicfiles.com/MMPT/metaclip/b32_400m.pt"
    _stage(str(tmp_path / "b32_400m.pt"), b"anything")
    assert pretrained.download_pretrained_from_url(plain, cache_dir=str(tmp_path)) == \
        str(tmp_path / "b32_400m.pt")


def test_hf_and_dispatch(tmp_path):
    """An hf_hub entry resolves to <cache>/<org>/<model>/<file> when staged,
    else the fetch is refused with the hub URL; the URL wins over hf_hub
    unless force_hf_hub."""
    cfg = pretrained.get_pretrained_cfg("ViT-B-16", "laion2b_s34b_b88k")
    assert cfg["hf_hub"] == "laion/CLIP-ViT-B-16-laion2B-s34B-b88K/"
    for mod in (pretrained, jax_pretrained):
        with pytest.raises(RuntimeError, match="huggingface.co/laion/CLIP-ViT-B-16"):
            mod.download_pretrained(cfg, cache_dir=str(tmp_path))
    staged = tmp_path / "laion" / "CLIP-ViT-B-16-laion2B-s34B-b88K" / pretrained.HF_WEIGHTS_NAME
    _stage(str(staged), b"x")
    for mod in (pretrained, jax_pretrained):
        assert mod.download_pretrained(cfg, cache_dir=str(tmp_path)) == str(staged)
    both = {"url": "https://example.invalid/a.pt", "hf_hub": "laion/CLIP-ViT-B-16-laion2B-s34B-b88K/"}
    for mod in (pretrained, jax_pretrained):
        with pytest.raises(RuntimeError, match="example.invalid"):
            mod.download_pretrained(both, cache_dir=str(tmp_path))
        assert mod.download_pretrained(both, force_hf_hub=True,
                                       cache_dir=str(tmp_path)) == str(staged)
        assert mod.download_pretrained({}) == ""
