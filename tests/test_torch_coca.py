"""CoCa on the port (rs_ov_torch.nn.coca, core.config, core.checkpoint,
factory) against rs_ov's on the CPU in fp32, with the same drawn weights
(every leaf drawn from a seed): the configs of the four names, the
attentional pool, both encoders, the decoder and forward, the cached step at
atol 2e-5 (tools/parity_check.py's blip_qq), generate's tokens in each mode,
cached and full-prefix, the checkpoint loader's tree, create_model on tiny
configs under the registry's names, and the HF-towered variant."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov import factory as jax_factory
from rs_ov.core import checkpoint as jax_checkpoint
from rs_ov.core import config as jax_config
from rs_ov.hub import _export_block
from rs_ov.nn import coca as jax_coca
from rs_ov.nn import hf_text as jax_hf
from rs_ov_torch import factory
from rs_ov_torch.core import checkpoint, config
from rs_ov_torch.core.params import coca_params_from_numpy
from rs_ov_torch.nn import coca, hf_text
from test_torch_hf_text import _hf_state_dict
from test_torch_timm_checkpoint import assert_trees_equal
from test_torch_timm_towers import draw

torch.set_num_threads(1)

ATOL = 2e-5  # tools/parity_check.py: blip_qq


def _small(pkg, mm=config.MultimodalConfig):
    return pkg.CoCaConfig(
        embed_dim=16,
        vision=pkg.VisionConfig(image_size=32, patch_size=16, width=24, layers=2, output_dim=16,
                                head_width=12),
        text=pkg.TextConfig(context_length=12, vocab_size=64, width=16, heads=2, layers=2,
                            output_dim=16, pool_type="last", embed_cls=True),
        multimodal=mm(context_length=12, vocab_size=64, width=16, heads=2, layers=2),
        attn_pooler_queries=8, attn_pooler_heads=2)


SMALL = _small(config)
JAX_SMALL = jax_coca.CoCaConfig(**{**{f.name: getattr(_small(config), f.name)
                                      for f in dataclasses.fields(jax_coca.CoCaConfig)},
                                   "vision": jax_config.VisionConfig(
                                       **dataclasses.asdict(SMALL.vision)),
                                   "text": jax_config.TextConfig(**dataclasses.asdict(SMALL.text)),
                                   "multimodal": jax_coca.MultimodalConfig(
                                       **dataclasses.asdict(SMALL.multimodal))})
TINY_ROBERTA = hf_text.HFTextConfig(model_type="roberta", vocab_size=50, hidden_size=32,
                                    num_layers=2, num_heads=2, intermediate_size=64,
                                    max_position_embeddings=40, pad_token_id=1, output_dim=16,
                                    pooler_type="mean_pooler", proj_type="linear")


def _jax_cfg(cfg):
    return jax_coca.CoCaConfig(
        **{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
           "vision": jax_config.VisionConfig(**dataclasses.asdict(cfg.vision)),
           "text": jax_config.TextConfig(**dataclasses.asdict(cfg.text)),
           "multimodal": jax_coca.MultimodalConfig(**dataclasses.asdict(cfg.multimodal))})


def _tree(cfg, seed):
    shapes = jax.eval_shape(lambda k: jax_coca.init_coca_params(k, _jax_cfg(cfg)),
                            jax.random.PRNGKey(0))
    tree = draw(shapes, seed)
    tree["logit_scale"] = np.float32(np.log(1 / 0.07))
    return tree


@pytest.fixture(scope="module")
def weights():
    tree = _tree(SMALL, 21)
    return jax.tree_util.tree_map(jnp.asarray, tree), coca_params_from_numpy(tree, SMALL), tree


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 3, 32, 32).astype(np.float32)
    texts = np.zeros((3, 12), np.int32)
    for i, n in enumerate((12, 7, 3)):
        texts[i, :n] = rng.randint(1, 63, n)
    return images, texts


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0, err_msg=msg)


def test_coca_configs_equal_jax():
    for name in config.COCA_MODELS:
        assert dataclasses.asdict(config.get_model_config(name)) == \
            dataclasses.asdict(jax_config.get_model_config(name)), name
    with pytest.raises(KeyError):
        config.get_coca_config("coca_nope")


def test_pool_encoders_decoder_and_forward_match_jax(weights):
    jp, tp, _ = weights
    images, texts = _inputs()
    x = np.random.RandomState(1).randn(3, 10, 24).astype(np.float32)
    _close(coca.attentional_pool(tp.visual.attn_pool, torch.from_numpy(x), 2),
           jax_coca.attentional_pool(jp["visual"]["attn_pool"], jnp.asarray(x), 2), "pool")
    for normalize in (True, False):
        for got, want in zip(coca.coca_encode_image(tp, torch.from_numpy(images), SMALL, normalize),
                             jax_coca.coca_encode_image(jp, jnp.asarray(images), JAX_SMALL,
                                                        normalize)):
            _close(got, want, "image")
        for got, want in zip(coca.coca_encode_text(tp, torch.from_numpy(texts), SMALL, normalize),
                             jax_coca.coca_encode_text(jp, jnp.asarray(texts), JAX_SMALL,
                                                       normalize)):
            _close(got, want, "text")
    got = coca.coca_forward(tp, torch.from_numpy(images[[0, 1, 0]]), torch.from_numpy(texts),
                            SMALL)
    want = jax_coca.coca_forward(jp, jnp.asarray(images[[0, 1, 0]]), jnp.asarray(texts),
                                 JAX_SMALL)
    assert set(got) == set(want)
    for k in ("image_features", "text_features", "logits", "logit_scale"):
        _close(got[k], want[k], k)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert set(coca.coca_forward(tp, torch.from_numpy(images), None, SMALL)) == \
        {"image_features", "image_embs"}


def test_cls_sits_last_and_its_row_is_pad_gated(weights):
    """The tokens do not see the CLS (appended last, causal rows end before
    it); the pooled CLS row has the pad columns masked: with no id taken for
    the pad, the rows with pads pool otherwise, the full row alike."""
    _, tp, _ = weights
    _, texts = _inputs()
    ids = torch.from_numpy(texts)
    pooled, tokens = coca.coca_encode_text(tp, ids, SMALL, normalize=False)
    with torch.no_grad():
        saved = tp.text.cls_emb.clone()
        tp.text.cls_emb.add_(torch.randn(saved.shape, generator=torch.Generator().manual_seed(0)))
        pooled2, tokens2 = coca.coca_encode_text(tp, ids, SMALL, normalize=False)
        tp.text.cls_emb.copy_(saved)
    assert torch.equal(tokens, tokens2) and not torch.allclose(pooled, pooled2)
    unmasked, _ = coca.coca_encode_text(tp, ids, dataclasses.replace(SMALL, pad_id=-1),
                                        normalize=False)
    assert torch.equal(unmasked[0], pooled[0])
    assert not torch.allclose(unmasked[1:], pooled[1:])


def test_cached_step_matches_jax_and_full_prefix(weights):
    """Each cached step's logits equal the JAX package's and the port's
    full-prefix decoder's at that position; rows reordered by a parent
    permutation after the first step."""
    jp, tp, _ = weights
    images, _ = _inputs()
    n = 9
    _, embs = coca.coca_encode_image(tp, torch.from_numpy(images[[0, 1, 1]]), SMALL)
    _, jembs = jax_coca.coca_encode_image(jp, jnp.asarray(images[[0, 1, 1]]), JAX_SMALL)
    tinit, tstep = coca.make_coca_cached_decoder(tp, SMALL, n)
    jinit, jstep = jax_coca.make_coca_cached_decoder(jp, JAX_SMALL, n)
    tc, jc = tinit(embs), jinit(jembs)
    rng = np.random.RandomState(3)
    seqs = np.zeros((3, n), np.int32)
    rows = np.arange(3)
    for pos in range(n):
        parent = rng.permutation(3).astype(np.int32) if pos else np.arange(3, dtype=np.int32)
        seqs, rows = seqs[parent], rows[parent]
        seqs[:, pos] = rng.randint(1, 63, 3)
        got, tc = tstep(seqs[:, pos], pos, tc, parent)
        want, jc = jstep(jnp.asarray(seqs[:, pos]), jnp.asarray(pos, jnp.int32), jc,
                         jnp.asarray(parent))
        _close(got, want, f"jax {pos}")
        full = coca.coca_forward(tp, None, torch.from_numpy(seqs[:, :pos + 1]), SMALL,
                                 image_latent=torch.zeros(3, 16),
                                 image_embs=embs[torch.from_numpy(rows)])["logits"][:, -1]
        _close(got, full, f"full prefix {pos}")


GENERATE = {"beam_search": dict(num_beams=3), "beam_search-penalty": dict(
    num_beams=2, repetition_penalty=1.3), "top_k": dict(top_k=3), "top_p": dict(top_p=0.5)}


@pytest.mark.parametrize("mode", list(GENERATE))
def test_generate_matches_jax(weights, mode):
    jp, tp, _ = weights
    images = np.random.RandomState(5).randn(2, 3, 32, 32).astype(np.float32)
    kw = dict(seq_len=8, min_seq_len=2, generation_type=mode.split("-")[0], sot_token_id=1,
              eos_token_id=2, seed=3, **GENERATE[mode])
    want = jax_coca.coca_generate(jp, jnp.asarray(images), JAX_SMALL, **kw)
    for use_cache in (True, False):
        got = coca.coca_generate(tp, images, SMALL, use_cache=use_cache, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=str(use_cache))
    with pytest.raises(ValueError, match="generation_type"):
        coca.coca_generate(tp, images, SMALL, generation_type="nope")


def test_generate_past_the_context_slides_like_jax():
    """seq_len past the context (4 here): the full prefix again each step,
    its window clamped to the context, as in the JAX package."""
    cfg = dataclasses.replace(SMALL, text=dataclasses.replace(SMALL.text, context_length=4),
                              multimodal=dataclasses.replace(SMALL.multimodal, context_length=4))
    tree = _tree(cfg, 25)
    images = np.random.RandomState(6).randn(1, 3, 32, 32).astype(np.float32)
    kw = dict(seq_len=7, min_seq_len=6, generation_type="top_k", top_k=1, sot_token_id=1,
              eos_token_id=2)
    want = jax_coca.coca_generate(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(images), _jax_cfg(cfg), **kw)
    got = coca.coca_generate(coca_params_from_numpy(tree, cfg), images, cfg, **kw)
    np.testing.assert_array_equal(got, want)
    assert want.shape == (1, 7)


def _coca_state_dict(tree):
    """An open_clip CoCa state dict for a JAX CoCa tree."""
    sd = {}
    v, t, m = tree["visual"], tree["text"], tree["multimodal"]
    sd["visual.conv1.weight"] = v["conv1_w"]
    sd["visual.class_embedding"] = v["class_embedding"]
    sd["visual.positional_embedding"] = v["positional_embedding"]
    for name in ("ln_pre", "ln_post"):
        sd[f"visual.{name}.weight"], sd[f"visual.{name}.bias"] = \
            v[name]["scale"], v[name]["bias"]
    sd["visual.proj"] = v["proj"]
    for i, blk in enumerate(v["blocks"]):
        _export_block(blk, f"visual.transformer.resblocks.{i}.", sd)
    ap = v["attn_pool"]
    sd["visual.attn_pool.query"] = ap["query"]
    for name in ("ln_q", "ln_k"):
        sd[f"visual.attn_pool.{name}.weight"] = ap[name]["scale"]
        sd[f"visual.attn_pool.{name}.bias"] = ap[name]["bias"]
    for name in ("q_proj_weight", "k_proj_weight", "v_proj_weight"):
        sd[f"visual.attn_pool.attn.{name}"] = ap[name.replace("_weight", "_w")]
    sd["visual.attn_pool.attn.in_proj_bias"] = ap["in_proj_b"]
    sd["visual.attn_pool.attn.out_proj.weight"] = ap["out_proj_w"]
    sd["visual.attn_pool.attn.out_proj.bias"] = ap["out_proj_b"]
    if "transformer" in t:
        sd.update(_hf_state_dict(t, "", "text."))
    else:
        sd["text.token_embedding.weight"] = t["token_embedding"]
        sd["text.positional_embedding"] = t["positional_embedding"]
        sd["text.cls_emb"] = t["cls_emb"]
        sd["text.ln_final.weight"] = t["ln_final"]["scale"]
        sd["text.ln_final.bias"] = t["ln_final"]["bias"]
        sd["text.text_projection"] = t["text_projection"]
        for i, blk in enumerate(t["blocks"]):
            _export_block(blk, f"text.transformer.resblocks.{i}.", sd)
    for i, (blk, xblk) in enumerate(zip(m["blocks"], m["cross_blocks"])):
        _export_block(blk, f"text_decoder.resblocks.{i}.", sd)
        _export_block(xblk, f"text_decoder.cross_attn.{i}.", sd)
        sd[f"text_decoder.cross_attn.{i}.ln_1_kv.weight"] = xblk["ln_1_kv"]["scale"]
        sd[f"text_decoder.cross_attn.{i}.ln_1_kv.bias"] = xblk["ln_1_kv"]["bias"]
    sd["text_decoder.ln_final.weight"] = m["ln_final"]["scale"]
    sd["text_decoder.ln_final.bias"] = m["ln_final"]["bias"]
    sd["text_decoder.text_projection"] = m["text_projection"]
    sd["logit_scale"] = np.asarray(tree["logit_scale"], np.float32)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _tiny_roberta(monkeypatch):
    """'roberta-base' resolved to a tiny tower in both packages."""
    monkeypatch.setattr(hf_text, "hf_text_config",
                        lambda name, output_dim, proj_type=None: dataclasses.replace(
                            TINY_ROBERTA, output_dim=output_dim, proj_type=proj_type))
    monkeypatch.setattr(jax_hf, "hf_text_config",
                        lambda name, output_dim, proj_type=None: jax_hf.HFTextConfig(
                            **{**dataclasses.asdict(TINY_ROBERTA), "output_dim": output_dim,
                               "proj_type": proj_type}))
    return dataclasses.replace(SMALL, text=dataclasses.replace(
        SMALL.text, width=32, embed_cls=False, hf_model_name="roberta-base",
        hf_proj_type="linear"), multimodal=dataclasses.replace(SMALL.multimodal, width=32))


@pytest.mark.parametrize("hf", [False, True], ids=["coca", "coca-roberta"])
def test_state_dict_loader_matches_jax(hf, monkeypatch):
    cfg = _tiny_roberta(monkeypatch) if hf else SMALL
    tree = _tree(cfg, 22)
    sd = _coca_state_dict(tree)
    got = checkpoint.coca_params_from_state_dict(sd)
    assert_trees_equal(got, jax.tree_util.tree_map(np.asarray,
                                                   jax_checkpoint.coca_params_from_state_dict(sd)))
    assert_trees_equal(got, tree)


TINY_NAMES = {"coca_ViT-B-32": SMALL, "coca_ViT-L-14": SMALL,
              "coca_base": dataclasses.replace(SMALL, quick_gelu=True)}


def _register(monkeypatch, tiny):
    monkeypatch.setattr(factory, "get_coca_config", lambda name: tiny[name])
    monkeypatch.setattr(jax_config, "get_coca_config", lambda name: _jax_cfg(tiny[name]))


@pytest.mark.parametrize("name", list(TINY_NAMES))
def test_create_model_builds_each_name_and_loads_a_checkpoint(name, monkeypatch, tmp_path):
    """create_model(name, device="cpu") on a tiny config under the name: a
    CoCaModel with the JAX init's tree; a checkpoint path gives the JAX
    CoCaModel's encode_image / encode_text / forward / generate."""
    _register(monkeypatch, TINY_NAMES)
    cfg = TINY_NAMES[name]
    m = factory.create_model(name, device="cpu")
    assert isinstance(m, factory.CoCaModel) and m.cfg is cfg
    shapes = jax.eval_shape(lambda k: jax_coca.init_coca_params(k, _jax_cfg(cfg)),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    assert {k: tuple(v.shape) for k, v in m.coca.named_parameters()} == want
    path = tmp_path / "coca.pt"
    torch.save({k: torch.from_numpy(v) for k, v in _coca_state_dict(_tree(cfg, 23)).items()},
               path)
    ours = factory.create_model(name, str(path), device="cpu")
    theirs = jax_factory.create_model(name, str(path))
    images, texts = _inputs(7)
    _close(ours.encode_image(images), theirs.encode_image(images))
    _close(ours.encode_text(texts), theirs.encode_text(texts))
    got, want = ours(images[[0, 1, 0]], texts), theirs(images[[0, 1, 0]], texts)
    _close(got["logits"], want["logits"])
    kw = dict(seq_len=6, num_beams=2, sot_token_id=1, eos_token_id=2, min_seq_len=2)
    np.testing.assert_array_equal(ours.generate(images, **kw), theirs.generate(images, **kw))
    assert float(ours.logit_scale) == pytest.approx(float(theirs.logit_scale), rel=1e-6)
    with pytest.raises(FileNotFoundError):
        factory.create_model(name, "laion2b_s13b_b90k", device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_roberta_coca_encodes_like_jax_and_refuses_the_caption_forward(monkeypatch):
    """coca_roberta-ViT-B-32 on a tiny HF tower: the encoders agree with the
    JAX package's; the caption forward (and so generate, which takes the
    full-prefix path for an HF tower) fails as the JAX one does: the image
    tokens are embed_dim wide, the decoder's LayerNorm is wider."""
    cfg = _tiny_roberta(monkeypatch)
    _register(monkeypatch, {"coca_roberta-ViT-B-32": cfg})
    m = factory.create_model("coca_roberta-ViT-B-32", device="cpu")
    assert isinstance(m.coca.text.transformer, torch.nn.Module)
    tree = _tree(cfg, 24)
    ours = coca_params_from_numpy(tree, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    images, texts = _inputs(8)
    texts = np.where(texts == 0, TINY_ROBERTA.pad_token_id, texts % 50).astype(np.int32)
    for got, want in zip(coca.coca_encode_image(ours, torch.from_numpy(images), cfg),
                         jax_coca.coca_encode_image(jp, jnp.asarray(images), _jax_cfg(cfg))):
        _close(got, want)
    for got, want in zip(coca.coca_encode_text(ours, torch.from_numpy(texts), cfg),
                         jax_coca.coca_encode_text(jp, jnp.asarray(texts), _jax_cfg(cfg))):
        _close(got, want)
    with pytest.raises(ValueError) as jax_err:
        jax_coca.coca_forward(jp, jnp.asarray(images), jnp.asarray(texts[:2]), _jax_cfg(cfg))
    with pytest.raises(ValueError) as err:
        coca.coca_forward(ours, torch.from_numpy(images), torch.from_numpy(texts[:2]), cfg)
    assert str(err.value) == str(jax_err.value).splitlines()[0]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        coca.coca_generate(ours, images, cfg, seq_len=4, sot_token_id=1, eos_token_id=2)
