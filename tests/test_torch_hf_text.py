"""The HF text tower on the port (rs_ov_torch.nn.hf_text) against
rs_ov.nn.hf_text on the CPU in fp32: RoBERTa (non-pad position ids) with
each pooler, BERT with its tanh pooler and a linear projection, the
state-dict loader under its prefixes, the config table and the init's
shapes. The trees are drawn from a seeded RandomState
(test_torch_timm_towers.draw) and go to both packages. Bound:
max|d|/max|ref| <= 1e-5 (tools/parity_check.py:72-85's tower tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.nn import hf_text as jax_hf
from rs_ov_torch.core.params import module_from_tree
from rs_ov_torch.nn import hf_text as hf
from test_torch_timm_checkpoint import assert_trees_equal
from test_torch_timm_towers import TOL, draw, rel

torch.set_num_threads(1)

ROBERTA = hf.HFTextConfig(model_type="roberta", vocab_size=50, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64, max_position_embeddings=40,
                          pad_token_id=1, output_dim=16, pooler_type="mean_pooler",
                          proj_type="mlp")
BERT = hf.HFTextConfig(model_type="bert", vocab_size=50, hidden_size=32, num_layers=2,
                       num_heads=2, intermediate_size=64, max_position_embeddings=40,
                       layer_norm_eps=1e-12, pad_token_id=0, output_dim=16,
                       pooler_type="cls_pooler", proj_type="linear")


def _jax_cfg(cfg):
    return jax_hf.HFTextConfig(**dataclasses.asdict(cfg))


def _tree(cfg, seed=0):
    shapes = jax.eval_shape(lambda k: jax_hf.init_hf_text_params(k, _jax_cfg(cfg)),
                            jax.random.PRNGKey(0))
    return draw(shapes, seed)


def _ids(cfg, seed=1):
    """Rows of different lengths padded with the pad id at the end."""
    rng = np.random.RandomState(seed)
    ids = np.full((3, 12), cfg.pad_token_id, np.int32)
    for row, n in enumerate((12, 7, 3)):
        ids[row, :n] = rng.randint(2, cfg.vocab_size, n)
    return ids


def _assert_encode_agrees(p, tree, cfg, ids):
    got, got_tok = hf.hf_text_encode(p, ids, cfg, output_tokens=True)
    want, want_tok = jax_hf.hf_text_encode(jax.tree_util.tree_map(jnp.asarray, tree),
                                           jnp.asarray(ids), _jax_cfg(cfg), output_tokens=True)
    errs = (rel(got.numpy(), np.asarray(want)), rel(got_tok.numpy(), np.asarray(want_tok)))
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("pooler", ["mean_pooler", "max_pooler", "cls_pooler",
                                    "cls_last_hidden_state_pooler"])
def test_roberta_poolers_match_jax(pooler):
    """RoBERTa's non-pad position ids and mask with each pooler (cls_pooler
    through the tanh pooler the init gives it) and the mlp projection."""
    cfg = dataclasses.replace(ROBERTA, pooler_type=pooler)
    tree = _tree(cfg)
    _assert_encode_agrees(module_from_tree(tree), tree, cfg, _ids(cfg))
    ids = torch.as_tensor(_ids(cfg))
    np.testing.assert_array_equal(hf._position_ids(ids, cfg).numpy(), np.asarray(
        jax_hf._position_ids(jnp.asarray(ids.numpy()), _jax_cfg(cfg))))


def test_bert_cls_pooler_and_linear_projection_match_jax():
    tree = _tree(BERT, seed=2)
    assert tree["pooler"] is not None and set(tree["proj"]) == {"w"}
    _assert_encode_agrees(module_from_tree(tree), tree, BERT, _ids(BERT))


def _hf_state_dict(tree, base, prefix):
    """A tree in HF transformers' names under ``prefix`` + 'transformer.' +
    ``base`` (the CoCa layout), its projection at ``prefix`` 'proj.*'."""
    t = prefix + "transformer." + base
    e = tree["transformer"]["embeddings"]
    sd = {t + "embeddings.word_embeddings.weight": e["word"],
          t + "embeddings.position_embeddings.weight": e["position"],
          t + "embeddings.token_type_embeddings.weight": e["token_type"],
          t + "embeddings.LayerNorm.weight": e["ln"]["scale"],
          t + "embeddings.LayerNorm.bias": e["ln"]["bias"]}
    names = (("q", "attention.self.query"), ("k", "attention.self.key"),
             ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
             ("inter", "intermediate.dense"), ("out", "output.dense"))
    for i, layer in enumerate(tree["transformer"]["layers"]):
        pre = f"{t}encoder.layer.{i}."
        for ours, theirs in names:
            sd[pre + theirs + ".weight"] = layer[f"{ours}_w"]
            sd[pre + theirs + ".bias"] = layer[f"{ours}_b"]
        for ours, theirs in (("attn_ln", "attention.output.LayerNorm"),
                             ("out_ln", "output.LayerNorm")):
            sd[pre + theirs + ".weight"] = layer[ours]["scale"]
            sd[pre + theirs + ".bias"] = layer[ours]["bias"]
    if tree["pooler"] is not None:
        sd[t + "pooler.dense.weight"] = tree["pooler"]["w"]
        sd[t + "pooler.dense.bias"] = tree["pooler"]["b"]
    proj = tree["proj"] or {}
    if "w" in proj:
        sd[prefix + "proj.weight"] = proj["w"]
    elif proj:
        sd[prefix + "proj.0.weight"], sd[prefix + "proj.2.weight"] = proj["w0"], proj["w1"]
    return sd


@pytest.mark.parametrize("cfg,base,prefix", [(ROBERTA, "roberta.", "text."),
                                             (BERT, "", ""), (BERT, "bert.", "")],
                         ids=["coca-roberta", "bert", "bert-base-prefix"])
def test_state_dict_loader_matches_jax(cfg, base, prefix):
    tree = _tree(cfg, seed=3)
    sd = _hf_state_dict(tree, base, prefix)
    got = hf._hf_text_tree(sd, cfg, prefix)
    assert_trees_equal(got, jax.tree_util.tree_map(
        np.asarray, jax_hf.hf_text_params_from_state_dict(sd, _jax_cfg(cfg), prefix)))
    assert_trees_equal(got, tree)
    _assert_encode_agrees(hf.hf_text_params_from_state_dict(sd, cfg, prefix), tree, cfg,
                          _ids(cfg))
    with pytest.raises(ValueError, match="encoder layers"):
        hf.hf_text_params_from_state_dict(sd, dataclasses.replace(cfg, num_layers=3), prefix)
    with pytest.raises(KeyError, match="No HF text encoder"):
        hf.hf_text_params_from_state_dict(sd, cfg, "visual.")


def test_config_table_and_init_match_jax():
    for name in ("roberta-base", "roberta-large", "xlm-roberta-base", "xlm-roberta-large",
                 "bert-base-uncased"):
        for proj in (None, "linear", "mlp"):
            assert dataclasses.asdict(hf.hf_text_config(name, 512, proj)) == \
                dataclasses.asdict(jax_hf.hf_text_config(name, 512, proj))
    with pytest.raises(NotImplementedError, match="not tabulated"):
        hf.hf_text_config("mt5-base", 512)
    for cfg in (ROBERTA, BERT):
        m = hf.init_hf_text_params(torch.Generator().manual_seed(0), cfg)
        shapes = jax.eval_shape(lambda k: jax_hf.init_hf_text_params(k, _jax_cfg(cfg)),
                                jax.random.PRNGKey(0))
        flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                tuple(v.shape)
                for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        assert {k: tuple(v.shape) for k, v in m.named_parameters()} == flat
        assert hf.hf_text_encode(m, _ids(cfg), cfg).shape == (3, cfg.output_dim)
    with pytest.raises(ValueError, match="requires"):
        hf.init_hf_text_params(torch.Generator(), dataclasses.replace(ROBERTA, proj_type=None))
