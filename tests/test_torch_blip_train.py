"""BLIP training on the port (rs_ov_torch.train.blip_retrieval, blip_pretrain,
nn.blip_lm's losses) against rs_ov's on the CPU in fp32, from drawn trees.

The JAX step is run with ``optax.sgd(SGD_LR)``, so its gradient is
(params - params') / SGD_LR; both packages' negative samplers are replaced
by the same argmax (``jax.random.categorical`` patched: the JAX step traces
at its first call, so no JAX file changes). Bounds: losses within 1e-5
relative; gradients max|d|/max|ref| <= GRAD_TOL per leaf; the EMA, the
queue ring and ``ptr`` within 1e-6. The port's sampler is held to the
softmax on its own (frequencies of 20000 draws within 0.015)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rs_ov.nn import blip_lm as jax_lm
from rs_ov.train import blip_pretrain as jax_pretrain
from rs_ov.train import blip_retrieval as jax_retrieval
from rs_ov_torch.core.params import (blip_decoder_params_from_numpy, blip_nlvr_params_from_numpy,
                                     blip_pretrain_state_from_numpy,
                                     blip_retrieval_state_from_numpy, blip_vqa_params_from_numpy)
from rs_ov_torch.nn import blip_lm
from rs_ov_torch.train import blip_pretrain, blip_retrieval
from test_torch_blip_lm import CFG, JAX_CFG
from test_torch_timm_towers import draw
from test_torch_train_step import assert_grads_match, flat

torch.set_num_threads(2)

SGD_LR = 1e4
GRAD_TOL = 1e-4
Q, B = 16, 4
ENC, BOS = 3, 2


def _argmax_categorical(key, logits, axis=-1):
    return jnp.argmax(logits, axis=axis)


def _argmax_sampler(logits, gen):
    return logits.argmax(1)


@pytest.fixture
def argmax_samplers(monkeypatch):
    monkeypatch.setattr(jax.random, "categorical", _argmax_categorical)
    monkeypatch.setattr(blip_retrieval, "_sample_negatives", _argmax_sampler)


def drawn_state(init, seed, temp=0.07):
    """The JAX init's state with every leaf of params and params_m drawn
    (params_m from its own seed, so the EMA moves it), ``temp`` as given,
    some queue ids equal to the batch's."""
    state = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JAX_CFG, queue_size=Q))
    state["params"] = draw(state["params"], seed)
    state["params"]["temp"] = np.float32(temp)
    state["params_m"] = draw(state["params_m"], seed + 1)
    state["queue"]["idx"] = state["queue"]["idx"].copy()
    state["queue"]["idx"][0, :3] = [1, 7, 2]
    state["queue"]["ptr"] = np.int32(8)
    return state


def batch(seed=3):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, 3, 32, 32).astype(np.float32)
    ids = rng.randint(4, 60, size=(B, 6)).astype(np.int32)
    mask = np.ones((B, 6), np.int32)
    mask[1, 4:] = 0
    ids[1, 4:] = 0
    idx = np.asarray([1, 1, 2, 5], np.int32)  # a duplicate pair, and ids shared with the queue
    return images, ids, mask, idx


def _run_both(jinit, jmake, ours_from, ours_make, seed, temp=0.07, **kw):
    tree = drawn_state(jinit, seed, temp)
    images, ids, mask, idx = batch()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jfn, jinit_opt = jmake(JAX_CFG, mesh, optimizer=optax.sgd(SGD_LR), **kw)
    jstate = jax.tree.map(jnp.asarray, tree)
    before = flat(tree["params"])
    jstate, _, jl = jfn(jstate, jinit_opt(jstate["params"]), jnp.asarray(images),
                        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(idx), jnp.float32(0.4),
                        jax.random.PRNGKey(1))
    jstate = jax.tree.map(np.asarray, jstate)
    jgrads = {k: (before[k] - v) / SGD_LR for k, v in flat(jstate["params"]).items()}
    state = ours_from(tree)
    fn, _ = ours_make(CFG, **kw)
    tl = fn.backward(state, images, ids, mask, idx, 0.4, torch.Generator())
    for a, b in zip(tl, jl):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (tl, jl)
    assert_grads_match(state["params"], jgrads)
    for n, pm in state["params_m"].named_parameters():
        np.testing.assert_allclose(pm.detach().numpy(), flat(jstate["params_m"])[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    for k in ("image", "text", "idx"):
        np.testing.assert_allclose(state["queue"][k].numpy(), jstate["queue"][k], rtol=0,
                                   atol=1e-6, err_msg=k)
    assert int(state["queue"]["ptr"]) == int(jstate["queue"]["ptr"]) == (8 + B) % Q
    return state


def test_retrieval_step_matches_jax(argmax_samplers):
    """ITC with momentum targets and the duplicate-idx mass, ITM with the
    argmax negatives, the EMA before the momentum forward, the queue ring."""
    _run_both(jax_retrieval.init_blip_retrieval_state,
              jax_retrieval.make_blip_retrieval_train_step,
              blip_retrieval_state_from_numpy, blip_retrieval.make_blip_retrieval_train_step,
              seed=5, enc_token_id=ENC)


def test_temp_is_clamped_inside_the_loss(argmax_samplers):
    """temp 1.0 reads as 0.5 in the loss and takes no gradient, as in JAX."""
    state = _run_both(jax_retrieval.init_blip_retrieval_state,
                      jax_retrieval.make_blip_retrieval_train_step,
                      blip_retrieval_state_from_numpy,
                      blip_retrieval.make_blip_retrieval_train_step, seed=6, temp=1.0,
                      enc_token_id=ENC)
    assert float(state["params"].temp.grad) == 0.0


def test_pretrain_step_matches_jax_and_keeps_the_tied_leaves_one(argmax_samplers):
    state = _run_both(jax_pretrain.init_blip_pretrain_state,
                      jax_pretrain.make_blip_pretrain_train_step,
                      blip_pretrain_state_from_numpy, blip_pretrain.make_blip_pretrain_train_step,
                      seed=7, enc_token_id=ENC, bos_token_id=BOS)
    params = state["params"]
    dec = blip_retrieval.decoder_view(params.text, params.dec_self_attn)
    for layer, enc, own in zip(dec.layers, params.text.layers, params.dec_self_attn):
        assert layer.inter_w is enc.inter_w and layer.x_out_w is enc.x_out_w
        assert layer.q_w is own.q_w and layer.attn_ln.scale is own.attn_ln.scale
    assert dec.embeddings.word is params.text.embeddings.word
    n_leaves = len(jax.tree_util.tree_leaves(drawn_state(
        jax_pretrain.init_blip_pretrain_state, 7)["params"]))
    assert len(list(params.parameters())) == n_leaves


def test_step_updates_the_state_in_place():
    """A port-initialised retrieval state: one whole step (the real sampler)
    moves ptr by B, writes the momentum features at the old ptr, and moves
    every trainable leaf."""
    state = blip_retrieval.init_blip_retrieval_state(torch.Generator().manual_seed(0), CFG,
                                                     queue_size=Q)
    fn, init = blip_retrieval.make_blip_retrieval_train_step(CFG, enc_token_id=ENC)
    opt = init(state["params"])
    images, ids, mask, idx = batch()
    before = [p.detach().clone() for p in state["params"].parameters()]
    state, opt, losses = fn(state, opt, images, ids, mask, idx, 0.4,
                            torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(x)) for x in losses)
    assert int(state["queue"]["ptr"]) == B
    with torch.no_grad():
        _, fm, tm = blip_retrieval._encode(state["params_m"], torch.from_numpy(images),
                                           torch.from_numpy(ids).long(),
                                           torch.from_numpy(mask).long(), CFG)
    torch.testing.assert_close(state["queue"]["image"][:, :B], fm.t(), rtol=0, atol=1e-6)
    torch.testing.assert_close(state["queue"]["text"][:, :B], tm.t(), rtol=0, atol=1e-6)
    moved = [not torch.equal(a, p) for a, p in zip(before, state["params"].parameters())]
    assert all(moved)


def test_sampler_frequencies_follow_the_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1e9], [3.0, 0.5, -1e9, 0.0]])
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = blip_retrieval._sample_negatives(logits.repeat_interleave(n, 0), gen).reshape(2, n)
    want = torch.softmax(logits, 1)
    for r in range(2):
        freq = torch.bincount(draws[r], minlength=4).float() / n
        assert torch.all((freq - want[r]).abs() <= 0.015), (freq, want[r])
        assert freq[want[r] == 0].sum() == 0


def _grad_check(jloss, jtree, ours, ours_loss):
    (jl, jg) = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, jtree))
    params = ours.requires_grad_()
    tl = ours_loss(params)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert_grads_match(params, jax.tree.map(np.asarray, jg))


def _tree(init, seed):
    return draw(jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), JAX_CFG)), seed)


def test_caption_loss_and_gradient_match_jax():
    images, ids, mask, _ = batch(4)
    ids[:, 0] = BOS
    tree = _tree(jax_lm.init_blip_decoder_params, 8)
    _grad_check(lambda p: jax_lm.blip_caption_loss(p, jnp.asarray(images), jnp.asarray(ids),
                                                   jnp.asarray(mask), JAX_CFG),
                tree, blip_decoder_params_from_numpy(tree),
                lambda p: blip_lm.blip_caption_loss(p, images, ids, mask, CFG))
    t = blip_lm.caption_targets(torch.from_numpy(ids).long(), 0, 4)
    assert (t[:, :4] == -100).all() and (t[1, 4:] == -100).all()


def test_vqa_loss_and_gradient_match_jax():
    images, q_ids, q_mask, _ = batch(5)
    q_ids[:, 0] = ENC
    rng = np.random.RandomState(6)
    a_ids = rng.randint(4, 60, size=(6, 5)).astype(np.int32)
    a_ids[:, 0] = BOS
    a_ids[2, 3:] = 0
    a_mask = (a_ids != 0).astype(np.int32)
    a2q = np.asarray([0, 0, 1, 2, 3, 3], np.int32)
    w = rng.rand(6).astype(np.float32)
    tree = _tree(jax_lm.init_blip_vqa_params, 9)
    _grad_check(lambda p: jax_lm.blip_vqa_loss(p, jnp.asarray(images), jnp.asarray(q_ids),
                                               jnp.asarray(q_mask), jnp.asarray(a_ids),
                                               jnp.asarray(a_mask), jnp.asarray(a2q),
                                               jnp.asarray(w), JAX_CFG),
                tree, blip_vqa_params_from_numpy(tree),
                lambda p: blip_lm.blip_vqa_loss(p, images, q_ids, q_mask, a_ids, a_mask, a2q, w,
                                                CFG))


def test_nlvr_loss_and_gradient_match_jax():
    rng = np.random.RandomState(7)
    images = rng.randn(2 * B, 3, 32, 32).astype(np.float32)
    _, ids, mask, _ = batch(7)
    ids[:, 0] = ENC
    targets = np.asarray([0, 1, 1, 0], np.int32)
    tree = _tree(jax_lm.init_blip_nlvr_params, 10)
    ours = blip_nlvr_params_from_numpy(tree)
    _grad_check(lambda p: jax_lm.blip_nlvr_forward(p, jnp.asarray(images), jnp.asarray(ids),
                                                   jnp.asarray(mask), JAX_CFG,
                                                   targets=jnp.asarray(targets)),
                tree, ours,
                lambda p: blip_lm.blip_nlvr_forward(p, images, ids, mask, CFG, targets=targets))
    assert not blip_lm.blip_nlvr_forward(ours, images, ids, mask, CFG).requires_grad
