"""The port's mesh on 2 gloo ranks (rs_ov_torch.parallel, the train steps
over a mesh) against the single-process step and rs_ov's on the CPU in fp32.

- data-parallel (--mesh 2,1): each rank encodes its half of the global
  batch; CLIP through the gather, SigLIP through the ring (with 2
  micro-batches); the averaged gradient against the single-process step's
  on the whole batch and against jax.grad of rs_ov's loss;
- tensor-parallel (--mesh 1,2): the blocks split over "model", the gathered
  gradient against the unsharded step's;
- BLIP retrieval, data-parallel with the argmax sampler: losses, gradient
  and the queue against the single-process step.

Bound: max|d|/max|ref| <= GRAD_TOL per leaf (fp32 sums in another order),
losses within 1e-5 relative."""

import numpy as np
import pytest
import torch

from rs_ov_torch.core.params import (blip_retrieval_state_from_numpy, clip_params_from_numpy)
from rs_ov_torch.parallel import sharding
from rs_ov_torch.train import blip_retrieval, step
from test_torch_blip_train import CFG as BLIP_CFG
from test_torch_blip_train import ENC, batch as blip_batch, drawn_state
from test_torch_train_step import CFG, assert_grads_match, batch, drawn_tree, jax_grads
from torch_dist_workers import blip_step_worker, clip_step_worker, spawn

torch.set_num_threads(2)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _with_grads(module, res):
    """``module`` with a worker's gradient (``g/<name>``) as its ``.grad``."""
    for n, p in module.named_parameters():
        p.grad = torch.from_numpy(res[f"g/{n}"])
    return module


def _grads(module):
    return _nest({n: p.grad.numpy() for n, p in module.named_parameters()})


@pytest.mark.parametrize("mesh,loss,accum", [((2, 1), "clip", 1), ((2, 1), "siglip", 2),
                                             ((1, 2), "clip", 1)])
def test_two_rank_step_matches_the_single_process_step(tmp_path, mesh, loss, accum):
    tree = drawn_tree(seed=11, siglip=loss == "siglip")
    images, texts = batch(8, seed=12)
    res = spawn(clip_step_worker, 2, tmp_path, tree, CFG, images, texts, mesh, loss, accum)
    single = clip_params_from_numpy(tree, CFG).requires_grad_()
    fn, _ = step.make_clip_train_step(CFG, loss=loss)
    want_loss = float(fn.backward(single, images, texts))
    assert abs(float(res["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    got = _with_grads(clip_params_from_numpy(tree, CFG).requires_grad_(), res)
    assert_grads_match(got, _grads(single))
    if mesh == (2, 1):
        assert_grads_match(got, jax_grads(tree, images, texts, loss)[1])


def test_shard_and_gather_round_trip():
    """Whole heads on each rank: q, k and v rows of the same heads."""
    w = torch.arange(12 * 4, dtype=torch.float32).reshape(12, 4)  # 3 x (4 rows), 2 heads of 2
    parts = [sharding._shard(w, ("qkv", 0), r, 2) for r in range(2)]
    assert torch.equal(parts[0], torch.cat([w[0:2], w[4:6], w[8:10]]))
    assert torch.equal(sharding._unshard(parts, ("qkv", 0)), w)
    cols = [sharding._shard(w, ("dim", 1), r, 2) for r in range(2)]
    assert torch.equal(sharding._unshard(cols, ("dim", 1)), w)
    specs = sharding.clip_param_shardings(clip_params_from_numpy(drawn_tree(), CFG))
    assert specs["visual.blocks.0.attn.in_proj_w"] == ("qkv", 0)
    assert specs["text.blocks.1.mlp.c_proj_w"] == ("dim", 1)
    assert specs["visual.blocks.0.attn.out_proj_b"] is None and specs["logit_scale"] is None


def test_two_rank_blip_retrieval_matches_the_single_process_step(tmp_path, monkeypatch):
    monkeypatch.setattr(blip_retrieval, "_sample_negatives", lambda logits, gen: logits.argmax(1))
    from rs_ov.train import blip_retrieval as jax_retrieval

    tree = drawn_state(jax_retrieval.init_blip_retrieval_state, 13)
    data = blip_batch(14)
    res = spawn(blip_step_worker, 2, tmp_path, tree, BLIP_CFG, data, ENC)
    state = blip_retrieval_state_from_numpy(tree)
    fn, _ = blip_retrieval.make_blip_retrieval_train_step(BLIP_CFG, enc_token_id=ENC)
    losses = fn.backward(state, *data, 0.4, torch.Generator())
    np.testing.assert_allclose(res["losses"], [float(x) for x in losses], rtol=1e-5)
    np.testing.assert_allclose(res["queue_image"], state["queue"]["image"].numpy(), rtol=0,
                               atol=1e-6)
    assert int(res["ptr"]) == int(state["queue"]["ptr"])
    assert_grads_match(_with_grads(blip_retrieval_state_from_numpy(tree)["params"], res),
                       _grads(state["params"]))
