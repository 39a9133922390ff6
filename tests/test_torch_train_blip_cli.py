"""python -m rs_ov_torch.train_blip on the CPU: one --tiny --synthetic run per
task with finite losses and a final checkpoint, --evaluate, and the manifest
batches (with --augment) equal to train_blip.py's (images within 1e-5, ids,
masks and image ids exactly)."""

import json
import os

import numpy as np
import pytest
import torch

import train_blip as jax_train_blip
from rs_ov_torch import train_blip
from rs_ov_torch.core.checkpoint import load_pytree
from test_torch_train_loop import _manifests

torch.set_num_threads(2)

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                     "blip_decode_vocab.txt")


@pytest.mark.parametrize("task", train_blip.TASKS)
def test_each_task_trains_on_synthetic_batches(task, tmp_path):
    last = train_blip.main(["--task", task, "--tiny", "--synthetic", "--steps", "2",
                            "--batch-size", "4", "--device", "cpu", "--log-every", "1",
                            "--precision", "fp32" if task == "vqa" else "bf16",
                            "--ckpt-dir", str(tmp_path)])
    assert last and all(np.isfinite(v) for v in last.values()), last
    tree = load_pytree(str(tmp_path / "final.npz"))
    if task in ("retrieval", "pretrain"):
        assert int(tree["queue"]["ptr"]) == 8 and "params_m" in tree


def test_evaluate_prints_the_recalls(capsys):
    m = train_blip.main(["--task", "retrieval", "--tiny", "--synthetic", "--evaluate",
                         "--eval-samples", "8", "--k-test", "4", "--device", "cpu"])
    assert set(m) >= {"txt_r1", "img_r1", "r_mean"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        k: round(v, 3) for k, v in m.items()}


@pytest.mark.parametrize("task", ["retrieval", "caption"])
def test_manifest_batches_match_train_blip_py(task, tmp_path):
    manifest = _manifests(tmp_path)[0]
    argv = ["--task", task, "--data", manifest, "--vocab", VOCAB, "--batch-size", "4",
            "--augment", "--tiny", "--context-length", "8"]
    args = train_blip.parse_args(argv)
    jargs = jax_train_blip.parse_args(argv)
    cfg = train_blip.blip_cfg(args)
    ours = next(train_blip.pair_batches(args, cfg, np.random.RandomState(2)))
    theirs = next(jax_train_blip._pair_batches(jargs, jax_train_blip._blip_cfg(jargs),
                                               np.random.RandomState(2)))
    assert set(ours) == set(theirs)
    np.testing.assert_allclose(ours["images"], theirs["images"], rtol=0, atol=1e-5)
    for k in set(ours) - {"images"}:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert train_blip.special_token_ids(args) == jax_train_blip._special_token_ids(jargs)
