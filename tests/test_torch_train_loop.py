"""The training loop and the CLIP training CLI on the port (rs_ov_torch.core.checkpoint
trees, train.loop, python -m rs_ov_torch.train) against rs_ov's on the CPU:
``.npz`` trees written by either package load in the other with equal
leaves; resume from the newest ``step_<n>.npz``; the CLI on --tiny
--synthetic; the manifest formats and the first batch of a manifest equal
to train.py's (images within 1e-6, tokens exactly)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import train as jax_train
from rs_ov.core import checkpoint as jax_checkpoint
from rs_ov.train import blip_retrieval as jax_retrieval
from rs_ov_torch.core import checkpoint
from rs_ov_torch.core.params import blip_retrieval_state_from_numpy
from rs_ov_torch.train import __main__ as cli
from rs_ov_torch.train import loop, step
from test_torch_blip_train import JAX_CFG as BLIP_JCFG
from test_torch_timm_checkpoint import assert_trees_equal
from test_torch_train_step import CFG, batch, drawn_tree, port_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trees_cross_both_ways(tmp_path):
    """A port module (lists of blocks, scalars) and a BLIP retrieval state
    (params, momentum, the int queue ids and ptr) through both packages."""
    tree = drawn_tree(seed=2)
    ours = str(tmp_path / "ours.npz")
    checkpoint.save_pytree(port_params(tree), ours)
    back = jax.tree.map(np.asarray, jax_checkpoint.load_pytree(ours))
    assert_trees_equal(back, tree)
    state = jax.tree.map(np.asarray, jax_retrieval.init_blip_retrieval_state(
        jax.random.PRNGKey(0), BLIP_JCFG, queue_size=8))
    theirs = str(tmp_path / "theirs.npz")
    jax_checkpoint.save_pytree(state, theirs)
    loaded = checkpoint.load_pytree(theirs)
    assert_trees_equal(loaded, state)
    assert loaded["queue"]["idx"].dtype == np.int32
    port_state = blip_retrieval_state_from_numpy(loaded)
    again = str(tmp_path / "again.npz")
    checkpoint.save_pytree(port_state, again)
    assert_trees_equal(jax.tree.map(np.asarray, jax_checkpoint.load_pytree(again)), state)


def test_loop_checkpoints_and_resumes(tmp_path, capsys):
    tree = drawn_tree(seed=3)
    images, texts = batch(4, seed=3)
    fn, init = step.make_clip_train_step(CFG)

    def data():
        while True:
            yield images, texts

    params = port_params(tree)
    params, _, hist = loop.train_loop(fn, params, init(params), data(), 4,
                                      ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1)
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz", "step_4.npz"]
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert loop.latest_checkpoint(str(tmp_path)).endswith("step_4.npz")
    fresh = port_params(tree)
    fresh, _, hist = loop.train_loop(fn, fresh, init(fresh), data(), 5,
                                     ckpt_dir=str(tmp_path), ckpt_every=10, log_every=1)
    assert "resumed from" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [5]
    saved = checkpoint.load_pytree(str(tmp_path / "step_4.npz"))
    assert not np.array_equal(saved["visual"]["proj"], tree["visual"]["proj"])


def test_cli_tiny_synthetic(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "rs_ov_torch.train", "--tiny", "--synthetic", "--steps", "2",
         "--batch-size", "4", "--log-every", "1", "--device", "cpu", "--accum-freq", "2",
         "--grad-clip-norm", "1.0", "--loss", "siglip", "--ckpt-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["step"] == 2 and np.isfinite(last["loss"])
    assert os.path.exists(tmp_path / "step_2.npz")


def _manifests(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 48, 3)).astype(np.uint8)).save(p)
        (tmp_path / f"im{i}.txt").write_text(f"a photo of tile {i}\n")
        paths.append(str(p))
    caps = [f"a photo of tile {i}" for i in range(3)]
    (tmp_path / "m.tsv").write_text("".join(f"{p}\t{c}\n" for p, c in zip(paths, caps)))
    (tmp_path / "m.csv").write_text("".join(f"{p},{c}\n" for p, c in zip(paths, caps)))
    (tmp_path / "m.jsonl").write_text("".join(json.dumps({"image": p, "caption": c}) + "\n"
                                              for p, c in zip(paths, caps)))
    return [str(tmp_path / n) for n in ("m.tsv", "m.csv", "m.jsonl")] + [str(tmp_path)]


def test_manifest_formats_and_batches_match_train_py(tmp_path):
    for path in _manifests(tmp_path):
        assert cli.read_manifest(path) == jax_train._read_manifest(path), path
    args = cli.parse_args(["--data", str(tmp_path / "m.tsv"), "--batch-size", "4"])
    ours = next(cli.data_iter(args, 32, 16, np.random.RandomState(1)))
    theirs = next(jax_train._data_iter(args, 32, 16, np.random.RandomState(1)))
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[1], theirs[1])
    half = next(cli.data_iter(args, 32, 16, np.random.RandomState(1), slice(2, 4)))
    np.testing.assert_array_equal(half[1], theirs[1][2:4])


def test_cli_needs_data_or_synthetic():
    with pytest.raises(SystemExit):
        cli.main(["--tiny", "--device", "cpu"])
