"""SegmentorEx(mesh=...) of the port on 2 gloo ranks (tests/torch_dist_workers.py)
against the meshless port (1e-5) and against the JAX package's
SegmentorEx(mesh=make_mesh(data=2)) on two of the 8 virtual CPU devices
(probabilities within 2e-3, argmax agreement >= 0.999), on the CPU in fp32
with the same weights: 9 crops of a 128x128 image split unevenly over the
"data" axis, with and without cross-tile fusion, predict_batch_raw of three
images (27 crops) with fusion, and a (1, 2) mesh whose "model" ranks repeat
the work. Then the eval's confusion-state reduction over "data" against the
host sum (tests/test_parallel.py:149-170)."""

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.params import init_clip_params
from rs_ov.evalsuite.metrics import IoUMetric as JaxIoUMetric
from rs_ov.evalsuite.metrics import confusion_update as jax_confusion_update
from rs_ov.parallel.mesh import make_mesh as jax_make_mesh
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.evalsuite.metrics import IoUMetric, confusion_update
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from test_torch_segmentor import CFG, _kwargs
from torch_dist_workers import segmentor_mesh_worker, spawn

torch.set_num_threads(1)

FUSION = dict(apply_cross_tile_fusion=True)
# name -> (mesh shape, extra kwargs, entry point)
CASES = {"data2": ((2, 1), {}, "raw"), "data2-fusion": ((2, 1), FUSION, "raw"),
         "data2-fusion-batch": ((2, 1), FUSION, "batch"), "model2": ((1, 2), {}, "raw")}


@pytest.fixture(scope="module")
def weights():
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(init_clip_params(jax.random.PRNGKey(0), CFG)),
            to_np(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)))


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(4).randint(0, 256, (3, 128, 128, 3), np.uint8)


def _draws():
    """Each rank's (predictions, labels) over 4 classes."""
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 4, 100), rng.randint(0, 4, 100)) for _ in range(2)]


@pytest.fixture(scope="module")
def states():
    return np.stack([confusion_update(pred, label, 4) for pred, label in _draws()])


@pytest.fixture(scope="module")
def ranks(weights, images, states, tmp_path_factory):
    """Rank 0's and rank 1's results."""
    tmp = tmp_path_factory.mktemp("mesh")
    got = spawn(segmentor_mesh_worker, 2, tmp, _kwargs(weights, 2), CASES, images, states)
    with np.load(str(tmp / "out.npz") + ".r1.npz") as f:
        return got, dict(f)


def _entry(seg, images, entry):
    res = seg.predict_raw(images[:1]) if entry == "raw" else seg.predict_batch_raw(images)
    return [(np.asarray(r["seg_logits"]), np.asarray(r["pred_sem_seg"])) for r in res]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_equals_the_meshless_port_and_jax(weights, images, ranks, case):
    shape, extra, entry = CASES[case]
    kw = {**_kwargs(weights, 2), **extra}
    want = _entry(SegmentorEx(**kw, device="cpu"), images, entry)
    rank0, rank1 = ranks
    for i, (probs, pred) in enumerate(want):
        # every rank returns the whole result
        for res in (rank0, rank1):
            np.testing.assert_allclose(res[f"{case}/{i}/probs"], probs, atol=1e-5, rtol=0)
            np.testing.assert_array_equal(res[f"{case}/{i}/pred"], pred)
    if shape[0] == 1:
        return  # no data split: the JAX mesh below is the "data" one
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jax_out = _entry(JaxSegmentorEx(**kw, mesh=mesh), images, entry)
    assert len(jax_out) == len(want)
    for i, (probs, pred) in enumerate(jax_out):
        np.testing.assert_allclose(rank0[f"{case}/{i}/probs"], probs, atol=2e-3, rtol=0)
        assert np.mean(rank0[f"{case}/{i}/pred"] == pred) >= 0.999


def test_confusion_state_reduction_equals_the_host_sum(ranks, states):
    """sum_over the "data" group == the host sum, the fp32 device state and
    the float64 host state each in its own dtype; the caller's state is left
    as it was; the merged metric equals the JAX package's."""
    rank0, rank1 = ranks
    for res in (rank0, rank1):
        np.testing.assert_array_equal(res["state_fp32"], states.sum(0).astype(np.float32))
        assert res["state_fp32"].dtype == np.float32
        np.testing.assert_array_equal(res["state_fp64"], states.sum(0))
        assert res["state_fp64"].dtype == np.float64
    np.testing.assert_array_equal(rank0["own_state_after"], states[0])
    np.testing.assert_array_equal(rank1["own_state_after"], states[1])
    m, jm = IoUMetric(4), JaxIoUMetric(4)
    m.merge(rank0["state_fp64"])
    jm.merge(sum(jax_confusion_update(pred, label, 4) for pred, label in _draws()))
    assert m.compute() == jm.compute()
