"""The port's serving export (rs_ov_torch/pipeline/export.py) against the JAX
package's (rs_ov/pipeline/export.py), on the CPU in fp32 with the same
weights: the served probabilities within 2e-3 of the JAX package's served
ones and argmax agreement >= 0.999 (tests/test_torch_segmentor.py's bounds),
and equal to the port's own live ``predict_raw``.

Cases: the channel-first route the CPU takes; the channel-last route with
the classifier fused into the last stage, forced through the route selector
as tests/test_torch_segmentor.py does; ClearCLIP at 2 stages on two classes
(tests/test_export.py's fast-mode case). Each is exported once per module."""

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.params import init_clip_params
from rs_ov.pipeline.export import export_predict as jax_export_predict
from rs_ov.pipeline.export import load_predict as jax_load_predict
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.decontam import outlier
from rs_ov_torch.nn import attention
from rs_ov_torch.pipeline import export
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.pipeline.tiler import tile_grid
from rs_ov_torch.upsample import jbu
from rs_ov_torch.utils import resize
from test_torch_segmentor import CFG, _kwargs

torch.set_num_threads(1)

CASES = {
    "channel_first": dict(hw=(96, 128), route=None, kw={}),
    "nhwc_classify": dict(hw=(96, 128), route="nhwc_classify", kw={}),
    "clearclip_2stage": dict(hw=(64, 64), route=None,
                             kw=dict(model_type="ClearCLIP", global_debias_factor=0.0,
                                     apply_outlier_suppression=False,
                                     apply_similarity_enhancement=False)),
}
# the kernels' operators each route's graph must hold (the tower's LayerNorms
# and linear epilogues on every route)
ROUTE_OPS = {None: {"rs_ov.layer_norm.default", "rs_ov.linear_epilogue.default",
                    "rs_ov.range_logits.default", "rs_ov.adaptive_conv_tapmajor.default"},
             "nhwc_classify": {"rs_ov.layer_norm.default", "rs_ov.linear_epilogue.default",
                               "rs_ov.range_logits.default", "rs_ov.jbu_epilogue.default",
                               "rs_ov.jbu_epilogue_classify.default"}}
DEVICE_CACHES = (resize._matrix, resize._reflect_index, jbu._tap_sq_dist,
                 attention._gaussian_on, outlier._offsets)


@pytest.fixture(scope="module")
def weights():
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(init_clip_params(jax.random.PRNGKey(0), CFG)),
            to_np(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)))


def _case_kwargs(weights, name, tmp):
    kw = {**_kwargs(weights, 2), **CASES[name]["kw"]}
    if name == "clearclip_2stage":
        cls = tmp / "cls.txt"
        cls.write_text("background\nbuilding")
        kw.update(name_path=str(cls), bg_idx=0)
    return kw


def _segmentor(kw, route):
    seg = SegmentorEx(**kw, device="cpu")
    if route is not None:
        seg._jbu_route = lambda tokens: route
    return seg


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """{case: (port artifact path, header, JAX artifact path, kwargs)}, each
    exported once; the device caches are emptied before each export, so the
    export builds every cached constant itself."""
    out = {}

    def get(name):
        if name not in out:
            tmp = tmp_path_factory.mktemp(name)
            kw = _case_kwargs(weights, name, tmp)
            hw = CASES[name]["hw"]
            for cache in DEVICE_CACHES:
                cache.cache_clear()
            path = str(tmp / "port.rsovt")
            header = export.export_predict(_segmentor(kw, CASES[name]["route"]), hw, path)
            jax_path = str(tmp / "jax.rsov")
            jax_export_predict(JaxSegmentorEx(**kw), hw, jax_path)
            out[name] = path, header, jax_path, kw
        return out[name]

    return get


def _image(hw, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_served_equals_live_and_jax(served, case):
    """The served program on a fresh segmentor's process state: equal to the
    port's live predict_raw (the same ops on the same inputs), and within
    the parity bounds of the JAX package's served program."""
    path, header, jax_path, kw = served(case)
    hw = CASES[case]["hw"]
    assert header == {"format": "rs_ov_torch.export_predict", "image_hw": list(hw),
                      "ori_shape": list(hw), "raw": True, "pred_dtype": "int32",
                      "platforms": ["cpu"], "num_queries": header["num_queries"]}
    fn = export.load_predict(path, device="cpu")
    assert fn.header == header
    img = _image(hw)
    got = fn(img)
    probs, pred = got["probs"].numpy(), got["pred_sem_seg"].numpy()
    # predict_raw after the export, on a segmentor built afterwards: the
    # device caches the export left must hold real tensors
    live = _segmentor(kw, CASES[case]["route"]).predict_raw(img[None])[0]
    np.testing.assert_array_equal(probs, live["seg_logits"].numpy())
    np.testing.assert_array_equal(pred, live["pred_sem_seg"].numpy())

    want = jax_load_predict(jax_path)(img)
    assert probs.shape == np.asarray(want["probs"]).shape
    assert pred.shape == np.asarray(want["pred_sem_seg"]).shape == (1, *hw)
    np.testing.assert_allclose(probs, np.asarray(want["probs"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999


@pytest.mark.parametrize("case", list(CASES))
def test_graph_holds_the_kernel_operators(served, case):
    """Each kernel call of the route is one node, its operator; no node is
    the plain version's decomposition standing in for one."""
    fn = export.load_predict(served(case)[0], device="cpu")
    targets = [str(n.target) for n in fn.program.graph.nodes if n.op == "call_function"]
    kernels = {t for t in targets if t.startswith("rs_ov.")}
    assert kernels == ROUTE_OPS[CASES[case]["route"]]
    h, w = CASES[case]["hw"]
    crops = len(tile_grid(h, w, 32, 64)[0])
    # one a stage (2) of each chunk of 2 crops
    assert targets.count("rs_ov.range_logits.default") == 2 * -(-crops // 2)


def test_constants_are_built_outside_the_trace(weights, tmp_path):
    """Under the export a cached device constant is built as a real tensor,
    outside the trace: the caches hold real tensors afterwards, and the
    program holds the constants, not the ops that built them."""
    seg = _segmentor(_case_kwargs(weights, "channel_first", tmp_path), None)
    for cache in DEVICE_CACHES:
        cache.cache_clear()
    path = str(tmp_path / "a.rsovt")
    export.export_predict(seg, (64, 64), path)
    cached = [resize._matrix("bilinear", 4, 8, torch.device("cpu"), torch.float32)]
    cached += [jbu._tap_sq_dist(11, torch.device("cpu"))]
    assert resize._matrix.cache_info().currsize >= 2 and jbu._tap_sq_dist.cache_info().hits
    assert all(type(t) is torch.Tensor for t in cached)
    targets = {str(n.target) for n in export.load_predict(path, device="cpu").program.graph.nodes}
    assert not targets & {"aten.arange.start", "aten.lift_fresh_copy.default"}


def test_loaders_refuse_each_others_artifacts(served, tmp_path):
    """A file that is not an artifact, the JAX package's artifact in the
    port's loader, and the port's in the JAX package's loader."""
    junk = tmp_path / "junk.rsovt"
    junk.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an rs_ov_torch export"):
        export.load_predict(str(junk), device="cpu")
    path, _, jax_path, _ = served("channel_first")
    with pytest.raises(ValueError, match="not an rs_ov_torch export"):
        export.load_predict(jax_path, device="cpu")
    with pytest.raises(ValueError, match="not an rs_ov export"):
        jax_load_predict(path)


def test_load_refuses_another_device(served):
    with pytest.raises(ValueError, match="exported on cpu and cannot be served on cuda"):
        export.load_predict(served("channel_first")[0])


def test_export_refuses_a_mesh(weights, tmp_path):
    seg = _segmentor(_case_kwargs(weights, "channel_first", tmp_path), None)
    seg.mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        export.export_predict(seg, (64, 64), str(tmp_path / "m.rsovt"))


def test_float_contract(weights, tmp_path):
    """raw=False takes the normalised [1, 3, H, W] image, as predict does."""
    seg = _segmentor(_case_kwargs(weights, "channel_first", tmp_path), None)
    path = str(tmp_path / "f.rsovt")
    header = export.export_predict(seg, (64, 64), path, ori_shape=(48, 80), raw=False)
    assert header["raw"] is False and header["ori_shape"] == [48, 80]
    x = np.random.RandomState(3).randn(1, 3, 64, 64).astype(np.float32)
    got = export.load_predict(path, device="cpu")(x)
    live = seg.predict(x, [{"ori_shape": (48, 80)}])[0]
    assert got["probs"].shape == (6, 48, 80)
    np.testing.assert_array_equal(got["probs"].numpy(), live["seg_logits"].numpy())
    np.testing.assert_array_equal(got["pred_sem_seg"].numpy(), live["pred_sem_seg"].numpy())
