"""The port's batched entry ``SegmentorEx.predict_batch_raw``, shape buckets,
the ``RS_OV_JBU_STAGES`` / ``RS_OV_TILE_CHUNK`` / ``RS_OV_SHAPE_BUCKET``
overrides and the plain ``Segmentor`` vs the JAX package, on the CPU in fp32
with the same weights: per-pixel class probabilities within 2e-3 and argmax
agreement >= 0.999 (tools/parity_check.py:72-85, :528-531); and the batch
against the port's own per-image ``predict_raw``."""

import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.data.transforms import PREPROC_MEAN, PREPROC_STD
from rs_ov.pipeline.segmentor import Segmentor as JaxSegmentor
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.pipeline.segmentor import Segmentor, SegmentorEx

torch.set_num_threads(1)

CFG = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                        output_dim=32, head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                    layers=2, output_dim=32))
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


@pytest.fixture(scope="module")
def weights():
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(init_clip_params(jax.random.PRNGKey(0), CFG)),
            to_np(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)))


def _kwargs(weights, **over):
    """configs/base_config.py at crop 64 / stride 32, outlier top-k cut to
    the 16-patch grid."""
    params, up = weights
    kw = dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
              name_path=POTSDAM, ignore_residual=True, slide_stride=32, slide_crop=64,
              global_debias_factor=0.2, apply_sim_feat_up=True,
              sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=2,
                                   model_path="weights/absent.ckpt"),
              apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
              apply_similarity_enhancement=True, prob_thd=0.1, bg_idx=5,
              clip_config=CFG, params=params, upsampler_params=up)
    kw.update(over)
    return kw


def _images(n, h=96, w=128, seed=8):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), np.uint8)


def _assert_matches(got, want, atol=2e-3, agree=0.999):
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=atol, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= agree


BATCH_CASES = {"plain": {}, "cross_tile": dict(apply_cross_tile_fusion=True)}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_predict_batch_raw_matches_jax(weights, case):
    """Two 96x128 images, 12 crops through one ViT batch; with cross-tile
    fusion the crops are regrouped per image before fusing."""
    imgs = _images(2)
    kw = _kwargs(weights, **BATCH_CASES[case])
    want = JaxSegmentorEx(**kw).predict_batch_raw(imgs)
    got = SegmentorEx(**kw, device="cpu").predict_batch_raw(imgs)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g["seg_logits"].shape == (6, 96, 128) and g["pred_sem_seg"].shape == (1, 96, 128)
        _assert_matches(g, w)


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_predict_batch_raw_equals_per_image_predict_raw(weights, case):
    """The batch is the same computation as one predict_raw per image: the
    argmax equal, probabilities within 1e-5; cross-tile fusion fuses each
    image's crops among themselves."""
    imgs = _images(3, seed=9)
    seg = SegmentorEx(**_kwargs(weights, **BATCH_CASES[case]), device="cpu")
    batch = seg.predict_batch_raw(imgs)
    for i, got in enumerate(batch):
        one = seg.predict_raw(imgs[i:i + 1])[0]
        np.testing.assert_array_equal(got["pred_sem_seg"].numpy(), one["pred_sem_seg"].numpy())
        np.testing.assert_allclose(got["seg_logits"].numpy(), one["seg_logits"].numpy(),
                                   atol=1e-5, rtol=0)


def test_predict_batch_raw_shapes(weights, monkeypatch):
    """One image goes to predict_raw; a shared ori_shape resizes every
    result; mixed ori_shapes raise, as in the JAX package."""
    seg = SegmentorEx(**_kwargs(weights), device="cpu")
    imgs = _images(2, 64, 64)
    out = seg.predict_batch_raw(imgs, [{"ori_shape": (32, 48)}] * 2)
    assert [o["pred_sem_seg"].shape for o in out] == [(1, 32, 48)] * 2
    with pytest.raises(ValueError, match="shape-homogeneous"):
        seg.predict_batch_raw(imgs, [{"ori_shape": (32, 48)}, {}])
    with pytest.raises(AssertionError, match="shape-homogeneous"):
        JaxSegmentorEx(**_kwargs(weights)).predict_batch_raw(imgs, [{"ori_shape": (32, 48)}, {}])
    seen = []
    monkeypatch.setattr(seg, "predict_raw", lambda x, m=None: seen.append(x.shape) or ["one"])
    assert seg.predict_batch_raw(imgs[:1]) == ["one"] and seen == [(1, 64, 64, 3)]


def test_shape_bucket_matches_jax(weights, monkeypatch):
    """A 200x150 image padded up to 224x160 (bucket 32): predict_raw pads the
    uint8 image with 0, predict the normalised one with 0; the logits are
    cropped back before the resize. Both match the JAX package, and
    RS_OV_SHAPE_BUCKET sets the bucket when the argument is 0."""
    img = _images(1, 200, 150, seed=10)
    kw = _kwargs(weights, shape_bucket=32)
    jseg = JaxSegmentorEx(**kw)
    seg = SegmentorEx(**kw, device="cpu")
    want = jseg.predict_raw(img)[0]
    got = seg.predict_raw(img)[0]
    assert got["seg_logits"].shape == (6, 200, 150)
    _assert_matches(got, want)
    norm = ((img.astype(np.float32) - PREPROC_MEAN) / PREPROC_STD).transpose(0, 3, 1, 2)
    _assert_matches(seg.predict(norm)[0], jseg.predict(norm)[0])
    # the bucket changes the result near the padded margin, as in JAX
    exact = SegmentorEx(**_kwargs(weights), device="cpu").predict_raw(img)[0]
    assert not torch.equal(exact["seg_logits"], got["seg_logits"])
    monkeypatch.setenv("RS_OV_SHAPE_BUCKET", "32")
    assert SegmentorEx(**_kwargs(weights), device="cpu").shape_bucket == 32


def test_env_overrides(weights, monkeypatch):
    """RS_OV_JBU_STAGES overrides num_stages (tests/test_jbu_stages.py:109);
    RS_OV_TILE_CHUNK applies at call time when tile_chunk is 0, whose default
    is 2 with SimFeatUp and no chunking without; chunking does not change
    the result."""
    monkeypatch.setenv("RS_OV_JBU_STAGES", "4")
    seg = SegmentorEx(**_kwargs(weights), device="cpu")
    assert seg.jbu_stages == JaxSegmentorEx(**_kwargs(weights)).jbu_stages == 4
    monkeypatch.setenv("RS_OV_JBU_STAGES", "5")
    with pytest.raises(ValueError, match="stages"):
        SegmentorEx(**_kwargs(weights), device="cpu")
    monkeypatch.delenv("RS_OV_JBU_STAGES")

    seg = SegmentorEx(**_kwargs(weights), device="cpu")
    assert seg._chunk_size() == 2
    assert SegmentorEx(**_kwargs(weights, apply_sim_feat_up=False), device="cpu")._chunk_size() == 0
    assert SegmentorEx(**_kwargs(weights, tile_chunk=4), device="cpu")._chunk_size() == 4
    img = _images(1, 64, 96, seed=11)
    ref = seg.predict_raw(img)[0]
    monkeypatch.setenv("RS_OV_TILE_CHUNK", "3")
    assert seg._chunk_size() == 3
    got = seg.predict_raw(img)[0]
    np.testing.assert_allclose(got["seg_logits"].numpy(), ref["seg_logits"].numpy(),
                               atol=1e-5, rtol=0)


def test_segmentor_matches_jax(weights):
    """The plain SegEarth-OV variant drops the decontamination switches it
    is given and matches the JAX Segmentor."""
    kw = _kwargs(weights, apply_ctd=True, apply_self_attn_enhancement=True,
                 apply_layer_fusion=True)
    del kw["model_type"]
    img = _images(1, 64, 96, seed=12)
    seg = Segmentor(**kw, device="cpu")
    assert seg.call.model_type == "SegEarth" and not seg.apply_ctd
    assert not (seg.call.apply_outlier_suppression or seg.call.apply_layer_fusion
                or seg.call.apply_similarity_enhancement
                or seg.call.apply_self_attn_enhancement)
    _assert_matches(seg.predict_raw(img)[0], JaxSegmentor(**kw).predict_raw(img)[0])


@pytest.mark.parametrize("option", [dict(result_dir="out"), dict(heatmap_dir="heat")])
def test_dump_dirs_raise(weights, option, tmp_path):
    """result_dir / heatmap_dir no longer raise: on every entry both packages
    write one PNG per image, named after its path (else sample_<i>), with
    the same colours wherever the predictions agree (masks: >= 0.999 of the
    pixels; heatmaps of the max probability, within 2e-3: one level of 255,
    which the JET colour map spreads to up to 4 per channel)."""
    from PIL import Image

    option, = option
    imgs = _images(2, 64, 96, seed=13)
    metas = [{"img_path": "/data/a.png"}, {"img_path": "/data/b.jpg"}]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    JaxSegmentorEx(**_kwargs(weights, **{option: str(jax_dir)})).predict_batch_raw(imgs, metas)
    seg = SegmentorEx(**_kwargs(weights, **{option: str(port_dir)}), device="cpu")
    seg.predict_batch_raw(imgs, metas)
    seg.predict_raw(imgs[:1])
    seg.predict(((imgs[1:].astype(np.float32) - PREPROC_MEAN) / PREPROC_STD).transpose(0, 3, 1, 2),
                [{"filename": "c.png"}])
    assert sorted(os.listdir(port_dir)) == ["a.png", "b.png", "c.png", "sample_0.png"]
    for name in ("a.png", "b.png"):
        want = np.asarray(Image.open(jax_dir / name)).astype(np.int64)
        got = np.asarray(Image.open(port_dir / name)).astype(np.int64)
        assert got.shape == want.shape == (64, 96, 3)
        same = np.mean((got == want).all(-1))
        if option == "result_dir":
            assert same >= 0.999
        else:
            assert same >= 0.99 and np.abs(got - want).max() <= 4
