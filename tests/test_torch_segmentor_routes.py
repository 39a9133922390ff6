"""The port's SegmentorEx on its channel-first route (the route the CPU, fp32
on the card and the RS_OV_JBU_FUSED=0 kill switch take) vs the JAX package's
SegmentorEx, on the CPU in fp32 with the same weights: per-pixel class
probabilities within 2e-3 and argmax agreement >= 0.999
(tools/parity_check.py:72-85, :528-531). Cases: jbu_one and jbu_stack at 2
and 4 stages, the route without SimFeatUp, and the CLS-logit blend."""

import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params, init_jbu_stack_params
from rs_ov_torch.pipeline.segmentor import SegmentorEx

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
            {"jbu_one": to_np(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)),
             "jbu_stack": to_np(init_jbu_stack_params(jax.random.PRNGKey(2), CFG.embed_dim))})


def _kwargs(weights, name="jbu_one", stages=2, **over):
    """configs/base_config.py at crop 64 / stride 32, outlier top-k cut to
    the 16-patch grid."""
    params, ups = weights
    kw = dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
              name_path=POTSDAM, ignore_residual=True, slide_stride=32, slide_crop=64,
              global_debias_factor=0.2, apply_sim_feat_up=True,
              sim_feat_up_cfg=dict(model_name=name, num_stages=stages,
                                   model_path="weights/absent.ckpt"),
              apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
              apply_similarity_enhancement=True, prob_thd=0.1, bg_idx=5,
              clip_config=CFG, params=params, upsampler_params=ups[name])
    kw.update(over)
    return kw


@pytest.mark.parametrize("case", [
    dict(name="jbu_one", stages=2), dict(name="jbu_one", stages=4),
    dict(name="jbu_stack", stages=2), dict(name="jbu_stack", stages=4),
    dict(apply_sim_feat_up=False), dict(cls_token_lambda=0.3),
], ids=["jbu_one-2", "jbu_one-4", "jbu_stack-2", "jbu_stack-4", "no_simfeatup",
        "cls_token_lambda"])
def test_channel_first_route_matches_jax(weights, case):
    img = np.random.RandomState(3).randint(0, 256, (1, 96, 128, 3), np.uint8)
    kw = _kwargs(weights, **case)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    seg = SegmentorEx(**kw, device="cpu")
    if seg.apply_sim_feat_up:
        assert seg._jbu_route(torch.zeros(1, 1, 1)) == "channel_first"
    got = seg.predict_raw(img)[0]
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    assert probs.shape == (6, 96, 128) and pred.shape == (1, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999


def test_nhwc_feature_route_matches_jax(weights, monkeypatch):
    """The channel-last route without the fused classifier (the card's bf16
    route when Q > 128), forced here, with jbu_stack at 4 stages."""
    img = np.random.RandomState(4).randint(0, 256, (1, 64, 96, 3), np.uint8)
    kw = _kwargs(weights, name="jbu_stack", stages=4)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    seg = SegmentorEx(**kw, device="cpu")
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: "nhwc")
    got = seg.predict_raw(img)[0]
    np.testing.assert_allclose(got["seg_logits"].numpy(), np.asarray(want["seg_logits"]),
                               atol=2e-3, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999


def test_route_selection(weights, monkeypatch):
    """The JAX rule (rs_ov/pipeline/segmentor.py:329-340) with the card in
    place of the TPU: bf16 tokens on the card take the channel-last routes
    unless RS_OV_JBU_FUSED=0; fp32 and the CPU take channel-first."""
    seg = SegmentorEx(**_kwargs(weights), device="cpu")
    meta = torch.device("meta")

    class Tok:  # the selector reads dtype and device only
        def __init__(self, dtype, device):
            self.dtype, self.device = dtype, device

    cuda = torch.device("cuda")
    monkeypatch.delenv("RS_OV_JBU_FUSED", raising=False)
    assert seg._jbu_route(Tok(torch.bfloat16, cuda)) == "nhwc_classify"
    assert seg._jbu_route(Tok(torch.float32, cuda)) == "channel_first"
    assert seg._jbu_route(Tok(torch.bfloat16, meta)) == "channel_first"
    assert seg._jbu_route(Tok(torch.bfloat16, torch.device("cpu"))) == "channel_first"
    monkeypatch.setattr(seg, "query_features", torch.zeros(129, 32))
    assert seg._jbu_route(Tok(torch.bfloat16, cuda)) == "nhwc"
    monkeypatch.setenv("RS_OV_JBU_FUSED", "0")
    assert seg._jbu_route(Tok(torch.bfloat16, cuda)) == "channel_first"
