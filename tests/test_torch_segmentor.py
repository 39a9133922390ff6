"""The port's SegmentorEx (the production recipe on a tiny arch) vs the JAX
package's, on the CPU in fp32, with the same weights: per-pixel class
probabilities within 2e-3 and argmax agreement >= 0.999
(tools/parity_check.py:72-85, :528-531).

On the CPU both packages take the channel-first JBU route
(tests/test_torch_segmentor_routes.py); here the port is forced onto the
channel-last route the card takes for bf16, with the classifier fused into
the last stage, through its private route selector."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.data.transforms import PREPROC_MEAN, PREPROC_STD
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params
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
            to_np(init_jbu_one_params(jax.random.PRNGKey(1), CFG.embed_dim)))


def _kwargs(weights, stages):
    """configs/base_config.py at crop 64 / stride 32, outlier top-k cut to
    the 16-patch grid."""
    params, up = weights
    return dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
                name_path=POTSDAM, ignore_residual=True, slide_stride=32, slide_crop=64,
                global_debias_factor=0.2, apply_sim_feat_up=True,
                sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=stages,
                                     model_path="weights/absent.ckpt"),
                apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
                apply_similarity_enhancement=True, prob_thd=0.1, bg_idx=5,
                clip_config=CFG, params=params, upsampler_params=up)


@pytest.mark.parametrize("stages", [2, 4])
def test_predict_raw_matches_jax(weights, stages, monkeypatch):
    img = np.random.RandomState(0).randint(0, 256, (1, 96, 128, 3), np.uint8)
    want = JaxSegmentorEx(**_kwargs(weights, stages)).predict_raw(img)[0]
    seg = SegmentorEx(**_kwargs(weights, stages), device="cpu")
    routes = []
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: routes.append(1) or "nhwc_classify")
    got = seg.predict_raw(img)[0]
    assert seg.param_dtype == torch.float32
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    assert probs.shape == (6, 96, 128) and pred.shape == (1, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999
    assert routes  # the forced route was taken

    # predict() on the normalised CHW image is the same computation
    norm = ((img[0].astype(np.float32) - PREPROC_MEAN) / PREPROC_STD).transpose(2, 0, 1)
    again = seg.predict(norm[None])[0]
    np.testing.assert_allclose(again["seg_logits"].numpy(), probs, atol=1e-5, rtol=0)


DECONTAM_CASES = {
    # eps 0.3 on the 4x4-patch crops gives clusters and noise in every chunk
    "ctd": dict(apply_ctd=True, ctd_cfg=dict(min_samples=3, eps=0.3)),
    "cross_tile-weighted": dict(apply_cross_tile_fusion=True),
    "cross_tile-attention": dict(apply_cross_tile_fusion=True, cross_tile_fusion_cfg=dict(
        fusion_mode="attention", cache_boundary_width=1, fusion_strength=0.5)),
    "som": dict(apply_som=True, som_cfg=dict(consensus_threshold=0.3)),
    "layer_fusion": dict(apply_layer_fusion=True, layer_fusion_lambda=0.6),
    "self_attn_enhancement": dict(apply_self_attn_enhancement=True,
                                  self_attn_enhancement_cfg=dict(top_k=3)),
    "suppression_layers": dict(outlier_suppression_cfg=dict(top_k=5,
                                                            suppression_layers=(1, -1))),
    "SegEarth": dict(model_type="SegEarth"),
    "ClearCLIP": dict(model_type="ClearCLIP", ignore_residual=False),
}


@pytest.mark.parametrize("case", list(DECONTAM_CASES), ids=list(DECONTAM_CASES))
def test_decontam_options_match_jax(weights, case):
    """Each option of the decontamination stack on top of the production
    recipe, on a 2x3 grid of crops: probs within 2e-3, argmax >= 0.999.
    SimFeatUp is off here (the route tests hold it); CTD still runs per
    chunk of crops in the port and on all crops at once in the JAX package."""
    img = np.random.RandomState(5).randint(0, 256, (1, 96, 128, 3), np.uint8)
    kw = {**_kwargs(weights, 2), "apply_sim_feat_up": False, **DECONTAM_CASES[case]}
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999


ITEM_8D_OPTIONS = [
    dict(clip_config=dataclasses.replace(CFG, vision=dataclasses.replace(CFG.vision,
                                                                         pool_type="avg"))),
    dict(sim_feat_up_cfg=dict(model_name="ifa"), upsampler_params=None),
    dict(sim_feat_up_cfg=dict(model_name="carafe"), upsampler_params=None),
    dict(clip_config=dataclasses.replace(CFG, vision=dataclasses.replace(CFG.vision,
                                                                         ls_init_value=1e-4)),
         params=None),
]


@pytest.mark.parametrize("option", [
    dict(clip_config=dataclasses.replace(CFG, vision=dataclasses.replace(
        CFG.vision, timm_model_name="vit_base_patch16_siglip_224"))),
    dict(clip_config=dataclasses.replace(CFG, text=dataclasses.replace(
        CFG.text, hf_model_name="roberta-base"))),
    dict(clip_config=dataclasses.replace(CFG, vision=dataclasses.replace(
        CFG.vision, attentional_pool=True))),
    dict(clip_config=dataclasses.replace(CFG, text=dataclasses.replace(
        CFG.text, embed_cls=True))),
])
def test_options_outside_the_slice_raise(weights, option):
    """A timm tower, which the segmentor refuses on purpose (its hooks are
    the CLIP ViT's; ROADMAP queue 3), raises. CoCa's fields (the HF text
    tower, the attentional pool, the text CLS; item 9, ported into
    ``nn.coca``) do not change the CLIP tree, which both packages build as
    without them: the port's probabilities equal the JAX package's (2e-3).
    Item 8d's options build since it was ported: test_item_8d_options_build."""
    kw = _kwargs(weights, 2)
    kw.update(option)
    if option["clip_config"].vision.timm_model_name:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
            SegmentorEx(**kw, device="cpu")
        return
    kw["apply_sim_feat_up"] = False
    img = np.random.RandomState(5).randint(0, 256, (1, 64, 64, 3), np.uint8)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    np.testing.assert_allclose(got["seg_logits"].numpy(), np.asarray(want["seg_logits"]),
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("option", ITEM_8D_OPTIONS,
                         ids=["avg-pool", "ifa", "carafe", "layerscale"])
def test_item_8d_options_build(weights, option):
    """An avg-pooled tower, the ifa and carafe upsamplers and LayerScale
    (random weights where the JAX tree has none) run a request."""
    kw = _kwargs(weights, 2)
    kw.update(option)
    img = np.random.RandomState(9).randint(0, 256, (1, 64, 96, 3), np.uint8)
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    assert got["seg_logits"].shape == (6, 64, 96)
    assert bool(torch.isfinite(got["seg_logits"]).all())


def test_without_a_card_the_device_must_be_named(weights, monkeypatch):
    """SegmentorEx runs on the card unless device="cpu" is passed; with no
    card it raises, and never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentorEx(**_kwargs(weights, 2))
    assert SegmentorEx(**_kwargs(weights, 2), device="cpu").device.type == "cpu"
