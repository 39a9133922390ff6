"""The port's SegmentorEx (the production recipe on a tiny arch) vs the JAX
package's, on the CPU in fp32, with the same weights: per-pixel class
probabilities within 2e-3 and argmax agreement >= 0.999
(tools/parity_check.py:72-85, :528-531)."""

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
def test_predict_raw_matches_jax(weights, stages):
    img = np.random.RandomState(0).randint(0, 256, (1, 96, 128, 3), np.uint8)
    want = JaxSegmentorEx(**_kwargs(weights, stages)).predict_raw(img)[0]
    seg = SegmentorEx(**_kwargs(weights, stages), device="cpu")
    got = seg.predict_raw(img)[0]
    assert seg.param_dtype == torch.float32
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    assert probs.shape == (6, 96, 128) and pred.shape == (1, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999

    # predict() on the normalised CHW image is the same computation
    norm = ((img[0].astype(np.float32) - PREPROC_MEAN) / PREPROC_STD).transpose(2, 0, 1)
    again = seg.predict(norm[None])[0]
    np.testing.assert_allclose(again["seg_logits"].numpy(), probs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", [
    dict(apply_ctd=True), dict(apply_som=True), dict(apply_layer_fusion=True),
    dict(apply_self_attn_enhancement=True), dict(apply_cross_tile_fusion=True),
    dict(model_type="SCLIP"), dict(clip_type="BLIP"), dict(apply_sim_feat_up=False),
    dict(cls_token_lambda=0.3), dict(checkpoint_path="ViT-B-16.pt"),
    dict(sim_feat_up_cfg=dict(model_name="jbu_stack")),
])
def test_options_outside_the_slice_raise(weights, option):
    kw = _kwargs(weights, 2)
    kw.update(option)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        SegmentorEx(**kw, device="cpu")
