"""The port's SegmentorEx on the fused-range channel-last routes
(``RS_OV_JBU_FUSED_RANGE=1``: K5a in every JBU stage, K5b in the last stage
of the classify route) vs the JAX package's SegmentorEx, on the CPU in fp32
with the same weights: per-pixel class probabilities within 2e-3 and argmax
agreement >= 0.999 (tools/parity_check.py:72-85, :528-531).

On the CPU the port takes the channel-first route, and so does the JAX
package; the channel-last routes are forced here through the port's private
route selector, the fused switch through the environment."""

import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.params import init_clip_params
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample.jbu import init_jbu_one_params, init_jbu_stack_params
from rs_ov_torch.kernels import jbu_epilogue as epi
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.upsample import jbu

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


def _kwargs(weights, name, stages):
    """configs/base_config.py at crop 64 / stride 32, outlier top-k cut to
    the 16-patch grid."""
    params, ups = weights
    return dict(clip_type="CLIP", vit_type="ViT-B/16", model_type="Experimental",
                name_path=POTSDAM, ignore_residual=True, slide_stride=32, slide_crop=64,
                global_debias_factor=0.2, apply_sim_feat_up=True,
                sim_feat_up_cfg=dict(model_name=name, num_stages=stages,
                                     model_path="weights/absent.ckpt"),
                apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
                apply_similarity_enhancement=True, prob_thd=0.1, bg_idx=5,
                clip_config=CFG, params=params, upsampler_params=ups[name])


@pytest.mark.parametrize("route", ["nhwc_classify", "nhwc"])
@pytest.mark.parametrize("name,stages", [("jbu_one", 2), ("jbu_stack", 4)])
def test_fused_range_routes_match_jax(weights, monkeypatch, name, stages, route):
    """96x128 image, six crops in three chunks of two: K5a runs stages - 1
    times per chunk on the classify route (then K5b once) and stages times
    on the feature route."""
    img = np.random.RandomState(6).randint(0, 256, (1, 96, 128, 3), np.uint8)
    want = JaxSegmentorEx(**_kwargs(weights, name, stages)).predict_raw(img)[0]
    seg = SegmentorEx(**_kwargs(weights, name, stages), device="cpu")
    monkeypatch.setattr(seg, "_jbu_route", lambda tokens: route)
    monkeypatch.setenv("RS_OV_JBU_FUSED_RANGE", "1")
    calls = []
    for fn in ("jbu_epilogue_fused", "jbu_epilogue_fused_classify", "jbu_epilogue",
               "jbu_epilogue_classify"):
        monkeypatch.setattr(jbu, fn, lambda *a, n=fn, f=getattr(epi, fn): calls.append(n) or f(*a))
    got = seg.predict_raw(img)[0]
    fused_stages = stages - 1 if route == "nhwc_classify" else stages
    assert calls.count("jbu_epilogue_fused") == 3 * fused_stages
    assert calls.count("jbu_epilogue_fused_classify") == (3 if route == "nhwc_classify" else 0)
    assert len(calls) == 3 * stages  # neither split epilogue ran
    probs, pred = got["seg_logits"].numpy(), got["pred_sem_seg"].numpy()
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(pred == np.asarray(want["pred_sem_seg"])) >= 0.999
