"""The other CLIP towers: the port's arch resolution and tower registry
against the JAX package's, and the whole slice on the CPU in fp32 with a
clip_type other than CLIP (tools/parity_check.py:72-85 tolerances)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from rs_ov.core import params as jax_params
from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.core.config import get_model_config as jax_model_config
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.pipeline.segmentor import _resolve_arch as jax_resolve_arch
from rs_ov.upsample.jbu import init_jbu_one_params
from rs_ov_torch.core.config import get_model_config
from rs_ov_torch.core.params import CLIP
from rs_ov_torch.pipeline.segmentor import SegmentorEx, _resolve_arch

torch.set_num_threads(1)

CLIP_TYPES = ("CLIP", "RemoteCLIP", "GeoRSCLIP", "SkyCLIP", "OpenCLIP", "MetaCLIP", "ALIP",
              "BLIP", "EVA-CLIP")
VIT_TYPES = ("ViT-B/16", "ViT-B/32", "ViT-L/14", "ViT-H/14")
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except NotImplementedError as e:
        return "NotImplementedError", str(e)


@pytest.mark.parametrize("clip_type,vit_type", [(c, v) for c in CLIP_TYPES for v in VIT_TYPES])
def test_resolve_arch_matches_jax(clip_type, vit_type):
    """Every (clip_type, vit_type) pair resolves to the JAX package's arch, or
    raises NotImplementedError with its message (BLIP takes its own branch,
    an unknown type is refused)."""
    assert _outcome(_resolve_arch, clip_type, vit_type) == _outcome(
        jax_resolve_arch, clip_type, vit_type)


ARCHS = sorted({jax_resolve_arch(c, v) for c in CLIP_TYPES[:7] for v in VIT_TYPES})


@pytest.mark.parametrize("arch", ARCHS)
def test_every_resolved_arch_builds(arch):
    """Each arch _resolve_arch returns has the JAX package's config in the
    port's registry, and the port's CLIP builds it (on the meta device, no
    memory) with the JAX init's leaf shapes."""
    cfg = get_model_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_model_config(arch))
    with torch.device("meta"):
        model = CLIP(cfg)
    shapes = jax.eval_shape(lambda k: jax_params._init_clip_params_impl(k, cfg, "float32"),
                            jax.random.PRNGKey(0))
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == flat
    assert model.visual.blocks[0].attn.in_proj_w.shape[1] // cfg.vision.heads == \
        cfg.vision.head_width


def test_item_8d_towers_still_raise():
    """Item 8d's towers build since it was ported (pool_type, LayerScale);
    what it left to item 8e, the timm towers, is refused with that item
    named."""
    base = get_model_config("ViT-B-16")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8e"):
        CLIP(dataclasses.replace(base, vision=dataclasses.replace(
            base.vision, timm_model_name="vit_base_patch16_224")))
    with torch.device("meta"):
        for vision in (dataclasses.replace(base.vision, pool_type="avg"),
                       get_model_config("ViT-M-16-alt").vision):
            CLIP(dataclasses.replace(base, vision=vision))


# the tiny arch of tools/parity_check.py:68-70; quick_gelu on, so that a
# segmentor that ignored the config's activation in either tower would miss
TINY = CLIPConfig(
    embed_dim=32,
    vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4, output_dim=32,
                        head_width=32),
    text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2, layers=2,
                    output_dim=32),
    quick_gelu=True)


def test_remoteclip_slice_matches_jax():
    """SegmentorEx with clip_type="RemoteCLIP" on a tiny clip_config, SimFeatUp
    on (jbu_one, 2 stages), the text classifier built by each package from
    its own text tower: probabilities within 2e-3, argmax agreement >= 0.999."""
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kw = dict(clip_type="RemoteCLIP", vit_type="ViT-B/32", model_type="Experimental",
              name_path=POTSDAM, slide_stride=32, slide_crop=64, global_debias_factor=0.2,
              apply_sim_feat_up=True, apply_outlier_suppression=True,
              outlier_suppression_cfg=dict(top_k=5), apply_similarity_enhancement=True,
              prob_thd=0.1, bg_idx=5, clip_config=TINY,
              params=to_np(jax_params.init_clip_params(jax.random.PRNGKey(0), TINY)),
              upsampler_params=to_np(init_jbu_one_params(jax.random.PRNGKey(1), 32)))
    img = np.random.RandomState(0).randint(0, 256, (1, 96, 128, 3), np.uint8)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    got = SegmentorEx(**kw, device="cpu").predict_raw(img)[0]
    probs = got["seg_logits"].numpy()
    assert probs.shape == (6, 96, 128)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=2e-3, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999
