"""The alternate SimFeatUp upsamplers on the port against the JAX package,
on the CPU in fp32 with the same weights: resize_conv, carafe (and its
reassembly op), sapa (and its window ops) and ifa within
tools/parity_check.py:72-85's jbu_feats 2e-3, their init shapes and
scales, the registry, and SegmentorEx with one of them against the JAX
segmentor (logits 2e-3 on the probabilities, argmax agreement >= 0.999)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.core import params as jax_params
from rs_ov.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov.pipeline.segmentor import SegmentorEx as JaxSegmentorEx
from rs_ov.upsample import alternates as jax_alt
from rs_ov.upsample.jbu import get_upsampler as jax_get_upsampler
from rs_ov_torch.core.params import load_numpy_tree
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.upsample import alternates
from rs_ov_torch.upsample.jbu import get_upsampler

torch.set_num_threads(1)

FEATS_TOL, LOGITS_TOL = 2e-3, 2e-3
NAMES = ("resize_conv", "carafe", "sapa", "ifa")
POTSDAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "cls_potsdam.txt")


def _pair(name, dim=24, seed=0):
    """JAX init weights as numpy, and the port's module holding them."""
    tree = jax.tree_util.tree_map(np.asarray, getattr(jax_alt, f"init_{name}_params")(
        jax.random.PRNGKey(seed), dim))
    if name == "ifa":  # a BatchNorm with statistics, not the identity
        rng = np.random.RandomState(seed)
        tree["bn"] = {k: rng.uniform(0.5, 1.5, dim).astype(np.float32) for k in tree["bn"]}
    mod = getattr(alternates, f"init_{name}_params")(torch.Generator().manual_seed(seed), dim)
    return tree, load_numpy_tree(mod, tree)


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)], ids=["4x4", "3x5"])
@pytest.mark.parametrize("name", NAMES)
def test_alternate_matches_jax(name, hw):
    """Each upsampler's full forward (IFA one 2x step, the others four) on a
    square and a non-square source grid (IFA: the square one, which the JAX
    coordinate grid assumes)."""
    if name == "ifa" and hw[0] != hw[1]:
        hw = (5, 5)
    tree, mod = _pair(name)
    rng = np.random.RandomState(1)
    src = rng.randn(2, 24, *hw).astype(np.float32)
    guide = rng.randn(2, 3, hw[0] * 16, hw[1] * 16).astype(np.float32)
    fwd, _ = jax_get_upsampler(name)
    want = np.asarray(jax.jit(fwd)(tree, jnp.asarray(src), jnp.asarray(guide)))
    tfwd, tinit = get_upsampler(name)
    with torch.no_grad():
        got = tfwd(mod, torch.from_numpy(src), torch.from_numpy(guide)).numpy()
    scale = 2 if name == "ifa" else 16
    assert got.shape == want.shape == (2, 24, hw[0] * scale, hw[1] * scale)
    np.testing.assert_allclose(got, want, atol=FEATS_TOL * max(1.0, np.abs(want).max()), rtol=0)
    assert isinstance(tinit(torch.Generator(), 24), torch.nn.Module)


def test_window_ops_match_jax():
    """CARAFE's reassembly and SAPA's sim / atn ops alone, zero outside the
    source grid."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 3, 4).astype(np.float32)
    masks = rng.rand(2, 25, 6, 8).astype(np.float32)
    np.testing.assert_allclose(
        alternates.carafe_reassemble(torch.from_numpy(x), torch.from_numpy(masks), 2, 5).numpy(),
        np.asarray(jax_alt.carafe_reassemble(jnp.asarray(x), jnp.asarray(masks), 2, 5)),
        atol=1e-5, rtol=0)
    q = rng.randn(2, 6, 8, 7).astype(np.float32)
    k = rng.randn(2, 3, 4, 7).astype(np.float32)
    np.testing.assert_allclose(
        alternates.sapa_sim(torch.from_numpy(q), torch.from_numpy(k), 3, 2).numpy(),
        np.asarray(jax_alt.sapa_sim(jnp.asarray(q), jnp.asarray(k), 3, 2)), atol=1e-5, rtol=0)
    attn = rng.rand(2, 6, 8, 9).astype(np.float32)
    v = rng.randn(2, 3, 4, 5).astype(np.float32)
    np.testing.assert_allclose(
        alternates.sapa_atn(torch.from_numpy(attn), torch.from_numpy(v), 3, 2).numpy(),
        np.asarray(jax_alt.sapa_atn(jnp.asarray(attn), jnp.asarray(v), 3, 2)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_jax_shapes_and_scales(name):
    """The port's init draws the JAX init's leaves: the same names and
    shapes, the constant leaves equal, the random ones at the JAX scale
    (SAPA's cut at two standard deviations)."""
    dim = 64
    tree = jax.tree_util.tree_map(np.asarray, getattr(jax_alt, f"init_{name}_params")(
        jax.random.PRNGKey(0), dim))
    mod = getattr(alternates, f"init_{name}_params")(torch.Generator().manual_seed(0), dim)
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ours = {k: v.detach().numpy() for k, v in mod.named_parameters()}
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in flat.items()}
    for k, want in flat.items():
        got = ours[k]
        if np.all(want == want.reshape(-1)[0]):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert got.std() == pytest.approx(want.std(), rel=0.15), k
            if name == "sapa":
                assert np.abs(got).max() <= 0.04 + 1e-7, k


def test_segmentor_with_an_alternate_matches_jax(tmp_path):
    """SegmentorEx with sim_feat_up_cfg={"model_name": "carafe"} (random
    init, weights crossed from the JAX run) on a tiny tower against the JAX
    segmentor; a model_path for an alternate is refused with ValueError in
    both."""
    cfg = CLIPConfig(embed_dim=32,
                     vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=4,
                                         output_dim=32, head_width=32),
                     text=TextConfig(context_length=77, vocab_size=49408, width=48, heads=2,
                                     layers=2, output_dim=32))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kw = dict(model_type="ClearCLIP", name_path=POTSDAM, slide_stride=32, slide_crop=64,
              apply_sim_feat_up=True, sim_feat_up_cfg={"model_name": "carafe"},
              clip_config=cfg,
              params=to_np(jax_params.init_clip_params(jax.random.PRNGKey(0), cfg)),
              upsampler_params=to_np(jax_alt.init_carafe_params(jax.random.PRNGKey(1), 32)))
    img = np.random.RandomState(0).randint(0, 256, (1, 80, 96, 3), np.uint8)
    want = JaxSegmentorEx(**kw).predict_raw(img)[0]
    seg = SegmentorEx(**kw, device="cpu")
    assert isinstance(seg.upsampler, alternates.Carafe)
    got = seg.predict_raw(img)[0]
    probs = got["seg_logits"].numpy()
    assert probs.shape == (6, 80, 96)
    np.testing.assert_allclose(probs, np.asarray(want["seg_logits"]), atol=LOGITS_TOL, rtol=0)
    assert np.mean(got["pred_sem_seg"].numpy() == np.asarray(want["pred_sem_seg"])) >= 0.999

    path = str(tmp_path / "upsampler.pth")
    torch.save({"upsampler.stages.0.comp_w": torch.zeros(1)}, path)
    bad = dict(kw, upsampler_params=None, sim_feat_up_cfg={"model_name": "sapa",
                                                            "model_path": path})
    for make in (lambda: SegmentorEx(**bad, device="cpu"), lambda: JaxSegmentorEx(**bad)):
        with pytest.raises(ValueError, match="Unknown SimFeatUp model 'sapa'"):
            make()
