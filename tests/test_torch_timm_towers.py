"""The timm towers on the port (rs_ov_torch.nn.timm_tower: ConvNeXt, the
SigLIP MAP-head ViT, EVA / EVA02) against the JAX package, on the CPU in
fp32, through the open_clip entry (create_model -> CLIPModel.encode_image /
encode_text). Tiny archs are registered under test names in both packages'
TIMM_ARCHS and registries. Every floating leaf of the JAX init's tree is
drawn anew from a seeded numpy RandomState (``draw``), and the same tree
goes to both packages: with the init's zero biases, zero CLS token and
ConvNeXt's 1e-6 gammas a tower that dropped a bias or a whole block would
still match. Bound: max|d|/max|ref|
<= 1e-5 on the image and text embeddings and the logits (the tolerance of
tools/parity_check.py:72-85 for a tower output)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov import factory as jax_factory
from rs_ov.core import config as jax_config
from rs_ov.core.params import init_text_params as jax_init_text_params
from rs_ov.nn import timm_tower as jax_tt
from rs_ov_torch import factory
from rs_ov_torch.core import config
from rs_ov_torch.core.params import CLIP, clip_params_from_numpy
from rs_ov_torch.nn import timm_tower as tt

torch.set_num_threads(1)

TOL = 1e-5
TEXT = config.TextConfig(context_length=16, vocab_size=97, width=32, heads=2, layers=1,
                         output_dim=16)


def draw(shapes, seed: int):
    """A numpy tree with the shapes of ``shapes`` (a tree of arrays or of
    jax.ShapeDtypeStructs), every array drawn from a seeded RandomState:
    LayerNorm scales near 1, ConvNeXt gammas near 0.5, biases and the CLS
    token N(0, 0.02), other arrays N(0, 1 / sqrt(last dim)); scalars (logit
    scale and bias) are taken as they are where given, else 0."""
    rng = np.random.RandomState(seed)

    def leaf(key, v):
        shape = tuple(v.shape)
        if not shape:
            return np.float32(v) if isinstance(v, (np.ndarray, np.generic)) else np.float32(0)
        if key == "scale":
            new = 1.0 + 0.1 * rng.randn(*shape)
        elif key == "gamma":
            new = 0.5 + 0.1 * rng.randn(*shape)
        elif key in ("bias", "cls_token") or key.endswith("_b"):
            new = 0.02 * rng.randn(*shape)
        else:
            new = shape[-1] ** -0.5 * rng.randn(*shape)
        return new.astype(np.float32)

    def walk(key, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(key, v) for v in node]
        return None if node is None else leaf(key, node)

    return walk("", shapes)


def jax_init_shapes(cfg):
    """The JAX create_model's random-init tree for a timm-towered ``cfg``
    (rs_ov/factory.py:220-237) as ShapeDtypeStructs: traced, not run."""
    def init(key):
        kv, kt = jax.random.split(key)
        tree = {"visual": jax_tt.init_timm_tower_params(kv, cfg.vision, cfg.embed_dim),
                "text": jax_init_text_params(kt, cfg.text), "logit_scale": jnp.zeros(())}
        if cfg.init_logit_bias is not None:
            tree["logit_bias"] = jnp.zeros(())
        return tree

    return jax.eval_shape(init, jax.random.PRNGKey(0))


def jax_tree(cfg, seed=0):
    """A drawn numpy tree of the JAX init's layout, logit scale and bias at
    the init's values."""
    tree = draw(jax_init_shapes(cfg), seed)
    tree["logit_scale"] = np.float32(np.log(1 / 0.07))
    if cfg.init_logit_bias is not None:
        tree["logit_bias"] = np.float32(cfg.init_logit_bias)
    return tree


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def timm_cfg(name, image_size, pool="", proj=None, embed=16, logit_bias=None):
    return config.CLIPConfig(
        embed_dim=embed,
        vision=config.VisionConfig(image_size=image_size, output_dim=embed,
                                   timm_model_name=name, timm_pool=pool, timm_proj=proj),
        text=dataclasses.replace(TEXT, output_dim=embed), custom_text=True,
        init_logit_bias=logit_bias)


def register(monkeypatch, name, arch, cfg):
    """``arch`` under ``name`` in both TIMM_ARCHS (each package's own
    dataclass) and ``cfg`` under ``name`` in both registries."""
    monkeypatch.setitem(tt.TIMM_ARCHS, name, arch)
    monkeypatch.setitem(jax_tt.TIMM_ARCHS, name, getattr(jax_tt, type(arch).__name__)(
        **dataclasses.asdict(arch)))
    monkeypatch.setitem(config._MODEL_CONFIGS, name, cfg)
    monkeypatch.setitem(jax_config._MODEL_CONFIGS, name, cfg)


def pair(name, seed=0):
    """The JAX CLIPModel for a registered ``name`` on a drawn tree, and the
    port's on the same tree."""
    cfg = config.get_model_config(name)
    tree = jax_tree(cfg, seed)
    jm = jax_factory.CLIPModel(cfg=cfg, params=jax.tree_util.tree_map(jnp.asarray, tree))
    return factory.CLIPModel(cfg, clip_params_from_numpy(tree, cfg)).eval(), jm


def text_ids(cfg, seed=1, n=3):
    ids = np.random.RandomState(seed).randint(1, cfg.text.vocab_size - 1,
                                              (n, cfg.text.context_length))
    ids[:, -3] = cfg.text.vocab_size - 1
    return ids.astype(np.int32)


def _logits(image, text, scale, bias):
    img = image / np.linalg.norm(image, axis=-1, keepdims=True)
    return scale * img @ text.T + bias


def assert_agree(tm, jm, images, ids):
    """encode_image, normalised encode_text and the logits, each within TOL."""
    got_i, want_i = tm.encode_image(images).numpy(), np.asarray(jm.encode_image(images))
    got_t = tm.encode_text(ids, normalize=True).numpy()
    want_t = np.asarray(jm.encode_text(ids, normalize=True))
    bias = float(tm.clip.logit_bias) if hasattr(tm.clip, "logit_bias") else 0.0
    jbias = float(jm.params.get("logit_bias", 0.0))
    errs = {"image": rel(got_i, want_i), "text": rel(got_t, want_t),
            "logits": rel(_logits(got_i, got_t, float(tm.logit_scale), bias),
                          _logits(want_i, want_t, float(jm.logit_scale), jbias))}
    assert max(errs.values()) <= TOL, errs
    return got_i


def _images(shape, seed=2):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CONVNEXT = tt.ConvNeXtArch((1, 1, 2, 1), (8, 12, 16, 24))
SIGLIP = tt.SigLipVitArch(patch=8, width=32, depth=2, heads=2)
# the flag sets of tests/test_eva_oracle.py:164-214
EVA_FLAGS = {
    "giant": dict(mlp_hidden=48),
    "eva02": dict(mlp_hidden=40, swiglu=True, rope=True, scale_mlp=True,
                  scale_attn_inner=True, fused_qkv=False, ref_feat_hw=(16, 16)),
    "eva02-no-ref-grid": dict(mlp_hidden=40, swiglu=True, rope=True, scale_mlp=True,
                              scale_attn_inner=True, fused_qkv=False),
    "post-norm": dict(mlp_hidden=48, post_norm=True),
    "rope-fused-qkv": dict(mlp_hidden=48, rope=True, ref_feat_hw=(4, 4)),
    "swiglu-no-inner-norms": dict(mlp_hidden=40, swiglu=True, fused_qkv=False),
}


def _eva(flags, patch=8, depth=2):
    return tt.EvaArch(patch=patch, width=32, depth=depth, heads=4, **EVA_FLAGS[flags])


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_convnext_matches_jax(proj, monkeypatch):
    """ConvNeXt (stem, downsamples, depthwise blocks, gammas, head norm) with
    the 'linear' (bias-free) and 'mlp' heads."""
    register(monkeypatch, "tiny-convnext", CONVNEXT, timm_cfg("tiny-convnext", 64, proj=proj))
    tm, jm = pair("tiny-convnext")
    assert hasattr(tm.clip.visual, "head") and not hasattr(tm.clip.visual.head, "proj_b")
    out = assert_agree(tm, jm, _images((2, 3, 64, 64)), text_ids(tm.cfg))
    assert out.shape == (2, 16)


@pytest.mark.parametrize("hw", [(32, 32), (48, 48), (32, 48)], ids=["native", "48", "32x48"])
def test_siglip_matches_jax(hw, monkeypatch):
    """The SigLIP MAP-head tower (no head of open_clip's, logit_bias) at its
    own grid and, through the pos-embed resample, at a larger and a
    non-square one."""
    register(monkeypatch, "tiny-siglip", SIGLIP,
             timm_cfg("tiny-siglip", 32, pool="map", proj="none", embed=32,
                      logit_bias=-10.0))
    tm, jm = pair("tiny-siglip")
    assert not hasattr(tm.clip.visual, "head")
    assert float(tm.clip.logit_bias) == float(jm.params["logit_bias"])
    assert_agree(tm, jm, _images((2, 3) + hw), text_ids(tm.cfg))


@pytest.mark.parametrize("flags", list(EVA_FLAGS))
def test_eva_flags_match_jax(flags, monkeypatch):
    """Each EVA flag combination (fused or split qkv, RoPE with and without a
    reference grid, SwiGLU, inner norms, post-norm), the trunk's own head."""
    register(monkeypatch, "tiny-eva", _eva(flags), timm_cfg("tiny-eva", 32, pool="token"))
    tm, jm = pair("tiny-eva")
    assert_agree(tm, jm, _images((2, 3, 32, 32)), text_ids(tm.cfg))


@pytest.mark.parametrize("case", ["336-grid", "non-square"])
def test_eva02_rope_grids_match_jax(case, monkeypatch):
    """EVA02's RoPE rescaled to its 16x16 reference grid from EVA02-L-14-336's
    24x24 grid (patch 14 at 336²), and on a non-square 4x6 grid reached
    through the pos-embed resample."""
    patch, size, hw = (14, 336, (336, 336)) if case == "336-grid" else (8, 32, (32, 48))
    register(monkeypatch, "tiny-eva02", _eva("eva02", patch=patch, depth=1),
             timm_cfg("tiny-eva02", size, pool="token"))
    tm, jm = pair("tiny-eva02")
    assert_agree(tm, jm, _images((1, 3) + hw), text_ids(tm.cfg, n=2))


def test_rope_tables_equal_jax():
    for gh, gw, ref in [(24, 24, (16, 16)), (4, 6, (16, 16)), (3, 5, None), (14, 14, (16, 16))]:
        for got, want in zip(tt._rope_tables(8, gh, gw, ref),
                             jax_tt._rope_tables(8, gh, gw, ref)):
            np.testing.assert_array_equal(got, want)


def test_force_image_size_builds_at_the_forced_grid(monkeypatch):
    """create_model(force_image_size=48) draws the pos-embed at the forced
    grid, as the JAX package does, and encodes a 48² image."""
    register(monkeypatch, "tiny-siglip", SIGLIP,
             timm_cfg("tiny-siglip", 32, pool="map", proj="none", embed=32,
                      logit_bias=-10.0))
    register(monkeypatch, "tiny-eva", _eva("eva02"), timm_cfg("tiny-eva", 32, pool="token"))
    for name, extra in (("tiny-siglip", 0), ("tiny-eva", 1)):
        m = factory.create_model(name, device="cpu", force_image_size=48)
        jm = jax.eval_shape(lambda: jax_factory.create_model(name, force_image_size=48).params)
        assert m.cfg.vision.image_size == 48
        assert tuple(m.clip.visual.trunk.pos_embed.shape) == \
            tuple(jm["visual"]["trunk"]["pos_embed"].shape) == (36 + extra, 32)
        assert m.encode_image(_images((1, 3, 48, 48))).shape == (1, m.cfg.embed_dim)


def test_encode_image_refuses_the_vit_hooks(monkeypatch):
    """A timm tower gives the pooled embedding only; every hook of the ViT
    path raises NotImplementedError, as in the JAX package."""
    register(monkeypatch, "tiny-eva", _eva("giant"), timm_cfg("tiny-eva", 32, pool="token"))
    tm, jm = pair("tiny-eva")
    img = _images((1, 3, 32, 32))
    for kw in (dict(model_type="ClearCLIP"), dict(ignore_residual=True),
               dict(output_cls_token=True), dict(apply_outlier_suppression=True)):
        with pytest.raises(NotImplementedError, match="decontamination"):
            tm.encode_image(img, **kw)
        with pytest.raises(NotImplementedError, match="decontamination"):
            jm.encode_image(img, **kw)
    out = tm.encode_image(img, model_type="default", normalize=True)
    np.testing.assert_allclose(float(out.norm()), 1.0, rtol=1e-6)


@pytest.mark.parametrize("family,leaf", [
    ("convnext", "gamma"), ("siglip", "attn_pool.proj_b"), ("eva", "q_b"),
    ("eva", "patch_embed_b")])
def test_drawn_leaves_make_a_dropped_leaf_visible(family, leaf, monkeypatch):
    """On the drawn tree, a tower that left out a gamma or a bias lands
    above the bound (with the init's values it would not)."""
    cases = {"convnext": (CONVNEXT, timm_cfg("t", 64, proj="linear"), 64),
             "siglip": (SIGLIP, timm_cfg("t", 32, pool="map", proj="none", embed=32), 32),
             "eva": (_eva("eva02"), timm_cfg("t", 32, pool="token"), 32)}
    arch, cfg, size = cases[family]
    register(monkeypatch, "t", arch, cfg)
    tm, _ = pair("t")
    img = _images((2, 3, size, size))
    ref = tm.encode_image(img).numpy()
    with torch.no_grad():
        for name, p in tm.clip.visual.named_parameters():
            if name.endswith(leaf):
                p.fill_(1.0 if leaf == "gamma" else 0.0)
    assert rel(tm.encode_image(img).numpy(), ref) > 10 * TOL


def _jax_shapes(cfg):
    """Leaf shapes of the JAX init for ``cfg``, ConvNeXt's convs as OIHW."""
    flat = jax.tree_util.tree_flatten_with_path(jax_init_shapes(cfg))[0]
    out = {}
    for path, v in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        shape = tuple(v.shape)
        if key.endswith(("stem_conv_w", ".conv_w", "conv_dw_w")):  # HWIO -> OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        out[key] = shape
    return out


TIMM_NAMES = [n for n in config.list_models() if n not in config.COCA_MODELS
              and config.get_model_config(n).vision.timm_model_name]


def test_registry_has_the_25_timm_names():
    assert len(TIMM_NAMES) == 25
    assert len([n for n in config.list_models() if n not in config.COCA_MODELS]) == 56


@pytest.mark.parametrize("name", ["convnext_large_d", "ViT-B-16-SigLIP", "EVA02-B-16",
                                  "EVA02-L-14-336", "EVA01-g-14"])
def test_registry_towers_have_the_jax_shapes(name):
    """The port's CLIP for a registry name of each family (on the meta
    device) holds the JAX init's leaves, ConvNeXt's convs as OIHW."""
    cfg = config.get_model_config(name)
    with torch.device("meta"):
        model = CLIP(cfg)
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == _jax_shapes(cfg)


def test_every_registry_name_builds_through_create_model(monkeypatch):
    """All 60 names build through create_model: the 56 CLIP ones as CLIP
    models, the 4 CoCa ones as CoCa models; the random draw is replaced by
    a meta-device build, so EVA02-E-14's 4.4 B parameters take no memory."""
    def meta_init(gen, cfg):
        with torch.device("meta"):
            return CLIP(cfg)

    def meta_coca(gen, cfg):
        with torch.device("meta"):
            return factory.CoCa(cfg)

    monkeypatch.setattr(factory, "init_clip_params", meta_init)
    monkeypatch.setattr(factory, "init_coca_params", meta_coca)
    for name in config.list_models():
        if name in config.COCA_MODELS:
            m = factory.create_model(name, device="meta")
            assert isinstance(m, factory.CoCaModel) and m.cfg == config.get_model_config(name)
            continue
        m = factory.create_model(name, device="meta")
        assert hasattr(m.clip.visual, "trunk") == bool(m.cfg.vision.timm_model_name), name
        assert hasattr(m.clip, "logit_bias") == (m.cfg.init_logit_bias is not None), name


def test_chip_smoke_phase_timm_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 8 at tiny widths on the CPU: the three registry
    names resolve to tiny configs of their own archs' families, the card is
    the CPU, CUDA timing is stubbed. Its gates pass and each planted fault
    lands above the bound."""
    import chip_smoke as cs

    bpe = dataclasses.replace(TEXT, vocab_size=49408, context_length=77)
    tiny = {"convnext_large_d": (CONVNEXT, dataclasses.replace(
                timm_cfg("convnext_large", 64, proj="mlp"), text=bpe)),
            "ViT-B-16-SigLIP": (SIGLIP, dataclasses.replace(
                timm_cfg("vit_base_patch16_siglip_224", 32, pool="map", proj="none", embed=32,
                         logit_bias=-10.0),
                text=dataclasses.replace(TEXT, output_dim=32, pool_type="last",
                                         no_causal_mask=True, proj_bias=True, norm_eps=1e-6,
                                         hf_tokenizer_name="timm/ViT-B-16-SigLIP"))),
            "EVA02-B-16": (_eva("eva02"), dataclasses.replace(
                timm_cfg("eva02_base_patch16_clip_224", 32, pool="token"), text=bpe))}
    for name, (arch, cfg) in tiny.items():
        monkeypatch.setitem(tt.TIMM_ARCHS, cfg.vision.timm_model_name, arch)
        monkeypatch.setitem(config._MODEL_CONFIGS, name, cfg)
    real_resolve = factory.resolve_device
    monkeypatch.setattr(factory, "resolve_device",
                        lambda device=None: real_resolve("cpu" if device is None else device))
    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "ENTRY_TIMED_BATCH", 4)
    monkeypatch.setattr(cs, "_median_ms", lambda fn, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setitem(cs.CARD, "smi", "CPU rehearsal")
    cs.phase_timm()
    assert tt.TIMM_ARCHS["eva02_base_patch16_clip_224"].rope  # the fault was undone


@pytest.mark.parametrize("family", ["convnext", "siglip", "eva"])
def test_init_follows_the_jax_distributions(family, monkeypatch):
    """init_timm_tower_params draws as the JAX init does (in distribution,
    not in bits): LayerNorms identity, biases and the CLS token zero,
    ConvNeXt's gammas 1e-6, the rest N(0, 0.02); the JAX leaf shapes."""
    from rs_ov_torch.core.params import init_timm_tower_params

    arch, cfg = {"convnext": (CONVNEXT, timm_cfg("t", 64, proj="mlp")),
                 "siglip": (SIGLIP, timm_cfg("t", 32, pool="map", proj="none", embed=32)),
                 "eva": (_eva("eva02"), timm_cfg("t", 32, pool="token"))}[family]
    register(monkeypatch, "t", arch, cfg)
    m = init_timm_tower_params(torch.Generator().manual_seed(0), cfg.vision, cfg.embed_dim)
    want = {k[len("visual."):]: v for k, v in _jax_shapes(cfg).items()
            if k.startswith("visual.")}
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == want
    drawn = []
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            assert bool((p == 1).all()), name
        elif leaf == "gamma":
            assert bool((p == 1e-6).all()), name
        elif leaf in ("bias", "cls_token") or leaf.endswith("_b"):
            assert bool((p == 0).all()), name
        else:
            drawn.append(p.reshape(-1))
    np.testing.assert_allclose(float(torch.cat(drawn).std()), 0.02, rtol=0.05)
