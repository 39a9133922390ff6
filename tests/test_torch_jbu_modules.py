"""The port's channel-first JBU modules (and the channel-last ``jbu_stack``
forms) against rs_ov/upsample/jbu.py on the CPU in fp32, with the same
weights (the JAX init, carried across by the weight bridge) and the same
numpy inputs: max|d| / max|ref| <= 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.upsample import jbu as jjbu
from rs_ov_torch.core.params import (JBUOne, JBUStack, init_jbu_stack_params,
                                     jbu_params_from_numpy, load_numpy_tree)
from rs_ov_torch.upsample import alternates, jbu

torch.set_num_threads(1)

C = 8


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _weights(name, seed=1):
    init = jjbu.init_jbu_one_params if name == "jbu_one" else jjbu.init_jbu_stack_params
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), C))
    return tree, jbu_params_from_numpy(tree, C)


def _inputs(b, hw, ghw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, C, *hw).astype(np.float32),
            rng.randn(b, 3, *ghw).astype(np.float32))


def test_unfold_matches_jax():
    x = np.random.RandomState(3).randn(2, 3, 7, 8).astype(np.float32)
    np.testing.assert_array_equal(jbu.unfold(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jjbu.unfold(jnp.asarray(x), 3)))


@pytest.mark.parametrize("d", [5, 7, 11])
def test_adaptive_conv_matches_jax(d):
    rng = np.random.RandomState(d)
    inp = rng.randn(2, 6, 9 + d - 1, 10 + d - 1).astype(np.float32)
    filt = rng.randn(2, 9, 10, d, d).astype(np.float32)
    ref = jjbu.adaptive_conv(jnp.asarray(inp), jnp.asarray(filt))
    got = jbu.adaptive_conv(torch.from_numpy(inp), torch.from_numpy(filt))
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("name,radius", [("jbu_one", 5), ("jbu_stack", 3)])
def test_jbu_module_forward_matches_jax(name, radius):
    tree, mod = _weights(name)
    jp, tp = (tree["up"], mod.up) if name == "jbu_one" else (tree["ups"][2], mod.ups[2])
    src, guid = _inputs(2, (6, 7), (12, 14))
    ref = jjbu.jbu_module_forward(jp, jnp.asarray(src), jnp.asarray(guid), radius)
    got = jbu.jbu_module_forward(tp, torch.from_numpy(src), torch.from_numpy(guid), radius)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_jbu_one_forward_matches_jax(stages):
    tree, mod = _weights("jbu_one")
    src, guid = _inputs(1, (4, 5), (64, 80), seed=1)
    ref = jjbu.jbu_one_forward(tree, jnp.asarray(src), jnp.asarray(guid), stages=stages)
    got = jbu.jbu_one_forward(mod, torch.from_numpy(src), torch.from_numpy(guid), stages=stages)
    assert got.shape == (1, C, 4 << stages, 5 << stages)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_jbu_stack_forward_matches_jax(stages):
    tree, mod = _weights("jbu_stack")
    src, guid = _inputs(1, (4, 5), (64, 80), seed=2)
    ref = jjbu.jbu_stack_forward(tree, jnp.asarray(src), jnp.asarray(guid), stages=stages)
    got = jbu.jbu_stack_forward(mod, torch.from_numpy(src), torch.from_numpy(guid),
                                stages=stages)
    assert _rel(got.numpy(), ref) <= 1e-5


def _nhwc_ref(name, tree, src, guid, stages, qf=None):
    """The JAX channel-last form, built from the JAX channel-first module step
    (the JAX NHWC step runs only on a TPU or in Pallas interpret mode): the
    same stages, the same module per stage, the final fixup in fp32."""
    x = jnp.asarray(src)
    ups = [tree["up"]] * 4 if name == "jbu_one" else tree["ups"]
    radius = 5 if name == "jbu_one" else 3
    mods = ups[:stages] if qf is None else ups[:stages - 1] + [ups[3]]
    for m in mods:
        h, w = x.shape[-2:]
        x = jjbu.jbu_module_forward(m, x, jjbu.adaptive_avg_pool2d(jnp.asarray(guid),
                                                                   (h * 2, w * 2)), radius)
    x = jjbu._final_fixup_nhwc(x.transpose(0, 2, 3, 1), tree["final_fixup"])
    if qf is None:
        return x
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    return jnp.einsum("bhwc,qc->bhwq", x, jnp.asarray(qf))


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("name", ["jbu_one", "jbu_stack"])
def test_nhwc_forms_match_jax(name, stages):
    """get_upsampler_nhwc / get_upsampler_nhwc_classify on the CPU (plain
    epilogues) against the channel-first JAX modules; the classify form of
    jbu_stack runs ``ups[3]`` in its last stage."""
    tree, mod = _weights(name, seed=3)
    src, guid = _inputs(1, (4, 5), (64, 80), seed=4)
    qf = np.random.RandomState(5).randn(3, C).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=-1, keepdims=True)
    s_nhwc = torch.from_numpy(src).permute(0, 2, 3, 1).contiguous()
    g = torch.from_numpy(guid)
    got = jbu.get_upsampler_nhwc(name, stages)(mod, s_nhwc, g)
    assert _rel(got.numpy(), _nhwc_ref(name, tree, src, guid, stages)) <= 1e-5
    got = jbu.get_upsampler_nhwc_classify(name, stages)(mod, s_nhwc, g, torch.from_numpy(qf))
    assert _rel(got.numpy(), _nhwc_ref(name, tree, src, guid, stages, qf)) <= 1e-5


def test_registry():
    src, guid = _inputs(1, (4, 5), (16, 20))
    fwd, init = jbu.get_upsampler("bilinear")
    ref = jjbu.bilinear_upsample({}, jnp.asarray(src), jnp.asarray(guid))
    got = fwd(init(torch.Generator(), C), torch.from_numpy(src), torch.from_numpy(guid))
    assert _rel(got.numpy(), ref) <= 1e-6
    _, init = jbu.get_upsampler("jbu_stack", stages=2)
    assert isinstance(init(torch.Generator().manual_seed(0), C), JBUStack)
    _, init = jbu.get_upsampler("jbu_one")
    assert isinstance(init(torch.Generator().manual_seed(0), C), JBUOne)
    for name in ("resize_conv", "ifa", "carafe", "sapa"):  # ported with item 8d
        fwd, init = jbu.get_upsampler(name)
        assert fwd is getattr(alternates, f"{name}_forward")
        assert isinstance(init(torch.Generator().manual_seed(0), C), torch.nn.Module)
        assert jbu.get_upsampler_nhwc(name) is None
    with pytest.raises(ValueError, match="Unknown upsampler"):
        jbu.get_upsampler("nearest")
    assert jbu.get_upsampler_nhwc("bilinear") is None
    assert jbu.get_upsampler_nhwc_classify("bilinear") is None


def test_jbu_stack_bridge_is_strict():
    tree, mod = _weights("jbu_stack")
    np.testing.assert_array_equal(mod.ups[3].fixup_proj.w1.numpy(),
                                  tree["ups"][3]["fixup_proj"]["w1"])
    assert mod.ups[0].fixup_proj.w0.shape == (49, 52, 1, 1)
    del tree["ups"][3]
    with pytest.raises(KeyError, match="missing.*ups.3"):
        jbu_params_from_numpy(tree, C)
    one, _ = _weights("jbu_one")
    with pytest.raises(KeyError, match=r"unused \['up\."):
        jbu_params_from_numpy({**one, "ups": tree["ups"]}, C)
    # the segmentor's path: the registry's init, then the strict bridge
    _, init = jbu.get_upsampler("jbu_stack")
    with pytest.raises(KeyError, match="missing.*ups.0"):
        load_numpy_tree(init(torch.Generator().manual_seed(0), C), one)
    m = init_jbu_stack_params(torch.Generator().manual_seed(0), C)
    assert len(m.ups) == 4 and float(m.ups[1].sigma_spatial) == 1.0
