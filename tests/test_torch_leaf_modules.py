"""The leaf modules on the port against the JAX package's, on the CPU in
fp32: CLIP's ModifiedResNet tower (rs_ov_torch.nn.modified_resnet) from a
synthetic torch-named state dict drawn from a seeded RandomState, and the
2-D sine-cosine pos-embed table (rs_ov_torch.nn.pos_embed). Bound:
max|d|/max|ref| <= 1e-5 (tools/parity_check.py:72-85's tower tolerance);
the pos-embed tables are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_ov.nn import modified_resnet as jax_resnet
from rs_ov.nn.pos_embed import get_2d_sincos_pos_embed as jax_sincos
from rs_ov_torch.nn import modified_resnet as resnet
from rs_ov_torch.nn.pos_embed import get_2d_sincos_pos_embed
from test_torch_timm_checkpoint import assert_trees_equal
from test_torch_timm_towers import TOL, rel

torch.set_num_threads(1)


def _resnet_state_dict(cfg, seed=0):
    """open_clip ModifiedResNet names and shapes (reference
    modified_resnet.py:96-181) for ``cfg``, every tensor drawn: BatchNorm
    scales near 1, running variances in [0.5, 1.5], convs at 1 / sqrt(fan in)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.zeros((), np.float32)

    w = cfg.width
    for i, (cout, cin) in enumerate(((w // 2, 3), (w // 2, w // 2), (w, w // 2)), 1):
        conv(f"conv{i}.weight", cout, cin, 3)
        bn(f"bn{i}", cout)
    inplanes = w
    for li, n in enumerate(cfg.layers):
        planes = w * 2 ** li
        for bi in range(n):
            pre = f"layer{li + 1}.{bi}"
            conv(f"{pre}.conv1.weight", planes, inplanes, 1)
            conv(f"{pre}.conv2.weight", planes, planes, 3)
            conv(f"{pre}.conv3.weight", planes * 4, planes, 1)
            for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{pre}.bn{j}", c)
            if bi == 0 and (li > 0 or inplanes != planes * 4):
                conv(f"{pre}.downsample.0.weight", planes * 4, inplanes, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inplanes = planes * 4
    embed = w * 32
    sd["attnpool.positional_embedding"] = (rng.randn((cfg.image_size // 32) ** 2 + 1, embed)
                                           / np.sqrt(embed)).astype(np.float32)
    for name, out in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                      ("c_proj", cfg.output_dim)):
        sd[f"attnpool.{name}.weight"] = (rng.randn(out, embed) / np.sqrt(embed)).astype(
            np.float32)
        sd[f"attnpool.{name}.bias"] = (0.02 * rng.randn(out)).astype(np.float32)
    return sd


@pytest.mark.parametrize("prefix", ["", "visual."])
def test_modified_resnet_matches_jax(prefix):
    """The stem, anti-aliased Bottlenecks (stride-1 conv plus avgpool, the
    downsample branch), eval-mode BatchNorm and the attention pool."""
    cfg = resnet.ModifiedResNetConfig(layers=(1, 2, 1, 1), output_dim=16, heads=2,
                                      image_size=64, width=8)
    sd = {prefix + k: v for k, v in _resnet_state_dict(cfg).items()}
    tree = resnet._resnet_tree(sd, prefix)
    assert_trees_equal(tree, jax.tree_util.tree_map(
        np.asarray, jax_resnet.resnet_params_from_state_dict(sd, prefix)))
    img = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    got = resnet.modified_resnet_forward(resnet.resnet_params_from_state_dict(sd, prefix),
                                         torch.from_numpy(img), cfg)
    want = jax_resnet.modified_resnet_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(img),
        jax_resnet.ModifiedResNetConfig(layers=cfg.layers, output_dim=16, heads=2,
                                        image_size=64, width=8))
    assert got.shape == (2, 16)
    assert rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("dim,grid,cls", [(64, 4, False), (128, 7, True), (256, 14, True)])
def test_sincos_pos_embed_equals_jax(dim, grid, cls):
    got = get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    np.testing.assert_array_equal(got, jax_sincos(dim, grid, cls_token=cls))
    assert got.shape == (grid * grid + cls, dim) and got.dtype == np.float32
