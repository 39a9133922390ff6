"""The training losses on the port (rs_ov_torch.train.losses, factory.create_loss)
against rs_ov.train.losses on the CPU in fp32: each loss and its gradient
(by the features, the scale and the bias) against jax.grad, within 1e-5
relative; and over 2 gloo ranks, the gathered CLIP loss (also
``local_loss``) and the SigLIP ring against the JAX global form of the whole
batch: the ranks' mean loss equals it, and the features' gradients are
``world`` times the global loss's (every rank differentiates the global
CLIP loss and the gather's backward sums them; the ranks' ``local_loss``
and SigLIP shares sum to ``world`` times the global loss)."""

from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rs_ov.train import losses as jax_losses
from rs_ov_torch import factory
from rs_ov_torch.train import losses
from torch_dist_workers import losses_worker, spawn

torch.set_num_threads(2)

RTOL = 1e-5


def _feats(b=6, d=8, seed=0):
    rng = np.random.RandomState(seed)
    f = rng.randn(2, b, d).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return f[0], f[1]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-12), (got, want)


def _check(jfn, tfn, arrays):
    """Value and gradient by every array: jfn on jnp arrays, tfn on tensors."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    _close(float(tv.detach()), float(jv))
    for t, g in zip(ts, jg):
        _close(t.grad.numpy(), g)


def test_clip_loss_and_gradient():
    img, txt = _feats()
    _check(lambda i, t, s: jax_losses.clip_loss(i, t, s),
           lambda i, t, s: losses.clip_loss(i, t, s), [img, txt, np.float32(14.3)])


def test_siglip_loss_and_gradient():
    img, txt = _feats(seed=1)
    _check(lambda i, t, s, b: jax_losses.siglip_loss(i, t, s, b),
           lambda i, t, s, b: losses.siglip_loss(i, t, s, b),
           [img, txt, np.float32(10.0), np.float32(-3.0)])


def test_coca_loss_and_gradient():
    img, txt = _feats(seed=2)
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 5, 11).astype(np.float32)
    labels = rng.randint(1, 11, size=(6, 5)).astype(np.int32)
    labels[:, -2:] = 0

    def jfn(i, t, lg, s):
        c, cap = jax_losses.coca_loss(i, t, lg, jnp.asarray(labels), s)
        return c + 3 * cap

    def tfn(i, t, lg, s):
        c, cap = losses.coca_loss(i, t, lg, torch.from_numpy(labels), s)
        return c + 3 * cap

    _check(jfn, tfn, [img, txt, logits, np.float32(5.0)])


def test_distill_loss_and_gradient():
    img, txt = _feats(seed=4)
    dimg, dtxt = _feats(seed=5)

    def jfn(i, t, s, di, dt, ds):
        c, d = jax_losses.distill_clip_loss(i, t, s, di, dt, ds)
        return c + 2 * d

    def tfn(i, t, s, di, dt, ds):
        c, d = losses.distill_clip_loss(i, t, s, di, dt, ds)
        return c + 2 * d

    _check(jfn, tfn, [img, txt, np.float32(9.0), dimg, dtxt, np.float32(20.0)])


def test_create_loss_dispatches_as_the_jax_factory():
    from rs_ov import factory as jax_factory

    for args in (SimpleNamespace(), SimpleNamespace(distill=True),
                 SimpleNamespace(model="coca_ViT-L-14"), SimpleNamespace(siglip=True)):
        assert (factory.create_loss(args).__name__ ==
                jax_factory.create_loss(args).__name__)


def test_two_rank_gather_and_ring_match_the_global_form(tmp_path):
    img, txt = _feats(b=8, seed=6)
    scale, bias = np.float32(10.0), np.float32(-2.0)
    res = spawn(losses_worker, 2, tmp_path, img, txt, scale, bias)
    world = 2
    forms = {"clip": lambda i, t: jax_losses.clip_loss(i, t, scale),
             "clip_local": lambda i, t: jax_losses.clip_loss(i, t, scale),
             "siglip": lambda i, t: jax_losses.siglip_loss(i, t, scale, bias)}
    for name, fn in forms.items():
        jv, (gi, gt) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(txt))
        _close(res[f"{name}_loss"], float(jv))
        _close(res[f"{name}_gi"], world * np.asarray(gi))
        _close(res[f"{name}_gt"], world * np.asarray(gt))
