"""The training step on the port (rs_ov_torch.train.step, optim, nn.layers'
matmul32 gradient) against rs_ov's on the CPU in fp32, from one drawn tree
(every leaf drawn from a seed: the init's zero biases hide faults).

Gradients are held against ``jax.grad`` of the same JAX loss, leaf by leaf:
max|d|/max|ref| <= GRAD_TOL (fp32 sums in another order). The optimiser is
held against optax on identical gradients (atol OPT_TOL). A whole step is
compared with the JAX step's updated leaves only within a few learning
rates (Adam's first steps move every leaf by about lr whatever its
gradient, so a near-zero gradient may flip sign between packages). bf16 on
the CPU: per-leaf-group gradient cosine >= BF16_COS against fp32."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from rs_ov.core import config as jax_config
from rs_ov.core.params import init_clip_params as jax_init_clip
from rs_ov.train import losses as jax_losses
from rs_ov.train import step as jax_step
from rs_ov_torch.core import config
from rs_ov_torch.core.params import clip_params_from_numpy
from rs_ov_torch.nn.layers import matmul32
from rs_ov_torch.train import optim, step
from test_torch_timm_towers import draw

torch.set_num_threads(2)

GRAD_TOL = 1e-4
OPT_TOL = 1e-6
BF16_COS = 0.99
LR = 1e-3


def tiny_cfg(pkg, logit_bias=None):
    return pkg.CLIPConfig(
        embed_dim=16,
        vision=pkg.VisionConfig(image_size=32, patch_size=16, width=32, layers=2, output_dim=16,
                                head_width=8),
        text=pkg.TextConfig(context_length=12, vocab_size=64, width=32, heads=4, layers=2,
                            output_dim=16),
        init_logit_bias=logit_bias)


CFG, JCFG = tiny_cfg(config), tiny_cfg(jax_config)


def drawn_tree(seed=0, siglip=False):
    """The JAX init's tree, every leaf drawn from ``seed``; ``logit_bias``
    -10 for SigLIP."""
    tree = draw(jax.tree.map(np.asarray, jax_init_clip(jax.random.PRNGKey(seed), JCFG)), seed)
    if siglip:
        tree["logit_bias"] = np.float32(-10.0)
    return tree


def batch(b, seed=1):
    rng = np.random.RandomState(seed)
    images = rng.randn(b, 3, 32, 32).astype(np.float32)
    texts = rng.randint(1, 60, size=(b, 12)).astype(np.int32)
    texts[np.arange(b), rng.randint(2, 12, size=b)] = 63  # the eot, the row's highest id
    return images, texts


def jax_loss(tree, images, texts, loss="clip"):
    img = jax_step.encode_image_train(tree, images, JCFG, remat=False)
    txt = jax_step.encode_text_train(tree, texts, JCFG, remat=False)
    scale = jnp.exp(tree["logit_scale"])
    if loss == "siglip":
        return jax_losses.siglip_loss(img, txt, scale, tree["logit_bias"])
    return jax_losses.clip_loss(img, txt, scale)


def jax_grads(tree, images, texts, loss="clip"):
    jtree = jax.tree.map(jnp.asarray, tree)
    fn = jax.jit(jax.value_and_grad(jax_loss), static_argnums=3)
    val, g = fn(jtree, jnp.asarray(images), jnp.asarray(texts), loss)
    return float(val), jax.tree.map(np.asarray, g)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def port_params(tree):
    return clip_params_from_numpy(tree, CFG).requires_grad_()


def assert_grads_match(module, want_tree, tol=GRAD_TOL):
    """Per leaf max|d| / max|ref|; a leaf whose true gradient is zero (a
    key bias under a softmax) is measured against 1e-3 of the largest
    leaf's, since both packages give it rounding noise."""
    want = flat(want_tree)
    got = {n: p.grad.numpy() for n, p in module.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        err = np.abs(got[n] - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, (n, err)


def test_matmul32_gradients_match_jax():
    """matmul32's backward against jax.grad of the fp32 dot with
    preferred_element_type=float32, for a 2-D and a batched right operand."""
    rng = np.random.RandomState(0)
    for a_shape, b_shape in (((3, 5, 7), (7, 4)), ((2, 3, 5, 7), (2, 3, 7, 4))):
        a, b = rng.randn(*a_shape).astype(np.float32), rng.randn(*b_shape).astype(np.float32)
        ct = rng.randn(*(a_shape[:-1] + b_shape[-1:])).astype(np.float32)

        def f(x, y):
            out = jnp.matmul(x, y, preferred_element_type=jnp.float32)
            return jnp.sum(out * ct)

        ga, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        (matmul32(ta, tb) * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-5)
        assert ta.grad.dtype == tb.grad.dtype == torch.float32


@pytest.mark.parametrize("loss,remat", [("clip", True), ("clip", False), ("siglip", True)])
def test_step_gradients_match_jax(loss, remat):
    """The step's gradients, remat on and off, CLIP and SigLIP."""
    tree = drawn_tree(siglip=loss == "siglip")
    images, texts = batch(6)
    want_loss, want = jax_grads(tree, images, texts, loss)
    params = port_params(tree)
    fn, _ = step.make_clip_train_step(CFG, remat=remat, loss=loss)
    got_loss = float(fn.backward(params, images, texts))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    assert_grads_match(params, want)


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_accumulation_gives_the_full_batch_gradient(loss):
    """accum_steps 2 against 1 on one global batch: the same loss and the
    full batch's gradient, logit_scale's counted once (as jax.grad's)."""
    tree = drawn_tree(seed=3, siglip=loss == "siglip")
    images, texts = batch(8, seed=4)
    want_loss, want = jax_grads(tree, images, texts, loss)
    params = port_params(tree)
    fn, _ = step.make_clip_train_step(CFG, loss=loss, accum_steps=2)
    assert abs(float(fn.backward(params, images, texts)) - want_loss) <= 1e-5 * abs(want_loss)
    assert_grads_match(params, want)


def test_clip_step_matches_the_jax_step():
    """Two whole steps (accumulation 2, clipping, a warmup-cosine schedule,
    the ndim >= 2 decay mask) against rs_ov's make_clip_train_step with the
    same optax chain: the losses, and the leaves within a few lr."""
    tree = drawn_tree(seed=5)
    images, texts = batch(8, seed=6)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=1, decay_steps=3)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(
        sched, weight_decay=0.2,
        mask=lambda p: jax.tree_util.tree_map(lambda x: getattr(x, "ndim", 0) >= 2, p)))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jfn, jinit = jax_step.make_clip_train_step(JCFG, mesh, optimizer=tx, accum_steps=2)
    jtree = jax.tree.map(jnp.asarray, tree)
    jopt = jinit(jtree)
    params = port_params(tree)
    spec = optim.adamw(optim.warmup_cosine_decay_schedule(0.0, LR, 1, 3), weight_decay=0.2,
                       mask=optim.decay_matrices, clip_norm=0.5)
    fn, init = step.make_clip_train_step(CFG, optimizer=spec, accum_steps=2)
    opt = init(params)
    for _ in range(2):
        jtree, jopt, jl = jfn(jtree, jopt, jnp.asarray(images), jnp.asarray(texts))
        params, opt, tl = fn(params, opt, images, texts)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = flat(jax.tree.map(np.asarray, jtree))
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=3 * LR, err_msg=n)
    assert opt.count == 2


def test_schedule_matches_optax():
    for warmup, steps in ((0, 1), (3, 10), (200, 5), (4, 4)):
        w = optim.warmup_steps(warmup, steps)
        ours = optim.warmup_cosine_decay_schedule(0.0, 1e-3, w, steps)
        theirs = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=w, decay_steps=steps)
        for c in range(steps + 2):
            assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-6, abs=1e-12), (w, steps, c)
    assert optim.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)(0) == 0.0
    with pytest.raises(ValueError):
        optim.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(0)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    optim.clip_by_global_norm(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adamw_matches_optax_on_identical_gradients():
    """Three updates of the same gradients: optax.adamw with the decay mask
    against the port's two parameter groups; and optax's defaults (weight
    decay 1e-4 on every leaf)."""
    rng = np.random.RandomState(1)
    leaves = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in leaves.items()}
             for _ in range(3)]
    for mask, wd in ((True, 0.2), (False, None)):
        kw = {} if wd is None else {"weight_decay": wd}
        tx = optax.adamw(1e-2, mask=(lambda p: jax.tree.map(lambda x: x.ndim >= 2, p))
                         if mask else None, **kw)
        jp = jax.tree.map(jnp.asarray, leaves)
        state = tx.init(jp)
        module = torch.nn.Module()
        for k, v in leaves.items():
            module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        opt = optim.adamw(1e-2, mask=optim.decay_matrices if mask else None, **kw).init(module)
        for g in grads:
            upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in module.named_parameters():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=OPT_TOL, err_msg=(k, mask))


def _groups(module):
    out = {}
    for n, p in module.named_parameters():
        out.setdefault(".".join(n.split(".")[:2]), []).append(p.grad.float().reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def test_bf16_step_on_the_cpu_follows_fp32():
    """bf16 compute over fp32 masters: the masters keep fp32 gradients whose
    per-group cosine with the fp32 step's is >= BF16_COS; the loss within 1e-2."""
    tree = drawn_tree(seed=7)
    images, texts = batch(6, seed=8)
    ref, low = port_params(tree), port_params(tree)
    l32 = float(step.make_clip_train_step(CFG)[0].backward(ref, images, texts))
    l16 = float(step.make_clip_train_step(CFG, compute_dtype=torch.bfloat16)[0].backward(
        low, images, texts))
    assert abs(l16 - l32) <= 1e-2 * abs(l32)
    assert all(p.grad.dtype == torch.float32 for p in low.parameters())
    g32, g16 = _groups(ref), _groups(low)
    for k in g32:
        cos = torch.nn.functional.cosine_similarity(g32[k], g16[k], dim=0)
        assert cos >= BF16_COS, (k, float(cos))


def test_coca_step_gradients_match_jax():
    """The CoCa step's (contrastive, caption) and gradients against jax.grad
    of rs_ov's CoCa loss (coca_forward + coca_loss)."""
    from rs_ov.nn import coca as jax_coca
    from rs_ov_torch.core.params import coca_params_from_numpy
    from test_torch_coca import JAX_SMALL, SMALL

    tree = draw(jax.tree.map(np.asarray, jax_coca.init_coca_params(jax.random.PRNGKey(0),
                                                                    JAX_SMALL)), 9)
    rng = np.random.RandomState(2)
    images = rng.randn(4, 3, 32, 32).astype(np.float32)
    texts = rng.randint(1, 64, size=(4, 12)).astype(np.int32)
    texts[:, -3:] = 0  # pads, ignored by the caption term

    def loss(t):
        out = jax_coca.coca_forward(t, jnp.asarray(images), jnp.asarray(texts), JAX_SMALL)
        c, cap = jax_losses.coca_loss(out["image_features"], out["text_features"],
                                      out["logits"], out["labels"], jnp.exp(t["logit_scale"]),
                                      pad_id=JAX_SMALL.pad_id)
        return c + cap, (c, cap)

    (_, (jc, jcap)), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    params = coca_params_from_numpy(tree, SMALL).requires_grad_()
    fn, init = step.make_coca_train_step(SMALL)
    c, cap = fn.backward(params, images, texts)
    assert abs(float(c) - float(jc)) <= 1e-5 * abs(float(jc))
    assert abs(float(cap) - float(jcap)) <= 1e-5 * abs(float(jcap))
    assert_grads_match(params, jax.tree.map(np.asarray, want))
    opt = init(params)
    before = params.logit_scale.detach().clone()
    fn(params, opt, images, texts)
    assert not torch.equal(before, params.logit_scale.detach())
