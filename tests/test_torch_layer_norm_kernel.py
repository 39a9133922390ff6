"""K7, the LayerNorm kernel (``rs_ov_torch/kernels/layer_norm.py``,
``rs_ov_torch/csrc/layer_norm.cu``): on the CPU the plain version against the
JAX package's ``layer_norm``, the operator's fake, the row plan and the
autograd route; on a card (``cuda`` tests, skipped here) the kernel against
the plain version: bf16 outputs at most one bf16 step apart (beside the
fp32 tolerance), fp32 within 1e-5 of max|ref|, both kernels (the row in
registers, a block a row), two calls equal bit for bit, one launch counted
a call, and the autograd route's gradients against the plain chain's.

Inputs are made with numpy from a seed. This file imports jax only inside
the CPU comparison, so that on a card it runs with

    python -m pytest tests/test_torch_layer_norm_kernel.py --noconftest -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels import build
from rs_ov_torch.kernels import layer_norm as ln
from rs_ov_torch.nn import layers

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(rows, d, dtype, pdtype=None, seed=0, device="cpu"):
    """x [rows, d] whose rows have spreads from 1e-3 to 30 around offsets
    (so that eps and the two-pass variance matter), scale and bias [d]."""
    rng = np.random.RandomState(seed)
    spread = 10.0 ** rng.uniform(-3, 1.5, (rows, 1))
    x = rng.randn(rows, d) * spread + rng.randn(rows, 1) * 3 * spread
    scale, bias = 1 + 0.5 * rng.randn(d), 0.3 * rng.randn(d)

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    pdtype = dtype if pdtype is None else pdtype
    return t(x, dtype), t(scale, pdtype), t(bias, pdtype)


def _bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 steps between two bf16 tensors, element by element
    (bit patterns mapped onto one ordered integer line; +0 and -0 coincide)."""
    def line(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)
    return int((line(a) - line(b)).abs().max())


def _bf16_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| over one bf16 step of |ref| plus 1e-5 of
    max|ref| (the fp32 tolerance: an output near zero is a cancellation in
    y * scale + bias, where fp32 sums taken in another order move it by more
    than its own step): at most 1 where the two are one rounding apart."""
    got, ref = got.float(), ref.float()
    step = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - 8) * (ref != 0)
    return float(((got - ref).abs() / (step + 1e-5 * ref.abs().max())).max())


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-6, 1e-12])
@pytest.mark.parametrize("d", [512, 768, 1000, 1024, 1280])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_plain_matches_the_jax_layer_norm(dtype, d, eps):
    """The plain version against rs_ov/nn/layers.py:layer_norm on the same
    inputs: only the order of the fp32 sums differs, so fp32 agrees within
    2e-6 of max|ref| and bf16 within one bf16 step."""
    jnp = pytest.importorskip("jax").numpy
    from rs_ov.nn import layers as jlayers

    x, scale, bias = _inputs(6, d, dtype, seed=d)
    got = ln.layer_norm_plain(x, scale, bias, eps)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    ref = jlayers.layer_norm(jnp.asarray(x.float().numpy(), jdt),
                             {"scale": jnp.asarray(scale.float().numpy(), jdt),
                              "bias": jnp.asarray(bias.float().numpy(), jdt)}, eps)
    assert got.dtype == dtype and tuple(got.shape) == (6, d)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    if dtype == BF16:
        assert _bf16_steps(got, ref) <= 1
    else:
        assert (got - ref).abs().max() <= 2e-6 * ref.abs().max()


@pytest.mark.parametrize("dtype,pdtype", [(BF16, BF16), (F32, F32), (BF16, F32), (F32, BF16)])
def test_the_operators_fake_gives_the_inputs_shape_and_dtype(dtype, pdtype):
    """rs_ov::layer_norm traced on fake tensors returns x's shape and dtype,
    contiguous; opcheck's schema and fake checks pass on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, scale, bias = _inputs(5, 96, dtype, pdtype)
    x = x.reshape(5, 1, 96)
    with FakeTensorMode() as mode:
        fx, fs, fb = (mode.from_tensor(t) for t in (x, scale, bias))
        out = torch.ops.rs_ov.layer_norm.default(fx, fs, fb, 1e-6)
    assert tuple(out.shape) == (5, 1, 96) and out.dtype == dtype and out.is_contiguous()
    torch.library.opcheck(torch.ops.rs_ov.layer_norm.default, (x, scale, bias, 1e-6),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_the_layers_layer_norm_is_the_plain_chain_on_the_cpu(dtype):
    """nn.layers.layer_norm on CPU tensors is the plain version bit for bit,
    and counts no launch."""
    x, scale, bias = _inputs(7, 768, dtype, seed=3)
    before = build.launch_counts()["layer_norm"]
    got = layers.layer_norm(x.reshape(7, 1, 768), SimpleNamespace(scale=scale, bias=bias), 1e-6)
    assert torch.equal(got, ln.layer_norm_plain(x, scale, bias, 1e-6).reshape(7, 1, 768))
    assert build.launch_counts()["layer_norm"] == before


@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, True)], ids=["all", "x", "params"])
def test_the_autograd_route_equals_the_plain_chain_on_the_cpu(need):
    """Where an operand needs a gradient the call is _LayerNorm: on the CPU
    its output and the gradients of the operands that need one are the
    plain chain's, bit for bit."""
    x, scale, bias = _inputs(9, 512, F32, seed=4)
    g = torch.from_numpy(np.random.RandomState(5).randn(9, 512).astype(np.float32))

    def run(fn):
        ops = [t.clone().requires_grad_(n) for t, n in zip((x, scale, bias), need)]
        y = fn(*ops, 1e-5)
        return y, torch.autograd.grad(y, [t for t in ops if t.requires_grad], g)

    y, grads = run(ln.layer_norm)
    y_ref, grads_ref = run(ln.layer_norm_plain)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("_LayerNorm")
    assert torch.equal(y, y_ref)
    assert len(grads) == sum(need)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_ref))


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (96, BF16, True, 1), (768, BF16, True, 3), (1000, BF16, True, 4), (1024, BF16, True, 4),
    (2048, BF16, True, 8), (1001, BF16, True, 0), (2056, BF16, True, 0),
    (768, F32, True, 6), (1024, F32, True, 8), (1280, F32, True, 0), (1002, F32, True, 0),
    (768, BF16, False, 0)])
def test_the_row_plan(d, dtype, aligned, want):
    """The 16-byte vectors a lane holds (the row in registers), or 0 for the
    one-block-a-row kernel: a ragged row, unaligned operands, or a row past
    MAX_VECTORS vectors a lane."""
    assert ln._row_vectors(d, dtype, aligned) == want


def test_the_operands_are_checked_before_the_library_loads(monkeypatch):
    """The CUDA wrapper's checks run on any tensors, before a launch: fp16,
    parameters of the wrong length or of two dtypes, and no rows raise."""
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("library loaded"))
    x, scale, bias = _inputs(3, 64, BF16)
    out, entry, args, _keep = ln._layer_norm_operands(x, scale, bias, 1e-5)
    assert out.shape == x.shape and entry == "rs_layer_norm" and args[4:9] == (3, 64, 1, 1, 1)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ln._layer_norm_operands(x.half(), scale, bias, 1e-5)
    with pytest.raises(ValueError, match="must be"):
        ln._layer_norm_operands(x, scale[:32], bias, 1e-5)
    with pytest.raises(ValueError, match="one dtype"):
        ln._layer_norm_operands(x, scale, bias.float(), 1e-5)
    with pytest.raises(ValueError, match="rows"):
        ln._layer_norm_operands(x[:0], scale, bias, 1e-5)
    with pytest.raises(NotImplementedError, match="no route"):
        ln.layer_norm(torch.empty(2, 64, device="meta"), scale, bias)


def test_the_cpu_and_a_trace_take_the_operator(monkeypatch):
    """A CPU tensor and a traced one go through the operator ``rs_ov::layer_norm``
    (only eager CUDA tensors launch the kernel without it), so that
    ``torch.export`` records the call as one node."""
    seen = []
    op = ln._KERNEL.op
    monkeypatch.setattr(ln._KERNEL, "op", lambda *a: seen.append(type(a[0])) or op(*a))
    x, scale, bias = _inputs(6, 64, F32)
    assert torch.equal(ln.layer_norm(x, scale, bias), ln.layer_norm_plain(x, scale, bias, 1e-5))
    assert seen == [torch.Tensor]

    class Norm(torch.nn.Module):
        def forward(self, x):
            return ln.layer_norm(x, scale, bias)

    graph = torch.export.export(Norm(), (x,)).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets == ["rs_ov.layer_norm.default"] and len(seen) == 2


# ---------------------------------------------------------------------------
# on a card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _agree(got, ref, dtype):
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    if dtype == BF16:
        assert _bf16_gap(got, ref) <= 1
    else:
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# (D, x dtype, parameter dtype): both kernels, ragged rows (1000 bf16 fills
# 125 of 128 vectors; 1001 and 1002 are no whole number of vectors), 96
# (ConvNeXt's first stage), rows past the register limit (2056 bf16, 1280
# fp32), mixed parameter dtypes
CASES = [(96, BF16, BF16), (768, BF16, BF16), (1000, BF16, BF16), (1001, BF16, BF16),
         (1024, BF16, BF16), (1280, BF16, BF16), (2048, BF16, BF16), (2056, BF16, BF16),
         (768, BF16, F32), (96, F32, F32), (768, F32, F32), (1002, F32, F32),
         (1024, F32, F32), (1280, F32, F32), (1024, F32, BF16)]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("d,dtype,pdtype", CASES)
def test_kernel_against_the_plain_version(cuda, d, dtype, pdtype, eps):
    """333 rows (not a whole number of blocks of 8) against the plain version
    on the card; one launch counted."""
    x, scale, bias = _inputs(333, d, dtype, pdtype, seed=d, device=cuda)
    before = build.launch_counts()["layer_norm"]
    got = ln.layer_norm(x, scale, bias, eps)
    assert build.launch_counts()["layer_norm"] == before + 1
    _agree(got, ln.layer_norm_plain(x, scale, bias, eps), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_unaligned_and_strided_operands(cuda, dtype):
    """x 2 elements past a 16-byte boundary takes the one-block-a-row
    kernel; a column slice of x is copied contiguous first; both agree."""
    x, scale, bias = _inputs(64, 768, dtype, seed=7, device=cuda)
    buf = torch.empty(64 * 768 + 2, dtype=dtype, device=cuda)
    shifted = buf[2:].view(64, 768)
    shifted.copy_(x)
    _agree(ln.layer_norm(shifted, scale, bias), ln.layer_norm_plain(x, scale, bias, 1e-5), dtype)
    wide = torch.cat([x, x], dim=1)[:, 768:]
    _agree(ln.layer_norm(wide, scale, bias), ln.layer_norm_plain(x, scale, bias, 1e-5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 1001], ids=["registers", "block"])
def test_two_calls_are_identical_bit_for_bit(cuda, d):
    x, scale, bias = _inputs(4096, d, BF16, seed=8, device=cuda)
    assert torch.equal(ln.layer_norm(x, scale, bias), ln.layer_norm(x, scale, bias))


@pytest.mark.cuda
def test_the_tower_shapes(cuda):
    """ViT-B/16's and ViT-L/14's LayerNorm of one 512^2 tile's 16 crops
    (3152 x 768, 4112 x 1024) as the tower calls it, [crops, tokens, D]."""
    for crops, tokens, d in ((16, 197, 768), (16, 257, 1024)):
        x, scale, bias = _inputs(crops * tokens, d, BF16, seed=d, device=cuda)
        p = SimpleNamespace(scale=scale, bias=bias)
        x = x.reshape(crops, tokens, d)
        _agree(layers.layer_norm(x, p), ln.layer_norm_plain(x, scale, bias, 1e-5), BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pdtype", [(BF16, BF16), (F32, F32), (BF16, F32)])
def test_the_autograd_route_on_the_card(cuda, dtype, pdtype):
    """The kernel's forward with the plain chain's backward: the gradients
    of x, scale and bias equal the plain chain's autograd bit for bit (the
    backward recomputes the plain version from the saved input)."""
    x, scale, bias = _inputs(200, 768, dtype, pdtype, seed=9, device=cuda)
    g = torch.from_numpy(np.random.RandomState(10).randn(200, 768).astype(np.float32)).to(
        cuda, dtype)

    def run(fn):
        ops = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = fn(*ops, 1e-5)
        return y, torch.autograd.grad(y, ops, g)

    before = build.launch_counts()["layer_norm"]
    y, grads = run(ln.layer_norm)
    assert build.launch_counts()["layer_norm"] == before + 1
    y_ref, grads_ref = run(ln.layer_norm_plain)
    _agree(y.detach(), y_ref.detach(), dtype)
    for a, b in zip(grads, grads_ref):
        assert torch.equal(a, b)
