"""K8, a linear layer's epilogue (``rs_ov_torch/kernels/linear_epilogue.py``,
``rs_ov_torch/csrc/linear_epilogue.cu``): on the CPU ``nn.layers.linear``
with an activation against the activation after the linear, ``mlp``'s
activation passed into its ``c_fc`` linear, the operator's fake, the
operand checks and the autograd route; on a card (``cuda`` tests, skipped
here) the kernel against the plain chain bit for bit: at the ViT towers'
shapes, at ragged widths and unaligned operands, and over every bf16 value
as the pre-activation of each activation; one launch counted a call.

Inputs are made with numpy or a seeded generator. This file imports no jax,
so that on a card it runs with

    python -m pytest tests/test_torch_linear_epilogue.py --noconftest -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rs_ov_torch.kernels import build
from rs_ov_torch.kernels import linear_epilogue as le
from rs_ov_torch.nn import layers

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
ACTS = {"none": None, "quick_gelu": layers.quick_gelu, "gelu": layers.gelu}


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _t(a, dtype=F32, device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)


def _operands(rows, n, dtype, seed=0, device="cpu"):
    """x [rows, 48] in ``dtype``, w [n, 48] and b [n] in ``dtype``: products
    around +-3, where every activation bends."""
    rng = np.random.RandomState(seed)
    return (_t(rng.randn(rows, 48), dtype, device), _t(rng.randn(n, 48) * 0.25, dtype, device),
            _t(rng.randn(n) * 0.5, dtype, device))


def _chain(x, w, b, act):
    """Today's chain, as the port ran it before K8: the product, the bias
    added in fp32, one cast, the activation."""
    y = layers.matmul32(x, w.t())
    if b is not None:
        y = y + b.float()
    h = y.to(x.dtype)
    return h if act is None else act(h)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_linear_with_an_activation_is_the_activation_after_the_linear(dtype, act, bias):
    """linear(x, w, b, act=a) on the CPU equals a(linear(x, w, b)) and the
    chain bit for bit, in x's dtype, and launches nothing."""
    x, w, b = _operands(37, 72, dtype, seed=1)
    b = b if bias else None
    before = build.launch_counts()
    got = layers.linear(x.reshape(37, 1, 48), w, b, act=ACTS[act])
    after = layers.linear(x.reshape(37, 1, 48), w, b)
    after = after if ACTS[act] is None else ACTS[act](after)
    assert got.dtype == dtype and tuple(got.shape) == (37, 1, 72)
    assert torch.equal(got, after)
    assert torch.equal(got, _chain(x, w, b, ACTS[act]).reshape(37, 1, 72))
    assert build.launch_counts() == before


@pytest.mark.parametrize("act,passed", [(layers.quick_gelu, "quick_gelu"),
                                        (layers.gelu, "gelu"), (gelu_tanh, "none")],
                         ids=["quick_gelu", "gelu", "gelu_tanh"])
def test_mlp_passes_its_activation_into_c_fc(act, passed, monkeypatch):
    """mlp hands quick_gelu and gelu (by identity) to the c_fc linear's
    epilogue; any other activation (timm's tanh GELU) runs after it. The
    output is c_proj(act(c_fc(x))) bit for bit."""
    seen = []
    fn = layers._linear_epilogue
    monkeypatch.setattr(layers, "_linear_epilogue",
                        lambda y, b, a, dt: seen.append(a) or fn(y, b, a, dt))
    x, w1, b1 = _operands(9, 64, BF16, seed=2)
    rng = np.random.RandomState(3)
    w2, b2 = _t(rng.randn(48, 64) * 0.25, BF16), _t(rng.randn(48) * 0.5, BF16)
    p = SimpleNamespace(c_fc_w=w1, c_fc_b=b1, c_proj_w=w2, c_proj_b=b2)
    got = layers.mlp(x, p, act=act)
    assert seen == [passed, "none"]
    ref = _chain(_chain(x, w1, b1, act), w2, b2, None)
    assert torch.equal(got, ref)


def test_the_kernel_is_declared_and_counted():
    """linear_epilogue is a declared kernel, its operator rs_ov::linear_epilogue,
    and launch_counts() names it."""
    assert "linear_epilogue" in build.launch_counts()
    assert build.KERNELS["linear_epilogue"] is le._KERNEL
    assert le._KERNEL.counters == ("linear_epilogue",)
    assert hasattr(torch.ops.rs_ov, "linear_epilogue")


@pytest.mark.parametrize("bias", [None, BF16, F32], ids=["no-bias", "bias-bf16", "bias-fp32"])
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_the_operators_fake_gives_the_outputs_shape_and_dtype(dtype, act, bias):
    """rs_ov::linear_epilogue traced on fake tensors returns y's shape in
    ``dtype``; opcheck's schema and fake checks pass on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    y = _t(np.random.RandomState(4).randn(3, 5, 24))
    b = None if bias is None else _t(np.random.RandomState(5).randn(24), bias)
    with FakeTensorMode() as mode:
        fy = mode.from_tensor(y)
        fb = None if b is None else mode.from_tensor(b)
        out = torch.ops.rs_ov.linear_epilogue.default(fy, fb, act, dtype)
    assert tuple(out.shape) == (3, 5, 24) and out.dtype == dtype and out.is_contiguous()
    torch.library.opcheck(torch.ops.rs_ov.linear_epilogue.default, (y, b, act, dtype),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, False), (False, False, True)],
                         ids=["all", "x", "w", "b"])
def test_the_autograd_route_is_the_chain(need, act, dtype, monkeypatch):
    """Where an operand needs a gradient linear's epilogue is the kernel's
    operator forward (the plain chain on the CPU), called once, and the
    chain's gradient backward: its output and the gradients of the operands
    that need one are the chain's bit for bit."""
    x, w, b = _operands(11, 40, dtype, seed=6)
    g = _t(np.random.RandomState(7).randn(11, 40), dtype)

    def run(fn):
        ops = [t.clone().requires_grad_(n) for t, n in zip((x, w, b), need)]
        y = fn(*ops, ACTS[act])
        return y, torch.autograd.grad(y, [t for t in ops if t.requires_grad], g)

    calls = []
    op = le._KERNEL.op
    monkeypatch.setattr(le._KERNEL, "op", lambda *a: calls.append(a) or op(*a))
    y, grads = run(lambda x, w, b, a: layers.linear(x, w, b, act=a))
    assert len(calls) == 1 and y.grad_fn is not None
    y_ref, grads_ref = run(_chain)
    assert torch.equal(y, y_ref)
    assert len(grads) == sum(need)
    assert all(torch.equal(a, r) for a, r in zip(grads, grads_ref))


def test_an_fp32_product_with_nothing_to_add_is_the_output(monkeypatch):
    """An fp32 linear with no bias and no activation returns the product
    itself, as the chain does: no epilogue call."""
    x, w, _ = _operands(6, 16, F32, seed=8)
    calls = []
    op = le._KERNEL.op
    monkeypatch.setattr(le._KERNEL, "op", lambda *a: calls.append(a) or op(*a))
    got = layers.linear(x, w)
    assert calls == [] and torch.equal(got, layers.matmul32(x, w.t()))


@pytest.mark.parametrize("n,offset,want", [(768, 0, 8), (2304, 0, 8), (24, 0, 8), (770, 0, 1),
                                           (7, 0, 1), (768, 1, 1)],
                         ids=["768", "2304", "24", "ragged-770", "ragged-7", "unaligned"])
def test_the_vector_plan(n, offset, want):
    """Eight columns a thread where N is a multiple of 8 and every operand
    16-byte aligned, else one; rows and N as the kernel reads them."""
    buf = torch.zeros(5 * n + offset)
    y = buf[offset:].view(5, n)
    out, entry, args, keep = le._linear_epilogue_operands(y, torch.zeros(n, dtype=BF16),
                                                          "gelu", BF16)
    assert entry == "rs_linear_epilogue" and out.shape == (5, n) and out.dtype == BF16
    assert args[3:] == (5, n, 1, 1, 2, want) and keep[0] is y


def test_the_operands_are_checked_before_the_library_loads(monkeypatch):
    """The CUDA wrapper's checks run on any tensors, before a launch: a
    non-contiguous, fp16 or bf16 product, an fp16 output, an unknown
    activation, a bias of the wrong length or dtype, and no rows raise."""
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("library loaded"))
    y, b = torch.zeros(4, 16), torch.zeros(16, dtype=BF16)
    out, _, args, _ = le._linear_epilogue_operands(y, None, "none", F32)
    assert out.dtype == F32 and args[1] == 0 and args[6] == -1
    for bad in (y.t(), y[:, ::2], y.half(), y.bfloat16()):
        with pytest.raises(ValueError, match="contiguous fp32 product"):
            le._linear_epilogue_operands(bad, None, "none", BF16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        le._linear_epilogue_operands(y, b, "none", torch.float16)
    with pytest.raises(ValueError, match="act one of"):
        le._linear_epilogue_operands(y, b, "relu", BF16)
    for bad in (b[:8], b.half(), torch.zeros(2, 8)):
        with pytest.raises(ValueError, match="bias"):
            le._linear_epilogue_operands(y, bad, "none", BF16)
    with pytest.raises(ValueError, match="rows"):
        le._linear_epilogue_operands(y[:0], b, "none", BF16)
    with pytest.raises(NotImplementedError, match="no route"):
        le.linear_epilogue(torch.empty(2, 16, device="meta"), None, "none", BF16)


# ---------------------------------------------------------------------------
# on a card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(got, ref):
    """Equal bit for bit, NaN against NaN of any payload."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    bits = torch.int16 if got.dtype == BF16 else torch.int32
    diff = got.view(bits) != ref.view(bits)
    assert not bool((diff & ~nan).any()), (
        f"{int((diff & ~nan).sum())} of {got.numel()} outputs differ")


def _product(rows, n, seed, device, scale=3.0):
    """An fp32 product [rows, n] drawn on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, n, generator=gen, device=device) * scale


# (tower, crops, width, tokens): ViT-B/16 and ViT-L/14 over a call of 8
# tiles (128 crops) and over one tile (16 crops)
TOWERS = [("B16", 128, 768, 197), ("B16", 16, 768, 197), ("L14", 128, 1024, 257),
          ("L14", 16, 1024, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("mult", [3, 1, 4], ids=["in_proj", "out_proj", "c_fc"])
@pytest.mark.parametrize("tower,crops,width,tokens", TOWERS,
                         ids=[f"{t}x{c}" for t, c, _, _ in TOWERS])
def test_the_tower_shapes_bit_for_bit(cuda, tower, crops, width, tokens, mult, bias, act):
    """Every N of a block (3W, W, 4W) at the towers' rows, bf16 out with a
    bf16 bias or none: the kernel equals the plain chain on the card bit for
    bit, one launch counted."""
    n = mult * width
    y = _product(crops * tokens, n, seed=n + crops, device=cuda)
    b = (_product(1, n, seed=n, device=cuda, scale=0.5)[0].to(BF16) if bias else None)
    before = build.launch_counts()["linear_epilogue"]
    got = le.linear_epilogue(y, b, act, BF16)
    assert build.launch_counts()["linear_epilogue"] == before + 1
    _same(got, le.linear_epilogue_plain(y, b, act, BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bias", [None, BF16, F32], ids=["no-bias", "bias-bf16", "bias-fp32"])
@pytest.mark.parametrize("rows,n", [(3152, 768), (333, 1001), (77, 770), (5, 7), (1, 1),
                                    (4112, 4096), (70001, 768)])
def test_ragged_widths_and_both_dtypes(cuda, rows, n, bias, dtype, act):
    """Widths that are no multiple of 8 (one column a thread) beside the
    vector path, bf16 and fp32 outputs, bf16 and fp32 biases, and more row
    blocks than a grid's 65535 (the kernel's row loop)."""
    y = _product(rows, n, seed=rows + n, device=cuda)
    b = None if bias is None else _product(1, n, seed=n, device=cuda, scale=0.5)[0].to(bias)
    _same(le.linear_epilogue(y, b, act, dtype), le.linear_epilogue_plain(y, b, act, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTS))
def test_unaligned_operands(cuda, act):
    """A product 4 bytes past a 16-byte boundary and a bias 2 bytes past one
    take the one-column kernel and agree."""
    y = _product(64, 768, seed=9, device=cuda)
    buf = torch.empty(64 * 768 + 1, device=cuda)
    shifted = buf[1:].view(64, 768)
    shifted.copy_(y)
    bbuf = torch.empty(769, dtype=BF16, device=cuda)
    b = bbuf[1:]
    b.copy_(_product(1, 768, seed=10, device=cuda)[0])
    assert le._linear_epilogue_operands(shifted, b, act, BF16)[2][-1] == 1
    _same(le.linear_epilogue(shifted, b, act, BF16), le.linear_epilogue_plain(y, b, act, BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("act", list(ACTS))
def test_every_bf16_value_as_the_pre_activation(cuda, act, dtype):
    """All 65,536 bf16 bit patterns (infinities and NaNs among them) as the
    product with no bias, so that the rounded value h the activation takes
    is each bf16 value once: the kernel's rounding rule equals the chain's
    for every input, not a sample."""
    h = torch.arange(-32768, 32768, dtype=torch.int32, device=cuda).to(torch.int16).view(BF16)
    y = h.float().reshape(256, 256).contiguous()
    _same(le.linear_epilogue(y, None, act, dtype), le.linear_epilogue_plain(y, None, act, dtype))


@pytest.mark.cuda
def test_a_non_contiguous_or_fp16_product_raises(cuda):
    y = _product(64, 96, seed=11, device=cuda)
    before = build.launch_counts()["linear_epilogue"]
    for bad in (y.t(), y[:, ::2], y.half()):
        with pytest.raises(ValueError, match="contiguous fp32 product"):
            le.linear_epilogue(bad, None, "gelu", BF16)
    assert build.launch_counts()["linear_epilogue"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("act", list(ACTS))
def test_the_layers_linear_on_the_card(cuda, act):
    """nn.layers.linear on bf16 CUDA operands: one K8 launch, the chain's
    output bit for bit; with an operand needing a gradient one K8 launch
    too, and the chain's gradients bit for bit."""
    x, w, b = _operands(197 * 4, 768, BF16, seed=12, device=cuda)
    before = build.launch_counts()["linear_epilogue"]
    got = layers.linear(x, w, b, act=ACTS[act])
    assert build.launch_counts()["linear_epilogue"] == before + 1
    _same(got, _chain(x, w, b, ACTS[act]))
    g = _product(197 * 4, 768, seed=13, device=cuda).to(BF16)

    def run(fn):
        ops = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*ops)
        return y, torch.autograd.grad(y, ops, g)

    before = build.launch_counts()["linear_epilogue"]
    y, grads = run(lambda x, w, b: layers.linear(x, w, b, act=ACTS[act]))
    assert build.launch_counts()["linear_epilogue"] == before + 1
    y_ref, grads_ref = run(lambda x, w, b: _chain(x, w, b, ACTS[act]))
    _same(y.detach(), y_ref.detach())
    for a, r in zip(grads, grads_ref):
        assert torch.equal(a, r)
