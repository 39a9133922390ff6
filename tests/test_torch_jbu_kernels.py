"""The port's JBU kernels: plain versions vs the JAX package (CPU), and the
CUDA kernels vs their plain versions (on a card only).

Inputs are made with numpy from a seed and fed to both sides. The JAX side is
the XLA composition each TPU kernel replaces (tests/test_kernels_epilogue.py),
run on the CPU. jax is imported inside those tests only, so that on a card
(where the port runs without jax) the CUDA tests run with

    python -m pytest tests/test_torch_jbu_kernels.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels.jbu_epilogue import (jbu_epilogue, jbu_epilogue_classify,
                                              jbu_epilogue_classify_plain,
                                              jbu_epilogue_plain)
from rs_ov_torch.kernels.range_logits import range_logits, range_logits_plain
from rs_ov_torch.upsample.jbu import _spatial_kernel

torch.set_num_threads(1)

SHAPES = [(5, 12, 16), (11, 13, 17)]  # (d, H, W): odd sizes and both radii in use


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _epilogue_case(d, h, w, seed, c=8, g=3, q=3):
    rng = np.random.RandomState(seed)
    dd = d * d
    return dict(
        logits=rng.randn(1, h, w, dd).astype(np.float32),
        guid=rng.randn(1, h, w, g).astype(np.float32),
        inp=rng.randn(1, h + d - 1, w + d - 1, c).astype(np.float32),
        w0=(rng.randn(dd, dd + g) * 0.2).astype(np.float32),
        b0=(rng.randn(dd) * 0.1).astype(np.float32),
        w1=(rng.randn(dd, dd) * 0.2).astype(np.float32),
        b1=(rng.randn(dd) * 0.1).astype(np.float32),
        fw=(rng.randn(c, c) * 0.2).astype(np.float32),
        fb=(rng.randn(c) * 0.1).astype(np.float32),
        qf=rng.randn(q, c).astype(np.float32))


@pytest.fixture
def jx():
    """(jax, jax.numpy, rs_ov.upsample.jbu), or a skip where jax is absent."""
    jax = pytest.importorskip("jax")
    from rs_ov.upsample import jbu

    return jax, jax.numpy, jbu


def _jax_epilogue(jx, case, d, dtype):
    """tests/test_kernels_epilogue.py:43-56, channel-first, -> NHWC fp32."""
    jax, jnp, jbu = jx
    logits = jnp.asarray(case["logits"]).transpose(0, 3, 1, 2)
    guidance = jnp.asarray(case["guid"], dtype).transpose(0, 3, 1, 2)
    inp = jnp.asarray(case["inp"], dtype).transpose(0, 3, 1, 2)
    w0, b0, w1, b1 = (jnp.asarray(case[k], dtype) for k in ("w0", "b0", "w1", "b1"))
    spatial = jbu._spatial_kernel(d, jnp.asarray(0.7, jnp.float32))
    rk = jax.nn.softmax(logits * jnp.float32(1.3), axis=1)
    combined = rk * spatial
    combined = combined / jnp.clip(jnp.sum(combined, axis=1, keepdims=True), 1e-7, None)
    x32 = jnp.concatenate([combined.astype(dtype), guidance], axis=1).astype(jnp.float32)
    mid = jax.nn.gelu(jnp.einsum("oc,bchw->bohw", w0.astype(jnp.float32), x32)
                      + b0.astype(jnp.float32)[None, :, None, None], approximate=False)
    fix = (jnp.einsum("oc,bchw->bohw", w1.astype(jnp.float32), mid)
           + b1.astype(jnp.float32)[None, :, None, None])
    combined = (combined + 0.1 * fix).astype(dtype)
    b, _, h, w = combined.shape
    filt = combined.transpose(0, 2, 3, 1).reshape(b, h, w, d, d)
    return jbu.adaptive_conv(inp, filt).transpose(0, 2, 3, 1)


def _torch_args(case, d, dtype):
    return (_t(case["inp"], dtype), _t(case["logits"]), _t(case["guid"], dtype),
            _spatial_kernel(d, torch.tensor(0.7)),
            torch.tensor(1.3), _t(case["w0"], dtype), _t(case["b0"], dtype),
            _t(case["w1"], dtype), _t(case["b1"], dtype))


@pytest.mark.parametrize("d,h,w", SHAPES)
def test_range_logits_plain_matches_jax(jx, d, h, w):
    """K1 plain vs the JAX shifted-sum formulation (rs_ov/upsample/jbu.py:177-179)."""
    jnp = jx[1]
    rng = np.random.RandomState(4)
    k = 8
    padded = rng.randn(2, k, h + d - 1, w + d - 1).astype(np.float32)
    proj = rng.randn(2, k, h, w).astype(np.float32)
    pj, qj = jnp.asarray(padded), jnp.asarray(proj)
    ref = np.asarray(jnp.stack([jnp.sum(pj[:, :, u:u + h, v:v + w] * qj, axis=1)
                                for u in range(d) for v in range(d)], axis=1))
    got = range_logits(_t(padded), _t(proj), d).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,w", SHAPES)
def test_jbu_epilogue_plain_matches_jax(jx, d, h, w, dtype):
    """K2 plain vs the XLA op chain it replaces: max|d|/max|ref| <= 1e-5 (the
    same casts on both sides; only fp32 summation order and the erf differ).

    In bf16 those last-bit differences can flip the bf16 rounding of a comb'
    tap or of an output (1 of 1768 outputs at d=11): at most 2 outputs per
    case may differ by up to 1e-3 of max|ref|, which bounds one flip
    (ulp(comb') * max|inp| or one output ulp). A cast put in the wrong place
    moves far more outputs than that."""
    case = _epilogue_case(d, h, w, seed=11)
    ref = np.asarray(_jax_epilogue(jx, case, d, jx[1].dtype(dtype)), np.float32)
    got = jbu_epilogue(*_torch_args(case, d, getattr(torch, dtype)), d).float().numpy()
    rel = np.abs(got - ref) / np.max(np.abs(ref))
    if dtype == "float32":
        assert rel.max() <= 1e-5
    else:
        assert np.sum(rel > 1e-5) <= 2 and rel.max() <= 1e-3


@pytest.mark.parametrize("d,h,w", SHAPES)
def test_jbu_epilogue_classify_plain_matches_jax(jx, d, h, w):
    """K3 plain vs tests/test_kernels_epilogue.py:72-87 (features -> final
    fixup -> L2 norm -> bf16 cosine), bf16, within 2e-2."""
    _, jnp, jbu = jx
    case = _epilogue_case(d, h, w, seed=13)
    bf = jnp.bfloat16
    feats = jbu._final_fixup_nhwc(_jax_epilogue(jx, case, d, bf),
                              {"w": jnp.asarray(case["fw"], bf), "b": jnp.asarray(case["fb"], bf)})
    f32 = feats.astype(jnp.float32)
    f32 = f32 / jnp.maximum(jnp.linalg.norm(f32, axis=-1, keepdims=True), 1e-12)
    qf = jnp.asarray(case["qf"])
    qf = qf / jnp.linalg.norm(qf, axis=-1, keepdims=True)
    want = np.asarray(jnp.einsum("bhwc,qc->bhwq", f32.astype(bf), qf.astype(bf),
                                 preferred_element_type=jnp.float32))
    got = jbu_epilogue_classify(*_torch_args(case, d, torch.bfloat16),
                                _t(case["fw"], torch.bfloat16), _t(case["fb"], torch.bfloat16),
                                torch.from_numpy(np.array(qf)), d).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w", SHAPES + [(11, 56, 56)])
def test_range_logits_kernel_matches_plain(cuda, d, h, w):
    rng = np.random.RandomState(5)
    padded = _t(rng.randn(2, 32, h + d - 1, w + d - 1)).to(cuda)
    proj = _t(rng.randn(2, 32, h, w)).to(cuda)
    got = range_logits(padded, proj, d)
    ref = range_logits_plain(padded, proj, d)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("d", [3, 7, 11, 17, 25])
def test_range_logits_kernel_at_its_edges(cuda, d, k, b):
    """Every diameter the JBU stages use and the limit 25, K below one
    channel group of 8, between groups and at the limit 32, on 13 x 19
    pixels (neither a multiple of the kernel's 2 x 32 tiles), B = 1 and 3;
    within 1e-5 of max|ref|."""
    rng = np.random.RandomState(6)
    padded = _t(rng.randn(b, k, 13 + d - 1, 19 + d - 1)).to(cuda)
    proj = _t(rng.randn(b, k, 13, 19)).to(cuda)
    got = range_logits(padded, proj, d)
    ref = range_logits_plain(padded, proj, d)
    assert got.shape == (b, d * d, 13, 19)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def _k1_operands(case):
    """(padded, proj, d) of a case the K1 kernel does not take."""
    t = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    return {
        "K past 32": (t(1, 33, 10, 10), t(1, 33, 6, 6), 5),
        "d past 25": (t(1, 4, 32, 32), t(1, 4, 6, 6), 27),
        "d of 0": (t(1, 4, 5, 5), t(1, 4, 6, 6), 0),
        "padded misshapen": (t(1, 4, 10, 11), t(1, 4, 6, 6), 5),
        "proj not 4-d": (t(1, 4, 10, 10), t(4, 6, 6), 5),
        "bf16 operand": (t(1, 4, 10, 10, dt=torch.bfloat16), t(1, 4, 6, 6), 5),
        "non-contiguous": (t(1, 4, 10, 10), t(1, 6, 6, 4).permute(0, 3, 1, 2), 5),
        "operands on two devices": (torch.empty(1, 4, 10, 10), t(1, 4, 6, 6), 5),
    }[case]


@pytest.mark.parametrize("case", ["K past 32", "d past 25", "d of 0", "padded misshapen",
                                  "proj not 4-d", "bf16 operand", "non-contiguous",
                                  "operands on two devices"])
def test_range_logits_kernel_refuses_what_it_does_not_take(case, monkeypatch):
    """K1's operand checks raise a ValueError before the kernel library loads:
    K past 32 (a pixel's projection is held in registers), d past 25 (the
    largest diameter the kernel is instantiated for) or under 1, a padded
    operand that does not match proj, an operand that is not contiguous fp32
    on proj's device."""
    from rs_ov_torch.kernels import build
    from rs_ov_torch.kernels import range_logits as mod

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(build, "load_library", no_library)
    with pytest.raises(ValueError, match="range_logits"):
        mod._range_logits_operands(*_k1_operands(case))


# (d, H, W, C, Q, seed): the earlier shapes, then the classify kernel's tile
# edges: every d from 3 to its limit 17, H not a multiple of the block's 2
# rows, W not a multiple of its 16 columns, C = 72 (not a multiple of 16) and
# 512, Q = 1, 13 and its limit 128; last, a seed at which the plain version
# as cuBLAS sums it lies ~3e-3 from the kernel at C = 72
EPILOGUE_CASES = ([(d, h, w, 64, 5, 17) for d, h, w in SHAPES + [(11, 28, 28)]]
                  + [(d, 13, 19, c, q, 17) for d in (3, 7, 11, 17) for c in (72, 512)
                     for q in (1, 13, 128)]
                  + [(17, 13, 19, 72, 128, 1)]
                  + [(d, 13, 19, 768, 8, 17) for d in (7, 11)])  # ViT-L/14's width


def _matmul_in_order(x, wt):
    """x [..., K] @ wt [K, N] in fp32 with the sum over k taken in order, one
    rounding per step (each fma held exactly in fp64): the order in which
    the classify kernel re-takes a sum near a bf16 rounding midpoint."""
    x2 = x.reshape(-1, x.shape[-1])
    acc = torch.zeros((x2.shape[0], wt.shape[1]), dtype=torch.float64, device=x.device)
    for k in range(x2.shape[1]):
        acc = (acc + x2[:, k:k + 1].double() * wt[k].double()).float().double()
    return acc.float().reshape(*x.shape[:-1], wt.shape[1])


def _classify_plain_in_order(*args):
    """jbu_epilogue_classify_plain with every fp32 product summed in order
    (its adaptive conv is a loop over the taps in order already)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul", _matmul_in_order)
        return jbu_epilogue_classify_plain(*args)


def _held_in_order(label, got, args):
    """max|got - ref| / max|ref| against the in-order plain version ref, and
    against the plain version as the card's library sums it, printed."""
    ref, ref_lib = _classify_plain_in_order(*args), jbu_epilogue_classify_plain(*args)
    scale = ref.abs().max().item()
    rel = (got - ref).abs().max().item() / scale
    print(f"K3 {label}: {rel:.3e} of max|ref| from the plain version summed in order, "
          f"{(got - ref_lib).abs().max().item() / scale:.3e} from it as the library sums "
          f"it; the two plain versions {(ref - ref_lib).abs().max().item() / scale:.3e} apart")
    return rel


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,c,q,seed", EPILOGUE_CASES)
def test_jbu_epilogue_kernels_match_plain(cuda, d, h, w, c, q, seed):
    """K2 within 1e-2 of max|ref| (a bf16 rounding flip of comb' is allowed;
    y rounds as the tap-ordered sum does), with the count of its outputs
    that differ from the plain version printed; K3 within 1e-3 of max|ref|
    of the plain version with
    its fp32 products summed in order: a few bf16 rounding flips fit, while
    leaving out the fixup product (1.5e-1), its bias (1.8e-2) or the bf16
    rounding of the normalised vector (1.7e-3) at the first cases' inputs
    does not. The plain version's library products (cuBLAS on the card)
    choose their order by size, and their own bf16 rounding flips alone can
    reach 1e-3; that gap is printed beside."""
    case = _epilogue_case(d, h, w, seed=seed, c=c, q=q)
    args = [a.to(cuda) for a in _torch_args(case, d, torch.bfloat16)]
    got = jbu_epilogue(*args, d).float()
    ref = jbu_epilogue_plain(*args, d).float()
    print(f"K2 d={d} {h}x{w} C={c} seed={seed}: {int((got != ref).sum())} of {ref.numel()} "
          f"outputs differ from the plain version")
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-2
    tail = (_t(case["fw"], torch.bfloat16).to(cuda),
            _t(case["fb"], torch.bfloat16).to(cuda),
            torch.nn.functional.normalize(_t(case["qf"]), dim=-1).to(cuda))
    got = jbu_epilogue_classify(*args, *tail, d)
    assert tuple(got.shape) == (1, h, w, q)
    label = f"d={d} {h}x{w} C={c} Q={q} seed={seed}"
    assert _held_in_order(label, got, (*args, *tail, d)) <= 1e-3


def _bf16_above(x):
    """The bf16 value next above each of the bf16 values x (all > 0)."""
    return (x.view(torch.int16) + 1).view(torch.bfloat16)


def _midpoint_case(d, h, w, c, q, cuda):
    """Operands on which every conv sum y and every fixup sum t of the
    classify kernel lands near a bf16 rounding midpoint, so that each block
    queues more repairs than it holds and re-takes all of them in order:
    comb' is 0.5 at taps (0, 0) and (0, 2) and 0 elsewhere, the source
    alternates between two neighbouring bf16 values every two columns (so y
    is their midpoint), and the fixup bias puts (y Wf^T + bf) * 0.1 within a
    few fp32 ulps of a midpoint, the product's weight being tiny."""
    rng = np.random.RandomState(23)
    dd = d * d
    logits = np.full((1, h, w, dd), -50.0, np.float32)
    logits[..., [0, 2]] = 50.0
    lo = torch.from_numpy(rng.uniform(0.5, 1.0, c).astype(np.float32)).to(torch.bfloat16)
    cols = torch.arange(w + d - 1) // 2 % 2 == 1
    inp = torch.where(cols[:, None], _bf16_above(lo), lo).expand(1, h + d - 1, w + d - 1, c)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], c).astype(np.float32))
    mid = sign * (1 + (2 * torch.from_numpy(rng.randint(0, 64, c)).float() + 1) / 256)
    fb = mid / 0.1  # fb * 0.1 within an ulp or two of the midpoint
    zeros = [torch.zeros(s) for s in ((dd, dd + 3), (dd,), (dd, dd), (dd,))]
    args = (inp.contiguous(), torch.from_numpy(logits),
            torch.from_numpy(rng.randn(1, h, w, 3)).to(torch.bfloat16),
            _spatial_kernel(d, torch.tensor(0.7)), torch.tensor(1.3), *zeros,
            torch.from_numpy(rng.randn(c, c) * 1e-7).to(torch.bfloat16), fb,
            torch.nn.functional.normalize(torch.from_numpy(rng.randn(q, c)).float(), dim=-1))
    return [a.to(cuda) for a in args] + [d]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [72, 512, 768])
def test_classify_kernel_repairs_every_sum_past_its_queue(cuda, c):
    """Every sum of both rounded products near a midpoint (checked on the
    plain version's y): the kernel's repair queue overflows in the conv and in
    the fixup product, so a block takes all of its sums again in order (at
    C = 72 the 1 x 4 pixel block at the corner queues them instead), and the
    result holds within 1e-3 of max|ref| of the in-order plain version, on
    blocks cut by the image's edges (5 x 20 pixels). K2's conv shares the
    repair: on the same operands (comb' exact: 0.5 at two taps) it re-takes
    every y in tap order and equals its plain version."""
    from rs_ov_torch.kernels.jbu_epilogue import _adaptive_conv_nhwc, _comb_fixed

    args = _midpoint_case(3, 5, 20, c, 5, cuda)
    comb = _comb_fixed(*args[1:9], torch.bfloat16)
    y = _adaptive_conv_nhwc(args[0], comb, 3)
    assert bool(((y.view(torch.int32) & 0xffff) == 0x8000).all())  # every y a midpoint
    got = jbu_epilogue_classify(*args)
    assert _held_in_order(f"every sum repaired C={c}", got, args) <= 1e-3
    assert torch.equal(jbu_epilogue(*args[:9], 3), jbu_epilogue_plain(*args[:9], 3))


@pytest.mark.parametrize("c,d", [(64, 19), (64, 18), (63, 5)])
def test_epilogue_kernel_refuses_what_it_does_not_take(c, d):
    """K2's operand checks raise, before the kernel library loads, for d > 17
    (the band of 16 + d - 1 columns no longer fits 32, the TPU kernel's
    limit) and an odd channel count."""
    from rs_ov_torch.kernels.jbu_epilogue import _epilogue_operands

    case = _epilogue_case(d, 3, 4, seed=19, c=c)
    with pytest.raises(ValueError, match="d <= 17|even channel"):
        _epilogue_operands(*_torch_args(case, d, torch.bfloat16), d)


@pytest.mark.parametrize("c,d,q", [(64, 5, 129), (64, 19, 5), (63, 5, 5), (64, 5, 0)])
def test_classify_kernel_refuses_what_it_does_not_take(c, d, q):
    """The classify kernel's operand checks raise, before the kernel library
    loads, for Q > 128 (or none), d > 17 and an odd channel count."""
    from rs_ov_torch.kernels.jbu_epilogue import _classify_operands

    case = _epilogue_case(d, 3, 4, seed=19, c=c, q=max(q, 1))
    qf = _t(case["qf"])[:q]
    with pytest.raises(ValueError):
        _classify_operands(*_torch_args(case, d, torch.bfloat16),
                           _t(case["fw"], torch.bfloat16),
                           _t(case["fb"], torch.bfloat16), qf, d)
