"""K4e/K4f (adaptive_conv_v3 / _v4, both operands rounded to bf16): the
port's plain version against the JAX package's Pallas kernels in interpret
mode, and on a card the CUDA kernels against the plain version. jax is
imported inside the tests that need it, so that on a card the CUDA tests run
with

    python -m pytest tests/test_torch_adaptive_bf16.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels import adaptive_conv as ac

torch.set_num_threads(1)

OPERANDS = {"fp32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
            "bf16 inp, fp32 taps": (torch.bfloat16, torch.float32)}


@pytest.fixture
def pallas():
    """(adaptive_conv_pallas_v3, adaptive_conv_pallas_v4, jax.numpy)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rs_ov.kernels.adaptive_conv_v3 import adaptive_conv_pallas_v3
    from rs_ov.kernels.adaptive_conv_v4 import adaptive_conv_pallas_v4

    return adaptive_conv_pallas_v3, adaptive_conv_pallas_v4, jnp


def _operands(shape, seed):
    b, c, h, w, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, h + d - 1, w + d - 1).astype(np.float32),
            rng.randn(b, d * d, h, w).astype(np.float32))


def _check_against_jax(jnp, jax_fn, port_fn, shape, operands, seed):
    """The port against the JAX kernel on the same operands: fp32 output
    within 1e-5 of max|ref| (only the summation order differs), bf16 output
    within 1e-2 with at most 0.5% of outputs different. Returns the fp32
    operands and max|ref| for further checks."""
    d = shape[-1]
    inp, filt = _operands(shape, seed)
    ti, tf = (torch.from_numpy(x).to(dt) for x, dt in zip((inp, filt), OPERANDS[operands]))
    ji, jf = (getattr(jnp, str(t.dtype)[6:]) for t in (ti, tf))
    ref = np.asarray(jax_fn(jnp.asarray(inp, ji), jnp.asarray(filt, jf), d,
                            interpret=True)).astype(np.float32)
    out = port_fn(ti, tf, d)
    assert out.dtype == ti.dtype and tuple(out.shape) == ref.shape
    got = out.float().numpy()
    scale = np.abs(ref).max()
    rel = np.abs(got - ref).max() / scale
    if ti.dtype == torch.float32:
        assert rel <= 1e-5, rel
    else:
        assert rel <= 1e-2, rel
        assert (got != ref).mean() <= 5e-3
    return ti, tf, ref, scale


def _rounding_matters(ti, tf, ref, scale, d):
    """K4b's unrounded function on the same fp32 operands lies far off."""
    k4b = ac.adaptive_conv_tapmajor_plain(ti, tf, d).numpy()
    assert np.abs(k4b - ref).max() / scale > 1e-4


# Each JAX interpret run compiles its kernel body for seconds (K4f's at two
# chunks for ~30 s), so K4f's operand pairings beyond one are left to K4e,
# whose rounding code is the same function
@pytest.mark.parametrize("entry,operands", [("v3", "fp32"), ("v3", "bf16"),
                                            ("v3", "bf16 inp, fp32 taps"),
                                            ("v4", "bf16 inp, fp32 taps")])
def test_plain_matches_the_jax_kernel(pallas, entry, operands):
    """B=2, C=16, H=21, W=19, d=5 (one column chunk); the CPU route is the
    plain version and launches nothing."""
    v3, v4, jnp = pallas
    jax_fn = v3 if entry == "v3" else v4
    port_fn = ac.adaptive_conv_v3 if entry == "v3" else ac.adaptive_conv_v4
    before = port_fn.launches
    checked = _check_against_jax(jnp, jax_fn, port_fn, (2, 16, 21, 19, 5), operands, 5)
    assert port_fn.launches == before
    if operands == "fp32":
        _rounding_matters(*checked, 5)


def test_v4_two_column_chunks_match_the_jax_kernel(pallas):
    """W = 117 gives K4f two chunks of 112 columns (pad8(117) = 120)."""
    assert ac.v4_chunk(117) == 112 and ac.v4_chunk(19) == 24
    _, v4, jnp = pallas
    checked = _check_against_jax(jnp, v4, ac.adaptive_conv_v4,
                                 (1, 8, 4, 117, 3), "fp32", 6)
    _rounding_matters(*checked, 3)


def test_plain_rounds_each_operand_once():
    """The plain version against a float64 sum of the bf16-rounded operands:
    an fp32 input keeps an fp32 output, within fp32 summation error."""
    g = torch.Generator().manual_seed(0)
    inp = torch.randn(1, 4, 9, 10, generator=g)
    filt = torch.randn(1, 9, 7, 8, generator=g)
    x, f = inp.bfloat16().double(), filt.bfloat16().double()
    want = sum(f[:, u * 3 + v:u * 3 + v + 1] * x[:, :, u:u + 7, v:v + 8]
               for u in range(3) for v in range(3))
    got = ac.adaptive_conv_bf16_plain(inp, filt, 3)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    assert (ac.adaptive_conv_bf16_plain(inp.bfloat16(), filt, 3).dtype == torch.bfloat16)


def test_v4_refuses_wide_windows():
    inp, filt = torch.zeros(1, 2, 20, 20), torch.zeros(1, 19 * 19, 2, 2)
    with pytest.raises(ValueError, match="d <= 17"):
        ac.adaptive_conv_v4(inp, filt, 19)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks run before the library is touched, so they hold here."""
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ac._adaptive_conv_bf16_cuda("rs_adaptive_conv_v3", torch.zeros(1, 2, 7, 7, dtype=torch.float64),
                                    torch.zeros(1, 9, 5, 5), 3, 32)
    with pytest.raises(ValueError, match="does not match"):
        ac._adaptive_conv_bf16_cuda("rs_adaptive_conv_v3", torch.zeros(1, 2, 7, 7),
                                    torch.zeros(1, 9, 5, 4), 3, 32)
    with pytest.raises(ValueError, match="shared memory"):
        ac._adaptive_conv_bf16_cuda("rs_adaptive_conv_v4", torch.zeros(1, 2, 100, 100),
                                    torch.zeros(1, 41 * 41, 60, 60), 41, 112)


@pytest.mark.cuda
@pytest.mark.parametrize("d,hw", [(11, 56), (11, 28), (7, 224), (17, 40), (5, 117)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
def test_kernels_match_the_plain_version_on_the_card(d, hw, dtypes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4e/K4f have no CPU mode")
    rng = np.random.RandomState(d * hw)
    inp = torch.from_numpy(rng.randn(2, 64, hw + d - 1, hw + d - 1).astype(np.float32))
    filt = torch.from_numpy(rng.randn(2, d * d, hw, hw).astype(np.float32))
    inp, filt = inp.cuda().to(dtypes[0]), filt.cuda().to(dtypes[1])
    ref = ac.adaptive_conv_bf16_plain(inp, filt, d).float()
    for fn in (ac.adaptive_conv_v3, ac.adaptive_conv_v4):
        before = fn.launches
        got = fn(inp, filt, d)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and got.dtype == inp.dtype
        rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-5 if dtypes[0] == torch.float32 else 1e-2), (fn.__name__, rel)
