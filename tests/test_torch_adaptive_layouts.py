"""The port's adaptive-conv entry points K4c (``adaptive_conv_planes``) and
K4d (``adaptive_conv_cl``): the plain version against the TPU kernels they
stand for (``adaptive_conv_pallas_planes`` and ``adaptive_conv_pallas_cl``,
run in interpret mode on the CPU), the wrappers' refusals, and the CUDA
kernels against the plain version (on a card only).

Each operand keeps its own dtype: the JAX kernels take fp32 taps with a bf16
input and never round them. Inputs are made with numpy from a seed. jax is
imported inside the tests that need it, so that on a card the CUDA tests run
with

    python -m pytest tests/test_torch_adaptive_layouts.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels.adaptive_conv import (_adaptive_conv_cl_cuda,
                                               _adaptive_conv_planes_cuda, adaptive_conv_cl,
                                               adaptive_conv_planes,
                                               adaptive_conv_tapmajor_plain)

torch.set_num_threads(1)


def _case(b, c, h, w, d, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, h + d - 1, w + d - 1).astype(np.float32),
            rng.randn(b, d * d, h, w).astype(np.float32))


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.fixture
def pallas():
    jax = pytest.importorskip("jax")
    from rs_ov.kernels.adaptive_conv import adaptive_conv_pallas_cl, adaptive_conv_pallas_planes

    return jax.numpy, {"planes": adaptive_conv_pallas_planes, "cl": adaptive_conv_pallas_cl}


ENTRIES = {"planes": adaptive_conv_planes, "cl": adaptive_conv_cl}


@pytest.mark.parametrize("c", [128, 16])  # the cl kernel, and its hand-off to planes
@pytest.mark.parametrize("entry", ["planes", "cl"])
def test_plain_matches_the_tpu_kernels_fp32(pallas, entry, c):
    """max|d|/max|ref| <= 1e-5: fp32 products on both sides, only the
    summation order differs."""
    jnp, fns = pallas
    d = 5
    inp, filt = _case(2, c, 9, 11, d)
    ref = np.asarray(fns[entry](jnp.asarray(inp), jnp.asarray(filt), d, interpret=True))
    got = ENTRIES[entry](torch.from_numpy(inp), torch.from_numpy(filt), d)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("entry", ["planes", "cl"])
def test_plain_matches_the_tpu_kernels_bf16_input_fp32_taps(pallas, entry):
    """A bf16 input with fp32 taps, the taps never rounded: bf16 x fp32
    products differ only by the fp32 summation order, which can flip the
    output's bf16 rounding. At most 2 outputs may differ, each by one bf16
    step of the value."""
    jnp, fns = pallas
    d = 7
    inp, filt = _case(2, 128, 8, 10, d, seed=4)
    ref = np.asarray(fns[entry](jnp.asarray(inp, jnp.bfloat16), jnp.asarray(filt), d,
                                interpret=True).astype(jnp.float32))
    got = ENTRIES[entry](torch.from_numpy(inp).bfloat16(), torch.from_numpy(filt), d)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    assert np.sum(diff > 0) <= 2
    assert np.all(diff <= np.abs(ref) * 2.0 ** -7)
    # rounding the taps to bf16 first, as K4a's caller does, is another function
    rounded = ENTRIES[entry](torch.from_numpy(inp).bfloat16(),
                             torch.from_numpy(filt).bfloat16(), d).float().numpy()
    assert np.sum(np.abs(rounded - ref) > np.abs(ref) * 2.0 ** -7) > 100


def test_cpu_tensors_take_the_plain_route():
    inp, filt = _case(1, 4, 5, 6, 3)
    before = (adaptive_conv_planes.launches, adaptive_conv_cl.launches)
    for fn in ENTRIES.values():
        for dt_in, dt_f in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            x, f = torch.from_numpy(inp).to(dt_in), torch.from_numpy(filt).to(dt_f)
            out = fn(x, f, 3)
            assert out.shape == (1, 4, 5, 6) and out.dtype == dt_in
            torch.testing.assert_close(out, adaptive_conv_tapmajor_plain(x, f, 3), rtol=0, atol=0)
    assert (adaptive_conv_planes.launches, adaptive_conv_cl.launches) == before


@pytest.mark.parametrize("fn", [adaptive_conv_planes, adaptive_conv_cl])
def test_other_devices_raise(fn):
    with pytest.raises(NotImplementedError, match="no route"):
        fn(torch.empty(1, 2, 7, 7, device="meta"), torch.empty(1, 9, 5, 5, device="meta"), 3)


@pytest.mark.parametrize("inp,filt,match", [
    (torch.randn(1, 2, 7, 7, dtype=torch.float64), torch.randn(1, 9, 5, 5),
     "bf16 or fp32 for each operand"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 9, 5, 5, dtype=torch.float16),
     "bf16 or fp32 for each operand"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 9, 5, 6), "does not match"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 8, 5, 5), "does not match"),
    (torch.randn(1, 2, 7), torch.randn(1, 9, 5, 5), "4-D"),
    (torch.randn(1, 7, 7, 2).permute(0, 3, 1, 2), torch.randn(1, 9, 5, 5), "inp must be contiguous"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 5, 5, 9).permute(0, 3, 1, 2),
     "filt_t must be contiguous"),
    (torch.randn(1, 2, 7, 7, device="meta"), torch.randn(1, 9, 5, 5), "filt_t is on cpu"),
])
@pytest.mark.parametrize("cuda_fn", [_adaptive_conv_planes_cuda, _adaptive_conv_cl_cuda])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_fn, inp, filt, match):
    """The checks run before the library is touched, so they hold here. The
    operands may differ in dtype (bf16 / fp32 each)."""
    with pytest.raises(ValueError, match=match):
        cuda_fn(inp, filt, 3)


def test_cuda_wrappers_refuse_what_does_not_fit():
    with pytest.raises(ValueError, match="even channel count"):
        _adaptive_conv_cl_cuda(torch.randn(1, 3, 7, 7), torch.randn(1, 9, 5, 5), 3)
    # K4c stages 32 x (8+d-1) x (32+d-1) fp32: d = 25 fits the 227 KB, 26 does not
    big = (torch.empty(1, 2, 27, 27), torch.empty(1, 26 * 26, 2, 2))
    with pytest.raises(ValueError, match="240768 bytes of shared memory"):
        _adaptive_conv_planes_cuda(*big, 26)
    with pytest.raises(ValueError, match="shared memory"):
        _adaptive_conv_cl_cuda(torch.empty(1, 2, 62, 62), torch.empty(1, 61 * 61, 2, 2), 61)


# ---------------------------------------------------------------------------
# CUDA kernels vs the plain version (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the main path's shapes, small odd ones, a channel count off every tile
# (K4c's 32, K4d's pairs need it even) and a width over both column tiles
CUDA_SHAPES = [(2, 16, 21, 19, 5), (2, 512, 56, 56, 11), (2, 512, 28, 28, 11),
               (2, 96, 56, 56, 7), (1, 70, 9, 130, 7)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
@pytest.mark.parametrize("b,c,h,w,d", CUDA_SHAPES)
@pytest.mark.parametrize("entry", ["planes", "cl"])
def test_kernel_matches_plain(cuda, entry, b, c, h, w, d, dtypes):
    """fp32 input within 1e-5 of max|ref|; bf16 input within 1e-2 (one bf16
    rounding flip of an output fits)."""
    fn = ENTRIES[entry]
    inp, filt = _case(b, c, h, w, d)
    inp = torch.from_numpy(inp).to(cuda, dtypes[0])
    filt = torch.from_numpy(filt).to(cuda, dtypes[1])
    n = fn.launches
    got = fn(inp, filt, d)
    ref = adaptive_conv_tapmajor_plain(inp, filt, d)
    assert fn.launches == n + 1 and got.dtype == inp.dtype
    tol = 1e-5 if dtypes[0] == torch.float32 else 1e-2
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol
