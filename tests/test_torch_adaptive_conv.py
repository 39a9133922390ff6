"""The port's adaptive-conv kernels K4a (bf16) and K4b (fp32): the plain
version against the TPU kernels it stands for (``adaptive_conv_pallas_v2`` and
``adaptive_conv_pallas_v5``, run in interpret mode on the CPU), the CUDA
kernels against the plain version (on a card only), and the wrapper's
refusals.

Inputs are made with numpy from a seed and fed to both sides; the taps are
normal-distributed, so that every tap counts. jax is imported inside the
tests that need it, so that on a card the CUDA tests run with

    python -m pytest tests/test_torch_adaptive_conv.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels.adaptive_conv import (_adaptive_conv_cuda, adaptive_conv_tapmajor,
                                               adaptive_conv_tapmajor_plain)

torch.set_num_threads(1)

# (b, c, h, w, d): tests/test_kernels.py:125 at d = 5, and d = 7 (jbu_stack)
SHAPES = [(2, 16, 21, 19, 5), (2, 16, 21, 19, 7)]


def _case(b, c, h, w, d, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, h + d - 1, w + d - 1).astype(np.float32),
            rng.randn(b, d * d, h, w).astype(np.float32))


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.fixture
def jnp():
    jax = pytest.importorskip("jax")
    return jax.numpy


@pytest.mark.parametrize("b,c,h,w,d", SHAPES)
def test_plain_matches_v2_fp32(jnp, b, c, h, w, d):
    """K4b's plain version vs adaptive_conv_pallas_v2: max|d|/max|ref| <= 1e-5
    (fp32 products, only the summation order differs)."""
    from rs_ov.kernels.adaptive_conv_v2 import adaptive_conv_pallas_v2

    inp, filt = _case(b, c, h, w, d)
    ref = np.asarray(adaptive_conv_pallas_v2(jnp.asarray(inp), jnp.asarray(filt), d,
                                             interpret=True))
    got = adaptive_conv_tapmajor(torch.from_numpy(inp), torch.from_numpy(filt), d).numpy()
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("b,c,h,w,d", SHAPES)
def test_plain_matches_v5_bf16(jnp, b, c, h, w, d):
    """K4a's plain version vs adaptive_conv_pallas_v5 on bf16 inputs: bf16
    products are exact in fp32 on both sides, so only the fp32 summation
    order differs, and that can flip the final bf16 rounding of an output.
    At most 2 outputs per case may differ, each by one bf16 step."""
    from rs_ov.kernels.adaptive_conv_v5 import adaptive_conv_pallas_v5

    inp, filt = _case(b, c, h, w, d, seed=8)
    ref = np.asarray(adaptive_conv_pallas_v5(jnp.asarray(inp, jnp.bfloat16),
                                             jnp.asarray(filt, jnp.bfloat16), d,
                                             interpret=True).astype(jnp.float32))
    got = adaptive_conv_tapmajor(torch.from_numpy(inp).bfloat16(),
                                 torch.from_numpy(filt).bfloat16(), d)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    diff = np.abs(got - ref)
    assert np.sum(diff > 0) <= 2
    assert np.all(diff <= np.abs(ref) * 2.0 ** -7)  # one bf16 step of the value


def test_cpu_tensors_take_the_plain_route():
    inp, filt = _case(1, 3, 5, 6, 3)
    before = dict(adaptive_conv_tapmajor.launches)
    for dt in (torch.float32, torch.bfloat16):
        out = adaptive_conv_tapmajor(torch.from_numpy(inp).to(dt), torch.from_numpy(filt).to(dt), 3)
        assert out.shape == (1, 3, 5, 6) and out.dtype == dt
    assert adaptive_conv_tapmajor.launches == before


def test_other_devices_raise():
    with pytest.raises(NotImplementedError, match="no route"):
        adaptive_conv_tapmajor(torch.empty(1, 2, 7, 7, device="meta"),
                               torch.empty(1, 9, 5, 5, device="meta"), 3)


@pytest.mark.parametrize("inp,filt,match", [
    (torch.randn(1, 2, 7, 7), torch.randn(1, 9, 5, 5, dtype=torch.bfloat16), "one dtype"),
    (torch.randn(1, 2, 7, 7, dtype=torch.float64),
     torch.randn(1, 9, 5, 5, dtype=torch.float64), "bf16 or fp32"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 9, 5, 6), "does not match"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 8, 5, 5), "does not match"),
    (torch.randn(1, 2, 7), torch.randn(1, 9, 5, 5), "4-D"),
    (torch.randn(1, 7, 7, 2).permute(0, 3, 1, 2), torch.randn(1, 9, 5, 5), "inp must be contiguous"),
    (torch.randn(1, 2, 7, 7), torch.randn(1, 5, 5, 9).permute(0, 3, 1, 2),
     "filt_t must be contiguous"),
    (torch.randn(1, 2, 7, 7, device="meta"), torch.randn(1, 9, 5, 5), "filt_t is on cpu"),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(inp, filt, match):
    """The checks run before the library is touched, so they hold here."""
    with pytest.raises(ValueError, match=match):
        _adaptive_conv_cuda(inp, filt, 3)


def test_cuda_wrapper_refuses_windows_over_the_shared_memory():
    for d, ok in ((25, True), (26, False)):
        inp, filt = torch.empty(1, 2, d + 1, d + 1), torch.empty(1, d * d, 2, 2)
        if ok:
            from rs_ov_torch.kernels.adaptive_conv import _check
            _check(inp, filt, d)
        else:
            with pytest.raises(ValueError, match="d <= 25"):
                _adaptive_conv_cuda(inp, filt, d)


# ---------------------------------------------------------------------------
# CUDA kernels vs the plain version (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the main path's shapes, a channel count that is not a multiple of the
# kernel's 64-channel tile, and a width over its 64-column tile
CUDA_SHAPES = SHAPES + [(2, 512, 56, 56, 11), (2, 512, 56, 56, 7), (1, 70, 9, 130, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,d", CUDA_SHAPES)
def test_k4b_matches_plain(cuda, b, c, h, w, d):
    inp, filt = (torch.from_numpy(a).to(cuda) for a in _case(b, c, h, w, d))
    n = adaptive_conv_tapmajor.launches[torch.float32]
    got = adaptive_conv_tapmajor(inp, filt, d)
    ref = adaptive_conv_tapmajor_plain(inp, filt, d)
    assert adaptive_conv_tapmajor.launches[torch.float32] == n + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,d", CUDA_SHAPES)
def test_k4a_matches_plain(cuda, b, c, h, w, d):
    """Within 1e-2 of max|ref|: one bf16 rounding flip of an output fits."""
    inp, filt = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _case(b, c, h, w, d))
    n = adaptive_conv_tapmajor.launches[torch.bfloat16]
    got = adaptive_conv_tapmajor(inp, filt, d).float()
    ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
    assert adaptive_conv_tapmajor.launches[torch.bfloat16] == n + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-2
