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

from rs_ov_torch.kernels import adaptive_conv as ac
from rs_ov_torch.kernels import build
from rs_ov_torch.kernels.adaptive_conv import (_adaptive_conv_operands, adaptive_conv_tapmajor,
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
    before = build.launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        out = adaptive_conv_tapmajor(torch.from_numpy(inp).to(dt), torch.from_numpy(filt).to(dt), 3)
        assert out.shape == (1, 3, 5, 6) and out.dtype == dt
    assert build.launch_counts() == before


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
    """The operand checks run before the library is touched, so they hold here."""
    with pytest.raises(ValueError, match=match):
        _adaptive_conv_operands(inp, filt, 3)


def test_cuda_wrapper_refuses_windows_over_the_shared_memory():
    for d, ok in ((25, True), (26, False)):
        inp, filt = torch.empty(1, 2, d + 1, d + 1), torch.empty(1, d * d, 2, 2)
        if ok:
            from rs_ov_torch.kernels.adaptive_conv import _check
            _check(inp, filt, d)
        else:
            with pytest.raises(ValueError, match="d <= 25"):
                _adaptive_conv_operands(inp, filt, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_tiling_fits_every_shape_the_kernel_takes(dtype):
    """Every d <= 25 and C gets a tiling the kernel has (R, channels per
    warp) whose block fits in shared memory, with no warp's channels wholly
    past C where a smaller tiling exists."""
    for d in range(1, ac.MAX_D + 1):
        for c in (1, 2, 64, 72, 512, 514):
            rows, cw = ac._tiling(2, c, 13, 21, d, dtype, 132)
            assert rows in ac.ROWS and cw in ac.WARP_CHANNELS
            assert ac._smem_bytes(d, rows, cw, dtype) <= ac.SMEM_MAX
            assert cw == 16 or cw * (8 // rows) < 2 * c


@pytest.mark.parametrize("dtype,hw,want", [
    (torch.bfloat16, 56, (8, 128)), (torch.bfloat16, 28, (2, 32)),
    (torch.float32, 56, (4, 32)), (torch.float32, 28, (4, 32))])
def test_tiling_at_the_main_paths_shapes(dtype, hw, want):
    """The main path's stages (B=2, C=512, d=11) take the sweep's fastest
    tilings (PERF.md) on a 132-SM card; bf16 at 28^2 leaves R=8's 64 blocks
    for R=2's 224."""
    assert ac._tiling(2, 512, hw, hw, 11, dtype, 132) == want
    assert ac._blocks(2, 512, 28, 28, 8, 128) == 64 and ac._blocks(2, 512, 28, 28, 2, 32) == 224


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
    n = build.launch_counts()["adaptive_conv_tapmajor.f32"]
    got = adaptive_conv_tapmajor(inp, filt, d)
    ref = adaptive_conv_tapmajor_plain(inp, filt, d)
    assert build.launch_counts()["adaptive_conv_tapmajor.f32"] == n + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,d", CUDA_SHAPES)
def test_k4a_matches_plain(cuda, b, c, h, w, d):
    """Within 1e-2 of max|ref|: one bf16 rounding flip of an output fits."""
    inp, filt = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _case(b, c, h, w, d))
    n = build.launch_counts()["adaptive_conv_tapmajor.bf16"]
    got = adaptive_conv_tapmajor(inp, filt, d).float()
    ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
    assert build.launch_counts()["adaptive_conv_tapmajor.bf16"] == n + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-2


# d from 3 to 25 (past 17 the band is wider than 32 columns), channel counts that
# are a multiple of 64, of neither 8 nor 64, and of 8 but not 64; odd H, W
# not a multiple of 16: odd W gives bf16 rows and taps of odd width, which
# take element-wise copies, W = 30 4-byte ones
EDGE_SHAPES = [(b, c, h, w, d) for d in (3, 7, 11, 17, 25)
               for b, c, h, w in ((1, 64, 13, 21), (2, 512, 9, 30), (1, 514, 11, 19),
                                  (2, 72, 7, 45))]


def _dropped_last_tap(filt):
    filt = filt.clone()
    filt[:, -1] = 0
    return filt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["k4a", "k4b"])
@pytest.mark.parametrize("b,c,h,w,d", EDGE_SHAPES)
def test_kernel_at_edge_shapes(cuda, dtype, b, c, h, w, d):
    """K4a within 1e-2, K4b within 1e-5 of max|ref| against the plain
    version; the plain version with its last tap dropped lands above the
    bound on the same inputs."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    inp, filt = (torch.from_numpy(a).to(cuda, dtype) for a in _case(b, c, h, w, d, seed=d + c))
    got = adaptive_conv_tapmajor(inp, filt, d).float()
    ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
    bad = adaptive_conv_tapmajor_plain(inp, _dropped_last_tap(filt), d).float()
    scale = ref.abs().max().item()
    assert ((got - ref).abs().max() / scale).item() <= tol
    assert ((bad - ref).abs().max() / scale).item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["k4a", "k4b"])
def test_kernel_at_every_tiling(cuda, dtype):
    """Every (R, channels per warp) the library takes, at an odd shape and at
    d = 11 and 25, through the bare call."""
    from rs_ov_torch.kernels.build import load_library

    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for d in (11, 25):
        inp, filt = (torch.from_numpy(a).to(cuda, dtype) for a in _case(2, 150, 11, 37, d))
        ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
        for rows in ac.ROWS:
            for cw in ac.WARP_CHANNELS:
                if ac._smem_bytes(d, rows, cw, dtype) > ac.SMEM_MAX:
                    continue
                out, entry, args, _keep = ac._adaptive_conv_operands(inp, filt, d, (rows, cw))
                fn = getattr(load_library(), entry)
                assert fn(*args, torch.cuda.current_stream().cuda_stream) == 0
                rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                assert rel <= tol, (d, rows, cw, rel)


@pytest.mark.cuda
def test_smem_mirror_matches_the_library(cuda):
    """_smem_bytes, which the wrapper checks before the library loads,
    equals the library's own count (rs_adaptive_conv_smem)."""
    from rs_ov_torch.kernels.build import load_library

    lib = load_library()
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        for d in (1, 3, 7, 11, 17, 18, 25):
            for rows in ac.ROWS:
                for cw in ac.WARP_CHANNELS:
                    assert ac._smem_bytes(d, rows, cw, dtype) == \
                        lib.rs_adaptive_conv_smem(d, rows, cw, size, size, 0, 0), \
                        (dtype, d, rows, cw)
