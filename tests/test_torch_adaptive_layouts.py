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

from rs_ov_torch.kernels import adaptive_conv as ac
from rs_ov_torch.kernels import build
from rs_ov_torch.kernels.adaptive_conv import (_layout_operands, adaptive_conv_cl,
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
    before = build.launch_counts()
    for fn in ENTRIES.values():
        for dt_in, dt_f in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            x, f = torch.from_numpy(inp).to(dt_in), torch.from_numpy(filt).to(dt_f)
            out = fn(x, f, 3)
            assert out.shape == (1, 4, 5, 6) and out.dtype == dt_in
            torch.testing.assert_close(out, adaptive_conv_tapmajor_plain(x, f, 3), rtol=0, atol=0)
    assert build.launch_counts() == before


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
@pytest.mark.parametrize("cuda_fn", [adaptive_conv_planes.operands, adaptive_conv_cl.operands],
                         ids=list(ENTRIES))
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_fn, inp, filt, match):
    """K4c's and K4d's operand checks run before the library is touched, so
    they hold here. The operands may differ in dtype (bf16 / fp32 each)."""
    with pytest.raises(ValueError, match=match):
        cuda_fn(inp, filt, 3)


def test_cuda_wrappers_refuse_what_does_not_fit():
    """K4d takes even C only; both take d <= 25, the banded kernel's widest
    band (the fp32-core kernels refused by their blocks' bytes instead)."""
    with pytest.raises(ValueError, match="even channel count"):
        _layout_operands(torch.randn(1, 3, 7, 7), torch.randn(1, 9, 5, 5), 3, True)
    big = (torch.empty(1, 2, 27, 27), torch.empty(1, 26 * 26, 2, 2))
    with pytest.raises(ValueError, match="d <= 25"):
        _layout_operands(*big, 26, False)
    with pytest.raises(ValueError, match="d <= 25"):
        _layout_operands(torch.empty(1, 2, 62, 62), torch.empty(1, 61 * 61, 2, 2), 61, True)


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]
LAYOUTS = {"planes": False, "cl": True}


@pytest.mark.parametrize("entry", ["planes", "cl"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
def test_tiling_fits_every_shape_the_kernels_take(dtypes, entry):
    """Every d <= 25 and C gets a tiling the kernel has (R, channels per
    warp) whose block fits in shared memory in the operand pair's layout,
    with no warp's channels wholly past C where a smaller tiling exists."""
    for d in range(1, ac.MAX_D + 1):
        for c in (2, 64, 72, 512, 514):
            rows, cw = ac._tiling(2, c, 13, 21, d, dtypes[0], 132, dtypes[1], LAYOUTS[entry])
            assert rows in ac.ROWS and cw in ac.WARP_CHANNELS
            assert ac._smem_bytes(d, rows, cw, *dtypes, LAYOUTS[entry]) <= ac.SMEM_MAX
            assert cw == 16 or cw * (8 // rows) < 2 * c


@pytest.mark.parametrize("entry,dtypes,tiling,want", [
    # channel-first, d = 11: taps [121][R*16 + 8] in the taps' type, rounded to
    # 128 B; the bf16 product rings 4 rows [CB][32 + 8] bf16; the TF32 one 3
    # rows [CB][32 + 16 B] and 2 steps of parts [CB][36] words (hi, lo for an
    # fp32 input); the output stage [8 warps][CW][16 + 16 B] where larger
    ("planes", (torch.float32, torch.float32), (4, 32), 34944 + 3 * 9216 + 4 * 9216),
    ("planes", (torch.bfloat16, torch.float32), (4, 32), 34944 + 3 * 5120 + 2 * 9216),
    ("planes", (torch.float32, torch.bfloat16), (4, 32), 17536 + 3 * 9216 + 4 * 9216),
    ("planes", (torch.bfloat16, torch.bfloat16), (8, 128), 33024 + 49152),
    # channels-last: rows [32 x][CB + 16 B], parts [32 x][CB + 8] words
    ("cl", (torch.float32, torch.float32), (4, 32), 34944 + 3 * 8704 + 4 * 9216),
    ("cl", (torch.bfloat16, torch.float32), (4, 32), 34944 + 3 * 4608 + 2 * 9216),
    ("cl", (torch.float32, torch.bfloat16), (4, 32), 17536 + 3 * 8704 + 4 * 9216),
    ("cl", (torch.bfloat16, torch.bfloat16), (8, 128), 33024 + 49152),
])
def test_smem_bytes_count_the_layouts(entry, dtypes, tiling, want):
    """_smem_bytes at the main path's d = 11, counted by hand from the C
    layout (csrc/adaptive_conv.cuh, make_layout); the fp32 pair's
    channel-first count is K4b's."""
    assert ac._smem_bytes(11, *tiling, *dtypes, LAYOUTS[entry]) == want
    if entry == "planes" and dtypes[0] == dtypes[1]:
        assert ac._smem_bytes(11, *tiling, dtypes[0]) == want


@pytest.mark.parametrize("entry", ["planes", "cl"])
@pytest.mark.parametrize("dtypes,want56,want28", [
    ((torch.bfloat16, torch.bfloat16), (8, 128), (2, 32)),
    ((torch.float32, torch.float32), (4, 32), (4, 32)),
    ((torch.bfloat16, torch.float32), (4, 32), (4, 32)),
    ((torch.float32, torch.bfloat16), (4, 32), (4, 32))])
def test_tiling_at_the_main_paths_shapes(entry, dtypes, want56, want28):
    """B=2, C=512, d=11 on a 132-SM card: bf16 x bf16 takes K4a's tilings,
    every pair with an fp32 operand K4b's."""
    for hw, want in ((56, want56), (28, want28)):
        assert ac._tiling(2, 512, hw, hw, 11, dtypes[0], 132, dtypes[1], LAYOUTS[entry]) == want


# ---------------------------------------------------------------------------
# CUDA kernels vs the plain version (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the main path's shapes, small odd ones, a channel count off every tile
# (K4d's pairs need it even) and a width over both column tiles
CUDA_SHAPES = [(2, 16, 21, 19, 5), (2, 512, 56, 56, 11), (2, 512, 28, 28, 11),
               (2, 96, 56, 56, 7), (1, 70, 9, 130, 7)]


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
    n = build.launch_counts()[f"adaptive_conv_{entry}"]
    got = fn(inp, filt, d)
    ref = adaptive_conv_tapmajor_plain(inp, filt, d)
    assert build.launch_counts()[f"adaptive_conv_{entry}"] == n + 1 and got.dtype == inp.dtype
    tol = 1e-5 if dtypes[0] == torch.float32 else 1e-2
    assert ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol


# d from 3 to 25 (past 17 the band is wider than 32 columns); channel counts
# that are a multiple of 64, of neither 8 nor 64 (K4d: 4-byte bf16 copies),
# and of 8 but not 64; odd H, W not a multiple of 16 (odd W: element-wise
# bf16 rows and taps channel-first)
EDGE_SHAPES = [(b, c, h, w, d) for d in (3, 7, 11, 17, 25)
               for b, c, h, w in ((1, 64, 13, 21), (2, 512, 9, 30), (1, 514, 11, 19),
                                  (2, 72, 7, 45))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
@pytest.mark.parametrize("b,c,h,w,d", EDGE_SHAPES)
@pytest.mark.parametrize("entry", ["planes", "cl"])
def test_kernel_at_edge_shapes(cuda, entry, b, c, h, w, d, dtypes):
    """Within 1e-5 (fp32 input) or 1e-2 (bf16 input) of max|ref|; the plain
    version with its last tap dropped lands above the bound on the same
    inputs."""
    tol = 1e-5 if dtypes[0] == torch.float32 else 1e-2
    inp, filt = _case(b, c, h, w, d, seed=d + c)
    inp = torch.from_numpy(inp).to(cuda, dtypes[0])
    filt = torch.from_numpy(filt).to(cuda, dtypes[1])
    got = ENTRIES[entry](inp, filt, d).float()
    ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
    dropped = filt.clone()
    dropped[:, -1] = 0
    bad = adaptive_conv_tapmajor_plain(inp, dropped, d).float()
    scale = ref.abs().max().item()
    assert ((got - ref).abs().max() / scale).item() <= tol
    assert ((bad - ref).abs().max() / scale).item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
@pytest.mark.parametrize("entry", ["planes", "cl"])
def test_kernel_at_every_tiling(cuda, entry, dtypes):
    """Every (R, channels per warp) the library takes, at an odd shape and at
    d = 11 and 25, through the bare call."""
    from rs_ov_torch.kernels.build import load_library

    tol = 1e-5 if dtypes[0] == torch.float32 else 1e-2
    for d in (11, 25):
        inp, filt = _case(2, 150, 11, 37, d)
        inp = torch.from_numpy(inp).to(cuda, dtypes[0])
        filt = torch.from_numpy(filt).to(cuda, dtypes[1])
        ref = adaptive_conv_tapmajor_plain(inp, filt, d).float()
        for rows in ac.ROWS:
            for cw in ac.WARP_CHANNELS:
                if ac._smem_bytes(d, rows, cw, *dtypes, LAYOUTS[entry]) > ac.SMEM_MAX:
                    continue
                out, name, args, _keep = ac._layout_operands(inp, filt, d, LAYOUTS[entry],
                                                             (rows, cw))
                assert getattr(load_library(), name)(
                    *args, torch.cuda.current_stream().cuda_stream) == 0
                rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
                assert rel <= tol, (d, rows, cw, rel)


@pytest.mark.cuda
def test_smem_mirror_matches_the_library(cuda):
    """_smem_bytes, which the wrappers check before the library loads,
    equals the library's own count (rs_adaptive_conv_smem) for every
    operand pair and layout."""
    from rs_ov_torch.kernels.build import load_library

    lib = load_library()
    for dt_in, dt_f in DTYPES:
        for channels_last in (False, True):
            for d in (1, 3, 7, 11, 17, 18, 25):
                for rows in ac.ROWS:
                    for cw in ac.WARP_CHANNELS:
                        assert ac._smem_bytes(d, rows, cw, dt_in, dt_f, channels_last) == \
                            lib.rs_adaptive_conv_smem(d, rows, cw, dt_in.itemsize,
                                                      dt_f.itemsize, int(channels_last), 0)
