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
from rs_ov_torch.kernels import build

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
    before = build.launch_counts()
    checked = _check_against_jax(jnp, jax_fn, port_fn, (2, 16, 21, 19, 5), operands, 5)
    assert build.launch_counts() == before
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


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """The checks run before the library is touched, so they hold here: the
    dtype, the shape, a d whose block does not fit in shared memory (an fp32
    input staged in a ring of fp32 rows and a rounded bf16 row: d <= 44),
    one past the widest band (d <= 49) and, for K4f, d > 17."""
    monkeypatch.setattr(ac, "_sms", lambda device: 132)
    monkeypatch.setattr(build, "load_library", lambda: pytest.fail("the library was loaded"))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ac._rounded_operands(torch.zeros(1, 2, 7, 7, dtype=torch.float64),
                             torch.zeros(1, 9, 5, 5), 3)
    with pytest.raises(ValueError, match="does not match"):
        ac._rounded_operands(torch.zeros(1, 2, 7, 7), torch.zeros(1, 9, 5, 4), 3)
    with pytest.raises(ValueError, match="shared memory at d=45: the smallest needs 232704 bytes"):
        ac._rounded_operands(torch.zeros(1, 2, 46, 46), torch.zeros(1, 45 * 45, 2, 2), 45)
    with pytest.raises(ValueError, match="d <= 49"):
        ac._rounded_operands(torch.zeros(1, 2, 51, 51, dtype=torch.bfloat16),
                             torch.zeros(1, 50 * 50, 2, 2), 50)
    with pytest.raises(ValueError, match="rs_adaptive_conv_v4 takes d <= 17"):
        ac._rounded_operands(torch.zeros(1, 2, 20, 20), torch.zeros(1, 19 * 19, 2, 2), 19,
                             chunked=True)
    for chunked, d in ((False, 44), (True, 17)):  # the largest each takes, fp32 input
        out, entry, args, _keep = ac._rounded_operands(torch.zeros(1, 2, d + 1, d + 1),
                                                       torch.zeros(1, d * d, 2, 2), d, chunked)
        assert entry == ac._ROUNDED_ENTRY[chunked] and args[-4:-2] == (0, 0)
        assert ac._smem_bytes(d, *args[-2:], F32, rounded=True) <= ac.SMEM_MAX


F32, BF16 = torch.float32, torch.bfloat16
PAIRS = [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)]


@pytest.mark.parametrize("dtypes,d,tiling,want", [
    # d = 11, 8 x 128 (CB = 128): taps [121][136] in bf16, rounded to 128 B,
    # 33024; an fp32 input rings 3 rows [128][32 + 4] fp32 (55296) and 2
    # rounded rows [128][32 + 8] bf16 (20480), under the output stage [8
    # warps][128][16 + 4] fp32 (81920); a bf16 input is K4a's layout (4 rows
    # [128][40] bf16, 40960, under the stage [8][128][24] bf16, 49152)
    ((F32, F32), 11, (8, 128), 33024 + 81920),
    ((F32, BF16), 11, (8, 128), 33024 + 81920),
    ((BF16, F32), 11, (8, 128), 33024 + 49152),
    ((BF16, BF16), 11, (8, 128), 33024 + 49152),
    # 2 x 32 (CB = 128): taps [121][40] bf16 (9680 -> 9728), the same rows
    ((F32, F32), 11, (2, 32), 9728 + 55296 + 20480),
    ((BF16, F32), 11, (2, 32), 9728 + 4 * 128 * 40 * 2),
    # d = 42, 1 x 16 (CB = 128, 64 columns): taps [1764][24] bf16 (84672 ->
    # 84736), 3 rows [128][68] fp32 (104448), 2 rounded [128][72] bf16 (36864)
    ((F32, F32), 42, (1, 16), 84736 + 104448 + 36864),
    ((BF16, F32), 42, (1, 16), 84736 + 4 * 128 * 72 * 2),
])
def test_smem_bytes_count_the_rounded_layouts(dtypes, d, tiling, want):
    """_smem_bytes of the rounded product (K4e/K4f), counted by hand from the
    C layout (csrc/adaptive_conv.cuh, make_layout): fp32 taps are staged as
    bf16, an fp32 input is rounded once into a bf16 row, and bf16 x bf16 is
    K4a's block."""
    assert ac._smem_bytes(d, *tiling, *dtypes, rounded=True) == want
    if dtypes == (BF16, BF16):
        assert ac._smem_bytes(d, *tiling, BF16) == want
    with pytest.raises(ValueError, match="channel-first"):
        ac._smem_bytes(d, *tiling, *dtypes, channels_last=True, rounded=True)


@pytest.mark.parametrize("dtypes", PAIRS, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
def test_rounded_tiling_fits_every_d_the_kernels_take(dtypes):
    """Every d up to the largest whose block fits (44 with an fp32 input, 49
    with a bf16 one, the widest band) and every C get a tiling the kernel has
    that fits in shared memory, with no warp's channels wholly past C where a
    smaller tiling exists; the next d is refused. The main path's shapes (B=2,
    C=512, d=11) take the sweep's tilings on a 132-SM card (PERF.md): 8 x 128
    at 56^2; at 28^2 4 x 64 with an fp32 input, bf16's 2 x 32 with a bf16
    one."""
    largest = 44 if dtypes[0] == F32 else 49
    for d in range(1, largest + 1):
        for c in (2, 64, 72, 512, 514):
            rows, cw = ac._tiling(2, c, 13, 21, d, dtypes[0], 132, dtypes[1], rounded=True)
            assert rows in ac.ROWS and cw in ac.WARP_CHANNELS
            assert ac._smem_bytes(d, rows, cw, *dtypes, rounded=True) <= ac.SMEM_MAX
            assert cw == 16 or cw * (8 // rows) < 2 * c
    if largest < ac.ROUNDED_MAX_D:
        with pytest.raises(ValueError, match=f"d={largest + 1}: the smallest needs"):
            ac._tiling(2, 64, 13, 21, largest + 1, dtypes[0], 132, dtypes[1], rounded=True)
    for hw, want in ((56, (8, 128)), (28, (4, 64) if dtypes[0] == F32 else (2, 32))):
        assert ac._tiling(2, 512, hw, hw, 11, dtypes[0], 132, dtypes[1], rounded=True) == want


# ---------------------------------------------------------------------------
# CUDA kernels vs the plain version (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4e/K4f have no CPU mode")
    return torch.device("cuda")


def _card_case(b, c, h, w, d, dtypes, cuda, seed):
    rng = np.random.RandomState(seed)
    inp = torch.from_numpy(rng.randn(b, c, h + d - 1, w + d - 1).astype(np.float32))
    filt = torch.from_numpy(rng.randn(b, d * d, h, w).astype(np.float32))
    return inp.to(cuda, dtypes[0]), filt.to(cuda, dtypes[1])


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


# the main path's stages (d=11 at 56^2 and 28^2, jbu_stack's d=7 at 224^2),
# d = 17 and two column chunks of the JAX K4f (W = 117) at C = 64; then d in
# {3, 7, 11, 17, 25} at channel counts that are a multiple of 64, of neither
# 8 nor 64, and of 8 but not 64, with odd H and W not a multiple of 16 (odd
# W: element-wise bf16 rows and fp32 taps in 4-byte pieces)
CARD_SHAPES = ([(2, 64, hw, hw, d) for d, hw in ((11, 56), (11, 28), (7, 224), (17, 40))]
               + [(1, 64, 4, 117, 5)]
               + [(b, c, h, w, d) for d in (3, 7, 11, 17, 25)
                  for b, c, h, w in ((1, 64, 13, 21), (2, 512, 9, 30), (1, 514, 11, 19),
                                     (2, 72, 7, 45))])


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,d", CARD_SHAPES)
@pytest.mark.parametrize("dtypes", PAIRS, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
def test_kernels_match_the_plain_version_on_the_card(cuda, b, c, h, w, d, dtypes):
    """K4e and (d <= 17) K4f within 1e-5 of max|ref| with an fp32 input, 1e-2
    with a bf16 one, one launch each; the plain version with its last tap
    dropped, and for an fp32 input K4b's unrounded function, land above the
    bound on the same inputs."""
    inp, filt = _card_case(b, c, h, w, d, dtypes, cuda, seed=d * w + c)
    tol = 1e-5 if dtypes[0] == F32 else 1e-2
    ref = ac.adaptive_conv_bf16_plain(inp, filt, d)
    dropped = filt.clone()
    dropped[:, -1] = 0
    assert _rel(ac.adaptive_conv_bf16_plain(inp, dropped, d), ref) > tol
    if dtypes[0] == F32:
        assert _rel(ac.adaptive_conv_tapmajor_plain(inp, filt, d), ref) > tol
    for name in ("adaptive_conv_v3", "adaptive_conv_v4")[:1 if d > ac.V4_MAX_D else 2]:
        before = build.launch_counts()[name]
        got = getattr(ac, name)(inp, filt, d)
        torch.cuda.synchronize()
        assert build.launch_counts()[name] == before + 1 and got.dtype == inp.dtype
        assert _rel(got, ref) <= tol, (name, _rel(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", PAIRS, ids=lambda t: f"{t[0]}-{t[1]}"[12:])
def test_kernels_at_the_largest_d_and_every_tiling(cuda, dtypes):
    """K4e at the largest d it takes (44 with an fp32 input, 49 with a bf16
    one), and the rounded product at every (R, channels per warp) whose block
    fits, at d = 11 and 25, through the bare library call."""
    from rs_ov_torch.kernels.build import load_library

    tol = 1e-5 if dtypes[0] == F32 else 1e-2
    largest = 44 if dtypes[0] == F32 else 49
    inp, filt = _card_case(1, 72, 5, 21, largest, dtypes, cuda, seed=largest)
    assert _rel(ac.adaptive_conv_v3(inp, filt, largest),
                ac.adaptive_conv_bf16_plain(inp, filt, largest)) <= tol
    stream = torch.cuda.current_stream().cuda_stream
    for d in (11, 25):
        inp, filt = _card_case(2, 150, 11, 37, d, dtypes, cuda, seed=d)
        ref = ac.adaptive_conv_bf16_plain(inp, filt, d)
        for rows in ac.ROWS:
            for cw in ac.WARP_CHANNELS:
                if ac._smem_bytes(d, rows, cw, *dtypes, rounded=True) > ac.SMEM_MAX:
                    continue
                out, name, args, _keep = ac._rounded_operands(inp, filt, d, tiling=(rows, cw))
                assert getattr(load_library(), name)(*args, stream) == 0
                assert _rel(out, ref) <= tol, (d, rows, cw, _rel(out, ref))


@pytest.mark.cuda
def test_bf16_pair_is_k4a(cuda):
    """With both operands bf16 nothing is rounded: K4e and K4f run K4a's
    instantiation at K4a's tiling, bit for bit."""
    for d, hw in ((11, 56), (11, 28), (7, 60)):
        inp, filt = _card_case(2, 512, hw, hw, d, (BF16, BF16), cuda, seed=hw)
        k4a = ac.adaptive_conv_tapmajor(inp, filt, d)
        assert torch.equal(ac.adaptive_conv_v3(inp, filt, d), k4a)
        assert torch.equal(ac.adaptive_conv_v4(inp, filt, d), k4a)


@pytest.mark.cuda
def test_rounded_smem_mirror_matches_the_library(cuda):
    """_smem_bytes of the rounded product, which the wrappers check before
    the library loads, equals the library's own count for every operand pair,
    d and tiling."""
    from rs_ov_torch.kernels.build import load_library

    lib = load_library()
    for dt_in, dt_f in PAIRS:
        for d in (1, 3, 7, 11, 17, 18, 25, 42, 44, 49):
            for rows in ac.ROWS:
                for cw in ac.WARP_CHANNELS:
                    assert ac._smem_bytes(d, rows, cw, dt_in, dt_f, rounded=True) == \
                        lib.rs_adaptive_conv_smem(d, rows, cw, dt_in.itemsize, dt_f.itemsize, 0, 1)
