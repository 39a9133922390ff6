"""The port's attention modes and the fused self-self attention kernel K6.

On the CPU: every mode of ``custom_attn`` against rs_ov's, K6's plain version
against the JAX kernel in interpret mode (tests/test_kernels.py:26-54), and
the routing rule. On a card only (``-m cuda``): K6 against its plain version,

    python -m pytest tests/test_torch_attention.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels.selfself_attention import (SUPPORTED_MODES,
                                                    fused_selfself_attention,
                                                    fused_selfself_attention_plain)
from rs_ov_torch.nn import attention
from rs_ov_torch.nn.attention import ATTENTION_MODES, custom_attn

torch.set_num_threads(1)

B, HEADS, HD = 2, 2, 8


class _Attn:  # the attention parameters as the port's modules hold them
    def __init__(self, **arrays):
        for k, a in arrays.items():
            setattr(self, k, torch.from_numpy(a))


def _case(seed, l=17):
    rng = np.random.RandomState(seed)
    d = HEADS * HD
    x = rng.randn(B, l, d).astype(np.float32)
    p = dict(in_proj_w=(rng.randn(3 * d, d) * 0.3).astype(np.float32),
             in_proj_b=(rng.randn(3 * d) * 0.1).astype(np.float32),
             out_proj_w=(rng.randn(d, d) * 0.3).astype(np.float32),
             out_proj_b=(rng.randn(d) * 0.1).astype(np.float32))
    sim = (rng.randn(B, l - 1, l - 1) * 0.5).astype(np.float32)
    return x, p, sim


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    from rs_ov.nn import attention as jattn

    return jax.numpy, jattn


@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode", ATTENTION_MODES)
def test_custom_attn_matches_jax(jx, mode, with_sim):
    """Every mode on a 4x4 grid + CLS, and the Gaussian-bias modes also on a
    non-square 3x5 grid with another std; within 1e-5."""
    jnp, jattn = jx
    grids = [(4, 4, 1.0)] + ([(3, 5, 0.7)] if mode in ("NACLIP", "NOnly", "GAV") else [])
    for gh, gw, std in grids:
        x, p, sim = _case(7, l=gh * gw + 1)
        sim = sim if with_sim else None
        kw = dict(mode=mode, heads=HEADS, similarity_weight=0.8, gaussian_std=std,
                  grid_hw=(gh, gw))
        want = np.asarray(jattn.custom_attn(
            {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
            sim_map=None if sim is None else jnp.asarray(sim), **kw))
        got = custom_attn(_Attn(**p), torch.from_numpy(x),
                          sim_map=None if sim is None else torch.from_numpy(sim), **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_gaussian_addition_matches_jax(jx):
    _, jattn = jx
    for gh, gw, std in ((4, 4, 1.0), (3, 5, 0.7), (14, 14, 2.0)):
        np.testing.assert_array_equal(attention._gaussian_addition(gh, gw, std),
                                      jattn._gaussian_addition(gh, gw, std))


def _qkv(seed, l=17, hd=HD):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, HEADS, l, hd).astype(np.float32) for _ in range(3))
    sim = np.pad(rng.randn(B, l - 1, l - 1).astype(np.float32) * 0.5, ((0, 0), (1, 0), (1, 0)))
    return q, k, v, sim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode", SUPPORTED_MODES)
def test_fused_plain_matches_the_jax_kernel(jx, mode, with_sim, dtype):
    """K6's plain version against the Pallas kernel in interpret mode, on the
    same inputs: fp32 within 1e-5; bf16 inputs within one bf16 step of the
    output (both widen to fp32 and cast once, so only a rounding flip of the
    last cast can differ)."""
    jnp, _ = jx
    from rs_ov.kernels.selfself_attention import fused_selfself_attention as jax_k6

    q, k, v, sim = _qkv(3)
    sim = sim if with_sim else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_k6(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             None if sim is None else jnp.asarray(sim), mode=mode,
                             sim_weight=0.8, interpret=True).astype(jnp.float32))
    got = fused_selfself_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   None if sim is None else torch.from_numpy(sim),
                                   mode=mode, sim_weight=0.8)
    assert got.dtype == tdt and got.shape == (B, HEADS, 17, HD)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_fused_route_rule(monkeypatch):
    """The JAX rule (rs_ov/nn/attention.py:131-144) with the card in the TPU's
    place: RS_OV_FUSED_ATTN=1, a CUDA device and a supported mode give the
    kernel; anything else the plain path."""
    cuda, cpu, meta = torch.device("cuda"), torch.device("cpu"), torch.device("meta")
    monkeypatch.setenv("RS_OV_FUSED_ATTN", "1")
    for mode in ATTENTION_MODES:
        assert attention._use_fused_kernel(mode, cuda) == (mode in SUPPORTED_MODES)
        assert not attention._use_fused_kernel(mode, cpu)
        assert not attention._use_fused_kernel(mode, meta)
    for value in ("0", "", "true"):
        monkeypatch.setenv("RS_OV_FUSED_ATTN", value)
        assert not attention._use_fused_kernel("Experimental", cuda)
    monkeypatch.delenv("RS_OV_FUSED_ATTN")
    assert not attention._use_fused_kernel("Experimental", cuda)


def test_fused_path_on_the_cpu_stays_plain(monkeypatch):
    """On the CPU the switch changes nothing: custom_attn never calls K6, and
    K6's wrapper given CPU tensors runs its plain version, not the kernel."""
    q, k, v, _ = _qkv(2)
    before = fused_selfself_attention.launches
    fused_selfself_attention(*(torch.from_numpy(a) for a in (q, k, v)), mode="SFP")
    assert fused_selfself_attention.launches == before
    monkeypatch.setenv("RS_OV_FUSED_ATTN", "1")
    x, p, sim = _case(5)
    called = []
    monkeypatch.setattr("rs_ov_torch.kernels.selfself_attention.fused_selfself_attention",
                        lambda *a, **k: called.append(1))
    custom_attn(_Attn(**p), torch.from_numpy(x), mode="SCLIP", heads=HEADS,
                sim_map=torch.from_numpy(sim))
    assert not called


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    from rs_ov_torch.kernels.selfself_attention import _fused_selfself_attention_cuda as k6

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    q = t(2, 3, 17, 8)
    with pytest.raises(ValueError, match="unsupported mode"):
        k6(q, q, q, None, "NACLIP", 1.0)
    with pytest.raises(ValueError, match="k must be"):
        k6(q, t(2, 3, 17, 8, dtype=torch.float32), q, None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="v must be"):
        k6(q, q, t(2, 3, 16, 8), None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        k6(*(t(2, 3, 17, 8, dtype=torch.float16),) * 3, None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="sim_map"):
        k6(q, q, q, t(2, 17, 17), "SCLIP", 1.0)  # bf16, not fp32
    with pytest.raises(ValueError, match="sim_map"):
        k6(q, q, q, t(2, 16, 16, dtype=torch.float32), "SCLIP", 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        k6(*(t(2, 3, 17, 12),) * 3, None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="L <= 288"):
        k6(*(t(1, 1, 300, 8),) * 3, None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        k6(*(t(1, 1, 288, 128, dtype=torch.float32),) * 3, None, "SCLIP", 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k6(t(2, 17, 3, 8).transpose(1, 2), q, q, None, "SCLIP", 1.0)
    with pytest.raises(NotImplementedError, match="no route"):
        fused_selfself_attention(q, q, q, mode="SCLIP")


@pytest.mark.parametrize("mode,l,hd,match", [
    ("SCLIP", 288, 128, "shared memory"),  # q, k, v: 3 x 288 x 136 x 2 B > 232448
    ("SegEarth", 289, 64, "L <= 288"),
    ("ClearCLIP", 17, 136, "multiple of 8 up to 128"),
    ("vanilla", 17, 4, "multiple of 8 up to 128"),
])
def test_fused_bf16_wrapper_refuses_past_its_limits(mode, l, hd, match):
    """The bf16 kernel's wrapper raises, before it loads the library, past
    L = 288, hd = 128 (or hd not a multiple of 8) and past the shared memory
    of a block holding the mode's padded operands."""
    from rs_ov_torch.kernels.selfself_attention import _fused_selfself_attention_cuda as k6

    x = torch.empty(1, 2, l, hd, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        k6(x, x, x, None, mode, 1.0)


def test_fused_bf16_kernel_takes_what_the_fp32_core_kernel_took():
    """Every (mode, L, hd) whose operands fitted the earlier bf16 kernel's
    block (rows of hd + 8 and a weights row per warp) fits the tensor-core
    kernel's (L and hd padded to 16, rows of hd + 8): it refuses nothing the
    earlier one took. ClearCLIP (two operands) takes L = 288 at hd = 128."""
    from rs_ov_torch.kernels.selfself_attention import LMAX, SMEM_MAX, _smem_bytes

    for mode in SUPPORTED_MODES:
        n_ops = 2 if mode == "ClearCLIP" else 3
        for l in range(1, LMAX + 1):
            for hd in range(8, 129, 8):
                if n_ops * l * (hd + 8) * 2 + 16 * l * 4 <= SMEM_MAX:
                    assert _smem_bytes(mode, l, hd, torch.bfloat16) <= SMEM_MAX, (mode, l, hd)
    assert _smem_bytes("ClearCLIP", 288, 128, torch.bfloat16) <= SMEM_MAX


def test_fused_f32_kernel_takes_what_the_fp32_core_kernel_took():
    """Every (mode, L, hd) whose operands fitted the earlier fp32 kernel's
    block (rows of hd + 4 floats and a weights row for each of its 16 warps)
    fits the TF32 kernel's (v padded to 16 rows, the sim rows staged only
    where room is left): it refuses nothing the earlier one took."""
    from rs_ov_torch.kernels.selfself_attention import LMAX, SMEM_MAX, _smem_bytes

    for mode in SUPPORTED_MODES:
        n_ops = 2 if mode == "ClearCLIP" else 3
        for l in range(1, LMAX + 1):
            for hd in range(8, 129, 8):
                if n_ops * l * (hd + 4) * 4 + 16 * l * 4 <= SMEM_MAX:
                    assert _smem_bytes(mode, l, hd, torch.float32) <= SMEM_MAX, (mode, l, hd)


def test_fused_f32_kernel_takes_every_mode_up_to_vith14():
    """The fp32 kernel's block holds every mode at L <= 288 and hd <= 80 (the
    shapes ViT-L/14 and ViT-H/14 give at a 224² crop): where q, k and v do
    not fit (L = 257, hd = 80: 264096 B), the score operands share one slot
    (177744 B; vanilla also holds the block's 96 rows of q, 210000 B)."""
    from rs_ov_torch.kernels.selfself_attention import LMAX, SMEM_MAX, _smem_bytes

    for mode in SUPPORTED_MODES:
        for l in range(1, LMAX + 1):
            for hd in range(8, 81, 8):
                assert _smem_bytes(mode, l, hd, torch.float32) <= SMEM_MAX, (mode, l, hd)
    assert ([_smem_bytes(m, 257, 80, torch.float32) for m in SUPPORTED_MODES]
            == [210000] + [177744] * 5)
    # the main path's shape keeps the three-operand layout
    assert _smem_bytes("Experimental", 197, 64, torch.float32) == (2 * 197 + 208) * 68 * 4


def _f32_cases():
    """(mode, L, hd) over L in {50, 197, 257, 288} and hd in {64, 80, 128}
    wherever the fp32 kernel's block holds the mode's operands."""
    from rs_ov_torch.kernels.selfself_attention import SMEM_MAX, _smem_bytes

    return [(m, l, hd) for m in SUPPORTED_MODES for l in (50, 197, 257, 288)
            for hd in (64, 80, 128) if _smem_bytes(m, l, hd, torch.float32) <= SMEM_MAX]


# ---------------------------------------------------------------------------
# K6 against its plain version (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode", SUPPORTED_MODES)
def test_fused_kernel_matches_plain(cuda, mode, with_sim, dtype):
    """At the main path's L=197, hd=64 (and a ragged L=17, hd=8): fp32 within
    1e-5 of max|ref|, bf16 within 1e-2 (a bf16 step of the output)."""
    tdt = getattr(torch, dtype)
    for l, hd in ((197, 64), (17, 8)):
        q, k, v, sim = (torch.from_numpy(a).to(cuda) for a in _qkv(11, l=l, hd=hd))
        q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
        sim = sim if with_sim else None
        got = fused_selfself_attention(q, k, v, sim, mode=mode, sim_weight=0.8).float()
        ref = fused_selfself_attention_plain(q, k, v, sim, mode=mode, sim_weight=0.8).float()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        assert rel <= (1e-5 if dtype == "float32" else 1e-2), (l, hd, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("l,hd", [(257, 64), (288, 64), (288, 112), (50, 80)],
                         ids=["vitl14", "lmax", "lmax-hd112", "vith14-b32grid"])
@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode", SUPPORTED_MODES)
def test_fused_bf16_kernel_at_the_wrappers_limits(cuda, mode, with_sim, l, hd):
    """The bf16 kernel at shapes the wrapper takes beyond the main path's:
    ViT-L/14 at 224² (L=257, hd=64), the limit L=288 (hd=64, and hd=112, the
    widest whose three operands fit a block), and ViT-H/14's hd=80 on a
    ViT-B/32 grid (L=50); within 1e-2 of max|ref|."""
    q, k, v, sim = (torch.from_numpy(a).to(cuda) for a in _qkv(13, l=l, hd=hd))
    q, k, v = q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)
    sim = sim if with_sim else None
    got = fused_selfself_attention(q, k, v, sim, mode=mode, sim_weight=0.8).float()
    ref = fused_selfself_attention_plain(q, k, v, sim, mode=mode, sim_weight=0.8).float()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-2, (l, hd, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode,l,hd", _f32_cases())
def test_fused_f32_kernel_at_the_wrappers_limits(cuda, mode, l, hd, with_sim):
    """The fp32 (3xTF32) kernel at ViT-B/32's L=50, ViT-B/16's 197, ViT-L/14's
    257 and the limit 288, at hd 64, 80 (ViT-H/14) and 128, in every mode and
    shape whose operands fit a block; within 1e-5 of max|ref|."""
    q, k, v, sim = (torch.from_numpy(a).to(cuda) for a in _qkv(17, l=l, hd=hd))
    sim = sim if with_sim else None
    got = fused_selfself_attention(q, k, v, sim, mode=mode, sim_weight=0.8)
    ref = fused_selfself_attention_plain(q, k, v, sim, mode=mode, sim_weight=0.8)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, (l, hd, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("with_sim", [False, True], ids=["nosim", "sim"])
@pytest.mark.parametrize("mode", SUPPORTED_MODES)
def test_fused_f32_kernel_at_vith14(cuda, mode, with_sim):
    """The fp32 kernel at ViT-H/14's L=257, hd=80 (16 heads, the score
    operands staged in turn in one slot) against its plain version, within
    1e-5 of max|ref|."""
    rng = np.random.RandomState(19)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 257, 80).astype(np.float32)).to(cuda)
               for _ in range(3))
    sim = torch.from_numpy(np.pad(rng.randn(2, 256, 256).astype(np.float32) * 0.5,
                                  ((0, 0), (1, 0), (1, 0)))).to(cuda) if with_sim else None
    got = fused_selfself_attention(q, k, v, sim, mode=mode, sim_weight=0.8)
    ref = fused_selfself_attention_plain(q, k, v, sim, mode=mode, sim_weight=0.8)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, rel


@pytest.mark.cuda
def test_fused_f32_smem_mirror_matches_the_library(cuda):
    """_smem_bytes in fp32 is the library's own count of the layout a launch
    picks (0 where it refuses), over every mode, L and hd the wrapper takes."""
    from rs_ov_torch.kernels.build import load_library
    from rs_ov_torch.kernels.selfself_attention import LMAX, SMEM_MAX, _smem_bytes

    lib = load_library()
    for i, mode in enumerate(SUPPORTED_MODES):
        for l in range(1, LMAX + 1):
            for hd in range(8, 129, 8):
                want = _smem_bytes(mode, l, hd, torch.float32)
                got = lib.rs_selfself_attention_f32_smem(i, l, hd)
                assert got == (want if want <= SMEM_MAX else 0), (mode, l, hd, got, want)
