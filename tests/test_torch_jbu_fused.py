"""The fused-range JBU stage (``RS_OV_JBU_FUSED_RANGE=1``): kernels K5a
(``jbu_epilogue_fused``) and K5b (``jbu_epilogue_fused_classify``), the
channel-last range projection ``_proj2_nhwc`` and the channel-last modules
that take the fused route.

The plain versions are held against the TPU kernels
``jbu_epilogue_fused_pallas`` / ``jbu_epilogue_fused_classify_pallas`` in
interpret mode (each called once: interpret mode is slow), against the
port's own split route (K1's plain version + reflect pads + K2's / K3's) on
grids where every pixel reads a reflected edge, and, through the modules,
against the JAX channel-first modules in fp32. The CUDA kernels are held
against the plain versions and, bit for bit, against the split pair's
kernels on a card only. Inputs come from numpy with a
seed. jax is imported inside the tests that need it, so that on a card the
CUDA tests run with

    python -m pytest tests/test_torch_jbu_fused.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels import build
from rs_ov_torch.kernels import jbu_epilogue as epi
from rs_ov_torch.kernels.range_logits import range_logits_plain
from rs_ov_torch.upsample import jbu
from rs_ov_torch.utils.resize import reflect_pad_2d, reflect_pad_nhwc

torch.set_num_threads(1)

C = 8


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref) / np.max(np.abs(ref))


def _stage_case(b, c, h, w, d, g, k, seed):
    """tests/test_kernels_epilogue.py:107-120's inputs, channel-last source
    and projection, channel-first guidance."""
    rng = np.random.RandomState(seed)
    dd = d * d
    return dict(proj=rng.randn(b, h, w, k).astype(np.float32),
                guid=rng.randn(b, g, h, w).astype(np.float32),
                inp=rng.randn(b, h, w, c).astype(np.float32),
                w0=rng.randn(dd, dd + g) * 0.2, b0=rng.randn(dd) * 0.1,
                w1=rng.randn(dd, dd) * 0.2, b1=rng.randn(dd) * 0.1,
                fw=rng.randn(c, c) * 0.2, fb=rng.randn(c) * 0.1,
                qf=rng.randn(3, c).astype(np.float32))


def _torch_stage(case, d, dtype):
    return (_t(case["inp"], dtype), _t(case["proj"]), _t(case["guid"], dtype),
            jbu._spatial_kernel(d, torch.tensor(0.7)), torch.tensor(1.3),
            *(_t(case[n], dtype) for n in ("w0", "b0", "w1", "b1")))


def _torch_tail(case, dtype):
    return _t(case["fw"], dtype), _t(case["fb"], dtype), _t(case["qf"])


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    from rs_ov.kernels import jbu_epilogue as jepi
    from rs_ov.upsample import jbu as jjbu

    return jax, jax.numpy, jepi, jjbu


def _jax_stage(jx, case, d):
    _, jnp, _, jjbu = jx
    bf = jnp.bfloat16
    return (jnp.asarray(case["inp"], bf), jnp.asarray(case["proj"]),
            jnp.asarray(case["guid"], bf),
            jjbu._spatial_kernel(d, jnp.asarray(0.7, jnp.float32)).reshape(-1),
            jnp.asarray(1.3, jnp.float32),
            *(jnp.asarray(case[n], bf) for n in ("w0", "b0", "w1", "b1")))


JAX_SIZE = dict(b=1, c=8, h=12, w=11, d=5, g=3, k=4)  # tests/test_kernels_epilogue.py:107


def test_k5a_plain_matches_the_tpu_kernel(jx):
    """K5a plain vs jbu_epilogue_fused_pallas (interpret), bf16: within 1e-5
    of max|ref|, except at most 2 outputs whose bf16 rounding flips (from
    fp32 last-bit differences of the erf and the summation order), each
    within 1e-3 (the rule of tests/test_torch_jbu_kernels.py for K2)."""
    d = JAX_SIZE["d"]
    case = _stage_case(**JAX_SIZE, seed=7)
    ref = np.asarray(jx[2].jbu_epilogue_fused_pallas(*_jax_stage(jx, case, d), d,
                                                     interpret=True), np.float32)
    got = epi.jbu_epilogue_fused(*_torch_stage(case, d, torch.bfloat16), d)
    assert got.dtype == torch.bfloat16
    rel = _rel(got.float().numpy(), ref)
    assert np.sum(rel > 1e-5) <= 2 and rel.max() <= 1e-3


def test_k5b_plain_matches_the_tpu_kernel(jx):
    """K5b plain vs jbu_epilogue_fused_classify_pallas (interpret), bf16:
    within 2e-2 absolute (K3's plain-vs-JAX bound)."""
    _, jnp, jepi, _ = jx
    d = JAX_SIZE["d"]
    case = _stage_case(**JAX_SIZE, seed=8)
    bf = jnp.bfloat16
    ref = np.asarray(jepi.jbu_epilogue_fused_classify_pallas(
        *_jax_stage(jx, case, d), jnp.asarray(case["fw"], bf), jnp.asarray(case["fb"], bf),
        jnp.asarray(case["qf"]), d, interpret=True))
    got = epi.jbu_epilogue_fused_classify(*_torch_stage(case, d, torch.bfloat16),
                                          *_torch_tail(case, torch.bfloat16), d)
    assert got.dtype == torch.float32 and got.shape == (1, 12, 11, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


def _split_plain(case, d, dtype, classify):
    """The port's split route on the same inputs: K1's plain version on the
    reflect-padded channel-first projection, the reflect-padded source, then
    K2's or K3's plain version."""
    inp, proj, guid, *rest = _torch_stage(case, d, dtype)
    pcf = proj.permute(0, 3, 1, 2).contiguous()
    logits = range_logits_plain(reflect_pad_2d(pcf, d // 2), pcf, d).permute(0, 2, 3, 1)
    args = (reflect_pad_nhwc(inp, d // 2), logits, guid.permute(0, 2, 3, 1), *rest)
    if classify:
        return epi.jbu_epilogue_classify_plain(*args, *_torch_tail(case, dtype), d)
    return epi.jbu_epilogue_plain(*args, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,h,w", [(5, 3, 4), (11, 6, 9)])  # every pixel within r of an edge
def test_fused_plain_matches_the_split_route(d, h, w, dtype):
    """The same function by two routes on grids as small as reflection
    allows (r <= H-1), so that every output reads reflected rows and
    columns: within 1e-6 of max|ref| (only the fp32 order of the logits'
    K-sum may differ)."""
    case = _stage_case(2, C, h, w, d, 3, 5, seed=d)
    for classify in (False, True):
        ref = _split_plain(case, d, dtype, classify).float().numpy()
        args = _torch_stage(case, d, dtype)
        got = (epi.jbu_epilogue_fused_classify(*args, *_torch_tail(case, dtype), d)
               if classify else epi.jbu_epilogue_fused(*args, d))
        assert _rel(got.float().numpy(), ref).max() <= 1e-6
    # zero padding in place of the reflection is caught at these sizes
    zero = lambda x, r: torch.nn.functional.pad(x, (0, 0, r, r, r, r))  # noqa: E731
    orig, epi._pad_nhwc = epi._pad_nhwc, zero
    try:
        bad = epi.jbu_epilogue_fused(*_torch_stage(case, d, dtype), d).float().numpy()
    finally:
        epi._pad_nhwc = orig
    assert _rel(bad, _split_plain(case, d, dtype, False).float().numpy()).max() > 1e-2


def _weights(name, seed=1):
    import jax

    from rs_ov.upsample import jbu as jjbu
    from rs_ov_torch.core.params import jbu_params_from_numpy

    init = jjbu.init_jbu_one_params if name == "jbu_one" else jjbu.init_jbu_stack_params
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), C))
    return tree, jbu_params_from_numpy(tree, C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj2_nhwc_matches_jax(jx, dtype):
    """_proj2_nhwc on [B, H, W, G] equals the JAX _proj2_nhwc and, transposed,
    the channel-first _proj2 (the same fp32 math and casts)."""
    _, jnp, _, jjbu = jx
    tree, mod = _weights("jbu_one")
    g = np.random.RandomState(2).randn(2, 3, 9, 7).astype(np.float32)
    jt = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v, jt) for k, v in tree["up"]["range_proj"].items()}
    tp = mod.up.range_proj.to(getattr(torch, dtype))
    got = jbu._proj2_nhwc(_t(g, getattr(torch, dtype)).permute(0, 2, 3, 1), tp)
    want_nhwc = jjbu._proj2_nhwc(jnp.asarray(g, jt).transpose(0, 2, 3, 1), jp)
    want_cf = jjbu._proj2(jnp.asarray(g, jt), jp).transpose(0, 2, 3, 1)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for want in (want_nhwc, want_cf):
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)).max() <= tol


@pytest.mark.parametrize("name,radius", [("jbu_one", 5), ("jbu_stack", 3)])
def test_module_forward_nhwc_fused_matches_jax(jx, monkeypatch, name, radius):
    """jbu_module_forward_nhwc with the switch on, fp32, against the JAX
    channel-first jbu_module_forward: within 1e-5 of max|ref|."""
    _, jnp, _, jjbu = jx
    tree, mod = _weights(name)
    jp, tp = (tree["up"], mod.up) if name == "jbu_one" else (tree["ups"][1], mod.ups[1])
    rng = np.random.RandomState(0)
    src, guid = rng.randn(2, C, 6, 7).astype(np.float32), rng.randn(2, 3, 12, 14).astype(np.float32)
    ref = np.asarray(jjbu.jbu_module_forward(jp, jnp.asarray(src), jnp.asarray(guid), radius))
    calls = []
    monkeypatch.setattr(jbu, "jbu_epilogue_fused",
                        lambda *a: calls.append(1) or epi.jbu_epilogue_fused(*a))
    monkeypatch.setenv("RS_OV_JBU_FUSED_RANGE", "1")
    got = jbu.jbu_module_forward_nhwc(tp, _t(src).permute(0, 2, 3, 1), _t(guid), radius)
    assert calls == [1]
    assert _rel(got.numpy(), ref.transpose(0, 2, 3, 1)).max() <= 1e-5


@pytest.mark.parametrize("stages", [2, 4])
def test_one_forward_nhwc_classify_fused_matches_jax(jx, monkeypatch, stages):
    """jbu_one_forward_nhwc_classify with the switch on (K5a in every stage
    but the last, K5b in the last), fp32, against the JAX channel-first
    jbu_one_forward followed by the L2 norm and the cosine logits: within
    1e-5 of max|ref|."""
    _, jnp, _, jjbu = jx
    tree, mod = _weights("jbu_one", seed=3)
    rng = np.random.RandomState(4)
    src, guid = rng.randn(1, C, 4, 5).astype(np.float32), rng.randn(1, 3, 64, 80).astype(np.float32)
    qf = rng.randn(3, C).astype(np.float32)
    qf /= np.linalg.norm(qf, axis=-1, keepdims=True)
    x = jjbu.jbu_one_forward(tree, jnp.asarray(src), jnp.asarray(guid), stages=stages)
    x = x.transpose(0, 2, 3, 1)
    ref = np.asarray(jnp.einsum("bhwc,qc->bhwq", x / jnp.linalg.norm(x, axis=-1, keepdims=True),
                                jnp.asarray(qf)))
    calls = []
    for name in ("jbu_epilogue_fused", "jbu_epilogue_fused_classify"):
        fn = getattr(epi, name)
        monkeypatch.setattr(jbu, name, lambda *a, n=name, f=fn: calls.append(n) or f(*a))
    monkeypatch.setenv("RS_OV_JBU_FUSED_RANGE", "1")
    got = jbu.jbu_one_forward_nhwc_classify(mod, _t(src).permute(0, 2, 3, 1), _t(guid),
                                            _t(qf), stages=stages)
    assert calls == ["jbu_epilogue_fused"] * (stages - 1) + ["jbu_epilogue_fused_classify"]
    assert _rel(got.numpy(), ref).max() <= 1e-5


def test_switch_is_read_at_call_time(monkeypatch):
    """Unset or not "1", the channel-last stage takes the split route."""
    tree, mod = _weights("jbu_one")
    src, guid = torch.randn(1, 5, 6, C), torch.randn(1, 3, 10, 12)
    seen = []
    monkeypatch.setattr(jbu, "jbu_epilogue_fused", lambda *a: seen.append("fused"))
    monkeypatch.setattr(jbu, "jbu_epilogue", lambda *a: seen.append("split"))
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("RS_OV_JBU_FUSED_RANGE", raising=False)
        else:
            monkeypatch.setenv("RS_OV_JBU_FUSED_RANGE", value)
        jbu.jbu_module_forward_nhwc(mod.up, src, guid, 5)
    assert seen == ["split", "split", "fused"]


def test_cpu_tensors_take_the_plain_route():
    case = _stage_case(1, 4, 6, 7, 5, 3, 4, seed=1)
    before = build.launch_counts()
    args = _torch_stage(case, 5, torch.bfloat16)
    assert epi.jbu_epilogue_fused(*args, 5).shape == (1, 6, 7, 4)
    out = epi.jbu_epilogue_fused_classify(*args, *_torch_tail(case, torch.bfloat16), 5)
    assert out.shape == (1, 6, 7, 3) and out.dtype == torch.float32
    assert build.launch_counts() == before
    with pytest.raises(NotImplementedError, match="no route"):
        epi.jbu_epilogue_fused(*(a.to("meta") for a in args), 5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The operand checks run before the library is touched, so they hold
    here."""
    case = _stage_case(1, 4, 6, 7, 5, 3, 4, seed=2)
    args = list(_torch_stage(case, 5, torch.bfloat16))
    fused, fused_cls = epi._fused_operands, epi._fused_classify_operands
    with pytest.raises(NotImplementedError, match="fp32 takes the channel-first route"):
        fused(*_torch_stage(case, 5, torch.float32), 5)
    bad = list(args)
    bad[2] = bad[2].permute(0, 2, 3, 1).contiguous()  # guidance channel-last
    with pytest.raises(ValueError, match="guid_cf"):
        fused(*bad, 5)
    bad = list(args)
    bad[1] = bad[1].bfloat16()
    with pytest.raises(ValueError, match="proj"):
        fused(*bad, 5)
    bad = list(args)
    bad[0] = bad[0][..., :3].contiguous()
    with pytest.raises(ValueError, match="even channel count"):
        fused(*bad, 5)
    with pytest.raises(ValueError, match="r <= min"):  # r = 5 > H - 1 = 5 fails at H = 5
        small = _stage_case(1, 4, 5, 7, 11, 3, 4, seed=3)
        fused(*_torch_stage(small, 11, torch.bfloat16), 11)
    with pytest.raises(ValueError, match="odd d"):
        fused(*_torch_stage(_stage_case(1, 4, 6, 7, 4, 3, 4, seed=3), 4, torch.bfloat16), 4)
    with pytest.raises(ValueError, match="weight of shape"):
        fused(*args[:5], torch.randn(25, 27), *args[6:], 5)
    with pytest.raises(ValueError, match="fixup_w"):
        fused_cls(*args, torch.randn(4, 5), torch.randn(4), torch.randn(3, 4), 5)
    for q in (0, 129):  # K3's query limit
        with pytest.raises(ValueError, match=f"1 to 128 queries, got {q}"):
            fused_cls(*args, torch.randn(4, 4), torch.randn(4), torch.randn(q, 4), 5)
    # d past 17: the band of 16 + d - 1 columns no longer fits 32 (K2's limit)
    with pytest.raises(ValueError, match="d <= 17, got 19"):
        fused(*_torch_stage(_stage_case(1, 4, 30, 30, 19, 3, 4, seed=4), 19, torch.bfloat16), 19)
    # a block over the 227 KB it may use is refused with its size: C = 2048
    # takes 303872 bytes at d = 5 (y and the tail's res, 4 KB a pixel)
    wide = _stage_case(1, 2048, 6, 7, 5, 3, 4, seed=4)
    with pytest.raises(ValueError, match=r"303872 bytes of shared memory at d=5, C=2048"):
        fused(*_torch_stage(wide, 5, torch.bfloat16), 5)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (skipped without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,k", [(5, 12, 11, 4), (11, 6, 9, 32), (11, 28, 28, 32),
                                     (7, 37, 19, 32)])
def test_fused_kernels_match_plain(cuda, d, h, w, k):
    """K5a within 1e-2 of max|ref| (K2's bound: a bf16 rounding flip of comb'
    or of the output); K5b within 1e-3 (K3's)."""
    case = _stage_case(2, 64, h, w, d, 3, k, seed=17)
    args = [a.to(cuda) for a in _torch_stage(case, d, torch.bfloat16)]
    n = build.launch_counts()["jbu_epilogue_fused"]
    got = epi.jbu_epilogue_fused(*args, d).float()
    ref = epi.jbu_epilogue_fused_plain(*args, d).float()
    assert build.launch_counts()["jbu_epilogue_fused"] == n + 1
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-2
    tail = [a.to(cuda) for a in _torch_tail(case, torch.bfloat16)]
    tail[2] = torch.nn.functional.normalize(tail[2], dim=-1)
    got = epi.jbu_epilogue_fused_classify(*args, *tail, d)
    ref = epi.jbu_epilogue_fused_classify_plain(*args, *tail, d)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-3


def _split_pair_cuda(args, d, tail=None):
    """The split route's kernels on the fused operands, on the card: K1 on
    the reflect-padded channel-first projection (past K1's 32 channels, the
    plain fused logits, summed in K1's order), the reflect-padded source,
    then K2 or K3."""
    from rs_ov_torch.kernels.range_logits import KMAX, range_logits

    inp, proj, guid, *rest = args
    r = d // 2
    if proj.shape[-1] <= KMAX:
        pcf = proj.permute(0, 3, 1, 2).contiguous()
        logits = range_logits(reflect_pad_2d(pcf, r).contiguous(), pcf, d).permute(0, 2, 3, 1)
    else:
        logits = epi._fused_logits(proj, d)
    split = (reflect_pad_nhwc(inp, r).contiguous(), logits.contiguous(),
             guid.permute(0, 2, 3, 1).contiguous(), *rest)
    if tail is None:
        return epi.jbu_epilogue(*split, d)
    return epi.jbu_epilogue_classify(*split, *tail, d)


# (d, H, W, K, C, Q): d in {3, 11, 17} by C in {64, 512, 514} (514: even,
# not a multiple of 8, so 4-byte copies), K in {4, 32, 100} (100: four
# window chunks, the last of 4 channels), Q in {8, 128}; odd H, W not a
# multiple of 16, and r = H - 1 (the reflection's limit) in the second case
# of each d
SPLIT_CASES = [(3, 13, 19, 4, 64, 8), (3, 2, 40, 100, 512, 128), (3, 13, 19, 32, 514, 8),
               (11, 13, 19, 32, 64, 128), (11, 6, 9, 32, 512, 8), (11, 13, 35, 100, 514, 8),
               (17, 17, 19, 32, 512, 128), (17, 9, 20, 4, 64, 8), (17, 13, 21, 100, 514, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w,k,c,q", SPLIT_CASES)
def test_fused_kernels_equal_the_split_pair(cuda, d, h, w, k, c, q):
    """K5a and K5b equal the split pair they replace (K1 + reflect pads + K2
    / K3, all on the card) bit for bit: phase 0 sums the logits as K1 does,
    and every later phase is K2's / K3's on the same blocks and the same
    staged values."""
    case = _stage_case(2, c, h, w, d, 3, k, seed=d + k + c)
    case["proj"] /= np.sqrt(k)  # the tap softmax spreads over the window
    args = [a.to(cuda) for a in _torch_stage(case, d, torch.bfloat16)]
    rng = np.random.RandomState(q)
    tail = (_t(case["fw"], torch.bfloat16).to(cuda), _t(case["fb"], torch.bfloat16).to(cuda),
            torch.nn.functional.normalize(_t(rng.randn(q, c)), dim=-1).to(cuda))
    n = build.launch_counts()
    got_a = epi.jbu_epilogue_fused(*args, d)
    got_b = epi.jbu_epilogue_fused_classify(*args, *tail, d)
    after = build.launch_counts()
    assert (after["jbu_epilogue_fused"], after["jbu_epilogue_fused_classify"]) == (
        n["jbu_epilogue_fused"] + 1, n["jbu_epilogue_fused_classify"] + 1)
    ref_a, ref_b = _split_pair_cuda(args, d), _split_pair_cuda(args, d, tail)
    assert got_b.shape == (2, h, w, q)
    print(f"K5 d={d} {h}x{w} K={k} C={c} Q={q}: {int((got_a != ref_a).sum())} of "
          f"{ref_a.numel()} K5a and {int((got_b != ref_b).sum())} of {ref_b.numel()} K5b "
          f"outputs differ from the split pair")
    assert torch.equal(got_a, ref_a) and torch.equal(got_b, ref_b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [72, 512])
def test_fused_kernels_repair_every_sum_past_their_queue(cuda, c):
    """A constant projection makes every logit equal, so with the spatial
    kernel 1 at taps (0, 0) and (0, 2) and 0 elsewhere and the range MLP's
    weights 0, comb' is exactly 0.5 at those two taps; the source alternates
    between two neighbouring bf16 values every two columns, so y is their
    midpoint at every pixel whose two taps do not reflect onto one column,
    and a tiny fixup weight with a bias put (y Wf^T + bf) * 0.1 within a few
    ulps of a midpoint. Each block then queues more repairs than it holds,
    in the conv and in K5b's fixup product, and takes every sum again in
    order: K5a equals its plain version, and both kernels the split pair,
    bit for bit."""
    d, h, w, k, q = 3, 5, 20, 4, 5
    rng = np.random.RandomState(23)
    lo = torch.from_numpy(rng.uniform(0.5, 1.0, c).astype(np.float32)).to(torch.bfloat16)
    hi = (lo.view(torch.int16) + 1).view(torch.bfloat16)
    inp = torch.where((torch.arange(w) // 2 % 2 == 1)[:, None], hi, lo).expand(1, h, w, c)
    spatial = torch.zeros(d * d)
    spatial[[0, 2]] = 1.0
    zeros = [torch.zeros(s) for s in ((9, 12), (9,), (9, 9), (9,))]
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], c).astype(np.float32))
    mid = sign * (1 + (2 * torch.from_numpy(rng.randint(0, 64, c)).float() + 1) / 256)
    args = [a.to(cuda) for a in (
        inp.contiguous(), torch.ones(1, h, w, k),
        torch.from_numpy(rng.randn(1, 3, h, w)).to(torch.bfloat16), spatial,
        torch.tensor(1.3), *zeros)]
    tail = [a.to(cuda) for a in (
        torch.from_numpy(rng.randn(c, c) * 1e-7).to(torch.bfloat16), mid / 0.1,
        torch.nn.functional.normalize(torch.from_numpy(rng.randn(q, c)).float(), dim=-1))]
    comb = epi._comb_fixed(epi._fused_logits(args[1], d), args[2].permute(0, 2, 3, 1),
                           *args[3:], torch.bfloat16)
    y = epi._adaptive_conv_nhwc(reflect_pad_nhwc(args[0], 1), comb, d)
    near = (y.view(torch.int32) & 0xffff) == 0x8000
    assert int(near[0, :2, :16].sum()) > 512  # the first block's queue (QCAP) overflows
    got = epi.jbu_epilogue_fused(*args, d)
    assert torch.equal(got, epi.jbu_epilogue_fused_plain(*args, d))
    assert torch.equal(got, _split_pair_cuda(args, d))
    assert torch.equal(epi.jbu_epilogue_fused_classify(*args, *tail, d),
                       _split_pair_cuda(args, d, tail))


@pytest.mark.cuda
def test_block_smem_mirror_matches_the_library(cuda):
    """The wrappers' shared-memory count (the refusal before the library is
    loaded) equals the kernels' own layout, K2/K3 (K = 0) and K5."""
    from rs_ov_torch.kernels.build import load_library

    lib = load_library()
    for d, g, cmid, c, k in [(3, 3, 9, 64, 4), (11, 3, 121, 512, 32), (17, 3, 289, 514, 100),
                             (11, 3, 121, 1408, 0), (5, 3, 1, 2048, 33), (17, 3, 1, 64, 32),
                             (7, 3, 49, 896, 5)]:
        assert epi._block_smem_bytes(d, g, cmid, c, k) == lib.rs_jbu_block_smem(d, g, cmid, c, k)
