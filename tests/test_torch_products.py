"""The port's products with fp32 sums (``rs_ov_torch.nn.layers.matmul32``,
under ``linear`` and attention's ``_bmm``) against the JAX package's
``preferred_element_type=jnp.float32`` products, and on a card the bf16
tensor-core route against the upcast one.

Inputs are made with numpy from a seed and fed to both sides.
"""

import numpy as np
import pytest
import torch

from rs_ov_torch.nn import attention
from rs_ov_torch.nn.layers import linear, matmul32

torch.set_num_threads(1)


def _t(shape, seed, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(
        device, dtype)


@pytest.mark.parametrize("sa,sb", [((5, 7), (7, 3)), ((2, 5, 7), (7, 3)),
                                   ((2, 3, 5, 7), (2, 3, 7, 4)), ((2, 3, 5, 7), (3, 7, 4)),
                                   ((1, 3, 5, 7), (2, 1, 7, 4))])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.float32)], ids=["bf16", "fp32", "mixed"])
def test_cpu_takes_the_upcast(sa, sb, dtypes):
    """On the CPU the product is torch.matmul of the fp32 upcasts, bit for
    bit, with matmul's broadcasting and an fp32 result."""
    a, b = _t(sa, 0, dtypes[0]), _t(sb, 1, dtypes[1])
    got = matmul32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.matmul(a.float(), b.float()), rtol=0, atol=0)


def test_linear_and_bmm_match_the_jax_package():
    """linear and _bmm on bf16 operands against rs_ov's (dot_general / einsum
    with fp32 results): bf16 products are exact in fp32, so only the order of
    the sums differs; linear returns the input's dtype."""
    jnp = pytest.importorskip("jax").numpy
    from rs_ov.nn import attention as jattn
    from rs_ov.nn import layers as jlayers

    x, w, bias = _t((3, 9, 40), 2), _t((24, 40), 3), _t((24,), 4)
    got = linear(x.bfloat16(), w.bfloat16(), bias.bfloat16())
    ref = jlayers.linear(jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(w.numpy(), jnp.bfloat16),
                         jnp.asarray(bias.numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert np.sum(diff > 0) <= 2  # a bf16 rounding flip of a sum taken in another order
    a, b = _t((2, 3, 17, 16), 5), _t((2, 3, 16, 17), 6)
    got = attention._bmm(a.bfloat16(), b.bfloat16())
    ref = np.asarray(jattn._bmm(jnp.asarray(a.numpy(), jnp.bfloat16),
                                jnp.asarray(b.numpy(), jnp.bfloat16)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_other_devices_raise():
    with pytest.raises(NotImplementedError, match="no route"):
        matmul32(torch.empty(2, 3, device="meta"), torch.empty(3, 4, device="meta"))


# ---------------------------------------------------------------------------
# the tensor-core route on a card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the out_dtype products have no CPU kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 197, 768), (394, 768)])
def test_linear_within_one_bf16_step_of_the_upcast(cuda, shape):
    """bf16 x bf16 on the tensor cores with fp32 sums against the fp32
    upcast: the same exact products summed in another order, so each bf16
    output lies within one bf16 step of the upcast's (the step taken at no
    less than 1e-5 of the largest sum, where a sum cancels)."""
    x, w, bias = (_t(s, i, torch.bfloat16, cuda) for i, s in
                  enumerate((shape, (2304, 768), (2304,))))
    got = linear(x, w, bias).float()
    ref32 = torch.matmul(x.float(), w.float().t()) + bias.float()
    step = torch.maximum(ref32.abs() * 2.0 ** -7, ref32.abs().max() * 1e-5)
    assert bool(((got - ref32.to(torch.bfloat16).float()).abs() <= step).all())


@pytest.mark.cuda
def test_bmm_within_1e5_of_the_upcast(cuda):
    """Attention's batched products, bf16 operands: within 1e-5 of max|ref|
    of the upcast (fp32 results, only the order of the sums differs)."""
    q, k = _t((16, 12, 197, 64), 0, torch.bfloat16, cuda), _t((16, 12, 197, 64), 1,
                                                               torch.bfloat16, cuda)
    got = attention._bmm(q, k.transpose(-1, -2))
    ref = torch.matmul(q.float(), k.float().transpose(-1, -2))
    assert got.dtype == torch.float32
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_no_fp32_copy_of_a_weight(cuda):
    """Under torch.profiler, a bf16 linear layer runs no cast of its weight
    to fp32: no elementwise kernel touches as many elements as the weight."""
    from torch.profiler import ProfilerActivity, profile

    x, w = _t((394, 768), 0, torch.bfloat16, cuda), _t((3072, 768), 1, torch.bfloat16, cuda)
    linear(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        linear(x, w)
        torch.cuda.synchronize()
    casts = [e for e in prof.events() if e.name in ("aten::to", "aten::_to_copy", "aten::copy_")
             and any(list(s) == [3072, 768] or list(s) == [768, 3072] for s in e.input_shapes
                     if s)]
    assert not casts, [(e.name, e.input_shapes) for e in casts]
