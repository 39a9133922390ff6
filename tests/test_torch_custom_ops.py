"""The kernels as declared in rs_ov_torch/kernels/build.py (``Kernel``):
each operator of the ``rs_ov`` namespace with its schema and fake
implementation checked by ``torch.library.opcheck`` on CPU sample inputs,
without the kernel library; each public callable refusing a tensor on any
other device; the launch table naming every kernel's counters. On a card
(``cuda`` tests, skipped here) each operator against the direct launch of
its kernel, its fake against the real output, each eager call launching the
kernel without the operator, and the serving export of a small segmentor on
the default route.

This file imports no jax, so that on a card it runs with

    python -m pytest tests/test_torch_custom_ops.py --noconftest -m cuda
"""

import inspect
import zlib

import numpy as np
import pytest
import torch

from rs_ov_torch.kernels import adaptive_conv as ac
from rs_ov_torch.kernels import build
from rs_ov_torch.kernels import jbu_epilogue as epi
from rs_ov_torch.kernels import layer_norm as ln
from rs_ov_torch.kernels import linear_epilogue as le
from rs_ov_torch.kernels import range_logits as rl
from rs_ov_torch.kernels import selfself_attention as sa

torch.set_num_threads(1)

D, H, W, C, G, CMID, Q, K = 3, 6, 7, 8, 3, 5, 3, 4
MODULES = (rl, epi, ac, sa, ln, le)
# the kernels whose bf16 and fp32 operands take two library entries: a case each
BY_DTYPE = ("adaptive_conv_tapmajor", "fused_selfself_attention", "layer_norm",
            "linear_epilogue")
# every declared kernel, as "<operator>" or "<operator>[<dtype>]"
OPS = [name + case for name in sorted(build.KERNELS)
       for case in (("[bf16]", "[fp32]") if name in BY_DTYPE else ("",))]
# the names launch_counts() has always given the spans and chip_smoke
LAUNCH_NAMES = ("range_logits", "jbu_epilogue", "jbu_epilogue_classify", "jbu_epilogue_fused",
                "jbu_epilogue_fused_classify", "adaptive_conv_tapmajor.bf16",
                "adaptive_conv_tapmajor.f32", "adaptive_conv_planes", "adaptive_conv_cl",
                "adaptive_conv_v3", "adaptive_conv_v4", "fused_selfself_attention", "layer_norm",
                "linear_epilogue")


def _samples(name: str, device) -> tuple:
    """The operator's arguments, drawn from a seed: the dtypes and layouts
    its kernel takes. The seed is a hash of the name alone, so that adding
    an operator leaves the others' samples as they were."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))

    def t(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(np.asarray(rng.randn(*shape) * scale, np.float32)).to(
            device=device, dtype=dtype)

    bf = torch.bfloat16
    stage = (t(D * D), t(), t(CMID, D * D + G, scale=0.3), t(CMID, scale=0.1),
             t(D * D, CMID, scale=0.3), t(D * D, scale=0.1))
    tail = (t(C, C, scale=0.2, dtype=bf), t(C, scale=0.1), t(Q, C))
    padded_nhwc = t(2, H + D - 1, W + D - 1, C, dtype=bf)
    if name == "range_logits":
        return t(2, K, H + D - 1, W + D - 1), t(2, K, H, W), D
    if name in ("jbu_epilogue", "jbu_epilogue_classify"):
        front = (padded_nhwc, t(2, H, W, D * D), t(2, H, W, G, dtype=bf), *stage)
        return (*front, *tail, D) if name.endswith("classify") else (*front, D)
    if name.startswith("jbu_epilogue_fused"):
        front = (t(2, H, W, C, dtype=bf), t(2, H, W, K), t(2, G, H, W, dtype=bf), *stage)
        return (*front, *tail, D) if name.endswith("classify") else (*front, D)
    if name.startswith("adaptive_conv"):
        dt = torch.float32 if name.endswith("[fp32]") else bf
        filt_dt = torch.float32 if name in ("adaptive_conv_planes", "adaptive_conv_v3") else dt
        return t(2, C, H + D - 1, W + D - 1, dtype=dt), t(2, D * D, H, W, dtype=filt_dt), D
    dt = torch.float32 if name.endswith("[fp32]") else bf
    if name.startswith("layer_norm"):
        return t(2, 5, 24, dtype=dt), t(24, dtype=dt), t(24, dtype=dt, scale=0.1), 1e-5
    if name.startswith("linear_epilogue"):
        return t(2, 5, 24, scale=3.0), t(24, dtype=bf, scale=0.5), "quick_gelu", dt
    q, k, v = (t(2, 3, 17, 16, dtype=dt) for _ in range(3))
    return q, k, v, t(2, 17, 17, scale=0.1), "SCLIP", 0.7


def _kernel(name: str) -> build.Kernel:
    return build.KERNELS[name.split("[")[0]]


def _op(name: str):
    return getattr(torch.ops.rs_ov, name.split("[")[0]).default


def _public_fn(name: str):
    """The public callable of the kernel's module."""
    base = name.split("[")[0]
    return next(getattr(m, base) for m in MODULES if hasattr(m, base))


def _public(name: str, args: tuple):
    """The public callable on ``args``, the operator's arguments (K6 takes
    its mode and weight by keyword)."""
    if name.startswith("fused_selfself_attention"):
        return _public_fn(name)(*args[:4], mode=args[4], sim_weight=args[5])
    return _public_fn(name)(*args)


def _launches(name):
    counts = build.launch_counts()
    return sum(counts[c] for c in _kernel(name).counters)


def test_every_kernel_wrapper_has_its_operator():
    """One operator per public wrapper (K4a and K4b share one, by dtype)."""
    assert sorted({n.split("[")[0] for n in OPS}) == sorted(
        name for name in dir(torch.ops.rs_ov) if not name.startswith("_")
        and isinstance(getattr(torch.ops.rs_ov, name), torch._ops.OpOverloadPacket))


def test_the_launch_table_names_every_kernels_counters():
    """launch_counts() has exactly the names the spans and chip_smoke read,
    each the counter of one declared kernel."""
    assert tuple(sorted(build.launch_counts())) == tuple(sorted(LAUNCH_NAMES))
    assert sorted(c for k in build.KERNELS.values() for c in k.counters) == sorted(LAUNCH_NAMES)


@pytest.mark.parametrize("name", OPS)
def test_operator_schema_and_fake_on_the_cpu(name, monkeypatch):
    """opcheck's schema and fake-tensor checks on the CPU implementation, the
    plain version; the kernel library is never loaded."""
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build, "load_library", no_library)
    torch.library.opcheck(_op(name), _samples(name, "cpu"),
                          test_utils=("test_schema", "test_faketensor"))
    before = _launches(name)
    _op(name)(*_samples(name, "cpu"))
    assert _launches(name) == before


@pytest.mark.parametrize("name", OPS)
def test_the_public_callable_refuses_other_devices(name):
    """Each kernel's public callable refuses a meta tensor with an error that
    names the kernel, and counts no launch."""
    before = build.launch_counts()
    with pytest.raises(NotImplementedError, match=f"^{name.split('[')[0]}: no route for meta"):
        _public(name, tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                            for a in _samples(name, "cpu")))
    assert build.launch_counts() == before


@pytest.mark.parametrize("name", OPS)
def test_the_public_callable_takes_keywords(name):
    """Each public callable takes every argument by keyword, by the names
    its signature gives, with the positional call's output."""
    args = _samples(name, "cpu")
    fn = _public_fn(name)
    got = fn(**dict(zip(inspect.signature(fn).parameters, args)))
    assert torch.equal(got, _public(name, args))


# ---------------------------------------------------------------------------
# on a card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OPS))
def test_operator_equals_the_direct_launch(cuda, name):
    """On CUDA tensors the operator launches the kernel (counted once) and
    gives the direct launch's output exactly; its fake gives the real
    output's shape, dtype and strides."""
    args = _samples(name, cuda)
    want = _kernel(name).launch(*args)
    before = _launches(name)
    got = _op(name)(*args)
    assert _launches(name) == before + 1
    assert torch.equal(got, want)
    torch.library.opcheck(_op(name), args, test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPS)
def test_eager_calls_on_the_card_skip_the_operators_dispatch(cuda, name, monkeypatch):
    """An eager CUDA call of the public callable launches the kernel without
    the operator (one launch counted), bit for bit the operator's output."""
    args = _samples(name, cuda)
    want = _op(name)(*args)
    monkeypatch.setattr(_kernel(name), "op", lambda *a: pytest.fail("the operator was called"))
    before = _launches(name)
    got = _public(name, args)
    assert _launches(name) == before + 1 and torch.equal(got, want)


@pytest.mark.cuda
def test_export_on_the_card_serves_the_kernels(cuda, tmp_path):
    """A small segmentor (random weights, bf16) on the card's default route:
    the served program equals the live predict_raw and launches K1, K2 and
    K3 as often."""
    from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
    from rs_ov_torch.pipeline.export import export_predict, load_predict
    from rs_ov_torch.pipeline.segmentor import SegmentorEx

    cfg = CLIPConfig(embed_dim=32, vision=VisionConfig(
        image_size=64, patch_size=16, width=64, layers=3, output_dim=32, head_width=32),
        text=TextConfig(context_length=77, vocab_size=49408, width=32, heads=2, layers=1,
                        output_dim=32))
    seg = SegmentorEx(name_path="configs/cls_potsdam.txt", slide_stride=32, slide_crop=64,
                      global_debias_factor=0.2, apply_sim_feat_up=True,
                      apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=5),
                      apply_similarity_enhancement=True, clip_config=cfg)
    img = np.random.RandomState(0).randint(0, 256, (96, 128, 3), np.uint8)
    path = str(tmp_path / "tiny.rsovt")
    assert export_predict(seg, (96, 128), path)["platforms"] == ["cuda"]
    fn = load_predict(path)
    names = ("range_logits", "jbu_epilogue", "jbu_epilogue_classify", "linear_epilogue")
    before = [_launches(n) for n in names]
    live = seg.predict_raw(img[None])[0]
    mid = [_launches(n) for n in names]
    got = fn(img)
    after = [_launches(n) for n in names]
    assert all(m > b for m, b in zip(mid, before))
    assert [a - m for a, m in zip(after, mid)] == [m - b for m, b in zip(mid, before)]
    assert torch.equal(got["pred_sem_seg"], live["pred_sem_seg"])
    assert torch.equal(got["probs"], live["seg_logits"])
