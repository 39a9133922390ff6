"""The port's profiling utilities (rs_ov_torch/utils/profiling.py) against the
JAX package's (rs_ov/utils/profiling.py): the same API; ``Throughput``'s
numbers equal under one clock; ``trace`` writes a trace whose events hold an
``annotate`` span."""

import glob
import json
import os

import pytest
import torch

from rs_ov.utils import profiling as jax_profiling
from rs_ov_torch.utils import profiling


def test_the_api_is_the_jax_packages():
    assert profiling.__all__ == jax_profiling.__all__
    for name in ("add_image", "elapsed", "tiles512_per_sec", "report"):
        assert hasattr(profiling.Throughput, name)


@pytest.mark.parametrize("sizes,n_chips", [([(512, 512)], 1), ([(512, 512), (1024, 768)], 4),
                                           ([], 2)])
def test_throughput_equals_the_jax_packages(sizes, n_chips, monkeypatch):
    """Started at 10.0 s and read at 12.5 s on both packages' clocks."""
    ours, theirs = [], []
    for mod, out in ((profiling, ours), (jax_profiling, theirs)):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: 10.0)
        t = mod.Throughput()
        for h, w in sizes:
            t.add_image(h, w)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: 12.5)
        out.append((t.pixels, t.elapsed, t.tiles512_per_sec, t.report(n_chips)))
    assert ours == theirs
    pixels = sum(h * w for h, w in sizes)
    assert ours[0][2] == pixels / 512.0 ** 2 / 2.5


def test_trace_writes_the_annotated_span(tmp_path):
    @profiling.annotate("rs_ov_stage")
    def stage(x):
        return torch.relu(x @ x)

    assert stage.__name__ == "stage"
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        stage(torch.randn(32, 32))
    assert "rs_ov_stage" in {e.key for e in prof.key_averages()}
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rs_ov_stage", "aten::relu"} <= names
