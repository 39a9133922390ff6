"""The port's profiling utilities (rs_ov_torch/utils/profiling.py) against the
JAX package's (rs_ov/utils/profiling.py): ``trace`` and ``annotate`` as the
JAX package has them; ``trace`` writes a trace whose events hold an
``annotate`` span. The port's span recorder: tests/test_torch_tracing.py."""

import glob
import inspect
import json
import os

import torch

from rs_ov.utils import profiling as jax_profiling
from rs_ov_torch.utils import profiling


def test_the_api_is_the_jax_packages():
    for mod in (profiling, jax_profiling):
        assert {"trace", "annotate"} <= set(mod.__all__)
        assert list(inspect.signature(mod.trace).parameters)[0] == "logdir"

        def stage():
            return 1

        wrapped = mod.annotate("rs_ov_stage")(stage)
        assert wrapped.__name__ == "stage" and wrapped() == 1


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
