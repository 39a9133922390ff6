"""The plain reference against the program (``SegmentorEx``) on the CPU in
fp32 at tiny widths, through the harness's own run of a cell, for both
configurations' recipes and both traffic entries; what the reference and
the harness may import; the import guard."""

import ast
import glob
import os
import time

import pytest
import torch

from perfbench import run as run_py
from perfbench.harness import cell, spec


@pytest.mark.parametrize("variant", ["b16", "l14"])
@pytest.mark.parametrize("traffic", ["serve", "batch"])
def test_reference_matches_the_program_in_fp32(tiny, variant, traffic):
    result, run = cell.run(tiny(variant, traffic), 2 ** 31 + 7, 0.5, False,
                           torch.device("cpu"), time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    nums = run.numbers
    assert nums["prob_gap_mean"] < 1e-5
    assert nums["label_flip_share"] < 1e-3 and nums["label_flip_decided"] == 0.0
    assert nums["decided_share"] > 0.5
    assert result["correct"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_torch_only():
    for path in glob.glob(f"{spec.REPO}/perfbench/reference/*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "torch"}, (path, tops)


def test_the_benchmark_imports_no_jax_and_nothing_of_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "rs_ov", "chip_smoke", "benchmarks", "bench"}
    for path in glob.glob(f"{spec.REPO}/perfbench/**/*.py", recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)


def test_the_import_guard_compares_whole_top_level_names():
    found = run_py.forbidden_modules(["rs_ov_torch", "rs_ov_torch.kernels", "jax.numpy",
                                      "rs_ov", "rs_ov.core", "flax", "jaxlib", "numpy",
                                      "jaxtyping"])
    assert found == ["flax", "jax.numpy", "jaxlib", "rs_ov", "rs_ov.core"]


def test_the_cells_read_no_program_switch(monkeypatch, capsys):
    monkeypatch.setenv("RS_OV_FUSED_ATTN", "1")
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):  # restored after the test
        monkeypatch.setenv(key, "")
    assert run_py.main(["--workload", "b16.serve1", "--seed", "1", "--seconds", "1"]) in (0, 2)
    assert "RS_OV_FUSED_ATTN" not in os.environ
    assert "RS_OV_FUSED_ATTN removed" in capsys.readouterr().err
