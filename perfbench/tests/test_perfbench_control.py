"""The lower-precision control: the reference with fp8 (e4m3) products put
in the program's place must come out not correct against the fp32
reference under each configuration's limits. At a size a test run holds on
the CPU, and (on the card) at the cell's own size."""

import pytest
import torch

from perfbench.harness import cell, compare, spec


def _control(c, seed, device):
    return compare.judge(cell.control_numbers(c, seed, device), c.config["limits"])


@pytest.mark.parametrize("variant", ["b16", "l14"])
def test_the_fp8_control_is_not_correct_at_a_small_size(tiny, variant):
    c = tiny(variant, "batch")
    c.config["dtype"] = "bfloat16"  # the weights as served
    ok, checks = _control(c, 5, torch.device("cpu"))
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["b16.batch8", "l14.batch8"])
def test_the_fp8_control_is_not_correct_at_the_cells_size(cuda, workload):
    c = spec.resolve(spec.load_benchmark(), workload)
    for seed in (31, 32, 33):
        ok, checks = _control(c, seed, cuda)
        assert not ok, (seed, checks)
        torch.cuda.empty_cache()
