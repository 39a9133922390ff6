"""The training CLIs on 2 gloo ranks (``--mesh 2,1``, each rank in a
process of its own, joined through a ``file://`` store as torchrun's
ranks would be): the CLIP and SigLIP runs' last loss against the
one-process run's, within 1e-4 relative (the sums run in another order and
AdamW carries the difference on), and BLIP retrieval training
data-parallel to a finite loss."""

import json
import math

import pytest

from rs_ov_torch.train import __main__ as train_cli
from torch_dist_workers import cli_worker, spawn

CLIP_ARGS = ["--tiny", "--synthetic", "--steps", "3", "--batch-size", "8", "--precision",
             "fp32", "--warmup", "1", "--log-every", "1", "--lr", "1e-4", "--device", "cpu"]


def _last(capsys):
    return json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_two_rank_cli_matches_one_process(loss, tmp_path, capsys):
    args = CLIP_ARGS + ["--loss", loss, "--no-resume"]
    train_cli.main(args)
    one = _last(capsys)
    res = spawn(cli_worker, 2, tmp_path, "rs_ov_torch.train.__main__",
                args + ["--mesh", "2,1"])
    two = json.loads(str(res["last"]))
    assert two["step"] == one["step"] == 3
    assert abs(two["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]), (two, one)


def test_two_rank_blip_retrieval_cli_trains(tmp_path):
    res = spawn(cli_worker, 2, tmp_path, "rs_ov_torch.train_blip",
                ["--task", "retrieval", "--tiny", "--synthetic", "--steps", "2",
                 "--batch-size", "8", "--log-every", "1", "--device", "cpu", "--mesh", "2,1"])
    last = json.loads(str(res["last"]))
    assert last["step"] == 2
    assert all(math.isfinite(v) for k, v in last.items() if k.startswith("loss"))
