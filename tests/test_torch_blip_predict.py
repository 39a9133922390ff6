"""The port's BLIP predictor (python -m rs_ov_torch.blip_predict) on the
CPU: each of the three tasks with --tiny --random-init --device cpu gives
the reference's output string; the argument refusals match
tools/blip_predict.py's; with no card and no --device it raises."""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rs_ov_torch import blip_predict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("img") / "photo.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (40, 56, 3), np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("task,extra,pattern", [
    ("image_captioning", [], r"Caption: [\w# ]*"),
    ("visual_question_answering", ["--question", "where is the tree?"], r"Answer: [\w# ]*"),
    ("image_text_matching", ["--caption", "a picture of a tree"],
     r"The image and text is matched with a probability of 0\.\d{4}\.\n"
     r"The image feature and text feature has a cosine similarity of -?[01]\.\d{4}\.")])
def test_each_task_runs_tiny_on_the_cpu(image, task, extra, pattern, capsys):
    out = blip_predict.main(["--task", task, "--image", image, "--tiny", "--random-init",
                             "--device", "cpu"] + extra)
    assert re.fullmatch(pattern, out), out
    assert capsys.readouterr().out.strip() == out
    assert out == blip_predict.main(["--task", task, "--image", image, "--tiny",
                                     "--random-init", "--device", "cpu"] + extra)


def test_refusals(image, monkeypatch):
    for argv, msg in ((["--task", "visual_question_answering"], "question"),
                      (["--task", "image_text_matching"], "caption"),
                      ([], "--pretrained")):
        with pytest.raises(SystemExit, match=msg):
            blip_predict.main(["--image", image] + argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blip_predict.main(["--image", image, "--tiny", "--random-init"])


def test_module_entry_runs(image):
    """``python -m rs_ov_torch.blip_predict`` from the repo root."""
    out = subprocess.run([sys.executable, "-m", "rs_ov_torch.blip_predict", "--image", image,
                          "--tiny", "--random-init", "--device", "cpu"], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.startswith("Caption: ")
