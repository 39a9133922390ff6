"""SimFeatUp ``jbu_one`` at its published 4 stages (16x) on ``SegmentorEx``'s
normal path, on the CPU in fp32 at tiny widths: the benchmark configuration
``clip-vitb16-segearth-jbu4`` with crops of 32 and patches of 8, so each
crop's 4 x 4 tokens are upsampled to 64 x 64, on weights drawn from a seed.

* Through ``predict_batch_raw`` and ``predict_raw`` the program matches the
  benchmark's plain reference (``perfbench/reference/segearth.py``), run by
  the benchmark's own harness: mean probability gap under 1e-5, no label
  decided by the reference flipped.
* Uneven chunks (5 crops in chunks of 3 and 2) give the one-chunk result
  exactly. (A chunk of one crop is not compared: there the CPU's einsum
  returns the range projection in another memory layout, and its exact GELU
  then differs from the vectorised one in the last bit. On the card the
  layout changes no result; the ``cuda`` chunk tests hold that.)
* With the recorder on, each ``rs_ov/entry/chunk`` span says how many chunks
  its call ran and holds four ``rs_ov/jbu/stage`` spans of sides 8, 16, 32
  and 64, each with the bytes of its epilogue's operands.
"""

import copy
import tempfile
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cell, inputs, spec
from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov_torch.utils import profiling

torch.set_num_threads(1)

CONFIG = "clip-vitb16-segearth-jbu4"
TOWER = {"image_size": 32, "patch_size": 8, "width": 32, "layers": 3, "head_width": 16,
         "mlp_ratio": 4.0, "embed_dim": 16, "quick_gelu": True}
TEXT = {"width": 16, "layers": 1, "heads": 2, "context_length": 8, "vocab_size": 32}
TRAFFIC = {
    "serve": {"entry": "predict_raw", "images_per_call": 1, "image_hw": [64, 64], "pool": 4,
              "warmup_calls": 1, "check_calls": 2, "trace_calls": 1, "rate_per_s": 50.0},
    "batch": {"entry": "predict_batch_raw", "images_per_call": 2, "image_hw": [64, 64],
              "pool": 4, "warmup_calls": 1, "check_calls": 2, "trace_calls": 1},
}
SEED = 2 ** 31 + 24
SIDES = [8, 16, 32, 64]  # the 4 x 4 token grid doubled four times


@pytest.fixture
def tiny(monkeypatch):
    """tiny(traffic) -> a spec.Cell of the 4-stage configuration at tiny
    widths in fp32, the program's tower registry patched to them."""
    import rs_ov_torch.pipeline.segmentor as segmentor

    config = copy.deepcopy(spec.load_json(f"{spec.REPO}/perfbench/configs/{CONFIG}.json"))
    config.update(tower=TOWER, text=TEXT, dtype="float32", name=f"tiny-{CONFIG}", file="-")
    config["recipe"].update(slide_crop=32, slide_stride=16,
                            outlier_suppression_cfg={"top_k": 3, "contamination_temp": 0.1})
    assert config["recipe"]["sim_feat_up_cfg"] == {"model_name": "jbu_one", "num_stages": 4}
    clip = CLIPConfig(
        embed_dim=TOWER["embed_dim"],
        vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=3,
                            output_dim=TOWER["embed_dim"], head_width=16, mlp_ratio=4.0),
        text=TextConfig(context_length=8, vocab_size=32, width=16, heads=2, layers=1,
                        output_dim=TOWER["embed_dim"]),
        quick_gelu=True)
    monkeypatch.setattr(segmentor, "get_model_config", lambda _name: clip)
    monkeypatch.delenv("RS_OV_TILE_CHUNK", raising=False)
    monkeypatch.delenv("RS_OV_JBU_STAGES", raising=False)

    def make(traffic):
        tr = {**TRAFFIC[traffic], "name": traffic}
        return spec.Cell(f"tiny.{traffic}", {"chips": 1}, config, tr, [], [])

    return make


@pytest.mark.parametrize("traffic", ["batch", "serve"])
def test_four_stages_match_the_plain_reference(tiny, traffic):
    result, run = cell.run(tiny(traffic), SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    nums = run.numbers
    assert nums["prob_gap_mean"] < 1e-5, nums
    assert nums["label_flip_decided"] == 0.0, nums
    assert nums["decided_share"] > 0.5, nums
    assert result["correct"]


def _program(tiny):
    """The tiny 4-stage SegmentorEx built from the seed as the benchmark
    builds it, and a 32 x 96 uint8 image: 5 crops of 32 every 16."""
    c = tiny("batch")
    with tempfile.TemporaryDirectory() as tmp:
        seg, _, _, _ = cell.setup(c.config, c.traffic, inputs.seeds(SEED), torch.device("cpu"),
                                  tmp)
    image = np.random.RandomState(5).randint(0, 256, (1, 32, 96, 3), np.uint8)
    return seg, image


@pytest.mark.parametrize("entry", ["predict_batch_raw", "predict_raw"])
def test_uneven_chunks_equal_one_chunk(tiny, entry):
    seg, image = _program(tiny)
    assert seg.jbu_stages == 4
    out = {}
    for chunk in (5, 3):
        seg.tile_chunk = chunk
        with profiling.recording():
            out[chunk] = getattr(seg, entry)(image)
        got = [r["attrs"]["crops"] for r in profiling.spans() if r["name"] == "rs_ov/entry/chunk"]
        assert got == ([5] if chunk == 5 else [3, 2]), got
    for one, split in zip(out[5], out[3]):
        assert torch.equal(one["seg_logits"], split["seg_logits"])
        assert torch.equal(one["pred_sem_seg"], split["pred_sem_seg"])


def test_each_chunk_holds_four_stage_spans(tiny):
    seg, image = _program(tiny)
    seg.tile_chunk = 2
    with profiling.recording():
        seg.predict_batch_raw(image)
    records = profiling.spans()
    by_id = {r["id"]: r for r in records}
    chunks = [r for r in records if r["name"] == "rs_ov/entry/chunk"]
    assert [(c["attrs"]["crops"], c["attrs"]["of"]) for c in chunks] == [(2, 3), (2, 3), (1, 3)]
    for c in chunks:
        assert c["attrs"]["peak_bytes"] > 0 and "budget" not in c["attrs"]  # no card
        (call,) = [r for r in records if r["name"] == "rs_ov/jbu/call" and r["parent"] == c["id"]]
        stages = [r for r in records if r["name"] == "rs_ov/jbu/stage"
                  and by_id[r["parent"]] is call]
        assert [s["attrs"]["stage"] for s in stages] == [0, 1, 2, 3]
        assert [s["attrs"]["side"] for s in stages] == SIDES
        crops, dim = c["attrs"]["crops"], TOWER["embed_dim"]
        # the CPU's channel-first route: the padded fp32 bicubic source and
        # the fp32 tap-major taps
        assert [s["attrs"]["operand_bytes"] for s in stages] == [
            4 * crops * (dim * (side + 10) ** 2 + 121 * side ** 2) for side in SIDES]
