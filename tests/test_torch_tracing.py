"""The port's span recorder (rs_ov_torch/utils/profiling.py): off, a span is
one shared object that does nothing and puts nothing in a profiler trace;
on, the spans of a tiny ``SegmentorEx`` nest as the pipeline does (request,
tower, chunks, JBU stages, set-up), each carrying its call's request id and
the kernel operators' launches while it was open, stamped within 50 us of
its ``record_function`` in a profiler trace, exported as a chrome trace; an
exported program is the same with the recorder on or off."""

import collections
import ctypes
import glob
import json
import os
import tracemalloc
from unittest import mock

import numpy as np
import pytest
import torch

from rs_ov_torch.core.config import CLIPConfig, TextConfig, VisionConfig
from rs_ov_torch.kernels import build
from rs_ov_torch.pipeline import export
from rs_ov_torch.pipeline.segmentor import SegmentorEx
from rs_ov_torch.utils import profiling

torch.set_num_threads(1)

CFG = CLIPConfig(
    embed_dim=16,
    vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=3, output_dim=16,
                        head_width=16),
    text=TextConfig(context_length=8, vocab_size=32, width=16, heads=2, layers=1,
                    output_dim=16))
STAGES = 2

# the parent of each program span: the pipeline's nesting
PARENT = {"rs_ov/entry/prepare": "rs_ov/request", "rs_ov/vit/tower": "rs_ov/request",
          "rs_ov/vit/front": "rs_ov/vit/tower", "rs_ov/vit/last": "rs_ov/vit/tower",
          "rs_ov/vit/post": "rs_ov/vit/tower", "rs_ov/entry/chunk": "rs_ov/request",
          "rs_ov/entry/debias": "rs_ov/entry/chunk", "rs_ov/jbu/call": "rs_ov/entry/chunk",
          "rs_ov/jbu/stage": "rs_ov/jbu/call", "rs_ov/jbu/operands": "rs_ov/jbu/stage",
          "rs_ov/jbu/epilogue": "rs_ov/jbu/stage",
          "rs_ov/entry/logit_resize": "rs_ov/entry/chunk",
          "rs_ov/entry/stitch": "rs_ov/request", "rs_ov/entry/postprocess": "rs_ov/request",
          "rs_ov/setup/tower": "rs_ov/setup/segmentor",
          "rs_ov/setup/queries": "rs_ov/setup/segmentor",
          "rs_ov/setup/upsampler": "rs_ov/setup/segmentor"}


def _segmentor(tmp_path, route=None):
    names = tmp_path / "cls.txt"
    names.write_text("background\nbuilding,house\nroad\n")
    seg = SegmentorEx(name_path=str(names), slide_crop=32, slide_stride=16,
                      global_debias_factor=0.2, apply_sim_feat_up=True,
                      sim_feat_up_cfg=dict(model_name="jbu_one", num_stages=STAGES),
                      apply_outlier_suppression=True, outlier_suppression_cfg=dict(top_k=3),
                      apply_similarity_enhancement=True, clip_config=CFG,
                      query_features=np.random.RandomState(0).randn(4, 16).astype(np.float32),
                      device="cpu")
    if route is not None:
        seg._jbu_route = lambda tokens: route
    return seg


def _images(n, hw=(48, 64)):
    return np.random.RandomState(n).randint(0, 256, (n, *hw, 3), np.uint8)


def test_off_is_one_shared_object_that_records_nothing(tmp_path):
    assert profiling._recorder is None
    off = profiling.span("rs_ov/a")
    assert off is profiling.span("rs_ov/b", crops=3) is profiling._OFF
    def spans(n):
        for _ in range(n):
            with profiling.span("rs_ov/a", crops=3):
                pass

    tracemalloc.start()
    try:
        spans(1)
        before = tracemalloc.get_traced_memory()[0]
        spans(1000)
        assert tracemalloc.get_traced_memory()[0] - before <= 0
    finally:
        tracemalloc.stop()
    seg = _segmentor(tmp_path)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        seg.predict_raw(_images(1))
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith("rs_ov/")}
    assert "aten::matmul" in names


def _by_id(records):
    return {r["id"]: r for r in records}


@pytest.mark.parametrize("route", [None, "nhwc_classify"])
def test_spans_nest_as_the_pipeline_does(tmp_path, route):
    with profiling.recording():
        seg = _segmentor(tmp_path, route)
        seg.predict_batch_raw(_images(2))
        seg.predict_raw(_images(1))
    records = profiling.spans()
    by_id = _by_id(records)
    for r in records:
        if r["name"] in PARENT:
            assert by_id[r["parent"]]["name"] == PARENT[r["name"]], r
    requests = [r for r in records if r["name"] == profiling.REQUEST]
    assert [(r["attrs"], r["parent"], r["request"] == r["id"]) for r in requests] == [
        ({"entry": "predict_batch_raw", "images": 2}, None, True),
        ({"entry": "predict_raw", "images": 1}, None, True)]
    for req in requests:
        inside = [r for r in records if r["request"] == req["id"]]
        assert all(req["start"] <= r["start"] <= r["end"] <= req["end"] for r in inside)
        count = collections.Counter(r["name"] for r in inside)
        crops = 6 * req["attrs"]["images"]   # a 48 x 64 image: 2 x 3 crops of 32
        assert count["rs_ov/entry/chunk"] == count["rs_ov/jbu/call"] == crops // 2
        assert count["rs_ov/jbu/stage"] == count["rs_ov/jbu/epilogue"] == crops // 2 * STAGES
        assert count["rs_ov/vit/tower"] == 1
        assert count["rs_ov/entry/stitch"] == req["attrs"]["images"]
        calls = [r for r in inside if r["name"] == "rs_ov/jbu/call"]
        assert {r["attrs"]["route"] for r in calls} == {route or "channel_first"}
        for call in calls:
            stages = [r["attrs"] for r in inside if r["parent"] == call["id"]]
            kernel = ("jbu_epilogue_classify" if route else "adaptive_conv_tapmajor")
            assert [s["stage"] for s in stages] == list(range(STAGES))
            assert stages[-1]["kernel"] == kernel
    setup = [r for r in records if r["request"] is None]
    assert {r["name"] for r in setup} == {"rs_ov/setup/segmentor", "rs_ov/setup/tower",
                                          "rs_ov/setup/queries", "rs_ov/setup/upsampler"}


def _offsets(seg, tmp_path):
    """(name, recorded start - traced start, recorded end - traced end,
    traced length) in ns of each span of one profiled request."""
    with profiling.recording():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            # a profile's first record_function takes tens of us to a few ms
            # inside the profiler, after the event's own time stamp
            with profiling.span("rs_ov/first"):
                pass
            seg.predict_raw(_images(1))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    traced = sorted((e["ts"] * 1e3 + base, (e["ts"] + e["dur"]) * 1e3 + base, e["name"])
                    for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e.get("name", "").startswith("rs_ov/"))
    recorded = sorted((r["start"], r["end"], r["name"]) for r in profiling.spans())
    assert [n for _, _, n in traced] == [n for _, _, n in recorded]
    return [(n, rs - ts, re_ - te, te - ts) for (ts, te, n), (rs, re_, _) in zip(traced, recorded)
            if n != "rs_ov/first"]


def test_spans_are_stamped_on_the_profilers_clock(tmp_path):
    """Each stamp lies within 50 us of the profiler's, plus 2% of the span's
    length: the two are taken a few us apart, on one clock, but with the
    profiler on a record_function's end lands about 1.4% of its length
    after its exit is called where many operators ran inside (a span of
    1000 small operators, 12.6 ms: 120-150 us). A host that stalls the
    process between two stamps (a busy machine, a garbage collection) can
    part them by more, so the request is profiled up to three times."""
    seg = _segmentor(tmp_path)
    seg.predict_raw(_images(1))
    for _ in range(3):
        offsets = _offsets(seg, tmp_path)
        assert len(offsets) > 30
        late = [o for o in offsets if max(abs(o[1]), abs(o[2])) > 50e3 + 0.02 * o[3]]
        if not late:
            break
    assert not late, late


def test_export_writes_a_chrome_trace(tmp_path):
    seg = _segmentor(tmp_path)
    with profiling.recording():
        seg.predict_raw(_images(1))
    path = str(tmp_path / "spans.json")
    assert profiling.export(path) == len(profiling.spans())
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert doc["droppedSpans"] == 0 and doc["displayTimeUnit"] == "ms"
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0 for e in events)
    assert {"id", "parent", "request", "launches"} <= set(events[0]["args"])
    req = next(e for e in events if e["name"] == profiling.REQUEST)
    assert req["args"]["entry"] == "predict_raw"
    stamps = sorted((e["ts"] * 1e3 + doc["baseTimeNanoseconds"]) for e in events)
    assert stamps[0] == pytest.approx(min(r["start"] for r in profiling.spans()), abs=1e3)


def test_trace_writes_the_recorders_export_beside_its_own(tmp_path):
    @profiling.annotate("rs_ov/stage")
    def stage(x):
        return torch.relu(x @ x)

    with profiling.trace(str(tmp_path), device="cpu"):
        stage(torch.randn(8, 8))
    assert len(glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))) == 1
    with open(os.path.join(str(tmp_path), "rs_ov_spans.json")) as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == ["rs_ov/stage"]


def test_a_span_takes_the_launch_counters_deltas(monkeypatch):
    monkeypatch.setattr(build, "_LAUNCHES", {**build.launch_counts(), "range_logits": 5,
                                             "adaptive_conv_tapmajor.bf16": 1})
    assert build.launch_counts()["range_logits"] == 5
    with profiling.recording():
        with profiling.span("rs_ov/outer"):
            build._LAUNCHES["range_logits"] += 2
            with profiling.span("rs_ov/inner"):
                build._LAUNCHES["adaptive_conv_tapmajor.bf16"] += 3
        with profiling.span("rs_ov/none"):
            pass
    launches = {r["name"]: r["launches"] for r in profiling.spans()}
    assert launches == {"rs_ov/inner": {"adaptive_conv_tapmajor.bf16": 3},
                        "rs_ov/outer": {"range_logits": 2, "adaptive_conv_tapmajor.bf16": 3},
                        "rs_ov/none": {}}


def test_the_buffer_is_bounded_and_counts_what_it_dropped(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for i in range(5):
            with profiling.span("rs_ov/s", i=i):
                pass
        with profiling.recording():  # an inner block keeps the outer one's buffer
            with profiling.span("rs_ov/s", i=5):
                pass
    assert [r["attrs"]["i"] for r in profiling.spans()] == [3, 4, 5]
    profiling.export(str(tmp_path / "s.json"))
    with open(tmp_path / "s.json") as f:
        assert json.load(f)["droppedSpans"] == 3
    with profiling.recording():
        pass
    assert profiling.spans() == []


def test_the_kernel_librarys_load_is_a_setup_span(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_build", lambda sources, lib: open(lib, "w").close())
    monkeypatch.setattr(ctypes, "CDLL", lambda path: mock.MagicMock())
    with profiling.recording():
        build.load_library.__wrapped__()
        build.load_library.__wrapped__()
    assert [(r["name"], r["attrs"]) for r in profiling.spans()] == [
        ("rs_ov/setup/kernel_library", {"built": True}),
        ("rs_ov/setup/kernel_library", {"built": False})]


def test_an_exported_program_is_the_same_with_the_recorder_on(tmp_path):
    seg = _segmentor(tmp_path)
    graphs = []
    for on in (False, True):
        path = str(tmp_path / f"{on}.rsovt")
        if on:
            with profiling.recording():
                export.export_predict(seg, (32, 32), path)
            assert profiling.spans() == []
        else:
            export.export_predict(seg, (32, 32), path)
        graphs.append(export.load_predict(path, device="cpu").program.graph_module.code)
    assert graphs[0] == graphs[1]
