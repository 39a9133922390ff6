"""The program's spans in a profiler trace (``harness/spans.py``): each idle
stretch split exactly over the program spans open across it, the layers'
parts adding up to ``trace.summarize``'s idle time; on the tiny cell on the
CPU, the program's ``rs_ov/vit/tower`` and ``rs_ov/jbu/call`` holding the
operations of the benchmark's own ``perfbench/vit/_tower`` and
``perfbench/jbu/_upsample_*`` spans, and every number the reader gives read
from a run."""

import collections
import tempfile

import pytest
import torch

from perfbench.harness import cell, inputs, spans, spec, trace
from perfbench.tests.test_perfbench_trace import MAIN, kernel, launch, request, span


def prog(name, start, end, tid=MAIN):
    """A program span as the profiler's light record function writes it."""
    return {**span(name, start, end, tid), "cat": "cpu_op"}


def _calls():
    """One call, 0-1000 us: the program's request 10-990 holds the tower
    (20-300, a ``user_annotation``, as ``record_function`` writes it) and a
    JBU call (400-800) of two stages, the first split into its operands
    (400-500) and epilogue (500-600); device busy 100-200 and 550-650."""
    return [request(0, 1000), prog("rs_ov/request", 10, 990),
            span("rs_ov/vit/tower", 20, 300), prog("rs_ov/jbu/call", 400, 800),
            prog("rs_ov/jbu/stage", 400, 600), prog("rs_ov/jbu/operands", 400, 500),
            prog("rs_ov/jbu/epilogue", 500, 600), prog("rs_ov/jbu/stage", 600, 800),
            launch(1, 30), launch(2, 510), kernel("a", 100, 200, 1), kernel("b", 550, 650, 2)]


def test_a_gap_is_split_over_the_spans_open_across_it():
    split = spans.idle_split(_calls())
    us = {k: round(v * 1e6, 6) for k, v in split.items()}
    assert us == {(None, None): 20.0,                       # 0-10, 990-1000
                  ("rs_ov/request", None): 10.0 + 100.0 + 190.0,  # 10-20, 300-400, 800-990
                  ("rs_ov/vit/tower", None): 80.0 + 100.0,  # 20-100, 200-300
                  ("rs_ov/jbu/operands", 0): 100.0,         # 400-500
                  ("rs_ov/jbu/epilogue", 0): 50.0,          # 500-550
                  ("rs_ov/jbu/stage", 1): 150.0}            # 650-800


def test_the_layers_and_the_rest_add_up_to_the_idle_time():
    ev = _calls() + [request(1200, 1500), prog("rs_ov/request", 1250, 1450),
                     prog("rs_ov/entry/stitch", 1300, 1350), launch(3, 1260),
                     kernel("c", 1320, 1400, 3)]
    layers = spans.idle_by_layer(spans.idle_split(ev))
    s = trace.summarize(ev)
    assert sum(layers.values()) == pytest.approx(s.window_s - s.busy_s, rel=1e-12)
    assert layers == pytest.approx({"jbu": 300e-6, "vit": 180e-6,
                                    "entry": 300e-6 + 50e-6 + 20e-6 + 50e-6,
                                    "outside": 20e-6 + 50e-6 + 50e-6})
    per_image = spans.idle_ms_per_image(ev, images=2)
    assert per_image["jbu"] == pytest.approx(0.15)


def test_other_threads_spans_and_the_arrival_gaps_take_no_idle():
    ev = _calls() + [prog("rs_ov/jbu/call", 0, 1000, tid=99), request(2000, 2100)]
    split = spans.idle_split(ev)
    assert sum(split.values()) == pytest.approx(1000e-6 - 200e-6 + 100e-6)
    assert split[(None, None)] == pytest.approx(20e-6 + 100e-6)


def test_setup_seconds_read_the_recorders_export():
    ev = [{"ph": "X", "name": "rs_ov/setup/segmentor", "ts": 5.0, "dur": 2.5e6},
          {"ph": "X", "name": "rs_ov/request", "ts": 9e6, "dur": 1.5e6},
          {"ph": "X", "name": "rs_ov/request", "ts": 20e6, "dur": 0.1e6}]
    assert spans.setup_seconds(ev) == {"setup_build_s": 2.5, "setup_first_call_s": 1.5}
    assert spans.setup_seconds([]) == {"setup_build_s": None, "setup_first_call_s": None}


def _traced_with_recorder(c, seed):
    """What a cell's traced run reads with the recorder on: the export of
    set-up and the profiled calls' events, the benchmark's layer spans
    installed as in ``trace.traced``."""
    import json
    import os

    from rs_ov_torch.utils import profiling

    s = inputs.seeds(seed)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.recording():
            prog, driver, _, _ = cell.setup(c.config, c.traffic, s, torch.device("cpu"), tmp)
        path = os.path.join(tmp, "setup.json")
        profiling.export(path)
        with open(path) as f:
            setup = json.load(f)["traceEvents"]
        restore = trace.install(prog, spec.layers())
        try:
            with profiling.recording():
                events = trace.profile(lambda: driver.run(calls=c.traffic["trace_calls"],
                                                          span=trace.request_span), tmp)
        finally:
            restore()
    return setup, events


def _ops_inside(events, prefix):
    """The CPU operators (name: count) launched inside the spans whose
    names start with ``prefix``."""
    holders = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("ph") == "X" and e["name"].startswith(prefix)]
    assert holders, prefix
    return collections.Counter(e["name"] for e in events if e.get("cat") == "cpu_op"
                               and not e["name"].startswith(spans.PREFIX)
                               and any(tid == e["tid"] and a <= e["ts"] <= b
                                       for tid, a, b in holders))


@pytest.mark.parametrize("traffic", ["serve", "batch"])
def test_the_programs_spans_hold_the_benchmarks_layers_and_read_numbers(tiny, traffic):
    c = tiny("b16", traffic)
    setup, events = _traced_with_recorder(c, 2147483648 + 995)
    assert _ops_inside(events, "rs_ov/vit/tower") == _ops_inside(events, "perfbench/vit/_tower")
    assert _ops_inside(events, "rs_ov/jbu/call") == _ops_inside(events, "perfbench/jbu/_")
    s = trace.summarize(events)
    images = s.requests * c.traffic["images_per_call"]
    per_image = spans.idle_ms_per_image(events, images)
    assert all(per_image[k] > 0 for k in ("jbu", "vit", "entry"))
    assert sum(per_image.values()) * images * 1e-3 == pytest.approx(s.window_s - s.busy_s)
    assert all(v > 0 for v in spans.setup_seconds(setup).values())
