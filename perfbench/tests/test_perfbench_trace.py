"""Reading a profiler trace: the union of device time inside the calls,
attribution of each device operation to a layer by its launch, and the
run's failure where the launch is missing; installing the layers' spans.
Synthetic chrome-trace events, and the tiny cell on the CPU."""

import time
import types

import pytest
import torch

from perfbench.harness import cell, readers, spec, trace

MAIN = 7


def span(name, start, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": start,
            "dur": end - start}


def launch(corr, at, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
            "ts": at, "dur": 1, "args": {"correlation": corr}}


def kernel(name, start, end, corr=None, stream=7, cat="kernel"):
    args = {"device": 0, "stream": stream}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": start,
            "dur": end - start, "args": args}


def request(start, end):
    return span(trace.REQUEST, start, end)


def test_busy_is_the_union_and_idle_the_rest():
    # two overlapping kernels (100-300, 200-400) and one apart (600-700) in a
    # request of 0-1000 us: busy 400 us, not the 500 us of their sum
    ev = [request(0, 1000), launch(1, 10), launch(2, 20), launch(3, 30),
          kernel("a", 100, 300, 1), kernel("b", 200, 400, 2, stream=8), kernel("c", 600, 700, 3)]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(300e-6 + 100e-6)
    assert s.kernels == 3
    assert s.layer_s == {trace.ENTRY: pytest.approx(500e-6)}
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(600e-6)


def test_a_kernel_belongs_to_the_innermost_span_of_its_launch():
    ev = [request(0, 1000),
          span("perfbench/vit/_tower", 10, 200),
          span("perfbench/jbu/_upsample_classify_nhwc", 300, 500),
          span("perfbench/entry/stitch", 320, 340),      # nested inside jbu's span
          launch(1, 50), launch(2, 310), launch(3, 330), launch(4, 600),
          kernel("gemm", 100, 150, 1), kernel("k3", 400, 450, 2),
          kernel("add", 460, 470, 3), kernel("copy", 700, 710, 4, cat="gpu_memcpy")]
    s = trace.summarize(ev)
    assert s.layer_s["vit"] == pytest.approx(50e-6)
    assert s.layer_s["jbu"] == pytest.approx(50e-6)
    assert s.layer_s["entry"] == pytest.approx(20e-6)   # stitch's kernel and the copy
    assert s.kernels == 3                                # the copy is no launch of a kernel
    assert s.layer_calls == {"vit": 1, "jbu": 1, "entry": 1}


def test_a_kernel_without_its_launch_fails():
    ev = [request(0, 1000), span("perfbench/vit/_tower", 10, 200), launch(1, 20),
          kernel("gemm", 100, 150, 1), kernel("orphan", 300, 320, corr=99, stream=9)]
    with pytest.raises(trace.TraceError, match="not attributed"):
        trace.summarize(ev)
    ev[-1]["args"].pop("correlation")
    with pytest.raises(trace.TraceError, match="not attributed"):
        trace.summarize(ev)


def test_arrival_gaps_are_left_out_of_the_window_and_reported_apart():
    # two calls of an open loop, 0-400 and 600-1000 us, each busy 100 us:
    # the window is the 800 us inside them, idle 600 us; the 200 us between
    # them is named apart and counts in neither
    ev = [request(0, 400), request(600, 1000), launch(1, 10), launch(2, 610),
          kernel("a", 100, 200, 1), kernel("b", 700, 800, 2)]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(800e-6)
    assert s.busy_s == pytest.approx(200e-6)
    assert s.requests == 2
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps[trace.BETWEEN] == pytest.approx(200e-6)
    assert gaps[trace.ENTRY] == pytest.approx(600e-6)
    run = types.SimpleNamespace(trace=s)
    assert readers.device_idle_share(run) == pytest.approx(75.0)


def test_idle_gaps_are_named_by_the_host_span_they_fall_in():
    ev = [request(0, 1000), span("perfbench/jbu/_upsample_classify_nhwc", 100, 900),
          launch(1, 50), launch(2, 150), kernel("a", 0, 100, 1), kernel("b", 800, 1000, 2)]
    s = trace.summarize(ev)
    assert s.idle_gaps == [["jbu/_upsample_classify_nhwc", pytest.approx(700e-6)]]


def test_a_trace_without_requests_fails():
    with pytest.raises(trace.TraceError, match="request"):
        trace.summarize([launch(1, 5), kernel("a", 10, 20, 1)])


def test_a_missing_call_site_fails_and_leaves_the_program_unwrapped():
    program = types.SimpleNamespace(_tower=lambda x: x, _none=None)
    tower = program._tower
    layers = [{"name": "vit", "wrap": [{"on": "program", "attr": "_tower"},
                                       {"on": "program", "attr": "_none"}]},
              {"name": "jbu", "wrap": [{"on": "program", "attr": "_renamed"}]}]
    with pytest.raises(trace.TraceError, match="_renamed"):
        trace.install(program, layers)
    assert program._tower is tower and program._none is None
    restore = trace.install(program, layers[:1])
    assert program._tower is not tower and program._none is None
    restore()
    assert program._tower is tower


def test_every_layer_of_the_tiny_cell_is_traced_on_the_cpu(tiny, monkeypatch):
    # the layer files' call sites exist in the program, each layer's span
    # holds calls, and the program is unwrapped after
    import rs_ov_torch.pipeline.segmentor as segmentor

    stitch = segmentor.stitch
    result, run = cell.run(tiny("b16", "serve"), 993, 0.1, True, torch.device("cpu"),
                           time.perf_counter())
    assert set(run.trace.layer_calls) == {layer["name"] for layer in spec.layers()}
    assert run.trace.requests == 1 and run.trace.window_s > 0
    assert segmentor.stitch is stitch
    assert result["device"]["window_s"] == run.trace.window_s


def test_step_mfu_of_an_open_loop_reads_the_call_not_the_rate(tiny):
    c = tiny("b16", "serve")
    ops = readers.flops.image_flops(c.config, c.traffic, 8)
    run = types.SimpleNamespace(config=c.config, traffic=c.traffic, queries=8,
                                window=types.SimpleNamespace(latencies=[0.02, 0.04, 0.05]))
    assert readers.step_mfu_per_call(run) == pytest.approx(
        100.0 * ops / 0.04 / readers.flops.PEAK["bfloat16"])
