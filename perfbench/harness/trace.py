"""Spans around the program's layers, and what a profiler trace says of them.

In a traced run only, the call sites each ``perfbench/layers/<layer>.json``
names are wrapped, from outside the program, in ``record_function`` spans
``perfbench/<layer>/<attr>``; each call of the traffic is inside a span
``perfbench/request``. A call site the program lacks fails the run, so a
rename cannot move a layer's work into the entry layer unseen.

Attribution of device time: a device operation (kernel, copy, fill) belongs
to the innermost layer span that holds its launch on the host, by the
profiler's correlation of the two; one launched inside no layer span
belongs to the entry layer. One whose launch is not in the trace cannot be
attributed and fails the run.

The traced window is the time inside the request spans: busy and idle are
read there, and the arrival gaps of an open loop between two calls are
reported apart, as "between calls", among the idle gaps.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import json
import os

import torch

PREFIX = "perfbench/"
REQUEST = "perfbench/request"
ENTRY = "entry"
BETWEEN = "between calls"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class TraceError(RuntimeError):
    pass


def _wrap(fn, name: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def install(program, layers: list):
    """Wrap every call site of ``layers`` ({"name", "wrap": [{"on":
    "program" or a module, "attr"}]}); returns the function that unwraps
    them. A call site the program lacks raises TraceError; one the program
    holds as None (a route this configuration does not take) is left as it
    is."""
    done = []
    for layer in layers:
        for site in layer["wrap"]:
            obj = program if site["on"] == "program" else importlib.import_module(site["on"])
            attr = site["attr"]
            if not hasattr(obj, attr):
                _restore(done)
                raise TraceError(f"layer {layer['name']!r}: the program has no call site "
                                 f"{site['on']}.{attr}; update perfbench/layers/")
            fn = getattr(obj, attr)
            if fn is None:
                continue
            done.append((obj, attr, attr in vars(obj), fn))
            setattr(obj, attr, _wrap(fn, f"{PREFIX}{layer['name']}/{attr}"))

    return functools.partial(_restore, done)


def _restore(done: list) -> None:
    for obj, attr, own, fn in reversed(done):
        if own:
            setattr(obj, attr, fn)
        else:
            delattr(obj, attr)


def request_span():
    from torch.profiler import record_function

    return record_function(REQUEST)


def profile(fn, tmpdir: str) -> list:
    """Run ``fn`` under ``torch.profiler`` (the host, and the card where
    there is one); the chrome trace's events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


@dataclasses.dataclass
class Summary:
    window_s: float      # time inside the request spans (arrival gaps left out)
    busy_s: float        # union of the device operations inside the request spans
    kernels: int         # kernel launches inside the request spans
    requests: int
    layer_s: dict        # layer -> seconds of its device operations
    layer_calls: dict    # layer -> spans of it
    device_ops: list     # [[name, seconds]], the 10 that took most time
    idle_gaps: list      # [[what the host was in, seconds]], the 10 largest totals


@dataclasses.dataclass(eq=False)
class _Span:
    name: str
    tid: object
    start: float
    end: float

    @property
    def layer(self) -> str:
        return self.name[len(PREFIX):].split("/")[0]


def _innermost(spans: list, points: list) -> dict:
    """{key: the innermost span holding t, or None} for (t, key) points,
    spans nesting properly on one thread."""
    ev = [(s.start, 0, s) for s in spans] + [(s.end, 2, s) for s in spans]
    ev += [(t, 1, key) for t, key in points]
    ev.sort(key=lambda e: (e[0], e[1]))
    stack, out = [], {}
    for _, kind, x in ev:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            stack.remove(x)
        else:
            out[x] = stack[-1] if stack else None
    return out


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _clip(s: float, t: float, starts: list, windows: list) -> float:
    """Seconds of [s, t] inside ``windows`` (disjoint, sorted; ``starts``
    their starts)."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    out = 0.0
    while i < len(windows) and windows[i][0] < t:
        out += max(0.0, min(t, windows[i][1]) - max(s, windows[i][0]))
        i += 1
    return out


def summarize(events: list) -> Summary:
    """Attribute, count and sum a chrome trace's device operations."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    cat = lambda e: str(e.get("cat", "")).lower()  # noqa: E731
    spans = [_Span(e["name"], e.get("tid"), e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
             for e in xs if cat(e) == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    requests = [s for s in spans if s.name == REQUEST]
    if not requests:
        raise TraceError("the trace holds no request span")
    windows = _union([[s.start, s.end] for s in requests])
    starts = [a for a, _ in windows]
    main = requests[0].tid
    by_tid = {}
    for s in spans:
        if s.name != REQUEST:
            by_tid.setdefault(s.tid, []).append(s)
    launches = {}
    for e in xs:
        corr = (e.get("args") or {}).get("correlation")
        if cat(e) in LAUNCH_CATS and corr is not None:
            launches[corr] = (e.get("tid"), e["ts"] * 1e-6)
    points = {}
    for corr, (tid, t) in launches.items():
        points.setdefault(tid, []).append((t, corr))
    owner = {}
    for tid, pts in points.items():
        owner.update(_innermost(by_tid.get(tid, []), pts))

    inside = []  # (op, layer, start, end, seconds inside the requests)
    for e in xs:
        if cat(e) not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launches:
            raise TraceError(f"device operation {e['name'][:120]!r} has no launch in the "
                             f"trace: not attributed")
        span = owner.get(corr)
        s, t = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
        secs = _clip(s, t, starts, windows)
        if secs > 0:
            inside.append((e, span.layer if span is not None else ENTRY, s, t, secs))
    layer_s, by_name = {}, {}
    for e, layer, _, _, secs in inside:
        layer_s[layer] = layer_s.get(layer, 0.0) + secs
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + secs
    busy = _union([[s, t] for _, _, s, t, _ in inside])
    busy_starts = [s for s, _ in busy]
    gaps = []  # inside each request, the stretches no operation covers
    for a, b in windows:
        at = a
        for s, t in busy[max(bisect.bisect_right(busy_starts, a) - 1, 0):]:
            if s >= b:
                break
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if b > at:
            gaps.append((at, b))
    host = _innermost([s for s in spans if s.tid == main and s.name != REQUEST],
                      [((a + b) / 2, i) for i, (a, b) in enumerate(gaps)])
    idle = {}
    for i, (a, b) in enumerate(gaps):
        span = host.get(i)
        label = ENTRY if span is None else span.name[len(PREFIX):]
        idle[label] = idle.get(label, 0.0) + (b - a)
    between = sum(b - a for (_, a), (b, _) in zip(windows, windows[1:]))
    if between > 0:
        idle[BETWEEN] = between
    layer_calls = {}
    for s in spans:
        if s.name != REQUEST and _clip(s.start, s.end, starts, windows) > 0:
            layer_calls[s.layer] = layer_calls.get(s.layer, 0) + 1
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Summary(
        window_s=sum(b - a for a, b in windows),
        busy_s=sum(_clip(s, t, starts, windows) for s, t in busy),
        kernels=sum(1 for e, *_ in inside if cat(e) == "kernel"),
        requests=len(requests), layer_s=layer_s, layer_calls=layer_calls,
        device_ops=top(by_name), idle_gaps=top(idle))


def traced(program, driver, layers: list, calls: int, tmpdir: str) -> Summary:
    """``calls`` calls of the traffic with the layer spans installed,
    profiled and summarised; the spans removed after."""
    restore = install(program, layers)
    try:
        events = profile(lambda: driver.run(calls=calls, span=request_span), tmpdir)
    finally:
        restore()
    return summarize(events)
