"""The port's spans, counters and traces, on torch.profiler.

  * ``span(name, **attrs)``: a context manager around one step of the
    program. Off by default: it then returns one shared object that does
    nothing, after one check of a module-level flag. While ``recording()``
    is on, a span records its name, its id, its parent's id, its request's
    id (the id of the outermost ``rs_ov/request`` span it lies in), its
    thread, its start and end, ``attrs`` (with those its ``set`` adds while
    it is open), and how many times each kernel launched while it
    was open (``kernels.build.launch_counts``).
    Start and end are Unix nanoseconds, the time base of torch.profiler's
    host events (its chrome trace counts microseconds from
    ``baseTimeNanoseconds``). While a profiler is active, each span is also
    a record function of the same name (the profiler's light
    ``_RecordFunctionFast`` where torch has it, else ``record_function``),
    so a profiler trace holds the program's spans and the device operations
    they launched on one time axis. Under ``torch.export`` no span is recorded, so an exported
    program is the same with the recorder on or off.
  * ``recording()``: switches the recorder on for a block. The outermost
    block starts an empty buffer of at most ``MAX_SPANS`` spans (the oldest
    are dropped first, and counted); the buffer stays readable after the
    block, until the next one starts.
  * ``spans()``: the buffer's spans, in the order they ended, as dicts.
  * ``export(path)``: the buffer as a chrome trace (JSON).
  * ``trace(logdir, device=None)``: a TensorBoard trace of the block
    (``*.pt.trace.json``) with the recorder on, and the recorder's export
    beside it (``rs_ov_spans.json``).
  * ``annotate(name)``: a decorator that runs a function inside
    ``span(name)``.

The program's spans are named ``rs_ov/<layer>/<step>``: ``rs_ov/request``
around each ``predict*`` / ``forward_feature`` call, ``rs_ov/entry/...``,
``rs_ov/vit/...``, ``rs_ov/jbu/...`` and ``rs_ov/setup/...`` (README,
"Profiling").
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from rs_ov_torch.kernels.build import launch_counts

__all__ = ["span", "recording", "spans", "export", "trace", "annotate", "REQUEST", "MAX_SPANS"]

REQUEST = "rs_ov/request"
MAX_SPANS = 1 << 17
# a span's record in an active profiler: the profiler's own light form of
# record_function where this torch has it (its events are "cpu_op" ones)
_MIRROR = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)
# libkineto's chrome-trace time base: Unix time floored to 7889238-second steps
_CHROME_BASE_NS = 7889238 * 10 ** 9


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()


class _Recorder:
    """One ``recording()`` block's buffer and its per-thread stacks of open spans."""

    def __init__(self):
        self.records = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        """This thread's open spans."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
            self.local.tid = threading.get_native_id()
        return stack

    def add(self, record: tuple) -> None:
        if len(self.records) == MAX_SPANS:
            self.dropped += 1
        self.records.append(record)


_recorder: _Recorder | None = None   # while a recording() block is on
_last: _Recorder | None = None       # the newest block's, read by spans() / export()


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "request", "launches", "mirror",
                 "start")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = self.rec.stack()
        outer = stack[-1] if stack else None
        self.id = next(self.rec.ids)
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else None
        if self.request is None and self.name == REQUEST:
            self.request = self.id
        self.launches = launch_counts()
        self.mirror = None
        if torch.autograd._profiler_enabled():
            self.mirror = _MIRROR(self.name)
            self.mirror.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        self.rec.stack().remove(self)
        after = launch_counts()
        before = self.launches
        launched = () if after == before else tuple(
            (k, n - before[k]) for k, n in after.items() if n != before[k])
        # a tuple of numbers and strings, which the garbage collector stops
        # tracking: a full buffer adds no work to its collections
        self.rec.add((self.name, self.id, self.parent, self.request, self.rec.local.tid,
                      self.start, end, tuple(self.attrs.items()), launched))
        return None

    def set(self, **attrs) -> None:
        """Add ``attrs`` to the span's record: what is known only inside it."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one step of the program named ``name``;
    ``attrs`` (numbers and strings) go into its record, and so do those the
    entered span's ``set(**attrs)`` adds (a no-op while the recorder is off)."""
    rec = _recorder
    if rec is None or torch.compiler.is_exporting():
        return _OFF
    return _Span(rec, name, attrs)


@contextlib.contextmanager
def recording():
    """The recorder on for the block; yields nothing."""
    global _recorder, _last
    outer = _recorder
    if outer is None:
        _recorder = _last = _Recorder()
    try:
        yield
    finally:
        if outer is None:
            _recorder = None


_FIELDS = ("name", "id", "parent", "request", "tid", "start", "end")


def spans() -> list[dict]:
    """The newest ``recording()`` block's spans, in the order they ended:
    name, id, parent, request, tid, start, end (ns), attrs and launches
    (dicts)."""
    if _last is None:
        return []
    return [{**dict(zip(_FIELDS, r)), "attrs": dict(r[7]), "launches": dict(r[8])}
            for r in _last.records]


def export(path: str) -> int:
    """Write the recorder's spans to ``path`` as a chrome trace: one complete
    event a span, its ids, attributes and launch counts under ``args``, its
    microseconds counted from ``baseTimeNanoseconds`` as torch.profiler's
    are. Returns the number of spans written."""
    records = spans()
    base = min((r["start"] for r in records), default=time.time_ns())
    base -= base % _CHROME_BASE_NS
    pid = os.getpid()
    events = [{"ph": "X", "cat": "rs_ov", "name": r["name"], "pid": pid, "tid": r["tid"],
               "ts": (r["start"] - base) / 1e3, "dur": (r["end"] - r["start"]) / 1e3,
               "args": {"id": r["id"], "parent": r["parent"], "request": r["request"],
                        **r["attrs"], "launches": r["launches"]}}
              for r in records]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base,
                   "droppedSpans": _last.dropped if _last is not None else 0}, f, default=str)
    return len(events)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block into a TensorBoard trace under ``logdir`` with the
    recorder on, and write its export to ``logdir/rs_ov_spans.json``;
    yields the profiler (``key_averages()`` and ``events()`` for the
    block). It records the CPU, and the card too where the device is one
    (the card by default when there is one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with recording():
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
        export(os.path.join(logdir, "rs_ov_spans.json"))


def annotate(name: str):
    """Decorator: run a function inside ``span(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
