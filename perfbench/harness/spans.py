"""The program's own spans in a profiler trace: why the card sits idle.

While the program's recorder is on (``rs_ov_torch.utils.profiling``), each
of its spans (``rs_ov/<layer>/<step>``) is also a record function in the
profiler's trace (a ``user_annotation`` or, from the profiler's light form,
a ``cpu_op`` event), on the host thread that runs the call. Here the idle time
inside the traced calls, as ``trace.summarize`` reads it (inside the
``perfbench/request`` spans, outside the union of the device operations),
is split over the program's spans open on that thread across each idle
stretch: every part of a stretch goes to the innermost ``rs_ov/`` span open
then, the parts outside any to ``OUTSIDE``. No stretch is given whole to the
span at its midpoint, and the parts add up to the idle time.

A span's layer is the second part of its name: ``jbu`` and ``vit`` are
layers of their own; every other program span (``rs_ov/request`` itself,
``rs_ov/entry/...``, a set-up span inside a call) is the entry layer's.

``setup_seconds`` reads the recorder's export (``profiling.export``) of a
run's set-up.

Nothing of ``run.py`` calls this module yet: wiring it into a cell's traced
run takes edits to ``harness/program.py``, ``harness/cell.py`` and
``harness/trace.py`` (PERF.md, "Open questions").
"""

from __future__ import annotations

import bisect

from perfbench.harness import trace

PREFIX = "rs_ov/"
REQUEST = "rs_ov/request"
CALL = "rs_ov/jbu/call"
STAGE = "rs_ov/jbu/stage"
OUTSIDE = "outside"
LAYERS = ("jbu", "vit", "entry", OUTSIDE)


def layer(name: str | None) -> str:
    """The layer of a program span's name; ``OUTSIDE`` for None."""
    if name is None:
        return OUTSIDE
    part = name[len(PREFIX):].split("/")[0]
    return part if part in ("jbu", "vit") else "entry"


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def idle_gaps(events: list) -> list:
    """[(start, end)] seconds: inside the ``perfbench/request`` spans, the
    stretches no device operation covers (``trace.summarize``'s idle)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    windows = trace._union([[e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6] for e in xs
                            if _cat(e) == "user_annotation" and e.get("name") == trace.REQUEST])
    starts = [a for a, _ in windows]
    ops = [[e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6] for e in xs
           if _cat(e) in trace.DEVICE_CATS]
    busy = trace._union([op for op in ops if trace._clip(*op, starts, windows) > 0])
    busy_starts = [s for s, _ in busy]
    gaps = []
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
    return gaps


def _segments(spans: list) -> list:
    """[(start, end, (innermost span's name, its JBU stage's index or
    None))] over the time any of ``spans`` ((start, end, name), nesting
    properly on one thread) is open, in order; a stage's index is its place
    among the stages of its ``rs_ov/jbu/call``."""
    ev = sorted([(s, 1, s - t, i) for i, (s, t, _) in enumerate(spans)]
                + [(t, 0, 0.0, i) for i, (_, t, _) in enumerate(spans)])
    stack, stage_of, stages, out, prev = [], {}, 0, [], None
    for at, opens, _, i in ev:
        if stack and at > prev:
            top = spans[stack[-1]][2]
            stage = next((stage_of[j] for j in reversed(stack) if j in stage_of), None)
            out.append((prev, at, (top, stage)))
        name = spans[i][2]
        if opens:
            stack.append(i)
            if name == CALL:
                stages = 0
            elif name == STAGE:
                stage_of[i], stages = stages, stages + 1
        else:
            stack.remove(i)
        prev = at
    return out


def idle_split(events: list) -> dict:
    """{(innermost program span's name, its JBU stage's index or None):
    idle seconds} inside the traced calls; ``(None, None)`` holds the idle
    time outside any program span."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    main = next((e.get("tid") for e in xs if _cat(e) == "user_annotation"
                 and e.get("name") == trace.REQUEST), None)
    spans = [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"]) for e in xs
             if e.get("tid") == main and str(e.get("name", "")).startswith(PREFIX)]
    segs = _segments(spans)
    seg_starts = [s for s, _, _ in segs]
    out = {}
    for a, b in idle_gaps(events):
        covered = 0.0
        for s, t, key in segs[max(bisect.bisect_right(seg_starts, a) - 1, 0):]:
            if s >= b:
                break
            part = min(b, t) - max(a, s)
            if part > 0:
                out[key] = out.get(key, 0.0) + part
                covered += part
        if b - a > covered:
            out[(None, None)] = out.get((None, None), 0.0) + (b - a - covered)
    return out


def idle_by_layer(split: dict) -> dict:
    """``idle_split``'s seconds summed by layer, every layer of ``LAYERS``."""
    out = dict.fromkeys(LAYERS, 0.0)
    for (name, _), secs in split.items():
        out[layer(name)] += secs
    return out


def idle_ms_per_image(events: list, images: int) -> dict:
    """{layer: idle ms per image} of the traced calls, which held ``images``."""
    return {k: v * 1e3 / images for k, v in idle_by_layer(idle_split(events)).items()}


def setup_seconds(events: list) -> dict:
    """From the recorder's export of set-up: ``setup_build_s``, the
    ``rs_ov/setup/segmentor`` span; ``setup_first_call_s``, the first
    ``rs_ov/request`` span (the kernel library's load, CUDA's lazy module
    loads, cuBLAS's start). None where the export lacks the span."""
    def first(name):
        found = sorted((e["ts"], e.get("dur", 0)) for e in events
                       if e.get("ph") == "X" and e.get("name") == name)
        return found[0][1] * 1e-6 if found else None

    return {"setup_build_s": first("rs_ov/setup/segmentor"),
            "setup_first_call_s": first(REQUEST)}
