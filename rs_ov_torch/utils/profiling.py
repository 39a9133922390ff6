"""Tracing and profiling utilities (rs_ov/utils/profiling.py) on torch.profiler.

  * ``trace(logdir, device=None)``: a context manager around
    ``torch.profiler.profile`` that writes a TensorBoard trace
    (``*.pt.trace.json``) into ``logdir``; it records the CPU, and the card
    too where the device is one (the card by default when there is one).
  * ``annotate(name)``: a decorator that wraps a function in a
    ``record_function`` span, so pipeline stages show up in traces.
  * ``Throughput``: a 512²-tiles-per-second counter, the north-star metric.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

__all__ = ["trace", "annotate", "Throughput"]


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block into a TensorBoard trace under ``logdir``; yields
    the profiler (``key_averages()`` and ``events()`` for the block)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Decorator: wrap a function in a profiler span named ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class Throughput:
    """Accumulates pixels processed and reports 512^2-tile units per second."""

    def __init__(self):
        self.pixels = 0
        self._t0 = time.perf_counter()

    def add_image(self, h: int, w: int) -> None:
        self.pixels += h * w

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def tiles512_per_sec(self) -> float:
        e = self.elapsed
        return (self.pixels / (512.0 * 512.0)) / e if e > 0 else 0.0

    def report(self, n_chips: int = 1) -> dict:
        return {
            "tiles512_per_sec": self.tiles512_per_sec,
            "tiles512_per_sec_per_chip": self.tiles512_per_sec / max(n_chips, 1),
            "elapsed_sec": self.elapsed,
        }
