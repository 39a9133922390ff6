"""The one traffic generator: it reads a traffic file and drives the program.

A traffic file (``perfbench/traffic/<name>.json``) gives:

  entry            the program's method a call goes to ("predict_raw",
                   "predict_batch_raw"), given uint8 [n, H, W, 3] on the host
  images_per_call  n
  image_hw         [H, W]
  pool             distinct images made at set-up and cycled, a multiple of n
  rate_per_s       absent: a closed loop, one client sending its next call
                   when the last one's label maps are on the host; a number:
                   an open loop, calls due at that fixed rate, each started
                   when due or when the last one ends, whichever is later,
                   and timed from when it was due
  warmup_calls     calls made at set-up, before the window
  check_calls      calls of the window kept, drawn from the seed, for the
                   comparison with the reference
  trace_calls      calls profiled in a traced run

A call ends when every label map it returned is on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np


@dataclasses.dataclass
class Kept:
    """One call kept for the comparison: its inputs' pool indices, the
    class probabilities it returned (on the device) and its label maps."""
    images: list
    probs: list
    labels: list


@dataclasses.dataclass
class Window:
    t0: float                    # when the first call was due
    t_end: float                 # when the last call ended
    latencies: list              # seconds from due to end, every call that ended
    images: int                  # images of the calls that ended
    attempted: int
    failed: int
    kept: list                   # Kept

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


class Driver:
    def __init__(self, program, traffic: dict, pool: np.ndarray, order: np.ndarray,
                 sample_seed: int):
        self.call = getattr(program, traffic["entry"])
        self.traffic = traffic
        n = traffic["images_per_call"]
        # the distinct calls, assembled at set-up
        self.calls = [order[i:i + n] for i in range(0, len(order) - n + 1, n)]
        self.inputs = [pool[idx] for idx in self.calls]
        self.rate = traffic.get("rate_per_s")
        self.rng = np.random.default_rng(sample_seed)
        self.done = 0  # calls ended, over every window: call i takes input i mod len
        self.warm_failed = 0

    def _one(self, i: int):
        """Call i -> (results, label maps on the host); raises on a fault."""
        results = self.call(self.inputs[i % len(self.inputs)])
        if len(results) != self.traffic["images_per_call"]:
            raise RuntimeError(f"{len(results)} results for "
                               f"{self.traffic['images_per_call']} images")
        return results, [r["pred_sem_seg"].cpu() for r in results]

    def warmup(self) -> None:
        """The traffic's warm-up calls; ``warm_failed`` counts those that failed."""
        for _ in range(self.traffic["warmup_calls"]):
            try:
                self._one(self.done)
            except Exception as exc:  # the run goes on, and is not correct
                self.warm_failed += 1
                print(f"perfbench: warm-up call failed: {exc!r}", file=sys.stderr, flush=True)
            self.done += 1

    def run(self, seconds: float | None = None, calls: int | None = None,
            keep: int = 0, span=contextlib.nullcontext) -> Window:
        """Calls due until ``seconds`` have passed (or ``calls`` of them),
        each inside ``span()``; keeps a uniform sample of ``keep`` of those
        that ended (a reservoir on the seed's stream)."""
        gap = 1.0 / self.rate if self.rate else 0.0
        t0 = time.perf_counter()
        latencies, kept, images, failed, n = [], [], 0, 0, 0
        while True:
            due = t0 + n * gap if self.rate else time.perf_counter()
            if (calls is not None and n >= calls) or (seconds is not None
                                                      and due >= t0 + seconds):
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            i = self.done
            n += 1
            self.done += 1
            try:
                with span():
                    results, labels = self._one(i)
            except Exception as exc:  # a failed call counts; the window goes on
                failed += 1
                print(f"perfbench: call {i} failed: {exc!r}", file=sys.stderr, flush=True)
                continue
            latencies.append(time.perf_counter() - due)
            images += len(results)
            ended = len(latencies) - 1
            slot = ended if ended < keep else int(self.rng.integers(0, ended + 1))
            if slot < keep:
                item = Kept(list(self.calls[i % len(self.calls)]),
                            [r["seg_logits"] for r in results], labels)
                if slot < len(kept):
                    kept[slot] = item
                else:
                    kept.append(item)
        # the loop leaves as soon as the last call has ended
        return Window(t0, time.perf_counter(), latencies, images, n, failed, kept)
