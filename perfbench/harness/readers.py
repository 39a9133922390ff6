"""What the metric files read, shared by the variants of one quantity
(``<metric>.batch`` and ``<metric>.serve`` read alike and move different
end-to-end metrics). Each returns None where the run has nothing to read."""

from __future__ import annotations

import numpy as np

from perfbench.harness import flops


def tiles_per_s(run):
    h, w = run.traffic["image_hw"]
    return run.window.images * (h * w / 512.0 ** 2) / run.window.seconds


def latency_ms(run, q: float):
    lat = run.window.latencies
    return float(np.percentile(lat, q)) * 1e3 if lat else None


def _images_traced(run) -> int:
    return run.trace.requests * run.traffic["images_per_call"]


def launches_per_image(run):
    return run.trace.kernels / _images_traced(run) if run.trace else None


def device_idle_share(run):
    """Share of the time inside the traced calls in which no device
    operation ran, % (an open loop's arrival gaps are not in it)."""
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s) if run.trace else None


def step_mfu(run):
    """The model's operations per image times images per second of the
    unprofiled window, over the bf16 peak, in %: a closed loop's rate, which
    the program sets."""
    ops = flops.image_flops(run.config, run.traffic, run.queries)
    return 100.0 * ops * run.images_per_s / flops.PEAK["bfloat16"]


def step_mfu_per_call(run):
    """The model's operations of one call over the median call's latency in
    the unprofiled window, over the bf16 peak, in %: an open loop's rate is
    the traffic's, so the call's own time is what the program sets."""
    lat = latency_ms(run, 50)
    if not lat:
        return None
    ops = flops.image_flops(run.config, run.traffic, run.queries)
    return 100.0 * ops * run.traffic["images_per_call"] / (lat * 1e-3) / flops.PEAK["bfloat16"]


def roofline(run, layer: str, counts):
    """Least time of the layer's traced calls (``counts(config, crops,
    calls, queries)`` -> (operations, bytes)) over its attributed device
    time, in %."""
    if not run.trace or not run.trace.layer_s.get(layer) or not run.trace.layer_calls.get(layer):
        return None
    crops = _images_traced(run) * flops.crops_per_image(run.config, run.traffic)
    ops, nbytes = counts(run.config, crops, run.trace.layer_calls[layer], run.queries)
    return 100.0 * flops.bound_s(nbytes, ops)[0] / run.trace.layer_s[layer]
