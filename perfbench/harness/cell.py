"""One run of one cell: set-up, the measured window, the traced calls, the
comparison with the reference, and the metrics, in that order."""

from __future__ import annotations

import dataclasses
import gc
import sys
import tempfile
import time

import torch

from perfbench.harness import compare, inputs, program, spec, trace, traffic


@dataclasses.dataclass
class Run:
    """What a metric's ``read(run)`` reads."""
    config: dict
    traffic: dict
    queries: int
    setup_s: float
    window: traffic.Window
    trace: trace.Summary | None = None
    numbers: dict = dataclasses.field(default_factory=dict)  # the comparison's

    @property
    def images_per_s(self) -> float:
        return self.window.images / self.window.seconds


def reference_outputs(config: dict, seeds: inputs.Seeds, pool, image_ids: list,
                      query_idx: list, device, fp8: bool = False) -> dict:
    """{pool index: (probs, labels)} of the reference rebuilt from the seed
    on ``device``, each image once; ``fp8``: the lower-precision control."""
    ref = spec.reference(config)
    flat, leaves = inputs.weights(config, seeds.weights, device)
    sd = inputs.views(flat.float(), leaves)
    queries = inputs.queries(config, len(query_idx), seeds.queries, device)
    wanted = sorted(set(image_ids))
    imgs = [torch.from_numpy(pool[i]).to(device) for i in wanted]
    probs, labels = ref.run(sd, imgs, queries, query_idx, config, fp8=fp8)
    return dict(zip(wanted, zip(probs, labels)))


def program_numbers(config: dict, seeds: inputs.Seeds, pool, kept: list, query_idx: list,
                    device) -> dict:
    """The comparison's numbers of the kept calls against the reference."""
    refs = reference_outputs(config, seeds, pool, [i for k in kept for i in k.images],
                             query_idx, device)
    prog = [(p.to(device), lab.to(device)) for k in kept for p, lab in zip(k.probs, k.labels)]
    return compare.numbers(prog, [refs[i] for k in kept for i in k.images],
                           config["decided_margin"])


def control_numbers(cell: spec.Cell, seed: int, device) -> dict:
    """The comparison's numbers of the lower-precision control: the
    reference with fp8 products against the fp32 reference, on the images
    the cell's check compares first."""
    s = inputs.seeds(seed)
    pool = inputs.images(cell.traffic, s.images, device)
    n = cell.traffic["check_calls"] * cell.traffic["images_per_call"]
    ids = [int(i) for i in inputs.order(cell.traffic, s.order)[:n]]
    _, query_idx = spec.vocabulary(cell.config)
    ref = reference_outputs(cell.config, s, pool, ids, query_idx, device)
    low = reference_outputs(cell.config, s, pool, ids, query_idx, device, fp8=True)
    return compare.numbers([low[i] for i in ids], [ref[i] for i in ids],
                           cell.config["decided_margin"])


def setup(config: dict, tr: dict, s: inputs.Seeds, device, tmpdir: str):
    """(the program built and warmed up on the traffic's calls, its driver,
    the image pool, each query's class) from the seeds."""
    t0 = time.perf_counter()
    vocab_path, query_idx = spec.vocabulary(config)
    flat, leaves = inputs.weights(config, s.weights, device)
    host = inputs.views(flat.float().cpu().numpy(), leaves)
    del flat
    queries = inputs.queries(config, len(query_idx), s.queries, device).cpu().numpy()
    pool = inputs.images(tr, s.images, device)
    t1 = time.perf_counter()
    prog = program.build(config, host, queries, vocab_path, device, tmpdir)
    del host
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    driver = traffic.Driver(prog, tr, pool, inputs.order(tr, s.order), s.sample)
    t2 = time.perf_counter()
    driver.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"perfbench: set-up s: inputs {t1 - t0:.3f}, program {t2 - t1:.3f}, "
          f"warm-up {time.perf_counter() - t2:.3f}", file=sys.stderr)
    return prog, driver, pool, query_idx


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """-> (the result line without "metrics", the Run for the readers)."""
    config, tr = cell.config, cell.traffic
    s = inputs.seeds(seed)
    with tempfile.TemporaryDirectory() as tmp:
        prog, driver, pool, query_idx = setup(config, tr, s, device, tmp)
        window = driver.run(seconds=seconds, keep=tr["check_calls"])
        _print_sixths(window.latencies)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        summary = (trace.traced(prog, driver, spec.layers(), tr["trace_calls"], tmp)
                   if traced else None)
    kept = [traffic.Kept(k.images, [p.cpu() for p in k.probs], k.labels) for k in window.kept]
    window.kept = []
    warm_failed = driver.warm_failed
    del prog, driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kept:
        nums = program_numbers(config, s, pool, kept, query_idx, device)
        ok, checks = compare.judge(nums, config["limits"])
    else:
        print("perfbench: no call of the window ended, nothing to compare", file=sys.stderr)
        nums, ok, checks = {}, False, {}
    run_ = Run(config, tr, len(query_idx), window.t0 - t_start, window, summary, nums)
    result = {"correct": ok and window.failed == 0 and warm_failed == 0,
              "attempted": window.attempted,
              "failed": window.failed, "device": _device(device, cell, peak, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result, run_


def _print_sixths(latencies: list) -> None:
    """The median call latency of each sixth of the window's calls, in the
    order they ended: whether a run's calls drift within it or hold steady."""
    k = len(latencies) // 6
    if k:
        parts = [sorted(latencies[i * k:(i + 1) * k])[k // 2] * 1e3 for i in range(6)]
        print("perfbench: median call ms by sixth of the window: "
              + " ".join(f"{p:.2f}" for p in parts), file=sys.stderr)


def _device(device, cell: spec.Cell, peak: int, summary) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        out.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return out
