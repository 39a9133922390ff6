"""The benchmark of ``rs_ov_torch``, one cell a run, on the card it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the repository's root. The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; set-up makes the
weights, query embeddings and images from ``--seed`` on the card, builds the
program and warms it up on the traffic's calls; the window then drives the
traffic for ``--seconds``. With ``--trace 0`` the result's metrics are the
cell's end-to-end ones; with ``--trace 1`` the window runs unprofiled as
well, then a few more calls run with the layers' spans under the profiler,
and the metrics are the cell's per-layer ones. Last, the calls kept from the
window are compared with the plain reference (``correct``).

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``rs_ov``
was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rs_ov")


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``rs_ov_torch`` is not ``rs_ov``."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's switches keep their defaults: a cell measures those
    for key in sorted(k for k in os.environ if k.startswith("RS_OV_")):
        print(f"perfbench: {key} removed from the environment", file=sys.stderr)
        del os.environ[key]
    # build caches at fixed places inside the checkout
    cache = os.path.join(REPO, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path.insert(0, REPO)

    import torch

    from perfbench.harness import cell as cell_run
    from perfbench.harness import spec

    print(f"perfbench: set-up s: imports {time.perf_counter() - T_START:.3f}", file=sys.stderr)
    cell = spec.resolve(spec.load_benchmark(REPO), args.workload, REPO)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"perfbench: {args.workload} needs {cell.entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, run = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START)
    metrics = cell.per_layer if args.trace else cell.end_to_end
    values = {}
    for m in metrics:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"]["power_limit"] = _power_limit()
    found = forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    line = {**result, "metrics": values, "checks": checks}
    for name, c in checks.items():
        bound = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} {c['value']!r} {bound}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
