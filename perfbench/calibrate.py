"""How the benchmark's serving rates and ``correct`` limits were found; a
cell's runs never call it.

    python3 perfbench/calibrate.py sweep --config NAME --traffic NAME --seed N
        [--seconds 8] [--factors 0.6,0.7,0.8,0.9,1.0,1.1]

the highest rate the program sustains on the traffic's calls: a closed-loop
window gives the capacity (calls/s), then an open-loop window at each factor
of it reports the latency quantiles and whether the backlog grew (the last
fifth's median latency against the first fifth's).

    python3 perfbench/calibrate.py limits --workloads W1,W2 --seeds S1,S2,...
        [--seconds 4] [--control N]

per seed, a run of each workload as ``run.py`` makes it with the window
shortened to ``--seconds``: the comparison's numbers of sound runs (the
lower readings); on the first ``--control`` seeds, the reference with fp8
products put in the program's place on the images the workload's check
compares (the upper readings). One JSON line each, also appended to ``--out``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit(row: dict, out: str) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def sweep(args, device) -> None:
    import numpy as np

    from perfbench.harness import cell, inputs, spec

    config = {**spec.load_json(os.path.join(REPO, "perfbench", "configs",
                                            f"{args.config}.json")), "name": args.config}
    tr = {**spec.load_json(os.path.join(REPO, "perfbench", "traffic", f"{args.traffic}.json")),
          "name": args.traffic}
    with tempfile.TemporaryDirectory() as tmp:
        _, driver, _, _ = cell.setup(config, tr, inputs.seeds(args.seed), device, tmp)
        driver.rate = None
        w = driver.run(seconds=args.seconds)
        capacity = len(w.latencies) / w.seconds
        _emit({"config": args.config, "traffic": args.traffic, "closed_calls_per_s": capacity,
               "p50_ms": 1e3 * float(np.median(w.latencies))}, args.out)
        for f in (float(x) for x in args.factors.split(",")):
            driver.rate = f * capacity
            w = driver.run(seconds=args.seconds)
            lat = np.array(w.latencies)
            fifth = max(len(lat) // 5, 1)
            _emit({"factor": f, "rate_per_s": driver.rate, "calls": len(lat),
                   "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                   "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                   "first_fifth_p50_ms": 1e3 * float(np.median(lat[:fifth])),
                   "last_fifth_p50_ms": 1e3 * float(np.median(lat[-fifth:])),
                   "achieved_per_s": len(lat) / w.seconds}, args.out)


def limits(args, device) -> None:
    import torch

    from perfbench.harness import cell, spec

    bench = spec.load_benchmark(REPO)
    cells = [spec.resolve(bench, w, REPO) for w in args.workloads.split(",")]
    seeds = [int(x) for x in args.seeds.split(",")]
    control_seeds = seeds[:args.control]
    for seed in seeds:
        for c in cells:
            t0 = time.perf_counter()
            result, run = cell.run(c, seed, args.seconds, False, device, t0)
            _emit({"workload": c.name, "seed": seed, "correct": result["correct"],
                   "attempted": result["attempted"], "failed": result["failed"],
                   "setup_s": run.setup_s, "images_per_s": run.images_per_s,
                   "numbers": run.numbers}, args.out)
            if seed not in control_seeds:
                continue
            _emit({"workload": c.name, "seed": seed, "control": "fp8 e4m3 products",
                   "numbers": cell.control_numbers(c, seed, device)}, args.out)
            if device.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("sweep")
    a.add_argument("--config", required=True)
    a.add_argument("--traffic", required=True)
    a.add_argument("--seed", type=int, default=1)
    a.add_argument("--seconds", type=float, default=8.0)
    a.add_argument("--factors", default="0.6,0.7,0.8,0.9,1.0,1.1")
    b = sub.add_parser("limits")
    b.add_argument("--workloads", required=True)
    b.add_argument("--seeds", required=True)
    b.add_argument("--seconds", type=float, default=4.0)
    b.add_argument("--control", type=int, default=0, metavar="N",
                   help="the control on the first N seeds")
    for p in (a, b):
        p.add_argument("--out", default="")
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    (sweep if args.cmd == "sweep" else limits)(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
