"""What a cell is made of, found by name.

``BENCHMARK.json`` (at the repository root) names each cell's configuration
and traffic mix; each lives in a file of its own:

  * a configuration: the file its ``configs`` entry names
    (``perfbench/configs/<name>.json``): source, widths, ``reduced`` /
    ``assumed``, the recipe passed to the program, its reference and limits;
  * a traffic mix: ``perfbench/traffic/<name>.json``;
  * a metric (end-to-end or per-layer): ``perfbench/metrics/<name>.py``,
    whose ``read(run)`` returns the number or None;
  * a traced layer: ``perfbench/layers/<name>.json``, the program's call
    sites wrapped in spans in traced runs.

Adding any of them is adding a file; nothing here tests for a cell's name.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the BENCHMARK.json workload entry
    config: dict           # the configuration file, with "name" and "file" added
    traffic: dict          # the traffic file, with "name" added
    end_to_end: list       # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = REPO) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, name: str, root: str = REPO) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {[w['name'] for w in bench['workloads']]})")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = {**load_json(os.path.join(root, cfg_entry["file"])), "name": cfg_entry["name"],
              "file": cfg_entry["file"]}
    traffic = {**load_json(os.path.join(root, "perfbench", "traffic",
                                        f"{entry['traffic']}.json")), "name": entry["traffic"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry, config, traffic, e2e, per_layer)


def _module(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: str = REPO):
    """``read`` of ``perfbench/metrics/<name>.py``."""
    return _module(os.path.join(root, "perfbench", "metrics", f"{name}.py"),
                   f"perfbench_metric_{name}").read


def layers(root: str = REPO) -> list[dict]:
    """Every ``perfbench/layers/*.json``, each with its file's name as "name"."""
    return [{**load_json(path), "name": os.path.splitext(os.path.basename(path))[0]}
            for path in sorted(glob.glob(os.path.join(root, "perfbench", "layers", "*.json")))]


def reference(config: dict, root: str = REPO):
    """The module ``perfbench/reference/<config["reference"]>.py``."""
    return _module(os.path.join(root, "perfbench", "reference", f"{config['reference']}.py"),
                   f"perfbench_reference_{config['reference']}")


def vocabulary(config: dict, root: str = REPO) -> tuple[str, list[int]]:
    """(the vocabulary file's path, the class of each query): one class a
    line, its synonyms separated by commas, as the program reads it."""
    path = os.path.join(root, "perfbench", config["vocabulary"])
    with open(path) as f:
        lines = f.read().splitlines()
    return path, [i for i, line in enumerate(lines) for _ in line.split(",")]
