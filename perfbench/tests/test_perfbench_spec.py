"""BENCHMARK.json against the benchmark's contract, every cell's
configuration, traffic mix and metrics found by name, and a new
configuration, traffic mix and metric added as new files only."""

import hashlib
import json
import os
import shutil

import pytest

from perfbench.harness import spec

BENCH = spec.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_the_file_has_the_contracts_keys_and_limits():
    assert set(BENCH) == KEYS
    assert os.path.getsize(f"{spec.REPO}/BENCHMARK.json") <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][:2] == ["python3",
                                                                       "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [x["name"] for x in BENCH["configs"] + BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for name in names:
        assert spec.NAME.fullmatch(name), name
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")


def test_metrics_keep_the_contracts_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cells_files_are_found_by_name(workload):
    cell = spec.resolve(BENCH, workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert spec.reference(cell.config).run
    assert cell.traffic["pool"] % cell.traffic["images_per_call"] == 0
    for key in cell.config["reduced"]:
        assert key in cell.config
    assert os.path.exists(spec.vocabulary(cell.config)[0])


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_configuration_a_traffic_mix_and_a_metric_are_added_as_files(tmp_path):
    shutil.copy(f"{spec.REPO}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{spec.REPO}/perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(tmp_path / "perfbench")
    config = spec.load_json(f"{spec.REPO}/perfbench/configs/clip-vitb16-segearth.json")
    config["recipe"]["sim_feat_up_cfg"]["num_stages"] = 4
    (tmp_path / "perfbench/configs/clip-vitb16-jbu4.json").write_text(json.dumps(config))
    (tmp_path / "perfbench/traffic/batch2-1024.json").write_text(json.dumps(
        {"entry": "predict_batch_raw", "images_per_call": 2, "image_hw": [1024, 1024],
         "pool": 8, "warmup_calls": 2, "check_calls": 2, "trace_calls": 1}))
    (tmp_path / "perfbench/metrics/calls_per_s.py").write_text(
        "def read(run):\n    return len(run.window.latencies) / run.window.seconds\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "clip-vitb16-jbu4", "source": "https://x.org",
                             "file": "perfbench/configs/clip-vitb16-jbu4.json",
                             "reduced": [], "why": "four stages"})
    bench["workloads"].append({"name": "b16jbu4.batch2", "config": "clip-vitb16-jbu4",
                               "traffic": "batch2-1024", "chips": 1, "why": "new"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "tiles_per_s", "workloads": ["b16jbu4.batch2"]})
    bench["end_to_end"][0]["workloads"].append("b16jbu4.batch2")
    cell = spec.resolve(bench, "b16jbu4.batch2", root=str(tmp_path))
    assert cell.config["recipe"]["sim_feat_up_cfg"]["num_stages"] == 4
    assert cell.traffic["image_hw"] == [1024, 1024]
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    assert spec.metric_reader("calls_per_s", root=str(tmp_path)) is not None
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
