"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix, entry and per-layer metric is found by its name, the names
and units keep to the allowed characters, each metric's file declares
what ``BENCHMARK.json`` says of it, and a new cell, configuration,
traffic mix and metric are added as new files alone."""
import json
import re
import shutil

import pytest

import cells
from cardbench import harness

ROOT = cells.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        path = ROOT / c["file"]
        assert c["file"].startswith("cardbench/") and path.exists()
        body = json.loads(path.read_text())
        assert body["name"] == c["name"]
        assert sorted(body.get("reduced", {})) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank", "_size")) or \
                key == "test_size"
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_cells_are_found_by_name():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"])
        assert cell.entry.prepare and cell.entry.drive
        assert set(cell.workload["limits"]) >= {"loss_gap", "grad_gap",
                                                "delta_gap"}
        names = {m["name"] for m in cell.end_to_end}
        assert {"setup_s", "round_s"} <= names
        assert cell.per_layer
    assert len(pairs) == len(BENCH["workloads"])


def test_every_metric_has_a_reader():
    cellnames = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        mod = harness.load_cell(m["workloads"][0]).metric(m["name"])
        assert callable(mod.read)
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert set(m["workloads"]) <= cellnames and m["moves"] in e2e
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_a_new_cell_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway cell with its own configuration, traffic mix and
    per-layer metric, added as files beside the benchmark's, runs on the
    CPU without an edit to a file that is there."""
    root = tmp_path / "cardbench"
    shutil.copytree(ROOT / "cardbench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
              if p.is_file()}
    small = cells.small_cell("resnet8-cifar10.fedgkd")
    cfg = dict(small.config, name="resnet8-tiny")
    (root / "configs" / "resnet8-tiny.json").write_text(json.dumps(cfg))
    (root / "traffic" / "fedgkd-k3-2x16.json").write_text(json.dumps(
        dict(small.traffic, cohort=3, max_batches_per_client=2)))
    (root / "workloads" / "resnet8-tiny.k3.json").write_text(json.dumps(
        dict(small.workload, config="resnet8-tiny",
             traffic="fedgkd-k3-2x16")))
    (root / "metrics" / "rounds_seen.py").write_text(
        'def read(run):\n    return float(run.window_rounds)\n')
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(BENCH["configs"][0],
                                                name="resnet8-tiny")]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "resnet8-tiny.k3", "config": "resnet8-tiny",
         "traffic": "fedgkd-k3-2x16", "chips": 1, "why": "a test's cell"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "rounds_seen", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "FL loop", "moves": "round_s",
         "workloads": ["resnet8-tiny.k3"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("resnet8-tiny.k3", root=root)
    assert [m["name"] for m in cell.per_layer][-1] == "rounds_seen"
    result = harness.run_cell(cell, 2 ** 33 + 5, 0.5, True, "cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["rounds_seen"]["value"] >= 1
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_limits_sit_between_readings(name):
    """Each limit lies above the largest reading of sound runs and below
    the smallest of the control or fault that sets its upper end, nearer
    the upper end: limit / lower > upper / limit > 1."""
    cell = harness.load_cell(name)
    readings = cell.workload["limit_readings"]
    assert set(readings) == set(cell.workload["limits"])
    for key, limit in cell.workload["limits"].items():
        lo, hi = readings[key]["lower"], readings[key]["upper"]
        assert lo < limit < hi, (key, lo, limit, hi)
        assert limit / lo > hi / limit, (key, lo, limit, hi)
