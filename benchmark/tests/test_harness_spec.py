"""``BENCHMARK.json`` against the benchmark's contract, and every entry
found by name: a configuration, a traffic mix or a metric is added with
files and entries only."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
SPEC = spec.load_spec()


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.find_cell(cell)
    assert c.traffic["limits"] and os.path.exists(os.path.join(spec.BENCH_DIR, "drivers",
                                                              c.traffic["driver"] + ".py"))
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    conf = next(x for x in SPEC["configs"] if x["name"] == c.config_name)
    assert conf["file"].startswith("benchmark/") and c.config["arch"] == "resnet18"


def test_an_added_cell_config_and_metric_are_found_without_code(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads(json.dumps(SPEC))
    (root / "benchmark" / "configs" / "byol_r34.json").write_text(
        json.dumps({**json.load(open(os.path.join(spec.BENCH_DIR, "configs", "byol_r18.json"))), "arch": "resnet34"}))
    (root / "benchmark" / "traffic" / "byol_r34.device.json").write_text(
        json.dumps({"driver": "byol_train", "ring_batches": 4, "setup_steps": 3,
                    "limits": {"loss_gap": 0.1}}))
    (root / "benchmark" / "metrics" / "train_steps.py").write_text("def read(run):\n    return run.steps\n")
    data["configs"].append({"name": "byol_r34", "source": "https://arxiv.org/abs/1512.03385",
                            "file": "benchmark/configs/byol_r34.json", "reduced": [], "why": "deeper encoder"})
    data["workloads"].append({"name": "byol_r34.device", "config": "byol_r34", "traffic": "byol_r34.device",
                              "chips": 1, "why": "resident batches"})
    data["per_layer"].append({"name": "train_steps", "unit": "steps", "better": "higher", "source": "host_clock",
                              "layer": "train step", "moves": "train_samples_per_s",
                              "workloads": ["byol_r34.device"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    cell = spec.find_cell("byol_r34.device", json.loads((root / "BENCHMARK.json").read_text()),
                          str(root / "benchmark"))
    assert cell.config["arch"] == "resnet34" and cell.traffic["limits"] == {"loss_gap": 0.1}
    assert [m["name"] for m in cell.per_layer][-1] == "train_steps"

    class Run:
        steps = 7

    assert spec.read_metrics(cell.per_layer[-1:], Run(), str(root / "benchmark")) == {
        "train_steps": {"value": 7.0, "unit": "steps"}}
