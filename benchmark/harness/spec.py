"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:

- ``benchmark/configs/<config>.json``: the configuration's sizes;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, among
  them ``driver``, the general generator that reads them
  (``benchmark/drivers/<driver>.py``), and ``limits``, each compared
  number's limit;
- ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(run)``
  returning a number or None (nothing to read in this run).

Adding a cell, a configuration, a traffic mix or a metric is adding files
and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run of this cell reports: the end-to-end ones
        without tracing, the per-layer ones with it."""
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: Optional[dict] = None, bench_dir: str = BENCH_DIR) -> Cell:
    spec = load_spec(os.path.dirname(bench_dir)) if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {[w['name'] for w in spec['workloads']]})")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"], traffic_name=entry["traffic"],
        config=_json(os.path.join(os.path.dirname(bench_dir), conf["file"])),
        traffic=_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"{kind} {name!r}: no file {path}")
    mod_name = f"benchmark_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics: List[dict], run, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"], bench_dir).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
