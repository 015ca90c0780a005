"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<name>``: ``benchmark/configs/<name>.json`` (its
  ``"model"`` holds the program's configuration fields as run);
* a traffic mix ``<name>``: ``benchmark/traffic/<name>.json`` (its
  ``"work"`` names the module that runs it, ``benchmark/kinds/<work>.py``);
* a metric ``<name>``: ``benchmark/metrics/<name>.py`` with ``read(ctx)``;
* a cell ``<name>``: its limits in ``benchmark/limits/<name>.json``.

So a later change adds a configuration, a mix, a metric or a cell by
adding files and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    workload: Mapping
    config: Mapping          # the configuration file
    traffic: Mapping         # the traffic file
    limits: Mapping          # the cell's limits file
    end_to_end: List[Mapping]
    per_layer: List[Mapping]

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: str) -> Mapping:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> Mapping:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: Mapping, cell: str) -> bool:
    """Whether the metric is reported in ``cell`` (no ``workloads``: every cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: Mapping, workload: str, base: str = HERE) -> Cell:
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    return Cell(
        workload=w,
        config=load_json(os.path.join(base, "configs", f"{w['config']}.json")),
        traffic=load_json(os.path.join(base, "traffic", f"{w['traffic']}.json")),
        limits=load_json(os.path.join(base, "limits", f"{workload}.json")),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, workload)],
    )


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE) -> Callable[[Mapping], Optional[float]]:
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    mod = _load_file(os.path.join(base, "metrics", f"{name}.py"),
                     "benchmark_metric_" + re.sub(r"\W", "_", name))
    return mod.read


def work_module(work: str, base: str = HERE):
    """The module that runs a traffic file's ``"work"``."""
    return _load_file(os.path.join(base, "kinds", f"{work}.py"),
                      "benchmark_kind_" + re.sub(r"\W", "_", work))


def read_metrics(metrics: List[Mapping], ctx: Mapping,
                 base: str = HERE) -> Dict[str, Dict[str, float]]:
    """Each metric's reading, where its reader finds something to read."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
