"""Finding a cell's files by the names that ``BENCHMARK.json`` gives.

A cell is one entry of ``workloads``: a configuration under a traffic mix.
Everything that belongs to one of them lies in a file of its own:

  bench/configs/<config>.json     the configuration as it is run; its
                                  ``kind`` and ``reference`` keys name
                                  its module and the plain reference
  bench/traffic/<traffic>.json    the traffic mix's parameters
  bench/limits/<cell>.json        the limit of each number the cell's
                                  correctness check compares
  bench/kinds/<kind>.py           set-up, the measured window and the check
  bench/reference/<reference>.py  the plain reference
  bench/metrics/<metric>.py       one reader for each per-layer metric

so a later change adds a cell, a mix or a metric as new files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    """The benchmark's description, ``BENCHMARK.json`` at the root."""
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload with its configuration, traffic mix and limits."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the end-to-end metrics this cell reports
    per_layer: list        # the per-layer metrics this cell reports

    @property
    def module(self):
        return importlib.import_module(
            f"bench.kinds.{self.config['kind']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read. Raises
    KeyError for a name that is not there."""
    s = spec()
    work = {w["name"]: w for w in s["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in s["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in s["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in s["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """The module of the per-layer metric ``name``
    (``bench/metrics/<name>.py``), loaded by its path: a metric's name
    may hold dots."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
