"""Finds a cell's files by the names in `BENCHMARK.json`.

- `BENCHMARK.json` (the root): the cell's config, traffic and chips; the metrics;
- the config's `file`: sizes, dtype and settings of one model configuration;
- `benchmark/traffic/<traffic>.json`: a traffic mix, `{"kind": ..., "params": {...}}`;
- `benchmark/kinds/<kind>.py`: the driver of that kind of traffic;
- `benchmark/families/<family>.py`: how a config's family is built, served,
  trained and worked out by the reference;
- `benchmark/workloads/<cell>.json`: the cell's limits for `correct`;
- `benchmark/metrics/<metric>.py`: the reader of one metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict  # the BENCHMARK.json entry
    config: dict  # the config file's contents
    traffic: dict  # the traffic file's contents
    limits: Dict[str, float]
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports, by mode
    per_layer: List[dict]
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def params(self) -> dict:
        return self.traffic["params"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "benchmark"
    return Cell(
        name=name, workload=w, config=_read(root / cfg_entry["file"]),
        traffic=_read(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_read(bench_dir / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def kind_module(kind: str):
    return importlib.import_module(f"kinds.{kind}")


def family_module(family: str):
    return importlib.import_module(f"families.{family}")


def metric_reader(name: str, root: Path = ROOT):
    """The module `benchmark/metrics/<name>.py` (names hold dots, so it is loaded by path)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
