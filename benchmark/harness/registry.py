"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

Under the benchmark's directory:

- ``configs/<config>.json``: the configuration as it is run (the file
  that ``BENCHMARK.json``'s ``configs`` entry names);
- ``traffic/<traffic>.json``: the traffic mix, whose ``"driver"`` names a
  module ``drivers/<driver>.py`` (the general code of one kind of entry);
- ``checks/<cell>.json``: the sizes of the cell's comparison with the
  plain reference and the limit of each number it compares;
- ``metrics/<metric>.py``: one reader per per-layer metric, with a
  function ``read(ctx)`` that returns a number, or None where it finds
  nothing to read.

A new cell, configuration, traffic mix or metric is new files and new
entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH_DIR = "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric file names hold
    dots, which ``import`` cannot take)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str, moved: set) -> bool:
    """Whether ``cell``, which reports the end-to-end metrics ``moved``,
    reports ``metric``: the cells its ``workloads`` list names, or without
    one every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in moved


@dataclass
class Cell:
    name: str
    root: Path
    workload: dict        # the cell's entry of ``workloads``
    config: dict          # its configuration file
    traffic: dict         # traffic/<traffic>.json
    check: dict           # checks/<cell>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports

    @property
    def bench_dir(self) -> Path:
        return self.root / BENCH_DIR

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "bench_metric_" + name.replace(".", "_"))


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files. Raises
    ``KeyError`` for an unknown cell and ``FileNotFoundError`` for a
    missing file."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / BENCH_DIR
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, moved)]
    return Cell(name, root, w, _json(root / configs[w["config"]]["file"]),
                _json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                _json(bench_dir / "checks" / f"{name}.json"), e2e,
                per_layer)
