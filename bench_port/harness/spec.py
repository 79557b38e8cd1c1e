"""Resolve a cell of BENCHMARK.json to its files, by name.

A cell names a configuration and a traffic mix. Each is a data file:
  configs/<config>.json   sizes, dtype, source and the plain reference's name
  traffic/<traffic>.json  the mix's parameters and the driver that runs it
  limits/<workload>.json  the limit of each number the cell compares
The driver is drivers/<driver>.py, a per-layer metric metrics/<name>.py and
a kernel's work count work/<kernel>.py. Adding any of them is a new file
and an entry; nothing here changes."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports
    bench_dir: Path

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['driver']}.py")


def load_module(path: Path) -> ModuleType:
    """Import a file by path (metric files carry dots in their names)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    path = path.resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:10]
    key = f"bench_port_{path.parent.name}_{path.stem}_{tag}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(benchmark: Dict[str, Any], workload: str,
            bench_dir: Optional[Path] = None) -> Cell:
    """The cell `workload` of a parsed BENCHMARK.json, its files read from
    `bench_dir` (this folder unless a test assembles its own)."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    e2e = [m for m in benchmark["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"]
                 if _reports(m, workload) and m["moves"] in moved]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=read_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        bench_dir=bench_dir,
    )


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(cell.bench_dir / "metrics" / f"{name}.py")


def work_module(bench_dir: Path, kernel: str) -> ModuleType:
    return load_module(Path(bench_dir) / "work" / f"{kernel}.py")
