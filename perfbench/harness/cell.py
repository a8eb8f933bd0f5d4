"""A cell found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, the driver module of the traffic's
kind and the readers of its per-layer metrics.  Adding a cell, a mix or
a metric adds files and entries; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    """Import a file by path (metric readers are named by metric names,
    which hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics

    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.traffic['kind']}.py",
                           f"perfbench_driver_{self.traffic['kind']}")

    def readers(self) -> Dict[str, object]:
        return {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py",
                                       "perfbench_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}


def _applies(metric: dict, workload: str, reported_e2e: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in reported_e2e


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfile = ROOT / configs[w["config"]]["file"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(name=workload, config_name=w["config"], config=json.loads(cfile.read_text()),
                traffic_name=w["traffic"],
                traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)
