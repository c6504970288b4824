"""Finds a cell's files by the names in ``BENCHMARK.json``: the
configuration's file (and the adapter it names), the cell's traffic file
``perfbench/cells/<workload>.json``, and one reader per metric,
``perfbench/metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and entries; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

CELLS_DIR = "perfbench/cells"
METRICS_DIR = "perfbench/metrics"


@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict              # the BENCHMARK.json entry
    config: dict                # the configs entry
    sizes: dict                 # the configuration's file
    cell: dict                  # the cell's file
    end_to_end: List[dict]      # metrics this cell reports with --trace 0
    per_layer: List[dict]       # ... and with --trace 1

    def adapter(self):
        return load_module(self.root / self.sizes["adapter"])

    def reader(self, metric: dict) -> Callable:
        return load_module(self.root / METRICS_DIR
                           / f"{metric['name']}.py").read


def load_module(path: Path):
    """A module from its file (the names may hold '-' and '.')."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "perfbench_" + re.sub(r"\W", "_", str(path.resolve()))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    sizes = json.loads((root / config["file"]).read_text())
    cell = json.loads((root / CELLS_DIR / f"{workload}.json").read_text())
    if cell["config"] != entry["config"]:
        raise ValueError(f"{workload}: cell file names config "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(root, entry, config, sizes, cell, e2e, per)


def metrics(bench_cell: Cell, traced: bool) -> Dict[str, dict]:
    return {m["name"]: m for m in
            (bench_cell.per_layer if traced else bench_cell.end_to_end)}
