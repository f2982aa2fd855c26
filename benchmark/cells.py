"""Everything a cell needs, found by name: no file here names a cell,
a configuration, a traffic mix or a metric.

* ``BENCHMARK.json`` at the root: the cells, configurations and metrics;
* a configuration's ``file``;
* ``benchmark/traffic/<traffic>.json``, whose ``driver`` names
  ``benchmark/drivers/<driver>.py``;
* ``benchmark/limits/<cell>.json``: the limit of each number compared;
* ``benchmark/metrics/<metric>.py``: one reader a metric, ``read(measured)``
  returning the value or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

def load_benchmark(root: Path) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    return _named(bench["workloads"], name, "workload")


def config(root: Path, bench: Dict, name: str) -> Dict:
    return json.loads((Path(root) / _named(bench["configs"], name, "config")["file"]).read_text())


def traffic(root: Path, name: str) -> Dict:
    return json.loads((Path(root) / "benchmark" / "traffic" / f"{name}.json").read_text())


def limits(root: Path, cell: str) -> Dict[str, float]:
    return json.loads((Path(root) / "benchmark" / "limits" / f"{cell}.json").read_text())["limits"]


def driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def metrics_for(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The *kind* (``end_to_end`` or ``per_layer``) metrics that *cell*
    reports: those that list it, and those that list no cell."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(root: Path, metric: str):
    """The module of ``benchmark/metrics/<metric>.py`` (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
