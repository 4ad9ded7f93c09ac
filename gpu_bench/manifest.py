"""``BENCHMARK.json`` and the files each of its names points at.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them is found by that name:

- ``configs/<config>.json``: the configuration as it is run (``config``),
  with its source, ``reduced`` and ``assumed``;
- ``configs/<config>_flops.py``: its model FLOPs, counted from its shapes;
- ``reference/<config>.py``: its plain reference and the limits of its
  comparison;
- ``traffic/<traffic>.json``: the loop driver (``driver``) and its
  parameters;
- ``drivers/<driver>.py``: the loop of that kind;
- ``metrics/<metric>.py`` (or ``metrics/<name before the first dot>.py``):
  the reader of a per-layer metric.

A later cell or metric of an existing kind is added as files and manifest
entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    #: ``configs/<config>.json``
    config: Dict[str, Any]
    #: ``traffic/<traffic>.json``
    traffic: Dict[str, Any]
    #: the manifest's metric entries that this cell reports
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    #: the benchmark's directory, where the cell's files lie
    here: Path = HERE


def load_manifest(path: Path = MANIFEST) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, package: str) -> ModuleType:
    """The Python file ``path`` as module ``gpu_bench.<package>.<stem>`` (its
    relative imports resolve inside that package)."""
    importlib.import_module(f"gpu_bench.{package}")
    name = f"gpu_bench.{package}." + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[Dict[str, Any]] = None, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics, from
    the files under ``here``."""
    manifest = manifest if manifest is not None else load_manifest()
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    config = json.loads((here / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    end_to_end = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(entry["chips"]), config_name=entry["config"],
                traffic_name=entry["traffic"], config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer, here=here)


def driver(cell: Cell) -> ModuleType:
    return load_module(cell.here / "drivers" / f"{cell.traffic['driver']}.py", "drivers")


def reference(cell: Cell) -> ModuleType:
    return load_module(cell.here / "reference" / f"{cell.config_name}.py", "reference")


def flops(cell: Cell) -> ModuleType:
    return load_module(cell.here / "configs" / f"{cell.config_name}_flops.py", "configs")


def reader(metric: str, here: Path = HERE) -> ModuleType:
    """``metrics/<metric>.py``, else ``metrics/<name before the first dot>.py``."""
    exact = here / "metrics" / f"{metric}.py"
    path = exact if exact.is_file() else here / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, "metrics")
