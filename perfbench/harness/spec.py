"""Finds a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file names its kind.  The pieces are files found by those
names under a checkout's root:

* ``perfbench/configs/<config>.json`` (the ``file`` of the configuration),
* ``perfbench/traffic/<traffic>.json``,
* ``perfbench/kinds/<kind>.py``: how a kind of configuration is set up,
  driven and checked,
* ``perfbench/metrics/<metric>.py``: one reader per metric, end to end or
  per layer.

So a later configuration, traffic mix, kind or metric is added as files
and entries, and nothing here or elsewhere names one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict                  # the configuration file's object
    config_entry: dict            # its entry in BENCHMARK.json
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]        # the metrics this cell reports
    per_layer: List[dict]
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    """A metric is reported in the cells its ``workloads`` lists, and in
    every cell where it lists none."""
    return cell in metric.get("workloads", [cell])


def cell_spec(workload: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> CellSpec:
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return CellSpec(name=workload, chips=int(cell["chips"]), config=config,
                    config_entry=entry, traffic_name=cell["traffic"],
                    traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                    root=root)


def _load_file(kind: str, name: str, root: Path):
    path = Path(root) / "perfbench" / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} does not exist")
    digest = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    mod_name = f"perfbench._loaded.{kind}_{digest}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def load_kind(name: str, root: Path = ROOT):
    """``perfbench/kinds/<name>.py``: a module with a ``Cell`` class."""
    return _load_file("kinds", name, root)


def load_metric(name: str, root: Path = ROOT):
    """``perfbench/metrics/<name>.py``: a module with ``read(ctx)``."""
    return _load_file("metrics", name, root)


def metric_readers(spec: CellSpec, trace: bool) -> Dict[str, tuple]:
    """name -> (reader module, unit) of the metrics a run reports: the
    end-to-end ones untraced, the per-layer ones traced."""
    chosen = spec.per_layer if trace else spec.end_to_end
    return {m["name"]: (load_metric(m["name"], spec.root), m["unit"])
            for m in chosen}
