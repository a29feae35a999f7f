"""Find a cell and everything that belongs to it by name.

`BENCHMARK.json` at the checkout's root lists the configurations, cells and
metrics. Each piece has a file of its own under `benchmark/`, found by its
name, so a later change adds a cell, a configuration, a traffic mix or a
metric by adding files and entries:

* `configs/<config>.json` (the entry's `file`): the model and its recipes;
* `traffic/<traffic>.json`: the traffic mix, a data file naming its driver,
  `traffic/<driver>.py`, and the recipe of the configuration it runs;
* `workloads/<cell>.json`: the cell's own settings (the limits that decide
  `correct`);
* `metrics/<metric>.py`: the reader of a per-layer metric, `read(ctx)`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    recipe: dict
    traffic: dict
    settings: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: Path = ROOT

    @property
    def model_cfg(self) -> dict:
        """The model as the reference reads it: the recipe's model block and
        the configuration's precision rule."""
        cfg = dict(self.recipe["model"])
        cfg["conv_io_bf16_from"] = self.config["conv_io_bf16_from"]
        cfg.setdefault("layer_norm_epsilon", self.config.get("layer_norm_epsilon", 1e-5))
        return cfg


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reported(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s manifest with its files; raises KeyError
    for an unknown cell."""
    man = load_manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    with open(root / conf_entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "benchmark" / "workloads" / f"{name}.json") as f:
        settings = json.load(f)
    e2e = [m for m in man["end_to_end"] if _reported(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                recipe=config["recipes"][traffic["recipe"]], traffic=traffic, settings=settings,
                end_to_end=e2e, per_layer=per_layer, root=root)


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(cell: Cell) -> ModuleType:
    """The traffic driver the cell's mix names."""
    driver = cell.traffic["driver"]
    return _load(cell.root / "benchmark" / "traffic" / f"{driver}.py", f"bench_driver_{driver}")


def load_readers(cell: Cell) -> Dict[str, ModuleType]:
    """{metric name: its reader module} for the cell's per-layer metrics."""
    return {m["name"]: _load(cell.root / "benchmark" / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            for m in cell.per_layer}
