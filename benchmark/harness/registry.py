"""Finds a cell's files by the names in `BENCHMARK.json`.

A cell (`workloads[]`) names a configuration (`configs/<file>`, from the
`configs[]` entry), a traffic mix (`workloads/<traffic>.json`), its
correctness limits (`limits/<cell>.json`) and, through the `per_layer`
entries that list it (or list no cells), its per-layer metrics, one
module each (`metrics/<name>.py`). The configuration's `model_type`
picks its family (`harness/families/<model_type>.py`) and the mix's
`kind` its path (`harness/<kind>_cell.py`, the class whose `kind` it
is). A later cell, mix, metric, family or kind is a new file and a new
entry; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config_file: str
    traffic_file: str
    limits_file: str
    end_to_end: List[dict]
    per_layer: List[dict]
    metrics: Dict[str, ModuleType] = field(default_factory=dict)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_metric(path: str) -> ModuleType:
    """A per-layer metric's module, loaded from its file (metric names may
    hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + os.path.basename(path)[:-3].replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def code(sub: str, stem: str, bench_dir: Optional[str] = None
         ) -> ModuleType:
    """The module `<sub>/<stem>.py` of the benchmark: from `bench_dir`
    where it holds one, else from this harness's own folder (imported by
    its package name there)."""
    rel = os.path.join(sub, stem + ".py")
    if bench_dir and os.path.exists(os.path.join(bench_dir, rel)) and \
            not os.path.samefile(bench_dir, HERE):
        return load_metric(os.path.join(bench_dir, rel))
    if not os.path.exists(os.path.join(HERE, rel)):
        raise SystemExit(f"no {rel} in the benchmark")
    return importlib.import_module(
        "benchmark." + sub.replace("/", ".") + "." + stem)


def family(model_type: str, bench_dir: Optional[str] = None) -> ModuleType:
    """The family module of a configuration's `model_type`."""
    return code("harness/families", model_type, bench_dir)


def load_config(path: str, bench_dir: Optional[str] = None):
    """(family module, dims) of the configuration file `path`."""
    with open(path) as f:
        raw = json.load(f)
    fam = family(raw["model_type"], bench_dir)
    return fam, fam.dims(raw)


def kind_class(kind: str, bench_dir: Optional[str] = None) -> type:
    """The cell class of a traffic mix's `kind`: the class of
    `harness/<kind>_cell.py` whose `kind` attribute it is."""
    mod = code("harness", kind + "_cell", bench_dir)
    found = [c for c in vars(mod).values()
             if isinstance(c, type) and getattr(c, "kind", None) == kind]
    if len(found) != 1:
        raise SystemExit(f"harness/{kind}_cell.py must hold one class "
                         f"whose kind is {kind!r}")
    return found[0]


def find(workload: str, root: str = ROOT,
         bench_dir: Optional[str] = None) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its files under
    `bench_dir` (default: the directory of this harness)."""
    bench = load_benchmark(root)
    bench_dir = bench_dir or HERE
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    cell = Cell(name=workload, chips=w["chips"],
                config_file=os.path.join(root, cfg["file"]),
                traffic_file=os.path.join(bench_dir, "workloads",
                                          w["traffic"] + ".json"),
                limits_file=os.path.join(bench_dir, "limits",
                                         workload + ".json"),
                end_to_end=e2e, per_layer=per_layer)
    rates = [m for m in e2e if m["name"] != "setup_s"]
    if len(rates) != 1 or not any(m["name"] == "setup_s" for m in e2e):
        raise SystemExit(f"{workload}: its end-to-end metrics must be "
                         f"setup_s and one rate, not "
                         f"{[m['name'] for m in e2e]}")
    for m in per_layer:
        mod = load_metric(os.path.join(bench_dir, "metrics",
                                       m["name"] + ".py"))
        for key in ("name", "unit", "layer", "moves"):
            if getattr(mod, key.upper()) != m[key]:
                raise SystemExit(f"metrics/{m['name']}.py declares "
                                 f"{key}={getattr(mod, key.upper())!r}, "
                                 f"BENCHMARK.json {m[key]!r}")
        cell.metrics[m["name"]] = mod
    return cell


def limits(cell: Cell) -> Dict[str, float]:
    """{number: limit} of the cell's correctness check; empty when the
    cell has no limits file yet (its runs then report correct false)."""
    if not os.path.exists(cell.limits_file):
        return {}
    with open(cell.limits_file) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}
