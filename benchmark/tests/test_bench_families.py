"""A model family and a cell kind join the benchmark as files alone: in a
copy of the benchmark's folder, a toy family (`harness/families/toy.py`),
a toy kind (`harness/toy_cell.py`), a configuration, a traffic mix, a
limits file, a per-layer metric and `BENCHMARK.json` entries are added,
and `registry.find` and `cell.run` run the new cell on the CPU with no
file of the harness edited."""

import filecmp
import json
import os
import shutil

from benchmark.harness import cell, registry

FAMILY = '''
"""A toy family: one square matrix."""
import types

import torch

PUBLISHED = {"test size": {"width": 8}}
FROZEN = ()


def dims(raw):
    return types.SimpleNamespace(width=raw["width"], rows=raw["rows"])


def port_config(dims):
    return dims.width


def make_weights(dims, seed, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(int(seed))
    return {"w": torch.randn((dims.width, dims.width), generator=g,
                             device=device, dtype=dtype)}


def port_tree(flat):
    return dict(flat)


def _forward(w, x, precision="float32"):
    if precision == "fp8":
        w = w.to(torch.float8_e4m3fn).float()
    return x.double() @ w.double()


reference = types.SimpleNamespace(forward=_forward)
'''

KIND = '''
"""A toy kind: the product of the family's matrix with seeded rows."""
import time

import torch


class ToyCell:
    kind = "toy"

    def __init__(self, dims, mix, seed, device, spans, traced, *, family,
                 ranks):
        self.family, self.dims, self.seed, self.device = (family, dims,
                                                          seed, device)
        self.w = family.port_tree(family.make_weights(dims, seed,
                                                      device))["w"]
        g = torch.Generator(device=device).manual_seed(int(seed) + 1)
        self.x = torch.randn((mix["rows"], dims.width), generator=g,
                             device=device)

    def window(self, seconds, trace_steps=0):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.y = self.x @ self.w
            n += 1
        self.steps = n
        elapsed = time.perf_counter() - t0
        return {"attempted": n, "failed": 0,
                "rate": (n / elapsed, "products/s"), "trace": None,
                "window_s": elapsed}

    def release(self):
        self.w = None

    def reference(self, precision="float32"):
        w = self.family.make_weights(self.dims, self.seed, self.device)["w"]
        return self.family.reference.forward(w, self.x, precision)

    def numbers(self, reference, other=None):
        y = self.y if other is None else other
        return {"toy_err": float((y.double() - reference).abs().max())}

    def control_numbers(self, reference):
        return self.numbers(reference, self.reference("fp8"))
'''

METRIC = '''
NAME = "toy_steps"
UNIT = "products"
LAYER = "toy product"
MOVES = "toy_products_per_s"


def read(ctx):
    return float(ctx.cell.steps)
'''


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, fs in os.walk(top) if "__pycache__" not in d
                  for f in fs)


def test_a_new_family_and_kind_are_files_alone(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(bench_dir)
    (bench_dir / "harness" / "families" / "toy.py").write_text(FAMILY)
    (bench_dir / "harness" / "toy_cell.py").write_text(KIND)
    (bench_dir / "metrics" / "toy_steps.py").write_text(METRIC)
    (bench_dir / "configs" / "toy.json").write_text(json.dumps(
        {"source": "test size", "model_type": "toy", "width": 8,
         "rows": 4}))
    (bench_dir / "workloads" / "toy-mix.json").write_text(json.dumps(
        {"kind": "toy", "rows": 4, "trace_steps": 0}))
    (bench_dir / "limits" / "toy-cell.json").write_text(json.dumps(
        {"toy_err": {"limit": 1e-5}}))
    bench = registry.load_benchmark()
    bench["configs"].append({"name": "toy", "source": "test size",
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy",
                               "traffic": "toy-mix", "chips": 1,
                               "why": "CPU tests"})
    bench["end_to_end"].append({
        "name": "toy_products_per_s", "unit": "products/s",
        "better": "higher", "bound": 0.01, "source": "host_clock",
        "workloads": ["toy-cell"]})
    bench["per_layer"].append({
        "name": "toy_steps", "unit": "products", "better": "higher",
        "source": "host_clock", "layer": "toy product",
        "moves": "toy_products_per_s", "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root, bdir = str(tmp_path), str(bench_dir)

    found = registry.find("toy-cell", root, bdir)
    family, dims = registry.load_config(found.config_file, bdir)
    assert family.PUBLISHED["test size"]["width"] == dims.width == 8
    assert registry.kind_class("toy", bdir).__name__ == "ToyCell"
    r = cell.run("toy-cell", 2 ** 31 + 3, 0.2, False, device="cpu",
                 root=root, bench_dir=bdir, control=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "toy_products_per_s"}
    assert r["control"]["toy_err"] > 1e-5
    r = cell.run("toy-cell", 2 ** 31 + 3, 0.2, True, device="cpu",
                 root=root, bench_dir=bdir)
    assert r["metrics"]["toy_steps"]["value"] >= 1
    # nothing that was there changed
    assert set(before) <= set(_files(bench_dir))
    match, mismatch, errors = filecmp.cmpfiles(registry.HERE, bench_dir,
                                               before, shallow=False)
    assert not mismatch and not errors
