"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole), and the reference loads nothing of the port."""

import os
import subprocess
import sys

from benchmark.harness import registry

ROOT = registry.ROOT

PROBE = r"""
import json, pkgutil, importlib, sys, tempfile
sys.path.insert(0, {root!r})
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__,
                                                "benchmark.")
         if ".tests" not in m.name]
for n in names:
    importlib.import_module(n)
from benchmark.harness import registry
for m in registry.load_benchmark()["per_layer"]:
    registry.load_metric(registry.HERE + "/metrics/" + m["name"] + ".py")
if {run}:
    from benchmark.tests import helpers
    from benchmark.harness import cell
    d = helpers.make(tempfile.mkdtemp())
    for w in ("test-train", "test-analyze"):
        cell.run(w, 3, 0.2, False, device="cpu", root=d, bench_dir=d)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_benchmark_loads_no_jax():
    top = loaded(PROBE.format(root=ROOT, run=True))
    assert not top & {"jax", "jaxlib", "flax", "audio_transformers_tpu"}
    assert "audio_transformers_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {ROOT!r}); "
            "import benchmark.reference.whisper; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    top = loaded(code)
    assert not top & {"jax", "jaxlib", "flax", "audio_transformers_tpu",
                      "audio_transformers_tpu_torch"}


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tiny-train-b64",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
