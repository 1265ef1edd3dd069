"""A cell on several cards, rehearsed on the CPU: two ranks over gloo run
the test-size train cell in data parallelism through the same path as
`run.py` (`cell.run_across`), and a failed rank ends the run with no
result and no rank left running."""

import json
import os
import time

import pytest

from benchmark.harness import cell, ranks
from benchmark.tests import helpers

SEED = 2 ** 31 + 77
LIMIT = 1e-3


def _two_rank_root(tmp):
    root = helpers.make(tmp, limits={"test-train-dp2": dict(
        loss_gap=LIMIT, grad_gap=LIMIT, change_gap=LIMIT, replica_gap=0.0)})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "test-train-dp2", "config": "test",
                               "traffic": "t-train", "chips": 2,
                               "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append("test-train-dp2")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_two_ranks_step_the_global_batch_as_the_reference(tmp_path,
                                                          capsys):
    root = _two_rank_root(str(tmp_path))
    r = cell.run_across(2, timeout=240, workload="test-train-dp2",
                        seed=SEED, seconds=0.5, trace=False, device="cpu",
                        root=root, bench_dir=root)
    assert r is not None
    assert r["device"]["count"] == 2
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                "replica_gap"}
    assert r["checks"]["replica_gap"]["value"] == 0.0
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "train_clips_per_s"}
    capsys.readouterr()
    cell.emit(r)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["correct"]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def fail_on_rank_one(device, ranks):
    """A rank 1 that fails while rank 0 waits on it."""
    if ranks.rank == 1:
        raise ValueError("planted")
    time.sleep(600)


def test_a_failed_rank_ends_every_rank(capsys):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        ranks.launch("benchmark.tests.test_bench_ranks:fail_on_rank_one",
                     {"device": "cpu"}, 2, timeout=120)
    assert time.monotonic() - t0 < 60
    assert "planted" in capsys.readouterr().err
