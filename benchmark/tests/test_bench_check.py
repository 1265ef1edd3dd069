"""The check that decides `correct`, on the CPU at the test size: the
reference agrees with the program, the control (the reference in float8
in the program's place) fails, and so does every planted fault a cell's
kind can have. The same runs at the cells' own sizes are made on the
card by `benchmark/calibrate.py` (PERF.md gives their readings)."""

import pytest

from benchmark.harness import cell, faults
from benchmark.harness.checks import verdict
from benchmark.tests import helpers

LIMIT = 1e-3
NUMBERS = {"test-train": ("loss_gap", "grad_gap", "change_gap"),
           "test-analyze": ("mel_err", "encoder_err", "cross_kv_err",
                            "token_gap", "emotion_err")}
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    limits = {w: {k: LIMIT for k in ks} for w, ks in NUMBERS.items()}
    return helpers.make(str(tmp_path_factory.mktemp("reg")), limits=limits)


@pytest.mark.parametrize("workload", sorted(NUMBERS))
def test_the_program_agrees_with_the_reference_and_the_control_fails(
        root, workload):
    r = cell.run(workload, SEED, 0.3, False, device="cpu", root=root,
                 bench_dir=root, control=True)
    assert set(r["checks"]) == set(NUMBERS[workload])
    assert r["correct"], r["checks"]
    assert all(c["value"] < 1e-4 for c in r["checks"].values()), r["checks"]
    ok, _ = verdict(r["control"], {k: LIMIT for k in r["control"]})
    assert not ok, r["control"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, kind in (("test-train", "train"),
                           ("test-analyze", "analyze"))
    for f in faults.FOR_KIND[kind]])
def test_a_planted_fault_comes_out_not_correct(root, workload, fault):
    r = cell.run(workload, SEED + 1, 0.3, False, device="cpu", root=root,
                 bench_dir=root, plant=faults.PLANTS[fault])
    assert not r["correct"], r["checks"]


def test_a_cell_without_limits_is_not_correct(tmp_path):
    bare = helpers.make(str(tmp_path))
    r = cell.run("test-train", SEED, 0.2, False, device="cpu", root=bare,
                 bench_dir=bare)
    assert not r["correct"]
    assert all(c["limit"] is None for c in r["checks"].values())


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    """One short run of every cell of BENCHMARK.json (about 2 min each;
    a cell on more cards than the machine has is left out)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness import registry
    for w in registry.load_benchmark()["workloads"]:
        if w["chips"] == 1:
            r = cell.run(w["name"], SEED, 3.0, False, device="cuda:0")
        elif torch.cuda.device_count() >= w["chips"]:
            r = cell.run_across(w["chips"], workload=w["name"], seed=SEED,
                                seconds=3.0, trace=False, device="cuda")
        else:
            continue
        assert r is not None and r["correct"], (w["name"], r)
