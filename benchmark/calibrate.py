"""Reads the numbers the check compares, for setting its limits: the
program's on many seeds (sound runs), the control's (the reference in
float8 in the program's place) and each planted fault's, all in one
process on the card (one process a card, for a cell on several).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        --control 3 --faults 3 --seconds 2 --out <file.json>

The first `--control` seeds also read the control, the first `--faults`
seeds each fault the cell can have (`harness/faults.py`). Each reading is
one run of the cell (set-up, a window of `--seconds`, the check), as
`run.py` makes it. Prints one JSON line per run and writes them all to
`--out`, again after each run.
"""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(workload: str, seeds: list, control: int, faults_n: int,
             seconds: float, out: str, device: str = "cuda:0",
             ranks=None) -> None:
    """The calibration runs, in this process (one rank of several where
    `ranks` says so); rank 0 prints and writes the rows."""
    import torch

    from benchmark.harness import cell, faults, registry, traffic
    from benchmark.harness.ranks import SINGLE
    ranks = ranks or SINGLE
    found = registry.find(workload)
    kind = traffic.load(found.traffic_file)["kind"]
    runs = [(s, None, i < control) for i, s in enumerate(seeds)]
    runs += [(s, f, False) for f in faults.for_cell(kind, found.chips)
             if f != "state_unchanged" for s in seeds[:faults_n]]
    rows = []
    for seed, fault, with_control in runs:
        r = cell.run(workload, seed, seconds, False, device=device,
                     plant=faults.PLANTS[fault] if fault else None,
                     control=with_control, ranks=ranks)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if r is None:
            continue
        row = {"seed": seed, "fault": fault,
               "numbers": {k: v["value"] for k, v in r["checks"].items()},
               "control": r.get("control"), "metrics": r["metrics"],
               "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from benchmark.harness import ranks, registry
    n = registry.find(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"needs {n} CUDA device(s)", file=sys.stderr)
        return 2
    kwargs = dict(workload=args.workload,
                  seeds=[int(s) for s in args.seeds.split(",")],
                  control=args.control, faults_n=args.faults,
                  seconds=args.seconds, out=os.path.abspath(args.out))
    if n == 1:
        readings(**kwargs)
        return 0
    try:
        sys.stdout.write(ranks.launch("benchmark.calibrate:readings",
                                      dict(kwargs, device="cuda"), n))
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
