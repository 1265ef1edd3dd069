"""Reads the numbers the check compares, for setting its limits: the
program's on many seeds (sound runs), the control's (the reference in
float8 in the program's place) and each planted fault's, all in one
process on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        --control 3 --faults 3 --seconds 2 --out <file.json>

The first `--control` seeds also read the control, the first `--faults`
seeds each fault the cell's kind can have (`harness/faults.py`). Each
reading is one run of the cell (set-up, a window of `--seconds`, the
check), as `run.py` makes it. Prints one JSON line per run and writes
them all to `--out`.
"""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


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

    from benchmark.harness import cell, faults, registry, traffic
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    kind = traffic.load(registry.find(args.workload).traffic_file)["kind"]
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    runs = [(s, None, i < args.control) for i, s in enumerate(seeds)]
    runs += [(s, f, False) for f in faults.FOR_KIND[kind]
             if f != "state_unchanged" for s in seeds[:args.faults]]
    for seed, fault, control in runs:
        r = cell.run(args.workload, seed, args.seconds, False,
                     device="cuda:0",
                     plant=faults.PLANTS[fault] if fault else None,
                     control=control)
        row = {"seed": seed, "fault": fault,
               "numbers": {k: v["value"] for k, v in r["checks"].items()},
               "control": r.get("control"), "metrics": r["metrics"],
               "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
