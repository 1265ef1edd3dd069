"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics and the device's busy time. It runs on
the card it is started on and exits non-zero, printing no result, when
there is none (or fewer than the cell needs). A cell on n > 1 cards runs
as n processes, rank r on card r (`harness/ranks.py`); this process
starts them, waits for them and prints rank 0's result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark.harness import cell, registry
    need = registry.find(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if need == 1:
        result = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda:0", t_start=T_START)
    else:
        result = cell.run_across(
            need, workload=args.workload, seed=args.seed,
            seconds=args.seconds, trace=bool(args.trace), device="cuda",
            t_start=T_START)
        if result is None:
            return 1
        found = cell.banned_modules()
        if found:
            print(f"loaded: {found}", file=sys.stderr)
            return 1
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
