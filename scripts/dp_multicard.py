#!/usr/bin/env python3
"""Data parallelism over the cards of one host.

    python3 scripts/dp_multicard.py [--ranks 4] [--device cpu]

1. The cases of tests/torch_dp_worker.py (both trainers' steps, their
   evaluate and an epoch of each, float32 at small widths) in `--ranks`
   processes, one card each over NCCL (`parallel.launch`: rank r takes
   cuda:r), held to the same cases in one process on the whole batch
   (`torch_dp_worker.hold`: the CPU tests' tolerances), every rank
   launching K3, and K4 in the whisper cases.
2. The train_whisper (whisper-tiny, bf16) and train_classifier (full
   width, bf16, SpecAugment) CLIs under torchrun on `--ranks` cards and
   on one, on the same synthetic data and global batch: each run's
   metrics.jsonl (written once, by rank 0) and wall time, and each
   epoch's val loss and accuracy held to the one-process run's (CLI_TOL).
3. The gradient all-reduce over the ranks (`allreduce_rank`): the
   whisper-tiny train step (bf16, flash, 30 s clips) at 16 clips a rank
   with and without the group, in turns; `average_gradients` over every
   trainable leaf and a bare `all_reduce` of a flat buffer of as many
   floats, by CUDA events, and their device time by torch.profiler; the
   all-reduce's share of the step.

With --device cpu the same runs in gloo processes on the CPU at the test
config, a rehearsal of the paths (step 3 by the host clock, with no
device time).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
SCRIPTS = os.path.join(ROOT, "scripts")

# step 2: N ranks against one process, both in bf16. The runs differ in
# sum order and in the GEMMs' shapes (a rank holds 1/N of the rows), so
# a val loss may move by bf16's rounding: held within bf16's unit
# roundoff, 2**-8 relative (the four-card run saw 2.6e-5 for whisper,
# 8.9e-4 for the classifier), and the accuracy within one clip.
CLI_TOL = 2.0 ** -8


def torchrun(nproc, module, args, timeout):
    """Runs `python -m module args` under torchrun on nproc processes;
    returns (wall s, metrics.jsonl rows of --output_dir)."""
    from audio_transformers_tpu_torch.parallel.launch import free_port
    out_dir = args[args.index("--output_dir") + 1]
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", f"--master_port={free_port()}",
           "-m", module, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ,
                                                "PYTHONPATH": ROOT})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return wall, [json.loads(line) for line in f]


def val_clips(module: str, argv: list) -> int:
    """The validation clips that the CLI `module` evaluates with `argv`,
    from the CLI's own flags and data builders."""
    import importlib

    from audio_transformers_tpu_torch.cli import common
    a = importlib.import_module(module).parse_args(argv)
    if module.endswith("train_classifier"):
        return common.build_classifier_batchers(a)[1].num_samples
    from audio_transformers_tpu_torch.core.config import WhisperConfig
    vocab = WhisperConfig.by_name(a.model_size).vocab_size
    return common.build_expresso_splits(
        a, common.get_tokenizer(a.tokenizer), vocab_size=vocab)[1].num_samples


def hold_cli(many: list, one: list, n_val: int) -> float:
    """Holds each epoch's val loss of the N-rank run to the one-process
    run's within CLI_TOL relative and its val accuracy within one of
    `n_val` clips; returns the largest relative loss difference."""
    acc = "val/accuracy" if "val/accuracy" in one[0] else \
        "val/emotion_accuracy"
    assert len(many) == len(one), (many, one)
    worst = 0.0
    for a, b in zip(many, one):
        rel = abs(a["val/loss"] - b["val/loss"]) / abs(b["val/loss"])
        assert rel <= CLI_TOL, (f"epoch {b['epoch']}: val loss "
                                f"{a['val/loss']} against {b['val/loss']}")
        assert abs(a[acc] - b[acc]) <= 1 / n_val + 1e-9, (
            f"epoch {b['epoch']}: {acc} {a[acc]} against {b[acc]} "
            f"({n_val} clips)")
        worst = max(worst, rel)
    return worst


def _timed(fn, reps: int, cuda: bool) -> float:
    """ms of one fn() over `reps` calls after three warm-up calls: CUDA
    events on the card, the host clock on the CPU."""
    import torch
    for _ in range(3):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_kernels(fn, reps: int) -> list:
    """[(name, us)] of the kernels `reps` calls of fn() launched, from one
    torch.profiler session after one unrecorded call. One session only:
    every rank must make the same collective calls, so a trace that
    dropped its records is reported as such, not taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def allreduce_rank(out_dir: str, device: str) -> None:
    """One rank of step 3; writes <out_dir>/allreduce<rank>.json."""
    import torch
    import torch.distributed as dist

    from audio_transformers_tpu_torch import core as port
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.parallel import distributed
    from audio_transformers_tpu_torch.parallel.mesh import (
        Mesh, average_gradients, build_mesh)
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.common import batch_to_device
    from audio_transformers_tpu_torch.train.optim import build_optimizer

    cs = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                        run_name="dp_multicard")
    cuda = device == "cuda"
    distributed.initialize_if_multihost(device=device)
    mesh = build_mesh()
    dev = distributed.process_device(device)
    w = port.WhisperConfig() if cuda else port.WhisperConfig.test()
    cfg = port.EmotionWhisperConfig(whisper=w, num_emotion_classes=9)
    rows = 16 if cuda else 2
    tcfg = port.TrainConfig(
        batch_size=rows * mesh.size, attn_impl="flash",
        compute_dtype="bfloat16" if cuda else "float32",
        optimizer=port.OptimizerConfig(name="adamw", learning_rate=3e-5))
    mel_cfg = port.MelConfig.whisper()
    params0 = init(cfg, torch.Generator().manual_seed(0))
    duration = min(30.0, 2 * w.max_source_positions * mel_cfg.hop_length
                   / mel_cfg.sample_rate)
    batch = batch_to_device(cs["train_batch"](
        rows, duration, w, 9, seed=13 + mesh.rank), dev)

    def make(group_mesh):
        params = cs["_fresh"](torch, params0, dev)
        opt = build_optimizer(tcfg.optimizer, params)
        step, _ = tw.make_steps(cfg, mel_cfg, tcfg, opt, dev, group_mesh)
        return step, params, opt

    def sync():
        if cuda:
            torch.cuda.synchronize()

    steps = {True: [], False: []}
    for with_group in (True, False, False, True):
        step, params, opt = make(mesh if with_group else Mesh(1, 0))
        step(params, batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            step(params, batch)
        sync()
        steps[with_group].append((time.perf_counter() - t0) / 5 * 1e3)
    grads = [p.grad for p in opt.params if p.grad is not None]
    n_floats = sum(g.numel() for g in grads)
    flat = torch.zeros(n_floats, dtype=grads[0].dtype, device=dev)
    res = {
        "rank": mesh.rank, "world": mesh.size, "device": str(dev),
        "rows": rows, "n_floats": n_floats,
        "step_ms_group": steps[True], "step_ms_none": steps[False],
        "average_gradients_ms": _timed(
            lambda: average_gradients(opt.params, mesh), 20, cuda),
        "all_reduce_ms": _timed(
            lambda: dist.all_reduce(flat, group=mesh.group), 20, cuda),
        "average_gradients_device_ms": None, "nccl_device_ms": None,
        "kernels_per_call": None}
    if cuda:
        kernels = _device_kernels(
            lambda: average_gradients(opt.params, mesh), 20)
        if kernels:
            res["average_gradients_device_ms"] = sum(
                us for _, us in kernels) / 20 / 1e3
            res["nccl_device_ms"] = sum(
                us for name, us in kernels if "nccl" in name.lower()) \
                / 20 / 1e3
            res["kernels_per_call"] = len(kernels) / 20
    with open(os.path.join(out_dir, f"allreduce{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, TESTS]
    import torch

    import torch_dp_worker as worker
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.parallel.launch import launch

    cuda = args.device == "cuda"
    if cuda:
        if torch.cuda.device_count() < args.ranks:
            print(f"dp_multicard: {args.ranks} cards wanted, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.build_all()

    # 1. the worker's cases: N ranks against one
    one, many = tempfile.mkdtemp(), tempfile.mkdtemp()
    worker.run(one, "cuda:0" if cuda else "cpu")
    t0 = time.perf_counter()
    launch("torch_dp_worker:run", args.ranks, [many, args.device],
           timeout=600, env={"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"})
    wall = time.perf_counter() - t0
    a = torch.load(os.path.join(one, "rank0.pt"), weights_only=False)
    ranks = [torch.load(os.path.join(many, f"rank{r}.pt"),
                        weights_only=False) for r in range(args.ranks)]
    worst = worker.hold(a, ranks)
    devices = [r["device"] for r in ranks]
    if cuda:
        assert devices == [f"cuda:{r}" for r in range(args.ranks)], devices
        for r, res in enumerate(ranks):
            for case in worst:
                names = ("log_mel",) + (("flash_attention_fwd",
                                         "flash_attention_bwd_dq",
                                         "flash_attention_bwd_dkv")
                                        if case.startswith("wh") else ())
                for name, (launches, plain) in res[case]["launches"].items():
                    assert plain == 0, (r, case, name)
                    assert launches > 0 or name not in names, (r, case, name)
    print(f"{args.ranks} ranks on {devices} ({wall:.1f} s) against one "
          f"process: {json.dumps(worst)}; whisper token counts per rank "
          f"{[r['wh_sa']['tokens'] for r in ranks]}", flush=True)

    # 2. the CLIs under torchrun, N processes and one
    n = args.ranks
    common = ["--device", args.device, "--num_workers", "2", "--seed", "3"]
    if cuda:
        whisper = ["--dataset", "synthetic", "--batch_size", str(8 * n),
                   "--num_samples", str(20 * n), "--num_epochs", "2"]
        classifier = ["--dataset", "synthetic", "--batch_size",
                      str(32 * n), "--limit_samples", str(80 * n),
                      "--epochs", "2", "--spec_augment"]
    else:
        whisper = ["--dataset", "synthetic", "--batch_size", str(2 * n),
                   "--num_samples", str(6 * n), "--num_epochs", "1",
                   "--model_size", "test", "--compute_dtype", "float32"]
        classifier = ["--dataset", "synthetic", "--batch_size", str(4 * n),
                      "--limit_samples", str(10 * n), "--epochs", "1",
                      "--conv_dim", "32", "--encoder_dim", "32",
                      "--num_encoder_blocks", "1", "--num_heads", "4",
                      "--compute_dtype", "float32", "--spec_augment"]
    for module, flags in (
            ("audio_transformers_tpu_torch.cli.train_whisper", whisper),
            ("audio_transformers_tpu_torch.cli.train_classifier",
             classifier)):
        runs = {}
        for nproc in (n, 1):
            out = tempfile.mkdtemp()
            argv_ = [*flags, *common, "--output_dir", out]
            wall, runs[nproc] = torchrun(nproc, module, argv_, 900)
            epochs = int(flags[flags.index("--num_epochs" if "--num_epochs"
                                           in flags else "--epochs") + 1])
            assert len(runs[nproc]) == epochs, runs[nproc]  # rank 0 wrote
            print(f"{module.rsplit('.', 1)[1]} on {nproc} process(es): "
                  f"{wall:.1f} s; {json.dumps(runs[nproc])}", flush=True)
        n_val = val_clips(module, argv_)
        rel = hold_cli(runs[n], runs[1], n_val)
        print(f"{module.rsplit('.', 1)[1]}: {n} processes against one, val "
              f"loss within {rel:.3e} relative (tolerance {CLI_TOL:.3e}), "
              f"val accuracy within one of {n_val} clips", flush=True)

    # 3. the gradient all-reduce over the N ranks, and its share of a step
    out = tempfile.mkdtemp()
    launch("dp_multicard:allreduce_rank", args.ranks, [out, args.device],
           timeout=600, env={"PYTHONPATH": SCRIPTS, "OMP_NUM_THREADS": "1"})
    res = [json.load(open(os.path.join(out, f"allreduce{r}.json")))
           for r in range(args.ranks)]
    r0 = res[0]
    step = statistics.mean(r0["step_ms_group"])
    print(f"gradient all-reduce over {args.ranks} ranks "
          f"({'NCCL' if cuda else 'gloo'}, {r0['n_floats']} floats of "
          f"whisper {'tiny' if cuda else 'test'}, {r0['rows']} clips a "
          f"rank): average_gradients {r0['average_gradients_ms']:.4f} ms "
          f"({r0['average_gradients_ms'] / step:.2%} of the step with the "
          f"group, {step:.3f} ms), the bare all_reduce "
          f"{r0['all_reduce_ms']:.4f} ms; device "
          f"{r0['average_gradients_device_ms']} ms, NCCL's kernels "
          f"{r0['nccl_device_ms']} ms, {r0['kernels_per_call']} kernels a "
          f"call; step ms with / without the group "
          f"{r0['step_ms_group']} / {r0['step_ms_none']}", flush=True)
    print(f"all-reduce, every rank: {json.dumps(res)}", flush=True)
    print("dp_multicard: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
