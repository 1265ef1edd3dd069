"""Train cells: the program's dual-loss train step over a pool of batches.

Set-up builds one train step (`make_steps(...)[0]`) with its parameters
and AdamW state, and drives it through its first three steps on pool
batches 0, 1 and 2 (the correctness readings: each step's loss, each
leaf's first gradient as AdamW holds it after step 1, each leaf's change
after step 3). The window then goes on with that same object over the
pool from batch 3, cycling, and ends on a synchronise.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import program, traffic, weights
from benchmark.harness.checks import train_numbers
from benchmark.harness.tracing import DeviceTrace, Spans
from benchmark.reference import whisper as ref

FIRST_STEPS = 3


class TrainCell:
    kind = "train"

    def __init__(self, dims, mix: dict, seed: int, device, spans: Spans,
                 traced: bool):
        from audio_transformers_tpu_torch.core.config import (OptimizerConfig,
                                                              TrainConfig)
        from audio_transformers_tpu_torch.core.params import set_trainable
        from audio_transformers_tpu_torch.train.optim import (
            build_optimizer, frozen_leaf_decay_mask)
        from audio_transformers_tpu_torch.train.whisper_emotion import \
            make_steps

        self.dims, self.mix, self.seed, self.device = dims, mix, seed, device
        self.batch = mix["batch"]
        self.t_dec = mix["label_len"] - 1
        o = mix["optimizer"]
        self.tcfg = TrainConfig(
            batch_size=self.batch, compute_dtype=mix["compute_dtype"],
            remat=mix["remat"], attn_impl=mix["attn_impl"],
            spec_augment=False, emotion_weight=mix["emotion_weight"],
            optimizer=OptimizerConfig(
                name="adamw", learning_rate=o["lr"], b1=o["b1"], b2=o["b2"],
                eps=o["eps"], weight_decay=o["weight_decay"]))
        cfg, mel_cfg = program.configs(dims)
        flat = weights.make(dims, seed, device)
        self.leaves = {n: t.clone() for n, t in flat.items()}
        del flat
        self.params = set_trainable(weights.tree(self.leaves))
        self.trainable = [n for n, t in self.leaves.items()
                          if t.requires_grad]
        self.opt = build_optimizer(self.tcfg.optimizer, self.params,
                                   decay_mask=frozen_leaf_decay_mask)
        self.step = make_steps(cfg, mel_cfg, self.tcfg, self.opt, device)[0]
        if traced:
            mods = program.modules()
            we = mods["whisper_emotion"]
            spans.wrap(self, "step", "train_step")
            spans.wrap(self.opt, "step", "optimizer.step", cuda_events=True)
            spans.wrap(we, "log_mel", "log_mel")
            spans.wrap(mods["emotion"], "forward_train", "forward_train")
            spans.wrap(we, "dual_loss", "dual_loss")
            spans.wrap(we, "average_gradients", "average_gradients")
        self.pool = [traffic.train_batch(mix, dims, seed, i, device)
                     for i in range(mix["pool"])]
        self.port = self._first_steps()

    def _first_steps(self) -> dict:
        start = {n: self.leaves[n].detach().clone() for n in self.trainable}
        losses, grad = [], {}
        b1 = self.tcfg.optimizer.b1
        for i in range(FIRST_STEPS):
            losses.append(self.step(self.params, self.pool[i])["loss"])
            if i == 0:
                state = self.opt.opt.state
                grad = {n: float(state[self.leaves[n]]["exp_avg"].norm())
                        / (1 - b1) if self.leaves[n] in state else 0.0
                        for n in self.trainable}
        change = {n: float((self.leaves[n].detach() - start[n]).norm())
                  for n in self.trainable}
        return {"loss": [float(x) for x in losses], "grad_norm": grad,
                "change": change}

    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """Steps until `seconds` have passed; with `trace_steps`, the
        device trace covers that many steps from the window's third
        (again from the next, up to three times, if a trace holds no
        device record)."""
        losses = []
        n, tries = 0, 0
        trace, begin = None, 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or (
                trace is not None and trace.t1 == 0):
            if trace_steps and n == begin and trace is None:
                trace = DeviceTrace().__enter__()
                before = program.launches()
            batch = self.pool[(FIRST_STEPS + n) % len(self.pool)]
            losses.append(self.step(self.params, batch)["loss"])
            n += 1
            if trace is not None and trace.t1 == 0 and n == begin + trace_steps:
                trace.__exit__(None, None, None)
                after = program.launches()
                launched = {k: after[k] - before[k] for k in after}
                if not trace.complete(launched) and tries < 2:
                    tries, trace, begin = tries + 1, None, n
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses).float())
        self.steps = n
        self.traced_steps = trace_steps
        self.rate = n * self.batch / elapsed
        return {"attempted": n, "failed": int((~finite).sum()),
                "rate": (self.rate, "clips/s"),
                "trace": trace, "window_s": elapsed}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        for name in ("params", "leaves", "opt", "step", "pool"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict:
        flat = weights.make(self.dims, self.seed, self.device)
        w = {n: t.clone() for n, t in flat.items()}
        del flat
        batches = [traffic.train_batch(self.mix, self.dims, self.seed, i,
                                       self.device)
                   for i in range(FIRST_STEPS)]
        o = self.mix["optimizer"]
        return ref.train_steps(
            self.dims, w, batches, [n for n in w if n not in weights.FROZEN],
            lr=o["lr"], betas=(o["b1"], o["b2"]), eps=o["eps"],
            weight_decay=o["weight_decay"],
            emotion_weight=self.mix["emotion_weight"], precision=precision)

    def numbers(self, reference: dict) -> dict:
        port = dict(self.port)
        for key in ("grad_norm", "change"):
            port[key] = {n: port[key].get(n, 0.0) for n in reference[key]}
        return train_numbers(port, reference)

    def control_numbers(self, reference: dict) -> dict:
        """The control's numbers: the reference in float8 in the
        program's place, against the float32 reference."""
        return train_numbers(self.reference("fp8"), reference)
