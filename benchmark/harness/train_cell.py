"""Train cells: the program's dual-loss train step over a pool of batches.

Set-up builds one train step (`make_steps(...)[0]`) with its parameters
and AdamW state, and drives it through its first three steps on pool
batches 0, 1 and 2 (the correctness readings: each step's loss, each
leaf's first gradient as AdamW holds it after step 1, each leaf's change
after step 3). The window then goes on with that same object over the
pool from batch 3, cycling, and ends on a synchronise.

On n > 1 cards (data parallelism) each rank builds the same weights from
the seed and the step over the program's mesh (`make_steps(...,
mesh=)`), and draws its own rows (`traffic.rank_seed`): batch i of the
cell is the n ranks' batches i together. The program averages the
gradients over the ranks and divides each rank's token sum by the global
token count over n, so the mean of the ranks' losses is the global
batch's loss; that mean is the loss compared. The reference runs over
the global batch, each rank's rows on its card, its float32 gradients
summed over the ranks (`reference.train_steps(..., group=)`). After
step 3 `replica_gap` is the largest difference between a trainable leaf
on rank 0 and on any other rank. Rank 0 decides when the window ends;
it starts and ends on a barrier.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from benchmark.harness import program, traffic
from benchmark.harness.checks import train_numbers
from benchmark.harness.ranks import SINGLE, Ranks
from benchmark.harness.tracing import DeviceTrace, Spans

FIRST_STEPS = 3


class TrainCell:
    kind = "train"

    def __init__(self, dims, mix: dict, seed: int, device, spans: Spans,
                 traced: bool, *, family, ranks: Ranks = SINGLE):
        from audio_transformers_tpu_torch.core.config import (OptimizerConfig,
                                                              TrainConfig)
        from audio_transformers_tpu_torch.core.params import set_trainable
        from audio_transformers_tpu_torch.train.optim import (
            build_optimizer, frozen_leaf_decay_mask)
        from audio_transformers_tpu_torch.train.whisper_emotion import \
            make_steps

        self.dims, self.mix, self.seed, self.device = dims, mix, seed, device
        self.family, self.ranks, self.world = family, ranks, ranks.world
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
        cfg, mel_cfg = family.port_config(dims)
        flat = family.make_weights(dims, seed, device)
        self.leaves = {n: t.clone() for n, t in flat.items()}
        del flat
        self.params = set_trainable(family.port_tree(self.leaves))
        self.trainable = [n for n, t in self.leaves.items()
                          if t.requires_grad]
        self.opt = build_optimizer(self.tcfg.optimizer, self.params,
                                   decay_mask=frozen_leaf_decay_mask)
        mesh = () if ranks.mesh is None else (ranks.mesh,)
        self.step = make_steps(cfg, mel_cfg, self.tcfg, self.opt, device,
                               *mesh)[0]
        if traced:
            mods = program.modules()
            we = mods["whisper_emotion"]
            spans.wrap(self, "step", "train_step")
            spans.wrap(self.opt, "step", "optimizer.step", cuda_events=True)
            spans.wrap(we, "log_mel", "log_mel")
            spans.wrap(mods["emotion"], "forward_train", "forward_train")
            spans.wrap(we, "dual_loss", "dual_loss")
            spans.wrap(we, "average_gradients", "average_gradients")
        rows_seed = traffic.rank_seed(seed, ranks.rank)
        self.pool = [traffic.train_batch(mix, dims, rows_seed, i, device)
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
        out = {"loss": [float(x) for x in losses], "grad_norm": grad,
               "change": change}
        if self.world > 1:
            out["loss"] = [float(x) for x in self._rank_mean(losses)]
            out["replica_gap"] = self._replica_gap()
        return out

    def _rank_mean(self, values) -> torch.Tensor:
        t = torch.stack(values).float()
        dist.all_reduce(t)
        return t / self.world

    def _replica_gap(self) -> float:
        """The largest |leaf on this rank - leaf on rank 0| over the
        trainable leaves and the ranks."""
        gap = torch.zeros((), device=self.device)
        with torch.no_grad():
            for n in self.trainable:
                leaf = self.leaves[n].detach()
                first = leaf.clone()
                dist.broadcast(first, src=0)
                gap = torch.maximum(gap, (leaf - first).abs().max())
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """Steps until `seconds` have passed; with `trace_steps`, the
        device trace covers that many steps from the window's third
        (again from the next, up to three times, if a trace holds no
        device record)."""
        losses = []
        n, tries = 0, 0
        trace, begin = None, 2
        ranks = self.ranks
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ranks.barrier()
        self.t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        while ranks.agree(time.perf_counter() - t0 < seconds or (
                trace is not None and trace.t1 == 0)):
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
                if not ranks.all(trace.complete(launched)) and tries < 2:
                    tries, trace, begin = tries + 1, None, n
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ranks.barrier()
        elapsed = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses).float())
        self.steps = n
        self.traced_steps = trace_steps
        self.rate = n * self.batch * self.world / elapsed
        failed = int(ranks.sum(int((~finite).sum())))
        return {"attempted": n, "failed": failed,
                "rate": (self.rate, "clips/s"),
                "trace": trace, "window_s": elapsed}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        for name in ("params", "leaves", "opt", "step", "pool"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict:
        fam = self.family
        flat = fam.make_weights(self.dims, self.seed, self.device)
        w = {n: t.clone() for n, t in flat.items()}
        del flat
        rows_seed = traffic.rank_seed(self.seed, self.ranks.rank)
        batches = [traffic.train_batch(self.mix, self.dims, rows_seed, i,
                                       self.device)
                   for i in range(FIRST_STEPS)]
        o = self.mix["optimizer"]
        group = {} if self.world == 1 else {"group": self.ranks.mesh.group}
        return fam.reference.train_steps(
            self.dims, w, batches, [n for n in w if n not in fam.FROZEN],
            lr=o["lr"], betas=(o["b1"], o["b2"]), eps=o["eps"],
            weight_decay=o["weight_decay"],
            emotion_weight=self.mix["emotion_weight"], precision=precision,
            **group)

    def numbers(self, reference: dict) -> dict:
        port = dict(self.port)
        for key in ("grad_norm", "change"):
            port[key] = {n: port[key].get(n, 0.0) for n in reference[key]}
        numbers = train_numbers(port, reference)
        if "replica_gap" in port:
            numbers["replica_gap"] = port["replica_gap"]
        return numbers

    def control_numbers(self, reference: dict) -> dict:
        """The control's numbers: the reference in float8 in the
        program's place, against the float32 reference."""
        return train_numbers(self.reference("fp8"), reference)
