"""UrbanSound classifier training: Adam, ReduceLROnPlateau, cross-entropy.

The reference's `audio_transformers_tpu/train/classifier.py` on PyTorch.
The step computes the log-mel features from the waveform
(the CUDA kernel on the card), casts them to `compute_dtype`, masks them
with SpecAugment when configured, runs the classifier in training mode
and takes a float32 cross-entropy; Adam updates the float32 parameters in
place and the BatchNorm statistics come back as the new state. The eval
step runs the classifier in evaluation mode (the running statistics) and
returns sums weighted by `valid`, so the wrap-padded rows of the last
batch count for nothing.

Random draws (dropout, SpecAugment) come from one generator per epoch,
seeded from (seed, epoch) (`common.epoch_generator`) as the
reference folds the epoch into its key, so a resumed run replays the
draws of an uninterrupted one. The draws themselves are not
`jax.random`'s.

With a checkpoint directory a run keeps the reference's two: <dir> holds
the best epochs by val accuracy (params and state), <dir>-resume the last
epoch's params, state, Adam state and the plateau scheduler's position,
from which a rerun resumes at the next epoch.

Data parallelism (`parallel/`): in a process group, `mesh_shape`'s
"data" axis spans the ranks. Each rank takes its rows of every global
batch (`data.loader.Batcher`), the parameters and state start
from rank 0's, BatchNorm normalises with the global batch's statistics,
dropout and SpecAugment draw for the global batch and keep this rank's
rows (`common.rank_generator`), the gradients are averaged before Adam
steps, and the eval sums and train metrics are reduced over the ranks,
so a step equals one process's step on the global batch up to sum
order; rank 0 alone writes. On a mesh with a "model" axis every model
rank holds a replica and its data rank's rows, as in the reference
(whose classifier trainer replicates its parameters), unless
`tensor_parallel` is set: each model rank then holds its shards of the
parameters (`us.param_axes`) and of Adam's moments, the steps run the
sharded model (K3 on every rank), the gradients are averaged over the
data axis only, and the checkpoints hold the whole tree (gathered on
every rank, written by rank 0).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.checkpoint import (Checkpointer,
                                                          check_structure)
from audio_transformers_tpu_torch.core.config import (MelConfig, TrainConfig,
                                                      UrbanSoundConfig)
from audio_transformers_tpu_torch.core.metrics import MetricLogger, StepTimer
from audio_transformers_tpu_torch.core.params import resolve_device
from audio_transformers_tpu_torch.models.urbansound import model as us
from audio_transformers_tpu_torch.ops import specaugment as sa
from audio_transformers_tpu_torch.ops.mel import log_mel
from audio_transformers_tpu_torch.parallel import tensor as tp
from audio_transformers_tpu_torch.parallel.mesh import (Mesh,
                                                        all_reduce_sum,
                                                        average_gradients,
                                                        build_mesh,
                                                        replicated)
from audio_transformers_tpu_torch.train.common import (DTYPES,
                                                       batch_to_device,
                                                       epoch_generator,
                                                       host_copy,
                                                       mean_over_ranks,
                                                       metric_logger,
                                                       rank_generator,
                                                       restore_into)
from audio_transformers_tpu_torch.train.optim import (PlateauScheduler,
                                                      build_optimizer,
                                                      set_learning_rate)


def make_steps(model_cfg: UrbanSoundConfig, mel_cfg: MelConfig,
               train_cfg: TrainConfig, opt, mesh: Mesh = Mesh(1, 0), *,
               tensor_parallel: bool = False):
    """(train_step, eval_step).

    train_step(params, state, batch, generator) updates `params` in place
    through `opt` and returns (new state, metrics as device scalars);
    `generator` (on the batch's device) draws the SpecAugment masks, then
    the dropout masks; None draws neither. eval_step(params, state, batch)
    returns the sums `loss_sum`, `correct` and `count`. On a `mesh` of
    several ranks train_step takes this rank's rows and a `nn.RowShard`
    generator, normalises BatchNorm over the global batch and averages
    the gradients before Adam steps. With `tensor_parallel` on a mesh
    with a model axis the parameters are this rank's shards
    (`us.param_axes`) and `opt` is built over them with the model group
    and the axes (the clip's norm over the whole tree)."""
    compute_dtype = DTYPES[train_cfg.compute_dtype]
    model_group = mesh.model_group if tensor_parallel else None

    def forward(params, state, waveform, *, training, generator=None):
        mel = log_mel(waveform, mel_cfg).to(compute_dtype)
        if train_cfg.spec_augment and training and generator is not None:
            mel = sa.spec_augment(generator, mel)
        return us.apply(params, state, model_cfg, mel, training=training,
                        generator=generator, group=mesh.group,
                        model_group=model_group)

    def train_step(params, state, batch, generator=None):
        logits, new_state = forward(params, state, batch["waveform"],
                                    training=True, generator=generator)
        logits = logits.float()
        loss = F.cross_entropy(logits, batch["label"])
        opt.zero_grad()
        loss.backward()
        average_gradients(opt.params, mesh)
        opt.step()
        acc = (logits.argmax(dim=-1) == batch["label"]).float().mean()
        return new_state, {"loss": loss.detach(), "accuracy": acc}

    @torch.no_grad()
    def eval_step(params, state, batch):
        logits, _ = forward(params, state, batch["waveform"], training=False)
        logits = logits.float()
        per = F.cross_entropy(logits, batch["label"], reduction="none")
        correct = (logits.argmax(dim=-1) == batch["label"]).float()
        valid = batch["valid"].float()
        return {"loss_sum": (per * valid).sum(),
                "correct": (correct * valid).sum(), "count": valid.sum()}

    return train_step, eval_step


def evaluate(eval_step, params, state, batcher, device,
             mesh: Mesh = Mesh(1, 0)) -> Dict[str, float]:
    """{"loss", "accuracy"} over every valid row of the eval batches; on a
    mesh of several ranks each rank evaluates its rows and the sums are
    reduced over them."""
    keys = ("loss_sum", "correct", "count")
    totals = torch.zeros(len(keys), dtype=torch.float64, device=device)
    for batch in batcher.eval_batches():
        out = eval_step(params, state, batch_to_device(batch, device))
        totals += torch.stack([out[k].double() for k in keys])
    sums = dict(zip(keys, all_reduce_sum(totals, mesh).tolist()))
    n = max(sums["count"], 1.0)
    return {"loss": sums["loss_sum"] / n, "accuracy": sums["correct"] / n}


def train_classifier(model_cfg: UrbanSoundConfig, mel_cfg: MelConfig,
                     train_cfg: TrainConfig, train_batcher, val_batcher, *,
                     device="cuda", init_params=None,
                     log_dir: Optional[str] = None,
                     wandb_project: Optional[str] = None,
                     logger: Optional[MetricLogger] = None,
                     tensor_parallel: bool = False) -> dict:
    """Trains for train_cfg.num_epochs epochs on `device` ("cuda" raises
    when no CUDA device is present), evaluating after each one.

    `init_params` is a (params, state) pair of port trees (e.g.
    `core.params.from_jax_params` of the reference's); None initialises
    from train_cfg.seed. Metrics go to <log_dir>/metrics.jsonl. Returns
    {"params", "state", "optimizer", "best_params", "best_state" (a host
    snapshot of the best-by-val-accuracy epoch), "history" (this run's
    epochs), "best_val_accuracy"}.

    In a process group (`parallel.distributed`) this runs on every rank,
    each with its own device and batchers
    (`build_mesh(train_cfg.mesh_shape)` must cover the group). With
    `tensor_parallel` the model axis cuts the parameters (see the module
    note); the returned params and snapshots are the whole tree."""
    device = resolve_device(device)
    mesh = build_mesh(train_cfg.mesh_shape)
    writer = mesh.writer
    if init_params is None:
        init_params = us.init(model_cfg, torch.Generator().manual_seed(
            train_cfg.seed))
    params = cp.map_tensors(init_params[0], lambda t: t.detach().to(
        device, torch.float32).clone())
    axes = (us.param_axes(params, model_cfg, mesh.model_size)
            if tensor_parallel and mesh.model_group is not None else None)
    if axes is not None:
        params = tp.shard_params(params, mesh.model_size, mesh.model_rank,
                                 axes)
    params = cp.set_trainable(replicated(params, mesh), frozen=())
    state = replicated(cp.map_tensors(
        init_params[1], lambda t: t.detach().to(device).clone()), mesh)
    opt = build_optimizer(train_cfg.optimizer, params,
                          total_steps=train_batcher.steps_per_epoch
                          * train_cfg.num_epochs,
                          model_group=None if axes is None
                          else mesh.model_group, axes=axes)

    def whole(tree):   # the whole parameter tree, on every model rank
        return (tp.gather_params(tree, mesh.model_group, axes)
                if axes is not None else tree)
    train_step, eval_step = make_steps(model_cfg, mel_cfg, train_cfg, opt,
                                       mesh, tensor_parallel=axes is not None)
    plateau = (PlateauScheduler(train_cfg.optimizer)
               if train_cfg.optimizer.schedule == "reduce_on_plateau"
               else None)
    ckpt = resume_ckpt = None
    if train_cfg.checkpoint_dir:
        ckpt = Checkpointer(train_cfg.checkpoint_dir,
                            max_to_keep=train_cfg.keep_checkpoints,
                            best_mode="max")
        resume_ckpt = Checkpointer(train_cfg.checkpoint_dir + "-resume",
                                   max_to_keep=1)
    log = logger or metric_logger(
        mesh, log_dir=log_dir, wandb_project=wandb_project,
        config={"model": model_cfg.to_json(), "train": train_cfg.to_json()})

    best_val_acc, history, best_tree = -1.0, [], None
    step = start_epoch = 0
    if resume_ckpt is not None and resume_ckpt.latest_step() is not None:
        tree, meta, step = restore_into(
            params, opt, resume_ckpt,
            shard=None if axes is None else lambda t: tp.shard_params(
                t, mesh.model_size, mesh.model_rank, axes))
        check_structure(tree["state"], state,
                        f"{resume_ckpt.directory} step {step}")
        state = cp.to_device(tree["state"], device)
        start_epoch = meta.get("epoch", 0)
        best_val_acc = meta.get("best_val_acc", -1.0)
        if plateau is not None:
            plateau.best = meta.get("plateau_best", plateau.best)
            plateau.lr = meta.get("plateau_lr", plateau.lr)
            plateau.bad_epochs = meta.get("plateau_bad_epochs",
                                          plateau.bad_epochs)
            set_learning_rate(opt, plateau.lr)
        if ckpt.best_step() is not None:
            best_tree = ckpt.restore(step=ckpt.best_step())[0]
        print(f"[train] resumed from epoch {start_epoch} (step {step})")

    timer = StepTimer()
    for epoch in range(start_epoch, train_cfg.num_epochs):
        generator = rank_generator(
            epoch_generator(train_cfg.seed, epoch, device), mesh)
        # metrics stay on the device until the epoch ends: one sync
        timer.reset()
        sums = None
        n = 0
        batches = train_batcher.train_epochs(epoch=epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            timer.data_tick(time.perf_counter() - t0)
            if batch is None:
                break
            state, m = train_step(params, state,
                                  batch_to_device(batch, device), generator)
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
            n += 1
            step += 1
            timer.tick(items=train_cfg.batch_size)
        rates = timer.rates(device)   # train only: before the eval
        acc = (mean_over_ranks(sums, mesh) if sums is not None
               else {"loss": 0.0, "accuracy": 0.0})

        val = evaluate(eval_step, params, state, val_batcher, device, mesh)
        if plateau is not None:
            lr = plateau.step(val["loss"])
            set_learning_rate(opt, lr)
        else:
            lr = train_cfg.optimizer.learning_rate
        row = {
            "epoch": epoch + 1,
            "train/loss": acc["loss"] / max(n, 1),
            "train/accuracy": acc["accuracy"] / max(n, 1),
            "val/loss": val["loss"],
            "val/accuracy": val["accuracy"],
            "lr": lr,
            "clips_per_sec": rates.get("items_per_sec", 0.0),
            "data_wait_s": rates.get("data_wait_s", 0.0),
        }
        history.append(row)
        log.log(row, step=step)

        if val["accuracy"] > best_val_acc:
            best_val_acc = val["accuracy"]
            # one host copy, shared with the checkpoint write below
            best_tree = {"params": host_copy(whole(params)),
                         "state": host_copy(state)}
            if ckpt is not None and writer:
                ckpt.save(step, best_tree,
                          metadata={"model_cfg": model_cfg.to_json(),
                                    "mel_cfg": mel_cfg.to_json(),
                                    "epoch": epoch + 1,
                                    "val_accuracy": val["accuracy"]},
                          best_metric=val["accuracy"])
        if resume_ckpt is not None:
            resume = {"params": whole(params), "state": state,
                      "opt_state": opt.full_state_dict()}
        if resume_ckpt is not None and writer:
            resume_ckpt.save(
                step, resume,
                metadata={"epoch": epoch + 1, "best_val_acc": best_val_acc,
                          **({"plateau_best": plateau.best,
                              "plateau_lr": plateau.lr,
                              "plateau_bad_epochs": plateau.bad_epochs}
                             if plateau is not None else {})})

    log.finish()
    if best_tree is None:   # no epoch improved (e.g. none ran)
        best_tree = {"params": host_copy(whole(params)),
                     "state": host_copy(state)}
    return {"params": whole(params), "state": state, "optimizer": opt,
            "best_params": best_tree["params"],
            "best_state": best_tree["state"],
            "history": history, "best_val_accuracy": best_val_acc}
