"""Dual-loss whisper-emotion fine-tuning (transcription CE + emotion CE).

The reference's `audio_transformers_tpu/train/whisper_emotion.py` on
PyTorch: teacher-forced shifted cross-entropy with the pad id ignored plus
a weighted emotion cross-entropy over the mean-pooled decoder states, AdamW
with linear warmup and decay, best-by-val-loss snapshots, the reference's
metric names and the style_to_id.txt label map. Parameters are float32
masters; activations run in `compute_dtype` (bfloat16 by default), with
the mel front end inside the step. On a CUDA device the step runs the
log-mel kernel and, with attn_impl "flash" ("auto" on CUDA), the flash
attention kernels forward and backward.

Loss masking is the reference's: `mask_mode="pad"` ignores every target
equal to the pad id (whisper's pad is <|endoftext|>, so EOS is not
supervised either); "keep_first_eos" supervises the first pad/EOS per row.

With an output directory a run keeps the reference's two checkpoint
directories (`core/checkpoint.py`): checkpoints/ holds the best epochs by
val loss (params and the metadata `from_checkpoint` reads) and resume/
the last epoch's full state (params, optimizer moments, the schedule's
position), from which a rerun with the same output directory resumes.

With `spec_augment` the mel features are masked after the cast
(`ops/specaugment.py`), the masks drawn from one generator per epoch
seeded from (seed + 1, epoch) (`epoch_generator`), as the reference folds
the epoch into the key of seed + 1; the draws are not `jax.random`'s.
With `remat` the encoder and decoder blocks recompute their activations
in the backward (`models/whisper/model.py`).

Data parallelism (`parallel/`): in a process group, `mesh_shape`'s
"data" axis spans the ranks. Each rank takes its rows of every global
batch (`data.loader.Batcher`), the parameters start from rank
0's, the transcription loss divides by the global token count (see
`dual_loss`), the gradients are averaged before AdamW clips and steps,
SpecAugment's masks are drawn for the global batch and sliced
(`common.rank_generator`), and the eval sums and train metrics are
reduced over the ranks; rank 0 alone writes.

Tensor parallelism: with a "model" axis over 1 in `mesh_shape`, each
model rank holds its shards of the parameters (`emotion.param_axes`,
`parallel/tensor.py`) and the optimizer moments of its shards; the step
runs the sharded forward, which leaves each rank its vocab shard of the
logits, and the cross-entropies of the train and eval steps run over the
shards (`parallel.tensor.vocab_parallel_cross_entropy`: three
all-reduces of one float a token, no gathered B x T x V logits); the
gradients are averaged over the data axis only, the whole leaves'
gradients are the model group's first rank's (`optim.Optimizer.
reconcile`: one broadcast a step), and the clip's norm is the whole
tree's. The checkpoints hold
the whole tree (gathered on every rank, written by rank 0), so their
format and a resume do not depend on the mesh.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from audio_transformers_tpu_torch.core.config import (
    EmotionWhisperConfig, MelConfig, TrainConfig)
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.checkpoint import (Checkpointer,
                                                          save_label_map)
from audio_transformers_tpu_torch.core.params import resolve_device
from audio_transformers_tpu_torch.core.metrics import StepTimer
from audio_transformers_tpu_torch.models.whisper import emotion as emo
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
from audio_transformers_tpu_torch.train.optim import (build_optimizer,
                                                      frozen_leaf_decay_mask)

def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        model_group=None,
                        vocab_size: Optional[int] = None) -> torch.Tensor:
    """(B, T) float32 cross-entropy of each target id under logits
    (B, T, V); under a model group the logits are this rank's vocab shard
    of a `vocab_size`-id vocabulary (`parallel.tensor.vocab_shard`) and
    the cross-entropy runs over the shards."""
    if model_group is None:
        return F.cross_entropy(logits.float().transpose(1, 2), targets,
                               reduction="none")
    v0, _, _ = tp.vocab_shard(vocab_size, tp.model_size(model_group),
                              tp.model_rank(model_group))
    return tp.vocab_parallel_cross_entropy(logits, targets, model_group, v0,
                                           vocab_size)


def dual_loss(logits: torch.Tensor, emotion_logits: torch.Tensor,
              labels: torch.Tensor, emotion_labels: torch.Tensor, *,
              pad_token_id: int, emotion_weight: float,
              mask_mode: str = "pad", group=None, model_group=None,
              vocab_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """labels (B, T+1) are full sequences: teacher forcing feeds
    labels[:, :-1] and targets labels[:, 1:]; `logits` (B, T, V) belong to
    the shifted inputs. Cross-entropies run on float32 logits; with a
    `model_group` the logits are this rank's vocab shard of a
    `vocab_size`-id vocabulary (`token_cross_entropy`).

    With a process `group` of R ranks, each holding its rows of the
    global batch, the transcription loss is the reference's token mean
    over the global batch: this rank's token sum over N / R, N the
    global token count (all-reduced, not differentiated). Averaging the
    ranks' losses, or their gradients, then gives the global batch's,
    however the tokens fall on the ranks; each rank's own token mean
    would not."""
    targets = labels[:, 1:].long()
    mask = targets != pad_token_id
    if mask_mode == "keep_first_eos":
        prev_real = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]],
                              dim=1)
        mask = mask | (prev_real & ~mask)
    elif mask_mode != "pad":
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    per_tok = token_cross_entropy(logits, targets, model_group, vocab_size)
    m = mask.float()
    if group is None:
        count = m.sum().clamp_min(1.0)
    else:
        count = m.sum().detach()
        dist.all_reduce(count, group=group)
        count = count.clamp_min(1.0) / dist.get_world_size(group)
    transcription = (per_tok * m).sum() / count
    emotion = F.cross_entropy(emotion_logits.float(), emotion_labels.long())
    acc = (emotion_logits.argmax(dim=-1) == emotion_labels).float().mean()
    return {"loss": transcription + emotion_weight * emotion,
            "transcription_loss": transcription, "emotion_loss": emotion,
            "emotion_accuracy": acc}


def make_steps(cfg: EmotionWhisperConfig, mel_cfg: MelConfig,
               train_cfg: TrainConfig, opt, device, mesh: Mesh = Mesh(1, 0)):
    """(train_step, eval_step) over the parameter tree they are given.

    train_step(params, batch, generator=None) updates the parameters in
    place through `opt` and returns the step's metrics as device scalars;
    with spec_augment, `generator` (on `device`) draws the step's masks,
    and without one nothing is masked; eval_step
    returns masked sums weighted by `valid`, so wrap-padded rows of the
    last eval batch count for nothing.

    attn_impl "auto" trains with the flash kernels on CUDA and with plain
    attention on the CPU; eval runs plain attention unless attn_impl names
    one (the reference resolves eval's "auto" to XLA). train_cfg.remat
    recomputes the blocks' activations in the backward of train_step.

    On a `mesh` of several ranks (`parallel.mesh`), train_step takes
    this rank's rows, a `nn.RowShard` generator, and averages the
    gradients over the ranks before the optimizer steps; its metrics are
    this rank's share (`common.mean_over_ranks` averages them). With a
    model axis the parameters are this rank's shards (`emo.param_axes`)
    and `opt` is built over them with the model group and the axes.

    With the recorder on (`core/tracing.py`), a train step is a
    `train.step` span around `train.forward` (`log_mel`, `encode`),
    `train.loss`, `train.backward` (remat's `block.recompute` spans),
    `train.grad_average` on several ranks and `train.optimizer` (CUDA
    events on the card)."""
    device = torch.device(device)
    compute_dtype = DTYPES[train_cfg.compute_dtype]
    pad = cfg.whisper.pad_token_id
    attn_impl = train_cfg.attn_impl
    if attn_impl == "auto":
        attn_impl = "flash" if device.type == "cuda" else "xla"
    eval_attn = train_cfg.attn_impl if train_cfg.attn_impl != "auto" \
        else "xla"
    mel_precision = "high" if compute_dtype == torch.bfloat16 else "highest"

    def forward(params, batch, attn, generator=None, remat=False):
        with tracing.span("log_mel"):
            mel = log_mel(batch["waveform"], mel_cfg,
                          precision=mel_precision).to(compute_dtype)
        if train_cfg.spec_augment and generator is not None:
            mel = sa.spec_augment(generator, mel)
        return emo.forward_train(params, cfg, mel, batch["labels"][:, :-1],
                                 remat=remat, attn_impl=attn,
                                 model_group=mesh.model_group)

    @tracing.spanned("train.step")
    def train_step(params, batch, generator=None):
        with tracing.span("train.forward"):
            logits, emotion_logits = forward(params, batch, attn_impl,
                                             generator, train_cfg.remat)
        with tracing.span("train.loss"):
            out = dual_loss(logits, emotion_logits, batch["labels"],
                            batch["emotion_labels"], pad_token_id=pad,
                            emotion_weight=train_cfg.emotion_weight,
                            group=mesh.group, model_group=mesh.model_group,
                            vocab_size=cfg.whisper.vocab_size)
        opt.zero_grad()
        with tracing.span("train.backward"):
            out["loss"].backward()
        if mesh.group is not None:
            with tracing.span("train.grad_average"):
                average_gradients(opt.params, mesh)
        with tracing.span("train.optimizer", device=device):
            opt.step()
        return {k: v.detach() for k, v in out.items()}

    @torch.no_grad()
    def eval_step(params, batch):
        logits, emotion_logits = forward(params, batch, eval_attn)
        targets = batch["labels"][:, 1:]
        valid = batch["valid"].float()
        tok_mask = (targets != pad).float() * valid[:, None]
        per_tok = token_cross_entropy(logits, targets, mesh.model_group,
                                      cfg.whisper.vocab_size)
        per_emo = F.cross_entropy(emotion_logits.float(),
                                  batch["emotion_labels"], reduction="none")
        correct = (emotion_logits.argmax(dim=-1)
                   == batch["emotion_labels"]).float()
        return {"transcription_sum": (per_tok * tok_mask).sum(),
                "token_count": tok_mask.sum(),
                "emotion_sum": (per_emo * valid).sum(),
                "correct": (correct * valid).sum(),
                "count": valid.sum()}

    return train_step, eval_step


def evaluate(eval_step, params, batcher, device, *,
             emotion_weight: float = 0.5,
             mesh: Mesh = Mesh(1, 0)) -> Dict[str, float]:
    """The eval metrics over every valid row; on a mesh of several ranks
    each rank evaluates its rows and the sums are reduced over them."""
    keys = ("transcription_sum", "token_count", "emotion_sum", "correct",
            "count")
    totals = torch.zeros(len(keys), dtype=torch.float64, device=device)
    for batch in batcher.eval_batches():
        out = eval_step(params, batch_to_device(batch, device))
        totals += torch.stack([out[k].double() for k in keys])
    sums = dict(zip(keys, all_reduce_sum(totals, mesh).tolist()))
    transcription = sums["transcription_sum"] / max(sums["token_count"], 1.0)
    emotion = sums["emotion_sum"] / max(sums["count"], 1.0)
    return {"loss": transcription + emotion_weight * emotion,
            "transcription_loss": transcription,
            "emotion_loss": emotion,
            "emotion_accuracy": sums["correct"] / max(sums["count"], 1.0)}


def train_whisper_emotion(cfg: EmotionWhisperConfig, mel_cfg: MelConfig,
                          train_cfg: TrainConfig, train_batcher, val_batcher,
                          *, device="cuda", init_params: Optional[dict] = None,
                          style_to_idx: Optional[dict] = None,
                          output_dir: Optional[str] = None,
                          wandb_project: Optional[str] = None) -> dict:
    """Trains for train_cfg.num_epochs epochs on `device` ("cuda" raises
    when no CUDA device is present) and evaluates after each one.

    `init_params` is a port parameter tree (e.g. `core.params.
    from_jax_params` of a JAX tree, or `models/whisper/load.py`'s); None
    initialises from train_cfg.seed. With `output_dir`, metrics go to
    <output_dir>/metrics.jsonl, the label map to style_to_id.txt, the
    best epochs to checkpoints/ and the last epoch's full state to
    resume/; when resume/ holds a step, training resumes from it at the
    next epoch (a run that has nothing left to train returns the best
    checkpoint's params). Returns {"params", "best_params" (a host
    snapshot of the best-by-val-loss epoch), "optimizer", "history" (this
    run's epochs), "best_val_loss"}.

    In a process group (`parallel.distributed`) this runs on every rank,
    each with its own device and batchers
    (`build_mesh(train_cfg.mesh_shape)` must cover the group)."""
    device = resolve_device(device)
    mesh = build_mesh(train_cfg.mesh_shape)
    writer = mesh.writer
    total_steps = train_batcher.steps_per_epoch * train_cfg.num_epochs
    if init_params is None:
        init_params = emo.init(cfg, torch.Generator().manual_seed(
            train_cfg.seed))
    axes = (emo.param_axes(init_params, cfg, mesh.model_size)
            if mesh.model_group is not None else None)
    params = cp.map_tensors(
        init_params, lambda t: t.detach().to(device, torch.float32).clone())
    if axes is not None:
        params = tp.shard_params(params, mesh.model_size, mesh.model_rank,
                                 axes)
    params = cp.set_trainable(replicated(params, mesh))
    opt = build_optimizer(train_cfg.optimizer, params,
                          total_steps=total_steps,
                          decay_mask=frozen_leaf_decay_mask,
                          model_group=mesh.model_group, axes=axes)

    def whole(tree):   # the whole tree, on every model rank
        return (tp.gather_params(tree, mesh.model_group, axes)
                if axes is not None else tree)
    train_step, eval_step = make_steps(cfg, mel_cfg, train_cfg, opt, device,
                                       mesh)

    ckpt = resume_ckpt = None
    if output_dir:
        if writer:
            os.makedirs(output_dir, exist_ok=True)
            if style_to_idx:
                save_label_map(os.path.join(output_dir, "style_to_id.txt"),
                               style_to_idx)
        ckpt = Checkpointer(os.path.join(output_dir, "checkpoints"),
                            max_to_keep=train_cfg.keep_checkpoints,
                            best_mode="min")
        resume_ckpt = Checkpointer(os.path.join(output_dir, "resume"),
                                   max_to_keep=1)
    log = metric_logger(
        mesh, log_dir=output_dir, wandb_project=wandb_project,
        config={"cfg": cfg.to_json(), "train": train_cfg.to_json()})

    best_val_loss = float("inf")
    best_params = None
    history = []
    step = 0
    start_epoch = 0
    if resume_ckpt is not None and resume_ckpt.latest_step() is not None:
        _, meta, step = restore_into(
            params, opt, resume_ckpt,
            shard=None if axes is None else lambda tree: tp.shard_params(
                tree, mesh.model_size, mesh.model_rank, axes))
        start_epoch = meta.get("epoch", 0)
        best_val_loss = meta.get("best_val_loss", float("inf"))
        if ckpt.best_step() is not None:
            best_params = ckpt.restore(step=ckpt.best_step())[0]["params"]
        print(f"[train] resumed from epoch {start_epoch} (step {step})")

    timer = StepTimer()
    for epoch in range(start_epoch, train_cfg.num_epochs):
        # metrics stay on the device until the epoch ends: one sync, not
        # one per step
        timer.reset()
        sums = None
        n = 0
        generator = (rank_generator(epoch_generator(train_cfg.seed + 1,
                                                    epoch, device), mesh)
                     if train_cfg.spec_augment else None)
        batches = train_batcher.train_epochs(epoch=epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            timer.data_tick(time.perf_counter() - t0)
            if batch is None:
                break
            m = train_step(params, batch_to_device(batch, device), generator)
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
            n += 1
            step += 1
            timer.tick(items=train_cfg.batch_size)

        rates = timer.rates(device)
        acc = mean_over_ranks(sums, mesh) if sums is not None else {}
        val = evaluate(eval_step, params, val_batcher, device,
                       emotion_weight=train_cfg.emotion_weight, mesh=mesh)
        row = {
            "epoch": epoch + 1,
            **{f"train/{k}": v / max(n, 1) for k, v in acc.items()},
            **{f"val/{k}": v for k, v in val.items()},
            "clips_per_sec": rates.get("items_per_sec", 0.0),
            "data_wait_s": rates.get("data_wait_s", 0.0),
        }
        history.append(row)
        log.log(row, step=step)
        if val["loss"] < best_val_loss:
            best_val_loss = val["loss"]
            best_params = host_copy(whole(params))
            if ckpt is not None and writer:
                ckpt.save(step, {"params": best_params},
                          metadata={"cfg": cfg.to_json(),
                                    "mel_cfg": mel_cfg.to_json(),
                                    "epoch": epoch + 1,
                                    "val_loss": val["loss"],
                                    "style_to_idx": style_to_idx},
                          best_metric=val["loss"])
        if resume_ckpt is not None:
            state = {"params": whole(params),
                     "opt_state": opt.full_state_dict()}
        if resume_ckpt is not None and writer:
            resume_ckpt.save(step, state,
                             metadata={"epoch": epoch + 1,
                                       "best_val_loss": best_val_loss})

    log.finish()
    if best_params is None:   # no epoch improved (e.g. none ran)
        best_params = host_copy(whole(params))
    return {"params": whole(params), "best_params": best_params,
            "optimizer": opt,
            "history": history, "best_val_loss": best_val_loss}
