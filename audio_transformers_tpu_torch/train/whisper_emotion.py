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

Not ported yet, and raising NotImplementedError: SpecAugment (the
reference draws its masks from jax.random; it needs its own slice),
activation checkpointing (remat), and checkpoint/resume directories (they
wait for the torch checkpoint bundle, ROADMAP queue item 9), so a run
keeps its best parameters as a host snapshot only.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                MelConfig, TrainConfig)
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.metrics import MetricLogger, StepTimer
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.ops.mel import log_mel
from audio_transformers_tpu_torch.train.optim import (build_optimizer,
                                                      frozen_leaf_decay_mask)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dual_loss(logits: torch.Tensor, emotion_logits: torch.Tensor,
              labels: torch.Tensor, emotion_labels: torch.Tensor, *,
              pad_token_id: int, emotion_weight: float,
              mask_mode: str = "pad") -> Dict[str, torch.Tensor]:
    """labels (B, T+1) are full sequences: teacher forcing feeds
    labels[:, :-1] and targets labels[:, 1:]; `logits` (B, T, V) belong to
    the shifted inputs. Cross-entropies run on float32 logits."""
    targets = labels[:, 1:].long()
    mask = targets != pad_token_id
    if mask_mode == "keep_first_eos":
        prev_real = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]],
                              dim=1)
        mask = mask | (prev_real & ~mask)
    elif mask_mode != "pad":
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    per_tok = F.cross_entropy(logits.float().transpose(1, 2), targets,
                              reduction="none")
    m = mask.float()
    transcription = (per_tok * m).sum() / m.sum().clamp_min(1.0)
    emotion = F.cross_entropy(emotion_logits.float(), emotion_labels.long())
    acc = (emotion_logits.argmax(dim=-1) == emotion_labels).float().mean()
    return {"loss": transcription + emotion_weight * emotion,
            "transcription_loss": transcription, "emotion_loss": emotion,
            "emotion_accuracy": acc}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device "
                           "is present (pass device='cpu' to train on the "
                           "CPU)")
    return device


def batch_to_device(batch: Dict[str, np.ndarray], device) -> dict:
    """A host batch (numpy) -> tensors on `device`; ids become int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def make_steps(cfg: EmotionWhisperConfig, mel_cfg: MelConfig,
               train_cfg: TrainConfig, opt, device):
    """(train_step, eval_step) over the parameter tree they are given.

    train_step(params, batch) updates the parameters in place through
    `opt` and returns the step's metrics as device scalars; eval_step
    returns masked sums weighted by `valid`, so wrap-padded rows of the
    last eval batch count for nothing.

    attn_impl "auto" trains with the flash kernels on CUDA and with plain
    attention on the CPU; eval runs plain attention unless attn_impl names
    one (the reference resolves eval's "auto" to XLA)."""
    if train_cfg.spec_augment:
        raise NotImplementedError("spec_augment is not ported yet")
    if train_cfg.remat:
        raise NotImplementedError("remat is not ported yet")
    device = torch.device(device)
    compute_dtype = _DTYPES[train_cfg.compute_dtype]
    pad = cfg.whisper.pad_token_id
    attn_impl = train_cfg.attn_impl
    if attn_impl == "auto":
        attn_impl = "flash" if device.type == "cuda" else "xla"
    eval_attn = train_cfg.attn_impl if train_cfg.attn_impl != "auto" \
        else "xla"
    mel_precision = "high" if compute_dtype == torch.bfloat16 else "highest"

    def forward(params, batch, attn):
        mel = log_mel(batch["waveform"], mel_cfg,
                      precision=mel_precision).to(compute_dtype)
        return emo.forward_train(params, cfg, mel, batch["labels"][:, :-1],
                                 attn_impl=attn)

    def train_step(params, batch):
        logits, emotion_logits = forward(params, batch, attn_impl)
        out = dual_loss(logits, emotion_logits, batch["labels"],
                        batch["emotion_labels"], pad_token_id=pad,
                        emotion_weight=train_cfg.emotion_weight)
        opt.zero_grad()
        out["loss"].backward()
        opt.step()
        return {k: v.detach() for k, v in out.items()}

    @torch.no_grad()
    def eval_step(params, batch):
        logits, emotion_logits = forward(params, batch, eval_attn)
        targets = batch["labels"][:, 1:]
        valid = batch["valid"].float()
        tok_mask = (targets != pad).float() * valid[:, None]
        per_tok = F.cross_entropy(logits.float().transpose(1, 2), targets,
                                  reduction="none")
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
             emotion_weight: float = 0.5) -> Dict[str, float]:
    keys = ("transcription_sum", "token_count", "emotion_sum", "correct",
            "count")
    totals = None
    for batch in batcher.eval_batches():
        out = eval_step(params, batch_to_device(batch, device))
        vec = torch.stack([out[k].double() for k in keys])
        totals = vec if totals is None else totals + vec
    sums = dict(zip(keys, totals.tolist() if totals is not None
                    else [0.0] * len(keys)))
    transcription = sums["transcription_sum"] / max(sums["token_count"], 1.0)
    emotion = sums["emotion_sum"] / max(sums["count"], 1.0)
    return {"loss": transcription + emotion_weight * emotion,
            "transcription_loss": transcription,
            "emotion_loss": emotion,
            "emotion_accuracy": sums["correct"] / max(sums["count"], 1.0)}


def save_label_map(path: str, label_to_idx: dict) -> None:
    """The reference-format label map: one "style: idx" line per label."""
    with open(path, "w") as f:
        for name, idx in label_to_idx.items():
            f.write(f"{name}: {idx}\n")


def _host_copy(params):
    return cp.map_tensors(params, lambda t: t.detach().cpu().clone())


def train_whisper_emotion(cfg: EmotionWhisperConfig, mel_cfg: MelConfig,
                          train_cfg: TrainConfig, train_batcher, val_batcher,
                          *, device="cuda", init_params: Optional[dict] = None,
                          style_to_idx: Optional[dict] = None,
                          output_dir: Optional[str] = None,
                          wandb_project: Optional[str] = None) -> dict:
    """Trains for train_cfg.num_epochs epochs on `device` ("cuda" raises
    when no CUDA device is present) and evaluates after each one.

    `init_params` is a port parameter tree (e.g. `core.params.
    from_jax_params` of a JAX tree); None initialises from train_cfg.seed.
    With `output_dir`, metrics go to <output_dir>/metrics.jsonl and the
    label map to style_to_id.txt. Returns {"params", "best_params" (a host
    snapshot of the best-by-val-loss epoch), "optimizer", "history",
    "best_val_loss"}."""
    device = resolve_device(device)
    total_steps = train_batcher.steps_per_epoch * train_cfg.num_epochs
    if init_params is None:
        init_params = emo.init(cfg, torch.Generator().manual_seed(
            train_cfg.seed))
    params = cp.set_trainable(cp.map_tensors(
        init_params, lambda t: t.detach().to(device, torch.float32).clone()))
    opt = build_optimizer(train_cfg.optimizer, params,
                          total_steps=total_steps,
                          decay_mask=frozen_leaf_decay_mask)
    train_step, eval_step = make_steps(cfg, mel_cfg, train_cfg, opt, device)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        if style_to_idx:
            save_label_map(os.path.join(output_dir, "style_to_id.txt"),
                           style_to_idx)
    log = MetricLogger(
        log_dir=output_dir, wandb_project=wandb_project,
        config={"cfg": cfg.to_json(), "train": train_cfg.to_json()})

    best_val_loss = float("inf")
    best_params = None
    history = []
    step = 0
    timer = StepTimer()
    for epoch in range(train_cfg.num_epochs):
        # metrics stay on the device until the epoch ends: one sync, not
        # one per step
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
            m = train_step(params, batch_to_device(batch, device))
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
            n += 1
            step += 1
            timer.tick(items=train_cfg.batch_size)

        rates = timer.rates(device)
        acc = ({k: v.item() for k, v in sums.items()} if sums is not None
               else {})
        val = evaluate(eval_step, params, val_batcher, device,
                       emotion_weight=train_cfg.emotion_weight)
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
            best_params = _host_copy(params)

    log.finish()
    if best_params is None:   # no epoch ran
        best_params = _host_copy(params)
    return {"params": params, "best_params": best_params, "optimizer": opt,
            "history": history, "best_val_loss": best_val_loss}
