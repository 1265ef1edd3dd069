"""One process of the port's data-parallel test run (not collected by
pytest: no test_ prefix). `run(out_dir)` takes one step of each trainer
in each of the cases below, at small widths in float32, and saves what
the step computed to <out_dir>/rank<r>.pt. Alone it is the one-process
run on the global batch; under `parallel.launch` each process joins the
group from the launcher's variables and takes its rows of every global
batch through `Batcher`. See tests/test_torch_parallel.py.

Cases:
  cls_drop   the classifier with BatchNorm, dropout 0.1 and SpecAugment
  cls_plain  the classifier with BatchNorm, no draws (held to JAX)
  wh_sa      whisper, SpecAugment, label lengths that give the ranks
             unequal token counts
  wh_plain   whisper, the same labels, no draws (held to JAX)
and, before each step, the trainer's `evaluate` over a wrap-padded last
batch; then one epoch of each trainer function with an output
directory.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (EmotionWhisperConfig,
                                                      MelConfig,
                                                      OptimizerConfig,
                                                      TrainConfig,
                                                      UrbanSoundConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.data.loader import Batcher
from audio_transformers_tpu_torch.data.synthetic import (
    SyntheticClassification, SyntheticSeq2Seq)
from audio_transformers_tpu_torch.models.urbansound import model as us
from audio_transformers_tpu_torch.parallel import distributed
from audio_transformers_tpu_torch.parallel.mesh import build_mesh
from audio_transformers_tpu_torch.train import classifier as tc
from audio_transformers_tpu_torch.train import common
from audio_transformers_tpu_torch.train import optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

CLS = UrbanSoundConfig(n_mels=64, num_classes=4, conv_dim=24,
                       encoder_dim=24, num_encoder_blocks=1, num_heads=2,
                       dropout=0.1, cnn_dims=(24,))
WHISPER = EmotionWhisperConfig(
    whisper=WhisperConfig.test().replace(encoder_layers=1, decoder_layers=1),
    num_emotion_classes=4)
MEL_CLS, MEL_WH = MelConfig.urbansound(), MelConfig.whisper()
CLS_BATCH, WH_BATCH = 8, 4
# supervised tokens per sample: every split of 4 samples into two pairs
# gives the pairs different totals
LABEL_LENGTHS = (1, 2, 3, 7)
LR = 1e-3


def cls_tcfg(**kw):
    return TrainConfig(batch_size=CLS_BATCH, num_epochs=1,
                       compute_dtype="float32",
                       optimizer=OptimizerConfig(name="adam",
                                                 learning_rate=LR,
                                                 schedule="constant"),
                       **kw)


def wh_tcfg(**kw):
    return TrainConfig(batch_size=WH_BATCH, num_epochs=1,
                       compute_dtype="float32",
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=LR,
                                                 weight_decay=0.01,
                                                 schedule="constant"),
                       **kw)


def cls_source(n=CLS_BATCH, seed=1):
    return SyntheticClassification(num_samples=n, num_classes=4,
                                   duration=1.0, seed=seed)


class RaggedLabels:
    """SyntheticSeq2Seq's samples with sample i's labels cut to
    LABEL_LENGTHS[i % 4] supervised tokens (then the pad id)."""

    def __init__(self, n: int, seed: int):
        w = WHISPER.whisper
        dur = 2 * w.max_source_positions * MEL_WH.hop_length \
            / MEL_WH.sample_rate
        self.base = SyntheticSeq2Seq(
            num_samples=n, num_classes=4, vocab_size=w.vocab_size,
            max_label_len=9, duration=dur, seed=seed,
            bos_id=w.decoder_start_token_id, eos_id=w.eos_token_id,
            pad_id=w.pad_token_id)
        self.num_samples = n

    def __call__(self, i: int) -> dict:
        s = dict(self.base(i))
        labels = s["labels"].copy()
        labels[1:] = np.where(labels[1:] == WHISPER.whisper.pad_token_id,
                              2, labels[1:])      # no pad before the cut
        labels[1 + LABEL_LENGTHS[i % 4]:] = WHISPER.whisper.pad_token_id
        s["labels"] = labels
        return s


def _grads(params) -> dict:
    return {path: t.grad.detach().cpu().clone()
            for path, t in cp.leaves_with_path(params) if t.grad is not None}


def _host(tree) -> dict:
    return {path: t.detach().cpu().clone()
            for path, t in cp.leaves_with_path(tree)}


def _generator(seed, mesh, device):
    return common.rank_generator(
        torch.Generator(device=device).manual_seed(seed), mesh)


def classifier_step(mesh, cfg, tcfg, gen_seed, device):
    params, state = cp.to_device(us.init(cfg, torch.Generator().manual_seed(
        0)), device)
    params = cp.set_trainable(params, frozen=())
    opt = optim.build_optimizer(tcfg.optimizer, params)
    train_step, eval_step = tc.make_steps(cfg, MEL_CLS, tcfg, opt, mesh)
    val = Batcher(cls_source(11, seed=2), 11, CLS_BATCH)
    metrics = tc.evaluate(eval_step, params, state, val, device, mesh)
    batcher = Batcher(cls_source(), CLS_BATCH, CLS_BATCH)
    host = next(batcher.train_epochs(epoch=0))
    state, m = train_step(params, state, common.batch_to_device(host, device),
                          _generator(gen_seed, mesh, device))
    return {"host": host, "loss": common.mean_over_ranks(m, mesh)["loss"],
            "grads": _grads(params), "state": _host(state), "eval": metrics}


def whisper_step(mesh, tcfg, gen_seed, device):
    params = cp.set_trainable(cp.to_device(cp.init(
        WHISPER, torch.Generator().manual_seed(0)), device))
    opt = optim.build_optimizer(tcfg.optimizer, params,
                                decay_mask=optim.frozen_leaf_decay_mask)
    train_step, eval_step = tw.make_steps(WHISPER, MEL_WH, tcfg, opt, device,
                                          mesh)
    val = Batcher(RaggedLabels(5, 2), 5, WH_BATCH)
    metrics = tw.evaluate(eval_step, params, val, device, mesh=mesh)
    batcher = Batcher(RaggedLabels(WH_BATCH, 1), WH_BATCH, WH_BATCH)
    host = next(batcher.train_epochs(epoch=0))
    m = train_step(params, common.batch_to_device(host, device),
                   _generator(gen_seed, mesh, device))
    tokens = int((host["labels"][:, 1:] != WHISPER.whisper.pad_token_id)
                 .sum())
    return {"host": host, "loss": common.mean_over_ranks(m, mesh)["loss"],
            "grads": _grads(params), "tokens": tokens, "eval": metrics}


def trainers(mesh, out_dir, device):
    """One epoch of each trainer function, writing under out_dir."""
    cls = tc.train_classifier(
        CLS, MEL_CLS, cls_tcfg(spec_augment=True),
        Batcher(cls_source(16), 16, CLS_BATCH),
        Batcher(cls_source(11, seed=2), 11, CLS_BATCH),
        device=device, log_dir=os.path.join(out_dir, "classifier"))
    wh = tw.train_whisper_emotion(
        WHISPER, MEL_WH, wh_tcfg(spec_augment=True),
        Batcher(RaggedLabels(8, 1), 8, WH_BATCH),
        Batcher(RaggedLabels(5, 2), 5, WH_BATCH),
        device=device, output_dir=os.path.join(out_dir, "whisper"),
        style_to_idx={"a": 0, "b": 1, "c": 2, "d": 3})
    return {"classifier": cls["history"], "whisper": wh["history"]}


def run(out_dir: str, device: str = "cpu",
        backend: Optional[str] = None) -> None:
    """Every case on `device`; in a group, over `backend` (gloo on the
    CPU and, for several ranks on one card, on CUDA too). On CUDA each
    case also records the kernels' launches and the plain versions'
    calls on CUDA tensors."""
    # the float32 comparisons hold the convolutions to float32 (no TF32);
    # the caller's setting comes back at the end
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _run(out_dir, device, backend)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _run(out_dir: str, device: str, backend: Optional[str]) -> None:
    from audio_transformers_tpu_torch.ops import _build

    distributed.initialize_if_multihost(device=device, backend=backend)
    mesh = build_mesh()
    device = str(distributed.process_device(device))
    out = {"world": mesh.size, "device": device}
    cases = {
        "cls_drop": lambda: classifier_step(
            mesh, CLS, cls_tcfg(spec_augment=True), 11, device),
        "cls_plain": lambda: classifier_step(
            mesh, CLS.replace(dropout=0.0), cls_tcfg(), 12, device),
        "wh_sa": lambda: whisper_step(mesh, wh_tcfg(spec_augment=True), 13,
                                      device),
        "wh_plain": lambda: whisper_step(mesh, wh_tcfg(), 14, device),
    }
    for name, case in cases.items():
        _build.reset_stats()
        out[name] = case()
        out[name]["launches"] = {k: (s.launches, s.plain_cuda_calls)
                                 for k, s in _build.STATS.items()}
    out["trainers"] = trainers(mesh, out_dir, device)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def hold(one: dict, ranks: list) -> dict:
    """Holds a run of several ranks (`ranks`: each rank's saved results)
    to one process's run on the whole batch (`one`), with the CPU tests'
    tolerances: loss 1e-5 relative, gradients 1e-4 * max(1, max |g|) per
    leaf, BatchNorm state 1e-6, eval metrics 1e-6 relative, one epoch's
    history 1e-3 relative; every rank's gradients and state bit-equal to
    rank 0's; unequal token counts over the ranks in the whisper cases.
    Raises AssertionError at the first miss; returns per case the loss's
    relative error and the largest gradient error's share of its
    tolerance."""
    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    r0 = ranks[0]
    check(one["world"] == 1 and r0["world"] == len(ranks) > 1, "worlds")
    worst = {}
    for case in ("cls_drop", "cls_plain", "wh_sa", "wh_plain"):
        want, got = one[case], r0[case]
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        check(loss_rel <= 1e-5, f"{case}: loss {got['loss']} against "
              f"{want['loss']}")
        share = 0.0
        for path, g in want["grads"].items():
            err = float((got["grads"][path] - g).abs().max())
            share = max(share, err / (1e-4 * max(1.0, float(g.abs().max()))))
            for r in ranks[1:]:
                check(torch.equal(r[case]["grads"][path], got["grads"][path]),
                      f"{case}: the ranks' gradients differ at {path}")
        check(share <= 1.0, f"{case}: gradients at {share:.3f} of their "
              "tolerance")
        for path, t in want.get("state", {}).items():
            check(float((got["state"][path] - t).abs().max()) <= 1e-6,
                  f"{case}: BatchNorm state {path}")
            for r in ranks[1:]:
                check(torch.equal(r[case]["state"][path],
                                  got["state"][path]),
                      f"{case}: the ranks' BatchNorm state differs")
        for k, v in want["eval"].items():
            check(abs(got["eval"][k] - v) <= 1e-6 * abs(v),
                  f"{case}: eval {k} {got['eval'][k]} against {v}")
        if case.startswith("wh"):
            tokens = [r[case]["tokens"] for r in ranks]
            check(len(set(tokens)) > 1 and sum(tokens) == want["tokens"],
                  f"{case}: token counts over the ranks {tokens}")
        worst[case] = {"loss_rel": loss_rel, "grad_share_of_tol": share}
    for trainer in ("classifier", "whisper"):
        for k, v in one["trainers"][trainer][0].items():
            if k not in ("clips_per_sec", "data_wait_s"):
                got = r0["trainers"][trainer][0][k]
                check(abs(got - v) <= 1e-3 * abs(v),
                      f"{trainer} epoch: {k} {got} against {v}")
    return worst


def fail_on_rank_1(sleep_s: float = 600.0) -> None:
    """Rank 1 exits with 3 at once; the others sleep until killed."""
    if os.environ["ATX_PROCESS_ID"] == "1":
        sys.exit(3)
    time.sleep(sleep_s)
