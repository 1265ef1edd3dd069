"""One process of the port's tensor-parallel test run (not collected by
pytest: no test_ prefix). `run(out_dir, mesh)` builds the mesh named by
`mesh` ("one": no group; "model2": model:2; "data2model2": data:2 x
model:2), cuts the parameter tree the test saved in <out_dir>/params.pt
to this rank's shards and saves to <out_dir>/<mesh>_rank<r>.pt what it
computed:

  mesh       (data size, data rank, model size, model rank)
  shards     this rank's leaves, by path
  forward    forward_train's logits and emotion logits on its data rows
  decode     per case, tokens and lengths of `generate` on its data rows:
             "greedy" (penalty 1.15, 3-gram ban), "ts" (the same,
             timestamped), "int4" (timestamped, int4 cross K/V) and
             "fallback" (timestamped, every row re-decoded at temperature
             0.7), each beside this process's one-process decode of the
             same rows ("<case>_one")
  step       one TP dual-loss train step (tests/torch_dp_worker.py's
             whisper case, grad clip 0.5): the mean loss over the ranks,
             the clip's norm, the gathered gradients and updated
             parameters, and this rank's copy of every whole leaf
  trainers   one epoch of `train_whisper_emotion` (writing under
             <out_dir>/<mesh>/whisper), a second run there to 2 epochs
             (resuming from the first's checkpoint) and one epoch of
             `train_classifier`, their histories

Alone (mesh "one") it is the one-process run. See
tests/test_torch_tensor_parallel.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import torch_dp_worker as dpw
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.data.loader import Batcher
from audio_transformers_tpu_torch.models.whisper import decode as wdecode
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.parallel import distributed
from audio_transformers_tpu_torch.parallel import tensor as tp
from audio_transformers_tpu_torch.parallel.mesh import build_mesh
from audio_transformers_tpu_torch.train import classifier as tc
from audio_transformers_tpu_torch.train import common, optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

# the test widths (d 64, 2 heads, ffn 128) with whisper's vocabulary and
# special ids, so that the vocab shards cut the padded 52224 ids and
# timestamps exist
_TINY = WhisperConfig()
WHISPER = WhisperConfig.test().replace(
    vocab_size=_TINY.vocab_size, pad_token_id=_TINY.pad_token_id,
    bos_token_id=_TINY.bos_token_id, eos_token_id=_TINY.eos_token_id,
    decoder_start_token_id=_TINY.decoder_start_token_id,
    no_timestamps_token_id=_TINY.no_timestamps_token_id,
    timestamp_begin_id=_TINY.timestamp_begin_id,
    lang_en_token_id=_TINY.lang_en_token_id,
    transcribe_token_id=_TINY.transcribe_token_id)
CFG = EmotionWhisperConfig(whisper=WHISPER, num_emotion_classes=4)
MESHES = {"one": (("data", -1),),
          "model2": (("data", -1), ("model", 2)),
          "data2model2": (("data", 2), ("model", 2))}
BATCH = 4
CHAIN = dict(repetition_penalty=1.15, no_repeat_ngram_size=3)
DECODES = {
    "greedy": DecodeConfig(max_new_tokens=10, **CHAIN),
    "ts": DecodeConfig(max_new_tokens=10, return_timestamps=True, **CHAIN),
    "int4": DecodeConfig(max_new_tokens=10, return_timestamps=True,
                         kv_quant="int4", **CHAIN),
    "fallback": DecodeConfig(max_new_tokens=10, return_timestamps=True,
                             compression_ratio_threshold=1e-6, **CHAIN),
}
CLIP = 0.5


def inputs():
    """(mel (BATCH, 128, 80) float32, decoder ids (BATCH, 7)), seeded."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((BATCH, 2 * WHISPER.max_source_positions,
                               WHISPER.n_mels)).astype(np.float32)
    ids = rng.integers(0, WHISPER.vocab_size, (BATCH, 7))
    return mel, ids


def _host(tree) -> dict:
    return {path: t.detach().cpu().clone()
            for path, t in cp.leaves_with_path(tree)}


def decodes(whole: dict, shards: dict, mesh, rows: slice) -> dict:
    mel = torch.from_numpy(inputs()[0][rows])
    group = mesh.model_group
    out = {}
    with torch.no_grad():
        enc = wm.encode(shards["whisper"], WHISPER, mel, model_group=group)
        enc_one = wm.encode(whole["whisper"], WHISPER, mel)
        for name, dcfg in DECODES.items():
            for key, params, e, g in ((name, shards, enc, group),
                                      (name + "_one", whole, enc_one, None)):
                got = wdecode.generate_with_fallback(
                    params["whisper"], WHISPER, dcfg, e, model_group=g)
                out[key] = {k: got[k].clone() for k in ("tokens", "lengths")}
    return out


def train_step(mesh) -> dict:
    """One dual-loss step of tests/torch_dp_worker.py's whisper case on
    the global batch (this rank's data rows, its model shards)."""
    full = cp.init(dpw.WHISPER, torch.Generator().manual_seed(0))
    axes = (emo.param_axes(full, dpw.WHISPER, mesh.model_size)
            if mesh.model_group is not None else None)
    params = (tp.shard_params(full, mesh.model_size, mesh.model_rank, axes)
              if axes is not None else full)
    params = cp.set_trainable(params)
    tcfg = dpw.wh_tcfg()
    tcfg = tcfg.replace(optimizer=tcfg.optimizer.replace(
        grad_clip_norm=CLIP))
    opt = optim.build_optimizer(tcfg.optimizer, params,
                                decay_mask=optim.frozen_leaf_decay_mask,
                                model_group=mesh.model_group, axes=axes)
    norms = []
    grad_norm = opt.grad_norm
    opt.grad_norm = lambda: norms.append(grad_norm()) or norms[-1]
    step, _ = tw.make_steps(dpw.WHISPER, dpw.MEL_WH, tcfg, opt, "cpu", mesh)
    batcher = Batcher(dpw.RaggedLabels(dpw.WH_BATCH, 1), dpw.WH_BATCH,
                      dpw.WH_BATCH)
    host = next(batcher.train_epochs(epoch=0))
    m = step(params, common.batch_to_device(host, "cpu"))

    def whole(tree):
        return (tp.gather_params(tree, mesh.model_group, axes)
                if axes is not None else tree)
    grad_tree = cp.map_tensors(params, lambda t: (
        t.grad if t.grad is not None else torch.zeros_like(t)))
    splits = (tp.split_leaves(axes) if axes is not None
              else [None] * len(cp.leaves_with_path(params)))
    return {"loss": common.mean_over_ranks(m, mesh)["loss"],
            "norm": float(norms[0]), "rows": host["labels"].shape[0],
            "params": _host(whole(params)),
            "grads": {p: g for p, g in _host(whole(grad_tree)).items()
                      if p not in cp.FROZEN},
            "whole_leaves": {p: t.detach().clone() for (p, t), s in
                             zip(cp.leaves_with_path(params), splits)
                             if s is None}}


def trainers(mesh_shape, out_dir) -> dict:
    wh = tw.train_whisper_emotion(
        dpw.WHISPER, dpw.MEL_WH, dpw.wh_tcfg(mesh_shape=mesh_shape),
        Batcher(dpw.RaggedLabels(8, 1), 8, dpw.WH_BATCH),
        Batcher(dpw.RaggedLabels(5, 2), 5, dpw.WH_BATCH),
        device="cpu", output_dir=os.path.join(out_dir, "whisper"))
    # a second run on the same directory resumes from the first's
    # checkpoint (the whole tree, cut again to this rank's shards)
    resumed = tw.train_whisper_emotion(
        dpw.WHISPER, dpw.MEL_WH,
        dpw.wh_tcfg(mesh_shape=mesh_shape).replace(num_epochs=2),
        Batcher(dpw.RaggedLabels(8, 1), 8, dpw.WH_BATCH),
        Batcher(dpw.RaggedLabels(5, 2), 5, dpw.WH_BATCH),
        device="cpu", output_dir=os.path.join(out_dir, "whisper"))
    cls = tc.train_classifier(
        dpw.CLS, dpw.MEL_CLS, dpw.cls_tcfg(mesh_shape=mesh_shape),
        Batcher(dpw.cls_source(16), 16, dpw.CLS_BATCH),
        Batcher(dpw.cls_source(11, seed=2), 11, dpw.CLS_BATCH),
        device="cpu", log_dir=os.path.join(out_dir, "classifier"))
    return {"whisper": wh["history"], "classifier": cls["history"],
            "whisper_params": _host(wh["params"]),
            "whisper_resumed": resumed["history"]}


def run(out_dir: str, mesh_name: str) -> None:
    distributed.initialize_if_multihost(device="cpu")
    mesh = build_mesh(MESHES[mesh_name])
    torch.manual_seed(0)
    whole = torch.load(os.path.join(out_dir, "params.pt"))
    axes = emo.param_axes(whole, CFG, mesh.model_size)
    shards = tp.shard_params(whole, mesh.model_size, mesh.model_rank, axes)
    per = BATCH // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    mel, ids = (torch.from_numpy(x[rows]) for x in inputs())
    with torch.no_grad():
        logits, emo_logits = emo.forward_train(
            shards, CFG, mel, ids, model_group=mesh.model_group)
    out = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank),
           "shards": _host(shards), "rows": (rows.start, rows.stop),
           "forward": (logits, emo_logits),
           "decode": decodes(whole, shards, mesh, rows),
           "step": train_step(mesh)}
    out["trainers"] = trainers(MESHES[mesh_name],
                               os.path.join(out_dir, mesh_name))
    rank = distributed.process_index()
    torch.save(out, os.path.join(out_dir, f"{mesh_name}_rank{rank}.pt"))


def whisper_trainer(out_dir: str, mesh_name: str) -> None:
    """One epoch of `train_whisper_emotion` on the mesh `mesh_name`; rank
    0 saves its history to <out_dir>/<mesh>_history.pt."""
    distributed.initialize_if_multihost(device="cpu")
    wh = tw.train_whisper_emotion(
        dpw.WHISPER, dpw.MEL_WH, dpw.wh_tcfg(mesh_shape=MESHES[mesh_name]),
        Batcher(dpw.RaggedLabels(8, 1), 8, dpw.WH_BATCH),
        Batcher(dpw.RaggedLabels(5, 2), 5, dpw.WH_BATCH), device="cpu")
    if distributed.process_index() == 0:
        torch.save(wh["history"], os.path.join(out_dir,
                                               f"{mesh_name}_history.pt"))
