"""One process of the port's tensor-parallel test run (not collected by
pytest: no test_ prefix). `run(out_dir, mesh)` builds the mesh named by
`mesh` ("one": no group; "model2": model:2; "data2model2": data:2 x
model:2), cuts the parameter tree the test saved in <out_dir>/params.pt
to this rank's shards and saves to <out_dir>/<mesh>_rank<r>.pt what it
computed:

  mesh       (data size, data rank, model size, model rank)
  shards     this rank's leaves, by path
  forward    forward_train's logits (its vocab shard gathered) and emotion
             logits on its data rows, and the shard's width
  decode     per case, tokens and lengths of `generate` on its data rows:
             "greedy" (penalty 1.15, 3-gram ban), "ts" (the same,
             timestamped), "int4" (timestamped, int4 cross K/V) and
             "fallback" (timestamped, every row re-decoded at temperature
             0.7) and "xla" (int8 cross K/V, step_attn and logits_impl
             "xla"), each beside this process's one-process decode of the
             same rows ("<case>_one"); and `generate_beam`'s outputs
             (3 beams, the same processors) for "beam" (kv_quant none),
             "beam_int8", "beam_ts" (timestamped) and "beam_int4"
             (timestamped, int4), with the ranks' choices compared every
             step (`check_ranks`)
  ce         the dual loss of forward_train on its data rows, its targets
             at the vocab shards' edges and on the pad id, through the
             vocab-parallel cross-entropy and through the gathered logits:
             each route's loss and whole gradients
  classifier the classifier (tests/torch_dp_worker.py's CLS, dropout 0.1)
             on this rank's shards (`us.param_axes`): its eval-mode logits
             on its data rows, and one TP train step with dropout (the
             mean loss over the ranks, the whole gradients and this rank's
             copy of every whole leaf after the step)
  step       one TP dual-loss train step (tests/torch_dp_worker.py's
             whisper case, grad clip 0.5): the mean loss over the ranks,
             the clip's norm, the gathered gradients and updated
             parameters, and this rank's copy of every whole leaf
  drift      on a model axis, two TP train steps of each trainer
             (whisper's dual loss, grad clip 0.5; the classifier with
             dropout) with a hook on model rank 1 that moves a whole
             leaf's gradient (the first convolution's weight) one ulp up,
             standing in for cuDNN's unordered weight gradients on the
             card: this rank's copy of every whole leaf, their Adam
             moments, the classifier's BatchNorm state, and the hook's
             call count
  trainers   one epoch of `train_whisper_emotion` (writing under
             <out_dir>/<mesh>/whisper), a second run there to 2 epochs
             (resuming from the first's checkpoint), one epoch of
             `train_classifier`, and one of `train_classifier(
             tensor_parallel=True)` with a checkpoint directory and a
             second run there to 2 epochs: their histories, and the
             last run's returned params

Alone (mesh "one") it is the one-process run. See
tests/test_torch_tensor_parallel.py.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

import torch_dp_worker as dpw
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.data.loader import Batcher
from audio_transformers_tpu_torch.models.urbansound import model as us
from audio_transformers_tpu_torch.models.whisper import beam as wbeam
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
    # the reference's XLA arithmetic (int8 quantizes q and p) and logits
    "xla": DecodeConfig(max_new_tokens=10, kv_quant="int8", step_attn="xla",
                        logits_impl="xla", **CHAIN),
}
BEAMS = {
    "beam": DecodeConfig(max_new_tokens=10, num_beams=3, **CHAIN),
    "beam_int8": DecodeConfig(max_new_tokens=10, num_beams=3,
                              kv_quant="int8", **CHAIN),
    "beam_ts": DecodeConfig(max_new_tokens=10, num_beams=3,
                            return_timestamps=True, **CHAIN),
    "beam_int4": DecodeConfig(max_new_tokens=10, num_beams=3,
                              kv_quant="int4", return_timestamps=True,
                              **CHAIN),
}
BEAM_KEYS = ("tokens", "lengths", "beam_tokens", "beam_scores",
             "beam_lengths", "hiddens")
CLIP = 0.5
# CE targets at the vocab shards' edges (t = 2: 26112 ids a shard, the
# second's real run ending at 51864) and the pad id
EDGE_IDS = (0, 26111, 26112, 51864, 50257, 13055, 13056, 39168)
CLS_MEL = (4, 44, 64)     # (B, frames, n_mels) of the classifier's forward


def inputs():
    """(mel (BATCH, 128, 80) float32, decoder ids (BATCH, 7)), seeded."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((BATCH, 2 * WHISPER.max_source_positions,
                               WHISPER.n_mels)).astype(np.float32)
    ids = rng.integers(0, WHISPER.vocab_size, (BATCH, 7))
    return mel, ids


def ce_labels() -> np.ndarray:
    """(BATCH, 8) labels whose targets (columns 1:) are the decoder ids'
    shifted ones, with the shard-edge ids and the pad id set in."""
    _, ids = inputs()
    labels = np.concatenate([ids, ids[:, :1]], axis=1)
    flat = labels[:, 1:].reshape(-1)
    flat[::3][:len(EDGE_IDS)] = EDGE_IDS
    labels[:, 1:] = flat.reshape(BATCH, 7)
    return labels


def cls_mel() -> np.ndarray:
    return np.random.default_rng(3).standard_normal(CLS_MEL).astype(
        np.float32)


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
        for name, dcfg in BEAMS.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # int4's warning
                got = wbeam.generate_beam(shards["whisper"], WHISPER, dcfg,
                                          enc, model_group=group,
                                          check_ranks=True)
                one = wbeam.generate_beam(whole["whisper"], WHISPER, dcfg,
                                          enc_one)
            out[name] = {k: got[k].clone() for k in BEAM_KEYS}
            out[name + "_one"] = {k: one[k].clone() for k in BEAM_KEYS}
    return out


def ce_routes(shards: dict, axes: dict, mesh, rows: slice) -> dict:
    """The dual loss on this rank's rows (no data group: each data rank's
    own token mean) through `dual_loss(model_group=)` and through the
    gathered logits: each route's loss and whole gradients."""
    group = mesh.model_group
    mel, ids = (torch.from_numpy(x[rows]) for x in inputs())
    labels = torch.from_numpy(ce_labels()[rows])
    emo_labels = torch.arange(BATCH)[rows] % CFG.num_emotion_classes
    out = {}
    for route in ("parallel", "gathered"):
        params = cp.set_trainable(cp.map_tensors(
            shards, lambda t: t.detach().clone()))
        logits, emo_logits = emo.forward_train(params, CFG, mel, ids,
                                               model_group=group)
        kw = dict(pad_token_id=WHISPER.pad_token_id, emotion_weight=0.5)
        if route == "parallel":
            kw.update(model_group=group, vocab_size=WHISPER.vocab_size)
        else:
            logits = tp.gather_vocab(logits, group, WHISPER.vocab_size)
        loss = tw.dual_loss(logits, emo_logits, labels, emo_labels, **kw)
        loss["loss"].backward()
        grads = cp.map_tensors(params, lambda t: (
            t.grad if t.grad is not None else torch.zeros_like(t)))
        whole = (tp.gather_params(grads, group, axes) if group is not None
                 else grads)
        out[route] = {"loss": loss["loss"].item(),
                      "transcription": loss["transcription_loss"].item(),
                      "grads": _host(whole)}
    return out


def classifier(mesh) -> dict:
    """The classifier on this rank's shards: eval-mode logits on its
    data rows of `cls_mel()`, then one TP train step with dropout."""
    cfg = dpw.CLS
    params, state = us.init(cfg, torch.Generator().manual_seed(1))
    axes = us.param_axes(params, cfg, mesh.model_size)
    group = mesh.model_group
    params = cp.set_trainable(
        tp.shard_params(params, mesh.model_size, mesh.model_rank, axes),
        frozen=())
    per = CLS_MEL[0] // mesh.size
    mel = torch.from_numpy(cls_mel()[mesh.rank * per:(mesh.rank + 1) * per])
    with torch.no_grad():
        logits, _ = us.apply(params, state, cfg, mel, training=False,
                             model_group=group)
    tcfg = dpw.cls_tcfg()
    opt = optim.build_optimizer(tcfg.optimizer, params, model_group=group,
                                axes=axes if group is not None else None)
    step, _ = tc.make_steps(cfg, dpw.MEL_CLS, tcfg, opt, mesh,
                            tensor_parallel=True)
    batcher = Batcher(dpw.cls_source(), dpw.CLS_BATCH, dpw.CLS_BATCH)
    host = next(batcher.train_epochs(epoch=0))
    state, m = step(params, state, common.batch_to_device(host, "cpu"),
                    common.rank_generator(torch.Generator().manual_seed(3),
                                          mesh))
    grads = cp.map_tensors(params, lambda t: (
        t.grad if t.grad is not None else torch.zeros_like(t)))
    splits = (tp.split_leaves(axes) if group is not None
              else [None] * len(cp.leaves_with_path(params)))
    return {"logits": logits.clone(), "rows": host["label"].shape[0],
            "loss": common.mean_over_ranks(m, mesh)["loss"],
            "grads": _host(tp.gather_params(grads, group, axes)
                           if group is not None else grads),
            "state": _host(state),
            "whole_leaves": {p: t.detach().clone() for (p, t), s in
                             zip(cp.leaves_with_path(params), splits)
                             if s is None}}


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


def _one_ulp(mesh, leaf: torch.Tensor) -> list:
    """On model rank 1, a hook that moves every element of `leaf`'s
    gradient one ulp up; returns the list the hook appends a 1 to at each
    call."""
    calls = []

    def up(g):
        calls.append(1)
        return torch.nextafter(g, torch.full_like(g, float("inf")))
    if mesh.model_rank == 1:
        leaf.register_hook(up)
    return calls


def _whole_state(params, axes, opt, state=None) -> dict:
    """Every whole leaf, its Adam moments, and `state`, by key."""
    out = {}
    for (path, t), s in zip(cp.leaves_with_path(params),
                            tp.split_leaves(axes)):
        if s is None:
            out[("leaf",) + path] = t.detach().clone()
            for k, v in opt.opt.state.get(t, {}).items():
                out[(k,) + path] = v.clone()
    for path, t in cp.leaves_with_path(state or {}):
        out[("state",) + path] = t.clone()
    return out


def drift(mesh) -> dict:
    """Two TP steps of each trainer with `_one_ulp` on the first
    convolution's weight (see the module note)."""
    out = {}
    full = cp.init(dpw.WHISPER, torch.Generator().manual_seed(0))
    axes = emo.param_axes(full, dpw.WHISPER, mesh.model_size)
    params = cp.set_trainable(tp.shard_params(full, mesh.model_size,
                                              mesh.model_rank, axes))
    tcfg = dpw.wh_tcfg()
    tcfg = tcfg.replace(optimizer=tcfg.optimizer.replace(
        grad_clip_norm=CLIP))
    opt = optim.build_optimizer(tcfg.optimizer, params,
                                decay_mask=optim.frozen_leaf_decay_mask,
                                model_group=mesh.model_group, axes=axes)
    calls = _one_ulp(mesh, params["whisper"]["encoder"]["conv1"]["w"])
    step, _ = tw.make_steps(dpw.WHISPER, dpw.MEL_WH, tcfg, opt, "cpu", mesh)
    batches = Batcher(dpw.RaggedLabels(2 * dpw.WH_BATCH, 1),
                      2 * dpw.WH_BATCH, dpw.WH_BATCH).train_epochs(epoch=0)
    for host in batches:
        step(params, common.batch_to_device(host, "cpu"))
    out["whisper"] = _whole_state(params, axes, opt)
    out["whisper_calls"] = len(calls)

    cfg = dpw.CLS
    params, state = us.init(cfg, torch.Generator().manual_seed(1))
    axes = us.param_axes(params, cfg, mesh.model_size)
    params = cp.set_trainable(
        tp.shard_params(params, mesh.model_size, mesh.model_rank, axes),
        frozen=())
    tcfg = dpw.cls_tcfg()
    opt = optim.build_optimizer(tcfg.optimizer, params,
                                model_group=mesh.model_group, axes=axes)
    calls = _one_ulp(mesh, params["conv1"]["w"])
    step, _ = tc.make_steps(cfg, dpw.MEL_CLS, tcfg, opt, mesh,
                            tensor_parallel=True)
    gen = common.rank_generator(torch.Generator().manual_seed(3), mesh)
    batches = Batcher(dpw.cls_source(2 * dpw.CLS_BATCH),
                      2 * dpw.CLS_BATCH, dpw.CLS_BATCH).train_epochs(epoch=0)
    for host in batches:
        state, _ = step(params, state, common.batch_to_device(host, "cpu"),
                        gen)
    out["classifier"] = _whole_state(params, axes, opt, state)
    out["classifier_calls"] = len(calls)
    return out


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
    # the classifier cut over the model axis, its checkpoints the whole
    # tree (a resume run to 2 epochs cuts them again)
    ckpt = os.path.join(out_dir, "classifier_tp", "ckpt")
    cls_tp = [tc.train_classifier(
        dpw.CLS, dpw.MEL_CLS, dpw.cls_tcfg(mesh_shape=mesh_shape,
                                           checkpoint_dir=ckpt).replace(
                                               num_epochs=epochs),
        Batcher(dpw.cls_source(16), 16, dpw.CLS_BATCH),
        Batcher(dpw.cls_source(11, seed=2), 11, dpw.CLS_BATCH),
        device="cpu", tensor_parallel=True) for epochs in (1, 2)]
    return {"whisper": wh["history"], "classifier": cls["history"],
            "whisper_params": _host(wh["params"]),
            "whisper_resumed": resumed["history"],
            "classifier_tp": [r["history"] for r in cls_tp],
            "classifier_tp_params": _host(cls_tp[-1]["params"])}


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
    width = logits.shape[-1]
    logits = tp.gather_vocab(logits, mesh.model_group, WHISPER.vocab_size)
    out = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank),
           "shards": _host(shards), "rows": (rows.start, rows.stop),
           "forward": (logits, emo_logits), "forward_width": width,
           "decode": decodes(whole, shards, mesh, rows),
           "ce": ce_routes(shards, axes, mesh, rows),
           "classifier": classifier(mesh),
           "step": train_step(mesh),
           "drift": drift(mesh) if mesh.model_group is not None else None}
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
