#!/usr/bin/env python3
"""Tensor parallelism over the cards of one host.

    python3 scripts/tp_multicard.py [--device cpu]

1. whisper-tiny (6 heads, seeded random weights, bf16 and float32) on a
   `model:2` mesh (2 cards) and on `data:2 x model:2` (4 cards): the
   greedy timestamped decode of 12 s clips (one a data rank), each rank
   on its heads, hidden units and vocab shard (K1 on its heads, K2 in its
   vocab-shard mode, one all-gather of the row partials a step), held to
   one card's decode of the same clips (`hold_decode`: float32 token for
   token; bf16 token for token up to the first position whose one-card
   margin lies under the bound that the hidden states' measured
   difference allows). Every rank must launch K1, K2's shard mode and
   K3, and K1 is held to its plain version at this rank's B * H / t rows.
   Printed per mesh: ms per decode step on the mesh and on one card, the
   collectives per step (all-reduces: 1 + 3 x decoder layers; all-gathers:
   1) and their time, by the host clock around each with the card
   synchronised, and its share of a step so timed.
2. whisper-base (8 heads, random weights) on `model:4`: the decode check.
3. one TP train step (whisper-tiny, batch 2, float32, flash attention)
   on `model:2` and `data:2 x model:2`: its loss within 1e-6 relative of
   one card's step on the same batch; then a second step with its
   collectives counted and timed as above, and a third for ms per step
   on the mesh and on one card.

Each mesh runs in N processes over NCCL, process r on card r
(`parallel.launch`). With --device cpu the same runs in gloo processes on
the CPU at the test widths (d 64, ffn 128; 2 heads, 4 for the model:4
case) with whisper's vocabulary, a rehearsal of the paths (float32 only,
no kernels, no device time). chip_smoke.py's phase 30 runs `run_mesh`
(the decodes untimed, and the train step) with two gloo ranks on one
card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from audio_transformers_tpu_torch.core import params as cp  # noqa: E402
from audio_transformers_tpu_torch.core.config import (  # noqa: E402
    DecodeConfig, EmotionWhisperConfig, MelConfig, OptimizerConfig,
    TrainConfig, WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import decode as wdecode  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import emotion as emo  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import model as wm  # noqa: E402,E501
from audio_transformers_tpu_torch.ops import _build  # noqa: E402
from audio_transformers_tpu_torch.ops import decode_attention as da  # noqa: E402,E501
from audio_transformers_tpu_torch.ops import decode_logits as dl  # noqa: E402,E501
from audio_transformers_tpu_torch.ops.mel import log_mel  # noqa: E402
from audio_transformers_tpu_torch.parallel import distributed  # noqa: E402
from audio_transformers_tpu_torch.parallel import tensor as tp  # noqa: E402
from audio_transformers_tpu_torch.parallel.launch import launch  # noqa: E402,E501
from audio_transformers_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, build_mesh)

MESHES = {"model2": (("data", -1), ("model", 2)),
          "data2model2": (("data", 2), ("model", 2)),
          "model4": (("data", -1), ("model", 4))}
DCFG = DecodeConfig(max_new_tokens=48, return_timestamps=True,
                    repetition_penalty=1.15, no_repeat_ngram_size=3)
CLIP_S = 12.0
K1_TOL_BF16 = 2e-2
# the bf16 rule: a logit of row b moves by at most |dh| * max_v |e_v| (the
# hidden states' measured difference times the largest embedding row, by
# Cauchy-Schwarz), times the repetition penalty (a seen logit is
# multiplied by it); a token may change only where the one-card margin is
# under twice that, plus the float32 sums' slack
MARGIN_SLACK = 1e-3


def whisper_cfg(size: str, device: str) -> WhisperConfig:
    """whisper-tiny or -base on the card; on the CPU the test widths with
    whisper's vocabulary and special ids (4 heads for "base", so that a
    model axis of 4 splits them)."""
    full = WhisperConfig() if size == "tiny" else WhisperConfig.base()
    if not device.startswith("cpu"):
        return full
    return WhisperConfig.test().replace(
        vocab_size=full.vocab_size, pad_token_id=full.pad_token_id,
        bos_token_id=full.bos_token_id, eos_token_id=full.eos_token_id,
        decoder_start_token_id=full.decoder_start_token_id,
        no_timestamps_token_id=full.no_timestamps_token_id,
        timestamp_begin_id=full.timestamp_begin_id,
        lang_en_token_id=full.lang_en_token_id,
        transcribe_token_id=full.transcribe_token_id,
        num_heads=2 if size == "tiny" else 4)


def clips(n: int, cfg: WhisperConfig, device, dtype) -> torch.Tensor:
    """n seeded 12 s clips (sines and noise), zero-padded to the encoder's
    window, as log-mel features (K3 on the card) in `dtype`."""
    mel_cfg = MelConfig.whisper()
    window = 2 * cfg.max_source_positions * mel_cfg.hop_length
    rng = np.random.default_rng(30)
    t = np.arange(int(CLIP_S * mel_cfg.sample_rate)) / mel_cfg.sample_rate
    wav = np.zeros((n, window), np.float32)
    for i in range(n):
        x = (0.5 * np.sin(2 * math.pi * (220 + 110 * i) * t)
             + 0.05 * rng.standard_normal(len(t)))[:window]
        wav[i, :len(x)] = x
    return log_mel(torch.from_numpy(wav).to(device), mel_cfg).to(dtype)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def counted_collectives(device, timed: bool):
    """Counts (and with `timed`, times by the host clock with the card
    synchronised before and after) every all_reduce and all_gather the
    block makes; yields the {"all_reduce": [n, s], "all_gather": [n, s]}
    it fills."""
    rec = {"all_reduce": [0, 0.0], "all_gather": [0, 0.0]}
    saved = {name: getattr(dist, name) for name in rec}

    def wrap(name):
        def call(*a, **kw):
            if timed:
                _sync(device)
            t0 = time.perf_counter()
            out = saved[name](*a, **kw)
            if timed:
                _sync(device)
            rec[name][0] += 1
            rec[name][1] += time.perf_counter() - t0
            return out
        return call
    for name in rec:
        setattr(dist, name, wrap(name))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _k1_rows(b, heads, dev, dtype) -> float:
    """K1 against its plain version at this rank's b * heads rows (hd 64,
    1500 keys): the largest difference."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((b, heads, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, heads, 64, 1500), generator=g,
                        device=dev).to(dtype) for _ in range(2))
    got = da.decode_cross_attention(q, k, v, scale=0.125)
    want = da.decode_cross_attention_reference(q, k, v, scale=0.125)
    return float((got.float() - want.float()).abs().max())


def _dtype(name):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def rank_main(out_dir: str, mesh_name: str, size: str, dtypes: list,
              device: str = "cuda", backend=None, timed: bool = True,
              train: bool = False) -> None:
    """One rank of a mesh: the TP decode in each of `dtypes` (its data
    rank's clip on its shards; with `timed`, run twice more to time a
    step and its collectives), then with `train` the TP train step.
    Saves <out_dir>/decode_<mesh>_<size>_<dtype>_rank<r>.pt and
    <out_dir>/train_<mesh>_rank<r>.pt."""
    distributed.initialize_if_multihost(device=device, backend=backend)
    torch.backends.cudnn.allow_tf32 = False   # float32 convolutions exact
    mesh = build_mesh(MESHES[mesh_name])
    for dtype in dtypes:
        decode_rank(out_dir, mesh, mesh_name, size, dtype, device, timed)
    if train:
        train_rank(out_dir, mesh, mesh_name, device)


def decode_rank(out_dir, mesh, mesh_name, size, dtype, device,
                timed) -> None:
    dev = distributed.process_device(device)
    cfg = whisper_cfg(size, str(dev))
    dt = _dtype(dtype)
    full = cp.init(EmotionWhisperConfig(whisper=cfg),
                   torch.Generator().manual_seed(0))
    axes = emo.param_axes(full, EmotionWhisperConfig(whisper=cfg),
                          mesh.model_size)
    shards = cp.to_device(tp.shard_params(
        full, mesh.model_size, mesh.model_rank, axes), dev)["whisper"]
    group = mesh.model_group
    _build.reset_stats()
    mel = clips(mesh.size, cfg, dev, dt)[mesh.rank:mesh.rank + 1]
    with torch.no_grad():
        enc = wm.encode(shards, cfg, mel, model_group=group)

    def run():
        with torch.no_grad():
            return wdecode.generate(shards, cfg, DCFG, enc,
                                    model_group=group)
    out = run()
    launches = {k: (s.launches, s.plain_cuda_calls)
                for k, s in _build.STATS.items()}
    wall = timed_wall = None
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall = time.perf_counter() - t0
    with counted_collectives(dev, timed=timed) as rec:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        timed_wall = time.perf_counter() - t0
    # decoder steps run: every position up to the first EOS, or all of
    # them (the loop's last token is fed once more)
    res = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank),
           "tokens": out["tokens"].cpu(), "lengths": out["lengths"].cpu(),
           "hiddens": out["hiddens"].float().cpu(), "launches": launches,
           "wall_s": wall, "timed_wall_s": timed_wall,
           "positions": int(out["lengths"].max()), "collectives": rec,
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu"}
    if dev.type == "cuda":
        res["k1_rows"] = {b: _k1_rows(b, cfg.num_heads // mesh.model_size,
                                      dev, dt) for b in (1, 4)}
    rank = distributed.process_index()
    torch.save(res, os.path.join(
        out_dir, f"decode_{mesh_name}_{size}_{dtype}_rank{rank}.pt"))


class MarginSpy:
    """Stands in for `dl.fused_greedy_step` during one card's decode: the
    kernel picks the token; the plain version's processed logits give
    each row's margin (the top-two gap in the region the token comes
    from, and in timestamp mode also the probability rule's), one (B,)
    tensor a generated position."""

    def __init__(self):
        self.fn = dl.fused_greedy_step
        self.margins = []

    def __call__(self, hidden, table_t, add, **kw):
        l = dl.processed_logits(hidden, table_t, add, **{
            k: v for k, v in kw.items() if k not in ("vocab_offset",
                                                     "partials")})

        def gap(x):
            top = x.topk(2, dim=-1).values
            return top[:, 0] - top[:, 1]
        m = gap(l)
        tb = kw.get("timestamp_begin")
        if kw.get("ts_bounds") is not None:
            rule = torch.logsumexp(l[:, tb:], -1) - l[:, :tb].amax(-1)
            region = torch.where(rule > 0, gap(l[:, tb:]), gap(l))
            m = torch.minimum(rule.abs(), region)
        self.margins.append(m.float().cpu())
        return self.fn(hidden, table_t, add, **kw)


def one_card_decode(size: str, dtype: str, n_clips: int, device: str,
                    timed: bool = True) -> dict:
    """The same decode on one card (no group) with every position's
    margins (with `timed`, once more to time it); also the largest
    embedding row's norm."""
    dev = torch.device(device)
    cfg = whisper_cfg(size, str(dev))
    full = cp.to_device(cp.init(EmotionWhisperConfig(whisper=cfg),
                                torch.Generator().manual_seed(0)),
                        dev)["whisper"]
    mel = clips(n_clips, cfg, dev, _dtype(dtype))
    spy = MarginSpy()
    with torch.no_grad():
        enc = wm.encode(full, cfg, mel)
        dl.fused_greedy_step = spy
        try:
            out = wdecode.generate(full, cfg, DCFG, enc)
        finally:
            dl.fused_greedy_step = spy.fn
        wall = None
        if timed:
            _sync(dev)
            t0 = time.perf_counter()
            wdecode.generate(full, cfg, DCFG, enc)
            _sync(dev)
            wall = time.perf_counter() - t0
    table = full["decoder"]["embed"]["table"].to(_dtype(dtype)).float()
    return {"tokens": out["tokens"].cpu(), "lengths": out["lengths"].cpu(),
            "hiddens": out["hiddens"].float().cpu(),
            "margins": spy.margins, "wall_s": wall,
            "emb_norm": float(table.norm(dim=1).max()),
            "prompt_len": len(wdecode.build_prompt(cfg, DCFG))}


def hold_decode(one: dict, ranks: list, dtype: str) -> dict:
    """Holds each rank's tokens to one card's decode of its clip: float32
    token for token; bf16 token for token up to the first position where
    they differ, where the one-card margin must lie under 2 * penalty *
    |dh| * max|e_v| + MARGIN_SLACK (dh: the two runs' final hidden states
    at the position before, where the inputs were still the same). The
    model ranks of a data rank must hold the same tokens. Returns
    {"rows_equal", "first_divergence", "bound_at_divergence",
    "margin_at_divergence"} per data row."""
    p_len = one["prompt_len"]
    rows = {}
    for r in ranks:
        d_rank = r["mesh"][1]
        peer = ranks[d_rank * r["mesh"][2]]
        if not torch.equal(r["tokens"], peer["tokens"]):
            raise AssertionError("the model ranks of a data rank hold "
                                 "different tokens")
        want = one["tokens"][d_rank]
        got = r["tokens"][0]
        diff = (got != want).nonzero()
        row = {"rows_equal": not len(diff)}
        if len(diff):
            pos = int(diff[0])
            if dtype == "float32":
                raise AssertionError(f"float32 TP decode differs from one "
                                     f"card at position {pos}")
            dh = float((r["hiddens"][0, pos - 1]
                        - one["hiddens"][d_rank, pos - 1]).norm())
            bound = 2 * DCFG.repetition_penalty * dh * one["emb_norm"] \
                + MARGIN_SLACK
            margin = float(one["margins"][pos - p_len][d_rank])
            row.update(first_divergence=pos, bound_at_divergence=bound,
                       margin_at_divergence=margin)
            if margin > bound:
                raise AssertionError(
                    f"bf16 TP decode differs at position {pos} where the "
                    f"one-card margin {margin:.3g} exceeds the bound "
                    f"{bound:.3g} (|dh| {dh:.3g})")
        rows[d_rank] = row
    return rows


def train_rank(out_dir: str, mesh: Mesh, mesh_name: str,
               device: str = "cuda") -> None:
    """One rank of the TP train step (on one process with no group where
    `mesh_name` is "one"): whisper-tiny (the test widths on the CPU),
    batch 2 over the data axis, float32, flash attention on the card.
    Saves its mean loss and launches to <out_dir>/train_<mesh>_rank<r>.pt."""
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.train import common, optim
    from audio_transformers_tpu_torch.train import whisper_emotion as tw

    dev = distributed.process_device(device)
    cfg = EmotionWhisperConfig(whisper=whisper_cfg("tiny", str(dev)),
                               num_emotion_classes=4)
    w = cfg.whisper
    mel_cfg = MelConfig.whisper()
    tcfg = TrainConfig(batch_size=2, compute_dtype="float32",
                       attn_impl="flash" if dev.type == "cuda" else "xla",
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-4,
                                                 schedule="constant",
                                                 grad_clip_norm=1.0))
    full = cp.to_device(cp.init(cfg, torch.Generator().manual_seed(0)), dev)
    axes = (emo.param_axes(full, cfg, mesh.model_size)
            if mesh.model_group is not None else None)
    params = cp.set_trainable(
        tp.shard_params(full, mesh.model_size, mesh.model_rank, axes)
        if axes is not None else full)
    opt = optim.build_optimizer(tcfg.optimizer, params,
                                decay_mask=optim.frozen_leaf_decay_mask,
                                model_group=mesh.model_group, axes=axes)
    step, _ = tw.make_steps(cfg, mel_cfg, tcfg, opt, dev, mesh)
    ds = SyntheticSeq2Seq(
        num_samples=2, num_classes=4, vocab_size=w.vocab_size,
        max_label_len=24, duration=2 * w.max_source_positions
        * mel_cfg.hop_length / mel_cfg.sample_rate,
        bos_id=w.decoder_start_token_id, eos_id=w.eos_token_id,
        pad_id=w.pad_token_id)
    batch = common.batch_to_device(
        next(ds.batcher(2).train_epochs(epoch=0)), dev)
    _build.reset_stats()
    m = step(params, batch)
    res = {"loss": common.mean_over_ranks(m, mesh)["loss"],
           "launches": {k: (s.launches, s.plain_cuda_calls)
                        for k, s in _build.STATS.items()}}
    # a second step, its collectives counted and timed (the card
    # synchronised around each), then a third timed alone
    with counted_collectives(dev, timed=True) as rec:
        t0 = time.perf_counter()
        step(params, batch)
        _sync(dev)
        res["timed_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(params, batch)
    _sync(dev)
    res.update(wall_s=time.perf_counter() - t0, collectives=rec)
    torch.save(res, os.path.join(
        out_dir, f"train_{mesh_name}_rank{distributed.process_index()}.pt"))


def _load(out_dir, prefix, n):
    return [torch.load(os.path.join(out_dir, f"{prefix}_rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def run_mesh(out_dir, mesh_name, size, dtypes, device, backend=None,
             rank_device=None, timed=True, train=False) -> tuple:
    """The checks of one mesh in one launch: the decode in each of
    `dtypes` and, with `train`, the train step; returns (the decodes'
    numbers, the train step's or None). `device` is this process's (the
    one-card references), `rank_device` the ranks' (default `device`)."""
    n = {"model2": 2, "data2model2": 4, "model4": 4}[mesh_name]
    launch("tp_multicard:rank_main", n,
           [out_dir, mesh_name, size, list(dtypes), rank_device or device,
            backend, timed, train],
           timeout=600, env={"PYTHONPATH": SCRIPTS, "OMP_NUM_THREADS": "1"})
    decodes = [_hold_mesh(out_dir, mesh_name, size, dtype, device, n, timed)
               for dtype in dtypes]
    return decodes, _hold_train(out_dir, mesh_name, device, n) \
        if train else None


def _hold_mesh(out_dir, mesh_name, size, dtype, device, n, timed) -> dict:
    ranks = _load(out_dir, f"decode_{mesh_name}_{size}_{dtype}", n)
    d = ranks[0]["mesh"][0]
    one = one_card_decode(size, dtype, d, device, timed)
    rows = hold_decode(one, ranks, dtype)
    r0 = ranks[0]
    per_step = {k: v[0] / r0["positions"] for k, v in
                r0["collectives"].items()}
    coll_s = sum(v[1] for v in r0["collectives"].values())
    for r in ranks:
        for k in ("decode_cross_attention", "fused_greedy_step_partials",
                  "log_mel"):
            if str(device).startswith("cuda") and r["launches"][k][0] == 0:
                raise AssertionError(f"{mesh_name}: rank {r['mesh']} did "
                                     f"not launch {k}")
            if r["launches"][k][1]:
                raise AssertionError(f"{k}'s plain version ran on CUDA")
        for b, e in r.get("k1_rows", {}).items():
            if e > K1_TOL_BF16:
                raise AssertionError(f"K1 at {b} x {r['mesh']} rows: {e}")
    fed = r0["positions"]   # the one card ran as many: same tokens
    times = {"ms_per_step": 1e3 * r0["wall_s"] / fed,
             "one_card_ms_per_step": 1e3 * one["wall_s"] / fed,
             "collective_ms_per_step": 1e3 * coll_s / fed,
             "collective_share": coll_s / r0["timed_wall_s"]} \
        if timed else {}
    return {"mesh": mesh_name, "size": size, "dtype": dtype,
            "card": r0["card"], "rows": rows, **times,
            "collectives_per_step": per_step,
            "launches_rank0": {k: r0["launches"][k][0] for k in
                               ("decode_cross_attention",
                                "fused_greedy_step_partials", "log_mel")},
            "k1_rows_err": {str(b): e for b, e in
                            r0.get("k1_rows", {}).items()}}


def _hold_train(out_dir, mesh_name, device, n) -> dict:
    ranks = _load(out_dir, f"train_{mesh_name}", n)
    train_rank(out_dir, Mesh(1, 0), "one", device)
    one = _load(out_dir, "train_one", 1)[0]
    rel = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    if rel > 1e-6:
        raise AssertionError(f"{mesh_name}: TP step loss {ranks[0]['loss']} "
                             f"against one card's {one['loss']}")
    if str(device).startswith("cuda"):
        for r in ranks:
            for k in ("log_mel", "flash_attention_fwd",
                      "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                if r["launches"][k][0] == 0 or r["launches"][k][1]:
                    raise AssertionError(f"{mesh_name}: {k} {r['launches']}")
    r0 = ranks[0]
    return {"mesh": mesh_name, "loss": r0["loss"],
            "one_card_loss": one["loss"], "loss_rel": rel,
            "ms_per_step": 1e3 * r0["wall_s"],
            "one_card_ms_per_step": 1e3 * one["wall_s"],
            "collectives_per_step": {k: v[0] for k, v in
                                     r0["collectives"].items()},
            "collective_ms_per_step": 1e3 * sum(
                v[1] for v in r0["collectives"].values()),
            "collective_share": sum(v[1] for v in r0["collectives"].values())
            / r0["timed_wall_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("tp_multicard: needs 4 CUDA devices", file=sys.stderr)
            return 1
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi, flush=True)
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device, dtypes = "cuda:0", ("float32", "bfloat16")
    else:
        device, dtypes = "cpu", ("float32",)
    results = []
    with tempfile.TemporaryDirectory(prefix="tp_multicard_") as out:
        for mesh_name, size, train in (("model2", "tiny", True),
                                       ("data2model2", "tiny", True),
                                       ("model4", "base", False)):
            t0 = time.perf_counter()
            decodes, step = run_mesh(out, mesh_name, size, dtypes, device,
                                     rank_device=args.device, train=train)
            for r in decodes + ([step] if step else []):
                print(json.dumps(r), flush=True)
                results.append(r)
            print(f"{mesh_name} {size}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(json.dumps({"ok": True, "results": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
