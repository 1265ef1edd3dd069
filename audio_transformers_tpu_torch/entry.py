"""Entry points of the port for a quick whole-model check: the
counterparts of the repository's `__graft_entry__.py` for the JAX
package.

entry(device="cuda")  -> (fn, args): fn(*args) is the forward of the
                         flagship model (whisper-tiny and the emotion
                         head, the log-mel front end included: the K3
                         kernel on the card) on 2 seeded clips of 30 s
                         and 24 decoder ids.
dryrun_multichip(n)   -> data parallelism in n processes on the CPU
                         (gloo), as the reference validates its mesh on
                         a virtual CPU mesh: one dual-loss train step at
                         the test config with the global batch split
                         over the ranks, then greedy timestamped decode
                         and segment pooling with the batch split, equal
                         to one process's decode. Tensor parallelism is
                         not ported, so the mesh has no "model" axis.

    python -m audio_transformers_tpu_torch.entry [--device cpu] [--dryrun N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig,
                                                      OptimizerConfig,
                                                      TrainConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.whisper import decode as wdecode
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops.mel import log_mel
from audio_transformers_tpu_torch.parallel import distributed
from audio_transformers_tpu_torch.parallel.launch import launch
from audio_transformers_tpu_torch.parallel.mesh import (build_mesh,
                                                        replicated)


def entry(device="cuda"):
    """(fn, (params, waveform, decoder_ids)) on `device` (bfloat16
    activations on the card, float32 on the CPU)."""
    device = cp.resolve_device(device)
    dtype = cp.compute_dtype_for(device)
    cfg = EmotionWhisperConfig()   # whisper-tiny + 10-class emotion head
    mel_cfg = MelConfig.whisper()
    params = cp.to_device(cp.init(cfg, torch.Generator().manual_seed(0)),
                          device)

    def fn(params, waveform, decoder_ids):
        mel = log_mel(waveform, mel_cfg).to(dtype)
        return emo.forward_train(params, cfg, mel, decoder_ids)

    rng = np.random.default_rng(0)
    waveform = torch.from_numpy(
        rng.standard_normal((2, mel_cfg.sample_rate * 30))
        .astype(np.float32) * 0.1).to(device)
    decoder_ids = torch.from_numpy(rng.integers(
        0, cfg.whisper.vocab_size, (2, 24))).to(device)
    return fn, (params, waveform, decoder_ids)


def dryrun_multichip(n_devices: int, *, timeout: float = 300.0) -> list:
    """Runs the data-parallel dry run in `n_devices` CPU processes and
    returns their output; raises if any rank fails."""
    outs = launch("audio_transformers_tpu_torch.entry:_dryrun_rank",
                  n_devices, timeout=timeout, env={"OMP_NUM_THREADS": "1"})
    print(outs[0].strip())
    return outs


def _gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of `t`, in rank order (equal row counts)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _dryrun_rank() -> None:
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.train.common import batch_to_device
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        make_steps

    distributed.initialize_if_multihost(device="cpu")
    mesh = build_mesh()
    n = mesh.size
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    w = cfg.whisper
    mel_cfg = MelConfig.whisper()
    tcfg = TrainConfig(batch_size=2 * n, compute_dtype="float32",
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-4,
                                                 schedule="constant"))
    duration = (2 * w.max_source_positions) * mel_cfg.hop_length \
        / mel_cfg.sample_rate
    ds = SyntheticSeq2Seq(num_samples=tcfg.batch_size,
                          num_classes=cfg.num_emotion_classes,
                          vocab_size=w.vocab_size, max_label_len=12,
                          duration=duration,
                          bos_id=w.decoder_start_token_id,
                          eos_id=w.eos_token_id, pad_id=w.pad_token_id)
    batch = next(ds.batcher(tcfg.batch_size).train_epochs(epoch=0))
    assert batch["waveform"].shape[0] == 2, batch["waveform"].shape

    params = cp.set_trainable(replicated(
        cp.init(cfg, torch.Generator().manual_seed(0)), mesh))
    opt = build_optimizer(tcfg.optimizer, params)
    train_step, _ = make_steps(cfg, mel_cfg, tcfg, opt, "cpu", mesh)
    metrics = train_step(params, batch_to_device(batch, "cpu"))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"rank {mesh.rank}: loss {loss}")
    flat = torch.cat([t.detach().reshape(-1)
                      for _, t in cp.leaves_with_path(params)])
    if not torch.equal(_gather(flat[None], mesh),
                       flat[None].expand(n, -1)):
        raise RuntimeError("the replicas' parameters differ after a step")
    print(f"dryrun_multichip({n}): mesh=data:{n}, one dual-loss train "
          f"step OK, replicas equal, rank {mesh.rank} loss={loss:.4f}")

    # inference: every rank decodes its rows of the batch; the gathered
    # tokens equal one process's decode of the whole batch
    params = cp.init(cfg, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal(
        (2 * n, 2 * w.max_source_positions, w.n_mels)).astype(np.float32))
    dcfg = DecodeConfig(max_new_tokens=10, no_repeat_ngram_size=3,
                        return_timestamps=True)
    prompt = (w.decoder_start_token_id,)
    # EOS suppressed: every row decodes all its steps
    kw = {"prompt": prompt, "suppress_ids": (w.eos_token_id,)}
    with torch.no_grad():
        enc = wm.encode(params["whisper"], w, mel)
        ref = wdecode.generate(params["whisper"], w, dcfg, enc, **kw)
        ref_seg = emo.segment_emotion_from_decode(params, cfg, ref,
                                                  prompt_len=1)
        rows = slice(2 * mesh.rank, 2 * mesh.rank + 2)
        out = wdecode.generate(params["whisper"], w, dcfg,
                               wm.encode(params["whisper"], w, mel[rows]),
                               **kw)
        seg = emo.segment_emotion_from_decode(params, cfg, out,
                                              prompt_len=1)
    for key in ("tokens", "lengths"):
        if not torch.equal(_gather(out[key], mesh), ref[key]):
            raise RuntimeError(f"DP decode: {key} differ from one "
                               "process's decode")
    got = _gather(seg["segment_logits"], mesh)
    err = float((got - ref_seg["segment_logits"]).abs().max())
    if err > 2e-4:
        raise RuntimeError(f"DP segment pooling differs by {err}")
    print(f"dryrun_multichip({n}): DP decode + segment pooling OK "
          f"({int(ref['lengths'].sum())} tokens, batch {2 * n} split "
          f"over data:{n}, token-equal to one process, segment logits "
          f"within {err:.2e})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dryrun", type=int, default=None,
                   help="run dryrun_multichip(N) only")
    args = p.parse_args(argv)
    if args.dryrun is None:
        fn, fn_args = entry(args.device)
        with torch.no_grad():
            out = fn(*fn_args)
        print("entry(): forward OK", [tuple(o.shape) for o in out])
    dryrun_multichip(args.dryrun or 2)


if __name__ == "__main__":
    main()
