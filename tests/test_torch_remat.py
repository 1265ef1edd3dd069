"""Activation checkpointing (remat) in the port's whisper model and
trainer, on the CPU at WhisperConfig.test() in float32.

The recompute repeats the same arithmetic, so on the CPU remat=True is
held to remat=False bit for bit: the outputs of `encode`, `apply_decoder`
and `forward_train`, every gradient, and a trainer step's parameters.
One step of the port's `forward_train(remat=True)` is held to JAX's
`forward_train(remat=True)` (jax.checkpoint over the blocks; the flash
path's Pallas kernels in interpret mode) as tests/test_torch_train.py
holds the gradients: the loss within 1e-5 relative, every leaf's
gradient within 1e-4 * max(1, max |jax|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                WhisperConfig)
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.train import whisper_emotion as jtrain
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (MelConfig,
                                                      OptimizerConfig,
                                                      TrainConfig)
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.train import optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as many alone, and far faster beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 2 * W.max_source_positions,
                               W.n_mels)).astype(np.float32)
    labels = rng.integers(2, W.vocab_size, (2, 9)).astype(np.int32)
    labels[:, 0] = W.decoder_start_token_id
    labels[0, 6:] = W.pad_token_id
    return {"mel": mel, "labels": labels,
            "emotion_labels": np.array([1, 3], np.int32)}


def _params(seed=0):
    return cp.set_trainable(cp.init(TINY, torch.Generator().manual_seed(seed)))


def _run(fn, remat, attn, batch):
    """(outputs, gradients) of fn's outputs' sum of squares."""
    params = _params()
    mel = torch.from_numpy(batch["mel"])
    ids = torch.from_numpy(batch["labels"][:, :-1]).long()
    w = params["whisper"]
    if fn == "encode":
        outs = (wm.encode(w, W, mel, remat=remat, attn_impl=attn),)
    elif fn == "apply_decoder":
        enc = wm.encode(w, W, mel, attn_impl=attn)
        outs = (wm.apply_decoder(w, W, enc, ids, remat=remat,
                                 attn_impl=attn),)
    else:
        outs = emo.forward_train(params, TINY, mel, ids, remat=remat,
                                 attn_impl=attn)
    sum(o.float().square().sum() for o in outs).backward()
    grads = {p: t.grad for p, t in cp.leaves_with_path(params)
             if t.grad is not None}
    return outs, grads


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("fn", ["encode", "apply_decoder", "forward_train"])
def test_remat_is_bit_equal(batch, fn, attn):
    outs, grads = _run(fn, False, attn, batch)
    routs, rgrads = _run(fn, True, attn, batch)
    assert all(torch.equal(a, b) for a, b in zip(outs, routs))
    assert grads and set(grads) == set(rgrads)
    for path, g in grads.items():
        assert torch.equal(g, rgrads[path]), path


def test_trainer_step_with_remat_is_bit_equal(batch):
    """make_steps with train_cfg.remat: one AdamW step, the metrics and
    every parameter equal to remat=False's."""
    wav = np.random.default_rng(1).standard_normal(
        (2, 2 * W.max_source_positions * 160)).astype(np.float32) * 0.1
    host = {"waveform": torch.from_numpy(wav),
            "labels": torch.from_numpy(batch["labels"]).long(),
            "emotion_labels": torch.from_numpy(batch["emotion_labels"]).long()}
    runs = []
    for remat in (False, True):
        tcfg = TrainConfig(batch_size=2, compute_dtype="float32",
                           remat=remat, attn_impl="flash",
                           optimizer=OptimizerConfig(name="adamw",
                                                     learning_rate=1e-3))
        params = _params()
        opt = optim.build_optimizer(tcfg.optimizer, params)
        step, _ = tw.make_steps(TINY, MelConfig.whisper(), tcfg, opt, "cpu")
        runs.append((step(params, host), params))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for (path, a), (_, b) in zip(cp.leaves_with_path(p0),
                                 cp.leaves_with_path(p1)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_remat_gradients_match_jax(batch, attn):
    labels, mel = batch["labels"], batch["mel"]
    jparams = cp.to_jax_params(_params())

    def jloss(p):
        logits, e = jemo.forward_train(p, TINY, jnp.asarray(mel),
                                       jnp.asarray(labels[:, :-1]),
                                       remat=True, attn_impl=attn)
        return jtrain.dual_loss(
            logits, e, jnp.asarray(labels),
            jnp.asarray(batch["emotion_labels"]),
            pad_token_id=W.pad_token_id, emotion_weight=0.5)["loss"]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jparams))
    jgrads = dict(cp.leaves_with_path(cp.from_jax_params(
        jax.device_get(jg))))
    params = cp.set_trainable(cp.from_jax_params(jparams))
    logits, e = emo.forward_train(params, TINY, torch.from_numpy(mel),
                                  torch.from_numpy(labels[:, :-1]).long(),
                                  remat=True, attn_impl=attn)
    loss = tw.dual_loss(logits, e, torch.from_numpy(labels).long(),
                        torch.from_numpy(batch["emotion_labels"]).long(),
                        pad_token_id=W.pad_token_id,
                        emotion_weight=0.5)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for path, t in cp.leaves_with_path(params):
        want = np.asarray(jgrads[path])
        if path in cp.FROZEN:
            assert t.grad is None and not want.any()
            continue
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (path, err)


def test_train_whisper_emotion_with_remat_equals_without():
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq

    dur = 2 * W.max_source_positions * 160 / 16000
    ds = SyntheticSeq2Seq(num_samples=4, num_classes=4,
                          vocab_size=W.vocab_size, max_label_len=8,
                          duration=dur, seed=3,
                          bos_id=W.decoder_start_token_id,
                          eos_id=W.eos_token_id, pad_id=W.pad_token_id)
    outs = []
    for remat in (False, True):
        tcfg = TrainConfig(batch_size=2, num_epochs=1,
                           compute_dtype="float32", remat=remat,
                           optimizer=OptimizerConfig(name="adamw",
                                                     learning_rate=1e-3))
        outs.append(tw.train_whisper_emotion(
            TINY, MelConfig.whisper(), tcfg, ds.batcher(2), ds.batcher(2),
            device="cpu", init_params=_params()))
    a, b = ({k: v for k, v in o["history"][0].items()
             if k not in ("clips_per_sec", "data_wait_s")} for o in outs)
    assert a == b
    for (path, x), (_, y) in zip(cp.leaves_with_path(outs[0]["params"]),
                                 cp.leaves_with_path(outs[1]["params"])):
        assert torch.equal(x, y), path
