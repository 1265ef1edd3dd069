"""The port's whisper-emotion training path against the JAX package, on
the CPU, at WhisperConfig.test() with JAX-initialised weights bridged into
the port (`core.params.from_jax_params`). Everything runs in float32; the
flash path runs the kernels' plain versions on the port's side and the
Pallas kernels in interpret mode on JAX's.

Tolerances:
  forward_train logits, emotion logits    2e-4 abs + 2e-4 rel (f32 sums in
                                          another order through 4 blocks)
  dual_loss                               1e-5 rel
  gradients, every parameter              max |port - jax| <= 1e-4 *
                                          max(1, max |jax|) per leaf
  optimizer, 5 steps of fixed gradients   2e-6 abs + 1e-5 rel on params
  train_whisper_emotion, 2 epochs         history and best_val_loss within
                                          1e-3 rel; parameters within
                                          2 * steps * lr abs: Adam
                                          normalises each update, so an
                                          element whose gradient is tiny
                                          can move by up to lr a step on
                                          either side from sum-order noise
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                MelConfig, OptimizerConfig,
                                                TrainConfig, WhisperConfig)
from audio_transformers_tpu.data.synthetic import SyntheticSeq2Seq
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.train import optim as joptim
from audio_transformers_tpu.train import whisper_emotion as jtrain
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.train import optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


@pytest.fixture(scope="module")
def jparams():
    return jemo.init(jax.random.PRNGKey(0), TINY)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 2 * W.max_source_positions,
                               W.n_mels)).astype(np.float32)
    labels = rng.integers(2, W.vocab_size, (2, 9)).astype(np.int32)
    labels[:, 0] = W.decoder_start_token_id
    labels[0, 6:] = W.pad_token_id        # a padded row
    return {"mel": mel, "labels": labels,
            "emotion_labels": np.array([1, 3], np.int32)}


def _port_params(jparams):
    return cp.set_trainable(cp.from_jax_params(jparams))


# --------------------------------------------------------------------------
# forward_train, dual_loss, gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("pooling", ["all", "masked"])
def test_forward_train_matches_jax(jparams, batch, attn, pooling):
    dec_in = batch["labels"][:, :-1]
    fwd = jax.jit(lambda p, m, d: jemo.forward_train(
        p, TINY, m, d, pooling=pooling, attn_impl=attn))
    jl, je = fwd(jparams, jnp.asarray(batch["mel"]), jnp.asarray(dec_in))
    tl, te = emo.forward_train(cp.from_jax_params(jparams), TINY,
                               torch.from_numpy(batch["mel"]),
                               torch.from_numpy(dec_in).long(),
                               pooling=pooling, attn_impl=attn)
    assert tl.dtype == te.dtype == torch.float32
    assert tl.shape == (2, 8, W.vocab_size) and te.shape == (2, 4)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(te), _np(je), rtol=2e-4, atol=2e-4)


def test_forward_train_rejects_remat(jparams, batch):
    """remat is ported: forward_train takes it and gives remat=False's
    outputs bit for bit (tests/test_torch_remat.py holds the gradients)."""
    mel = torch.from_numpy(batch["mel"])
    ids = torch.from_numpy(batch["labels"][:, :-1]).long()
    params = cp.from_jax_params(jparams)
    want = emo.forward_train(params, TINY, mel, ids)
    got = emo.forward_train(params, TINY, mel, ids, remat=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mask_mode", ["pad", "keep_first_eos"])
def test_dual_loss_matches_jax(mask_mode):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    emo_logits = rng.standard_normal((3, 5)).astype(np.float32)
    labels = rng.integers(1, 50, (3, 8)).astype(np.int32)
    labels[0, 4:] = 0
    labels[2, 2:] = 0
    emo_labels = np.array([0, 4, 2], np.int32)
    kw = {"pad_token_id": 0, "emotion_weight": 0.3, "mask_mode": mask_mode}
    want = jtrain.dual_loss(jnp.asarray(logits), jnp.asarray(emo_logits),
                            jnp.asarray(labels), jnp.asarray(emo_labels),
                            **kw)
    got = tw.dual_loss(torch.from_numpy(logits),
                       torch.from_numpy(emo_logits),
                       torch.from_numpy(labels).long(),
                       torch.from_numpy(emo_labels).long(), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_synthetic_tiny_labels_supervise_padding():
    """A known point of the reference, reproduced: train_whisper
    --dataset synthetic at tiny width pads labels with the byte
    tokenizer's id 0, while dual_loss masks the config's pad id 50257, so
    the padding positions are supervised, in both packages alike."""
    from argparse import Namespace

    from audio_transformers_tpu.cli.common import (build_expresso_splits,
                                                   get_tokenizer)
    cfg = WhisperConfig.tiny()
    args = Namespace(dataset="synthetic", seed=42, num_samples=12,
                     simple_styles=False, data_percentage=1.0)
    train, _, _, _ = build_expresso_splits(args, get_tokenizer(None),
                                           duration=0.1,
                                           vocab_size=cfg.vocab_size)
    labels = np.stack([train(i)["labels"] for i in range(4)])
    assert labels[:, 0].tolist() == [1] * 4     # the byte tokenizer's start
    targets = labels[:, 1:]
    assert (targets == 0).any()                 # byte-tokenizer padding...
    assert (targets != cfg.pad_token_id).all()  # ...is not masked
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, targets.shape[1], 64)).astype(
        np.float32)
    emo_labels = np.zeros(4, np.int32)
    kw = {"pad_token_id": cfg.pad_token_id, "emotion_weight": 0.5}
    want = jtrain.dual_loss(jnp.asarray(logits), jnp.zeros((4, 3)),
                            jnp.asarray(labels % 64), jnp.asarray(emo_labels),
                            **kw)
    got = tw.dual_loss(torch.from_numpy(logits), torch.zeros(4, 3),
                       torch.from_numpy(labels % 64).long(),
                       torch.from_numpy(emo_labels).long(), **kw)
    np.testing.assert_allclose(float(got["transcription_loss"]),
                               float(want["transcription_loss"]), rtol=1e-5)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_dual_loss_gradients_match_jax(jparams, batch, attn):
    labels, mel = batch["labels"], batch["mel"]

    def jloss(p):
        logits, e = jemo.forward_train(p, TINY, jnp.asarray(mel),
                                       jnp.asarray(labels[:, :-1]),
                                       attn_impl=attn)
        return jtrain.dual_loss(
            logits, e, jnp.asarray(labels),
            jnp.asarray(batch["emotion_labels"]),
            pad_token_id=W.pad_token_id, emotion_weight=0.5)["loss"]

    jgrads = cp.from_jax_params(jax.jit(jax.grad(jloss))(jparams))
    params = _port_params(jparams)
    logits, e = emo.forward_train(params, TINY, torch.from_numpy(mel),
                                  torch.from_numpy(labels[:, :-1]).long(),
                                  attn_impl=attn)
    tw.dual_loss(logits, e, torch.from_numpy(labels).long(),
                 torch.from_numpy(batch["emotion_labels"]).long(),
                 pad_token_id=W.pad_token_id,
                 emotion_weight=0.5)["loss"].backward()
    jleaves = dict(cp.leaves_with_path(jgrads))
    for path, t in cp.leaves_with_path(params):
        want = _np(jleaves[path])
        if path in cp.FROZEN:
            assert t.grad is None              # frozen: no gradient at all
            assert not want.any()              # stop_gradient in JAX
            continue
        err = np.abs(_np(t.grad) - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (path, err)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------


def _opt_tree():
    rng = np.random.default_rng(3)
    tree = {"whisper": {"encoder": {"pos": rng.standard_normal((4, 3))},
                        "w": rng.standard_normal((5, 3))},
            "emotion_head": {"b": rng.standard_normal(3)}}
    return jax.tree.map(lambda a: a.astype(np.float32), tree)


OPT_CASES = {
    "adamw_warmup_decay_clip": OptimizerConfig(
        name="adamw", learning_rate=1e-2, weight_decay=0.1,
        schedule="linear_warmup_decay", warmup_fraction=0.4,
        grad_clip_norm=1.0),
    "adam_plateau": OptimizerConfig(name="adam", learning_rate=1e-2,
                                    schedule="reduce_on_plateau"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    cfg = OPT_CASES[case]
    tree = _opt_tree()
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * s)
                          .astype(np.float32), tree)
             for s in (0.2, 3.0, 0.5, 0.05, 1.0)]
    total = 5
    tx = joptim.build_optimizer(cfg, total_steps=total,
                                decay_mask=joptim.frozen_leaf_decay_mask)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)

    params = cp.set_trainable(cp.map_tensors(
        tree, lambda a: torch.from_numpy(np.array(a))))
    opt = optim.build_optimizer(cfg, params, total_steps=total,
                                decay_mask=optim.frozen_leaf_decay_mask)
    for i, g in enumerate(grads):
        if case == "adam_plateau" and i == 3:
            state = joptim.set_learning_rate(state, 1e-3)
            optim.set_learning_rate(opt, 1e-3)
            assert optim.get_learning_rate(opt) == pytest.approx(
                joptim.get_learning_rate(state))
        # JAX: the frozen leaf's gradient is zero (stop_gradient)
        g = {**g, "whisper": {**g["whisper"], "encoder": {
            "pos": np.zeros_like(g["whisper"]["encoder"]["pos"])}}}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for (path, t) in cp.trainable_leaves(params):
            t.grad = torch.from_numpy(np.array(
                dict(cp.leaves_with_path(g))[path]))
        opt.step()
    jleaves = dict(cp.leaves_with_path(jp))
    for path, t in cp.leaves_with_path(params):
        np.testing.assert_allclose(_np(t), _np(jleaves[path]), rtol=1e-5,
                                   atol=2e-6, err_msg=str(path))
    pos = tree["whisper"]["encoder"]["pos"]
    np.testing.assert_array_equal(_np(params["whisper"]["encoder"]["pos"]),
                                  pos)


def test_schedule_starts_at_zero_like_optax():
    cfg = OptimizerConfig(learning_rate=3e-5, schedule="linear_warmup_decay",
                          warmup_fraction=0.1)
    sched = optim.learning_rate_schedule(cfg, 37)
    j = optax.join_schedules(
        [optax.linear_schedule(0.0, 3e-5, 3),
         optax.linear_schedule(3e-5, 0.0, 34)], boundaries=[3])
    assert sched(0) == 0.0
    for count in range(40):
        # optax evaluates the schedule in float32
        assert sched(count) == pytest.approx(float(j(count)), rel=1e-6,
                                             abs=1e-12)


def test_plateau_scheduler_matches_jax():
    cfg = OptimizerConfig(learning_rate=1.0, plateau_patience=1,
                          plateau_factor=0.5)
    a, b = joptim.PlateauScheduler(cfg), optim.PlateauScheduler(cfg)
    for m in (3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6):
        assert a.step(m) == b.step(m)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------


def _seq2seq(n, seed):
    mel_cfg = MelConfig.whisper()
    dur = 2 * W.max_source_positions * mel_cfg.hop_length \
        / mel_cfg.sample_rate
    return SyntheticSeq2Seq(num_samples=n, num_classes=4,
                            vocab_size=W.vocab_size, max_label_len=8,
                            duration=dur, seed=seed,
                            bos_id=W.decoder_start_token_id,
                            eos_id=W.eos_token_id, pad_id=W.pad_token_id)


def test_train_whisper_emotion_matches_jax(jparams, tmp_path):
    lr, epochs = 1e-3, 2
    tcfg = TrainConfig(
        batch_size=8, num_epochs=epochs, compute_dtype="float32",
        optimizer=OptimizerConfig(name="adamw", learning_rate=lr,
                                  weight_decay=0.01,
                                  schedule="linear_warmup_decay",
                                  warmup_fraction=0.25),
        mesh_shape=(("data", 1),))
    mel_cfg = MelConfig.whisper()
    ds_t, ds_v = _seq2seq(16, 1), _seq2seq(12, 2)
    # the JAX trainer donates its parameter buffers: hand it host copies
    want = jtrain.train_whisper_emotion(TINY, mel_cfg, tcfg,
                                        ds_t.batcher(8), ds_v.batcher(8),
                                        init_params=jax.tree.map(np.array,
                                                                 jparams))
    out_dir = str(tmp_path / "run")
    got = tw.train_whisper_emotion(
        TINY, mel_cfg, tcfg, ds_t.batcher(8), ds_v.batcher(8), device="cpu",
        init_params=cp.from_jax_params(jparams), output_dir=out_dir,
        style_to_idx={"a": 0, "b": 1})

    assert len(got["history"]) == len(want["history"]) == epochs
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        for k in w:
            if k in ("clips_per_sec", "data_wait_s"):
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"],
                               rtol=1e-3)
    steps = epochs * ds_t.batcher(8).steps_per_epoch
    jleaves = dict(cp.leaves_with_path(
        cp.from_jax_params(jax.device_get(want["best_params"]))))
    for path, t in cp.leaves_with_path(got["best_params"]):
        assert np.abs(_np(t) - _np(jleaves[path])).max() \
            <= 2 * steps * lr, path
    with open(os.path.join(out_dir, "style_to_id.txt")) as f:
        assert f.read() == "a: 0\nb: 1\n"
    assert os.path.exists(os.path.join(out_dir, "metrics.jsonl"))


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # SpecAugment, remat and tensor parallelism are ported: one epoch on a
    # "model" axis of 2 (two gloo processes) is one process's epoch
    import torch_tp_worker
    from audio_transformers_tpu_torch.parallel.launch import launch

    tw.make_steps(TINY, MelConfig.whisper(), TrainConfig(spec_augment=True),
                  None, "cpu")
    tw.make_steps(TINY, MelConfig.whisper(), TrainConfig(remat=True), None,
                  "cpu")
    out = str(tmp_path)
    launch("torch_tp_worker:whisper_trainer", 2, [out, "model2"],
           timeout=120, env={"PYTHONPATH": os.path.dirname(__file__),
                             "OMP_NUM_THREADS": "1"})
    torch_tp_worker.whisper_trainer(out, "one")
    got, want = (torch.load(os.path.join(out, f"{m}_history.pt"))
                 for m in ("model2", "one"))
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k not in ("clips_per_sec", "data_wait_s"):
            np.testing.assert_allclose(got[0][k], v, rtol=1e-3, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tw.resolve_device("cuda")


def test_cli_refuses_pretrained_and_hub(tmp_path, monkeypatch, capsys):
    """--pretrained refuses a directory without weights (a sharded index
    is not read); --hf_repo_id without HF_ACCESS exports the run but
    refuses the upload."""
    from audio_transformers_tpu_torch.cli import train_whisper
    (tmp_path / "sharded").mkdir()
    (tmp_path / "sharded" / "model.safetensors.index.json").write_text("{}")
    small = ["--device", "cpu", "--model_size", "test", "--compute_dtype",
             "float32", "--num_epochs", "1", "--batch_size", "8",
             "--num_samples", "16", "--num_workers", "0"]
    with pytest.raises(FileNotFoundError, match="sharded"):
        train_whisper.main(small + ["--pretrained",
                                    str(tmp_path / "sharded")])
    monkeypatch.delenv("HF_ACCESS", raising=False)
    train_whisper.main(small + ["--hf_repo_id", "user/repo",
                                "--output_dir", str(tmp_path / "run")])
    assert "HF_ACCESS not set; skipping upload" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "run" / "hf_export" /
                          "model.safetensors")


def test_training_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['optax'] = None; sys.modules['orbax'] = None\n"
            "import audio_transformers_tpu_torch.train.whisper_emotion\n"
            "import audio_transformers_tpu_torch.train.optim\n"
            "import audio_transformers_tpu_torch.cli.train_whisper as c\n"
            "import audio_transformers_tpu_torch.ops.attention\n"
            "import audio_transformers_tpu_torch.core.metrics\n"
            "import audio_transformers_tpu.cli.common\n"
            "import audio_transformers_tpu.data.expresso\n"
            "assert c.parse_args([]).device == 'cuda'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
