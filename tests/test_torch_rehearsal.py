"""scripts/parity_rehearsal_torch.py, the port's Expresso rehearsal,
against the JAX package on the CPU at the test widths (WhisperConfig.
test(), clips of its 1.28 s window), in float32.

The JAX side makes the calls of scripts/parity_rehearsal.py in its
order (SyntheticExpresso.splits, train_whisper_emotion,
evaluate_sequence_level on the best parameters), at these widths:
that script's `main` builds the full-width EmotionWhisperConfig() itself.
Both start from JAX's seeded initial parameters (the port's through
`core.params.from_jax_params`).

  losses and accuracies of each epoch, best val loss   1e-4 relative
  the evaluator's predictions.txt and metrics.txt      equal
"""

import json
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np

from audio_transformers_tpu.cli.common import get_tokenizer
from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                MelConfig, OptimizerConfig,
                                                TrainConfig, WhisperConfig)
from audio_transformers_tpu.data.expresso import SyntheticExpresso
from audio_transformers_tpu.infer.evaluate import evaluate_sequence_level
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.train.whisper_emotion import \
    train_whisper_emotion
from audio_transformers_tpu_torch.core import config as pcfg
from audio_transformers_tpu_torch.core import params as cp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS, BATCH, SEED = 20, 5, 42


def _jax_rehearsal(out_dir):
    """scripts/parity_rehearsal.py:97-161's calls at the test widths
    (float32, on one device; the trainer without an output directory,
    whose orbax checkpoints take seconds); returns (history, best val
    loss, the initial parameters)."""
    tokenizer = get_tokenizer(None)
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test())
    mel_cfg = MelConfig.whisper()
    ds = SyntheticExpresso(tokenizer, num_samples=CLIPS,
                           duration=(2 * cfg.whisper.max_source_positions
                                     * mel_cfg.hop_length
                                     / mel_cfg.sample_rate),
                           vocab_size=cfg.whisper.vocab_size, seed=SEED)
    train_ds, val_ds, test_ds, style_to_idx = ds.splits(seed=SEED)
    cfg = cfg.replace(num_emotion_classes=len(style_to_idx))
    idx_to_style = {v: k for k, v in style_to_idx.items()}
    init = jax.tree.map(np.asarray,
                        jemo.init(jax.random.PRNGKey(SEED), cfg))
    train_cfg = TrainConfig(
        batch_size=BATCH, num_epochs=1, seed=SEED, compute_dtype="float32",
        emotion_weight=0.5,
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-5,
                                  schedule="linear_warmup_decay",
                                  warmup_fraction=0.1),
        # one device of the tests' 8-device CPU mesh: batch 5 does not
        # split over 8
        mesh_shape=(("data", 1),))
    out = train_whisper_emotion(
        cfg, mel_cfg, train_cfg,
        train_ds.batcher(BATCH, seed=SEED, num_workers=4),
        val_ds.batcher(BATCH, seed=SEED, num_workers=4),
        init_params=jax.tree.map(np.array, init), style_to_idx=style_to_idx)
    evaluate_sequence_level(
        out["best_params"], cfg, mel_cfg, test_ds.batcher(BATCH),
        idx_to_style, tokenizer=tokenizer,
        output_dir=os.path.join(out_dir, "eval_out"),
        compute_dtype=jnp.float32)
    return out["history"], out["best_val_loss"], init


def _read(path):
    with open(path) as f:
        return f.read()


def test_rehearsal_matches_jax(tmp_path):
    history, best, init = _jax_rehearsal(str(tmp_path / "jax"))
    script = runpy.run_path(os.path.join(ROOT, "scripts",
                                         "parity_rehearsal_torch.py"))
    port_dir = str(tmp_path / "port")
    summary = script["main"](
        ["--num_samples", str(CLIPS), "--epochs", "1", "--compute_dtype",
         "float32", "--device", "cpu", "--output_dir", port_dir],
        cfg=pcfg.EmotionWhisperConfig(whisper=pcfg.WhisperConfig.test()),
        init_params=cp.from_jax_params(init))

    with open(os.path.join(port_dir, "metrics.jsonl")) as f:
        got = [json.loads(line) for line in f]
    assert [g["epoch"] for g in got] == [h["epoch"] for h in history] == [1]
    for g, w in zip(got, history):
        keys = [k for k in w if k.startswith(("train/", "val/"))]
        assert len(keys) == 8
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(summary["best_val_loss"], best, rtol=1e-4)
    assert [c["epoch"] for c in summary["loss_curve"]] == [1]
    assert summary["test_samples"] == 4
    for name in ("predictions.txt", "metrics.txt"):
        assert _read(os.path.join(port_dir, "eval_out", name)) \
            == _read(str(tmp_path / "jax" / "eval_out" / name)), name
    with open(os.path.join(port_dir, "rehearsal_summary.json")) as f:
        assert json.load(f) == summary
