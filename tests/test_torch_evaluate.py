"""The port's segment pooling, segment emotion, metrics and evaluation
(`infer/evaluate.py`) against the JAX package on the CPU, at the test
config with JAX-initialised weights bridged into the port, in float32.

  segment_ids_from_tokens                  equal
  segment_means, segment_emotion_from_decode  <= 1e-5 (float32 sums)
  classification_metrics                   equal to sklearn's, the report
                                           character for character
  word_error_rate                          equal
  evaluate_sequence_level, evaluate_segment_level: results equal, the
    files byte-equal (metrics.txt, predictions.txt,
    segment_evaluation.txt), the fallback's noise replayed

Timestamps sit at ids >= 600 (the test config puts them at 4), so that
decoded rows mix text and timestamp segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import accuracy_score, classification_report, f1_score

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                MelConfig, WhisperConfig)
from audio_transformers_tpu.data.synthetic import SyntheticSeq2Seq as JSynth
from audio_transformers_tpu.data.tokenizer import ByteTokenizer as JTok
from audio_transformers_tpu.infer import evaluate as jev
from audio_transformers_tpu.infer import metrics as jmet
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.ops import segment_pool as jsp
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
from audio_transformers_tpu_torch.data.tokenizer import ByteTokenizer
from audio_transformers_tpu_torch.infer import evaluate as ev
from audio_transformers_tpu_torch.infer import metrics as met
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.ops import segment_pool as sp

W = WhisperConfig.test().replace(timestamp_begin_id=600)
TINY = EmotionWhisperConfig(whisper=W, num_emotion_classes=4)
TB, EOS = W.timestamp_begin_id, W.eos_token_id
STYLES = {0: "angry", 1: "happy", 2: "sad", 3: "whisper"}
TOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu())


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(0), TINY))
    return jp, cp.from_jax_params(jp)


def _rows():
    """Decoded rows after a one-id prompt: segments of text between
    timestamp pairs, an empty segment ([3, 0, 2] counts), a row of
    timestamps and no text (no segment: the whole-sequence fallback), a
    row whose last segment stays open, and EOS."""
    rows = [
        [1, TB, 9, 10, 11, TB + 5, TB + 5, TB + 9, TB + 9, 12, 13, TB + 20,
         EOS, 0, 0, 0],
        [1, TB, 20, 21, 22, TB + 4, TB + 6, TB + 8, TB + 8, 30, 31, TB + 12,
         EOS, 0, 0, 0],
        [1, TB, TB + 2, EOS, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [1, TB, 50, TB + 3, TB + 3, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60,
         61],
    ]
    toks = np.array(rows, np.int32)
    lengths = np.array([13, 13, 4, 16], np.int32)
    return toks, lengths


def test_segment_ids_match_jax():
    toks, lengths = _rows()
    want = jsp.segment_ids_from_tokens(jnp.asarray(toks), jnp.asarray(lengths),
                                       prompt_len=1, timestamp_begin=TB,
                                       eos_token_id=EOS)
    got = sp.segment_ids_from_tokens(torch.from_numpy(toks),
                                     torch.from_numpy(lengths), prompt_len=1,
                                     timestamp_begin=TB, eos_token_id=EOS)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("num_segments", [3, 8])
def test_segment_means_match_jax(num_segments):
    toks, lengths = _rows()
    ids, valid = jsp.segment_ids_from_tokens(
        jnp.asarray(toks), jnp.asarray(lengths), prompt_len=1,
        timestamp_begin=TB, eos_token_id=EOS)
    h = np.random.default_rng(2).standard_normal(
        (4, 16, W.d_model)).astype(np.float32)
    want = jsp.segment_means(jnp.asarray(h), ids, valid, num_segments)
    got = sp.segment_means(torch.from_numpy(h),
                           torch.from_numpy(np.array(ids)),
                           torch.from_numpy(np.array(valid)), num_segments)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL, rtol=0)
    # row 1's middle pair holds no text: counts [3, 0, 2]
    np.testing.assert_array_equal(_np(got[1])[1, :3], [3, 0, 2])


@pytest.mark.parametrize("max_segments", [None, 2])
def test_segment_emotion_matches_jax(weights, max_segments):
    jp, tp = weights
    toks, lengths = _rows()
    h = np.random.default_rng(3).standard_normal(
        (4, 16, W.d_model)).astype(np.float32)
    want = jemo.segment_emotion_from_decode(
        jp, TINY, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths),
                   "hiddens": jnp.asarray(h)},
        prompt_len=1, max_segments=max_segments)
    got = emo.segment_emotion_from_decode(
        tp, TINY, {"tokens": torch.from_numpy(toks),
                   "lengths": torch.from_numpy(lengths),
                   "hiddens": torch.from_numpy(h)},
        prompt_len=1, max_segments=max_segments)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)
    # the row with no text falls back to its whole sequence, which
    # sequence_emotion_from_hiddens pools the same way
    seq = emo.sequence_emotion_from_hiddens(tp, torch.from_numpy(h),
                                            torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got["segment_logits"])[2, 0],
                               _np(seq)[2], atol=TOL, rtol=0)
    assert int(got["num_segments"][2]) == 1


def _label_cases():
    rng = np.random.default_rng(0)
    cases = [([0, 1, 2, 2], [0, 2, 2, 2]), ([1, 1, 1], [0, 0, 0]),
             ([3, 0], [3, 0]), ([2], [5])]
    for _ in range(40):
        n, k = int(rng.integers(1, 50)), int(rng.integers(1, 7))
        yt = rng.integers(0, k, n)
        yp = np.where(rng.random(n) < 0.6, yt, rng.integers(0, k + 2, n))
        cases.append((yt.tolist(), yp.tolist()))
    return cases


@pytest.mark.parametrize("case", range(len(_label_cases())))
def test_classification_metrics_equal_sklearn(case):
    y_true, y_pred = _label_cases()[case]
    got = met.classification_metrics(y_true, y_pred, STYLES)
    present = sorted(set(y_true) | set(y_pred))
    report = classification_report(
        y_true, y_pred, labels=present,
        target_names=[STYLES.get(i, f"Unknown_{i}") for i in present],
        digits=3, zero_division=0)
    assert got["report"] == report
    assert got["accuracy"] == accuracy_score(y_true, y_pred)
    assert got["weighted_f1"] == f1_score(y_true, y_pred,
                                          average="weighted", zero_division=0)
    assert got == jmet.classification_metrics(y_true, y_pred, STYLES)


def test_classification_metrics_empty():
    assert met.classification_metrics([], [], STYLES) \
        == jmet.classification_metrics([], [], STYLES)


@pytest.mark.parametrize("refs,hyps", [
    (["the cat sat", "Hello, world!"], ["the cat sat down", "hello world"]),
    (["a b c d"], ["a x c"]), ([""], ["extra words"]),
    (["it's here"], ["its here"])])
def test_word_error_rate_matches_jax(refs, hyps):
    assert met.word_error_rate(refs, hyps) == jmet.word_error_rate(refs, hyps)


class _JaxGumbel:
    """The reference's fallback noise, replayed into `decode.gumbel_noise`:
    per fallback call PRNGKey(0), one split per loop step, drawn over the
    reference's power-of-two bucket of rows (at most the batch)."""

    def __init__(self, batch):
        self.batch, self.gen, self.key = batch, None, None
        self.calls = 0

    def __call__(self, shape, generator):
        if generator is not self.gen:
            self.gen, self.key = generator, jax.random.PRNGKey(0)
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        rows = 1
        while rows < shape[0]:
            rows *= 2
        g = jax.random.gumbel(sub, (min(rows, self.batch), shape[1]),
                              jnp.float32)
        return torch.from_numpy(np.asarray(g)[:shape[0]].copy())


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("level,dcfg", [
    ("sequence", DecodeConfig(max_new_tokens=24, no_repeat_ngram_size=3,
                              repetition_penalty=1.15)),
    # the reference's segment decode at a shorter budget, and a threshold
    # that flags some rows (the texts here compress to ratios 0.27-0.43),
    # so that the fallback re-decodes
    ("segment", DecodeConfig(max_new_tokens=24, return_timestamps=True,
                             no_repeat_ngram_size=3, repetition_penalty=1.1,
                             compression_ratio_threshold=0.3)),
    ("segment_int4", DecodeConfig(max_new_tokens=24, return_timestamps=True,
                                  no_repeat_ngram_size=3,
                                  repetition_penalty=1.1, kv_quant="int4",
                                  compression_ratio_threshold=0.3)),
    ("segment_beams", DecodeConfig(max_new_tokens=16, return_timestamps=True,
                                   num_beams=2, repetition_penalty=1.1))])
def test_evaluate_matches_jax(weights, monkeypatch, tmp_path, level, dcfg):
    jp, tp = weights
    batch = 4
    mel_cfg = MelConfig.whisper(n_mels=W.n_mels)
    # clips of the test config's window: 64 encoder positions, 1.28 s
    kw = dict(num_samples=6, num_classes=4, vocab_size=W.vocab_size,
              duration=2 * W.max_source_positions * mel_cfg.hop_length
              / mel_cfg.sample_rate, seed=5)
    noise = _JaxGumbel(batch)
    monkeypatch.setattr(dec, "gumbel_noise", noise)
    fn = "evaluate_sequence_level" if level == "sequence" \
        else "evaluate_segment_level"
    want = getattr(jev, fn)(
        jp, TINY, mel_cfg, JSynth(**kw).batcher(batch), STYLES,
        tokenizer=JTok(), output_dir=str(tmp_path / "jax"), dcfg=dcfg,
        compute_dtype=jnp.float32)
    got = getattr(ev, fn)(
        tp, TINY, mel_cfg, SyntheticSeq2Seq(**kw).batcher(batch), STYLES,
        tokenizer=ByteTokenizer(), output_dir=str(tmp_path / "port"),
        dcfg=dcfg, compute_dtype=torch.float32, device="cpu")
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert sorted(files) == (["metrics.txt", "predictions.txt"]
                             if level == "sequence" else
                             ["predictions.txt", "segment_evaluation.txt"])
    if level in ("segment", "segment_int4"):
        assert noise.calls > 0          # the fallback re-decoded
        assert got["total_segments"] > kw["num_samples"]
