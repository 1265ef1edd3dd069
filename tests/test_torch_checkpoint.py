"""The port's checkpoints (`core/checkpoint.py`) against the JAX package's
orbax Checkpointer, and the trainer's checkpoints/ and resume/
directories, on the CPU at the test config in float32.

  Checkpointer: round trip with dtypes kept; kept steps and best step
    equal JAX's over sequences of metrics; the actionable structure error;
    label maps and export_json byte-equal to JAX's
  train_whisper_emotion: 3 epochs straight against 2 epochs, a cut, and
    a resume to 3: params, optimizer state and the metric rows (timing
    aside) bit for bit; a resume with nothing left to train returns the
    best checkpoint's params; from_checkpoint reads the metadata
  train_whisper --pretrained starts from an HF directory's weights;
    --hf_repo_id exports the best epoch and uploads it (mocked Hub)
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core import checkpoint as jck
from audio_transformers_tpu.infer import pipeline as jpipe
from audio_transformers_tpu_torch.cli import infer as cli_infer
from audio_transformers_tpu_torch.cli import train_whisper
from audio_transformers_tpu_torch.core import checkpoint as ck
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig,
                                                      OptimizerConfig,
                                                      TrainConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.train import whisper_emotion as tw
from audio_transformers_tpu_torch.utils import hub

W = WhisperConfig.test()
TINY = EmotionWhisperConfig(whisper=W, num_emotion_classes=4)
TIMING = ("clips_per_sec", "data_wait_s", "wall_time")


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "h": torch.randn(3, generator=g).to(torch.bfloat16),
                  "l": [torch.arange(2, dtype=torch.int64),
                        torch.ones(2, 2, dtype=torch.float16)]}}


def _assert_same(got, want):
    g, w = cp.leaves_with_path(got), cp.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), p
        else:
            assert a == b, p


# --------------------------------------------------------------------------
# the Checkpointer
# --------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    c = ck.Checkpointer(str(tmp_path), max_to_keep=2)
    tree = _tree(0)
    c.save(1, tree, metadata={"epoch": 1, "note": "x",
                              "best": float("inf")}, best_metric=0.5)
    got, meta, step = c.restore()
    assert step == 1 and meta == {"epoch": 1, "note": "x",
                                  "best": float("inf")}
    _assert_same(got, tree)
    # `like` gives each leaf its dtype; the structure must match
    like = cp.map_tensors(tree, lambda t: t.double()
                          if t.is_floating_point() else t)
    got, _, _ = c.restore(step=1, like=like)
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], tree["a"].double())
    c.save(2, _tree(1))
    assert c.restore(step=2)[1] is None
    with pytest.raises(ValueError, match="already exists"):
        c.save(2, _tree(1))
    c.close()


def test_restore_without_checkpoints(tmp_path):
    c = ck.Checkpointer(str(tmp_path / "new"))
    assert c.latest_step() is None and c.best_step() is None
    with pytest.raises(FileNotFoundError):
        c.restore()


def test_a_partial_write_is_no_step(tmp_path):
    c = ck.Checkpointer(str(tmp_path), max_to_keep=3)
    c.save(1, _tree(0))
    # what a crash leaves behind: a temporary directory and a step
    # directory without its tree
    os.makedirs(tmp_path / ".tmp-2-123")
    os.makedirs(tmp_path / "3")
    assert c.latest_step() == 1
    c.save(4, _tree(1))
    assert c.latest_step() == 4


SEQUENCES = {
    "reference": ("max", 2, [(1, 0.3), (2, 0.9), (3, 0.5)]),
    "min_keep2": ("min", 2, [(1, 0.3), (2, 0.9), (3, 0.5), (4, 0.1)]),
    "max_keep1": ("max", 1, [(1, 0.3), (2, 0.9), (3, 0.5)]),
    "min_keep3": ("min", 3, [(s, m) for s, m in enumerate(
        [1.0, 0.8, 0.9, 0.7, 0.75, 0.6], start=1)]),
    "ties": ("min", 2, [(1, 0.5), (2, 0.5), (3, 0.5)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_retention_and_best_match_jax(tmp_path, name):
    mode, keep, seq = SEQUENCES[name]
    jc = jck.Checkpointer(str(tmp_path / "jax"), max_to_keep=keep,
                          best_mode=mode)
    pc = ck.Checkpointer(str(tmp_path / "port"), max_to_keep=keep,
                         best_mode=mode)
    for step, metric in seq:
        jc.save(step, {"a": jnp.full(3, step, jnp.float32)},
                best_metric=metric)
        pc.save(step, {"a": torch.full((3,), float(step))},
                best_metric=metric)

    def kept(path):
        return sorted(int(d) for d in os.listdir(path) if d.isdigit())

    assert kept(tmp_path / "port") == kept(tmp_path / "jax")
    assert pc.best_step() == jc.best_step()
    assert pc.latest_step() == jc.latest_step()
    if name == "reference":
        assert pc.best_step() == 2 and 2 in kept(tmp_path / "port")
    jc.close()


def test_steps_without_a_metric_keep_the_latest(tmp_path):
    # orbax keeps every step saved without a metric under best_fn; the
    # port keeps the latest max_to_keep (resume/ holds one step)
    c = ck.Checkpointer(str(tmp_path), max_to_keep=1)
    for step in (1, 2, 3):
        c.save(step, _tree(step), metadata={"epoch": step})
    assert sorted(os.listdir(tmp_path)) == ["3"]
    assert c.latest_step() == 3 and c.best_step() is None
    assert c.restore()[1] == {"epoch": 3}


def test_structure_mismatch_is_actionable(tmp_path):
    c = ck.Checkpointer(str(tmp_path))
    c.save(1, _tree(0))
    stale = _tree(0)
    stale["b"]["extra"] = torch.zeros(3)
    with pytest.raises(ValueError, match="older version"):
        c.restore(like=stale)
    wider = _tree(0)
    wider["a"] = torch.zeros(4, 9)
    with pytest.raises(ValueError, match=str(tmp_path)):
        c.restore(like=wider)


def test_label_map_and_json_files_match_jax(tmp_path):
    mapping = {"happy": 0, "sad": 1, "a: weird name": 2, "ünï": 3}
    ck.save_label_map(str(tmp_path / "p.txt"), mapping)
    jck.save_label_map(str(tmp_path / "j.txt"), mapping)
    assert (tmp_path / "p.txt").read_bytes() \
        == (tmp_path / "j.txt").read_bytes()
    assert ck.load_label_map(str(tmp_path / "j.txt")) == mapping \
        == jck.load_label_map(str(tmp_path / "p.txt"))
    obj = {"b": [1, 2.5], "a": {"z": None, "y": "s"}}
    ck.export_json(str(tmp_path / "p.json"), obj)
    jck.export_json(str(tmp_path / "j.json"), obj)
    assert (tmp_path / "p.json").read_bytes() \
        == (tmp_path / "j.json").read_bytes()


# --------------------------------------------------------------------------
# the trainer's checkpoints/ and resume/
# --------------------------------------------------------------------------


class Preempted(Exception):
    pass


class _CutBatcher:
    """A batcher whose epoch `at` never starts: the job is preempted."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at
        self.steps_per_epoch = inner.steps_per_epoch

    def train_epochs(self, *, epoch):
        if epoch == self.at:
            raise Preempted(epoch)
        return self.inner.train_epochs(epoch=epoch)


def _data(n, seed):
    mel_cfg = MelConfig.whisper()
    dur = 2 * W.max_source_positions * mel_cfg.hop_length \
        / mel_cfg.sample_rate
    return SyntheticSeq2Seq(num_samples=n, num_classes=4,
                            vocab_size=W.vocab_size, max_label_len=8,
                            duration=dur, seed=seed,
                            bos_id=W.decoder_start_token_id,
                            eos_id=W.eos_token_id, pad_id=W.pad_token_id)


TCFG = TrainConfig(batch_size=8, num_epochs=3, compute_dtype="float32",
                   keep_checkpoints=2,
                   optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                             weight_decay=0.01,
                                             schedule="linear_warmup_decay",
                                             warmup_fraction=0.25))


def _train(out_dir, train_batcher=None):
    return tw.train_whisper_emotion(
        TINY, MelConfig.whisper(), TCFG,
        train_batcher or _data(16, 1).batcher(8), _data(12, 2).batcher(8),
        device="cpu", output_dir=out_dir, style_to_idx={"a": 0, "b": 1,
                                                        "c": 2, "d": 3})


def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in TIMING} for line in f]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("straight"))
    return out_dir, _train(out_dir)


def test_resume_equals_an_uninterrupted_run(straight, tmp_path):
    out_dir, want = straight
    cut_dir = str(tmp_path / "cut")
    with pytest.raises(Preempted):
        _train(cut_dir, _CutBatcher(_data(16, 1).batcher(8), at=2))
    assert sorted(os.listdir(os.path.join(cut_dir, "resume"))) == ["4"]
    got = _train(cut_dir)
    assert [r["epoch"] for r in got["history"]] == [3]
    _assert_same(cp.map_tensors(got["params"], lambda t: t.detach()),
                 cp.map_tensors(want["params"], lambda t: t.detach()))
    _assert_same(got["optimizer"].state_dict(),
                 want["optimizer"].state_dict())
    assert got["optimizer"].count == 6
    assert _rows(cut_dir) == _rows(out_dir)
    assert got["best_val_loss"] == want["best_val_loss"]
    _assert_same(got["best_params"], want["best_params"])


def test_resume_with_nothing_left_returns_the_best(straight):
    out_dir, first = straight
    assert first["best_val_loss"] == min(h["val/loss"]
                                         for h in first["history"])
    again = _train(out_dir)
    assert again["history"] == []
    assert again["best_val_loss"] == first["best_val_loss"]
    _assert_same(again["best_params"], first["best_params"])
    c = ck.Checkpointer(os.path.join(out_dir, "checkpoints"))
    best, meta, step = c.restore(step=c.best_step())
    _assert_same(best["params"], first["best_params"])
    assert meta["val_loss"] == first["best_val_loss"]
    kept = sorted(int(d) for d in os.listdir(c.directory))
    assert len(kept) <= TCFG.keep_checkpoints and step in kept


def test_from_checkpoint_reads_the_metadata(straight):
    out_dir, first = straight
    pipe = EmotionWhisperPipeline.from_checkpoint(
        os.path.join(out_dir, "checkpoints"), device="cpu", kv_quant="int8")
    assert pipe.cfg == TINY and pipe.mel_cfg == MelConfig.whisper()
    assert pipe.idx_to_label == {0: "a", 1: "b", 2: "c", 3: "d"}
    assert pipe.kv_quant == "int8"
    _assert_same(cp.map_tensors(pipe.params, lambda t: t.detach()),
                 first["best_params"])
    # the resume directory's tree has params too (no metadata config)
    resumed = EmotionWhisperPipeline.from_checkpoint(
        os.path.join(out_dir, "resume"), device="cpu")
    assert resumed.cfg.num_emotion_classes == 4
    out = cli_infer.main(["--model_path", os.path.join(out_dir,
                                                       "checkpoints"),
                          "--device", "cpu", "--segment_duration", "0.5",
                          "--audio", _wav(out_dir)])
    assert len(out["segments"]) == 3
    assert set(out["segments"][0]["emotion_probs"]) == {"a", "b", "c", "d"}


@pytest.mark.parametrize("which", ["evaluate", "evaluate_simple"])
def test_evaluate_clis_over_a_checkpoint(straight, tmp_path, which):
    """The evaluation CLIs over the trainer's checkpoints/ give what the
    evaluation functions give on the best checkpoint's params."""
    from audio_transformers_tpu_torch.cli import common
    from audio_transformers_tpu_torch.cli import evaluate as cli_eval
    from audio_transformers_tpu_torch.cli import evaluate_simple
    from audio_transformers_tpu_torch.infer import evaluate as ev
    cli = {"evaluate": cli_eval, "evaluate_simple": evaluate_simple}[which]
    out_dir, first = straight
    argv = ["--model_path", os.path.join(out_dir, "checkpoints"),
            "--num_samples", "20", "--batch_size", "4", "--device", "cpu",
            "--output_dir", str(tmp_path / "cli")]
    got = cli.main(argv)
    args = cli.parse_args(argv)
    tok = common.get_tokenizer(None)
    dur = 2 * W.max_source_positions * 160 / 16000
    _, _, test_ds, styles = common.build_expresso_splits(
        args, tok, duration=dur, vocab_size=W.vocab_size)
    fn = ev.evaluate_segment_level if which == "evaluate" \
        else ev.evaluate_sequence_level
    dcfg = (DecodeConfig(max_new_tokens=256, return_timestamps=True,
                         no_repeat_ngram_size=3, repetition_penalty=1.1,
                         compression_ratio_threshold=2.4)
            if which == "evaluate" else
            DecodeConfig(max_new_tokens=100, no_repeat_ngram_size=3,
                         repetition_penalty=1.15))
    want = fn(first["best_params"], TINY, MelConfig.whisper(),
              test_ds.batcher(4), {v: k for k, v in styles.items()},
              tokenizer=tok, output_dir=str(tmp_path / "fn"), dcfg=dcfg,
              device="cpu")
    assert got == want

    def files(d):
        return {p.name: p.read_bytes() for p in sorted(d.iterdir())}

    assert files(tmp_path / "cli") == files(tmp_path / "fn")


def _wav(out_dir):
    import wave
    path = os.path.join(out_dir, "clip.wav")
    pcm = (np.sin(np.arange(22000) * 0.05) * 8000).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return path


# --------------------------------------------------------------------------
# train_whisper --pretrained and --hf_repo_id
# --------------------------------------------------------------------------


def _cli(out_dir, *extra):
    return ["--device", "cpu", "--model_size", "test", "--compute_dtype",
            "float32", "--num_epochs", "1", "--batch_size", "8",
            "--num_samples", "24", "--num_workers", "0", "--output_dir",
            str(out_dir), *extra]


@pytest.mark.parametrize("classes", [9, 4])
def test_pretrained_starts_from_the_hf_weights(tmp_path, monkeypatch,
                                                capsys, classes):
    # the synthetic Expresso data has 9 styles: a 9-class head is kept, a
    # 4-class one is re-initialised
    cfg = EmotionWhisperConfig(whisper=W, num_emotion_classes=classes)
    params = cp.init(cfg, torch.Generator().manual_seed(7))
    hf_dir = hub.export_hf_dir(params, cfg, str(tmp_path / "hf"))
    seen = {}
    orig = tw.train_whisper_emotion

    def spy(*args, **kw):
        seen["init"] = cp.map_tensors(kw["init_params"],
                                      lambda t: t.clone())
        return orig(*args, **kw)

    monkeypatch.setattr(tw, "train_whisper_emotion", spy)
    out = train_whisper.main(_cli(tmp_path / "run", "--pretrained", hf_dir))
    _assert_same(seen["init"]["whisper"], params["whisper"])
    said = capsys.readouterr().out
    if classes == 9:
        _assert_same(seen["init"]["emotion_head"], params["emotion_head"])
        assert "reinitializing" not in said
    else:
        assert seen["init"]["emotion_head"]["w"].shape == (9, W.d_model)
        assert "pretrained emotion head has 4 classes but the dataset " \
               "has 9; reinitializing the head" in said
    assert out["optimizer"].count > 0


def test_hf_repo_id_exports_and_uploads(tmp_path, monkeypatch):
    uploads = []

    class FakeApi:
        def __init__(self, token=None):
            self.token = token

        def create_repo(self, repo_id, exist_ok=False):
            pass

        def upload_folder(self, folder_path, repo_id, path_in_repo,
                          commit_message):
            uploads.append((folder_path, repo_id, sorted(
                os.listdir(folder_path))))

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=FakeApi))
    monkeypatch.setenv("HF_ACCESS", "tkn")
    out = train_whisper.main(_cli(tmp_path, "--hf_repo_id", "user/repo"))
    export = str(tmp_path / "hf_export")
    assert uploads == [(export, "user/repo",
                        ["README.md", "config.json", "generation_config.json",
                         "model.safetensors", "style_to_id.txt"])]
    # the JAX package loads the export back to the best epoch's params
    jp = jpipe.EmotionWhisperPipeline.from_hf_dir(export)
    want = cp.to_jax_params(out["best_params"])
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                              jax.tree_util.tree_leaves_with_path(
                                  jp.params)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))
