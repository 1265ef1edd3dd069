"""The port stands alone: it imports nothing of JAX, of the JAX package,
of scikit-learn, safetensors, transformers, huggingface_hub or orbax (the
card's machine has none of them), it loads, saves and serves models
without them,
its copies of the package's JAX-free modules (configs, audio utilities,
the synthetic Expresso data, the micro-batcher) behave as the originals,
and its entry points run on the card unless the caller asks for the CPU.
"""

import dataclasses
import io
import os
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest
import torch

from audio_transformers_tpu.core import config as jcfg
from audio_transformers_tpu.data import expresso as jexp
from audio_transformers_tpu.data import tokenizer as jtok
from audio_transformers_tpu.serve import batching as jbatch
from audio_transformers_tpu.utils import audio as jaudio
from audio_transformers_tpu_torch.core import config as pcfg
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.data import expresso as pexp
from audio_transformers_tpu_torch.data import tokenizer as ptok
from audio_transformers_tpu_torch.infer import pipeline as ppipe
from audio_transformers_tpu_torch.serve import batching as pbatch
from audio_transformers_tpu_torch.serve import http_server
from audio_transformers_tpu_torch.utils import audio as paudio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = ("jax", "audio_transformers_tpu", "sklearn", "safetensors",
            "transformers", "huggingface_hub", "orbax")

_BLOCK = f"""
import sys
for blocked in {_BLOCKED!r}:
    sys.modules[blocked] = None
"""

_IMPORT_ALL = _BLOCK + """
import importlib, pkgutil, runpy
import audio_transformers_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
new = {"audio_transformers_tpu_torch." + m for m in (
    "models.urbansound.model", "train.classifier", "cli.train_classifier",
    "data.urbansound", "data.cache", "ops.specaugment", "train.common",
    "parallel", "parallel.distributed", "parallel.mesh", "parallel.launch",
    "entry", "serve.app")}
assert new <= set(names), sorted(new - set(names))
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
runpy.run_path("tests/test_torch_cuda.py", run_name="test_torch_cuda")
for script in ("parity_rehearsal_torch", "tp_multicard"):
    runpy.run_path(f"scripts/{script}.py", run_name=script)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in blocked_names)
assert not leaked, leaked
print(len(names))
""".replace("blocked_names", repr(_BLOCKED))

# segment and sequence evaluation at the test config on the CPU, with
# jax, the JAX package and sklearn blocked: the metrics and the files
_EVALUATE = _BLOCK + """
import os, sys, tempfile
import torch
from audio_transformers_tpu_torch.core import (DecodeConfig,
                                               EmotionWhisperConfig,
                                               MelConfig, WhisperConfig)
from audio_transformers_tpu_torch.core.params import init
from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
from audio_transformers_tpu_torch.data.tokenizer import ByteTokenizer
from audio_transformers_tpu_torch.infer import evaluate as ev
cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(), num_emotion_classes=3)
params = init(cfg, torch.Generator().manual_seed(0))
mel_cfg = MelConfig.whisper(n_mels=cfg.whisper.n_mels)
data = SyntheticSeq2Seq(num_samples=3, num_classes=3, duration=1.28)
out = tempfile.mkdtemp()
seq = ev.evaluate_sequence_level(
    params, cfg, mel_cfg, data.batcher(2), {0: "a", 1: "b", 2: "c"},
    tokenizer=ByteTokenizer(), output_dir=out, device="cpu",
    dcfg=DecodeConfig(max_new_tokens=6))
seg = ev.evaluate_segment_level(
    params, cfg, mel_cfg, data.batcher(2), {0: "a", 1: "b", 2: "c"},
    tokenizer=ByteTokenizer(), output_dir=out, device="cpu",
    dcfg=DecodeConfig(max_new_tokens=6, return_timestamps=True,
                      kv_quant="int4", compression_ratio_threshold=0.01))
assert seq["samples"] == 3 and seg["total_segments"] >= 3
assert "weighted avg" in seg["report"]
assert "sklearn" not in sys.modules or sys.modules["sklearn"] is None
print(" ".join(sorted(os.listdir(out))))
"""


# model I/O on the CPU with the same packages blocked: an HF directory
# written and loaded back, a checkpoint saved and restored, and the infer
# CLI over both
_MODEL_IO = _BLOCK + """
import os, tempfile
import torch
from audio_transformers_tpu_torch.cli import infer
from audio_transformers_tpu_torch.cli.common import load_pipeline
from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                               WhisperConfig)
from audio_transformers_tpu_torch.core.checkpoint import Checkpointer
from audio_transformers_tpu_torch.core.params import init, leaves_with_path
from audio_transformers_tpu_torch.data.tokenizer import ByteTokenizer
from audio_transformers_tpu_torch.utils.audio import synth_clip
from audio_transformers_tpu_torch.utils.hub import export_hf_dir
# the test config's widths with whisper's vocab and special ids, which
# config.json carries (or implies) exactly
cfg = EmotionWhisperConfig(whisper=WhisperConfig(
    d_model=64, encoder_layers=2, decoder_layers=2, num_heads=2,
    ffn_dim=128, max_source_positions=64, max_target_positions=32),
    num_emotion_classes=3)
params = init(cfg, torch.Generator().manual_seed(0))
root = tempfile.mkdtemp()
hf = export_hf_dir(params, cfg, os.path.join(root, "hf"),
                   style_to_idx={"a": 0, "b": 1, "c": 2})
pipe = load_pipeline(hf, tokenizer=ByteTokenizer(), device="cpu")
for (p, a), (_, b) in zip(leaves_with_path(params),
                          leaves_with_path(pipe.params)):
    assert torch.equal(a, b), p
out = pipe.analyze(synth_clip(1.5, 16000), 16000, segment_duration=1.0,
                   max_new_tokens=4)
assert len(out["segments"]) == 2
assert set(out["segments"][0]["emotion_probs"]) == {"a", "b", "c"}
ck = Checkpointer(os.path.join(root, "ck"))
ck.save(3, {"params": params}, metadata={"cfg": cfg.to_json()},
        best_metric=0.5)
tree, meta, step = ck.restore(like={"params": params})
assert step == 3 and ck.best_step() == 3
for (p, a), (_, b) in zip(leaves_with_path(params),
                          leaves_with_path(tree["params"])):
    assert torch.equal(a, b), p
for path in (hf, ck.directory):
    res = infer.main(["--model_path", path, "--device", "cpu",
                      "--segment_duration", "6.0"])
    assert len(res["segments"]) == 2
print("ok")
"""


# the classifier's CLI at a small width on the CPU with the same packages
# blocked: training, checkpoints, resume and the safetensors export
_CLASSIFIER = _BLOCK + """
import os, sys, tempfile
import torch
torch.set_num_threads(1)   # tiny tensors, beside other test processes
from audio_transformers_tpu_torch.cli import train_classifier
from audio_transformers_tpu_torch.utils.safetensors import load_file
out = tempfile.mkdtemp()
args = ["--device", "cpu", "--dataset", "synthetic", "--limit_samples", "10",
        "--batch_size", "4", "--conv_dim", "16", "--encoder_dim", "16",
        "--num_encoder_blocks", "1", "--num_heads", "2", "--compute_dtype",
        "float32", "--num_workers", "0", "--spec_augment", "--output_dir", out]
train_classifier.main(args + ["--epochs", "1"])
res = train_classifier.main(args + ["--epochs", "2"])
assert [r["epoch"] for r in res["history"]] == [2], res["history"]
sd = load_file(os.path.join(out, "best_model.safetensors"))
assert sd["position_embeddings"].shape == (1000, 16)
assert "conv_module.bn1.running_var" in sd
print("ok")
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 30


def test_evaluation_stands_alone():
    out = subprocess.run([sys.executable, "-c", _EVALUATE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["metrics.txt", "predictions.txt",
                                  "segment_evaluation.txt"]


def test_classifier_stands_alone():
    out = subprocess.run([sys.executable, "-c", _CLASSIFIER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


def test_model_io_stands_alone():
    out = subprocess.run([sys.executable, "-c", _MODEL_IO], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def _pairs():
    sizes = ["tiny", "base", "small", "medium", "large", "large-v3", "test"]
    pairs = [(f"whisper {n}", lambda m, n=n: m.WhisperConfig.by_name(n))
             for n in sizes]
    pairs += [
        ("whisper test()", lambda m: m.WhisperConfig.test()),
        ("whisper test(512)", lambda m: m.WhisperConfig.test(512)),
        ("mel whisper()", lambda m: m.MelConfig.whisper()),
        ("mel urbansound()", lambda m: m.MelConfig.urbansound()),
        ("emotion", lambda m: m.EmotionWhisperConfig()),
        ("decode", lambda m: m.DecodeConfig()),
        ("train", lambda m: m.TrainConfig()),
        ("optimizer", lambda m: m.OptimizerConfig()),
        ("data", lambda m: m.DataConfig()),
        ("urbansound", lambda m: m.UrbanSoundConfig()),
    ]
    return pairs


@pytest.mark.parametrize("name,make", _pairs(), ids=[p[0] for p in _pairs()])
def test_config_copies_equal_the_package(name, make):
    got, want = make(pcfg), make(jcfg)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    # a JSON round trip through the copy gives the copy back
    import json
    assert type(got).from_dict(json.loads(got.to_json())) == got


def test_config_properties_match():
    for name in ("tiny", "large-v3", "test"):
        g, w = pcfg.WhisperConfig.by_name(name), \
            jcfg.WhisperConfig.by_name(name)
        assert g.head_dim == w.head_dim
    g, w = pcfg.MelConfig.whisper(), jcfg.MelConfig.whisper()
    assert (g.n_freqs, g.effective_f_max, g.num_frames(480000)) \
        == (w.n_freqs, w.effective_f_max, w.num_frames(480000))
    with pytest.raises(ValueError):
        pcfg.WhisperConfig.by_name("huge")


# --------------------------------------------------------------------------
# audio utilities
# --------------------------------------------------------------------------


@pytest.mark.parametrize("orig,target", [(8000, 16000), (44100, 16000),
                                         (16000, 16000), (22050, 16000)])
def test_resample_matches(orig, target):
    x = np.random.default_rng(orig).standard_normal(orig // 3) \
        .astype(np.float32)
    got, want = paudio.resample(x, orig, target), \
        jaudio.resample(x, orig, target)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(1000,), (2, 1000), (1000, 2), (8, 300)])
def test_to_mono_matches(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    assert np.array_equal(paudio.to_mono(x), jaudio.to_mono(x))


def _wav(audio, sr, width):
    buf = io.BytesIO()
    a = np.clip(audio, -1, 1)
    pcm = {1: ((a * 127) + 128).astype(np.uint8),
           2: (a * 32767).astype("<i2"),
           4: (a * 2147483647).astype("<i4")}[width]
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[0] if pcm.ndim > 1 else 1)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes() if pcm.ndim > 1 else pcm.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_decode_audio_bytes_matches(width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    audio = 0.5 * rng.standard_normal((channels, 4000) if channels > 1
                                      else 4000)
    data = _wav(audio, 16000, width)
    (ga, gsr), (wa, wsr) = paudio.decode_audio_bytes(data), \
        jaudio.decode_audio_bytes(data)
    assert gsr == wsr == 16000 and np.array_equal(ga, wa)
    with pytest.raises(ValueError):
        paudio.decode_audio_bytes(b"OggS" + bytes(40))


@pytest.mark.parametrize("duration,sr,freq,seed", [(1.0, 16000, 440.0, 0),
                                                   (2.5, 8000, 220.0, 3)])
def test_synth_clip_matches(duration, sr, freq, seed):
    assert np.array_equal(
        paudio.synth_clip(duration, sr, freq=freq, seed=seed),
        jaudio.synth_clip(duration, sr, freq=freq, seed=seed))


# --------------------------------------------------------------------------
# the synthetic Expresso data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_workers", [0, 2])
def test_synthetic_expresso_splits_and_batches_match(num_workers):
    kw = dict(num_samples=60, duration=0.5, vocab_size=1024, seed=7)
    got = pexp.SyntheticExpresso(ptok.ByteTokenizer(), **kw).splits(seed=7)
    want = jexp.SyntheticExpresso(jtok.ByteTokenizer(), **kw).splits(seed=7)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert list(g.indices) == list(w.indices)
        gb, wb = g.batcher(4, num_workers=num_workers), w.batcher(4)
        batches = [(list(gb.train_epochs(epoch=e)),
                    list(wb.train_epochs(epoch=e))) for e in (0, 1)]
        batches.append((list(gb.eval_batches()), list(wb.eval_batches())))
        for gs, ws in batches:
            assert len(gs) == len(ws)
            for a, b in zip(gs, ws):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    assert np.array_equal(a[k], b[k]), k


def test_tokenizers_match():
    text = "héllo, wörld"
    g, w = ptok.ByteTokenizer(), jtok.ByteTokenizer()
    assert g.encode(text) == w.encode(text)
    assert g.decode(g.encode(text) + [0, 3]) == w.decode(w.encode(text)
                                                          + [0, 3])


# --------------------------------------------------------------------------
# the micro-batcher
# --------------------------------------------------------------------------


def _batcher_run(cls):
    calls = []

    def run(windows, *, max_new_tokens):
        calls.append((windows.shape[0], max_new_tokens))
        return ([f"{max_new_tokens}:{x:.3f}" for x in windows[:, 0]],
                windows[:, :3] * 2.0)

    b = cls(run, max_rows=8, max_wait_ms=200.0)
    rng = np.random.default_rng(5)
    reqs = [(rng.standard_normal((n, 16)).astype(np.float32), t)
            for n, t in ((2, 16), (3, 16), (1, 32), (4, 16))]
    futs = [None] * len(reqs)

    def submit(i):
        futs[i] = b.submit(reqs[i][0], max_new_tokens=reqs[i][1])

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results = [f.result(timeout=30) for f in futs]
    direct = b.runner(reqs[0][0], max_new_tokens=8)
    with pytest.raises(ValueError):
        b.submit(np.zeros(4, np.float32), max_new_tokens=8)
    b.close()
    return results, direct, b.stats, calls


def test_micro_batcher_matches():
    got, want = _batcher_run(pbatch.MicroBatcher), \
        _batcher_run(jbatch.MicroBatcher)
    for (gt, gp), (wt, wp) in zip(got[0], want[0]):
        assert gt == wt and np.array_equal(gp, wp)
    assert got[1][0] == want[1][0] and np.array_equal(got[1][1], want[1][1])
    assert got[2]["requests"] == want[2]["requests"] == 5
    assert got[2]["rows"] == want[2]["rows"] == 12


# --------------------------------------------------------------------------
# entry points: the card unless the caller asks for the CPU
# --------------------------------------------------------------------------

TEST_CFG = pcfg.EmotionWhisperConfig(whisper=pcfg.WhisperConfig.test(),
                                     num_emotion_classes=4)


def _pipeline(**kw):
    params = cp.init(TEST_CFG, torch.Generator().manual_seed(0))
    return ppipe.EmotionWhisperPipeline(params, TEST_CFG, **kw)


def _build(**kw):
    return http_server.build_pipeline(config="test", **kw)


def _self_test(**kw):
    return ppipe.self_test(duration=1.0, **kw)


_US = pcfg.UrbanSoundConfig(num_classes=4, conv_dim=16, encoder_dim=16,
                           num_encoder_blocks=1, num_heads=2, dropout=0.0,
                           cnn_dims=(16,))


class _OneThread:
    """One intra-op thread while the classifier's tiny steps run beside
    other test processes."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _train_classifier(**kw):
    from audio_transformers_tpu_torch.data.synthetic import \
        SyntheticClassification
    from audio_transformers_tpu_torch.train.classifier import \
        train_classifier
    ds = SyntheticClassification(num_samples=8, num_classes=4, duration=0.5)
    tcfg = pcfg.TrainConfig(batch_size=4, num_epochs=1,
                            compute_dtype="float32",
                            optimizer=pcfg.OptimizerConfig(name="adam"))
    with _OneThread():
        return train_classifier(_US, pcfg.MelConfig.urbansound(), tcfg,
                                ds.batcher(4), ds.batcher(4), **kw)


def _cli_train_classifier(**kw):
    import tempfile

    from audio_transformers_tpu_torch.cli import train_classifier
    args = ["--dataset", "synthetic", "--limit_samples", "8",
            "--batch_size", "4", "--epochs", "1", "--conv_dim", "16",
            "--encoder_dim", "16", "--num_encoder_blocks", "1",
            "--num_heads", "2", "--compute_dtype", "float32",
            "--num_workers", "0", "--output_dir", tempfile.mkdtemp()]
    if "device" in kw:
        args += ["--device", kw["device"]]
    with _OneThread():
        return train_classifier.main(args)


ENTRY_POINTS = {"pipeline": _pipeline, "build_pipeline": _build,
                "self_test": _self_test,
                "train_classifier": _train_classifier,
                "cli.train_classifier": _cli_train_classifier}
# the classifier's entry points return the trainer's results
TRAINERS = ("train_classifier", "cli.train_classifier")


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_by_default(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(entry):
    got = ENTRY_POINTS[entry](device="cpu")
    if entry in TRAINERS:
        assert len(got["history"]) == 1
        assert np.isfinite(got["history"][0]["train/loss"])
        assert {t.device.type for _, t in cp.leaves_with_path(
            got["params"])} == {"cpu"}
        return
    if entry == "self_test":
        out = got
    else:
        assert got.device.type == "cpu"
        assert got.compute_dtype == torch.float32
        out = got.analyze(paudio.synth_clip(1.2, 16000), 16000,
                          segment_duration=1.0, max_new_tokens=4)
    assert isinstance(out["transcription"], str)
    probs = out["segments"][0]["emotion_probs"]
    assert abs(sum(probs.values()) - 1.0) < 1e-4


def test_server_cli_defaults_to_the_card():
    seen = {}

    def fake_build(**kw):
        seen.update(kw)
        raise SystemExit(0)

    orig = http_server.build_pipeline
    http_server.build_pipeline = fake_build
    try:
        for argv, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(SystemExit):
                http_server.main(argv)
            assert seen["device"] == want
    finally:
        http_server.build_pipeline = orig
