"""Model I/O of the port against the JAX package and the `safetensors`
package on the CPU: HF state dicts, configs, the port's safetensors
reader and writer, HF export, HF directories in both directions, the
pipeline's loaders, the CLIs over them and the Hub upload.

  from_torch_state_dict, to_torch_state_dict    bit for bit
  config_from_json, config_from_hf              equal
  safetensors reader, writer                    bit for bit, dtypes kept
  export_hf_dir's config.json,
    generation_config.json, style_to_id.txt     byte-equal to JAX's
  JAX export -> port from_hf_dir -> decode      tokens equal; emotion
                                                probabilities <= 1e-5
                                                (float32, as
                                                test_torch_pipeline.py)
  cli.evaluate, cli.evaluate_simple             files byte-equal to the
                                                JAX CLIs' (float32)

The HF model here is whisper at the test config's widths with whisper's
vocab and special ids, so that its config.json round-trips exactly
(`config_from_json` takes the timestamp and task ids from the vocab).
"""

import dataclasses
import json
import os
import struct
import sys
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as stn
import safetensors.torch as stt
import torch
from transformers import WhisperConfig as HFConfig
from transformers import WhisperForConditionalGeneration

from audio_transformers_tpu.cli import common as jcommon
from audio_transformers_tpu.cli import evaluate as jcli_eval
from audio_transformers_tpu.cli import evaluate_simple as jcli_simple
from audio_transformers_tpu.core import config as jcfg
from audio_transformers_tpu.infer import pipeline as jpipe
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.models.whisper import load as jload
from audio_transformers_tpu.utils import hub as jhub
from audio_transformers_tpu_torch.cli import common
from audio_transformers_tpu_torch.cli import evaluate as cli_eval
from audio_transformers_tpu_torch.cli import evaluate_simple as cli_simple
from audio_transformers_tpu_torch.cli import infer as cli_infer
from audio_transformers_tpu_torch.core import config as pcfg
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import DecodeConfig
from audio_transformers_tpu_torch.data.tokenizer import ByteTokenizer
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import load
from audio_transformers_tpu_torch.serve import http_server
from audio_transformers_tpu_torch.utils import hub
from audio_transformers_tpu_torch.utils import safetensors as st
from audio_transformers_tpu_torch.utils.audio import synth_clip

from test_torch_evaluate import _JaxGumbel

GEOMETRY = dict(vocab_size=51865, n_mels=80, d_model=64, encoder_layers=2,
                decoder_layers=2, num_heads=2, ffn_dim=128,
                max_source_positions=64, max_target_positions=32)
JW = jcfg.WhisperConfig(**GEOMETRY)
PW = pcfg.WhisperConfig(**GEOMETRY)
JCFG = jcfg.EmotionWhisperConfig(whisper=JW, num_emotion_classes=4)
PCFG = pcfg.EmotionWhisperConfig(whisper=PW, num_emotion_classes=4)
STYLES = {"angry": 0, "happy": 1, "sad": 2, "a: odd name": 3}
PROB_TOL = 1e-5


def _hf_config(w=JW):
    return HFConfig(
        vocab_size=w.vocab_size, num_mel_bins=w.n_mels, d_model=w.d_model,
        encoder_layers=w.encoder_layers, decoder_layers=w.decoder_layers,
        encoder_attention_heads=w.num_heads,
        decoder_attention_heads=w.num_heads,
        encoder_ffn_dim=w.ffn_dim, decoder_ffn_dim=w.ffn_dim,
        max_source_positions=w.max_source_positions,
        max_target_positions=w.max_target_positions,
        pad_token_id=w.pad_token_id, bos_token_id=w.bos_token_id,
        eos_token_id=w.eos_token_id,
        decoder_start_token_id=w.decoder_start_token_id)


def _equal_trees(got, want):
    """Port trees: the same paths (in any order), bit-equal float32."""
    g, w = dict(cp.leaves_with_path(got)), dict(cp.leaves_with_path(want))
    assert sorted(g, key=str) == sorted(w, key=str)
    for path, t in w.items():
        assert g[path].dtype == t.dtype == torch.float32, path
        assert torch.equal(g[path], t), path


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    return WhisperForConditionalGeneration(_hf_config()).eval()


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(3), JCFG))


@pytest.fixture(scope="module")
def jax_export(jparams, tmp_path_factory):
    """An HF directory written by the JAX package."""
    out = str(tmp_path_factory.mktemp("jax_export"))
    jhub.export_hf_dir(jparams, JCFG, out, style_to_idx=STYLES,
                       val_loss=1.25)
    return out


# --------------------------------------------------------------------------
# HF state dicts and configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["plain", "wrapper"])
@pytest.mark.parametrize("values", ["torch", "numpy"])
def test_state_dict_matches_jax_loader(hf_model, form, values):
    sd = hf_model.state_dict()
    if form == "wrapper":
        sd = {"whisper." + k: v for k, v in sd.items()}
        g = torch.Generator().manual_seed(1)
        sd["emotion_classifier.weight"] = torch.randn(4, 64, generator=g)
        sd["emotion_classifier.bias"] = torch.randn(4, generator=g)
    if values == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    got, got_head = load.from_torch_state_dict(sd, PW)
    want, want_head = jload.from_torch_state_dict(sd, JW)
    _equal_trees(got, cp.from_jax_params(want))
    if form == "plain":
        assert got_head is None and want_head is None
    else:
        _equal_trees(got_head, cp.from_jax_params(want_head))
        assert got_head["w"].shape == (4, 64)
    # the port's init order, so that every tree of the port agrees
    init = cp.init_whisper(PW, torch.Generator().manual_seed(0))
    assert [p for p, _ in cp.leaves_with_path(got)] \
        == [p for p, _ in cp.leaves_with_path(init)]


def _json_cases():
    return {"empty": {},
            "full": {"vocab_size": 51865, "num_mel_bins": 80,
                     "d_model": 64, "encoder_layers": 2, "decoder_layers": 3,
                     "encoder_attention_heads": 2, "encoder_ffn_dim": 128,
                     "max_source_positions": 64, "max_target_positions": 32,
                     "pad_token_id": 7, "bos_token_id": 8, "eos_token_id": 9,
                     "decoder_start_token_id": 10},
            "large-v3": {"vocab_size": 51866, "num_mel_bins": 128},
            "partial": {"d_model": 512, "encoder_layers": 6}}


@pytest.mark.parametrize("case", sorted(_json_cases()))
def test_config_from_json_matches_jax(case):
    d = _json_cases()[case]
    got, want = load.config_from_json(d), jload.config_from_json(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("vocab", [51865, 51866])
def test_config_from_hf_matches_jax(vocab):
    hf = _hf_config(jcfg.WhisperConfig(**{**GEOMETRY, "vocab_size": vocab}))
    got, want = load.config_from_hf(hf), jload.config_from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_size == vocab


# --------------------------------------------------------------------------
# the safetensors reader and writer
# --------------------------------------------------------------------------


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "h": rng.standard_normal(7).astype(np.float16),
            "i": rng.integers(-9, 9, (2, 2, 3)).astype(np.int32),
            "l": rng.integers(-2**40, 2**40, 3).astype(np.int64),
            "scalar": np.array(1.5, np.float32),
            "empty": np.zeros((0, 4), np.float32)}


@pytest.mark.parametrize("metadata", [None, {"format": "pt", "k": "v"}])
def test_reader_matches_safetensors(tmp_path, metadata):
    path = str(tmp_path / "x.safetensors")
    stn.save_file(_arrays(0), path, metadata=metadata)
    got, want = st.load_file(path), stn.load_file(path)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].numpy().dtype == a.dtype, k
        assert got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)


def test_reader_matches_safetensors_bf16(tmp_path):
    path = str(tmp_path / "b.safetensors")
    g = torch.Generator().manual_seed(2)
    tensors = {"b": torch.randn(9, 3, generator=g).to(torch.bfloat16),
               "f": torch.randn(4, generator=g)}
    stt.save_file(tensors, path)
    got = st.load_file(path)
    for k, t in stt.load_file(path).items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_writer_reads_back_through_safetensors(tmp_path, metadata):
    path = str(tmp_path / "y.safetensors")
    arrays = _arrays(1)
    tensors = {k: torch.from_numpy(a) for k, a in arrays.items()}
    tensors["bf"] = torch.randn(5, 2).to(torch.bfloat16)
    st.save_file(tensors, path, metadata=metadata)
    (n,) = struct.unpack("<Q", open(path, "rb").read(8))
    assert n % 8 == 0
    back = stt.load_file(path)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    without_bf = dict(tensors)
    del without_bf["bf"]
    st.save_file(without_bf, path, metadata=metadata)
    for k, a in stn.load_file(path).items():
        assert a.dtype == arrays[k].dtype
        np.testing.assert_array_equal(a, arrays[k], err_msg=k)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert header.get("__metadata__") == metadata


def test_reader_refuses_what_it_cannot_take(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    stn.save_file({"d": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        st.load_file(path)
    with pytest.raises(ValueError, match="dtype"):
        st.save_file({"d": torch.zeros(3, dtype=torch.float64)}, path)
    bad = str(tmp_path / "cut.safetensors")
    stn.save_file({"w": np.zeros(64, np.float32)}, bad)
    data = open(bad, "rb").read()
    open(bad, "wb").write(data[:-4])
    with pytest.raises(ValueError, match="offsets"):
        st.load_file(bad)


def test_load_safetensors_finds_the_weights(tmp_path, hf_model):
    sd = {k: v.contiguous() for k, v in hf_model.state_dict().items()}
    st_dir, bin_dir, sharded = (tmp_path / n for n in ("st", "bin", "shard"))
    for d in (st_dir, bin_dir, sharded):
        d.mkdir()
    st.save_file(sd, str(st_dir / "model.safetensors"))
    torch.save(sd, bin_dir / "pytorch_model.bin")
    (sharded / "model.safetensors.index.json").write_text("{}")
    for got in (load.load_safetensors(str(st_dir)),
                load.load_safetensors(str(st_dir / "model.safetensors")),
                load.load_safetensors(str(bin_dir))):
        assert sorted(got) == sorted(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError, match="sharded"):
        load.load_safetensors(str(sharded))


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", ["whisper.", ""])
def test_to_torch_state_dict_matches_jax(jparams, prefix):
    got = hub.to_torch_state_dict(cp.from_jax_params(jparams), PCFG,
                                  wrapper_prefix=prefix)
    want = jhub.to_torch_state_dict(jparams, JCFG, wrapper_prefix=prefix)
    assert list(got) == list(want)
    for k, a in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    assert f"{prefix}proj_out.weight" in got


def test_port_export_loads_in_jax(jparams, jax_export, tmp_path):
    out = str(tmp_path / "port")
    hub.export_hf_dir(cp.from_jax_params(jparams), PCFG, out,
                      style_to_idx=STYLES, val_loss=1.25)
    for name in ("config.json", "generation_config.json",
                 "style_to_id.txt"):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(jax_export, name), "rb") as g:
            assert f.read() == g.read(), name
    pipe = jpipe.EmotionWhisperPipeline.from_hf_dir(out)
    assert pipe.cfg == JCFG
    assert pipe.idx_to_label == {v: k for k, v in STYLES.items()}
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jparams),
                              jax.tree_util.tree_leaves_with_path(
                                  pipe.params)):
        assert np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))


def _decode_both(jax_pipe, port, windows):
    dcfg = DecodeConfig(max_new_tokens=16, repetition_penalty=1.15,
                        no_repeat_ngram_size=3)
    want = jax_pipe._decode(windows, jcfg.DecodeConfig(
        **dataclasses.asdict(dcfg)))
    got = port._decode(windows, dcfg)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))


@pytest.mark.parametrize("weights", ["model.safetensors",
                                     "pytorch_model.bin"])
def test_jax_export_analyzes_as_in_jax(jax_export, tmp_path, weights):
    model_dir = jax_export
    if weights == "pytorch_model.bin":
        model_dir = str(tmp_path / "bin")
        os.makedirs(model_dir)
        for name in os.listdir(jax_export):
            if name != "model.safetensors":
                with open(os.path.join(jax_export, name), "rb") as f, \
                        open(os.path.join(model_dir, name), "wb") as g:
                    g.write(f.read())
        torch.save({k: torch.from_numpy(v) for k, v in stn.load_file(
            os.path.join(jax_export, "model.safetensors")).items()},
            os.path.join(model_dir, weights))
    tok = ByteTokenizer()
    jax_pipe = jpipe.EmotionWhisperPipeline.from_hf_dir(
        jax_export, tokenizer=tok, compute_dtype=jnp.float32)
    port = EmotionWhisperPipeline.from_hf_dir(model_dir, tokenizer=tok,
                                              device="cpu")
    assert port.cfg == PCFG and port.compute_dtype == torch.float32
    assert port.idx_to_label == jax_pipe.idx_to_label
    assert port.suppress_ids == jax_pipe.suppress_ids
    rng = np.random.default_rng(4)
    windows = (0.3 * rng.standard_normal((3, port._window))) \
        .astype(np.float32)
    _decode_both(jax_pipe, port, windows)
    wav = synth_clip(2.2, 16000, seed=5)
    want = jax_pipe.analyze(wav, 16000, segment_duration=1.0,
                            max_new_tokens=12)
    got = port.analyze(wav, 16000, segment_duration=1.0, max_new_tokens=12)
    assert got["transcription"] == want["transcription"]
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["text"], g["emotion"]) == (w["text"], w["emotion"])
        for k in w["emotion_probs"]:
            assert abs(g["emotion_probs"][k] - w["emotion_probs"][k]) \
                <= PROB_TOL


def test_reference_save_pretrained_dir_matches_jax(hf_model, tmp_path):
    """A plain whisper directory as transformers writes it: no emotion
    head (a fresh one of the default 10 classes, from the port's own
    generator), the config from HF's config.json."""
    hf_model.save_pretrained(str(tmp_path))
    port = EmotionWhisperPipeline.from_hf_dir(str(tmp_path), device="cpu")
    jax_pipe = jpipe.EmotionWhisperPipeline.from_hf_dir(str(tmp_path))
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jax_pipe.cfg)
    _equal_trees(port.params["whisper"],
                 cp.from_jax_params(jax_pipe.params["whisper"]))
    assert port.params["emotion_head"]["w"].shape == (10, 64)
    _equal_trees(port.params["emotion_head"],
                 cp.linear_init(torch.Generator().manual_seed(0), 64, 10))


def test_suppress_tokens_reach_the_pipeline(jax_export, tmp_path):
    d = tmp_path / "sup"
    d.mkdir()
    for name in os.listdir(jax_export):
        (d / name).write_bytes(open(os.path.join(jax_export, name),
                                    "rb").read())
    gc = json.loads((d / "generation_config.json").read_text())
    gc["suppress_tokens"] = [220, 50256, 11]
    (d / "generation_config.json").write_text(json.dumps(gc))
    port = EmotionWhisperPipeline.from_hf_dir(str(d), device="cpu")
    want = jpipe.EmotionWhisperPipeline.from_hf_dir(str(d)).suppress_ids
    assert port.suppress_ids == want == (220, 50256, 11)


# --------------------------------------------------------------------------
# loading dispatch, the CLIs, the server
# --------------------------------------------------------------------------


def test_load_pipeline_dispatch(jax_export, tmp_path):
    pipe = common.load_pipeline(jax_export, device="cpu", kv_quant="int8",
                                num_beams=2)
    assert (pipe.kv_quant, pipe.num_beams) == ("int8", 2)
    assert pipe.cfg == PCFG
    seeded = common.load_pipeline(None, device="cpu")
    assert seeded.cfg == pcfg.EmotionWhisperConfig()
    _equal_trees(seeded.params, cp.init(pcfg.EmotionWhisperConfig(),
                                        torch.Generator().manual_seed(0)))
    with pytest.raises(FileNotFoundError):
        common.load_pipeline(str(tmp_path / "nothing"), device="cpu")
    assert not os.path.exists(tmp_path / "nothing")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            common.load_pipeline(jax_export)


def _wav_file(path, audio, sr):
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


def test_infer_cli_matches_jax_pipeline(jax_export, tmp_path):
    wav = synth_clip(2.5, 16000, seed=8)
    audio = _wav_file(tmp_path / "clip.wav", wav, 16000)
    got = cli_infer.main(["--audio", audio, "--model_path", jax_export,
                          "--segment_duration", "1.0", "--device", "cpu"])
    jax_pipe = jpipe.EmotionWhisperPipeline.from_hf_dir(
        jax_export, tokenizer=jcommon.get_tokenizer(None),
        compute_dtype=jnp.float32)
    from audio_transformers_tpu.utils.audio import read_audio
    want = jax_pipe.analyze(*read_audio(audio), segment_duration=1.0)
    assert got["transcription"] == want["transcription"]
    assert len(got["segments"]) == len(want["segments"]) == 3
    for g, w in zip(got["segments"], want["segments"]):
        assert g["text"] == w["text"]
        for k in w["emotion_probs"]:
            assert abs(g["emotion_probs"][k] - w["emotion_probs"][k]) \
                <= PROB_TOL


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("which", ["evaluate", "evaluate_simple"])
def test_evaluate_clis_match_jax(jax_export, tmp_path, monkeypatch, which):
    port_cli, jax_cli = {"evaluate": (cli_eval, jcli_eval),
                         "evaluate_simple": (cli_simple, jcli_simple)}[which]
    args = ["--model_path", jax_export, "--dataset", "synthetic",
            "--num_samples", "20", "--batch_size", "4"]
    if which == "evaluate_simple":
        args += ["--max_new_tokens", "12"]
    # the JAX CLIs decode in the JAX pipeline's default bfloat16; hold
    # both packages to float32, and replay the JAX fallback's noise
    orig = jcommon.load_pipeline
    monkeypatch.setattr(jcommon, "load_pipeline", lambda path, **kw: orig(
        path, compute_dtype=jnp.float32, **kw))
    monkeypatch.setattr(dec, "gumbel_noise", _JaxGumbel(4))
    want = jax_cli.main(args + ["--output_dir", str(tmp_path / "jax")])
    got = port_cli.main(args + ["--output_dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert sorted(files) == (["predictions.txt", "segment_evaluation.txt"]
                             if which == "evaluate" else
                             ["metrics.txt", "predictions.txt"])


def test_server_main_loads_through_load_pipeline(jax_export, monkeypatch):
    seen = {}

    def fake_load(model_path, **kw):
        seen.update(kw, model_path=model_path)
        raise SystemExit(0)

    monkeypatch.setattr(common, "load_pipeline", fake_load)
    with pytest.raises(SystemExit):
        http_server.main(["--model_path", jax_export, "--tokenizer", "byte",
                          "--device", "cpu"])
    assert seen["model_path"] == jax_export and seen["device"] == "cpu"
    assert isinstance(seen["tokenizer"], ByteTokenizer)
    monkeypatch.undo()
    pipe = http_server.build_pipeline(model_path=jax_export,
                                      tokenizer=ByteTokenizer(),
                                      device="cpu")
    assert isinstance(pipe.tokenizer, ByteTokenizer) and pipe.cfg == PCFG
    with pytest.raises(ValueError):
        http_server.build_pipeline(model_path=jax_export, config="test",
                                   device="cpu")


# --------------------------------------------------------------------------
# the Hub
# --------------------------------------------------------------------------


def test_push_to_hub_skips_without_token(monkeypatch, capsys):
    monkeypatch.delenv("HF_ACCESS", raising=False)
    assert hub.push_to_hub("/nonexistent", "user/repo") is False
    assert "HF_ACCESS not set" in capsys.readouterr().out


@pytest.mark.parametrize("token_from", ["argument", "environment"])
def test_push_to_hub_api_plumbing(monkeypatch, tmp_path, token_from):
    calls = {}

    class FakeApi:
        def __init__(self, token=None):
            calls["token"] = token

        def create_repo(self, repo_id, exist_ok=False):
            calls["repo"] = (repo_id, exist_ok)

        def upload_folder(self, folder_path, repo_id, path_in_repo,
                          commit_message):
            calls["upload"] = (folder_path, repo_id, path_in_repo)

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=FakeApi))
    if token_from == "environment":
        monkeypatch.setenv("HF_ACCESS", "tkn")
        ok = hub.push_to_hub(str(tmp_path), "user/repo")
    else:
        monkeypatch.delenv("HF_ACCESS", raising=False)
        ok = hub.push_to_hub(str(tmp_path), "user/repo", token="tkn")
    assert ok is True
    assert calls == {"token": "tkn", "repo": ("user/repo", True),
                     "upload": (str(tmp_path), "user/repo", ".")}
