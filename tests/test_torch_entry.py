"""The port's entry points beside the trainers: `entry.entry` (the
forward of whisper-tiny with the emotion head and log-mel) and
the Streamlit demo `serve/app.py`, on the CPU. Streamlit is installed
nowhere the port runs, so `app.main()` runs against a stand-in module
that records what the page would show; its flag parser is held to the
reference's on the reference's own cases (tests/test_serve.py).
(`entry.dryrun_multichip` is tested in tests/test_torch_parallel.py.)
"""

import contextlib
import sys
import types

import numpy as np
import pytest
import torch

from audio_transformers_tpu.serve import app as japp
from audio_transformers_tpu_torch.serve import app


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as many alone, and far faster beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    ["--model_path=/a", "--tokenizer", "byte"], [],
    ["--model_path", "/m", "--device=cpu"],
    ["--model_path", "--tokenizer", "byte"], ["--tokenizer"]])
def test_parse_flags_matches_the_reference(argv):
    try:
        want = japp.parse_flags(argv)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[1]):
            app.parse_flags(argv)
        return
    assert app.parse_flags(argv) == want


class FakeStreamlit(types.ModuleType):
    """What `app.main` calls of streamlit, recorded; the uploader returns
    `upload` and the button is pressed."""

    def __init__(self, upload: bytes):
        super().__init__("streamlit")
        self.upload = upload
        self.calls = []

    def cache_resource(self, fn):
        return fn

    def spinner(self, text):
        self.calls.append(("spinner", text))
        return contextlib.nullcontext()

    def file_uploader(self, label, type):
        self.calls.append(("file_uploader", tuple(type)))
        return types.SimpleNamespace(getvalue=lambda: self.upload)

    def button(self, label):
        return True

    def __getattr__(self, name):   # set_page_config, title, markdown, ...
        return lambda *a, **kw: self.calls.append((name, *a))


def test_app_main_analyzes_an_upload_on_a_cpu_pipeline(monkeypatch,
                                                       tmp_path):
    from audio_transformers_tpu_torch.cli import common
    from audio_transformers_tpu_torch.core.config import (
        EmotionWhisperConfig, WhisperConfig)
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.data.tokenizer import ByteTokenizer
    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline
    from audio_transformers_tpu_torch.utils.audio import (synth_clip,
                                                          write_wav)

    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=3)
    loads = []

    def load_pipeline(model_path, *, tokenizer=None, **kw):
        loads.append((model_path, type(tokenizer), kw))
        return EmotionWhisperPipeline(
            init(cfg, torch.Generator().manual_seed(0)), cfg,
            tokenizer=tokenizer, compute_dtype=torch.float32, **kw)

    path = str(tmp_path / "clip.wav")
    write_wav(path, synth_clip(7.0, 16000), 16000)
    with open(path, "rb") as f:
        st = FakeStreamlit(f.read())
    monkeypatch.setitem(sys.modules, "streamlit", st)
    monkeypatch.setattr(common, "load_pipeline", load_pipeline)
    monkeypatch.setattr(sys, "argv", ["app.py", "--model_path=/m",
                                      "--tokenizer", "byte",
                                      "--device", "cpu"])
    app.main()

    assert loads == [("/m", ByteTokenizer, {"device": "cpu"})]
    names = [c[0] for c in st.calls]
    assert "error" not in names, st.calls
    assert st.calls[names.index("file_uploader")][1][:2] == ("wav", "flac")
    assert names.count("subheader") == 2
    charts = [c[1] for c in st.calls if c[0] == "bar_chart"]
    assert len(charts) == 2          # 7 s in 5 s segments
    for probs in charts:
        assert len(probs) == 3
        np.testing.assert_allclose(sum(probs.values()), 1.0, rtol=1e-5)
    assert any(c[0] == "markdown" and str(c[1]).startswith("> ")
               for c in st.calls)


def test_app_main_reports_an_undecodable_upload(monkeypatch):
    from audio_transformers_tpu_torch.cli import common

    st = FakeStreamlit(b"not audio at all")
    monkeypatch.setitem(sys.modules, "streamlit", st)
    never = types.SimpleNamespace(analyze=lambda *a, **kw: pytest.fail(
        "analyzed an undecodable upload"))
    monkeypatch.setattr(common, "load_pipeline", lambda *a, **kw: never)
    monkeypatch.setattr(sys, "argv", ["app.py", "--device", "cpu"])
    app.main()
    assert [c[0] for c in st.calls][-1] == "error"


def test_entry_runs_on_the_cpu():
    from audio_transformers_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    params, waveform, ids = args
    assert waveform.shape == (2, 480000) and ids.shape == (2, 24)
    assert waveform.device.type == ids.device.type == "cpu"
    with torch.no_grad():
        logits, emotion = fn(*args)
    assert logits.shape == (2, 24, 51865) and emotion.shape == (2, 10)
    assert torch.isfinite(logits).all() and torch.isfinite(emotion).all()
    _, again = entry(device="cpu")    # seeded: the same inputs again
    assert torch.equal(again[1], waveform) and torch.equal(again[2], ids)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
