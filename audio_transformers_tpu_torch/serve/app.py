"""Streamlit demo on the port's inference path (the reference package's
`serve/app.py`): upload a clip, read its transcription and the emotion
of each 5 s segment as bar charts. Needs `streamlit`; without it, serve
through `serve/http_server.py`.

  streamlit run audio_transformers_tpu_torch/serve/app.py -- \\
      --model_path ./emotion_whisper_model/checkpoints [--device cpu]

--model_path takes what `cli.common.load_pipeline` takes (a checkpoint
or HF directory; none: seeded random weights), --tokenizer an HF
tokenizer path, --device the torch device (default cuda).
"""

from __future__ import annotations

import sys


def parse_flags(argv):
    """--flag=value and --flag value forms (the docstring's own invocation
    uses the space-separated form; accepting only '=' served a random-init
    model silently). Every flag here takes a value, so a --flag with no
    value following is an error, not a silent skip — that would reproduce
    the same random-init failure mode."""
    flags = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            if "=" in a:
                k, v = a.split("=", 1)
                flags[k] = v
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                flags[a] = argv[i + 1]
                i += 1
            else:
                raise ValueError(f"flag {a} expects a value "
                                 f"({a}=VALUE or {a} VALUE)")
        i += 1
    return flags


def main():
    import streamlit as st

    st.set_page_config(page_title="Audio Emotion Recognition", page_icon="*")
    st.title("Audio Emotion Recognition & Transcription")
    st.markdown("Upload an audio file; the model transcribes it and "
                "estimates emotions for 5-second segments.")

    @st.cache_resource
    def load(model_path, tokenizer, device):
        from audio_transformers_tpu_torch.cli import common
        return common.load_pipeline(
            model_path, tokenizer=common.get_tokenizer(tokenizer),
            device=device)

    args = parse_flags(sys.argv[1:])
    pipeline = load(args.get("--model_path"), args.get("--tokenizer"),
                    args.get("--device", "cuda"))

    # Advertise exactly what decodes: wav and flac always, mp3/ogg/m4a
    # only when soundfile or librosa is installed
    from audio_transformers_tpu_torch.utils.audio import (
        decode_audio_bytes, thirdparty_formats_available)
    types = ["wav", "flac"]
    if thirdparty_formats_available():
        types += ["mp3", "ogg", "m4a"]
    uploaded = st.file_uploader("Audio file", type=types)
    if uploaded is None:
        return
    st.audio(uploaded)
    if not st.button("Analyze"):
        return

    try:
        wav, sr = decode_audio_bytes(uploaded.getvalue())
    except ValueError as e:
        st.error(str(e))
        return

    with st.spinner("Processing audio..."):
        result = pipeline.analyze(wav, sr, segment_duration=5.0)

    st.subheader("Transcription")
    st.markdown(f"> {result['transcription']}")
    st.subheader("Emotion analysis by segment")
    for seg in result["segments"]:
        st.markdown(f"**{seg['start']:.1f}s – {seg['end']:.1f}s** — "
                    f"{seg['emotion']}")
        st.bar_chart(seg["emotion_probs"])


if __name__ == "__main__":
    main()
