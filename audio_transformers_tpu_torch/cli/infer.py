"""Inference CLI: transcription and per-segment emotion of an audio file.

The port of the reference package's `cli/infer.py`, plus --device
(default cuda; --device cpu runs on the CPU):

  python -m audio_transformers_tpu_torch.cli.infer --audio clip.wav \
      --model_path ./emotion_whisper_model/checkpoints

--model_path takes a checkpoint directory the trainer wrote or an HF
directory (either package's `export_hf_dir`, or the reference's
save_pretrained output); without it the weights are seeded random
whisper-tiny. With no --audio it analyzes a synthesized 12 s clip.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Emotion-whisper inference")
    p.add_argument("--audio", default=None, help="wav or flac file path")
    p.add_argument("--model_path", default=None,
                   help="checkpoint dir or HF dir; random init if unset")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--segment_duration", type=float, default=5.0)
    p.add_argument("--json", action="store_true", help="print raw JSON")
    p.add_argument("--kv_quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="quantize the decode K/V caches (the cross K/V in "
                        "int8 or nibble-packed int4, the self K/V in int8)")
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam-search width (1 = greedy)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from audio_transformers_tpu_torch.cli.common import (get_tokenizer,
                                                         load_pipeline)
    from audio_transformers_tpu_torch.utils.audio import (read_audio,
                                                          synth_clip)

    pipe = load_pipeline(args.model_path,
                         tokenizer=get_tokenizer(args.tokenizer),
                         kv_quant=args.kv_quant, num_beams=args.num_beams,
                         device=args.device)
    if args.audio:
        wav, sr = read_audio(args.audio)
    else:
        print("no --audio given; running synthesized self-test clip")
        wav, sr = synth_clip(12.0, 16000), 16000

    result = pipe.analyze(wav, sr, segment_duration=args.segment_duration)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(f"\nTranscription: {result['transcription']!r}")
        for seg in result["segments"]:
            top = max(seg["emotion_probs"].items(), key=lambda kv: kv[1])
            print(f"  [{seg['start']:6.1f}s - {seg['end']:6.1f}s] "
                  f"{top[0]} ({top[1]:.2f})  {seg['text']!r}")
    return result


if __name__ == "__main__":
    main()
