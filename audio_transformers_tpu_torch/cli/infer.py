"""Inference CLI: transcription and per-segment emotion of an audio file.

The port of the reference package's `cli/infer.py`, plus --device
(default cuda; --device cpu runs on the CPU):

  python -m audio_transformers_tpu_torch.cli.infer --audio clip.wav \
      --model_path ./emotion_whisper_model/checkpoints

--model_path takes a checkpoint directory the trainer wrote or an HF
directory (either package's `export_hf_dir`, or the reference's
save_pretrained output); without it the weights are seeded random
whisper-tiny. With no --audio it analyzes a synthesized 12 s clip.

--model_type grin_qwen2_vl runs Uni-MoE-2.0-Omni's speech understanding instead (`infer/omni.py`):
the clip and --prompt_ids in, --max_new_tokens greedy ids out. Its
published checkpoint does not load yet: the weights are seeded, at the
published sizes (53.6 GB in bf16 on the card).
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
    p.add_argument("--model_type", default="whisper",
                   choices=["whisper", "grin_qwen2_vl"],
                   help="the model family")
    p.add_argument("--prompt_ids", default="1,2,3,4,5,6,7,8,9,10,11,12",
                   help="grin_qwen2_vl: comma-separated prompt ids")
    p.add_argument("--max_new_tokens", type=int, default=32)
    return p.parse_args(argv)


def run_omni(args, wav, sr):
    """Uni-MoE-2.0-Omni on the clip: seeded weights, greedy ids."""
    from audio_transformers_tpu_torch.core.config import OmniConfig
    from audio_transformers_tpu_torch.infer.omni import OmniPipeline, seeded
    if args.model_path:
        raise SystemExit("grin_qwen2_vl: loading a checkpoint is not "
                         "supported yet; run without --model_path")
    cfg = OmniConfig()
    pipe = OmniPipeline(seeded(cfg), cfg, device=args.device)
    prompt = [int(t) for t in args.prompt_ids.split(",") if t]
    result = pipe.analyze(wav, sr, prompt, args.max_new_tokens)
    print(json.dumps(result) if args.json else
          f"\n{result['audio_s']:.1f} s of audio -> ids {result['tokens']}")
    return result


def main(argv=None):
    args = parse_args(argv)

    from audio_transformers_tpu_torch.cli.common import (get_tokenizer,
                                                         load_pipeline)
    from audio_transformers_tpu_torch.utils.audio import (read_audio,
                                                          synth_clip)

    if args.audio:
        wav, sr = read_audio(args.audio)
    else:
        print("no --audio given; running synthesized self-test clip")
        wav, sr = synth_clip(12.0, 16000), 16000
    if args.model_type == "grin_qwen2_vl":
        return run_omni(args, wav, sr)
    pipe = load_pipeline(args.model_path,
                         tokenizer=get_tokenizer(args.tokenizer),
                         kv_quant=args.kv_quant, num_beams=args.num_beams,
                         device=args.device)

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
