"""Segment-level (timestamped) evaluation CLI: the port of the reference
package's `cli/evaluate.py` over `infer/evaluate.evaluate_segment_level`,
plus --device (default cuda):

  python -m audio_transformers_tpu_torch.cli.evaluate \
      --model_path ./emotion_whisper_model/checkpoints --dataset synthetic
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Segment-level evaluation")
    p.add_argument("--model_path", required=True,
                   help="checkpoint dir or HF dir")
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--data_percentage", type=float, default=1.0)
    p.add_argument("--dataset", default="synthetic",
                   choices=["expresso", "synthetic"])
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--simple_styles", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--max_segments", type=int, default=None,
                   help="segment buffer size; default sizes it from the "
                        "decode length so nothing is ever dropped")
    p.add_argument("--kv_quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="quantize the decode K/V caches (the cross K/V in "
                        "int8 or nibble-packed int4, the self K/V in int8)")
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam-search width (1 = the reference's greedy "
                        "protocol; beams disable the compression-ratio "
                        "temperature fallback, which is a greedy rescue)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from audio_transformers_tpu_torch.cli.common import (
        build_expresso_splits, get_tokenizer, load_pipeline)
    from audio_transformers_tpu_torch.core.config import DecodeConfig
    from audio_transformers_tpu_torch.infer.evaluate import \
        evaluate_segment_level

    tokenizer = get_tokenizer(args.tokenizer)
    pipe = load_pipeline(args.model_path, tokenizer=tokenizer,
                         device=args.device)

    w = pipe.cfg.whisper
    duration = min(30.0, (2 * w.max_source_positions)
                   * pipe.mel_cfg.hop_length / pipe.mel_cfg.sample_rate)
    _, _, test_ds, style_to_idx = build_expresso_splits(
        args, tokenizer, duration=duration, vocab_size=w.vocab_size)
    idx_to_style = {v: k for k, v in style_to_idx.items()}

    # the reference's decode and the kv_quant knob
    dcfg = DecodeConfig(max_new_tokens=256, return_timestamps=True,
                        no_repeat_ngram_size=3, repetition_penalty=1.1,
                        compression_ratio_threshold=2.4,
                        kv_quant=args.kv_quant, num_beams=args.num_beams)
    result = evaluate_segment_level(
        pipe.params, pipe.cfg, pipe.mel_cfg,
        test_ds.batcher(args.batch_size), idx_to_style,
        tokenizer=tokenizer, output_dir=args.output_dir, dcfg=dcfg,
        max_segments=args.max_segments, compute_dtype=pipe.compute_dtype,
        device=pipe.device)

    print(f"Total segments evaluated: {result['total_segments']}")
    print(f"Segment-level Accuracy: {result['accuracy']:.4f}")
    print(f"Segment-level F1: {result['weighted_f1']:.4f}")
    print(result["report"])
    return result


if __name__ == "__main__":
    main()
