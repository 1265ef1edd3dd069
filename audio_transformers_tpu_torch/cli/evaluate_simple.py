"""Sequence-level evaluation CLI (the reference's published-metric path):
the port of the reference package's `cli/evaluate_simple.py` over
`infer/evaluate.evaluate_sequence_level`, plus --device (default cuda):

  python -m audio_transformers_tpu_torch.cli.evaluate_simple \
      --model_path ./emotion_whisper_model/checkpoints \
      --dataset synthetic --output_dir eval_out
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Sequence-level evaluation")
    p.add_argument("--model_path", required=True,
                   help="checkpoint dir or HF-format dir")
    p.add_argument("--output_dir", default="eval_out")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_percentage", type=float, default=1.0)
    p.add_argument("--dataset", default="synthetic",
                   choices=["expresso", "synthetic"])
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--simple_styles", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--max_new_tokens", type=int, default=100)
    p.add_argument("--kv_quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="quantize the decode K/V caches (the cross K/V in "
                        "int8 or nibble-packed int4, the self K/V in int8)")
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam-search width (1 = the reference's greedy "
                        "protocol)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from audio_transformers_tpu_torch.cli.common import (
        build_expresso_splits, get_tokenizer, load_pipeline)
    from audio_transformers_tpu_torch.core.config import DecodeConfig
    from audio_transformers_tpu_torch.infer.evaluate import \
        evaluate_sequence_level

    tokenizer = get_tokenizer(args.tokenizer)
    pipe = load_pipeline(args.model_path, tokenizer=tokenizer,
                         device=args.device)

    w = pipe.cfg.whisper
    duration = min(30.0, (2 * w.max_source_positions)
                   * pipe.mel_cfg.hop_length / pipe.mel_cfg.sample_rate)
    _, _, test_ds, style_to_idx = build_expresso_splits(
        args, tokenizer, duration=duration, vocab_size=w.vocab_size)
    idx_to_style = {v: k for k, v in style_to_idx.items()}

    dcfg = DecodeConfig(max_new_tokens=args.max_new_tokens,
                        no_repeat_ngram_size=3, repetition_penalty=1.15,
                        kv_quant=args.kv_quant, num_beams=args.num_beams)
    result = evaluate_sequence_level(
        pipe.params, pipe.cfg, pipe.mel_cfg,
        test_ds.batcher(args.batch_size), idx_to_style,
        tokenizer=tokenizer, output_dir=args.output_dir, dcfg=dcfg,
        compute_dtype=pipe.compute_dtype, device=pipe.device)

    print("\n===== SUMMARY =====")
    print("Samples    :", result["samples"])
    print("Accuracy   :", round(result["accuracy"], 4))
    print("Weighted F1:", round(result["weighted_f1"], 4))
    if "wer" in result:
        print("WER        :", round(result["wer"], 4))
    return result


if __name__ == "__main__":
    main()
