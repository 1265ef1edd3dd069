"""Dual-loss whisper-emotion fine-tuning CLI.

Flag-compatible with the reference package's `cli/train_whisper.py`, plus
--device (default cuda):

  python -m audio_transformers_tpu_torch.cli.train_whisper \\
      --dataset synthetic --num_epochs 2 --batch_size 8
  python -m audio_transformers_tpu_torch.cli.train_whisper --device cpu \\
      --model_size test --compute_dtype float32 --num_epochs 1

Not ported yet, and raising NotImplementedError: --pretrained and
--hf_repo_id (HF weight loading and hub export with the torch checkpoint
bundle, ROADMAP queue items 4 and 9) and --spec_augment.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Emotion-Aware Whisper")
    p.add_argument("--num_epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--data_percentage", type=float, default=1.0)
    p.add_argument("--emotion_weight", type=float, default=0.5)
    p.add_argument("--simple_styles", action="store_true")
    p.add_argument("--output_dir", default="./emotion_whisper_model")
    p.add_argument("--wandb_project", default="emotion_whisper")
    p.add_argument("--wandb_entity", default=None)
    p.add_argument("--hf_repo_id", default=None)
    p.add_argument("--dataset", default="synthetic",
                   choices=["expresso", "synthetic"])
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer path (default: byte tokenizer)")
    p.add_argument("--pretrained", default=None,
                   help="HF whisper dir/safetensors to initialize from")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "base", "small", "medium", "large",
                            "large-v3", "test"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--num_samples", type=int, default=64,
                   help="synthetic dataset size")
    p.add_argument("--num_workers", type=int, default=4,
                   help="background host-prefetch threads (0 = sync)")
    p.add_argument("--spec_augment", action="store_true",
                   help="SpecAugment time/freq masking post-mel")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.pretrained:
        raise NotImplementedError(
            "--pretrained is not ported yet (HF weight loading and the "
            "checkpoint bundle, ROADMAP queue items 4 and 9)")
    if args.hf_repo_id:
        raise NotImplementedError(
            "--hf_repo_id is not ported yet (hub export needs the torch "
            "checkpoint bundle, ROADMAP queue items 4 and 9)")

    from audio_transformers_tpu.cli.common import (build_expresso_splits,
                                                   get_tokenizer)
    from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                    MelConfig,
                                                    OptimizerConfig,
                                                    TrainConfig,
                                                    WhisperConfig)
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        train_whisper_emotion

    whisper_cfg = WhisperConfig.by_name(args.model_size)
    mel_cfg = MelConfig.whisper(n_mels=whisper_cfg.n_mels)
    # synthetic clip duration must fit the model's encoder window
    duration = min(30.0, (2 * whisper_cfg.max_source_positions)
                   * mel_cfg.hop_length / mel_cfg.sample_rate)

    tokenizer = get_tokenizer(args.tokenizer)
    train_ds, val_ds, _, style_to_idx = build_expresso_splits(
        args, tokenizer, duration=duration,
        vocab_size=whisper_cfg.vocab_size)
    num_classes = len(style_to_idx)
    print(f"emotion classes: {num_classes} ({sorted(style_to_idx)})")

    cfg = EmotionWhisperConfig(whisper=whisper_cfg,
                               num_emotion_classes=num_classes)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        seed=args.seed, compute_dtype=args.compute_dtype,
        emotion_weight=args.emotion_weight,
        spec_augment=args.spec_augment,
        optimizer=OptimizerConfig(name="adamw", learning_rate=args.lr,
                                  schedule="linear_warmup_decay",
                                  warmup_fraction=0.1))

    out = train_whisper_emotion(
        cfg, mel_cfg, train_cfg,
        train_ds.batcher(args.batch_size, num_workers=args.num_workers),
        val_ds.batcher(args.batch_size, num_workers=args.num_workers),
        device=args.device, style_to_idx=style_to_idx,
        output_dir=args.output_dir, wandb_project=args.wandb_project)
    print(f"best val loss: {out['best_val_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
