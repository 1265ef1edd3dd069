"""Dual-loss whisper-emotion fine-tuning CLI.

Flag-compatible with the reference package's `cli/train_whisper.py`, plus
--device (default cuda):

  python -m audio_transformers_tpu_torch.cli.train_whisper \\
      --dataset synthetic --num_epochs 2 --batch_size 8
  python -m audio_transformers_tpu_torch.cli.train_whisper --device cpu \\
      --model_size test --compute_dtype float32 --num_epochs 1

--pretrained starts from an HF directory or .safetensors file (the
whisper weights, and the emotion head when its class count fits the
dataset); --hf_repo_id exports the best epoch as an HF directory to
<output_dir>/hf_export and uploads it (with HF_ACCESS set). Rerunning
with the same --output_dir resumes from its resume/ directory.
--spec_augment masks the mel features in each train step.

Data parallelism: torchrun starts one process per card, and each trains
on its rows of every global batch of --batch_size (rank 0 writes):

  torchrun --nproc_per_node 4 -m \
      audio_transformers_tpu_torch.cli.train_whisper --batch_size 32
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

    from audio_transformers_tpu_torch.parallel import distributed
    distributed.initialize_if_multihost(device=args.device)
    try:
        return _train(args, distributed.process_device(args.device),
                      distributed.process_index() == 0)
    finally:
        distributed.shutdown()


def _train(args, device, writer: bool):
    from audio_transformers_tpu_torch.cli.common import (
        build_expresso_splits, get_tokenizer)
    from audio_transformers_tpu_torch.core.config import (
        EmotionWhisperConfig, MelConfig, OptimizerConfig, TrainConfig,
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

    init_params = None
    if args.pretrained:
        import torch

        from audio_transformers_tpu_torch.core.params import linear_init
        from audio_transformers_tpu_torch.models.whisper.load import (
            from_torch_state_dict, load_safetensors)
        whisper_params, emotion = from_torch_state_dict(
            load_safetensors(args.pretrained), cfg.whisper)
        if emotion is not None and emotion["w"].shape[0] != num_classes:
            # a narrower head would index past its classes in the emotion
            # loss; a wider one would export a config.json inconsistent
            # with the weights
            print(f"[train] pretrained emotion head has "
                  f"{emotion['w'].shape[0]} classes but the dataset has "
                  f"{num_classes}; reinitializing the head")
            emotion = None
        if emotion is None:
            emotion = linear_init(torch.Generator().manual_seed(args.seed),
                                  whisper_cfg.d_model, num_classes)
        init_params = {"whisper": whisper_params, "emotion_head": emotion}
    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs,
        seed=args.seed, compute_dtype=args.compute_dtype,
        emotion_weight=args.emotion_weight,
        spec_augment=args.spec_augment,
        optimizer=OptimizerConfig(name="adamw", learning_rate=args.lr,
                                  schedule="linear_warmup_decay",
                                  warmup_fraction=0.1))

    batchers = [ds.batcher(args.batch_size, num_workers=args.num_workers)
                for ds in (train_ds, val_ds)]
    out = train_whisper_emotion(
        cfg, mel_cfg, train_cfg, *batchers, device=device,
        init_params=init_params, style_to_idx=style_to_idx,
        output_dir=args.output_dir, wandb_project=args.wandb_project)
    print(f"best val loss: {out['best_val_loss']:.4f}")

    if args.hf_repo_id and writer:
        from audio_transformers_tpu_torch.utils.hub import (export_hf_dir,
                                                            push_to_hub)
        hf_dir = export_hf_dir(out["best_params"], cfg,
                               f"{args.output_dir}/hf_export",
                               style_to_idx=style_to_idx,
                               val_loss=out["best_val_loss"])
        push_to_hub(hf_dir, args.hf_repo_id)
    return out


if __name__ == "__main__":
    main()
