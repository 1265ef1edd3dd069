"""Train the UrbanSound classifier.

Flag-compatible with the reference package's `cli/train_classifier.py`,
plus --device (default cuda):

  python -m audio_transformers_tpu_torch.cli.train_classifier \\
      --dataset synthetic --epochs 3 --batch_size 64 --spec_augment
  python -m audio_transformers_tpu_torch.cli.train_classifier --device cpu \\
      --compute_dtype float32 --epochs 1 --limit_samples 32

It writes <output_dir>/metrics.jsonl, the best epochs by val accuracy to
<output_dir>/checkpoints and the last epoch's full state to
<output_dir>/checkpoints-resume (a rerun with the same --output_dir
resumes from it), then exports the best epoch to
<output_dir>/best_model.safetensors with the reference's torch keys and,
with --hf_repo_id, uploads <output_dir> (with HF_ACCESS set).

Data parallelism: torchrun starts one process per card, and each trains
on its rows of every global batch of --batch_size (rank 0 writes):

  torchrun --nproc_per_node 4 -m \
      audio_transformers_tpu_torch.cli.train_classifier --batch_size 256
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train UrbanSound classifier")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--limit_samples", type=int, default=None)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    # model flags (the reference's defaults)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--conv_dim", type=int, default=128)
    p.add_argument("--encoder_dim", type=int, default=256)
    p.add_argument("--num_encoder_blocks", type=int, default=4)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.1)
    # data/system
    p.add_argument("--dataset", default="synthetic",
                   choices=["urbansound8k", "local", "synthetic"])
    p.add_argument("--data_dir", default=None)
    p.add_argument("--num_workers", type=int, default=4,
                   help="background host-prefetch threads (0 = sync)")
    p.add_argument("--waveform_cache", default=None,
                   help="directory for the decoded-waveform cache "
                        "(--dataset local): epochs >= 2 skip the "
                        "decode/resample chain entirely")
    p.add_argument("--spec_augment", action="store_true",
                   help="SpecAugment time/freq masking post-mel")
    p.add_argument("--norm_type", default="batch",
                   choices=["batch", "group"],
                   help="batch matches the reference BatchNorm1d; group "
                        "is the stateless alternative")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--wandb_project", default="mlx-audio-models")
    p.add_argument("--hf_repo_id", default=None)
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
    from audio_transformers_tpu_torch.cli.common import \
        build_classifier_batchers
    from audio_transformers_tpu_torch.core.config import (MelConfig,
                                                          OptimizerConfig,
                                                          TrainConfig,
                                                          UrbanSoundConfig)
    from audio_transformers_tpu_torch.train.classifier import \
        train_classifier
    from audio_transformers_tpu_torch.utils.hub import (export_classifier,
                                                        push_to_hub)

    model_cfg = UrbanSoundConfig(
        n_mels=args.n_mels, conv_dim=args.conv_dim,
        encoder_dim=args.encoder_dim,
        num_encoder_blocks=args.num_encoder_blocks,
        num_heads=args.num_heads, dropout=args.dropout,
        norm_type=args.norm_type)
    mel_cfg = MelConfig.urbansound(n_mels=args.n_mels)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.epochs, seed=args.seed,
        compute_dtype=args.compute_dtype,
        optimizer=OptimizerConfig(name="adam", learning_rate=args.lr,
                                  schedule="reduce_on_plateau",
                                  plateau_patience=5),
        spec_augment=args.spec_augment,
        checkpoint_dir=f"{args.output_dir}/checkpoints")

    train_b, val_b = build_classifier_batchers(args)
    out = train_classifier(model_cfg, mel_cfg, train_cfg, train_b, val_b,
                           device=device, log_dir=args.output_dir,
                           wandb_project=args.wandb_project)
    print(f"best val accuracy: {out['best_val_accuracy']:.4f}")
    if not writer:
        return out

    export_path = f"{args.output_dir}/best_model.safetensors"
    export_classifier(out["best_params"], out["best_state"], export_path)
    print(f"exported {export_path}")
    if args.hf_repo_id:
        push_to_hub(args.output_dir, args.hf_repo_id)
    return out


if __name__ == "__main__":
    main()
