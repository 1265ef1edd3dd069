"""The Expresso parity rehearsal through the PyTorch port.

    python3 scripts/parity_rehearsal_torch.py [--output_dir DIR]

The protocol of scripts/parity_rehearsal.py, run by the port
(`audio_transformers_tpu_torch`, which this script alone imports):

  --mode rehearsal (default, offline): SyntheticExpresso, 768 clips split
      626/71/71 (seeded, stratified), whisper-tiny at full width (51865
      vocab, 80 mels, 30 s windows -> 1500 encoder frames), batch 5,
      AdamW 3e-5 with 10% linear warm-up then linear decay, dual loss
      with emotion weight 0.5, 8 epochs, then the sequence-level
      evaluator (greedy, 100 new tokens, no-repeat 3-gram, repetition
      penalty 1.15) on the test split with the best-by-val-loss
      parameters. It writes <output_dir>/metrics.jsonl (a line an epoch),
      style_to_id.txt, eval_out/metrics.txt and predictions.txt, and
      rehearsal_summary.json with the keys of the JAX script's summary.
      On the card the training runs in bf16 through the flash-attention
      kernels and the evaluation decodes through K1, K2 and K3.

  --mode real: the Expresso dataset (`data/expresso.create_dataset`,
      which needs the HF `datasets` package and the dataset) fine-tuned
      from pretrained whisper-tiny (`--pretrained <model.safetensors>`,
      read by the port's own safetensors reader), with a tokenizer
      (`--tokenizer`, which needs `transformers`). Neither the dataset
      nor the pretrained weights are in the repository, so the real run
      waits until they are.

`main(argv, cfg=, init_params=)` takes the model configuration (its
encoder length sets the clip duration) and the initial parameter tree as
arguments, for runs at other widths; the default is EmotionWhisperConfig()
initialised from `--seed`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Expresso parity rehearsal "
                                            "(PyTorch port)")
    p.add_argument("--mode", default="rehearsal",
                   choices=["rehearsal", "real"])
    p.add_argument("--epochs", type=int, default=None,
                   help="default: 8 (the reference protocol) in both modes")
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--emotion_weight", type=float, default=0.5)
    p.add_argument("--data_percentage", type=float, default=1.0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_samples", type=int, default=768,
                   help="synthetic dataset size (rehearsal mode); 768 -> "
                        "626/71/71 splits")
    p.add_argument("--pretrained", default=None,
                   help="whisper safetensors to initialize from (real mode)")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer name/path; byte tokenizer if unset")
    p.add_argument("--output_dir",
                   default="artifacts/parity_rehearsal_torch")
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None, *, cfg=None, init_params: Optional[dict] = None) -> dict:
    args = parse_args(argv)
    epochs = args.epochs or 8

    import torch

    from audio_transformers_tpu_torch.cli.common import get_tokenizer
    from audio_transformers_tpu_torch.core.config import (
        DataConfig, EmotionWhisperConfig, MelConfig, OptimizerConfig,
        TrainConfig)
    from audio_transformers_tpu_torch.data.expresso import (
        SyntheticExpresso, create_dataset)
    from audio_transformers_tpu_torch.infer.evaluate import \
        evaluate_sequence_level
    from audio_transformers_tpu_torch.models.whisper import emotion as emo
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        train_whisper_emotion

    cfg = cfg or EmotionWhisperConfig()      # whisper-tiny, 51865 vocab
    mel_cfg = MelConfig.whisper(n_mels=cfg.whisper.n_mels)
    data_cfg = DataConfig(
        dataset="expresso" if args.mode == "real" else "synthetic",
        duration=(2 * cfg.whisper.max_source_positions * mel_cfg.hop_length
                  / mel_cfg.sample_rate),  # 30 s at whisper's 1500 frames
        sample_rate=mel_cfg.sample_rate,
        data_percentage=args.data_percentage,
        num_workers=args.num_workers, seed=args.seed)

    tokenizer = get_tokenizer(args.tokenizer)
    if data_cfg.dataset == "expresso":
        train_ds, val_ds, test_ds, style_to_idx = create_dataset(
            tokenizer, data_percentage=data_cfg.data_percentage,
            seed=data_cfg.seed)
    else:
        ds = SyntheticExpresso(tokenizer, num_samples=args.num_samples,
                               duration=data_cfg.duration,
                               vocab_size=cfg.whisper.vocab_size,
                               seed=data_cfg.seed)
        train_ds, val_ds, test_ds, style_to_idx = ds.splits(
            seed=data_cfg.seed)
    cfg = cfg.replace(num_emotion_classes=len(style_to_idx))
    idx_to_style = {v: k for k, v in style_to_idx.items()}
    print(f"[rehearsal] mode={args.mode} classes={len(style_to_idx)} "
          f"train/val/test = {train_ds.num_samples}/{val_ds.num_samples}/"
          f"{test_ds.num_samples}", flush=True)

    if args.pretrained:
        from audio_transformers_tpu_torch.models.whisper.load import (
            from_torch_state_dict, load_safetensors)
        whisper_params, emotion = from_torch_state_dict(
            load_safetensors(args.pretrained), cfg.whisper)
        base = emo.init(cfg, torch.Generator().manual_seed(args.seed))
        init_params = {"whisper": whisper_params,
                       "emotion_head": emotion or base["emotion_head"]}

    train_cfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=epochs, seed=args.seed,
        compute_dtype=args.compute_dtype,
        emotion_weight=args.emotion_weight,
        optimizer=OptimizerConfig(name="adamw", learning_rate=args.lr,
                                  schedule="linear_warmup_decay",
                                  warmup_fraction=0.1))

    out = train_whisper_emotion(
        cfg, mel_cfg, train_cfg,
        train_ds.batcher(args.batch_size, seed=args.seed,
                         num_workers=data_cfg.num_workers),
        val_ds.batcher(args.batch_size, seed=args.seed,
                       num_workers=data_cfg.num_workers),
        device=args.device, init_params=init_params,
        style_to_idx=style_to_idx, output_dir=args.output_dir)

    # the sequence-level evaluation of the test split with the
    # best-by-val-loss parameters, as the reference evaluates its saved
    # best model
    result = evaluate_sequence_level(
        out["best_params"], cfg, mel_cfg, test_ds.batcher(args.batch_size),
        idx_to_style, tokenizer=tokenizer,
        output_dir=os.path.join(args.output_dir, "eval_out"),
        device=args.device)

    summary = {
        "mode": args.mode,
        "protocol": {"model": "whisper-tiny", "batch_size": args.batch_size,
                     "lr": args.lr, "epochs": epochs,
                     "emotion_weight": args.emotion_weight},
        "best_val_loss": out["best_val_loss"],
        "loss_curve": [{"epoch": r["epoch"], "train_loss": r["train/loss"],
                        "val_loss": r["val/loss"],
                        "clips_per_sec": r["clips_per_sec"]}
                       for r in out["history"]],
        "test_accuracy": result["accuracy"],
        "test_weighted_f1": result["weighted_f1"],
        "test_samples": result["samples"],
        "reference_anchor": {"accuracy": 0.925734, "weighted_f1": 0.921336,
                             "source": "whisper_finetune/eval_out/"
                                       "metrics.txt"},
    }
    with open(os.path.join(args.output_dir, "rehearsal_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in
                      ("mode", "best_val_loss", "test_accuracy",
                       "test_samples")}), flush=True)
    return summary


if __name__ == "__main__":
    main()
