"""Shared CLI plumbing: dataset construction and model loading from flags
(the port's copy of the reference package's `cli/common.py`)."""

from __future__ import annotations

from typing import Optional, Tuple

from audio_transformers_tpu_torch.data.tokenizer import (ByteTokenizer,
                                                         load_tokenizer)


def build_expresso_splits(args, tokenizer, *, duration: float = 3.0,
                          vocab_size: Optional[int] = None):
    """(train, val, test, style_to_idx) from --dataset flags.

    --dataset expresso needs network access to the HF hub; rather than
    silently substituting different training data, an unreachable hub is
    surfaced as a clear error pointing at --dataset synthetic."""
    from audio_transformers_tpu_torch.data.expresso import (
        SIMPLE_STYLES, SyntheticExpresso, create_dataset)

    selected = SIMPLE_STYLES if getattr(args, "simple_styles", False) else None
    if args.dataset == "expresso":
        try:
            return create_dataset(tokenizer, selected_styles=selected,
                                  data_percentage=args.data_percentage,
                                  seed=args.seed)
        except (ConnectionError, OSError) as e:
            raise SystemExit(
                f"--dataset expresso: HF hub load failed ({e}). If this "
                "machine has no network access, use --dataset synthetic "
                "(the schema-faithful offline stand-in).") from e
    ds = SyntheticExpresso(tokenizer,
                           num_samples=getattr(args, "num_samples", 64),
                           styles=selected, duration=duration,
                           vocab_size=vocab_size, seed=args.seed)
    return ds.splits(seed=args.seed)


def build_classifier_batchers(args) -> Tuple:
    """(train, val) batchers of the UrbanSound classifier from --dataset
    flags: urbansound8k (HF datasets), local (--data_dir, with an
    optional --waveform_cache) or synthetic."""
    from audio_transformers_tpu_torch.data.synthetic import \
        SyntheticClassification
    from audio_transformers_tpu_torch.data.urbansound import (
        UrbanSoundHFSource, UrbanSoundLocalSource, get_batchers)

    if args.dataset == "urbansound8k":
        src = UrbanSoundHFSource(limit_samples=args.limit_samples)
    elif args.dataset == "local":
        src = UrbanSoundLocalSource(args.data_dir,
                                    limit_samples=args.limit_samples)
        cache_dir = getattr(args, "waveform_cache", None)
        if cache_dir:
            # epochs >= 2 then serve mmap reads instead of re-decoding
            src = src.cached(cache_dir)
    else:
        src = SyntheticClassification(
            num_samples=args.limit_samples or 64, seed=args.seed)
    return get_batchers(src, batch_size=args.batch_size,
                        val_split=args.val_split, seed=args.seed,
                        num_workers=getattr(args, "num_workers", 0))


def get_tokenizer(name_or_path: Optional[str]):
    if name_or_path in (None, "", "byte"):
        return ByteTokenizer()
    return load_tokenizer(name_or_path)


def load_pipeline(model_path: Optional[str], *, tokenizer=None, **kwargs):
    """An EmotionWhisperPipeline from a --model_path value, the one loader
    of the infer, evaluate and evaluate_simple CLIs and the server: an HF
    directory (model.safetensors or pytorch_model.bin) goes to
    `from_hf_dir`, any other path to `from_checkpoint`, and None to
    whisper-tiny with seeded random weights (`torch.Generator` seed 0).
    Keyword arguments (device, compute_dtype, kv_quant, num_beams) go to
    the pipeline on every path."""
    import os

    import torch

    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline

    if model_path is None:
        from audio_transformers_tpu_torch.core.config import \
            EmotionWhisperConfig
        from audio_transformers_tpu_torch.core.params import (init,
                                                              resolve_device)
        resolve_device(kwargs.get("device", "cuda"))
        cfg = EmotionWhisperConfig()
        params = init(cfg, torch.Generator().manual_seed(0))
        return EmotionWhisperPipeline(params, cfg, tokenizer=tokenizer,
                                      **kwargs)
    if any(os.path.exists(os.path.join(model_path, name))
           for name in ("model.safetensors", "pytorch_model.bin")):
        return EmotionWhisperPipeline.from_hf_dir(model_path,
                                                  tokenizer=tokenizer,
                                                  **kwargs)
    return EmotionWhisperPipeline.from_checkpoint(model_path,
                                                  tokenizer=tokenizer,
                                                  **kwargs)
