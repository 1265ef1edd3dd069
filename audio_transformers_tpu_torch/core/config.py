"""Config dataclasses for the whole framework.

The reference scatters configuration across argparse blocks and hardcoded
constants (reference: urban_sounds/train_classifier.py:154-181,
whisper_finetune/train.py:59-83, whisper_finetune/model.py:117). Here every
subsystem is driven by one frozen dataclass tree so configs are hashable
(usable as jit static args), serializable, and testable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


class _ConfigBase:
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        import typing

        # field annotations are strings under `from __future__ import
        # annotations`; resolve them to real types for nested configs
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ftype = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                v = ftype.from_dict(v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# DSP / mel front-end
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MelConfig(_ConfigBase):
    """Parameterization of the fused log-mel front-end.

    One kernel serves both reference pipelines:
      - the UrbanSound torchaudio parameterization
        (reference: urban_sounds/dataset.py:19-24,55-56 — power mel, HTK
        mel scale, no filter norm, natural log(x + 1e-9))
      - the Whisper/HF parameterization
        (reference: whisper_finetune/dataset.py:57-62 via
        WhisperFeatureExtractor — 400-pt FFT, Slaney filters, log10 with
        clamp at 1e-10, dynamic-range max-8 floor, (x+4)/4 normalize, and
        the final STFT frame dropped).
    """

    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 80
    f_min: float = 0.0
    f_max: Optional[float] = None  # None -> sample_rate / 2
    power: float = 2.0
    center: bool = True
    pad_mode: str = "reflect"
    mel_scale: str = "slaney"  # "htk" | "slaney"
    mel_norm: Optional[str] = "slaney"  # None | "slaney"
    # "log_eps": natural log(mel + 1e-9)   (torchaudio/urbansound pipeline)
    # "whisper": log10(clamp(mel,1e-10)); floor at max-8; (x+4)/4
    log_mode: str = "whisper"
    # Whisper's extractor computes T+1 STFT frames and drops the last
    # (30 s * 16 kHz / 160 + 1 = 3001 -> 3000 frames).
    drop_last_frame: bool = True

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            n = num_samples // self.hop_length + 1
        else:
            n = (num_samples - self.n_fft) // self.hop_length + 1
        return n - 1 if self.drop_last_frame else n

    @staticmethod
    def urbansound(sample_rate: int = 22050, n_fft: int = 1024,
                   hop_length: int = 512, n_mels: int = 64) -> "MelConfig":
        """torchaudio.transforms.MelSpectrogram defaults + log(x+1e-9)."""
        return MelConfig(
            sample_rate=sample_rate, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, power=2.0, center=True, pad_mode="reflect",
            mel_scale="htk", mel_norm=None, log_mode="log_eps",
            drop_last_frame=False,
        )

    @staticmethod
    def whisper(sample_rate: int = 16000, n_mels: int = 80) -> "MelConfig":
        """HF WhisperFeatureExtractor parameterization (whisper-tiny: 80 mels)."""
        return MelConfig(
            sample_rate=sample_rate, n_fft=400, hop_length=160, n_mels=n_mels,
            power=2.0, center=True, pad_mode="reflect", mel_scale="slaney",
            mel_norm="slaney", log_mode="whisper", drop_last_frame=True,
        )


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UrbanSoundConfig(_ConfigBase):
    """Conv front-end -> pre-LN transformer encoder -> CNN head classifier.

    Capability-equivalent to the reference UrbanSoundModel
    (reference: urban_sounds/model.py:95-214; defaults at :96-113), with the
    positional-embedding bug (torch.arrange typo, model.py:153) fixed.
    """

    n_mels: int = 64
    num_classes: int = 10
    conv_dim: int = 128
    conv_kernel: int = 3
    encoder_dim: int = 256
    num_encoder_blocks: int = 4
    num_heads: int = 8
    dropout: float = 0.1
    cnn_dims: Tuple[int, ...] = (256, 512)
    max_positions: int = 1000
    # "batch" matches the reference BatchNorm1d; "group" is the
    # DP-friendly deviation (no cross-replica running stats needed).
    norm_type: str = "batch"


@dataclass(frozen=True)
class WhisperConfig(_ConfigBase):
    """Whisper encoder-decoder architecture + special-token vocabulary.

    Matches openai/whisper-tiny (reference: whisper_finetune/model.py:117;
    architecture dump in wandb run output.log:28-81 — d_model 384, 4+4
    layers, 6 heads, ffn 1536, vocab 51865, 80 mel bins).
    """

    vocab_size: int = 51865
    n_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation: str = "gelu"
    # Special tokens (whisper multilingual vocab).
    pad_token_id: int = 50257          # == <|endoftext|>
    bos_token_id: int = 50257
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    no_timestamps_token_id: int = 50363  # <|notimestamps|>
    timestamp_begin_id: int = 50364      # <|0.00|>
    # language/task tokens used by the default forced prefix
    lang_en_token_id: int = 50259        # <|en|>
    transcribe_token_id: int = 50359     # <|transcribe|>

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @staticmethod
    def tiny() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def base() -> "WhisperConfig":
        return WhisperConfig(d_model=512, encoder_layers=6, decoder_layers=6,
                             num_heads=8, ffn_dim=2048)

    @staticmethod
    def small() -> "WhisperConfig":
        return WhisperConfig(d_model=768, encoder_layers=12,
                             decoder_layers=12, num_heads=12, ffn_dim=3072)

    @staticmethod
    def medium() -> "WhisperConfig":
        return WhisperConfig(d_model=1024, encoder_layers=24,
                             decoder_layers=24, num_heads=16, ffn_dim=4096)

    @staticmethod
    def large() -> "WhisperConfig":
        """large-v2 geometry (vocab 51865, 80 mel bins)."""
        return WhisperConfig(d_model=1280, encoder_layers=32,
                             decoder_layers=32, num_heads=20, ffn_dim=5120)

    @staticmethod
    def token_overrides_for_vocab(vocab_size: int) -> dict:
        """Special-token ids that differ by vocab version. large-v3
        (51866) inserts <|yue|> at 50358, shifting every LATER special
        (+1): translate 50359, transcribe 50360, notimestamps 50364,
        timestamps from 50365. <|startoftranscript|> (50258) and the
        language block start are unchanged. Every config-building path
        (presets, config_from_hf, config_from_json) must apply this —
        class defaults are the v2/51865 ids."""
        if vocab_size == 51866:
            return {"no_timestamps_token_id": 50364,
                    "timestamp_begin_id": 50365,
                    "transcribe_token_id": 50360}
        return {}

    @staticmethod
    def large_v3() -> "WhisperConfig":
        """large-v3: 128 mel bins, one extra vocab entry (<|yue|>)."""
        return WhisperConfig(vocab_size=51866, n_mels=128, d_model=1280,
                             encoder_layers=32, decoder_layers=32,
                             num_heads=20, ffn_dim=5120,
                             **WhisperConfig.token_overrides_for_vocab(51866))

    @staticmethod
    def by_name(name: str) -> "WhisperConfig":
        presets = {"tiny": WhisperConfig.tiny, "base": WhisperConfig.base,
                   "small": WhisperConfig.small,
                   "medium": WhisperConfig.medium,
                   "large": WhisperConfig.large,
                   "large-v3": WhisperConfig.large_v3,
                   "test": WhisperConfig.test}
        if name not in presets:
            raise ValueError(f"unknown whisper size {name!r}; "
                             f"choose from {sorted(presets)}")
        return presets[name]()

    @staticmethod
    def test(vocab_size: int = 1024) -> "WhisperConfig":
        """A tiny config for fast unit tests."""
        return WhisperConfig(
            vocab_size=vocab_size, n_mels=80, d_model=64, encoder_layers=2,
            decoder_layers=2, num_heads=2, ffn_dim=128,
            max_source_positions=64, max_target_positions=32,
            pad_token_id=0, bos_token_id=0, eos_token_id=0,
            decoder_start_token_id=1, no_timestamps_token_id=3,
            timestamp_begin_id=4, lang_en_token_id=2, transcribe_token_id=2,
        )


@dataclass(frozen=True)
class EmotionWhisperConfig(_ConfigBase):
    """Whisper + linear emotion head (reference: whisper_finetune/model.py:6-18)."""

    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    num_emotion_classes: int = 10


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodeConfig(_ConfigBase):
    """On-device autoregressive decode configuration.

    Mirrors the generation-parameter surface the reference exercises through
    HF `generate` (reference: whisper_finetune/evaluate_simple.py:125-135,
    evaluate.py:41-58, inference.py:159-216) as jit-compatible logit
    processors.
    """

    max_new_tokens: int = 100
    temperature: float = 0.0          # 0 => greedy
    no_repeat_ngram_size: int = 0
    repetition_penalty: float = 1.0
    # Beam search width; 1 = greedy/sampling (models/whisper/beam.py —
    # a capability BEYOND the reference, whose surfaces only decode
    # greedily: evaluate_simple.py:125-135). HF-parity semantics
    # (BeamSearchScorer): 2N candidates/step, EOS candidates ranked in
    # the top N retire to a kept-N hypothesis set, length_penalty
    # normalizes finished scores.
    num_beams: int = 1
    # Beam-search stop rule (HF early_stopping): True stops a batch row
    # as soon as N hypotheses exist; False keeps going while the best
    # running score could still beat the worst kept hypothesis.
    early_stopping: bool = False
    # Exponent on generated length when scoring finished beam hypotheses
    # (>1 favors longer transcripts). Meaningful only under num_beams>1;
    # for greedy decode it is accepted-and-ignored exactly like the
    # reference, which passes length_penalty=-0.5 to greedy generate
    # (evaluate_simple.py:132) where HF ignores it.
    length_penalty: float = 1.0
    return_timestamps: bool = False
    compression_ratio_threshold: Optional[float] = None
    forced_language_token: Optional[int] = None   # e.g. <|en|>
    forced_task_token: Optional[int] = None       # e.g. <|transcribe|>
    suppress_blank: bool = True
    # "none" | "int8" | "int4": quantize the precomputed cross-attention
    # K/V (per-key / per-channel scales). Decode is bound by re-reading
    # cross-K/V from HBM every step — int8 halves that traffic, int4
    # (nibble-packed, ops/decode_attention.pack_int4) quarters it at a
    # further accuracy cost. Long decodes also quantize the self cache
    # (int8 in both modes — see decode.generate). Off by default: greedy
    # token parity with fp32/bf16 decode is only approximate under
    # quantization.
    kv_quant: str = "none"
    # "auto" | "fused" | "xla": how a greedy step's vocab projection,
    # logit processors and token pick run (decode.resolve_logits_impl).
    # "fused" is K2 (ops/decode_logits.fused_greedy_step: the (B, V)
    # logits never reach device memory); "xla" materialises the float32
    # logits and runs decode._process_logits and an argmax, the
    # reference's XLA chain; sampling always takes "xla". "auto" is
    # "fused" on the card and on the CPU (where K2's plain version runs):
    # the decode loop is held by the host, and the materialised chain
    # adds several launches a step for K2's one, which on an H100
    # (chip_smoke.py phase 31, PERF.md) never made a greedy step faster
    # beyond the run-to-run spread. The reference's "auto" differs: XLA
    # off a TPU. Anything else raises ValueError.
    logits_impl: str = "auto"
    # "auto" | "mm" | "take" | "pallas": how beam search's per-step
    # parent reorder of the self-KV cache runs (HF _reorder_cache).
    # "take" (the jnp.take row gather) is lowered pathologically by XLA
    # inside the decode while_loop (+12.1 ms/step at b128/N=4); "mm"
    # expresses the permutation as a one-hot MXU matmul (exact per
    # dtype — beam._permute_rows_mxu; 17.1 -> 6.4 ms/step,
    # scripts/beam_stage_ab.py); "pallas" (ops/permute.py) does the
    # copy as a scalar-prefetch gather kernel but measures 13.3 vs mm's
    # 5.9 ms/step in production (the custom call defeats the while-loop
    # carry aliasing — scripts/beam_reorder_pallas_ab.py), kept as the
    # exactness oracle. "auto" = "mm" on TPU, "take" elsewhere. A
    # CONFIG field for the same jit-cache-key reason as self_kv_min.
    beam_reorder: str = "auto"
    # Minimum decode-buffer length at which BEAM search quantizes the
    # self-KV cache when kv_quant is set (greedy gates on self_kv_min).
    # Default 0: always quantize alongside the cross KV. Measured a
    # speed TIE at the short budget (5.308 vs 5.351 ms/step at
    # b128/N=4/L=68, scripts/beam_reorder_pallas_ab.py mm_i8s vs
    # mm_i8), but it halves the dominant L-proportional beam costs
    # (the per-step reorder bytes and the self-attention re-read),
    # halves beam decode-state memory per row, and keeps short and
    # long budgets in one quantization regime. Set >= self_kv_min to
    # recover the legacy greedy gating for A/B.
    beam_self_kv_min: int = 0
    # "auto" | "merged" | "perbeam": how beam search selects its 2N
    # step candidates. "merged" materializes HF's (B, N*V) logp+score
    # candidate buffer and top-k's it; "perbeam" top-k's each (B*N, V)
    # row FIRST (a per-row constant cannot change within-row order),
    # adds the beam scores to the 2N survivors, and merges N*2N tiny
    # candidates per batch row — skipping the 106 MB merged f32 buffer
    # and its unaligned (N*V % 128 != 0) relayout. 6.24 -> 5.94 ms/step
    # at b128/N=4 on chip (scripts/beam_stage_ab.py hyp_mmS vs
    # hyp_mmT2). "auto" = "perbeam" on TPU, "merged" elsewhere. Same
    # jit-cache-key rationale as self_kv_min. Tie caveat in
    # beam.resolve_beam_topk.
    beam_topk: str = "auto"
    # Minimum decode-buffer length at which the self-attention KV cache
    # is quantized (int8, for kv_quant "int8" and "int4") alongside the
    # cross K/V (decode.generate); shorter decodes keep it in the
    # activation dtype. It changes the numerics, so the port keeps the
    # reference's 192; on the card the int8 self cache costs more
    # launches a step than it saves in bytes at whisper-tiny's widths.
    self_kv_min: int = 192
    # "auto" | "fused" | "xla": a greedy or sampled decode step's
    # cross-attention (models/whisper/model.resolve_step_attn). "fused" is
    # K1 (ops/decode_attention.decode_cross_attention: q and p never
    # quantized); "xla" is the reference's XLA arithmetic
    # (model.xla_cross_attention: int8 quantizes q and p). "auto" is
    # "fused" on the card and on the CPU: on an H100 (chip_smoke.py phase
    # 31, PERF.md) the XLA arithmetic, several launches a layer for K1's
    # one, made the greedy step slower with int8 and int4 cross K/V, in
    # float32 and bf16, and lay within the run-to-run spread with
    # kv_quant none. The reference's "auto" is XLA off a TPU. Beams
    # ignore it in both packages. Anything else raises ValueError.
    step_attn: str = "auto"


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig(_ConfigBase):
    name: str = "adamw"               # "adam" | "adamw"
    learning_rate: float = 3e-5
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: Optional[float] = None
    # schedule: "constant" | "linear_warmup_decay" | "reduce_on_plateau"
    schedule: str = "constant"
    warmup_fraction: float = 0.1      # of total steps (linear_warmup_decay)
    plateau_patience: int = 5         # epochs (reduce_on_plateau)
    plateau_factor: float = 0.1


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    batch_size: int = 32
    num_epochs: int = 10
    seed: int = 42
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # bf16 activations on TPU; params stay fp32.
    compute_dtype: str = "bfloat16"
    emotion_weight: float = 0.5       # dual-loss mix (reference train.py:227)
    # SpecAugment time/freq masking applied post-mel in the train step
    # (ops/specaugment.py; off by default — the reference trains without
    # feature augmentation)
    spec_augment: bool = False
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    # mesh axes, e.g. (("data", -1),) or (("data", -1), ("model", 2))
    mesh_shape: Tuple[Tuple[str, int], ...] = (("data", -1),)
    remat: bool = False               # jax.checkpoint the encoder/decoder blocks
    # "xla" | "flash" | "auto": attention implementation for training
    # (flash = fused Pallas kernels with the custom-VJP backward;
    # auto = flash on TPU, xla elsewhere)
    attn_impl: str = "auto"


@dataclass(frozen=True)
class DataConfig(_ConfigBase):
    dataset: str = "synthetic"        # "urbansound8k" | "expresso" | "synthetic" | "local"
    data_dir: Optional[str] = None
    sample_rate: int = 16000
    duration: float = 4.0
    limit_samples: Optional[int] = None
    data_percentage: float = 1.0
    val_split: float = 0.2
    test_split: float = 0.1
    seed: int = 42
    num_workers: int = 4
