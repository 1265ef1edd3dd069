#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (audio_transformers_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and the repository around this file. Phases,
each raising on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a), one
     nvcc per source, all started together;
  3. each serving kernel against its plain PyTorch version on the card at
     the serving path's shapes (B in {4, 16}, and for K1 and K2 also
     B = 1, for K2 also B = 128; T=1500, V=51865 padded to 52224, 30 s
     audio), with the tolerances below, and their times (CUDA events,
     median of 20 after warm-up); for K3 also B = 1, two launches
     bit-equal, one launch per call (the wrapper's counter and the
     profiler: one K3 kernel a call, no padding kernel), its device time
     and the whole call's (torch.profiler), torch.stft's device time on
     the same clips (Hann 400, hop 160, centred, reflect: the STFT alone,
     a yardstick only), the kernel's and the plain version's error
     against the float64 golden `reference_log_mel` at B = 4, and
     UrbanSound's preset (n_fft 1024) on 16 clips of 4 s against its plain
     version and the golden; for K2 (bf16: csrc/decode_logits_sm90.cu)
     two launches bit-equal, one launch per call (the wrapper's counter
     and the profiler's kernel count) and its device time
     (torch.profiler); for K1 two launches bit-equal, the time of torch's
     scaled_dot_product_attention (SDPA) on the same bf16 q, K, V (one
     query; K and V in SDPA's (B, H, T, hd) layout, and as transposed
     views of the kernel's time-minor tensors), and the device time of K1
     and of SDPA on (B, H, T, hd) K/V (torch.profiler: at about 0.01 ms a
     call's event time is mostly host time); K1's int4 mode (nibble-packed
     K/V, even/odd K scales) at B = 1, 4, 16 with bf16 and float32 q, all
     1500 keys and an odd t_valid of 1499, two launches bit-equal, its
     per-call and device times beside int8's device time in the same
     call;
  4. correctness on a small input: the port's pipeline at the test config
     in float32 on the card (kernels) equals the same pipeline on the CPU
     (plain versions);
  5. the serving path: EmotionWhisperPipeline.analyze of a 12 s clip at the
     full width of whisper-tiny (seeded random weights, bfloat16), with
     every kernel's launch counter reset just before and read just after:
     K1, K2, K3 and K4a (the encoder's self-attention, one launch a layer
     in each `encode`) launched; then K1's device records (dca_split,
     torch.profiler) over three more calls, whose decodes replay a
     captured step, equal to the launches
     `_build.STATS` counts for them;
  6. the HTTP server on 127.0.0.1 with the micro-batcher, answering three
     concurrent /analyze requests;
  7. the flash-attention kernels K4a/b/c against their plain versions at
     the training shapes of whisper-tiny at batch 16 (B*H = 96, d = 64:
     encoder self-attention 1500 x 1500, decoder causal self-attention
     31 x 31, cross-attention 31 x 1500) and two ragged ones (65 x 65
     causal, 129 x 1500), float32 and bfloat16, two launches of each
     bit-equal, and their times in bfloat16, beside SDPA's forward and its
     backward (torch.autograd.grad with retain_graph) on the same inputs,
     with the backend SDPA chose, and the kernels' device time
     (torch.profiler); in bfloat16 K4a/K4b/K4c are the tensor-core
     kernels of csrc/flash_attention_sm90.cu, in float32 the FMA kernels
     of csrc/flash_attention.cu; then K4a alone at the serving encoder's
     shape (B*H = 1280: 64 windows of whisper-large-v3's 20 heads,
     1500 x 1500, d = 64, non-causal, bfloat16) against its plain version
     at the same tolerance, two launches bit-equal, its per-call, device
     and bound times beside SDPA's forward (per call and device);
  8. correctness of one train step on a small input: the test config in
     float32, kernels on the card against plain versions on the CPU;
  9. the training path: the train_whisper CLI on whisper-tiny (bfloat16,
     synthetic 30 s clips, batch 8, 10 train steps and one eval), with
     every launch counter reset just before and read just after; it
     writes checkpoints/ and resume/, each save timed, kept for phase 21;
  10. a fixed batch overfit for 20 constant-lr steps: the loss falls;
  11. steady-state train-step time at batch 16, flash kernels against the
     plain attention, four turns each in alternating order;
  12. the beam reorder K5 against its plain version on the card, on the
     whisper-tiny beam step's own buffers at L=66 (8 self K/V of
     (rows, 6, 64, 66) in bf16, or in int8 with 8 f32 scales of
     (rows, 6, 66); the (rows, 52224) int8 seen mask; (rows, 66) int64
     tokens) at rows = 64 (B=16 x N=4) and 512 (B=128 x N=4), with
     repeated parents, and their times per call (CUDA events, median of 20
     after warm-up), as for the other kernels, and the device time of the
     kernels alone (torch.profiler);
  13. correctness on a small input: a beam pipeline (num_beams=3) at the
     test config in float32 on the card equals the same pipeline on the
     CPU;
  14. the beam serving path: EmotionWhisperPipeline(num_beams=4).analyze of
     a 12 s clip at whisper-tiny width (seeded weights, bfloat16), with
     kv_quant "none", "int8" and "int4", launch counters reset around each;
  15. the HTTP server with that beam pipeline, three concurrent requests;
  16. beam decode ms per step at B=16 and B=128 (N=4, seeded random
     encoder states), the K5 reorder against its plain version (one
     index_select per buffer, patched in for the plain turns), in five
     turns each: the time of a 64-token decode less that of a 16-token
     one, over 48;
  17. correctness of evaluation on a small input: evaluate_sequence_level
     and evaluate_segment_level (infer/evaluate.py) at the test config
     (timestamps moved to ids >= 600) in float32, kv_quant "none" and
     "int4", the fallback re-decoding every row with text, on the card and
     on the CPU with the same Gumbel noise (drawn on the CPU and moved to
     the card through decode.gumbel_noise): the decoded tokens equal and
     the four files (metrics.txt and predictions.txt, predictions.txt and
     segment_evaluation.txt) identical;
  18. segment evaluation at whisper-tiny width: evaluate_segment_level on 8
     synthetic 30 s clips in batches of 4 (seeded weights, bfloat16, the
     reference's decode: timestamps, 256 new tokens, repetition penalty
     1.1, no-repeat 3-gram), kv_quant "none" and "int4", with the
     fallback at the reference's 2.4 (byte tokenizer) and at 1e-6 over the
     id bytes, which re-decodes every row at temperature 0.7; counters
     reset around each run: K1 (every call in int4 mode with int4, and
     its launches the eager calls plus each replayed step's decoder
     layers), K2 (in its timestamp mode) and K3 launched, no plain version
     on CUDA;
     the wall time, segments, re-decoded rows and launches logged;
  19. the same evaluation with 4 beams and int4 cross K/V: K5 launched;
  20. model I/O, the HF directory: phase 5's seeded whisper-tiny exported
     by the port (`export_hf_dir`; also a copy with pytorch_model.bin in
     place of model.safetensors), each loaded on the card through
     `cli.common.load_pipeline`: greedy `analyze` of the 12 s clip gives
     phase 5's tokens and probabilities exactly, through K1, K2 and K3,
     with no plain version on CUDA; then `cli.infer --num_beams 4` over
     the directory (K5). Export, load and first-analyze wall times;
  21. model I/O, checkpoints: phase 9's resume/ bundle (params and AdamW
     moments) restored, `cli.infer` over its checkpoints/ on the card
     (K1, K2, K3), `train_whisper --pretrained` from phase 20's directory
     (K4a/b/c), and at the test config in float32 2 epochs straight
     against 1 epoch, a preemption and a resume to 2: the parameters
     bit-equal, else the largest difference within 2 * steps * lr (PERF.md
     §6). Every load and save wall time is logged beside the card's name
     and power limit;
  22. the UrbanSound classifier at the test widths (conv 32, encoder 32,
     2 blocks, CNN head 32 and 48) in float32, dropout 0: 3 train steps
     and one eval on the card (K3) against the same on the CPU (plain
     versions), on 4 s clips and on 3 s clips zero-padded to 4 s; then K3
     at UrbanSound's preset on 16 clips zero-padded to 4 s at five
     lengths (3 s, and the lengths that put the last frame with signal or
     the first silent one at either place of its FFT pair);
  23. the classifier's training path at full width through the CLI:
     `train_classifier --dataset synthetic --batch_size 64 --epochs 2
     --limit_samples 320 --compute_dtype bfloat16 --spec_augment`, launch
     counters reset around the run: K3 launched once per train and eval
     step and no plain version on CUDA; `best_model.safetensors` read back
     by the port's reader with the reference's keys; a rerun to 3 epochs
     resumes from checkpoints-resume; clips/s, data wait and each save's
     wall time logged;
  24. the classifier's steady-state train step at full width, batch 64,
     bf16, SpecAugment, dropout 0.1: the mean of 20 steps by CUDA events,
     device busy, idle share, K3's device time and the kernels per step
     from torch.profiler over 10 steps; K3 alone at (64, 88200) against
     its plain version and its bound;
  25. remat: the whisper-tiny train step (bf16, flash) with remat off and
     on, two turns each: K4's launches in a step (K4a 12 off, 24 on; K4b
     and K4c 12), the first step's loss and gradients at batch 16
     (bit-equal expected, cuDNN deterministic for the phase), and the
     peak memory (torch.cuda.max_memory_allocated) and ms per step at
     batch 16 and at REMAT_BATCH;
  26. data parallelism at world size 1: this process joins an NCCL group
     of one by passing a coordinator, and both trainers (the test config
     and the classifier's test widths, bf16, SpecAugment, 2 epochs) run
     through every collective: parameters and BatchNorm state bit-equal
     to the run without a group, K3 and K4 launched, no plain version on
     CUDA; the batch-16 whisper-tiny step with and without the group in
     turns, and the gradient all-reduce alone;
  27. data parallelism with two ranks on the one card: two processes in a
     gloo group (NCCL refuses two ranks on one device) run the cases of
     tests/torch_dp_worker.py in float32 (the classifier with BatchNorm,
     dropout and SpecAugment, and without draws; whisper with label
     lengths that give the ranks unequal token counts; evaluate; one
     epoch of each trainer), held to the same cases in one process on
     the whole batch; every rank launches K3, and K4 for whisper;
  28. `entry.entry()`'s forward (whisper-tiny, emotion head, log-mel) on
     the card: K3 launched, finite outputs of the expected shapes;
  29. K2's vocab-shard mode (tensor parallelism) at whisper-tiny width,
     bf16, on t = 2 and 4 shards of the padded vocab (26112 and 13056
     ids), B = 1, 4, 16, 128, penalty+ban and timestamps: one launch a
     shard, each shard's partials beside its plain version's, and the
     tokens `merge_partials` makes of them equal to the unsharded K2's on
     the rows `_k2_decidable` passes; the device time of a shard's call
     beside its bound (its table bytes over 3.35 TB/s);
  30. tensor parallelism at whisper-tiny width (6 heads, 3 a rank) in two
     gloo processes on the one card (scripts/tp_multicard.py's
     `run_mesh`, one launch): the greedy timestamped decode of a
     12 s clip in float32, token-equal to one process, and in bf16,
     token-equal up to the first position whose one-process margin lies
     under the bound the measured hidden difference allows
     (`tp_multicard.hold_decode`); both ranks launch K1, K2's shard mode
     and K3, and K1 is held to its plain version at B * 3 rows; 4 beams
     on the same clip (48 new tokens, penalty 1.15, 3-gram ban; kv_quant
     none, int8, int8 with timestamps; float32 and bf16), each rank on
     its heads, the logits gathered to whole rows each step, the ranks'
     choices compared every step: float32 equal to one process's kept
     beams and lengths, scores within 1e-5 relative; bf16 equal up to a
     step whose one-process deciding margin lies under the bound the
     measured hidden differences allow (`tp_multicard.hold_beam`); both
     ranks launch K5 once a step; one TP classifier train step
     (UrbanSoundConfig() at full width, batch 64 of 4 s clips, dropout
     0.1; float32 and bf16) against one process (float32: loss 1e-6
     relative, gradients 1e-4 * max(1, max |g|); bf16: loss 2e-2
     relative), its whole leaves, their Adam moments and BatchNorm's
     state bit-equal over the ranks under cuDNN's default algorithms, K3
     launched on both, a second step's collectives counted and timed;
     one TP train step (batch 2, float32, flash) through the
     vocab-parallel cross-entropy, its loss within 1e-6 relative of one
     process's and of the route that gathers the logits, its gradients
     within 1e-4 * max(1, max |g|) of both, each route's collectives
     counted (50 all-reduces and 1 broadcast a step), K3 and K4 launched
     on both ranks, the whole leaves and their Adam moments bit-equal
     over the ranks after three steps; for both steps the broadcast of
     the whole leaves' gradients against an all-reduce of them
     (`tp_multicard.reconcile_times`), and the step with and without it
     in turns;
  31. the greedy decode's routes: `analyze` of the 12 s clip at
     whisper-tiny width (its transcription and segment decodes), float32
     and bf16, kv_quant none, int8 and int4,
     through each DecodeConfig (step_attn, logits_impl) of "fused"
     (K1, K2) and "xla" (the reference's XLA arithmetic): K1 launched only
     under step_attn "fused", K2 only under logits_impl "fused", at the
     counts of fed and generated positions; in float32 with kv_quant none
     the four routes token-equal; the float32 "xla" decodes held to the
     same route on the CPU up to `tp_multicard.hold_decode`'s near-tie
     rule; the decode's ms per step for each combination, in two turns;
  32. scripts/parity_rehearsal_torch.py at full width on 40 clips for 2
     epochs (bf16): the training and evaluation kernels launched, the
     train and val losses falling, the summary and eval files written;
  33. K6, the grouped SwiGLU expert GEMM of Uni-MoE-2.0-Omni's routed
     experts (D 3584, F 18944, 4 experts, bf16), at the omni cell's
     shapes: a decode step's 64 slots on one, two and four experts and a
     prefill's 31,248 slots with 18,900 routed: against its plain version
     on the same inputs, the slots past the routed ones zero, two
     launches bit-equal, one launch of each half a call (counter) and two
     K6 kernels a call (profiler), its times beside the plain version's,
     one cuBLAS chain per active expert and its bound; then its launches
     in `OmniPipeline.generate` at a small Uni-MoE (2 layers): one of
     each half per layer in the prefill and in every replayed step.

Tolerances (kernel vs plain version, on the card):
  K1 decode_cross_attention: 1e-5 abs in float32 (sum order only);
     2e-2 abs in bfloat16 (one bf16 ulp of the output); the same in int4
     mode by q's dtype.
  K2 fused_greedy_step: tokens equal on every row whose plain top-2 gap
     (and, with timestamps, the margin of the probability rule) exceeds
     1e-3; rows below that gap are reported, not compared.
  K3 log_mel: 2e-4 abs on the final features (f32 sums in another order,
     then log10); against the float64 golden, bin by bin, the larger of
     2e-5 + 1e-5 |ref| (the JAX package's golden tolerance) and
     `mel_cuda.golden_error_bound` (how far any float32 front end may lie
     from the golden: a float32 DFT's per-bin error, GOLDEN_ERR * u *
     sqrt(N) * ||frame||, carried through the power, the filterbank, the
     log and whisper's max - 8 floor).
  K4a/b/c flash attention fwd, dq, dk/dv: in float32, max|err| <= 2e-5 *
     max(1, max|plain|) (sum order only); in bfloat16, within two bf16
     ulps at the tensor's largest magnitude (the output is rounded to
     bf16, and the kernel rounds p against its running maximum where the
     plain version takes the final one). For dq and dk that magnitude is
     taken no smaller than 2^-17 * d * max|dO| * max|v| * max(max|q|,
     max|k|): ds = p (dP - delta) cancels (exactly when Tk = 1), leaving
     the float32 sum-order noise of dP, about 2^-24 d max|dO| max|v| per
     entry, in both versions.
  K3 on clips zero-padded to 4 s (UrbanSound's preset): K3_TOL +
     `mel_cuda.frame_error_bound`, the float32 rounding of the frame's
     own FFT (the kernel balances each pair's energies) carried through
     the power, the filterbank and log(mel + 1e-9) (derived in its
     docstring).
  K5 permute_rows: bit for bit (a pure copy).
  K6 expert_swiglu: 2e-2 of the plain output's largest magnitude (both
     sum in float32 and round the intermediate to bf16, in another order,
     so an intermediate can land one bf16 ulp apart); the plain version
     with the experts' weights moved by one must lie outside it.
  The classifier, card vs CPU (test widths, float32, 3 steps): losses and
     the eval loss within 1e-4 relative; logits within 1e-3 * max(1,
     max|cpu|); parameters and BatchNorm running statistics within 2 *
     steps * lr (Adam; the conv biases before BatchNorm get only
     sum-order noise as gradient, and the running means take them in).
  Remat against no remat (phase 25): bit-equal; failing that, the loss
     within 1e-4 relative and every gradient within 1e-3 * max(1, max|g|)
     (phase 8's bound; only the recompute's sum order could differ).
  Two ranks against one (phase 27, float32): the CPU tests' tolerances:
     loss 1e-5 relative, gradients 1e-4 * max(1, max|g|) per leaf, BN
     state 1e-6, eval metrics 1e-6 relative, an epoch's history 1e-3
     relative (Adam turns rounding-level gradients into steps of lr);
     the ranks' gradients bit-equal.
  One train step, card vs CPU (test config, float32): losses within 1e-4
     relative; gradients within 1e-3 * max(1, max|cpu|) per leaf (log-mel
     features differ by up to 2e-4); updated parameters within 2 * lr + 1e-6
     (the first Adam update is +-lr per element, so an element whose tiny
     gradient flips sign under sum-order noise moves 2 * lr apart).

The next-to-last line is a JSON object with one entry per kernel: its
time and its plain version's at the path's shape, `bound_ms` (the larger
of the bytes it must move over 3.35 TB/s and its operations over the peak
rate of their type, 989 TFLOP/s bf16 or 67 TFLOP/s float32, computed from
this run's inputs) and `bound_by`, and `library_ms`, the time of one
PyTorch call computing the same function where there is one (SDPA for
K1, on K/V in its own layout, and for K4; its backward computes K4b and
K4c together), else null; K1's entry also has `device_ms` and
`library_device_ms` (profiler kernel time of K1 and of that SDPA call),
`int4_*_b{1,4,16}` (the int4 mode's times, bound and int8's device time;
no library call takes nibble-packed K/V) and `launches_eval_int4` (every
serving kernel's entry has it: its launches in phase 18's int4 run at
threshold 2.4),
K2's `device_ms`, K3's `device_ms` and `kernels_per_call` (K3's own),
`call_device_ms` and `call_kernels` (the whole `log_mel` call: K3 and the
whisper floor after it) and `stft_ms` (torch.stft's device time, no
library call of the same function: the STFT alone); K3's
`launches_classifier` (phase 23's first run), `classifier_*_b64` (phase
24's step: ms, busy ms, idle share, kernels, K3's device ms),
`urbansound_b64_*` (K3 alone at the classifier's batch) and its errors on
zero-padded clips (`max_abs_err_padded`, `padded_share_of_bound`), and
its launches under data parallelism (`launches_dp_world1`, phase 26's
run; `launches_dp_two_ranks`, each rank's in phase 27's first case)
beside phase 26's step times and `average_gradients` time (in a group
of one: the flatten, divide and copy back; NCCL over one rank launches
no kernel) and phase 27's errors;
every K4 entry's `launches_remat` (phase 25's step with remat), and
K4a's `remat_*` fields (phase 25's peak MiB and ms per step),
`launches_serving` (phase 5's analyze) and `serve_*` (phase 7's serving
shape). The entry
`fused_greedy_step_partials` is K2's vocab-shard mode: its launches on
rank 0 of phase 30's bf16 decode, phase 29's times at t = 2 and B = 4
(and `*_t{2,4}_b{1,4,16,128}`), and phase 30's results (`tp_decode`,
`tp_train`); K1's and K3's entries carry `launches_tp_rank0`; K5's
`launches_tp_beam` (rank 0's in phase 30's bf16 beams) and `tp_beam`,
K3's `launches_tp_classifier` (rank 0's in the bf16 TP classifier step)
and `tp_classifier`; K1's and K2's `launches_routes` (phase 31's launches
by dtype/kv_quant/step_attn/logits_impl) and `routes_ms_per_step`; every
entry but K5's and K2's shard mode's `launches_rehearsal` (phase 32).
The entry `expert_swiglu` is K6 (phase 33): its launches in the small
`generate`, the two-expert decode shape's times as the main fields
(`device_ms` the two K6 kernels' own; `library_ms` the per-expert cuBLAS
chain) and every shape's as `*_decode_e{1,2,4}` and `*_prefill`.
The last line is {"ok": true, "device": {...}}. Nothing of JAX is
imported.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

HERE = os.path.dirname(os.path.abspath(__file__))

K1_TOL_F32, K1_TOL_BF16, K2_GAP, K3_TOL = 1e-5, 2e-2, 1e-3, 2e-4
K4_TOL_F32, K4_ULPS_BF16 = 2e-5, 2
K6_TOL = 2e-2
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# traces taken of one profiled function before an empty one fails it
PROFILE_TRIES = 5
REPLACES = {
    "decode_cross_attention": "audio_transformers_tpu/ops/decode_attention.py:100",
    "fused_greedy_step": "audio_transformers_tpu/ops/decode_logits.py:82",
    "fused_greedy_step_partials":
        "audio_transformers_tpu/ops/decode_logits.py:82",
    "log_mel": "audio_transformers_tpu/ops/mel_pallas.py:67",
    "flash_attention_fwd": "audio_transformers_tpu/ops/attention.py:42",
    "flash_attention_bwd_dq": "audio_transformers_tpu/ops/attention.py:147",
    "flash_attention_bwd_dkv": "audio_transformers_tpu/ops/attention.py:187",
    "permute_rows": "audio_transformers_tpu/ops/permute.py:45",
}
SOURCES = {
    "decode_cross_attention": "audio_transformers_tpu_torch/csrc/decode_attention.cu",
    "fused_greedy_step": "audio_transformers_tpu_torch/csrc/decode_logits_sm90.cu",
    "fused_greedy_step_partials": "audio_transformers_tpu_torch/csrc/decode_logits_sm90.cu",
    "log_mel": "audio_transformers_tpu_torch/csrc/mel.cu",
    "flash_attention_fwd": "audio_transformers_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_bwd_dq": "audio_transformers_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_bwd_dkv": "audio_transformers_tpu_torch/csrc/flash_attention_sm90.cu",
    "permute_rows": "audio_transformers_tpu_torch/csrc/permute.cu",
}
SERVING = ("decode_cross_attention", "fused_greedy_step", "log_mel")
TRAINING = ("log_mel", "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
BEAM = ("permute_rows", "log_mel")
N_BEAMS = 4
# training shapes at whisper-tiny width and batch 16, then two ragged
# ones: (name, Tq, Tk, causal)
K4_SHAPES = (("encoder", 1500, 1500, False), ("decoder", 31, 31, True),
             ("cross", 31, 1500, False), ("ragged65", 65, 65, True),
             ("ragged129", 129, 1500, False))
# the serving encoder's self-attention (`large-v3-offline-b64`): 64
# windows x 20 heads, T, forward only, non-causal
K4_SERVE = (64, 20, 1500)


def synth_clip(duration, sr, *, freq=440.0, noise=0.05, seed=0):
    """Deterministic sine + noise clip (float32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration * sr)) / sr
    return (0.5 * np.sin(2 * math.pi * freq * t)
            + noise * rng.standard_normal(len(t))).astype(np.float32)


class ByteTokenizer:
    """UTF-8 bytes offset by 8 special ids: enough to turn the test
    config's token ids into comparable text."""

    def decode(self, ids, skip_special=True):
        data = bytes(i - 8 for i in ids if 8 <= i < 264)
        return data.decode("utf-8", errors="replace")


def log(*args):
    print(*args, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_events(fn, reps=20, whole=None):
    """[(name, us)] of the kernels `reps` calls of fn() launched, from
    torch.profiler after a warm-up call and one more call inside the
    profiler's warm-up cycle, which it does not record (the records of
    the first kernels after the profiler starts go missing now and then:
    19 of 20 one-kernel calls, as `profiled_window` found). A trace that
    holds no kernel, or that `whole(events)` rejects (by default: a count
    that is no whole multiple of `reps`), is taken again, up to
    PROFILE_TRIES times, and said so; when none is whole, the fullest is
    returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    fullest = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events and (whole(events) if whole else len(events) % reps == 0):
            return events
        log(f"the profiler's trace {attempt + 1} of {PROFILE_TRIES} holds "
            f"{len(events)} kernels for {reps} calls")
        fullest = max(fullest, events, key=len)
    return fullest


def device_profile(fn, reps=20):
    """(ms, kernels) of one fn(): the summed device time of the kernels it
    launched and their number, from torch.profiler over `reps` calls after
    a warm-up. Unlike time_ms, it leaves out the host time of a call.
    The time is taken over the calls the trace holds: one that lost its
    first records (`kernel_events`) holds fewer than `reps`."""
    kernels = [us for _, us in kernel_events(fn, reps)]
    require(kernels, "the profiler recorded no kernel")
    calls = len(kernels) / max(1, round(len(kernels) / reps))
    return sum(kernels) / calls / 1e3, len(kernels) / reps


def device_ms(fn, reps=20):
    """Device time of one fn() in ms (device_profile)."""
    return device_profile(fn, reps)[0]


def bound(nbytes, flops, flops_per_s):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the peak
    rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def sdpa_backend(fn):
    """The names of the aten attention ops one call of fn runs (they name
    the backend SDPA chose: flash, efficient, cudnn or math)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if "attention" in e.name and e.name.startswith("aten::_")})
    return ",".join(names) or "unknown"


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_k1(torch, da, gen, results):
    dev = "cuda"
    h, hd, t = 6, 64, 1500
    worst = 0.0
    for b in (1, 4, 16):
        q = torch.randn((b, h, hd), generator=gen, device=dev)
        k = torch.randn((b, h, hd, t), generator=gen, device=dev)
        v = torch.randn((b, h, hd, t), generator=gen, device=dev)
        ks = k.abs().amax(dim=2) / 127.0
        vs = v.abs().amax(dim=3) / 127.0
        k8 = torch.round(k / ks[:, :, None, :]).to(torch.int8)
        v8 = torch.round(v / vs[:, :, :, None]).to(torch.int8)
        cases = [("f32", q, k, v, {}, K1_TOL_F32),
                 ("bf16", q.bfloat16(), k.bfloat16(), v.bfloat16(), {},
                  K1_TOL_BF16),
                 ("int8+bf16q", q.bfloat16(), k8, v8,
                  {"k_scale": ks, "v_scale": vs}, K1_TOL_BF16),
                 ("int8+f32q", q, k8, v8, {"k_scale": ks, "v_scale": vs},
                  K1_TOL_F32)]
        for name, qq, kk, vv, kw, tol in cases:
            got = da.decode_cross_attention(qq, kk, vv, **kw)
            got2 = da.decode_cross_attention(qq, kk, vv, **kw)
            want = da.decode_cross_attention_reference(qq, kk, vv, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            log(f"K1 B={b} {name:10s} max_abs_err={err:.3e} (tol {tol}); "
                f"two launches bit-equal")
            require(err <= tol, f"K1 {name} B={b}: {err} > {tol}")
            require(torch.equal(got, got2),
                    f"K1 {name} B={b}: two launches differ")
            if name != "f32":
                worst = max(worst, err)
        # the serving path's operands: bf16 q, bf16 K/V
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        ms = time_ms(lambda: da.decode_cross_attention(qb, kb, vb))
        plain = time_ms(lambda: da.decode_cross_attention_reference(qb, kb,
                                                                    vb))
        # SDPA on the same values, one query: K and V in the (B, H, T, hd)
        # layout it is built for (the cross K/V are written once per clip,
        # so their layout is free), and as views of the kernel's time-minor
        # (B, H, hd, T) tensors, which send it to its math backend
        want = da.decode_cross_attention_reference(qb, kb, vb)
        sq = qb[:, :, None, :]
        lib, backend = {}, {}
        for layout, (sk, sv) in (
                ("contiguous", (kb.transpose(2, 3).contiguous(),
                                vb.transpose(2, 3).contiguous())),
                ("time-minor", (kb.transpose(2, 3), vb.transpose(2, 3)))):
            def sdpa(sk=sk, sv=sv):
                return torch.nn.functional.scaled_dot_product_attention(
                    sq, sk, sv)
            got = sdpa()
            torch.cuda.synchronize()
            lib_err = (got[:, :, 0].float() - want.float()).abs().max().item()
            require(lib_err <= K1_TOL_BF16,
                    f"SDPA {layout} B={b}: {lib_err} > {K1_TOL_BF16}")
            lib[layout] = time_ms(sdpa)
            backend[layout] = sdpa_backend(sdpa)
            if layout == "contiguous":
                lib_dev = device_ms(sdpa)
        # at about 0.01 ms a call's event time is mostly the Python
        # wrapper's; the profiler's kernel time is the card's own
        dev_ms = device_ms(lambda: da.decode_cross_attention(qb, kb, vb))
        bnd = bound(nbytes(qb, kb, vb, qb), 4 * b * h * t * hd, BF16_FLOPS)
        log(f"K1 B={b} bf16 time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            + ", ".join(f"SDPA {layout} {lib[layout]:.4f} ms "
                        f"({backend[layout]})" for layout in lib)
            + f"; device time: kernel {dev_ms:.4f} ms, SDPA contiguous "
            f"{lib_dev:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, "
            f"{100 * bnd[0] / dev_ms:.1f}% of it by device time); split "
            f"plan {da.split_plan(b * h, t, 2, hd)}")
        results.setdefault(b, {})["decode_cross_attention"] = {
            "ms": ms, "plain_ms": plain, "library_ms": lib["contiguous"],
            "library": "scaled_dot_product_attention, (B, H, T, hd) K/V "
                       f"({backend['contiguous']})",
            "library_time_minor_ms": lib["time-minor"],
            "device_ms": dev_ms, "library_device_ms": lib_dev,
            "bound_ms": bnd[0], "bound_by": bnd[1]}
    return worst


def check_k1_int4(torch, da, gen, results):
    """K1's int4 mode (nibble-packed K/V, even/odd K scales) against its
    plain version at the path's shapes, bf16 and float32 q, all keys and
    an odd t_valid (the last byte's high nibble masked), two launches
    bit-equal; its per-call and device times, and int8's device time in
    the same call."""
    dev = "cuda"
    h, hd, t = 6, 64, 1500
    worst = 0.0
    for b in (1, 4, 16):
        q = torch.randn((b, h, hd), generator=gen, device=dev)
        k = torch.randn((b, h, hd, t), generator=gen, device=dev)
        v = torch.randn((b, h, hd, t), generator=gen, device=dev)
        ks, vs = k.abs().amax(dim=2) / 7.0, v.abs().amax(dim=3) / 7.0
        kp = da.pack_int4(torch.round(k / ks[:, :, None, :]))
        vp = da.pack_int4(torch.round(v / vs[:, :, :, None]))
        kw = {"k_scale": torch.stack([ks[..., 0::2], ks[..., 1::2]],
                                     dim=2).contiguous(), "v_scale": vs}
        for name, qq, tol in (("int4+f32q", q, K1_TOL_F32),
                              ("int4+bf16q", q.bfloat16(), K1_TOL_BF16)):
            for tv in (t, t - 1):
                got = da.decode_cross_attention(qq, kp, vp, t_valid=tv, **kw)
                got2 = da.decode_cross_attention(qq, kp, vp, t_valid=tv,
                                                 **kw)
                want = da.decode_cross_attention_reference(
                    qq, kp, vp, t_valid=tv, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                log(f"K1 B={b} {name:10s} t_valid={tv} max_abs_err="
                    f"{err:.3e} (tol {tol}); two launches bit-equal")
                require(err <= tol, f"K1 {name} B={b} t_valid={tv}: "
                        f"{err} > {tol}")
                require(torch.equal(got, got2), f"K1 {name} B={b} "
                        f"t_valid={tv}: two launches differ")
                worst = max(worst, err)
        qb = q.bfloat16()

        def kernel():
            return da.decode_cross_attention(qb, kp, vp, **kw)
        ms = time_ms(kernel)
        plain = time_ms(lambda: da.decode_cross_attention_reference(
            qb, kp, vp, **kw))
        dev_ms = device_ms(kernel)
        # int8 K/V of the same values, in the same call
        s8, v8s = k.abs().amax(dim=2) / 127.0, v.abs().amax(dim=3) / 127.0
        k8 = torch.round(k / s8[:, :, None, :]).to(torch.int8)
        v8 = torch.round(v / v8s[:, :, :, None]).to(torch.int8)
        int8_ms = device_ms(lambda: da.decode_cross_attention(
            qb, k8, v8, k_scale=s8, v_scale=v8s))
        # the packed K and V, both scales and q read once, out written once
        bnd = bound(nbytes(qb, kp, vp, kw["k_scale"], kw["v_scale"], qb),
                    4 * b * h * t * hd, BF16_FLOPS)
        log(f"K1 B={b} int4 (bf16 q) time: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms; device time {dev_ms:.4f} ms, int8 in the same "
            f"call {int8_ms:.4f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}, "
            f"{100 * bnd[0] / dev_ms:.1f}% of it by device time); split "
            f"plan {da.split_plan(b * h, t // 2, 1, hd)}")
        results.setdefault(b, {})["decode_cross_attention_int4"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "device_ms": dev_ms, "int8_device_ms": int8_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}
    return worst


def _k2_decidable(l, ts, tb):
    """Rows whose token the kernel must reproduce: the plain top-2 gap in
    the region the token comes from (and the probability rule's margin,
    in ts mode) exceeds K2_GAP."""
    import torch

    def gap(x):
        top = x.topk(2, dim=-1).values
        return top[:, 0] - top[:, 1]

    if not ts:
        return gap(l) > K2_GAP
    margin = torch.logsumexp(l[:, tb:], dim=-1) - l[:, :tb].amax(dim=-1)
    region_gap = torch.where(margin > 0, gap(l[:, tb:]), gap(l))
    return (margin.abs() > K2_GAP) & (region_gap > K2_GAP)


def check_k2(torch, dl, lp, decode, cfg, gen, results):
    dev = "cuda"
    v, d = cfg.vocab_size, cfg.d_model
    v_pad = dl.pad_vocab(v)
    table = torch.randn((v, d), generator=gen, device=dev) * 0.02
    table_t = torch.zeros((d, v_pad), device=dev, dtype=torch.bfloat16)
    table_t[:, :v] = table.t().bfloat16()
    add = lp.suppress_vector(v_pad, decode.default_suppress_ids(cfg),
                             vocab=v, device=dev)
    worst, below = 0, 0
    tb = cfg.timestamp_begin_id
    from audio_transformers_tpu_torch.ops import _build
    stats = _build.STATS["fused_greedy_step"]
    # B = 1: the transcription window; 4: the segment bucket; 16: a full
    # micro-batch; 128: the reference bench's decode batch
    for b in (1, 4, 16, 128):
        hidden = torch.randn((b, d), generator=gen, device=dev).bfloat16()
        seen = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.002
                ).to(torch.int8)
        ban = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.0005
               ).to(torch.int8)
        # histories in three timestamp states, so that both sides of the
        # probability rule occur: a closed pair (timestamps banned), a
        # lone timestamp (text banned), an earlier one (monotonic floor)
        hist = torch.randint(0, tb - 1000, (b, 20), generator=gen,
                             device=dev)
        ts_tok = torch.randint(tb, tb + 1000, (b, 2), generator=gen,
                               device=dev)
        state = torch.arange(b, device=dev) % 3
        hist[state == 0, 12:14] = ts_tok[state == 0]
        hist[state == 1, 13] = ts_tok[state == 1, 0]
        hist[state == 2, 11] = ts_tok[state == 2, 0]
        bounds = lp.timestamp_row_bounds(hist, 14, begin_index=3,
                                         timestamp_begin=tb,
                                         eos_token_id=cfg.eos_token_id)
        modes = {"penalty+ban": {"seen": seen, "ban": ban, "penalty": 1.15},
                 "ts": {"seen": seen, "ban": ban, "penalty": 1.15,
                        "ts_bounds": bounds, "timestamp_begin": tb}}
        for name, kw in modes.items():
            before = stats.launches
            got = dl.fused_greedy_step(hidden, table_t, add, **kw)
            got2 = dl.fused_greedy_step(hidden, table_t, add, **kw)
            require(stats.launches == before + 2,
                    f"K2 B={b}: one launch per call")
            want = dl.fused_greedy_step_reference(hidden, table_t, add, **kw)
            l = dl.processed_logits(hidden, table_t, add, **kw)
            ok = _k2_decidable(l, "ts_bounds" in kw, tb)
            torch.cuda.synchronize()
            n_below = int((~ok).sum())
            diff = (got.long() - want.long()).abs()[ok]
            err = int(diff.max()) if diff.numel() else 0
            mism = int((got != want).sum())
            log(f"K2 B={b} {name:11s} tokens equal on "
                f"{int(ok.sum()) - int((diff != 0).sum())}/{int(ok.sum())} "
                f"decidable rows; rows below the {K2_GAP} gap: {n_below}; "
                f"mismatches overall: {mism}; two launches bit-equal")
            require(err == 0, f"K2 {name} B={b}: tokens differ")
            require(torch.equal(got, got2), f"K2 {name} B={b}: two "
                    f"launches differ")
            worst, below = max(worst, err), below + n_below
        kw = modes["penalty+ban"]

        def kernel():
            return dl.fused_greedy_step(hidden, table_t, add, **kw)
        ms = time_ms(kernel)
        plain = time_ms(lambda: dl.fused_greedy_step_reference(
            hidden, table_t, add, **kw))
        dev_ms, per_call = device_profile(kernel)
        require(per_call == 1, f"K2 B={b}: {per_call} kernels per call")
        # reads the table, the bias row, hidden and the two masks once;
        # writes one int32 token per row
        bnd = bound(nbytes(hidden, table_t, add, seen, ban) + 4 * b,
                    2 * b * d * v_pad, BF16_FLOPS)
        plan = dl.greedy_plan(b, d, v_pad, dl.sm_count(0))
        log(f"K2 B={b} penalty+ban time: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms; device time {dev_ms:.4f} ms in {per_call:g} "
            f"kernel per call; bound {bnd[0]:.4f} ms ({bnd[1]}, "
            f"{100 * bnd[0] / dev_ms:.1f}% of it by device time); plan "
            f"{plan}")
        results.setdefault(b, {})["fused_greedy_step"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "device_ms": dev_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
    return worst, below


def _k3_golden_err(mel, cfg, got, wav):
    """(max |err|, max |err| / limit) of features `got` against the float64
    golden `mel.reference_log_mel` of each clip; the limit, bin by bin,
    the larger of 2e-5 + 1e-5 |ref| (the reference package's tolerance)
    and `mel_cuda.golden_error_bound` (how far any float32 front end may
    lie from the golden, argued from its arithmetic)."""
    import numpy as np
    from audio_transformers_tpu_torch.ops import mel_cuda
    ref = np.stack([mel.reference_log_mel(c, cfg) for c in wav.cpu().numpy()])
    limit = np.maximum(2e-5 + 1e-5 * np.abs(ref),
                       mel_cuda.golden_error_bound(wav, cfg).cpu().numpy())
    d = np.abs(got.cpu().numpy() - ref)
    return float(d.max()), float((d / limit).max())


def k3_bound(mel_cfg, mel, b, n):
    """(bound_ms, bound_by) of one K3 call on (b, n) samples: the waveform
    read once and the kernel's (b, frames, n_mels) float32 written once,
    against the float32 operations per frame (the window, a real FFT of
    n_fft padded to a power of two at 2.5 N log2 N, the power spectrum
    and the filterbank at its nonzeros, which is what its bins need)."""
    frames = n // mel_cfg.hop_length + 1
    nnz = int((mel.mel_filter_bank(mel_cfg) != 0).sum())
    n_pow2 = 1 << (mel_cfg.n_fft - 1).bit_length()
    flops = b * frames * (mel_cfg.n_fft + 2.5 * n_pow2 * math.log2(n_pow2)
                          + 3 * (mel_cfg.n_fft // 2 + 1) + 2 * nnz)
    return bound(4 * b * n + 4 * b * frames * mel_cfg.n_mels, flops,
                 F32_FLOPS)


def check_k3(torch, mel, mel_cfg, gen, results):
    from audio_transformers_tpu_torch.ops import _build
    stats = _build.STATS["log_mel"]
    worst = 0.0
    window = torch.hann_window(mel_cfg.n_fft, device="cuda")
    # B = 1: the transcription window; 4: the segment bucket; 16: a
    # training batch and the pipeline's largest bucket
    for b in (1, 4, 16):
        wav = 0.3 * torch.randn((b, 480000), generator=gen, device="cuda")
        before = stats.launches
        got = mel.log_mel(wav, mel_cfg)
        got2 = mel.log_mel(wav, mel_cfg)
        require(stats.launches == before + 2, f"K3 B={b}: one launch per call")
        want = mel.log_mel_torch(wav, mel_cfg)
        torch.cuda.synchronize()
        require(got.shape == (b, 3000, mel_cfg.n_mels),
                f"K3 shape {tuple(got.shape)}")
        require(torch.equal(got, got2), f"K3 B={b}: two launches differ")
        err = (got - want).abs().max().item()
        log(f"K3 B={b} max_abs_err={err:.3e} (tol {K3_TOL}); two launches "
            f"bit-equal")
        require(err <= K3_TOL, f"K3 B={b}: {err} > {K3_TOL}")
        worst = max(worst, err)
        if b == 4:
            golden, ratio = _k3_golden_err(mel, mel_cfg, got, wav)
            plain_golden, _ = _k3_golden_err(mel, mel_cfg, want, wav)
            log(f"K3 B=4 against reference_log_mel (float64): kernel "
                f"{golden:.3e} ({ratio:.3f} of the golden limit), plain "
                f"{plain_golden:.3e}")
            require(ratio <= 1.0, f"K3 B=4: {golden} off the golden")

        def call():
            return mel.log_mel(wav, mel_cfg)

        def stft():
            return torch.stft(wav, mel_cfg.n_fft, mel_cfg.hop_length,
                              window=window, center=True, pad_mode="reflect",
                              return_complex=True)
        ms = time_ms(call)
        plain = time_ms(lambda: mel.log_mel_torch(wav, mel_cfg))
        events = kernel_events(call)
        k3_us = [us for name, us in events if "mel_kernel" in name]
        require(len(k3_us) == 20, f"K3 B={b}: {len(k3_us) / 20:g} K3 "
                f"kernels per call")
        pads = sorted({name for name, _ in events if "pad" in name.lower()})
        require(not pads, f"K3 B={b}: padding kernels {pads}")
        dev_ms = sum(k3_us) / 20 / 1e3
        call_ms = sum(us for _, us in events) / 20 / 1e3
        call_kernels = len(events) / 20
        stft_ms, _ = device_profile(stft)
        bnd = k3_bound(mel_cfg, mel, b, wav.shape[1])
        log(f"K3 B={b} time: per call {ms:.4f} ms, plain {plain:.4f} ms; "
            f"device time of K3 {dev_ms:.4f} ms (one kernel a call), of the "
            f"whole call {call_ms:.4f} ms in {call_kernels:g} kernels; "
            f"torch.stft {stft_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, "
            f"{100 * bnd[0] / dev_ms:.1f}% of it by device time)")
        results.setdefault(b, {})["log_mel"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "device_ms": dev_ms, "kernels_per_call": len(k3_us) / 20,
            "call_device_ms": call_ms, "call_kernels": call_kernels,
            "stft_ms": stft_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}
    # UrbanSound's preset (n_fft 1024, hop 512, 64 htk bands, log(x+1e-9))
    # on a batch of 16 clips of 4 s at 22050 Hz
    us_cfg = type(mel_cfg).urbansound()
    wav = 0.3 * torch.randn((16, 88200), generator=gen, device="cuda")
    got = mel.log_mel(wav, us_cfg)
    want = mel.log_mel_torch(wav, us_cfg)
    torch.cuda.synchronize()
    require(got.shape == (16, 173, 64), f"K3 UrbanSound shape {got.shape}")
    err = (got - want).abs().max().item()
    golden, ratio = _k3_golden_err(mel, us_cfg, got, wav)
    log(f"K3 UrbanSound B=16: max_abs_err={err:.3e} (tol {K3_TOL}); against "
        f"reference_log_mel {golden:.3e} ({ratio:.3f} of the golden limit)")
    require(err <= K3_TOL and ratio <= 1.0, "K3 UrbanSound preset")
    return max(worst, err)


# ---------------------------------------------------------------------------
# phases 4-6: the pipeline
# ---------------------------------------------------------------------------


def check_result(out, n_segments, n_classes):
    require(isinstance(out["transcription"], str), "transcription is a str")
    require(len(out["segments"]) == n_segments,
            f"{len(out['segments'])} segments, want {n_segments}")
    for seg in out["segments"]:
        require(set(seg) >= {"start", "end", "text", "emotion",
                             "emotion_probs"}, f"segment keys {set(seg)}")
        probs = list(seg["emotion_probs"].values())
        require(len(probs) == n_classes, "one probability per class")
        require(all(math.isfinite(p) and 0.0 <= p <= 1.0 for p in probs),
                "finite probabilities")
        require(abs(sum(probs) - 1.0) < 1e-3,
                f"probabilities sum to {sum(probs)}")


def check_small_reference(torch, EmotionWhisperConfig, WhisperConfig, init,
                          Pipeline, synth_clip, ByteTokenizer):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    params = init(cfg, torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = Pipeline(params, cfg, tokenizer=ByteTokenizer(), device=dev,
                        compute_dtype=torch.float32)
        outs.append(pipe.analyze(synth_clip(3.0, 16000, seed=2), 16000,
                                 segment_duration=1.0))
    gpu, cpu = outs
    check_result(gpu, 3, 4)
    require(gpu["transcription"] == cpu["transcription"],
            "test-config transcription: card vs CPU")
    err = 0.0
    for g, c in zip(gpu["segments"], cpu["segments"]):
        require(g["text"] == c["text"], "test-config segment text")
        err = max(err, max(abs(g["emotion_probs"][k] - c["emotion_probs"][k])
                           for k in c["emotion_probs"]))
    log(f"small reference: texts equal, probs max_abs_err={err:.3e} "
        f"(tol 1e-4)")
    require(err <= 1e-4, f"test-config probabilities differ by {err}")


def _wav_bytes(audio, sr):
    import numpy as np
    buf = io.BytesIO()
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def check_server(pipe, synth_clip):
    from http.server import ThreadingHTTPServer

    from audio_transformers_tpu_torch.serve.http_server import (MicroBatcher,
                                                                make_handler)

    batcher = MicroBatcher(pipe.analyze_windows, max_wait_ms=50.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(pipe, 5.0, batcher=batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/analyze"
    results = [None] * 3

    def post(i):
        body = _wav_bytes(synth_clip(12.0, 16000, freq=220.0 * (i + 1),
                                     seed=i), 16000)
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            results[i] = (r.status, json.loads(r.read()))

    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for p in posts:
            p.start()
        for p in posts:
            p.join()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=10)
    for i, res in enumerate(results):
        require(res is not None, f"request {i} got no answer")
        status, out = res
        require(status == 200, f"request {i}: HTTP {status}")
        check_result(out, 3, 10)
    log(f"server: 3 concurrent /analyze requests answered 200 in "
        f"{wall:.3f} s; micro-batcher stats {batcher.stats}")


def check_replayed_k1(torch, _build, fn, what, reps=3):
    """Phase 5: K1's device records (dca_split) over `reps` calls of fn(),
    whose decodes replay a captured step, against the launches
    `_build.STATS` counts for the same calls. A replay adds the K1
    launches that its capture recorded: the two agree only where every
    replay launches them. Taken after the profiler's warm-up cycle, and
    again, up to PROFILE_TRIES times, where records are missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    stats = _build.STATS["decode_cross_attention"]
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = stats.launches
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            counted = stats.launches - before
            prof.step()
        records = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "dca_split" in e.name)
        log(f"{what}: K1 over {reps} calls: {records} device records, "
            f"{counted} launches counted")
        require(counted > 0 and records <= counted,
                f"{what}: more K1 records than launches counted")
        if records == counted:
            return counted
    require(False, f"{what}: K1's device records never matched its count")


# ---------------------------------------------------------------------------
# phases 7-11: the training path
# ---------------------------------------------------------------------------


def _k4_err(got, want, dtype, floor=0.0):
    """(max abs error, limit) of a K4 output against its plain version;
    `floor` bounds the magnitude the bf16 ulps are taken at from below."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        return err, K4_TOL_F32 * max(1.0, scale)
    scale = max(scale, floor)
    return err, K4_ULPS_BF16 * 2.0 ** (math.floor(math.log2(scale)) - 7)


def k4_cancel_floor(q, k, v, g):
    """The magnitude below which dq and dk are float32 noise of the
    cancellation ds = p (dP - delta): 2^7 times its per-entry bound."""
    m = [x.float().abs().max().item() for x in (q, k, v, g)]
    return 2.0 ** -17 * q.shape[-1] * m[3] * m[2] * max(m[0], m[1])


def k4_pairs(tq, tk, causal):
    """(query, key) pairs the attention computes."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def _time_sdpa(torch, q, k, v, g, causal):
    """SDPA's forward and backward (dq, dk, dv by torch.autograd.grad with
    retain_graph) on the K4 operands, as (B=16, H=6, T, d) views, scale 1
    (q is pre-scaled): (fwd ms, bwd ms, fwd backend, bwd backend)."""
    f = torch.nn.functional.scaled_dot_product_attention
    bh, tq, d = q.shape
    qs, ks, vs = (x.detach().view(16, bh // 16, x.shape[1], d)
                  .requires_grad_() for x in (q, k, v))
    gs = g.view(16, bh // 16, tq, d)
    with torch.no_grad():
        fwd = time_ms(lambda: f(qs, ks, vs, is_causal=causal, scale=1.0))
    out = f(qs, ks, vs, is_causal=causal, scale=1.0)

    def bwd():
        return torch.autograd.grad(out, (qs, ks, vs), gs, retain_graph=True)
    with torch.no_grad():
        fwd_backend = sdpa_backend(
            lambda: f(qs, ks, vs, is_causal=causal, scale=1.0))
    return fwd, time_ms(bwd), fwd_backend, sdpa_backend(bwd)


def check_k4(torch, att, gen, times):
    """K4a/b/c against their plain versions; returns the worst bf16 error
    of each."""
    worst = {n: 0.0 for n in ("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv")}
    bh, d = 16 * 6, 64
    for name, tq, tk, causal in K4_SHAPES:
        q32 = torch.randn((bh, tq, d), generator=gen, device="cuda") / 8.0
        k32 = torch.randn((bh, tk, d), generator=gen, device="cuda")
        v32 = torch.randn((bh, tk, d), generator=gen, device="cuda")
        g32 = torch.randn((bh, tq, d), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (x.to(dtype) for x in (q32, k32, v32, g32))
            out, lse = att.flash_attention_fwd(q, k, v, causal)
            out2, lse2 = att.flash_attention_fwd(q, k, v, causal)
            p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, causal)
            # both backward versions run from the plain forward's residuals
            delta = (g.float() * p_out.float()).sum(-1)
            bwd = (q, k, v, g, p_lse, delta, causal)
            dq = att.flash_attention_bwd_dq(*bwd)
            dk, dv = att.flash_attention_bwd_dkv(*bwd)
            dq2 = att.flash_attention_bwd_dq(*bwd)
            dk2, dv2 = att.flash_attention_bwd_dkv(*bwd)
            p_dq = att.flash_attention_bwd_dq_reference(*bwd)
            p_dk, p_dv = att.flash_attention_bwd_dkv_reference(*bwd)
            torch.cuda.synchronize()
            require(torch.equal(out, out2) and torch.equal(lse, lse2),
                    f"K4a {name} {dtype}: two launches differ")
            require(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                    and torch.equal(dv, dv2),
                    f"K4b/c {name} {dtype}: two launches differ")
            lse_err = (lse - p_lse).abs().max().item()
            require(lse_err <= 1e-4, f"K4a {name} lse: {lse_err}")
            floor = k4_cancel_floor(q, k, v, g)
            errs = {}
            for kern, part, got, want, fl in (
                    ("flash_attention_fwd", "out", out, p_out, 0.0),
                    ("flash_attention_bwd_dq", "dq", dq, p_dq, floor),
                    ("flash_attention_bwd_dkv", "dk", dk, p_dk, floor),
                    ("flash_attention_bwd_dkv", "dv", dv, p_dv, 0.0)):
                err, tol = _k4_err(got, want, dtype, fl)
                require(got.dtype == dtype and got.shape == want.shape,
                        f"{kern} {name}: dtype/shape")
                require(err <= tol, f"{kern} {name} {dtype}: {err} > {tol}")
                errs[part] = err
                if dtype == torch.bfloat16:
                    worst[kern] = max(worst[kern], err)
            log(f"K4 {name} {str(dtype)[6:]:8s} max_abs_err out "
                f"{errs['out']:.3e} lse {lse_err:.3e} dq {errs['dq']:.3e} "
                f"dk {errs['dk']:.3e} dv {errs['dv']:.3e}; two launches "
                f"bit-equal")
        # the training path's operands: bf16
        pairs = k4_pairs(tq, tk, causal)
        io_fwd = nbytes(q, k, v, q) + 4 * bh * tq
        io_bwd = nbytes(q, k, v, g, lse, delta)
        t = {"flash_attention_fwd": (
                time_ms(lambda: att.flash_attention_fwd(q, k, v, causal)),
                time_ms(lambda: att.flash_attention_fwd_reference(
                    q, k, v, causal)),
                bound(io_fwd, 4 * bh * pairs * d, BF16_FLOPS)),
             "flash_attention_bwd_dq": (
                time_ms(lambda: att.flash_attention_bwd_dq(*bwd)),
                time_ms(lambda: att.flash_attention_bwd_dq_reference(*bwd)),
                bound(io_bwd + nbytes(q), 6 * bh * pairs * d, BF16_FLOPS)),
             "flash_attention_bwd_dkv": (
                time_ms(lambda: att.flash_attention_bwd_dkv(*bwd)),
                time_ms(lambda: att.flash_attention_bwd_dkv_reference(
                    *bwd)),
                bound(io_bwd + nbytes(k, v), 8 * bh * pairs * d,
                      BF16_FLOPS))}
        lib_fwd, lib_bwd, fwd_op, bwd_op = _time_sdpa(torch, q, k, v, g,
                                                      causal)
        # the kernels' own time (profiler), beside the per-call event time
        dev = {"flash_attention_fwd": device_ms(
                   lambda: att.flash_attention_fwd(q, k, v, causal)),
               "flash_attention_bwd_dq": device_ms(
                   lambda: att.flash_attention_bwd_dq(*bwd)),
               "flash_attention_bwd_dkv": device_ms(
                   lambda: att.flash_attention_bwd_dkv(*bwd))}
        times[name] = {
            kern: {"ms": a, "plain_ms": b, "device_ms": dev[kern],
                   "bound_ms": bnd[0], "bound_by": bnd[1],
                   "library_ms": lib_fwd if kern.endswith("fwd") else lib_bwd,
                   "library": "scaled_dot_product_attention " + (
                       f"forward ({fwd_op})" if kern.endswith("fwd") else
                       f"backward, dq, dk and dv together ({bwd_op})")}
            for kern, (a, b, bnd) in t.items()}
        log(f"K4 {name} bf16 time (kernel / device / plain / bound ms): "
            + ", ".join(f"{n[16:]} {a:.4f} / {dev[n]:.4f} / {b:.4f} / "
                        f"{bnd[0]:.4f}" for n, (a, b, bnd) in t.items())
            + f"; SDPA forward {lib_fwd:.4f} ms ({fwd_op}), backward (dq, "
            f"dk, dv) {lib_bwd:.4f} ms ({bwd_op})")
    return worst


def check_k4_serving(torch, att, gen, times):
    """K4a at the serving encoder's shape (K4_SERVE, bf16, d = 64)
    against its plain version, two launches bit-equal; its per-call,
    device and bound times beside SDPA's forward on the same operands.
    Returns its error."""
    b, h, t = K4_SERVE
    bh, d = b * h, 64
    q = (torch.randn((bh, t, d), generator=gen, device="cuda") / 8.0
         ).to(torch.bfloat16)
    k, v = (torch.randn((bh, t, d), generator=gen, device="cuda"
                        ).to(torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        out, lse = att.flash_attention_fwd(q, k, v, False)
        out2, lse2 = att.flash_attention_fwd(q, k, v, False)
        p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, False)
        torch.cuda.synchronize()
        require(torch.equal(out, out2) and torch.equal(lse, lse2),
                "K4a serve: two launches differ")
        lse_err = (lse - p_lse).abs().max().item()
        require(lse_err <= 1e-4, f"K4a serve lse: {lse_err}")
        err, tol = _k4_err(out, p_out, torch.bfloat16)
        require(out.dtype == torch.bfloat16 and out.shape == p_out.shape,
                "K4a serve: dtype/shape")
        require(err <= tol, f"K4a serve bf16: {err} > {tol}")
        del out2, lse2, p_out, p_lse
        bnd = bound(nbytes(q, k, v, q) + 4 * bh * t, 4 * bh * t * t * d,
                    BF16_FLOPS)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qs, ks, vs = (x.view(b, h, t, d) for x in (q, k, v))

        def lib():
            return sdpa(qs, ks, vs, scale=1.0)
        res = {"ms": time_ms(lambda: att.flash_attention_fwd(q, k, v, False)),
               "plain_ms": time_ms(lambda: att.flash_attention_fwd_reference(
                   q, k, v, False), reps=5),
               "device_ms": device_ms(
                   lambda: att.flash_attention_fwd(q, k, v, False)),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "library_ms": time_ms(lib), "library_device_ms": device_ms(lib),
               "max_abs_err": err}
        backend = sdpa_backend(lib)
    times["serve"] = {"flash_attention_fwd": res}
    log(f"K4a serve (B*H {bh}, T {t}, d {d}, bf16) max_abs_err {err:.3e} "
        f"(limit {tol:.3e}), lse {lse_err:.3e}; two launches bit-equal; "
        f"per call {res['ms']:.4f} ms, device {res['device_ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}; {100 * bnd[0] / res['device_ms']:.1f}% by device "
        f"time); SDPA forward {res['library_ms']:.4f} ms, device "
        f"{res['library_device_ms']:.4f} ms ({backend})")
    return err


def train_batch(b, duration, w, n_classes, seed, max_len=32):
    """A host batch in the trainer's schema: sine-plus-noise clips, label
    rows [start, tokens..., eos, pad...] of max_len ids drawn from the
    config's vocab, one emotion class per clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = np.full((b, max_len), w.pad_token_id, np.int32)
    for i in range(b):
        n = int(rng.integers(3, max_len - 2))
        seq = [w.decoder_start_token_id,
               *rng.integers(10, w.vocab_size, n).tolist(), w.eos_token_id]
        labels[i, :len(seq)] = seq
    wav = np.stack([synth_clip(duration, 16000, freq=150.0 * (i % 7 + 1),
                               seed=seed + i) for i in range(b)])
    return {"waveform": wav, "labels": labels,
            "emotion_labels": (np.arange(b) % n_classes).astype(np.int32),
            "valid": np.ones(b, bool)}


def _fresh(torch, params, device):
    from audio_transformers_tpu_torch.core import params as cp
    return cp.set_trainable(cp.map_tensors(
        params, lambda t: t.detach().to(device, torch.float32).clone()))


def check_small_train_step(torch, port, init):
    """One train step at the test config in float32: card vs CPU."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    cfg = port.EmotionWhisperConfig(whisper=port.WhisperConfig.test(),
                                    num_emotion_classes=4)
    w, lr = cfg.whisper, 1e-4
    tcfg = port.TrainConfig(batch_size=4, compute_dtype="float32",
                            attn_impl="flash",
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=lr,
                                weight_decay=0.01))
    dur = 2 * w.max_source_positions * 160 / 16000
    batch = train_batch(4, dur, w, 4, seed=5, max_len=12)
    params0 = init(cfg, torch.Generator().manual_seed(3))
    runs = {}
    for dev in ("cuda", "cpu"):
        params = _fresh(torch, params0, dev)
        opt = build_optimizer(tcfg.optimizer, params)
        step, _ = tw.make_steps(cfg, port.MelConfig.whisper(), tcfg, opt, dev)
        metrics = step(params, tw.batch_to_device(batch, dev))
        runs[dev] = ({k: v.item() for k, v in metrics.items()},
                     dict(cp.leaves_with_path(params)))
    (gm, gp), (cm, cparams) = runs["cuda"], runs["cpu"]
    for k in ("loss", "transcription_loss", "emotion_loss"):
        require(abs(gm[k] - cm[k]) <= 1e-4 * abs(cm[k]),
                f"train step {k}: card {gm[k]} vs CPU {cm[k]}")
    g_err = p_err = 0.0
    for path, t in gp.items():
        c = cparams[path]
        p_err = max(p_err, (t.detach().cpu() - c.detach()).abs().max().item())
        if c.grad is not None:
            e = (t.grad.cpu() - c.grad).abs().max().item()
            require(e <= 1e-3 * max(1.0, c.grad.abs().max().item()),
                    f"train step grad {path}: {e}")
            g_err = max(g_err, e)
    require(p_err <= 2 * lr + 1e-6, f"train step params differ by {p_err}")
    log(f"small train step (test config, f32, flash): loss card "
        f"{gm['loss']:.6f} vs CPU {cm['loss']:.6f}; grads max_abs_err "
        f"{g_err:.3e}; updated params max_abs_err {p_err:.3e} "
        f"(bound {2 * lr + 1e-6:.1e})")


class SaveTimer:
    """Times every Checkpointer.save (synchronised before and after) while
    in a `with`, as (directory name, step, seconds, tree bytes)."""

    def __init__(self):
        from audio_transformers_tpu_torch.core import checkpoint
        self.cls, self.saves = checkpoint.Checkpointer, []
        self.save = self.cls.save

    def __enter__(self):
        import torch
        timer = self

        def save(ck, step, tree, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.save(ck, step, tree, **kw)
            seconds = time.perf_counter() - t0
            timer.saves.append((os.path.basename(ck.directory), step,
                                seconds, os.path.getsize(os.path.join(
                                    ck.directory, str(step), "tree.pt"))))

        self.cls.save = save
        return self

    def __exit__(self, *exc):
        self.cls.save = self.save
        return False


def check_train_cli(torch, _build, out_dir, smi):
    """The training path at whisper-tiny width through the CLI, writing
    its checkpoints/ and resume/ directories into `out_dir` (kept for
    phase 21)."""
    from audio_transformers_tpu_torch.cli import train_whisper
    args = ["--dataset", "synthetic", "--model_size", "tiny",
            "--compute_dtype", "bfloat16", "--batch_size", "8",
            "--num_samples", "100", "--num_epochs", "1",
            "--num_workers", "4", "--device", "cuda",
            "--output_dir", out_dir]
    torch.cuda.synchronize()
    _build.reset_stats()
    t0 = time.perf_counter()
    with SaveTimer() as saves:
        out = train_whisper.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {name: (s.launches, s.plain_cuda_calls)
             for name, s in _build.STATS.items()}
    require(os.path.exists(os.path.join(out_dir, "metrics.jsonl")),
            "metrics.jsonl written")
    log(f"train_whisper (whisper-tiny, bf16, 30 s clips, batch 8, "
        f"{out['optimizer'].count} steps + eval): {wall:.3f} s; "
        f"launches / plain-on-CUDA calls: {stats}")
    require(out["optimizer"].count == 10, "ten train steps")
    for name in TRAINING:
        require(stats[name][0] > 0,
                f"{name} was not launched on the training path")
    for name, (_, plain) in stats.items():
        require(plain == 0, f"{name}'s plain version ran on CUDA")
    for row in out["history"]:
        for key, val in row.items():
            if "loss" in key:
                require(math.isfinite(val), f"{key} = {val}")
    log(f"train_whisper history: {json.dumps(out['history'])}")
    require(sorted(d for d, *_ in saves.saves) == ["checkpoints", "resume"],
            f"one save each to checkpoints/ and resume/: {saves.saves}")
    for directory, step, seconds, size in saves.saves:
        log(f"model I/O ({smi}): Checkpointer.save of {directory}/{step} "
            f"(whisper-tiny{' + AdamW moments' if directory == 'resume' else ''}"
            f", {size / 1e6:.1f} MB): {seconds:.3f} s")
    return {name: stats[name][0] for name in TRAINING}


def _tiny_steps(torch, port, params0, attn, lr, batch_size):
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    cfg = port.EmotionWhisperConfig(num_emotion_classes=9)
    tcfg = port.TrainConfig(batch_size=batch_size, compute_dtype="bfloat16",
                            attn_impl=attn,
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=lr))
    params = _fresh(torch, params0, "cuda")
    opt = build_optimizer(tcfg.optimizer, params)
    step, _ = tw.make_steps(cfg, port.MelConfig.whisper(), tcfg, opt, "cuda")
    return lambda batch: step(params, batch)


def check_overfit(torch, port, params0):
    from audio_transformers_tpu_torch.train.common import \
        batch_to_device
    w = port.WhisperConfig()
    batch = batch_to_device(train_batch(4, 30.0, w, 9, seed=11), "cuda")
    step = _tiny_steps(torch, port, params0, "flash", 5e-4, 4)
    losses = [step(batch)["loss"].item() for _ in range(20)]
    require(all(math.isfinite(x) for x in losses), "finite overfit losses")
    log(f"overfit (whisper-tiny, bf16, flash, one batch of 4, 20 steps at "
        f"lr 5e-4): loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    require(losses[-1] < losses[0], "the overfit loss did not fall")
    return losses[0], losses[-1]


def time_train_step(torch, port, params0):
    """Steady-state train-step ms at batch 16: plain attention vs flash
    kernels, four turns each (plain, flash, flash, plain, flash, plain,
    plain, flash); returns the mean of each path's turns."""
    from audio_transformers_tpu_torch.train.common import \
        batch_to_device
    w = port.WhisperConfig()
    batch = batch_to_device(train_batch(16, 30.0, w, 9, seed=13), "cuda")
    runs = {}
    for attn in ("xla", "flash", "flash", "xla", "flash", "xla", "xla",
                 "flash"):
        step = _tiny_steps(torch, port, params0, attn, 3e-5, 16)
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
        runs.setdefault(attn, []).append(
            (time.perf_counter() - t0) / 5 * 1e3)
        del step
        torch.cuda.empty_cache()
    log(f"train step (whisper-tiny, bf16, batch 16, 30 s clips), ms per "
        f"step over 5 steps, four turns each: plain attention "
        f"{runs['xla']}, flash kernels {runs['flash']}")
    return {k: statistics.mean(v) for k, v in runs.items()}


# ---------------------------------------------------------------------------
# phases 12-16: beam search
# ---------------------------------------------------------------------------


def _k5_bufs(torch, rows, mode, gen):
    """The whisper-tiny beam step's per-beam buffers at L=66: 8 self K/V
    (4 layers x k, v), in int8 mode with 8 f32 scales, then the int8 seen
    mask at the padded vocab width and the int64 token rows."""
    dev, length = "cuda", 66
    kv = [torch.randn((rows, 6, 64, length), generator=gen, device=dev)
          for _ in range(8)]
    if mode == "bf16":
        bufs = [x.bfloat16() for x in kv]
    else:
        bufs = [x.mul(40).clamp(-127, 127).to(torch.int8) for x in kv]
        bufs += [torch.rand((rows, 6, length), generator=gen, device=dev)
                 for _ in range(8)]
    bufs.append((torch.rand((rows, 52224), generator=gen, device=dev) < 0.01
                 ).to(torch.int8))
    bufs.append(torch.randint(0, 51865, (rows, length), generator=gen,
                              device=dev))
    return bufs


def check_k5(torch, pm, gen):
    """K5 against its plain version, bit for bit, and both times, at the
    beam path's row counts; returns {(rows, mode): (ms per call, plain ms
    per call, device ms, plain device ms)}. A call's time (time_ms, as for
    K1-K4) includes the wrapper's host work where the card waits for it;
    the device times are the kernels' own (the plain version's 10 or 18
    index_select kernels summed)."""
    times = {}
    for rows in (N_BEAMS * 16, N_BEAMS * 128):
        for mode in ("bf16", "int8"):
            bufs = _k5_bufs(torch, rows, mode, gen)
            # beam-structured parents: each row's parent is a beam of its
            # own batch row, so parents repeat
            perm = ((torch.arange(rows, device="cuda") // N_BEAMS) * N_BEAMS
                    + torch.randint(0, N_BEAMS, (rows,), generator=gen,
                                    device="cuda"))
            got = pm.permute_rows(bufs, perm)
            want = pm.permute_rows_reference(bufs, perm)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                require(a.dtype == b.dtype and torch.equal(a, b),
                        f"K5 {mode} rows={rows}: not bit exact")
            out, out_plain = got, want

            def kernel():
                pm.permute_rows(bufs, perm, out=out)

            def plain():
                pm.permute_rows_reference(bufs, perm, out=out_plain)
            # the rows this run's parents need: each distinct one read once,
            # every output row written once
            read = nbytes(*bufs) * perm.unique().numel() // rows
            t = (time_ms(kernel), time_ms(plain), device_ms(kernel),
                 device_ms(plain),
                 bound(read + nbytes(*bufs) + nbytes(perm), 0, BF16_FLOPS))
            moved = 2 * sum(a.nbytes for a in bufs)
            log(f"K5 rows={rows} {mode}: {len(bufs)} buffers, bit exact; "
                f"per call kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; device "
                f"time kernel {t[2]:.4f} ms ({moved / t[2] / 1e6:.1f} GB/s "
                f"of {moved / 1e6:.1f} MB read + written), plain "
                f"{t[3]:.4f} ms; bound {t[4][0]:.4f} ms")
            times[(rows, mode)] = t
            del bufs, got, want, out, out_plain
    return times


def check_small_beam(torch, EmotionWhisperConfig, WhisperConfig, init,
                     Pipeline):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    params = init(cfg, torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = Pipeline(params, cfg, tokenizer=ByteTokenizer(), device=dev,
                        compute_dtype=torch.float32, num_beams=3)
        outs.append(pipe.analyze(synth_clip(3.0, 16000, seed=2), 16000,
                                 segment_duration=1.0))
    gpu, cpu = outs
    check_result(gpu, 3, 4)
    require(gpu["transcription"] == cpu["transcription"],
            "test-config beam transcription: card vs CPU")
    err = 0.0
    for g, c in zip(gpu["segments"], cpu["segments"]):
        require(g["text"] == c["text"], "test-config beam segment text")
        err = max(err, max(abs(g["emotion_probs"][k] - c["emotion_probs"][k])
                           for k in c["emotion_probs"]))
    log(f"small beam reference (num_beams=3): texts equal, probs "
        f"max_abs_err={err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"test-config beam probabilities differ by {err}")


def check_beam_serving(torch, _build, Pipeline, params, cfg, clip):
    """analyze through beam search at whisper-tiny width, kv_quant none,
    int8 and int4; returns ({mode: launch stats}, the "none" pipeline)."""
    runs, pipes = {}, {}
    for mode in ("none", "int8", "int4"):
        pipe = Pipeline(params, cfg, device="cuda",
                        compute_dtype=torch.bfloat16, kv_quant=mode,
                        num_beams=N_BEAMS)
        torch.cuda.synchronize()
        _build.reset_stats()
        t0 = time.perf_counter()
        out = pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {name: (s.launches, s.plain_cuda_calls)
                 for name, s in _build.STATS.items()}
        log(f"beam analyze (num_beams={N_BEAMS}, kv_quant={mode}, "
            f"whisper-tiny, bf16, 12 s clip, first call): {wall:.3f} s; "
            f"launches / plain-on-CUDA calls: {stats}")
        check_result(out, 3, cfg.num_emotion_classes)
        for name, (_, plain) in stats.items():
            require(plain == 0, f"{name}'s plain version ran on CUDA "
                                f"(beam, {mode})")
        for name in BEAM:
            require(stats[name][0] > 0,
                    f"{name} was not launched on the beam path ({mode})")
        log(f"beam analyze ({mode}): K1 decode_cross_attention launches "
            f"{stats['decode_cross_attention'][0]}, K2 fused_greedy_step "
            f"launches {stats['fused_greedy_step'][0]} (the beam path "
            f"calls neither)")
        t0 = time.perf_counter()
        pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        log(f"beam analyze ({mode}, same clip, second call): "
            f"{time.perf_counter() - t0:.3f} s")
        runs[mode], pipes[mode] = stats, pipe
    del pipes["int8"], pipes["int4"]
    return runs, pipes["none"]


def time_beam_steps(torch, beam, pm, cfg, params):
    """Beam decode ms per step at N=4, B in {16, 128}: the K5 reorder
    ("k5") against its plain version ("plain", one index_select per
    buffer, patched into the beam module for its turns), five turns each
    in the order plain, k5, k5, plain, ... (ABBA); each turn times a
    64-token and a 16-token decode of the same seeded encoder states, and
    the step time is their difference over 48. Returns the median turn of
    each."""
    from audio_transformers_tpu_torch.core import DecodeConfig
    from audio_transformers_tpu_torch.core.params import to_device
    w = cfg.whisper
    p = to_device(params["whisper"], "cuda")
    reorders = {"k5": beam.permute_rows, "plain": pm.permute_rows_reference}
    result = {}
    for b in (16, 128):
        enc = torch.randn((b, w.max_source_positions, w.d_model),
                          generator=torch.Generator().manual_seed(b)
                          ).to("cuda", torch.bfloat16)

        def decode(impl, new):
            dcfg = DecodeConfig(max_new_tokens=new, num_beams=N_BEAMS,
                                repetition_penalty=1.15,
                                no_repeat_ngram_size=3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beam.permute_rows = reorders[impl]
            try:
                out = beam.generate_beam(p, w, dcfg, enc)
            finally:
                beam.permute_rows = reorders["k5"]
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

        toks = {impl: decode(impl, 64)[1]["tokens"] for impl in reorders}
        require(torch.equal(toks["k5"], toks["plain"]),
                f"beam B={b}: K5 and plain reorders give other tokens")
        turns = {"k5": [], "plain": []}
        for impl in ("plain", "k5", "k5", "plain") * 2 + ("plain", "k5"):
            t64, _ = decode(impl, 64)
            t16, _ = decode(impl, 16)
            turns[impl].append((t64 - t16) / 48 * 1e3)
        log(f"beam decode B={b} N={N_BEAMS} (L=66, whisper-tiny, bf16): ms "
            f"per step, five turns each: K5 reorder {turns['k5']}, plain "
            f"index_select {turns['plain']}")
        result[b] = {k: statistics.median(v) for k, v in turns.items()}
        del enc
        torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phases 17-19: segment-level evaluation
# ---------------------------------------------------------------------------


class Spy:
    """Counts, in place of the module attribute `attr` of `mod`, the calls
    that `pick(args, kwargs)` selects, and keeps what `keep` takes of each
    result; `with` restores the attribute."""

    def __init__(self, mod, attr, pick=lambda a, k: True, keep=None):
        self.mod, self.attr = mod, attr
        self.fn = getattr(mod, attr)
        self.pick, self.keep = pick, keep
        self.calls, self.kept, self.seconds = 0, [], 0.0

    def __call__(self, *args, **kwargs):
        import torch
        picked = self.pick(args, kwargs)
        if picked and self.keep is not None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if picked:
            self.calls += 1
            if self.keep is not None:
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.kept.append(self.keep(args, kwargs, out))
        return out

    def __enter__(self):
        setattr(self.mod, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)
        return False


class CpuGumbel:
    """Stands in for decode.gumbel_noise (the replay hook): the noise is
    drawn on the CPU, from a generator seeded 0 for each new decode's
    generator, and moved to the decode's device, so that a decode on the
    card and one on the CPU sample with the same noise."""

    def __init__(self, decode):
        self.decode, self.draw = decode, decode.gumbel_noise
        self.of = self.cpu = None

    def __call__(self, shape, generator):
        import torch
        if generator is not self.of:
            self.of = generator
            self.cpu = torch.Generator().manual_seed(0)
        return self.draw(shape, self.cpu).to(generator.device)

    def __enter__(self):
        self.decode.gumbel_noise = self
        return self

    def __exit__(self, *exc):
        self.decode.gumbel_noise = self.draw
        return False


def _segment_dcfg(**kw):
    """The reference's segment-evaluation decode (evaluate_segment_level's
    default) with `kw` replaced."""
    from audio_transformers_tpu_torch.core import DecodeConfig
    base = dict(max_new_tokens=256, return_timestamps=True,
                no_repeat_ngram_size=3, repetition_penalty=1.1,
                compression_ratio_threshold=2.4)
    return DecodeConfig(**{**base, **kw})


def _read_files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def check_small_evaluate(torch):
    """Sequence- and segment-level evaluation at the test config (its
    timestamps moved to ids >= 600, so that rows mix text and
    timestamps) in float32, card against CPU, kv_quant none and int4, the
    fallback re-decoding every row with text: the same CPU-drawn Gumbel
    noise on both sides; tokens equal and the files identical."""
    import tempfile

    from audio_transformers_tpu_torch.core import (DecodeConfig,
                                                   EmotionWhisperConfig,
                                                   MelConfig, WhisperConfig)
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.infer import evaluate as ev
    from audio_transformers_tpu_torch.models.whisper import decode
    cfg = EmotionWhisperConfig(
        whisper=WhisperConfig.test().replace(timestamp_begin_id=600),
        num_emotion_classes=4)
    params = init(cfg, torch.Generator().manual_seed(1))
    mel_cfg = MelConfig.whisper(n_mels=cfg.whisper.n_mels)
    styles = {0: "angry", 1: "happy", 2: "sad", 3: "whisper"}
    # clips of the test config's window (64 encoder positions: 1.28 s)
    data = SyntheticSeq2Seq(num_samples=6, num_classes=4,
                            vocab_size=cfg.whisper.vocab_size, duration=1.28,
                            seed=3)
    for mode in ("none", "int4"):
        runs = {}
        for dev in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as tmp, CpuGumbel(decode), \
                    Spy(decode, "generate_with_fallback",
                        keep=lambda a, k, out: out["tokens"].cpu()) as dec:
                for level, dcfg in (
                        ("sequence", DecodeConfig(
                            max_new_tokens=40, no_repeat_ngram_size=3,
                            repetition_penalty=1.15, kv_quant=mode)),
                        ("segment", _segment_dcfg(
                            kv_quant=mode,
                            compression_ratio_threshold=1e-6))):
                    fn = getattr(ev, f"evaluate_{level}_level")
                    fn(params, cfg, mel_cfg, data.batcher(4), styles,
                       tokenizer=ByteTokenizer(), device=dev,
                       output_dir=os.path.join(tmp, level), dcfg=dcfg,
                       compute_dtype=torch.float32)
                files = {f"{level}/{name}": body for level in
                         ("sequence", "segment") for name, body in
                         _read_files(os.path.join(tmp, level)).items()}
                runs[dev] = (dec.kept, files)
        (gpu_toks, gpu_files), (cpu_toks, cpu_files) = runs["cuda"], \
            runs["cpu"]
        require(len(gpu_toks) == len(cpu_toks) == 4, "four decodes a side")
        for g, c in zip(gpu_toks, cpu_toks):
            require(torch.equal(g, c),
                    f"small evaluation ({mode}): tokens card vs CPU")
        require(sorted(gpu_files) == ["segment/predictions.txt",
                                      "segment/segment_evaluation.txt",
                                      "sequence/metrics.txt",
                                      "sequence/predictions.txt"],
                f"evaluation files {sorted(gpu_files)}")
        for name in gpu_files:
            require(gpu_files[name] == cpu_files[name],
                    f"small evaluation ({mode}): {name} card vs CPU")
        n_seg = gpu_files["segment/segment_evaluation.txt"].split(
            b"\n")[0].decode()
        log(f"small evaluation (test config, float32, kv_quant={mode}, "
            f"fallback on every row with text): tokens of 4 decodes equal, "
            f"{len(gpu_files)} files identical, card vs CPU; {n_seg}")


def check_eval_full(torch, _build, params, cfg, mode, threshold, tokenizer,
                    beams=1):
    """evaluate_segment_level at whisper-tiny width in bf16 on 8 synthetic
    30 s clips in batches of 4 (kv_quant `mode`, the fallback at
    `threshold`), every launch counter reset just before and read just
    after; K1 (int4 mode where asked), K2 (timestamp mode) and K3 must be
    launched, K5 with beams, and no plain version may run on CUDA. Returns
    a dict of what it measured."""
    import tempfile

    from audio_transformers_tpu_torch.core import MelConfig
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.infer import evaluate as ev
    from audio_transformers_tpu_torch.infer.pipeline import \
        DEFAULT_EMOTION_LABELS
    from audio_transformers_tpu_torch.models.whisper import decode
    from audio_transformers_tpu_torch.models.whisper import model as wm
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    data = SyntheticSeq2Seq(num_samples=8,
                            num_classes=cfg.num_emotion_classes,
                            vocab_size=cfg.whisper.vocab_size, duration=30.0,
                            seed=7)
    styles = dict(enumerate(DEFAULT_EMOTION_LABELS))
    dcfg = _segment_dcfg(kv_quant=mode, compression_ratio_threshold=threshold,
                         num_beams=beams)
    torch.cuda.synchronize()
    _build.reset_stats()
    with tempfile.TemporaryDirectory() as tmp, \
            Spy(wm, "decode_cross_attention",
                lambda a, k: k.get("k_scale") is not None
                and k["k_scale"].dim() == 4) as k1_int4, \
            Spy(wm, "decode_cross_attention") as k1_all, \
            Spy(wm, "decode_cross_attention",
                lambda a, k: not torch.cuda.is_current_stream_capturing()) \
            as k1_eager, \
            Spy(wm, "apply_decoder_step",
                lambda a, k: a[3].get("graph") is not None) as replays, \
            Spy(dl, "fused_greedy_step",
                lambda a, k: k.get("ts_bounds") is not None) as k2_ts, \
            Spy(decode, "generate",
                lambda a, k: a[2].temperature > 0,
                keep=lambda a, k, out: a[3].shape[0]) as redo:
        t0 = time.perf_counter()
        res = ev.evaluate_segment_level(
            params, cfg, MelConfig.whisper(), data.batcher(4),
            styles, tokenizer=tokenizer, output_dir=tmp, dcfg=dcfg,
            device="cuda", compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    stats = {name: (s.launches, s.plain_cuda_calls)
             for name, s in _build.STATS.items()}
    what = (f"segment evaluation (whisper-tiny, bf16, 8 clips of 30 s in "
            f"batches of 4, kv_quant={mode}, num_beams={beams}, fallback "
            f"threshold {threshold}, tokenizer "
            f"{'bytes' if tokenizer else 'none (id bytes)'})")
    log(f"{what}: {wall:.3f} s ({wall / 2:.3f} s a batch, first call); "
        f"{res['total_segments']} segments, accuracy {res['accuracy']:.4f}; "
        f"fallback re-decoded {sum(redo.kept)} rows in {redo.calls} calls "
        f"({redo.seconds:.3f} s); K1 calls in int4 mode {k1_int4.calls}, K2 "
        f"calls in timestamp mode {k2_ts.calls}; launches / plain-on-CUDA "
        f"calls: {stats}")
    require(files == ["predictions.txt", "segment_evaluation.txt"],
            f"{what}: files {files}")
    require(res["total_segments"] >= 8, f"{what}: a segment per clip")
    for name, (_, plain) in stats.items():
        require(plain == 0, f"{what}: {name}'s plain version ran on CUDA")
    needed = ("log_mel",) + (("permute_rows",) if beams > 1 else
                             ("decode_cross_attention", "fused_greedy_step"))
    for name in needed:
        require(stats[name][0] > 0, f"{what}: {name} was not launched")
    if beams == 1:
        require(k2_ts.calls > 0, f"{what}: K2 never ran its timestamp mode")
        if mode == "int4":
            require(k1_int4.calls > 0 and k1_int4.calls == k1_all.calls,
                    f"{what}: K1 ran {k1_int4.calls} of {k1_all.calls} "
                    f"calls in int4 mode")
        # a captured step calls K1 once a layer at its capture, and each
        # replay launches it once a layer
        want = k1_eager.calls + replays.calls * cfg.whisper.decoder_layers
        require(replays.calls > 0
                and stats["decode_cross_attention"][0] == want,
                f"{what}: K1 launched {stats['decode_cross_attention'][0]} "
                f"times, not {k1_eager.calls} eager calls + "
                f"{replays.calls} replays x {cfg.whisper.decoder_layers} "
                f"layers = {want}")
        if threshold < 1e-3:
            require(sum(redo.kept) == 8,
                    f"{what}: the fallback re-decoded {sum(redo.kept)} of 8 "
                    f"rows")
    return {"wall_s": wall, "segments": res["total_segments"],
            "redecoded_rows": sum(redo.kept), "redecode_s": redo.seconds,
            "launches": {k: v[0] for k, v in stats.items() if v[0]}}


# ---------------------------------------------------------------------------
# phases 20-21: model I/O
# ---------------------------------------------------------------------------


def _tokens(decode):
    """A Spy on greedy decoding that keeps each call's tokens."""
    return Spy(decode, "generate_with_fallback",
               keep=lambda a, k, out: out["tokens"].cpu())


def _launches():
    from audio_transformers_tpu_torch.ops import _build
    return {name: (s.launches, s.plain_cuda_calls)
            for name, s in _build.STATS.items()}


def _require_launched(stats, names, what):
    for name, (_, plain) in stats.items():
        require(plain == 0, f"{what}: {name}'s plain version ran on CUDA")
    for name in names:
        require(stats[name][0] > 0, f"{what}: {name} was not launched")


def check_hf_path(torch, _build, decode, params, cfg, clip, want, smi):
    """Phase 20: seeded whisper-tiny exported by the port as an HF
    directory (model.safetensors, and a copy with pytorch_model.bin), each
    loaded through `load_pipeline` on the card: greedy `analyze` of the
    12 s clip gives phase 5's tokens and probabilities, through K1, K2 and
    K3; then `cli.infer --num_beams 4` over the directory launches K5.
    `want` is (phase 5's tokens per decode call, its result). Returns the
    temporary root holding the directory and the times it measured."""
    import shutil
    import tempfile

    from audio_transformers_tpu_torch.cli import infer as cli_infer
    from audio_transformers_tpu_torch.cli.common import load_pipeline
    from audio_transformers_tpu_torch.utils.hub import (export_hf_dir,
                                                        to_torch_state_dict)
    want_tokens, want_out = want
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    hf, binned = os.path.join(root, "hf"), os.path.join(root, "bin")
    times = {}
    t0 = time.perf_counter()
    export_hf_dir(params, cfg, hf)
    times["export_hf_dir_s"] = time.perf_counter() - t0
    os.makedirs(binned)
    for name in ("config.json", "generation_config.json"):
        shutil.copy(os.path.join(hf, name), binned)
    torch.save(to_torch_state_dict(params, cfg),
               os.path.join(binned, "pytorch_model.bin"))
    size = os.path.getsize(os.path.join(hf, "model.safetensors"))
    log(f"model I/O ({smi}): export_hf_dir of whisper-tiny "
        f"(model.safetensors {size / 1e6:.1f} MB): "
        f"{times['export_hf_dir_s']:.3f} s")
    for weights, path in (("model.safetensors", hf),
                          ("pytorch_model.bin", binned)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = load_pipeline(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(pipe.compute_dtype == torch.bfloat16
                and pipe.cfg == cfg, f"{weights}: the loaded pipeline")
        _build.reset_stats()
        with _tokens(decode) as spy:
            t0 = time.perf_counter()
            out = pipe.analyze(clip, 16000)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        stats = _launches()
        what = f"analyze of the HF directory ({weights})"
        check_result(out, 3, cfg.num_emotion_classes)
        _require_launched(stats, SERVING, what)
        require(len(spy.kept) == len(want_tokens)
                and all(torch.equal(a, b)
                        for a, b in zip(spy.kept, want_tokens)),
                f"{what}: tokens differ from phase 5's pipeline")
        prob_err = max(abs(g["emotion_probs"][k] - w["emotion_probs"][k])
                       for g, w in zip(out["segments"], want_out["segments"])
                       for k in w["emotion_probs"])
        require(prob_err == 0.0, f"{what}: probabilities differ from phase "
                                 f"5's by {prob_err}")
        key = "safetensors" if weights == "model.safetensors" else "bin"
        times[f"from_hf_dir_{key}_s"] = load_s
        times[f"first_analyze_{key}_s"] = first_s
        log(f"model I/O ({smi}): load_pipeline of the HF directory "
            f"({weights}, whisper-tiny, to bf16 on the card): {load_s:.3f} "
            f"s; first analyze of the 12 s clip {first_s:.3f} s; tokens and "
            f"probabilities equal phase 5's; launches / plain-on-CUDA "
            f"calls: {stats}")
        del pipe
        torch.cuda.empty_cache()
    _build.reset_stats()
    t0 = time.perf_counter()
    res = cli_infer.main(["--model_path", hf, "--num_beams", str(N_BEAMS),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = _launches()
    what = f"cli.infer --num_beams {N_BEAMS} over the HF directory"
    check_result(res, 3, cfg.num_emotion_classes)
    _require_launched(stats, BEAM, what)
    log(f"{what}: {wall:.3f} s (load and one analyze); launches / "
        f"plain-on-CUDA calls: {stats}")
    times["cli_infer_beams_s"] = wall
    torch.cuda.empty_cache()
    return root, times


class Preempted(Exception):
    pass


class CutBatcher:
    """A batcher whose epoch `at` never starts: a preempted job."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at
        self.steps_per_epoch = inner.steps_per_epoch

    def train_epochs(self, *, epoch):
        if epoch == self.at:
            raise Preempted(epoch)
        return self.inner.train_epochs(epoch=epoch)


def check_resume_exact(torch, port):
    """The test config in float32 on the card: 2 epochs straight against
    1 epoch, a preemption and a resume to 2 (flash K4 in float32, K3).
    cuDNN runs its deterministic algorithms here, so that run-to-run noise
    of the convolutions' backward does not hide the resume's own. Returns
    the largest parameter difference, held to 2 * steps * lr (PERF.md)."""
    import tempfile

    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    cfg = port.EmotionWhisperConfig(whisper=port.WhisperConfig.test(),
                                    num_emotion_classes=4)
    w, lr = cfg.whisper, 1e-3
    tcfg = port.TrainConfig(batch_size=8, num_epochs=2,
                            compute_dtype="float32",
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=lr,
                                weight_decay=0.01,
                                schedule="linear_warmup_decay",
                                warmup_fraction=0.25))
    mel_cfg = port.MelConfig.whisper()

    def data(n, seed):
        return SyntheticSeq2Seq(
            num_samples=n, num_classes=4, vocab_size=w.vocab_size,
            max_label_len=8, duration=2 * w.max_source_positions * 160
            / 16000, seed=seed, bos_id=w.decoder_start_token_id,
            eos_id=w.eos_token_id, pad_id=w.pad_token_id).batcher(8)

    def train(out_dir, batcher=None):
        return tw.train_whisper_emotion(
            cfg, mel_cfg, tcfg, batcher or data(16, 1), data(12, 2),
            device="cuda", output_dir=out_dir)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            straight = train(os.path.join(tmp, "straight"))
            try:
                train(os.path.join(tmp, "cut"), CutBatcher(data(16, 1), 1))
                require(False, "the preempted run was not cut")
            except Preempted:
                pass
            resumed = train(os.path.join(tmp, "cut"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require([r["epoch"] for r in resumed["history"]] == [2],
            "the resumed run trains epoch 2 only")
    steps = straight["optimizer"].count
    require(resumed["optimizer"].count == steps, "the schedule's position")
    diff = max((a.detach() - b.detach()).abs().max().item()
               for (_, a), (_, b) in zip(
                   cp.leaves_with_path(straight["params"]),
                   cp.leaves_with_path(resumed["params"])))
    bound = 2 * steps * lr
    log(f"resume (test config, float32, on the card, {steps} steps): "
        f"2 epochs straight against 1 + a preemption + resume 1: params "
        f"{'bit-equal' if diff == 0.0 else 'not bit-equal'}, max |diff| "
        f"{diff:.3e} (bound 2 * steps * lr = {bound:.1e})")
    require(diff <= bound, f"resumed params differ by {diff}")
    return diff


def check_checkpoint_path(torch, _build, port, run_dir, hf_dir, smi):
    """Phase 21: phase 9's resume/ bundle restored (timed), cli.infer over
    its checkpoints/ on the card, train_whisper --pretrained from phase
    20's HF directory through K4a/b/c, and the resume's exactness."""
    import tempfile

    from audio_transformers_tpu_torch.cli import infer as cli_infer
    from audio_transformers_tpu_torch.cli import train_whisper
    from audio_transformers_tpu_torch.core.checkpoint import Checkpointer
    times = {}
    resume = Checkpointer(os.path.join(run_dir, "resume"))
    step = resume.latest_step()
    require(step is not None, "phase 9 wrote a resume step")
    size = os.path.getsize(os.path.join(resume.directory, str(step),
                                        "tree.pt"))
    t0 = time.perf_counter()
    tree, meta, _ = resume.restore()
    times["restore_resume_s"] = time.perf_counter() - t0
    require(meta["epoch"] == 1 and tree["opt_state"]["count"] == step,
            f"resume/ metadata {meta}")
    del tree
    log(f"model I/O ({smi}): Checkpointer.restore of resume/{step} "
        f"(whisper-tiny + AdamW moments, {size / 1e6:.1f} MB, to the "
        f"CPU): {times['restore_resume_s']:.3f} s")

    _build.reset_stats()
    t0 = time.perf_counter()
    res = cli_infer.main(["--model_path", os.path.join(run_dir,
                                                       "checkpoints"),
                          "--device", "cuda"])
    torch.cuda.synchronize()
    times["cli_infer_checkpoint_s"] = time.perf_counter() - t0
    stats = _launches()
    what = "cli.infer over phase 9's checkpoints/"
    check_result(res, 3, 9)
    _require_launched(stats, SERVING, what)
    log(f"{what}: {times['cli_infer_checkpoint_s']:.3f} s (load and one "
        f"analyze); launches / plain-on-CUDA calls: {stats}")

    with tempfile.TemporaryDirectory() as out_dir:
        _build.reset_stats()
        t0 = time.perf_counter()
        out = train_whisper.main([
            "--dataset", "synthetic", "--model_size", "tiny",
            "--compute_dtype", "bfloat16", "--batch_size", "8",
            "--num_samples", "40", "--num_epochs", "1", "--num_workers",
            "4", "--device", "cuda", "--pretrained", hf_dir,
            "--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = _launches()
    what = "train_whisper --pretrained (phase 20's HF directory)"
    _require_launched(stats, TRAINING, what)
    require(out["optimizer"].count > 0, f"{what}: no step")
    require(all(math.isfinite(v) for row in out["history"]
                for k, v in row.items() if "loss" in k),
            f"{what}: finite losses")
    log(f"{what}: {out['optimizer'].count} steps + eval in {wall:.3f} s; "
        f"launches / plain-on-CUDA calls: {stats}")
    times["resume_max_abs_diff"] = check_resume_exact(torch, port)
    return times


# ---------------------------------------------------------------------------
# phases 22-24: the UrbanSound classifier
# ---------------------------------------------------------------------------

# the test widths of the classifier (the JAX package's tests' SMALL)
US_SMALL = dict(n_mels=64, num_classes=10, conv_dim=32, encoder_dim=32,
                num_encoder_blocks=2, num_heads=4, dropout=0.0,
                cnn_dims=(32, 48))
US_RATE, US_CLIP = 22050, 88200


def classifier_keys(cfg):
    """The reference module's state-dict keys of a classifier config
    (BatchNorm with running statistics, q/k/v fused in in_proj)."""
    keys = {"position_embeddings"}

    def mod(name, *leaves):
        keys.update(f"{name}.{leaf}" for leaf in leaves)

    for name in ("conv_module.conv1", "conv_module.conv2", "classifier"):
        mod(name, "weight", "bias")
    for name in ("conv_module.bn1", "conv_module.bn2"):
        mod(name, "weight", "bias", "running_mean", "running_var")
    if cfg.conv_dim != cfg.encoder_dim:
        mod("projection", "weight", "bias")
    mod("ln_post", "weight", "bias")
    for i in range(cfg.num_encoder_blocks):
        pre = f"encoder_blocks.{i}"
        mod(f"{pre}.attn", "in_proj_weight", "in_proj_bias")
        for name in ("attn_ln", "attn.out_proj", "mlp_ln", "mlp.0", "mlp.3"):
            mod(f"{pre}.{name}", "weight", "bias")
    for i in range(len(cfg.cnn_dims)):
        mod(f"cnn_module.cnn_layers.{i}.0", "weight", "bias")
        mod(f"cnn_module.cnn_layers.{i}.1", "weight", "bias", "running_mean",
            "running_var")
    return keys


def check_k3_padded(torch, mel, gen, smi):
    """K3 at UrbanSound's preset on clips zero-padded to 4 s, against its
    plain version within K3_TOL + `mel_cuda.frame_error_bound` (each
    frame's rounding scales with its own energy: the kernel balances a
    quiet frame against its loud partner, and gives a silent one power
    0): 16 clips of 3 s, then the lengths that put the last frame with
    signal, or the first silent one, at either place of its pair. Returns (max |err|, max |err| / (K3_TOL +
    bound), max |err| of the 3 s clips)."""
    from audio_transformers_tpu_torch.ops import mel_cuda
    cfg = mel.MelConfig.urbansound()
    worst, ratio, err_3s = 0.0, 0.0, None
    for length in (3 * US_RATE, 512 * 128 + 1, 512 * 128 + 6,
                   512 * 129 + 3, 512 * 40):
        wav = torch.zeros((16, US_CLIP), device="cuda")
        wav[:, :length] = 0.3 * torch.randn((16, length), generator=gen,
                                            device="cuda")
        got = mel.log_mel(wav, cfg)
        want = mel.log_mel_torch(wav, cfg)
        power = mel.log_mel_torch(wav, cfg.replace(log_mode="none"))
        bnd = mel_cuda.frame_error_bound(wav, cfg, power)
        err = (got - want).abs().double()
        r = (err / (K3_TOL + bnd)).max().item()
        log(f"K3 UrbanSound padded ({smi}): 16 clips of {length} samples "
            f"zero-padded to {US_CLIP}: max_abs_err {err.max().item():.3e}, "
            f"{r:.3f} of K3_TOL + frame_error_bound")
        require(r <= 1.0, f"K3 padded clips of {length} samples")
        worst, ratio = max(worst, err.max().item()), max(ratio, r)
        if err_3s is None:
            err_3s = err.max().item()
    return worst, ratio, err_3s


def first_step_err(got, want, lr):
    """Holds one classifier step of `got` against `want`, each (gradients,
    params after the step, BN state after it) as {path: host tensor}:
    every leaf's gradient within 1e-4 * max(1, max |g|), except a leaf
    whose wanted gradient is rounding (under 1e-6 of the tree's largest:
    the conv biases before BatchNorm and the attention's key biases, whose
    exact gradient is 0), which must be rounding in `got` too; after the
    Adam step the params within 1e-6 where the wanted gradient exceeds
    its tolerance (the comparison fixes the sign there), elsewhere within
    2 lr; the BN state within 1e-6 + 1e-5 |x|. Returns (the largest
    gradient error over its tolerance, the largest such param move, the
    largest state error over its tolerance, the rounding leaves)."""
    (gg, gp, gs), (wg, wp, ws) = got, want
    floor = 1e-6 * max(w.abs().max().item() for w in wg.values())
    g_ratio = p_sure = s_ratio = 0.0
    rounding = []
    for path, w in wg.items():
        g, moved = gg[path], (gp[path] - wp[path]).abs()
        require(moved.max().item() <= 2 * lr, f"{path}: moved "
                f"{moved.max().item()} > 2 lr")
        if w.abs().max().item() <= floor:
            rounding.append(path)
            require(g.abs().max().item() <= floor, f"{path}: gradient "
                    f"{g.abs().max().item()} where the reference's is "
                    f"rounding (<= {floor})")
            continue
        tol = 1e-4 * max(1.0, w.abs().max().item())
        g_ratio = max(g_ratio, (g - w).abs().max().item() / tol)
        require(g_ratio <= 1.0, f"{path}: gradient error "
                f"{(g - w).abs().max().item()} > {tol}")
        sure = moved[w.abs() > tol]
        p_sure = max(p_sure, sure.max().item() if sure.numel() else 0.0)
        require(p_sure <= 1e-6, f"{path}: params after one step differ by "
                f"{p_sure}")
    for path, w in ws.items():
        s_ratio = max(s_ratio, ((gs[path] - w).abs()
                                / (1e-6 + 1e-5 * w.abs())).max().item())
        require(s_ratio <= 1.0, f"{path}: BN state after one step")
    return g_ratio, p_sure, s_ratio, rounding


def check_small_classifier(torch, _build, mel):
    """Phase 22: the classifier at the test widths in float32 (dropout 0),
    the card (K3) against the CPU (plain versions), on 4 s clips and on
    3 s clips zero-padded to 4 s. 3 train steps and one eval end to end:
    losses within 1e-4 relative, logits within 1e-3 of their scale. The
    first step's gradients, params and BN state (`first_step_err`)
    against a CPU step fed the card's features, so that the comparison
    holds the step's own arithmetic (cuDNN, cuBLAS, autograd on the card)
    and not K3's rounding, which phase 3 and `check_k3_padded` hold."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.core.config import (MelConfig,
                                                          OptimizerConfig,
                                                          TrainConfig,
                                                          UrbanSoundConfig)
    from audio_transformers_tpu_torch.data.synthetic import \
        SyntheticClassification
    from audio_transformers_tpu_torch.models.urbansound import model as us
    from audio_transformers_tpu_torch.train import classifier as tc
    from audio_transformers_tpu_torch.train.common import batch_to_device
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    # lr 1e-4: the conv biases before each BatchNorm get only rounding
    # as gradient, which Adam turns into steps of lr either way on each
    # side; train-mode BatchNorm cancels them, but the eval-mode running
    # means took them in, so the eval loss drifts apart by about lr
    cfg, mel_cfg, lr = UrbanSoundConfig(**US_SMALL), MelConfig.urbansound(), \
        1e-4
    tcfg = TrainConfig(batch_size=8, compute_dtype="float32",
                       optimizer=OptimizerConfig(
                           name="adam", learning_rate=lr,
                           schedule="reduce_on_plateau"))
    params0, state0 = us.init(cfg, torch.Generator().manual_seed(0))
    ds = SyntheticClassification(num_samples=8, num_classes=10, seed=3)

    def host(tree):
        return {p: t.detach().cpu().clone()
                for p, t in cp.leaves_with_path(tree)}

    def run(dev, batch, steps, features=None):
        """(losses, eval sums, first step (grads, params, state), params,
        state) of `steps` train steps on `dev`; with `features`, the
        steps take them in place of the log-mel of the batch."""
        params = _fresh(torch, params0, dev)
        state = cp.map_tensors(state0, lambda t: t.to(dev).clone())
        opt = build_optimizer(tcfg.optimizer, params)
        train_step, eval_step = tc.make_steps(cfg, mel_cfg, tcfg, opt)
        b = batch_to_device(batch, dev)
        log_mel = tc.log_mel
        if features is not None:
            tc.log_mel = lambda wav, c: features.to(wav.device)
        try:
            losses, first = [], None
            for _ in range(steps):
                state, m = train_step(params, state, b)
                losses.append(m["loss"].item())
                if first is None:
                    first = ({p: t.grad.cpu().clone()
                              for p, t in cp.leaves_with_path(params)},
                             host(params), host(state))
            ev = {k: v.item()
                  for k, v in eval_step(params, state, b).items()}
        finally:
            tc.log_mel = log_mel
        return losses, ev, first, params, state

    for seconds in (4.0, 3.0):
        batch = next(ds.batcher(8).train_epochs(epoch=0))
        batch["waveform"][:, int(seconds * US_RATE):] = 0.0
        _build.reset_stats()
        gl, ge, gfirst, gp, gs = run("cuda", batch, 3)
        with torch.no_grad():
            wav = batch_to_device(batch, "cuda")["waveform"]
            glog = us.apply(gp, gs, cfg, mel.log_mel(wav, mel_cfg))[0].cpu()
        stats = _launches()
        require(stats["log_mel"][0] == 5, f"K3 on each of 5 classifier "
                f"calls: {stats['log_mel']}")
        _require_launched(stats, ("log_mel",), "phase 22")
        cl, ce, _, cpp, cs = run("cpu", batch, 3)
        with torch.no_grad():
            clog = us.apply(cpp, cs, cfg, mel.log_mel(
                batch_to_device(batch, "cpu")["waveform"], mel_cfg))[0]
        for g, c in zip(gl + [ge["loss_sum"]], cl + [ce["loss_sum"]]):
            require(abs(g - c) <= 1e-4 * abs(c), f"classifier loss: card "
                    f"{g} vs CPU {c}")
        require(ge["count"] == ce["count"] == 8, "eval count")
        lerr = (glog - clog).abs().max().item()
        lscale = max(1.0, clog.abs().max().item())
        require(lerr <= 1e-3 * lscale, f"classifier logits differ by {lerr}")
        features = mel.log_mel(wav, mel_cfg).cpu()
        _, _, cfirst, _, _ = run("cpu", batch, 1, features)
        g_ratio, p_sure, s_ratio, rounding = first_step_err(gfirst, cfirst,
                                                            lr)
        log(f"small classifier ({seconds:g} s clips in 4 s, f32, lr {lr:g}, "
            f"3 steps + eval): losses card {gl} vs CPU {cl}; eval loss_sum "
            f"{ge['loss_sum']:.6f} vs {ce['loss_sum']:.6f}; logits "
            f"max_abs_err {lerr:.3e} (tol {1e-3 * lscale:.1e}); K3 launches "
            f"{stats['log_mel'][0]}; first step against the CPU on the "
            f"card's features: gradients {g_ratio:.3e} of their tolerance "
            f"(1e-4 max(1, max |g|)), params {p_sure:.3e} where the "
            f"gradient exceeds it (bound 1e-6), BN state {s_ratio:.3e} of "
            f"1e-6 + 1e-5 |x|; rounding-level leaves {rounding}")


def check_classifier_cli(torch, _build, smi):
    """Phase 23: train_classifier at full width through the CLI (bf16,
    batch 64, SpecAugment, 2 epochs of 320 synthetic clips), then a rerun
    to 3 epochs that resumes from checkpoints-resume; launch counters reset
    around each run. Returns the first run's K3 launches."""
    from audio_transformers_tpu_torch.cli import train_classifier
    from audio_transformers_tpu_torch.core.config import UrbanSoundConfig
    from audio_transformers_tpu_torch.utils.safetensors import load_file
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_classifier_")
    args = ["--dataset", "synthetic", "--batch_size", "64",
            "--limit_samples", "320", "--compute_dtype", "bfloat16",
            "--spec_augment", "--num_workers", "4", "--device", "cuda",
            "--output_dir", out_dir]
    eval_batches = 1          # 64 validation clips in one batch
    launches, count = [], 0
    try:
        for epochs in (2, 3):
            torch.cuda.synchronize()
            _build.reset_stats()
            t0 = time.perf_counter()
            with SaveTimer() as saves:
                out = train_classifier.main(args + ["--epochs", str(epochs)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = _launches()
            what = f"train_classifier --epochs {epochs}"
            steps = out["optimizer"].count - count
            count = out["optimizer"].count
            ran = [row["epoch"] for row in out["history"]]
            require(ran == ([1, 2] if epochs == 2 else [3]),
                    f"{what}: epochs {ran} (a rerun resumes at 3)")
            _require_launched(stats, ("log_mel",), what)
            want = steps + len(ran) * eval_batches
            require(stats["log_mel"][0] == want, f"{what}: K3 launched "
                    f"{stats['log_mel'][0]} times for {steps} train and "
                    f"{len(ran) * eval_batches} eval steps")
            require(all(math.isfinite(v) for row in out["history"]
                        for k, v in row.items() if "loss" in k),
                    f"{what}: finite losses")
            launches.append(stats["log_mel"][0])
            log(f"{what} (UrbanSound full width, bf16, batch 64; {smi}): "
                f"{steps} steps + {len(ran)} evals in {wall:.3f} s; "
                f"launches / plain-on-CUDA calls: {stats}")
            for row in out["history"]:
                log(f"  epoch {row['epoch']}: clips_per_sec "
                    f"{row['clips_per_sec']:.1f}, data_wait_s "
                    f"{row['data_wait_s']:.3f}, train/loss "
                    f"{row['train/loss']:.4f}, val/accuracy "
                    f"{row['val/accuracy']:.4f}")
            for directory, step, seconds, size in saves.saves:
                log(f"  Checkpointer.save of {directory}/{step} "
                    f"({size / 1e6:.1f} MB): {seconds:.3f} s")
            require({d for d, *_ in saves.saves} >= {"checkpoints-resume"},
                    f"{what}: a resume save per epoch")
        sd = load_file(os.path.join(out_dir, "best_model.safetensors"))
        want = classifier_keys(UrbanSoundConfig())
        require(set(sd) == want, f"best_model.safetensors keys: "
                f"{sorted(set(sd) ^ want)[:6]}")
        require(tuple(sd["position_embeddings"].shape) == (1000, 256)
                and tuple(sd["conv_module.conv1.weight"].shape)
                == (128, 64, 3), "best_model.safetensors shapes")
        require(all(torch.isfinite(t).all() for t in sd.values()),
                "finite exported weights")
        log(f"best_model.safetensors: {len(sd)} tensors, the reference's "
            f"keys, read back by the port's reader")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches[0]


def profiled_window(fn, reps, per_rep):
    """(kernel events [(name, us)], wall ms) of `reps` calls of fn() under
    torch.profiler, after a warm-up call and one more call inside the
    profiler's warm-up cycle, which it does not record (the records of the
    first kernels after the profiler starts have gone missing now and
    then). A trace whose kernels per call are not what `per_rep(events)`
    expects is taken again, up to PROFILE_TRIES times, and said so; then
    it fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    fullest = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                prof.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events and per_rep(events):
            return events, wall
        log(f"the profiler's trace {attempt + 1} of {PROFILE_TRIES} holds "
            f"{len(events)} kernels, not the calls' own")
    require(False, "no whole profiler trace")


def time_classifier_step(torch, _build, mel, smi):
    """Phase 24: the classifier's train step at full width, batch 64,
    bf16, SpecAugment and dropout 0.1 (the CLI's): the mean of 20 steps
    after warm-up by CUDA events; device busy, K3's device time and the
    kernels per step from torch.profiler over 10 steps, and the idle share
    1 - busy / the event-timed step; K3
    alone at (64, 88200) against its plain version and its bound."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.core.config import (MelConfig,
                                                          OptimizerConfig,
                                                          TrainConfig,
                                                          UrbanSoundConfig)
    from audio_transformers_tpu_torch.data.synthetic import \
        SyntheticClassification
    from audio_transformers_tpu_torch.models.urbansound import model as us
    from audio_transformers_tpu_torch.train import classifier as tc
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    from audio_transformers_tpu_torch.train.common import \
        batch_to_device
    cfg, mel_cfg = UrbanSoundConfig(), MelConfig.urbansound()
    tcfg = TrainConfig(batch_size=64, compute_dtype="bfloat16",
                       spec_augment=True,
                       optimizer=OptimizerConfig(
                           name="adam", learning_rate=1e-3,
                           schedule="reduce_on_plateau"))
    params, state = us.init(cfg, torch.Generator().manual_seed(0))
    params = cp.set_trainable(cp.to_device(params, "cuda"), frozen=())
    live = {"state": cp.to_device(state, "cuda")}
    opt = build_optimizer(tcfg.optimizer, params)
    train_step, _ = tc.make_steps(cfg, mel_cfg, tcfg, opt)
    ds = SyntheticClassification(num_samples=64, num_classes=10, seed=5)
    batch = batch_to_device(next(ds.batcher(64).train_epochs(epoch=0)),
                            "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        live["state"], _ = train_step(params, live["state"], batch, gen)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / 20
    _build.reset_stats()
    step()
    torch.cuda.synchronize()
    stats = _launches()
    require(stats["log_mel"][0] == 1, f"one K3 launch per classifier step: "
            f"{stats['log_mel']}")
    _require_launched(stats, ("log_mel",), "phase 24")
    def k3_kernels(events):
        return [us_ for name, us_ in events if "mel_kernel" in name]

    events, wall = profiled_window(step, 10,
                                   lambda ev: len(k3_kernels(ev)) == 10)
    busy = sum(us_ for _, us_ in events) / 1e3
    k3 = k3_kernels(events)
    by_name = {}
    for name, us_ in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log("classifier step, kernels by device time (ms per step, launches "
        "per step): " + "; ".join(f"{name[:60]} {t / 10 / 1e3:.4f} "
                                  f"({n / 10:g})" for name, (n, t) in top))
    out = {"classifier_step_ms_b64": step_ms,
           "classifier_step_busy_ms_b64": busy / 10,
           # against the event-timed step: the profiled window's wall
           # time also holds the profiler's own host work
           "classifier_step_idle_share_b64": 1.0 - busy / 10 / step_ms,
           "classifier_step_kernels_b64": len(events) / 10,
           "classifier_k3_device_ms_b64": sum(k3) / 10 / 1e3}
    wav = batch["waveform"]
    out["urbansound_b64_ms"] = time_ms(lambda: mel.log_mel(wav, mel_cfg))
    out["urbansound_b64_plain_ms"] = time_ms(
        lambda: mel.log_mel_torch(wav, mel_cfg))
    out["urbansound_b64_device_ms"] = device_ms(
        lambda: mel.log_mel(wav, mel_cfg))
    out["urbansound_b64_bound_ms"] = k3_bound(mel_cfg, mel, 64,
                                              wav.shape[1])[0]
    log(f"classifier train step (UrbanSound full width, bf16, batch 64, "
        f"SpecAugment, dropout 0.1; {smi}): {step_ms:.3f} ms per step "
        f"(CUDA events, mean of 20); device busy {busy / 10:.3f} ms per step "
        f"over 10 profiled steps ({wall / 10:.3f} ms each under the "
        f"profiler), idle share {out['classifier_step_idle_share_b64']:.3f} "
        f"of the event-timed step, "
        f"{len(events) / 10:g} kernels per step, K3 "
        f"{out['classifier_k3_device_ms_b64']:.4f} ms of it; K3 alone at "
        f"(64, 88200): per call {out['urbansound_b64_ms']:.4f} ms, plain "
        f"{out['urbansound_b64_plain_ms']:.4f}, device "
        f"{out['urbansound_b64_device_ms']:.4f}, bound "
        f"{out['urbansound_b64_bound_ms']:.4f}")
    return out


# ---------------------------------------------------------------------------
# phases 25-28: remat, data parallelism, the entry point
# ---------------------------------------------------------------------------

# phase 25's second batch, from scripts/probe_remat_memory.py's sweep on
# the H100 (PERF.md §6): remat takes the step's peak from about 17300 to
# about 7750 MiB
REMAT_BATCH = 128
K4 = TRAINING[1:]


def _whisper_step(torch, port, params0, batch_size, **kw):
    """(step, params): a fresh whisper-tiny train step (bf16, flash,
    AdamW at 3e-5) over a copy of params0; `kw` goes to TrainConfig and
    a `mesh` to make_steps."""
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    mesh = kw.pop("mesh", None)
    cfg = port.EmotionWhisperConfig(num_emotion_classes=9)
    tcfg = port.TrainConfig(batch_size=batch_size, compute_dtype="bfloat16",
                            attn_impl="flash",
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=3e-5), **kw)
    params = _fresh(torch, params0, "cuda")
    opt = build_optimizer(tcfg.optimizer, params)
    args = (mesh,) if mesh is not None else ()
    step, _ = tw.make_steps(cfg, port.MelConfig.whisper(), tcfg, opt, "cuda",
                            *args)
    return step, params, opt


def _timed_steps(torch, step, params, batch, reps=5):
    """(mean ms, peak MiB) of `reps` steps after one warm-up step."""
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(params, batch)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / reps * 1e3,
            torch.cuda.max_memory_allocated() / 2**20)


def check_remat(torch, port, _build, params0, smi):
    """Phase 25: the whisper-tiny train step (bf16, flash) with remat off
    and on. At batch 16 the first step's loss and gradients (bit-equal
    expected: the recompute repeats deterministic kernels, with cuDNN
    held to its deterministic algorithms for the phase) and K4's launches
    (K4a 12 off, 24 on; K4b, K4c 12); at batch 16 and REMAT_BATCH the
    peak memory and ms per step over 5 steps after a warm-up, off and on
    in turns. Returns (K4's launches in a step with remat, the K4a
    entry's remat fields)."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.train.common import batch_to_device
    w = port.WhisperConfig()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res, first = {}, {}
    try:
        for b in (16, REMAT_BATCH):
            batch = batch_to_device(train_batch(b, 30.0, w, 9, seed=13),
                                    "cuda")
            for remat in (False, True, True, False):
                step, params, _ = _whisper_step(torch, port, params0, b,
                                                remat=remat)
                torch.cuda.synchronize()
                _build.reset_stats()
                m = step(params, batch)
                torch.cuda.synchronize()
                launches = {k: _build.STATS[k].launches for k in K4}
                require(all(s.plain_cuda_calls == 0
                            for s in _build.STATS.values()),
                        "phase 25: a plain version ran on CUDA")
                want = {"flash_attention_fwd": 24 if remat else 12,
                        "flash_attention_bwd_dq": 12,
                        "flash_attention_bwd_dkv": 12}
                require(launches == want, f"phase 25 (batch {b}, remat "
                        f"{remat}): K4 launches {launches}, want {want}")
                if b == 16 and remat:
                    remat_launches = launches
                if b == 16 and remat not in first:
                    # on the host, out of the peaks measured below
                    first[remat] = (m["loss"].item(), {
                        p: t.grad.detach().cpu()
                        for p, t in cp.leaves_with_path(params)
                        if t.grad is not None})
                ms, peak = _timed_steps(torch, step, params, batch)
                res.setdefault((b, remat), []).append((ms, peak))
                del step, params, m
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss0, g0), (loss1, g1) = first[False], first[True]
    require(set(g0) == set(g1), "phase 25: the same leaves take gradients")
    bit_equal = loss0 == loss1 and all(torch.equal(g0[p], g1[p])
                                       for p in g0)
    worst = max(float((g0[p].float() - g1[p].float()).abs().max()
                      / max(1.0, float(g0[p].abs().max()))) for p in g0)
    if not bit_equal:
        # the bound of phase 8's float32 step: log-mel differences carried
        # through the step; here only the recompute's sum order can differ
        require(abs(loss1 - loss0) <= 1e-4 * abs(loss0),
                f"phase 25: remat loss {loss1} against {loss0}")
        require(worst <= 1e-3, f"phase 25: remat gradients differ by "
                f"{worst:.3e} of max(1, max |g|)")
    summary = {}
    for (b, remat), runs in res.items():
        tag = f"b{b}_{'on' if remat else 'off'}"
        summary[f"remat_ms_{tag}"] = statistics.mean(r[0] for r in runs)
        summary[f"remat_peak_mib_{tag}"] = max(r[1] for r in runs)
    log(f"remat ({smi}; whisper-tiny train step, bf16, flash, 30 s clips): "
        f"first step at batch 16 {'bit-equal' if bit_equal else 'NOT bit-equal'}"
        f" (loss {loss0!r} / {loss1!r}, largest gradient difference "
        f"{worst:.3e} of max(1, max |g|)); K4a 12 -> 24 launches a step, "
        f"K4b, K4c 12; ms per step and peak MiB over 5 steps, two turns "
        f"each: {json.dumps({f'{b}/{r}': v for (b, r), v in res.items()})}")
    summary["remat_bit_equal"] = bit_equal
    summary["remat_max_grad_diff"] = worst
    return remat_launches, summary


def _small_trainer_runs(torch, port, init):
    """The whisper trainer at the test config and the classifier trainer
    at the test widths, 2 epochs each on the card in bf16 with SpecAugment
    (dropout 0.1 for the classifier): their final parameters (and the
    classifier's BatchNorm state) on the host."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.core.config import UrbanSoundConfig
    from audio_transformers_tpu_torch.data.synthetic import (
        SyntheticClassification, SyntheticSeq2Seq)
    from audio_transformers_tpu_torch.train.classifier import \
        train_classifier
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        train_whisper_emotion
    cfg = port.EmotionWhisperConfig(whisper=port.WhisperConfig.test(),
                                    num_emotion_classes=4)
    w = cfg.whisper
    dur = 2 * w.max_source_positions * 160 / 16000

    def seq(seed):
        return SyntheticSeq2Seq(num_samples=8, num_classes=4,
                                vocab_size=w.vocab_size, max_label_len=12,
                                duration=dur, seed=seed,
                                bos_id=w.decoder_start_token_id,
                                eos_id=w.eos_token_id, pad_id=w.pad_token_id)

    wh = train_whisper_emotion(
        cfg, port.MelConfig.whisper(),
        port.TrainConfig(batch_size=4, num_epochs=2, spec_augment=True,
                         compute_dtype="bfloat16",
                         optimizer=port.OptimizerConfig(
                             name="adamw", learning_rate=1e-3,
                             schedule="linear_warmup_decay")),
        seq(1).batcher(4), seq(2).batcher(4), device="cuda",
        init_params=init(cfg, torch.Generator().manual_seed(0)))
    ucfg = UrbanSoundConfig(n_mels=64, num_classes=4, conv_dim=32,
                            encoder_dim=32, num_encoder_blocks=2,
                            num_heads=4, dropout=0.1, cnn_dims=(32, 48))
    cls = train_classifier(
        ucfg, port.MelConfig.urbansound(),
        port.TrainConfig(batch_size=8, num_epochs=2, spec_augment=True,
                         compute_dtype="bfloat16",
                         optimizer=port.OptimizerConfig(
                             name="adam", learning_rate=1e-3,
                             schedule="constant")),
        SyntheticClassification(16, 4, seed=3).batcher(8),
        SyntheticClassification(8, 4, seed=4).batcher(8), device="cuda")
    return {"whisper": dict(cp.leaves_with_path(wh["params"])),
            "classifier": dict(cp.leaves_with_path(cls["params"])),
            "classifier_state": dict(cp.leaves_with_path(cls["state"]))}


def _trees_equal(torch, a, b):
    """(bit-equal, largest difference) over every tree of two runs."""
    equal, worst = True, 0.0
    for name in a:
        for p, t in a[name].items():
            t, u = t.detach(), b[name][p].detach()
            equal &= torch.equal(t, u)
            worst = max(worst, float((t.float() - u.float()).abs().max()))
    return equal, worst


def check_dp_one_rank(torch, port, _build, init, params0, smi):
    """Phase 26: both trainers through the data-parallel path at world
    size 1: the process joins an NCCL group of one by passing a
    coordinator, so every collective runs (parameter broadcast, gradient
    all-reduce, BatchNorm's global statistics, the token count, the eval
    sums) and must change no bit: the final parameters and BatchNorm
    state equal the run without a group, K3 and K4 launched, no plain
    version on CUDA (cuDNN deterministic for the phase). Then the
    whisper-tiny train step at batch 16 with and without the group, in
    turns, and `average_gradients` alone (CUDA events, and its device time
    by torch.profiler). In a group of one that times the flatten, the
    divide and the copy back: NCCL over one rank launches no kernel.
    scripts/dp_multicard.py times the all-reduce itself over four cards."""
    import torch.distributed as dist
    from audio_transformers_tpu_torch.parallel import distributed
    from audio_transformers_tpu_torch.parallel.launch import free_port
    from audio_transformers_tpu_torch.parallel.mesh import (
        Mesh, average_gradients, build_mesh)
    from audio_transformers_tpu_torch.train.common import batch_to_device
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = _small_trainer_runs(torch, port, init)
        require(distributed.initialize_if_multihost(
            coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
            process_id=0, device="cuda"), "phase 26 joins a group of one")
        try:
            mesh = build_mesh()
            require(dist.get_backend() == "nccl" and mesh.size == 1
                    and mesh.group is not None,
                    f"phase 26: an NCCL group of one, got "
                    f"{dist.get_backend()} {mesh}")
            torch.cuda.synchronize()
            _build.reset_stats()
            dp = _small_trainer_runs(torch, port, init)
            torch.cuda.synchronize()
            stats = {k: (s.launches, s.plain_cuda_calls)
                     for k, s in _build.STATS.items()}
            _require_launched(stats, TRAINING, "phase 26 (DP, NCCL, 1 rank)")
            equal, worst = _trees_equal(torch, dp, ref)
            if not equal:
                again = _small_trainer_runs(torch, port, init)
                control = _trees_equal(torch, again, ref)
                require(False, f"phase 26: DP at world size 1 differs from "
                        f"the run without a group by {worst:.3e} (two runs "
                        f"without a group: bit-equal {control[0]}, "
                        f"{control[1]:.3e})")
            # the whisper-tiny step at batch 16, with and without the group
            w = port.WhisperConfig()
            batch = batch_to_device(train_batch(16, 30.0, w, 9, seed=13),
                                    "cuda")
            times = {}
            for with_group in (False, True, True, False, False, True):
                step, params, opt = _whisper_step(
                    torch, port, params0, 16,
                    mesh=mesh if with_group else Mesh(1, 0))
                times.setdefault(with_group, []).append(
                    _timed_steps(torch, step, params, batch)[0])
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            for _ in range(3):
                average_gradients(opt.params, mesh)
            start.record()
            for _ in range(20):
                average_gradients(opt.params, mesh)
            end.record()
            torch.cuda.synchronize()
            flatten_ms = start.elapsed_time(end) / 20
            flatten_dev = device_profile(
                lambda: average_gradients(opt.params, mesh))
            n_grad = sum(p.numel() for p in opt.params)
            del step, params, opt
            torch.cuda.empty_cache()
        finally:
            distributed.shutdown()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    off, on = (statistics.mean(times[k]) for k in (False, True))
    log(f"DP at world size 1 ({smi}; NCCL, a group of one): both trainers' "
        f"parameters and BN state bit-equal to the run without a group; "
        f"launches / plain-on-CUDA {stats}; whisper-tiny step at batch 16 "
        f"ms without / with the group {times[False]} / {times[True]} "
        f"(means {off:.3f} / {on:.3f}); average_gradients over one rank "
        f"(the flatten, divide and copy back of {n_grad} floats) "
        f"{flatten_ms:.4f} ms by CUDA events ({flatten_ms / on:.2%} of the "
        f"step), device {flatten_dev[0]:.4f} ms in {flatten_dev[1]:.0f} "
        f"kernels")
    return {"launches_dp_world1": stats["log_mel"][0],
            "dp_world1_step_ms": on, "dp_none_step_ms": off,
            "dp_grad_flatten_ms": flatten_ms,
            "dp_grad_flatten_device_ms": flatten_dev[0]}


def check_dp_two_ranks(torch, smi):
    """Phase 27: two processes on the one card in a gloo group (NCCL
    refuses two ranks on one device; gloo reduces the CUDA tensors)
    run the cases of tests/torch_dp_worker.py (the classifier at small
    widths with BatchNorm, dropout and SpecAugment, and without draws;
    whisper at the test config with label lengths that give the ranks
    unequal token counts, with and without SpecAugment; each trainer's
    evaluate and one epoch of each trainer), in float32, and are held to
    the same cases run in this process on the whole batch with the CPU
    tests' tolerances (`torch_dp_worker.hold`: loss 1e-5 relative,
    gradients 1e-4 max(1, max |g|) per leaf, BN state 1e-6, eval metrics
    1e-6 relative, an epoch's history 1e-3 relative; the ranks'
    gradients bit-equal). Every rank launches K3 in every case and K4 in
    the whisper cases; no plain version runs on CUDA."""
    from audio_transformers_tpu_torch.parallel.launch import launch
    tests_dir = os.path.join(HERE, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_dp_worker as worker
    one = tempfile.mkdtemp(prefix="chip_smoke_dp1_")
    two = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    try:
        worker.run(one, "cuda:0")
        t0 = time.perf_counter()
        launch("torch_dp_worker:run", 2, [two, "cuda:0", "gloo"],
               timeout=300, env={"PYTHONPATH": tests_dir})
        wall = time.perf_counter() - t0
        a = torch.load(os.path.join(one, "rank0.pt"), weights_only=False)
        ranks = [torch.load(os.path.join(two, f"rank{r}.pt"),
                            weights_only=False) for r in (0, 1)]
    finally:
        shutil.rmtree(one, ignore_errors=True)
        shutil.rmtree(two, ignore_errors=True)
    try:
        worst = worker.hold(a, ranks)
    except AssertionError as e:
        require(False, f"phase 27: {e}")
    for r, res in enumerate(ranks):
        for case in worst:
            names = ("log_mel",) + (K4 if case.startswith("wh") else ())
            _require_launched(res[case]["launches"], names,
                              f"phase 27 {case}, rank {r}")
    log(f"DP with two ranks on one card ({smi}; gloo on CUDA tensors, "
        f"{wall:.1f} s for both ranks): every case within the CPU tests' "
        f"tolerances of one rank on the whole batch: {json.dumps(worst)}; "
        f"token counts per rank {ranks[0]['wh_sa']['tokens']} / "
        f"{ranks[1]['wh_sa']['tokens']}")
    return {"launches_dp_two_ranks": [r["cls_drop"]["launches"]["log_mel"][0]
                                      for r in ranks],
            "dp_two_ranks_err": worst}


def check_entry(torch, _build):
    """Phase 28: `entry.entry()`'s fn on the card: whisper-tiny with the
    emotion head on 2 clips of 30 s (bf16), K3 launched once, no plain
    version on CUDA, finite outputs of the expected shapes."""
    from audio_transformers_tpu_torch.entry import entry
    fn, args = entry()
    torch.cuda.synchronize()
    _build.reset_stats()
    with torch.no_grad():
        logits, emotion = fn(*args)
    torch.cuda.synchronize()
    stats = {k: (s.launches, s.plain_cuda_calls)
             for k, s in _build.STATS.items()}
    require(stats["log_mel"][0] == 1, f"entry(): K3 launches {stats}")
    require(all(p == 0 for _, p in stats.values()),
            "entry(): a plain version ran on CUDA")
    require(tuple(logits.shape) == (2, 24, 51865)
            and tuple(emotion.shape) == (2, 10)
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(emotion).all()),
            "entry(): finite logits of the expected shapes")
    log(f"entry() on the card: logits {tuple(logits.shape)}, emotion "
        f"{tuple(emotion.shape)}, launches {stats}")


# ---------------------------------------------------------------------------
# phases 29-30: tensor parallelism
# ---------------------------------------------------------------------------

# phase 29: a shard's partials against its plain version's, by row: the
# max (float32 sums of exact bf16 products in another order, at logits of
# about 0.4) and, in ts mode, the timestamp sum of exp relative to it
# (the same order noise through exp, on sums of up to 1501 terms)
K2_PART_TOL, K2_SUM_RTOL = 1e-4, 1e-4


def check_k2_shards(torch, dl, lp, decode, cfg, gen, smi):
    """Phase 29: K2's vocab-shard mode at whisper-tiny width (bf16) on t =
    2 and 4 shards, B = 1, 4, 16, 128, both modes; returns its numbers
    by (t, B) and the largest partial error."""
    from audio_transformers_tpu_torch.ops import _build
    dev = "cuda"
    v, d = cfg.vocab_size, cfg.d_model
    v_pad = dl.pad_vocab(v)
    table = torch.randn((v, d), generator=gen, device=dev) * 0.02
    table_t = torch.zeros((d, v_pad), device=dev, dtype=torch.bfloat16)
    table_t[:, :v] = table.t().bfloat16()
    add = lp.suppress_vector(v_pad, decode.default_suppress_ids(cfg),
                             vocab=v, device=dev)
    tb = cfg.timestamp_begin_id
    stats = _build.STATS["fused_greedy_step_partials"]
    out, worst, below = {}, 0.0, 0
    for b in (1, 4, 16, 128):
        hidden = torch.randn((b, d), generator=gen, device=dev).bfloat16()
        seen = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.002
                ).to(torch.int8)
        ban = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.0005
               ).to(torch.int8)
        hist = torch.randint(0, tb - 1000, (b, 20), generator=gen,
                             device=dev)
        ts_tok = torch.randint(tb, tb + 1000, (b, 2), generator=gen,
                               device=dev)
        state = torch.arange(b, device=dev) % 3
        hist[state == 0, 12:14] = ts_tok[state == 0]
        hist[state == 1, 13] = ts_tok[state == 1, 0]
        hist[state == 2, 11] = ts_tok[state == 2, 0]
        bounds = lp.timestamp_row_bounds(hist, 14, begin_index=3,
                                         timestamp_begin=tb,
                                         eos_token_id=cfg.eos_token_id)
        modes = {"penalty+ban": {"penalty": 1.15},
                 "ts": {"penalty": 1.15, "ts_bounds": bounds,
                        "timestamp_begin": tb}}
        for t in (2, 4):
            w = v_pad // t
            shards = [{"table_t": table_t[:, r * w:(r + 1) * w].contiguous(),
                       "add": add[r * w:(r + 1) * w].contiguous(),
                       "seen": seen[:, r * w:(r + 1) * w].contiguous(),
                       "ban": ban[:, r * w:(r + 1) * w].contiguous(),
                       "vocab_offset": r * w} for r in range(t)]
            for name, kw in modes.items():
                def call(sh, fn=dl.fused_greedy_step, **extra):
                    return fn(hidden, sh["table_t"], sh["add"],
                              seen=sh["seen"], ban=sh["ban"],
                              vocab_offset=sh["vocab_offset"], **kw, **extra)
                before = stats.launches
                parts = torch.stack([call(sh, partials=True)
                                     for sh in shards])
                require(stats.launches == before + t,
                        f"K2 shards t={t} B={b}: one launch a shard")
                again = torch.stack([call(sh, partials=True)
                                     for sh in shards])
                plain = torch.stack([call(
                    sh, fn=dl.fused_greedy_step_partials_reference)
                    for sh in shards])
                got = dl.merge_partials(parts)
                whole = dl.fused_greedy_step(hidden, table_t, add, seen=seen,
                                             ban=ban, **kw)
                l = dl.processed_logits(hidden, table_t, add, seen=seen,
                                        ban=ban, **kw)
                ok = _k2_decidable(l, "ts_bounds" in kw, tb)
                torch.cuda.synchronize()
                err = float((parts[..., 0] - plain[..., 0]).abs().max())
                require(err <= K2_PART_TOL, f"K2 shards t={t} B={b} {name}: "
                        f"partial max off by {err}")
                if "ts_bounds" in kw:
                    ts_on = plain[..., 2] > lp.NEG_INF
                    rel = ((parts[..., 4] - plain[..., 4]).abs()
                           / plain[..., 4].abs().clamp(min=1e-30))[ts_on]
                    require(not rel.numel() or float(rel.max())
                            <= K2_SUM_RTOL,
                            f"K2 shards t={t} B={b}: timestamp sums")
                require(torch.equal(parts, again), f"K2 shards t={t} B={b} "
                        f"{name}: two launches differ")
                require(torch.equal(got[ok], whole[ok]),
                        f"K2 shards t={t} B={b} {name}: merged tokens "
                        f"differ from the unsharded K2's")
                worst, below = max(worst, err), below + int((~ok).sum())
            sh = shards[0]
            kw = modes["penalty+ban"]

            def kernel():
                return dl.fused_greedy_step(
                    hidden, sh["table_t"], sh["add"], seen=sh["seen"],
                    ban=sh["ban"], vocab_offset=0, partials=True, **kw)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: dl.fused_greedy_step_partials_reference(
                hidden, sh["table_t"], sh["add"], seen=sh["seen"],
                ban=sh["ban"], **kw))
            dev_ms, per_call = device_profile(kernel)
            require(per_call == 1, f"K2 shard t={t} B={b}: {per_call} "
                    "kernels per call")
            # the shard's table, bias and mask columns and hidden, read
            # once; two float32 partials a row written
            bnd = bound(nbytes(hidden, sh["table_t"], sh["add"], sh["seen"],
                               sh["ban"]) + 8 * b,
                        2 * b * d * w, BF16_FLOPS)
            log(f"K2 shard t={t} B={b} ({smi}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, device {dev_ms:.4f} ms in one kernel, "
                f"bound {bnd[0]:.4f} ms ({bnd[1]}, "
                f"{100 * bnd[0] / dev_ms:.1f}% of it)")
            out[(t, b)] = {"ms": ms, "plain_ms": plain_ms,
                           "device_ms": dev_ms, "bound_ms": bnd[0],
                           "bound_by": bnd[1], "library_ms": None}
    log(f"K2 shard mode: partial maxima within {worst:.2e} of the plain "
        f"version's; merged tokens equal to the unsharded K2's on every "
        f"decidable row ({below} rows below the {K2_GAP} gap not compared)")
    return out, worst


def check_tp(torch, smi):
    """Phase 30: tensor parallelism at whisper-tiny width in two gloo
    processes on the one card (NCCL refuses two ranks on one device):
    scripts/tp_multicard.py's decode and beam checks (float32 and bf16),
    the classifier step (float32 and bf16) and the train step on a
    model:2 mesh. Returns its numbers."""
    scripts = os.path.join(HERE, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import tp_multicard as tpm
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        t0 = time.perf_counter()
        # one launch: the decodes and beams (not timed: gloo stages every
        # collective through the host here), the classifier step and the
        # train step
        got = tpm.run_mesh(out, "model2", "tiny", ["float32", "bfloat16"],
                           "cuda:0", backend="gloo", timed=False,
                           train=True, beams=True, classifier=True)
        wall = time.perf_counter() - t0
    except AssertionError as e:
        require(False, f"phase 30: {e}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for r in got["decode"]:
        log(f"TP decode ({smi}; model:2, two gloo ranks on one card, "
            f"{r['dtype']}): {json.dumps(r)}")
    for r in got["beam"]:
        log(f"TP beams ({smi}; model:2, 4 beams, {r['dtype']}): "
            f"{json.dumps(r)}")
    for r in got["classifier"]:
        log(f"TP classifier step ({smi}; model:2, UrbanSoundConfig(), "
            f"batch 64, {r['dtype']}): {json.dumps(r)}")
    log(f"TP train step (model:2, float32, flash): "
        f"{json.dumps(got['train'])}; phase 30 took {wall:.1f} s")
    return got


# ---------------------------------------------------------------------------
# phases 31-32: the decode routes, the rehearsal
# ---------------------------------------------------------------------------

# (step_attn, logits_impl)
ROUTE_PAIRS = (("fused", "fused"), ("fused", "xla"), ("xla", "fused"),
               ("xla", "xla"))


class XlaMargins:
    """Stands in for decode._process_logits in greedy decodes with
    logits_impl "xla": keeps each generated position's margin, the top-two
    gap of the processed logits the argmax reads (one (B,) tensor a
    position, as tp_multicard.MarginSpy keeps K2's), a list a decode."""

    def __init__(self, decode):
        self.decode, self.fn = decode, decode._process_logits
        self.margins = []

    def __call__(self, logits, tokens, pos, cfg, dcfg, prompt_len, *args,
                 **kwargs):
        out = self.fn(logits, tokens, pos, cfg, dcfg, prompt_len, *args,
                      **kwargs)
        if pos == prompt_len:       # a new decode's first token
            self.margins.append([])
        top = out.topk(2, dim=-1).values
        self.margins[-1].append((top[:, 0] - top[:, 1]).float().cpu())
        return out

    def __enter__(self):
        self.decode._process_logits = self
        return self

    def __exit__(self, *exc):
        self.decode._process_logits = self.fn
        return False


def _route_run(torch, _build, decode, pipe, clip):
    """One `analyze` of `clip` through `pipe`, which decodes twice (the
    transcription's window, then the segments' batch): ([{"tokens",
    "lengths", "hiddens"} of each decode, on the host], the decodes'
    seconds with the card synchronised around each, the launches)."""
    def keep(args, kwargs, out):
        return {k: out[k].float().cpu() if k == "hiddens" else out[k].cpu()
                for k in ("tokens", "lengths", "hiddens")}
    torch.cuda.synchronize()
    _build.reset_stats()
    with Spy(decode, "generate", keep=keep) as spy:
        pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    require(spy.calls == 2, f"analyze decoded {spy.calls} times")
    return spy.kept, spy.seconds, _launches()


def check_routes(torch, _build, decode, Pipeline, params, cfg, clip, smi):
    """Phase 31: `analyze` of the 12 s clip at whisper-tiny width (its two
    decodes: the transcription, B = 1 and 128 new tokens, and the three
    segments, B = 4 and 64; penalty 1.15, a 3-gram ban) through each
    (step_attn, logits_impl) of ROUTE_PAIRS, in float32 and bf16,
    kv_quant none, int8 and int4, each pipeline warmed up by one call,
    the four routes run in turns (in order, then reversed): K1's launches
    4 a fed position under step_attn "fused" and none under "xla" (whose
    int4 arithmetic is K1's plain version, counted as such), K2's one a
    generated position under logits_impl "fused" and none under "xla", K3
    once a decode, no other plain version on CUDA; in float32 with
    kv_quant none the four routes token-equal; in float32 the ("xla",
    "xla") decodes on the card held to the same route on the CPU, row by
    row (`tp_multicard.hold_decode`'s near-tie rule, the CPU run's
    margins from `XlaMargins`). Each combination's decode ms per step in
    each turn (its decodes' seconds over their fed positions, by the host
    clock with the card synchronised around each decode). Returns {"launches": {kernel:
    {combination: launches}}, "ms": {...}, "holds": {...}}."""
    from audio_transformers_tpu_torch.core.config import DecodeConfig
    scripts = os.path.join(HERE, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import tp_multicard as tpm
    w = cfg.whisper
    p_len = len(decode.build_prompt(w, DecodeConfig()))
    runs, ms = {}, {}
    launches = {"decode_cross_attention": {}, "fused_greedy_step": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for quant in ("none", "int8", "int4"):
            pipe = Pipeline(params, cfg, device="cuda", compute_dtype=dtype,
                            kv_quant=quant)
            pipe.analyze(clip, 16000)
            for sa, li in ROUTE_PAIRS + ROUTE_PAIRS[::-1]:
                pipe.step_attn, pipe.logits_impl = sa, li
                key = f"{str(dtype)[6:]}/{quant}/{sa}/{li}"
                outs, secs, stats = _route_run(torch, _build, decode, pipe,
                                               clip)
                steps = sum(int(o["lengths"].max()) for o in outs)
                ms.setdefault(key, []).append(1e3 * secs / steps)
                k1, k1_plain = stats["decode_cross_attention"]
                k2 = stats["fused_greedy_step"][0]
                launches["decode_cross_attention"][key] = k1
                launches["fused_greedy_step"][key] = k2
                require(k1 == (w.decoder_layers * steps if sa == "fused"
                               else 0), f"phase 31 {key}: K1 launches {k1} "
                        f"for {steps} fed positions")
                require(k2 == (steps - len(outs) * p_len if li == "fused"
                               else 0),
                        f"phase 31 {key}: K2 launches {k2} for {steps} "
                        f"fed positions")
                require(k1_plain == (w.decoder_layers * steps
                                     if (sa, quant) == ("xla", "int4")
                                     else 0),
                        f"phase 31 {key}: K1's plain version ran "
                        f"{k1_plain} times")
                require(stats["log_mel"] == (2, 0)
                        and all(plain == 0 for name, (_, plain)
                                in stats.items()
                                if name != "decode_cross_attention"),
                        f"phase 31 {key}: launches {stats}")
                runs[key] = outs
            del pipe
            torch.cuda.empty_cache()

    def same(a, b):
        return all(torch.equal(x["tokens"], y["tokens"])
                   for x, y in zip(runs[a], runs[b]))
    for sa, li in ROUTE_PAIRS:
        require(same(f"float32/none/{sa}/{li}", "float32/none/fused/fused"),
                f"phase 31: float32 kv_quant none, {sa}/{li} tokens differ "
                f"from fused/fused")
    emb_norm = float(params["whisper"]["decoder"]["embed"]["table"].float()
                     .norm(dim=1).max())
    holds = {}
    for quant in ("none", "int8", "int4"):
        cpu = Pipeline(params, cfg, device="cpu",
                       compute_dtype=torch.float32, kv_quant=quant,
                       step_attn="xla", logits_impl="xla")
        with XlaMargins(decode) as margins:
            refs, _, _ = _route_run(torch, _build, decode, cpu, clip)
        for i, (ref, card, m) in enumerate(zip(
                refs, runs[f"float32/{quant}/xla/xla"], margins.margins)):
            rows = [{"mesh": (len(ref["tokens"]), b, 1, 0),
                     "tokens": card["tokens"][b:b + 1],
                     "hiddens": card["hiddens"][b:b + 1]}
                    for b in range(len(ref["tokens"]))]
            try:
                holds[f"{quant}/{i}"] = tpm.hold_decode(
                    {"tokens": ref["tokens"], "hiddens": ref["hiddens"],
                     "margins": m, "prompt_len": p_len,
                     "emb_norm": emb_norm}, rows, "float32",
                    near_ties=True)
            except AssertionError as e:
                require(False, f"phase 31 float32 {quant} xla/xla decode "
                        f"{i}, card against CPU: {e}")
    equal = {key: same(key, "/".join(key.split("/")[:2]) + "/fused/fused")
             for key in runs}
    log(f"decode routes ({smi}; whisper-tiny, analyze of a 12 s clip, "
        f"dtype/kv_quant/step_attn/logits_impl): ms per step "
        f"{json.dumps(ms)}; tokens equal to fused/fused {json.dumps(equal)};"
        f" float32 xla/xla card against CPU by decode/row "
        f"{json.dumps(holds)}")
    return {"launches": launches, "ms": ms, "holds": holds}


def check_rehearsal(torch, _build, smi):
    """Phase 32: scripts/parity_rehearsal_torch.py's `main` at full width
    (whisper-tiny, bf16) on 40 SyntheticExpresso clips (24/9/7), 2 epochs
    of batch 5, then the sequence-level evaluation: the training and
    evaluation kernels launched, no plain version on CUDA, the train and
    val losses lower in the second epoch than in the first, a summary
    over the 7 test clips. Returns its numbers."""
    scripts = os.path.join(HERE, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import parity_rehearsal_torch as rehearsal
    out = tempfile.mkdtemp(prefix="chip_smoke_rehearsal_")
    try:
        torch.cuda.synchronize()
        _build.reset_stats()
        t0 = time.perf_counter()
        summary = rehearsal.main(["--num_samples", "40", "--epochs", "2",
                                  "--output_dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = _launches()
        written = sorted(os.listdir(out))
        evaluated = sorted(os.listdir(os.path.join(out, "eval_out")))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _require_launched(stats, TRAINING + ("decode_cross_attention",
                                         "fused_greedy_step"), "phase 32")
    curve = summary["loss_curve"]
    require(len(curve) == 2
            and curve[1]["train_loss"] < curve[0]["train_loss"]
            and curve[1]["val_loss"] < curve[0]["val_loss"],
            f"phase 32: the loss falls over two epochs: {curve}")
    require(summary["test_samples"] == 7
            and math.isfinite(summary["best_val_loss"])
            and 0.0 <= summary["test_accuracy"] <= 1.0,
            f"phase 32: summary {summary}")
    require({"metrics.jsonl", "rehearsal_summary.json", "style_to_id.txt",
             "eval_out"} <= set(written)
            and evaluated == ["metrics.txt", "predictions.txt"],
            f"phase 32: wrote {written}, eval_out {evaluated}")
    log(f"rehearsal at full width ({smi}; 40 clips, 2 epochs, batch 5, "
        f"bf16): {wall:.1f} s; loss curve {json.dumps(curve)}; test "
        f"accuracy {summary['test_accuracy']} on "
        f"{summary['test_samples']} clips; launches {stats}")
    return {"launches": {k: v[0] for k, v in stats.items()},
            "wall_s": wall, "loss_curve": curve}


# ---------------------------------------------------------------------------
# phase 33: K6, the grouped SwiGLU expert GEMM
# ---------------------------------------------------------------------------

# Uni-MoE-2.0-Omni's widths (hidden, expert width, routed experts) and the
# omni cell's K6 calls: a decode step's 64 slots (32 rows x 2) on one, two
# and four experts, and a prefill's 31,248 slots (15,624 tokens x 2) with
# about 18,900 routed; the other slots are null or not kept
K6_D, K6_F, K6_E = 3584, 18944, 4
K6_CASES = (("decode_e1", 64, (38, 0, 0, 0)), ("decode_e2", 64, (19, 19, 0, 0)),
            ("decode_e4", 64, (10, 10, 9, 9)),
            ("prefill", 31248, (6000, 4400, 4900, 3600)))
K6 = ("expert_gate_up", "expert_down")


def k6_bound(counts, m):
    """(bound_ms, bound_by) of one K6 call: the active experts' weights,
    the routed rows read, their (rows, F) intermediate written and read
    in bf16, the (m, D) output written; 6 D F operations a routed row."""
    rows, active = sum(counts), sum(c > 0 for c in counts)
    moved = 2 * (active * 3 * K6_D * K6_F + rows * K6_D + m * K6_D
                 + 2 * rows * K6_F)
    return bound(moved, 6 * K6_D * K6_F * rows, BF16_FLOPS)


def _k6_omni_launches(torch, _build, smi):
    """K6's launches on its main path: `OmniPipeline.generate` at a small
    Uni-MoE (hidden 256, 2 layers, bf16) on the card, the second call of
    a shape (its decode graphs captured by the first): one launch of each
    half per layer in the prefill and in every replayed step, no plain
    call."""
    from audio_transformers_tpu_torch.core.config import (OmniConfig,
                                                          UniMoEConfig,
                                                          WhisperConfig)
    from audio_transformers_tpu_torch.infer.omni import OmniPipeline, seeded
    import numpy as np
    llm = UniMoEConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=2, mrope_section=(8, 12, 12),
                       expert_size=256, shared_size=128)
    cfg = OmniConfig(whisper=WhisperConfig.test(), llm=llm, audio_tokens=8)
    pipe = OmniPipeline(seeded(cfg, 33, router_scale=8.0), cfg,
                        device="cuda")
    rng = np.random.default_rng(33)
    audio = [0.1 * rng.standard_normal(n).astype(np.float32)
             for n in (30000, 50000, 9000)]
    prompts = [list(range(1, 13)), list(range(40, 60)), list(range(9, 19))]
    new = 6
    pipe.generate(audio, prompts, new)
    torch.cuda.synchronize()
    _build.reset_stats()
    pipe.generate(audio, prompts, new)
    torch.cuda.synchronize()
    stats = _launches()
    want = llm.num_layers * new
    for name in K6:
        require(stats[name] == (want, 0),
                f"phase 33: {name} launches, plain calls {stats[name]} in "
                f"a {new}-token generate at {llm.num_layers} layers; want "
                f"({want}, 0)")
    log(f"K6 in OmniPipeline.generate ({smi}; hidden 256, "
        f"{llm.num_layers} layers, 3 rows, {new} tokens): {want} launches "
        f"of each half, no plain call")
    return want


def check_k6(torch, _build, smi):
    """Phase 33: K6 (`ops/expert_gemm.expert_swiglu`) at the published
    widths and the omni cell's shapes (K6_CASES), bf16: against its plain
    version on the same inputs within K6_TOL of the plain output's
    largest magnitude (the plain version with each expert's weights moved
    to the next expert must lie outside it, so the tolerance fails a
    wrong expert), the slots past offsets[E] zero, two launches
    bit-equal, one launch of each half a call by the wrapper's counter
    and two K6 kernels a call by the profiler; the time per call (CUDA
    events), the kernels' device time, the plain version's time, and one
    cuBLAS GEMM chain per active expert on host-known row ranges as the
    library call; then its launches on the main path
    (`_k6_omni_launches`). Returns (K6's kernel entry, max error)."""
    import numpy as np
    from audio_transformers_tpu_torch.ops import expert_gemm as eg
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(33)

    def w(shape, fan_in):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                / fan_in ** 0.5).to(torch.bfloat16)
    wg, wu = w((K6_E, K6_F, K6_D), K6_D), w((K6_E, K6_F, K6_D), K6_D)
    wd = w((K6_E, K6_D, K6_F), K6_F)
    results, worst = {}, 0.0
    for name, m, counts in K6_CASES:
        x = torch.randn((m, K6_D), generator=gen, device="cuda").bfloat16()
        off = torch.tensor(np.cumsum((0,) + counts), dtype=torch.int32,
                           device="cuda")
        rows = sum(counts)
        stats = [_build.STATS[k] for k in K6]
        before = [(s.launches, s.plain_cuda_calls) for s in stats]
        got = eg.expert_swiglu(x, off, wg, wu, wd)
        got2 = eg.expert_swiglu(x, off, wg, wu, wd)
        require([(s.launches - a, s.plain_cuda_calls - p) for s, (a, p)
                 in zip(stats, before)] == [(2, 0), (2, 0)],
                f"K6 {name}: one launch of each half a call, no plain call")
        want = eg.expert_swiglu_reference(x, off, wg, wu, wd)
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max()) / scale
        require(torch.equal(got, got2), f"K6 {name}: two launches differ")
        require(not got[rows:].any(), f"K6 {name}: slots past offsets[E] "
                "are not zero")
        require(err <= K6_TOL, f"K6 {name}: {err:.3g} of the plain output's "
                f"largest magnitude, over {K6_TOL}")
        shifted = eg.expert_swiglu_reference(
            x, off, wg.roll(1, 0), wu.roll(1, 0), wd.roll(1, 0))
        wrong = float((shifted[:rows].float() - want[:rows].float())
                      .abs().max()) / scale
        require(wrong > K6_TOL, f"K6 {name}: experts moved by one lie "
                f"within the tolerance ({wrong:.3g})")
        del got2, shifted
        worst = max(worst, err)

        def kernel():
            eg.expert_swiglu(x, off, wg, wu, wd)

        starts = np.cumsum((0,) + counts).tolist()

        def library():
            y = torch.zeros_like(x)
            for e, (a, n) in enumerate(zip(starts, counts)):
                if n:
                    xe = x[a:a + n]
                    y[a:a + n] = (F.silu(xe @ wg[e].t()) * (xe @ wu[e].t())
                                  ) @ wd[e].t()
            return y
        # a trace also holds records that are not K6's (the output's zero
        # fill), whose count varies: a whole trace holds every K6 record
        events = kernel_events(kernel, whole=lambda ev: sum(
            "k6_" in k for k, _ in ev) == 2 * 20)
        ours = [us for k, us in events if "k6_" in k]
        require(len(ours) == 2 * 20, f"K6 {name}: {len(ours)} K6 kernels "
                f"for 20 calls")
        bnd = k6_bound(counts, m)
        t = {"ms": time_ms(kernel), "device_ms": sum(ours) / 20 / 1e3,
             "plain_ms": time_ms(lambda: eg.expert_swiglu_reference(
                 x, off, wg, wu, wd), reps=3, warmup=1),
             "library_ms": time_ms(library), "bound_ms": bnd[0],
             "bound_by": bnd[1]}
        log(f"K6 {name} ({smi}; M={m}, rows {counts}): {err:.3g} of the "
            f"plain output's largest magnitude (experts moved by one: "
            f"{wrong:.3g}), two launches bit-equal; per call kernel "
            f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms (the two K6 "
            f"kernels), plain {t['plain_ms']:.2f} ms, cuBLAS per expert "
            f"{t['library_ms']:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, "
            f"{100 * bnd[0] / t['device_ms']:.1f}% of it by device time)")
        results[name] = t
        del x, got, want
    del wg, wu, wd
    torch.cuda.empty_cache()
    launches = _k6_omni_launches(torch, _build, smi)
    e2 = results["decode_e2"]
    return {"name": "expert_swiglu", "route": "cuda",
            "source": "audio_transformers_tpu_torch/csrc/expert_gemm_sm90.cu",
            "replaces": None, "launches": launches, "max_abs_err": worst,
            **e2, **{f"{k}_{name}": v for name, t in results.items()
                       for k, v in t.items()}}, worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import audio_transformers_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print("chip_smoke: imported a port from outside this checkout",
              file=sys.stderr)
        return 1

    from audio_transformers_tpu_torch import core as port_core
    from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                                   MelConfig, WhisperConfig)
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline
    from audio_transformers_tpu_torch.models.whisper import beam, decode
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.ops import attention as att
    from audio_transformers_tpu_torch.ops import decode_attention as da
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    from audio_transformers_tpu_torch.ops import logit_processors as lp
    from audio_transformers_tpu_torch.ops import mel
    from audio_transformers_tpu_torch.ops import permute as pm

    # the plain versions are the oracle: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {', '.join(_build.KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions at the serving shapes
    cfg = EmotionWhisperConfig()
    w = cfg.whisper
    require((w.d_model, w.encoder_layers, w.decoder_layers, w.num_heads,
             w.vocab_size, w.max_source_positions)
            == (384, 4, 4, 6, 51865, 1500), "whisper-tiny geometry")
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    err = {"decode_cross_attention": check_k1(torch, da, gen, times)}
    # its own generator, so that the phases after it see the inputs they
    # saw before it was added
    err_int4 = check_k1_int4(
        torch, da, torch.Generator(device="cuda").manual_seed(4), times)
    # bf16 (the serving path's dtype) runs K2's tensor-core source
    require(dl.SOURCE[torch.bfloat16] == "decode_logits_sm90",
            "bf16 K2 routes to csrc/decode_logits_sm90.cu")
    err["fused_greedy_step"], below = check_k2(torch, dl, lp, decode, w, gen,
                                               times)
    err["log_mel"] = check_k3(torch, mel, MelConfig.whisper(), gen, times)

    # 4. correctness on a small input: card (kernels) vs CPU (plain)
    check_small_reference(torch, EmotionWhisperConfig, WhisperConfig, init,
                          EmotionWhisperPipeline, synth_clip, ByteTokenizer)

    # 5. the serving path at whisper-tiny width
    params = init(cfg, torch.Generator().manual_seed(0))
    pipe = EmotionWhisperPipeline(params, cfg, device="cuda",
                                  compute_dtype=torch.bfloat16)
    clip = synth_clip(12.0, 16000)
    torch.cuda.synchronize()
    _build.reset_stats()
    t0 = time.perf_counter()
    with _tokens(decode) as phase5_tokens:   # held against phase 20
        out = pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phase5 = (phase5_tokens.kept, out)
    stats = {name: (s.launches, s.plain_cuda_calls)
             for name, s in _build.STATS.items()}
    log(f"analyze (whisper-tiny, bf16, 12 s clip, first call): {wall:.3f} s; "
        f"launches / plain-on-CUDA calls: {stats}")
    check_result(out, 3, cfg.num_emotion_classes)
    for name, (launches, plain) in stats.items():
        require(plain == 0, f"{name}'s plain version ran on CUDA")
    for name in SERVING:
        require(stats[name][0] > 0,
                f"{name} was not launched on the serving path")
    # bf16 on the card: the encoder's self-attention is K4a, a launch a
    # layer in each encode
    k4a_serving = stats["flash_attention_fwd"][0]
    require(k4a_serving > 0 and k4a_serving % w.encoder_layers == 0,
            f"K4a: {k4a_serving} launches on the serving path, not one a "
            f"layer of each encode")
    t0 = time.perf_counter()
    pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    log(f"analyze (same clip, second call): {time.perf_counter() - t0:.3f} s")
    check_replayed_k1(torch, _build, lambda: pipe.analyze(clip, 16000),
                      "analyze (whisper-tiny, bf16, 12 s clip)")

    # 6. the HTTP server
    check_server(pipe, synth_clip)
    del pipe
    torch.cuda.empty_cache()

    # 7. K4 against its plain versions at the training shapes; in bf16 (the
    # training path's dtype) all three run from the tensor-core source
    require(att.SOURCE[torch.bfloat16] == "flash_attention_sm90",
            "bf16 K4a/K4b/K4c route to csrc/flash_attention_sm90.cu")
    k4_times = {}
    err.update(check_k4(torch, att, gen, k4_times))
    # its own generator, so that the phases after it see the inputs they
    # saw before it was added
    serve_err = check_k4_serving(
        torch, att, torch.Generator(device="cuda").manual_seed(7), k4_times)
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], serve_err)
    torch.cuda.empty_cache()

    # 8. one train step at the test config: card vs CPU
    check_small_train_step(torch, port_core, init)

    # 9. the training path at whisper-tiny width, through the CLI; its
    # checkpoint directories serve phase 21
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    train_launches = check_train_cli(torch, _build, run_dir, smi[0])

    # 10-11. overfit on one batch; steady-state step time, flash vs plain
    params = init(EmotionWhisperConfig(num_emotion_classes=9),
                  torch.Generator().manual_seed(0))
    check_overfit(torch, port_core, params)
    step_ms = time_train_step(torch, port_core, params)
    log(f"train step mean ms (batch 16): plain attention "
        f"{step_ms['xla']:.3f}, flash kernels {step_ms['flash']:.3f}")
    del params
    torch.cuda.empty_cache()

    # 12. K5 against its plain version at the beam step's buffers
    k5_times = check_k5(torch, pm, gen)
    err["permute_rows"] = 0.0

    # 13. a beam pipeline at the test config: card vs CPU
    check_small_beam(torch, EmotionWhisperConfig, WhisperConfig, init,
                     EmotionWhisperPipeline)

    # 14. the beam serving path at whisper-tiny width, kv_quant none, int8
    params = init(cfg, torch.Generator().manual_seed(0))
    beam_runs, pipe = check_beam_serving(torch, _build,
                                         EmotionWhisperPipeline, params, cfg,
                                         clip)

    # 15. the HTTP server with the beam pipeline
    check_server(pipe, synth_clip)
    del pipe
    torch.cuda.empty_cache()

    # 16. beam decode ms per step, K5 against the plain reorder
    beam_ms = time_beam_steps(torch, beam, pm, cfg, params)

    # 17. segment and sequence evaluation at the test config: card vs CPU
    check_small_evaluate(torch)

    # 18. segment evaluation at whisper-tiny width, kv_quant none and int4,
    # the fallback at the reference's 2.4 and at a threshold that flags
    # every row (over the id bytes: the byte tokenizer turns few of
    # whisper's ids into text, and an empty text flags nothing)
    evals = {}
    for mode in ("none", "int4"):
        for threshold, tok in ((2.4, ByteTokenizer()), (1e-6, None)):
            evals[(mode, threshold)] = check_eval_full(
                torch, _build, params, cfg, mode, threshold, tok)

    # 19. timestamped 4-beam segment evaluation with int4 cross K/V
    evals["beams"] = check_eval_full(torch, _build, params, cfg, "int4", 2.4,
                                     ByteTokenizer(), beams=N_BEAMS)

    # 20. the HF directory: export, load on the card, analyze, 4 beams
    io_root, io_times = check_hf_path(torch, _build, decode, params, cfg,
                                      clip, phase5, smi[0])
    del params
    torch.cuda.empty_cache()

    # 21. checkpoints: restore, infer, --pretrained, resume exactness
    try:
        io_times.update(check_checkpoint_path(
            torch, _build, port_core, run_dir, os.path.join(io_root, "hf"),
            smi[0]))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        shutil.rmtree(io_root, ignore_errors=True)
    log(f"model I/O times ({smi[0]}): {json.dumps(io_times)}")

    # 22. the classifier at the test widths, card vs CPU (4 s clips and 3 s
    # clips zero-padded to 4 s); K3 on zero-padded clips against its bound
    check_small_classifier(torch, _build, mel)
    k3_padded = check_k3_padded(
        torch, mel, torch.Generator(device="cuda").manual_seed(22), smi[0])

    # 23. the classifier's training path at full width through the CLI,
    # then a rerun that resumes
    classifier_launches = check_classifier_cli(torch, _build, smi[0])

    # 24. the classifier's steady-state train step at batch 64
    classifier_times = time_classifier_step(torch, _build, mel, smi[0])

    # 25. remat: the whisper-tiny train step off and on
    params = init(EmotionWhisperConfig(num_emotion_classes=9),
                  torch.Generator().manual_seed(0))
    remat_launches, remat = check_remat(torch, port_core, _build, params,
                                        smi[0])

    # 26. both trainers through the data-parallel path at world size 1
    dp = check_dp_one_rank(torch, port_core, _build, init, params, smi[0])
    del params
    torch.cuda.empty_cache()

    # 27. two ranks on the one card (gloo)
    dp.update(check_dp_two_ranks(torch, smi[0]))

    # 28. entry.entry()'s forward on the card
    check_entry(torch, _build)

    # 29. K2's vocab-shard mode against its plain version
    t0 = time.perf_counter()
    k2_shards, err["fused_greedy_step_partials"] = check_k2_shards(
        torch, dl, lp, decode, w, torch.Generator(device="cuda").manual_seed(
            29), smi[0])

    # 30. tensor parallelism: decodes, beams, the classifier step and a
    # train step in two ranks
    tp_run = check_tp(torch, smi[0])
    tp_decodes, tp_train = tp_run["decode"], tp_run["train"]
    log(f"phases 29-30: {time.perf_counter() - t0:.1f} s")

    # 31. the greedy decode's routes, step_attn x logits_impl
    t0 = time.perf_counter()
    params = init(cfg, torch.Generator().manual_seed(0))
    routes = check_routes(torch, _build, decode, EmotionWhisperPipeline,
                          params, cfg, clip, smi[0])
    del params
    torch.cuda.empty_cache()

    # 32. the Expresso rehearsal through the port, short
    rehearsal = check_rehearsal(torch, _build, smi[0])
    log(f"phases 31-32: {time.perf_counter() - t0:.1f} s")

    # 33. K6 at Uni-MoE-2.0-Omni's widths, and on its main path
    t0 = time.perf_counter()
    k6_entry, err["expert_swiglu"] = check_k6(torch, _build, smi[0])
    log(f"phase 33: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name in SERVING:
        t4, t16 = times[4][name], times[16][name]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": stats[name][0],
                 "max_abs_err": err[name], **t4,
                 **{f"{k}_b16": v for k, v in t16.items()},
                 **{f"{k}_b{b}": v for b in (1, 128)
                    for k, v in times.get(b, {}).get(name, {}).items()}}
        if name in train_launches:
            entry["launches_training"] = train_launches[name]
        # segment evaluation with int4 cross K/V (K1's int4 mode, K2's
        # timestamp mode), the reference's threshold
        entry["launches_eval_int4"] = evals[("int4", 2.4)]["launches"][name]
        if name == "log_mel":
            # the classifier: phase 23's first run, phase 24's step; K3 on
            # zero-padded clips, held to K3_TOL + frame_error_bound
            entry["launches_classifier"] = classifier_launches
            entry.update(classifier_times)
            entry["max_abs_err_padded"] = k3_padded[0]
            entry["padded_share_of_bound"] = k3_padded[1]
            entry["max_abs_err_padded_3s"] = k3_padded[2]
            # phase 30: rank 0's launches in the bf16 TP classifier step
            entry["launches_tp_classifier"] = next(
                r for r in tp_run["classifier"]
                if r["dtype"] == "bfloat16")["k3_launches_rank0"]
            entry["tp_classifier"] = tp_run["classifier"]
            # data parallelism: phase 26's DP runs, phase 27's ranks
            entry.update(dp)
        if name in routes["launches"]:
            # phase 31: launches by dtype/kv_quant/step_attn/logits_impl,
            # and each combination's decode ms per step
            entry["launches_routes"] = routes["launches"][name]
            entry["routes_ms_per_step"] = routes["ms"]
        entry["launches_rehearsal"] = rehearsal["launches"][name]
        if name == "decode_cross_attention":
            entry["max_abs_err"] = max(err[name], err_int4)
            entry["max_abs_err_int4"] = err_int4
            entry.update({f"int4_{k}_b{b}": v for b in (1, 4, 16)
                          for k, v in times[b][f"{name}_int4"].items()})
        kernels.append(entry)
    for name in TRAINING[1:]:
        # phase 25: launches per step with remat, and its memory and time
        remat_fields = {"launches_remat": remat_launches[name],
                        "launches_rehearsal": rehearsal["launches"][name]}
        if name == "flash_attention_fwd":
            remat_fields.update(remat)
            remat_fields["launches_serving"] = k4a_serving
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": train_launches[name], **remat_fields,
                        "max_abs_err": err[name],
                        **k4_times["encoder"][name],
                        **{f"{shape}_{k}": v
                           for shape in k4_times if shape != "encoder"
                           for k, v in k4_times[shape].get(name, {}).items()
                           if k != "library"}})
    k5 = k5_times[(64, "bf16")]
    kernels.append({
        "name": "permute_rows", "route": "cuda",
        "source": SOURCES["permute_rows"],
        "replaces": REPLACES["permute_rows"],
        "launches": beam_runs["none"]["permute_rows"][0],
        "launches_int8": beam_runs["int8"]["permute_rows"][0],
        "launches_int4": beam_runs["int4"]["permute_rows"][0],
        "launches_eval_beams_int4": evals["beams"]["launches"][
            "permute_rows"],
        "max_abs_err": err["permute_rows"],
        "ms": k5[0], "plain_ms": k5[1], "bound_ms": k5[4][0],
        "bound_by": k5[4][1], "library_ms": None,
        **{f"{key}_{rows}{'' if mode == 'bf16' else '_int8'}": k5_times[
            (rows, mode)][i] if i < 4 else k5_times[(rows, mode)][4][0]
           for rows in (64, 512) for mode in ("bf16", "int8")
           for i, key in enumerate(("ms", "plain_ms", "device_ms",
                                    "plain_device_ms", "bound_ms"))},
        "beam_step_ms": {str(b): v["k5"] for b, v in beam_ms.items()},
        "beam_step_plain_ms": {str(b): v["plain"]
                               for b, v in beam_ms.items()},
        # phase 30: rank 0's launches in the bf16 TP beams (kv_quant none;
        # each case's in `tp_beam`)
        "launches_tp_beam": next(
            r for r in tp_run["beam"] if r["dtype"] == "bfloat16")[
                "cases"]["none"]["k5_launches_rank0"],
        "tp_beam": tp_run["beam"]})
    # K2's vocab-shard mode: launches on phase 30's main path (rank 0 of
    # the bf16 decode), times of phase 29 (t = 2, B = 4 the main fields)
    bf16 = next(r for r in tp_decodes if r["dtype"] == "bfloat16")
    kernels.append({
        "name": "fused_greedy_step_partials", "route": "cuda",
        "source": SOURCES["fused_greedy_step_partials"],
        "replaces": REPLACES["fused_greedy_step_partials"],
        "launches": bf16["launches_rank0"]["fused_greedy_step_partials"],
        "max_abs_err": err["fused_greedy_step_partials"],
        **k2_shards[(2, 4)],
        **{f"{k}_t{t}_b{b}": v for (t, b), res in k2_shards.items()
           for k, v in res.items() if k != "library_ms"},
        "tp_decode": tp_decodes, "tp_train": tp_train})
    for entry in kernels:
        # phase 30's launches on rank 0 (K1, K3 of the decode)
        if entry["name"] in ("decode_cross_attention", "log_mel"):
            entry["launches_tp_rank0"] = bf16["launches_rank0"][
                entry["name"]]
    kernels.append(k6_entry)
    log(f"K2 rows below the top-2 gap {K2_GAP} (not compared): {below}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
