"""Operations and bytes from a cell's shapes, and the card's peaks.

Each count is what the algorithm needs at the cell's shapes (inputs read
once, outputs written once, a causal product counted over its kept half),
not what a kernel happens to do; a roofline share is the least time these
allow (the larger of bytes over the memory rate and operations over the
peak of their type) over the measured device time.
"""

from __future__ import annotations

from benchmark.harness.spec import Dims

# NVIDIA H100 SXM, dense, at its 700 W limit (the card's data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float, flops_per_s: float = PEAK_BF16_FLOPS):
    """(seconds, "bytes" | "operations"): the least time the card could
    take."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pad_vocab(v: int, block: int = 1024) -> int:
    """The vocab width the greedy step's operands carry (a multiple of
    1024, as the program pads them)."""
    return -(-v // block) * block


# -- attention (K4): per call ------------------------------------------------


def attention_flops(rows: int, tq: int, tk: int, hd: int, causal: bool,
                    backward: bool) -> float:
    """rows = batch x heads. Forward: QK^T and PV; backward: dV, dP, dQ and
    dK (the forward's scores recomputed are not counted)."""
    pairs = tq * (tq + 1) / 2 if causal else tq * tk
    per_product = 2.0 * rows * pairs * hd
    return per_product * (2 + (4 if backward else 0))


def attention_bytes(rows: int, tq: int, tk: int, hd: int, backward: bool,
                    itemsize: int = 2) -> float:
    """Forward: q, k, v read, o written (and the float32 row statistics);
    backward: q, k, v, o, dO read, dq, dk, dv written."""
    q, kv = rows * tq * hd * itemsize, rows * tk * hd * itemsize
    fwd = 2 * q + 2 * kv + rows * tq * 4
    bwd = 3 * q + 2 * kv + 2 * kv + rows * tq * 4
    return fwd + (bwd if backward else 0)


def train_attention(dims: Dims, batch: int, t_dec: int):
    """(flops, bytes) of every flash-attention call of one train step,
    forward and backward: the encoder's self-attention, the decoder's
    causal self-attention and its cross-attention."""
    r = batch * dims.heads
    hd, te = dims.head_dim, dims.source_positions
    calls = [(dims.encoder_layers, te, te, False),
             (dims.decoder_layers, t_dec, t_dec, True),
             (dims.decoder_layers, t_dec, te, False)]
    flops = sum(n * attention_flops(r, tq, tk, hd, c, True)
                for n, tq, tk, c in calls)
    byts = sum(n * attention_bytes(r, tq, tk, hd, True)
               for n, tq, tk, c in calls)
    return flops, byts


# -- the front end (K3) ----------------------------------------------------


def mel_bytes(dims: Dims, batch: int) -> float:
    """The float32 waveform read once and the float32 features written
    once."""
    return batch * (dims.window_samples + dims.mel_frames * dims.n_mels) * 4


# -- decode kernels: per call ------------------------------------------------


def cross_attention_bytes(dims: Dims, batch: int, itemsize: int = 2) -> float:
    """K1, one layer of one step: the K and V of every row read once, q
    read and the output written (bf16)."""
    kv = 2 * batch * dims.d_model * dims.source_positions * itemsize
    return kv + 2 * batch * dims.d_model * itemsize


def greedy_step_bytes(dims: Dims, batch: int, itemsize: int = 2) -> float:
    """K2, one step: the padded (D, V) table, the additive vector
    (float32), the int8 seen and ban masks read once, the hidden states
    read, one id a row written."""
    v = pad_vocab(dims.vocab)
    return (dims.d_model * v * itemsize + v * 4 + 2 * batch * v
            + batch * dims.d_model * itemsize + batch * 4)


# -- model FLOPs -------------------------------------------------------------


def encoder_flops(dims: Dims) -> float:
    """Forward of one 30 s window: the two convolutions and the blocks."""
    d, f, t = dims.d_model, dims.ffn, dims.source_positions
    conv = 2 * dims.mel_frames * dims.n_mels * d * 3 + 2 * t * d * d * 3
    block = 2 * t * 4 * d * d + 4 * t * t * d + 4 * t * d * f
    return conv + dims.encoder_layers * block


def cross_kv_flops(dims: Dims) -> float:
    """Every decoder layer's cross K and V of one window."""
    return dims.decoder_layers * 4 * dims.source_positions * dims.d_model ** 2


def decoder_flops(dims: Dims, t: int) -> float:
    """Teacher-forced forward of t positions (one row), cross K/V and the
    tied projection to the vocabulary included."""
    d, f, te = dims.d_model, dims.ffn, dims.source_positions
    block = (2 * t * 4 * d * d + 2 * t * (t + 1) * d    # self: proj, causal
             + 2 * t * 2 * d * d + 4 * t * te * d      # cross: q, o; attend
             + 4 * t * d * f)
    return (dims.decoder_layers * block + cross_kv_flops(dims)
            + 2 * t * d * dims.vocab)


def train_flops_per_clip(dims: Dims, t_dec: int) -> float:
    """Model FLOPs of one clip of a train step: the forward three times
    (forward and backward); recompute under remat not counted."""
    return 3.0 * (encoder_flops(dims) + decoder_flops(dims, t_dec))


def decode_step_flops(dims: Dims, index: int, logits: bool) -> float:
    """One row of one cached decode step at cache position `index`."""
    d, f, te = dims.d_model, dims.ffn, dims.source_positions
    block = (2 * 4 * d * d + 4 * (index + 1) * d
             + 2 * 2 * d * d + 4 * te * d + 4 * d * f)
    return dims.decoder_layers * block + (2 * d * dims.vocab if logits else 0)


def analyze_flops_per_window(dims: Dims, steps: int, prompt_len: int) -> float:
    """One window of `analyze_windows`: the encoder, the cross K/V and
    `steps` decode steps (positions 0 .. steps - 1), the vocabulary
    projection at every step that picks a token."""
    dec = sum(decode_step_flops(dims, i, logits=prompt_len <= i + 1 < steps)
              for i in range(steps))
    return encoder_flops(dims) + cross_kv_flops(dims) + dec
