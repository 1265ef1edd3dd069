"""Operations and bytes of an omni cell's batch, from its shapes and from
the program's routing counters (`moe.slots.expert<e>`, `moe.tokens`,
`moe.experts.active`, summed over the calls read): the routed experts'
work is what the routing actually sent them, not a top-k assumption.

K6 (the grouped SwiGLU expert GEMM, `k6_gate_up_sm90` then
`k6_down_sm90`): per routed row 6 D F flops (three products of D x F);
bytes read once and written once: each active expert's three weight
matrices a call (3 D F bf16 values), and per row its input (D), the
intermediate written and read (2 F) and its output (D), in bf16.
"""

from __future__ import annotations

from typing import Dict

from benchmark.harness import counts

BF16 = 2


def routed_rows(c: Dict[str, int], experts: int) -> int:
    return sum(c.get(f"moe.slots.expert{e}", 0) for e in range(experts))


def expert_gemm(dims, c: Dict[str, int]):
    """(flops, bytes) of K6 over the counted calls."""
    d, f = dims.hidden, dims.expert_size
    rows = routed_rows(c, dims.experts)
    flops = 6.0 * d * f * rows
    nbytes = (c.get("moe.experts.active", 0) * 3.0 * d * f
              + rows * (2.0 * d + 2.0 * f)) * BF16
    return flops, nbytes


def expert_gemm_roofline(dims, c: Dict[str, int], device_s: float) -> float:
    """K6's share (%) of its roofline: the least time its counted work
    allows over its device time."""
    flops, nbytes = expert_gemm(dims, c)
    return 100.0 * counts.bound(nbytes, flops)[0] / device_s


def encoder_flops(dims) -> float:
    """One 30 s window through the whisper encoder."""
    e, f, t = dims.enc_d, dims.enc_ffn, dims.source_positions
    conv = 2 * dims.mel_frames * dims.n_mels * e * 3 + 2 * t * e * e * 3
    block = 2 * t * 4 * e * e + 4 * t * t * e + 4 * t * e * f
    return conv + dims.enc_layers * block


def batch_flops(dims, c: Dict[str, int], windows: int, tokens_in: int,
                rows: int, new_tokens: int, attended: float) -> float:
    """Model FLOPs of one batch: the encoder of its windows, the connector,
    every fed token through every layer (q/k/v/o, the causal attention
    over `attended` (token, key) pairs summed over the rows, the router,
    the shared experts), the routed experts' counted rows, and the head at
    each pick."""
    d, hd = dims.hidden, dims.head_dim
    kv = dims.kv_heads * hd
    fed = tokens_in + rows * (new_tokens - 1)
    per_token = (2 * d * (2 * d + 2 * kv) + 2 * d * dims.experts
                 + 2 * dims.null_experts * d
                 + 6 * d * dims.shared * dims.shared_size)
    layers = dims.layers * (fed * per_token + 4 * attended * d)
    routed = 6.0 * d * dims.expert_size * routed_rows(c, dims.experts)
    audio = windows * (encoder_flops(dims) + 2 * dims.audio_tokens
                       * dims.enc_d * d)
    head = 2 * d * dims.vocab * rows * new_tokens
    return audio + layers + routed + head
