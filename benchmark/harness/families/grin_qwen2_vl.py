"""The Uni-MoE-2.0-Omni family (`"model_type": "grin_qwen2_vl"`): the
speech-understanding path, whisper-large-v3's encoder into a 28-layer
dynamic-capacity MoE language model (`audio_transformers_tpu_torch/
models/unimoe`).

Weights are seeded per tensor name (`tensor`), so that the plain
reference can remake one layer at a time on the card (26 B parameters
never sit there in float32) and get the values the program was given.
Leaf names are the program's tree paths joined by "."."""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from benchmark.harness import weights
from benchmark.reference import unimoe as reference  # noqa: F401

PUBLISHED = {
    "https://huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni/blob/main/config.json": {
        "hidden_size": 3584, "num_hidden_layers": 28,
        "num_attention_heads": 28, "num_key_value_heads": 4,
        "dynamic_intermediate_size": 18944, "shared_intermediate_size": 2368,
        "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
        "mlp_fixed_expert_num": 2, "mlp_dynamic_top_k": 2,
        "mlp_dynamic_top_p": 0.7, "vocab_size": 152064,
        "rms_norm_eps": 1e-06, "rope_theta": 1000000,
        "whisper_hidden_size": 1280, "whisper_query_tokens_size": 200},
}
FROZEN = ("whisper.encoder.pos",)


@dataclass(frozen=True)
class Dims:
    """The sizes of a configuration file."""
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    rope_theta: float
    mrope_section: Tuple[int, ...]
    eps: float
    experts: int
    null_experts: int
    expert_size: int
    shared: int
    shared_size: int
    top_p: float
    top_k: int
    vocab: int
    enc_d: int
    enc_layers: int
    enc_heads: int
    enc_ffn: int
    n_mels: int
    source_positions: int
    audio_tokens: int
    router_scale: float
    embed_std: float
    text_ids: Tuple[int, int]
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def window_samples(self) -> int:
        """One 30 s encoder window."""
        return self.source_positions * 2 * self.hop

    @property
    def mel_frames(self) -> int:
        return self.source_positions * 2

    def reference_dims(self):
        return reference.Dims(
            hidden=self.hidden, layers=self.layers, heads=self.heads,
            kv_heads=self.kv_heads, rope_theta=self.rope_theta,
            mrope_section=self.mrope_section, eps=self.eps,
            experts=self.experts, null_experts=self.null_experts,
            top_p=self.top_p, top_k=self.top_k, vocab=self.vocab,
            enc_d=self.enc_d, enc_layers=self.enc_layers,
            enc_heads=self.enc_heads, audio_tokens=self.audio_tokens,
            n_mels=self.n_mels, sample_rate=self.sample_rate,
            n_fft=self.n_fft, hop=self.hop)


def dims(raw: dict) -> Dims:
    enc, assumed = raw["whisper_encoder"], raw["assumed"]
    return Dims(
        hidden=raw["hidden_size"], layers=raw["num_hidden_layers"],
        heads=raw["num_attention_heads"], kv_heads=raw["num_key_value_heads"],
        rope_theta=float(raw["rope_theta"]),
        mrope_section=tuple(raw["rope_scaling"]["mrope_section"]),
        eps=raw["rms_norm_eps"], experts=raw["mlp_dynamic_expert_num"],
        null_experts=raw["mlp_dynamic_null_expert_num"],
        expert_size=raw["dynamic_intermediate_size"],
        shared=raw["mlp_fixed_expert_num"],
        shared_size=raw["shared_intermediate_size"],
        top_p=raw["mlp_dynamic_top_p"], top_k=raw["mlp_dynamic_top_k"],
        vocab=raw["vocab_size"], enc_d=raw["whisper_hidden_size"],
        enc_layers=enc["encoder_layers"],
        enc_heads=enc["encoder_attention_heads"],
        enc_ffn=enc["encoder_ffn_dim"], n_mels=enc["num_mel_bins"],
        source_positions=enc["max_source_positions"],
        audio_tokens=raw["whisper_query_tokens_size"],
        router_scale=float(assumed["router_init_scale"]),
        embed_std=float(assumed["embed_init_std"]),
        text_ids=tuple(assumed["text_token_ids"]),
        sample_rate=assumed["sample_rate"])


def port_config(d: Dims):
    """(OmniConfig, MelConfig) of the program."""
    from audio_transformers_tpu_torch.core.config import (
        MelConfig, OmniConfig, UniMoEConfig, WhisperConfig)
    whisper = WhisperConfig(
        vocab_size=8, n_mels=d.n_mels, d_model=d.enc_d,
        encoder_layers=d.enc_layers, decoder_layers=0, num_heads=d.enc_heads,
        ffn_dim=d.enc_ffn, max_source_positions=d.source_positions)
    llm = UniMoEConfig(
        vocab_size=d.vocab, hidden_size=d.hidden, num_layers=d.layers,
        num_heads=d.heads, num_kv_heads=d.kv_heads, rope_theta=d.rope_theta,
        mrope_section=d.mrope_section, rms_norm_eps=d.eps,
        num_experts=d.experts, null_experts=d.null_experts,
        expert_size=d.expert_size, shared_experts=d.shared,
        shared_size=d.shared_size, top_p=d.top_p, top_k=d.top_k)
    return (OmniConfig(whisper=whisper, llm=llm, audio_tokens=d.audio_tokens),
            MelConfig.whisper(sample_rate=d.sample_rate, n_mels=d.n_mels))


# -- the seeded weights --------------------------------------------------------


def _linear(p: str, fan_in: int, out: int, bias: bool = True,
            scale: float = 1.0) -> list:
    b = scale / math.sqrt(fan_in)
    specs = [(f"{p}.w", (out, fan_in), "uniform", b)]
    if bias:
        specs.append((f"{p}.b", (out,), "uniform", b))
    return specs


def _ln(p: str, n: int, bias: bool = True) -> list:
    out = [(f"{p}.scale", (n,), "ones", 0.0)]
    return out + [(f"{p}.bias", (n,), "zeros", 0.0)] if bias else out


def encoder_specs(d: Dims) -> list:
    e, pre = d.enc_d, "whisper.encoder"
    out = [(f"{pre}.conv1.w", (e, d.n_mels, 3), "uniform",
            1 / math.sqrt(d.n_mels * 3)),
           (f"{pre}.conv1.b", (e,), "uniform", 1 / math.sqrt(d.n_mels * 3)),
           (f"{pre}.conv2.w", (e, e, 3), "uniform", 1 / math.sqrt(e * 3)),
           (f"{pre}.conv2.b", (e,), "uniform", 1 / math.sqrt(e * 3)),
           (f"{pre}.pos", (d.source_positions, e), "sinusoid", 0.0)]
    for i in range(d.enc_layers):
        p = f"{pre}.blocks.{i}"
        out += (_ln(f"{p}.self_ln", e) + _linear(f"{p}.self_attn.q", e, e)
                + _linear(f"{p}.self_attn.k", e, e, bias=False)
                + _linear(f"{p}.self_attn.v", e, e)
                + _linear(f"{p}.self_attn.o", e, e) + _ln(f"{p}.mlp_ln", e)
                + _linear(f"{p}.fc1", e, d.enc_ffn)
                + _linear(f"{p}.fc2", d.enc_ffn, e))
    return out + _ln(f"{pre}.ln", e)


def layer_specs(d: Dims, i: int) -> list:
    h, kv = d.hidden, d.kv_heads * d.head_dim
    f, fs = d.expert_size, d.shared * d.shared_size
    p = f"llm.layers.{i}"
    return (_ln(f"{p}.attn_norm", h, bias=False)
            + _linear(f"{p}.attn.q", h, h) + _linear(f"{p}.attn.k", h, kv)
            + _linear(f"{p}.attn.v", h, kv)
            + _linear(f"{p}.attn.o", h, h, bias=False)
            + _ln(f"{p}.moe_norm", h, bias=False)
            + [(f"{p}.moe.router.w", (d.experts + d.null_experts, h),
                "uniform", d.router_scale / math.sqrt(h)),
               (f"{p}.moe.experts.w_gate", (d.experts, f, h), "uniform",
                1 / math.sqrt(h)),
               (f"{p}.moe.experts.w_up", (d.experts, f, h), "uniform",
                1 / math.sqrt(h)),
               (f"{p}.moe.experts.w_down", (d.experts, h, f), "uniform",
                1 / math.sqrt(f)),
               (f"{p}.moe.shared.w_gate", (fs, h), "uniform", 1 / math.sqrt(h)),
               (f"{p}.moe.shared.w_up", (fs, h), "uniform", 1 / math.sqrt(h)),
               (f"{p}.moe.shared.w_down", (h, fs), "uniform",
                1 / math.sqrt(d.shared_size))])


def outer_specs(d: Dims) -> list:
    """The connector, the embedding, the final norm and the head."""
    return (_linear("connector", d.enc_d, d.hidden)
            + [("llm.embed.table", (d.vocab, d.hidden), "normal",
                d.embed_std)]
            + _ln("llm.norm", d.hidden, bias=False)
            + _linear("llm.head", d.hidden, d.vocab, bias=False))


def leaf_specs(d: Dims) -> List[tuple]:
    """[(name, shape, kind, scale)] of every leaf."""
    out = encoder_specs(d) + outer_specs(d)
    for i in range(d.layers):
        out += layer_specs(d, i)
    return out


def n_params(d: Dims) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaf_specs(d))


def tensor_seed(seed: int, name: str) -> int:
    return int.from_bytes(hashlib.sha256(
        f"{int(seed)}:{name}".encode()).digest()[:8], "little") % 2 ** 62


def tensor(spec: tuple, seed: int, device, dtype=torch.float32
           ) -> torch.Tensor:
    """One leaf from (seed, its name): the same values on every call."""
    name, shape, kind, scale = spec
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "sinusoid":
        return weights.sinusoids(*shape).to(device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    if kind == "normal":
        t = torch.randn(shape, generator=g, device=device)
        return t.mul_(scale).to(dtype)
    t = torch.rand(shape, generator=g, device=device)
    return t.mul_(2.0 * scale).sub_(scale).to(dtype)


def make_weights(d: Dims, seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every leaf in `dtype` on `device`."""
    return {spec[0]: tensor(spec, seed, device, dtype)
            for spec in leaf_specs(d)}


def port_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The program's tree ({"whisper": {"encoder"}, "connector", "llm"})
    over the flat leaves."""
    return weights.tree(flat)


def maker(d: Dims, seed: int, device, dtype=torch.bfloat16):
    """{group: a function making that group's leaves} for the blockwise
    reference: "encoder", "outer" and "layer.<i>"; each leaf as the
    program got it (in `dtype`), widened to float32."""
    groups = {"encoder": encoder_specs(d), "outer": outer_specs(d)}
    groups.update({f"layer.{i}": layer_specs(d, i) for i in range(d.layers)})

    def make(group: str) -> Dict[str, torch.Tensor]:
        return {s[0]: tensor(s, seed, device, dtype).float()
                for s in groups[group]}
    return make
