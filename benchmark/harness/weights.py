"""EmotionWhisper weights made from the seed, on the device, in two calls.

The leaves follow the distributions of a fresh whisper (linear and conv
weights and biases uniform in +-1/sqrt(fan_in), the token table and the
decoder positions normal with std 0.02, layer norms at 1 and 0, the
encoder positions whisper's frozen sinusoids). All uniform leaves are cut
from one `torch.rand` draw and all normal leaves from one `torch.randn`
draw of a generator on the device, so a seed gives the same weights on
every call. The benchmark hands the same values to the program (its
parameter tree, `tree`) and to the plain reference (the flat dict).
Leaf names are paths of the program's tree joined by ".".
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.harness.spec import Dims

FROZEN = ("whisper.encoder.pos",)


def _linear(prefix: str, fan_in: int, fan_out: int, bias: bool = True):
    bound = 1.0 / math.sqrt(fan_in)
    out = [(f"{prefix}.w", (fan_out, fan_in), "uniform", bound)]
    if bias:
        out.append((f"{prefix}.b", (fan_out,), "uniform", bound))
    return out


def _ln(prefix: str, d: int):
    return [(f"{prefix}.scale", (d,), "ones", 0.0),
            (f"{prefix}.bias", (d,), "zeros", 0.0)]


def _attn(prefix: str, d: int):
    return (_linear(f"{prefix}.q", d, d) + _linear(f"{prefix}.k", d, d, False)
            + _linear(f"{prefix}.v", d, d) + _linear(f"{prefix}.o", d, d))


def _block(prefix: str, dims: Dims, cross: bool):
    d = dims.d_model
    out = _ln(f"{prefix}.self_ln", d) + _attn(f"{prefix}.self_attn", d)
    if cross:
        out += _ln(f"{prefix}.cross_ln", d) + _attn(f"{prefix}.cross_attn", d)
    out += (_ln(f"{prefix}.mlp_ln", d) + _linear(f"{prefix}.fc1", d, dims.ffn)
            + _linear(f"{prefix}.fc2", dims.ffn, d))
    return out


def leaf_specs(dims: Dims) -> List[Tuple[str, tuple, str, float]]:
    """[(name, shape, kind, scale)] in the program's tree order."""
    d = dims.d_model
    conv1 = 1.0 / math.sqrt(dims.n_mels * 3)
    conv2 = 1.0 / math.sqrt(d * 3)
    out = [("whisper.encoder.conv1.w", (d, dims.n_mels, 3), "uniform", conv1),
           ("whisper.encoder.conv1.b", (d,), "uniform", conv1),
           ("whisper.encoder.conv2.w", (d, d, 3), "uniform", conv2),
           ("whisper.encoder.conv2.b", (d,), "uniform", conv2),
           ("whisper.encoder.pos", (dims.source_positions, d), "sinusoid", 0.0)]
    for i in range(dims.encoder_layers):
        out += _block(f"whisper.encoder.blocks.{i}", dims, cross=False)
    out += _ln("whisper.encoder.ln", d)
    out += [("whisper.decoder.embed.table", (dims.vocab, d), "normal", 0.02),
            ("whisper.decoder.pos", (dims.target_positions, d), "normal", 0.02)]
    for i in range(dims.decoder_layers):
        out += _block(f"whisper.decoder.blocks.{i}", dims, cross=True)
    out += _ln("whisper.decoder.ln", d)
    out += _linear("emotion_head", d, dims.classes)
    return out


def n_params(dims: Dims) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaf_specs(dims))


def sinusoids(length: int, dim: int) -> torch.Tensor:
    """Whisper's positional table: concat(sin, cos), log-spaced
    timescales from 1 to 10000 over dim / 2 - 1 steps."""
    half = dim // 2
    inc = math.log(10000.0) / max(half - 1, 1)
    freqs = torch.exp(-inc * torch.arange(half, dtype=torch.float64))
    args = torch.arange(length, dtype=torch.float64)[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1).float()


def make(dims: Dims, seed: int, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} in `dtype` on `device`, from `seed`. Leaves are views
    of two flat buffers (and small constants)."""
    specs = leaf_specs(dims)
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in specs if kind == k)
             for k in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=g,
                                  device=device),
            "normal": torch.randn(sizes["normal"], generator=g,
                                  device=device)}
    flat["uniform"].mul_(2.0).sub_(1.0)
    flat = {k: v.to(dtype) if dtype != torch.float32 else v
            for k, v in flat.items()}
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, scale in specs:
        if kind in flat:
            n = math.prod(shape)
            o = offsets[kind]
            t = flat[kind][o:o + n].view(shape)
            offsets[kind] = o + n
            t.mul_(scale)
        elif kind == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = sinusoids(*shape).to(device=device, dtype=dtype)
        out[name] = t
    return out


def tree(flat: Dict[str, torch.Tensor], clone: bool = False) -> dict:
    """The program's nested parameter tree (dicts, and lists for blocks)
    over the flat leaves; `clone` gives every leaf its own storage."""
    root: dict = {}
    for name, t in flat.items():
        keys = name.split(".")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.clone() if clone else t
    return _lists(root)


def _lists(node):
    """Dicts whose keys are all digits become lists (the blocks)."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
