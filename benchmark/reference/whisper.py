"""Plain EmotionWhisper in PyTorch: the yardstick that decides `correct`.

Written from whisper's published description, in float32 (float64 for
the spectrogram) with TF32 off, and in blocks of rows so that it fits at
full width: the log-mel front end (reflect-padded 400-point frames, a
periodic Hann window, the power spectrum, the Slaney mel bank, log10,
the max - 8 floor, (x + 4) / 4), the encoder (two GELU convolutions,
sinusoidal positions, pre-LN blocks), the decoder (token and learned
positions, causal self-attention, cross-attention, MLP, tied output
projection), the emotion head over the mean of the decoder states, the
dual loss (token cross-entropy over non-pad targets plus 0.5 x the
emotion cross-entropy) and AdamW. It imports nothing of the program.

`precision="fp8"` is the control: every operand of every matrix product
and convolution is rounded to float8 e4m3 with a per-tensor scale before
a float32 product, the step below the bfloat16 the cells compute in.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.harness.spec import Dims

Tensor = torch.Tensor
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: Tensor) -> Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    y = (x.detach() / s).float().to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (y - x).detach()       # the rounding, with x's gradient


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mels = f / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / logstep, mels)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
                    m * (200.0 / 3.0))


def slaney_bank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) Slaney-normalised triangular bank."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                 n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    bank = np.maximum(0.0, np.minimum(down, up))
    return bank * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[None, :]


class Whisper:
    """The reference over flat float32 weights {name: tensor} (names of
    `benchmark.harness.weights`)."""

    def __init__(self, dims: Dims, weights: Dict[str, Tensor],
                 precision: str = "float32", remat: bool = False):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.dims, self.w = dims, weights
        self.q = _fp8 if precision == "fp8" else (lambda x: x)
        self.remat = remat

    # -- primitives ---------------------------------------------------------

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, p: str, x: Tensor) -> Tensor:
        y = self.mm(x, self.w[p + ".w"].t())
        b = self.w.get(p + ".b")
        return y if b is None else y + b

    def conv(self, p: str, x: Tensor, stride: int) -> Tensor:
        y = F.conv1d(self.q(x.transpose(1, 2)), self.q(self.w[p + ".w"]),
                     self.w[p + ".b"], stride=stride, padding=1)
        return y.transpose(1, 2)

    def ln(self, p: str, x: Tensor) -> Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[p + ".scale"],
                            self.w[p + ".bias"], 1e-5)

    def attention(self, p: str, xq: Tensor, xkv: Tensor,
                  causal: bool = False) -> Tensor:
        b, tq, d = xq.shape
        h, hd = self.dims.heads, self.dims.head_dim

        def heads(x, name):
            return self.linear(f"{p}.{name}", x).view(b, -1, h, hd
                                                       ).transpose(1, 2)
        q, k, v = heads(xq, "q"), heads(xkv, "k"), heads(xkv, "v")
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            keep = torch.ones(tq, s.shape[-1], dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        o = self.mm(torch.softmax(s, dim=-1), v)
        return self.linear(f"{p}.o", o.transpose(1, 2).reshape(b, tq, d))

    def mlp(self, p: str, x: Tensor) -> Tensor:
        return self.linear(f"{p}.fc2", F.gelu(self.linear(f"{p}.fc1", x)))

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- the model ----------------------------------------------------------

    def mel(self, wav: Tensor) -> Tensor:
        """(B, N) -> (B, N // hop, n_mels) float32 log-mel features."""
        d = self.dims
        x = F.pad(wav.double()[:, None], (d.n_fft // 2, d.n_fft // 2),
                  mode="reflect")[:, 0]
        frames = x.unfold(1, d.n_fft, d.hop)
        n = torch.arange(d.n_fft, dtype=torch.float64, device=wav.device)
        win = 0.5 - 0.5 * torch.cos(2 * math.pi * n / d.n_fft)
        k = torch.arange(d.n_fft // 2 + 1, dtype=torch.float64,
                         device=wav.device)
        ang = 2 * math.pi * n[:, None] * k[None, :] / d.n_fft
        fw = frames * win
        power = self.mm(fw, torch.cos(ang)) ** 2 + self.mm(
            fw, torch.sin(ang)) ** 2
        bank = torch.from_numpy(slaney_bank(d.sample_rate, d.n_fft,
                                            d.n_mels)).to(wav.device)
        mel = self.mm(power, bank)[:, :-1]
        out = torch.log10(mel.clamp(min=1e-10))
        out = torch.maximum(out, out.amax(dim=(1, 2), keepdim=True) - 8.0)
        return ((out + 4.0) / 4.0).float()

    def encode(self, mel: Tensor) -> Tensor:
        x = F.gelu(self.conv("whisper.encoder.conv1", mel, 1))
        x = F.gelu(self.conv("whisper.encoder.conv2", x, 2))
        x = x + self.w["whisper.encoder.pos"][: x.shape[1]]
        for i in range(self.dims.encoder_layers):
            x = self._run(self._enc_block, f"whisper.encoder.blocks.{i}", x)
        return self.ln("whisper.encoder.ln", x)

    def _enc_block(self, p: str, x: Tensor) -> Tensor:
        h = self.ln(f"{p}.self_ln", x)
        x = x + self.attention(f"{p}.self_attn", h, h)
        return x + self.mlp(p, self.ln(f"{p}.mlp_ln", x))

    def decode(self, enc: Tensor, tokens: Tensor) -> Tensor:
        """Teacher-forced decoder states (B, T, D) over tokens (B, T)."""
        x = (self.w["whisper.decoder.embed.table"][tokens]
             + self.w["whisper.decoder.pos"][: tokens.shape[1]])
        for i in range(self.dims.decoder_layers):
            x = self._run(self._dec_block, f"whisper.decoder.blocks.{i}", x,
                          enc)
        return self.ln("whisper.decoder.ln", x)

    def _dec_block(self, p: str, x: Tensor, enc: Tensor) -> Tensor:
        h = self.ln(f"{p}.self_ln", x)
        x = x + self.attention(f"{p}.self_attn", h, h, causal=True)
        h = self.ln(f"{p}.cross_ln", x)
        x = x + self.attention(f"{p}.cross_attn", h, enc)
        return x + self.mlp(p, self.ln(f"{p}.mlp_ln", x))

    def logits(self, hidden: Tensor) -> Tensor:
        return self.mm(hidden, self.w["whisper.decoder.embed.table"].t())

    def emotion_logits(self, hidden: Tensor) -> Tensor:
        return self.linear("emotion_head", hidden.mean(dim=1))

    def cross_kv(self, enc: Tensor) -> List[Tensor]:
        """Each decoder layer's cross K and V, (B, H, hd, T) each."""
        b, t, _ = enc.shape
        h, hd = self.dims.heads, self.dims.head_dim
        out = []
        for i in range(self.dims.decoder_layers):
            for name in ("k", "v"):
                y = self.linear(f"whisper.decoder.blocks.{i}.cross_attn."
                                f"{name}", enc)
                out.append(y.view(b, t, h, hd).permute(0, 2, 3, 1))
        return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rows_per_block(dims: Dims, budget_bytes: float = 2.0e9) -> int:
    """Rows of one block so that an encoder layer's scores fit a budget."""
    per_row = dims.heads * dims.source_positions ** 2 * 4 * 3
    return max(1, int(budget_bytes // per_row))


def train_steps(dims: Dims, weights: Dict[str, Tensor], batches: Sequence,
                trainable: Sequence[str], *, lr: float, betas=(0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                emotion_weight: float = 0.5, precision: str = "float32",
                group=None) -> dict:
    """AdamW steps over `batches` ({"waveform", "labels",
    "emotion_labels"}) from float32 `weights` (updated in place).

    Returns {"loss": [per step], "grad_norm": {leaf: ||g|| of step 1},
    "change": {leaf: ||p_n - p_0|| after the last step}}. Each step's
    gradient is summed over blocks of rows with the batch's global
    normalisation (the token mean over the whole batch's non-pad
    targets), each block's decoder and encoder blocks recomputed in the
    backward.

    With a `torch.distributed` process `group`, each process holds its
    rows of the batch (an equal share) and the same weights: the token
    count and the rows are summed over the group before the
    normalisation, and each step's loss and float32 gradients after the
    blocks, so every process takes the global batch's step."""
    model = Whisper(dims, weights, precision, remat=True)
    params = {n: weights[n] for n in trainable}
    start = {n: p.detach().clone() for n, p in params.items()}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p))
               for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    out = {"loss": [], "grad_norm": {}, "change": {}}
    rows = rows_per_block(dims)
    world = 1 if group is None else dist.get_world_size(group)
    b1, b2 = betas
    with exact_float32():
        for step, batch in enumerate(batches, start=1):
            labels = batch["labels"]
            targets = labels[:, 1:]
            mask = (targets != dims.pad_id).float()
            count = mask.sum()
            n = labels.shape[0]
            if group is not None:
                dist.all_reduce(count, group=group)
            count = count.clamp(min=1.0)
            total = 0.0
            for lo in range(0, n, rows):
                sl = slice(lo, min(lo + rows, n))
                mel = model.mel(batch["waveform"][sl])
                enc = model.encode(mel)
                hidden = model.decode(enc, labels[sl, :-1])
                tok = F.cross_entropy(model.logits(hidden).transpose(1, 2),
                                      targets[sl], reduction="none")
                emo = F.cross_entropy(model.emotion_logits(hidden),
                                      batch["emotion_labels"][sl],
                                      reduction="sum")
                loss = (tok * mask[sl]).sum() / count \
                    + emotion_weight * emo / (n * world)
                loss.backward()
                total += float(loss.detach())
            if group is not None:
                total = _summed(total, group, count.device)
                for p in params.values():
                    dist.all_reduce(p.grad, group=group)
            out["loss"].append(total)
            with torch.no_grad():
                for name, p in params.items():
                    g = p.grad
                    if step == 1:
                        out["grad_norm"][name] = float(g.norm())
                    m, v = moments[name]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                    p.mul_(1 - lr * weight_decay)
                    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
                    p.grad = None
    with torch.no_grad():
        for name, p in params.items():
            out["change"][name] = float((p - start[name]).norm())
            p.requires_grad_(False)
    return out


def _summed(value: float, group, device) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return float(t[0])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def processed(logits: Tensor, tokens: Sequence[int], pos: int, dims: Dims,
              prompt_len: int, penalty: float, ngram: int) -> Tensor:
    """The float64 logits for position `pos` after whisper's processors:
    the suppress list (and " " and EOS at the first generated position)
    excluded, the repetition penalty over the ids of tokens[:pos] (positive
    logits divided by it, negative ones multiplied), and every id that
    would repeat an `ngram`-gram of tokens[:pos] excluded."""
    x = logits.double().clone()
    ids = list(dims.suppress)
    if pos == prompt_len:
        ids += list(dims.begin_suppress)
    x[torch.tensor(ids, dtype=torch.long, device=x.device)] = float("-inf")
    seen = torch.tensor(sorted(set(tokens[:pos])), device=x.device)
    s = x[seen]
    x[seen] = torch.where(s > 0, s / penalty, s * penalty)
    if ngram and pos >= ngram - 1:
        tail = tuple(tokens[pos - ngram + 1:pos])
        banned = [tokens[i + ngram - 1] for i in range(pos - ngram + 1)
                  if tuple(tokens[i:i + ngram - 1]) == tail]
        if banned:
            x[torch.tensor(banned, device=x.device)] = float("-inf")
    return x


def token_gaps(ref_logits: Tensor, tokens: Sequence[int], length: int,
               dims: Dims, prompt_len: int, penalty: float, ngram: int,
               chosen_logits: Optional[Tensor] = None) -> List[float]:
    """For each generated position p (prompt_len <= p < length): how far
    the reference's processed logit of the token at p lies below its best
    (ref_logits (T, V): row p - 1 predicts position p). With
    `chosen_logits` the token judged at each position is the one those
    logits, processed alike, put first (the control), not the served one."""
    gaps = []
    for pos in range(prompt_len, length):
        ref = processed(ref_logits[pos - 1], tokens, pos, dims, prompt_len,
                        penalty, ngram)
        if chosen_logits is None:
            tok = tokens[pos]
        else:
            tok = int(processed(chosen_logits[pos - 1], tokens, pos, dims,
                                prompt_len, penalty, ngram).argmax())
        gaps.append(float(ref.max() - ref[tok]))
    return gaps
