"""Omni cells: spoken question answering with Uni-MoE-2.0-Omni through the
program's `OmniPipeline.generate`, whole batches issued back to back.

Set-up makes the served weights (bfloat16, per tensor from the seed), a
pool of distinct batches (recordings of the mix's lengths and prompts of
its id counts) and the pipeline, and runs one batch (every kernel built,
every shape of the window used). The window calls `generate` until its
time is up; the last call started completes and counts. The rate is the
seconds of real audio in the completed batches over the window's start
to the last batch's end.

What the check compares is kept by the program for the window's first
call (`models/unimoe/model.Observer`, passed to `generate`): the sampled
rows' log-mel windows and projected audio tokens, every layer's routing
of every token, and the final hidden states at each greedy pick, whose
logits (the program's head product, `models/unimoe/model.logits`) are
taken before the weights are released. The check compares them with the
plain reference's teacher-forced forward over the program's own tokens
(`reference/unimoe.evaluate`), and holds each greedy id the program
picked (K2, `fused_greedy_step`) to the reference's logits at its
position: `token_gap`, the reference's best logit less its logit at the
picked id, is 0 where the reference picks the same id.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import traffic
from benchmark.harness.checks import rel_fro
from benchmark.harness.ranks import SINGLE, Ranks
from benchmark.harness.tracing import DeviceTrace, Spans

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Span:
    """The traffic generator's view of a mix's longest recording: its
    length in samples."""

    def __init__(self, seconds: float, sample_rate: int):
        self.sample_rate = sample_rate
        self.window_samples = int(round(seconds * sample_rate))


def batch(mix: dict, dims, seed: int, index: int, device):
    """(recordings, prompts) of batch `index`: float32 numpy waveforms of
    the mix's lengths (speech-like, `traffic.audio`) and lists of prompt
    ids drawn from the configuration's text ids."""
    rows = mix["batch"]
    span = _Span(mix["audio_s"][1], dims.sample_rate)
    wav = traffic.audio(mix, span, seed, index, rows, device).cpu().numpy()
    lengths = (traffic.audio_lengths(mix, seed, index, rows)
               * dims.sample_rate).long().tolist()
    g = torch.Generator().manual_seed(traffic.batch_seed(seed, index, 6))
    lo, hi = mix["prompt_ids"]
    counts = traffic._spread(lo, hi + 1, rows, g).floor().long().clamp(lo, hi)
    ids = torch.randint(*dims.text_ids, (rows, hi), generator=g)
    return ([wav[r, :n] for r, n in enumerate(lengths)],
            [ids[r, :int(counts[r])].tolist() for r in range(rows)])


class OmniCell:
    kind = "omni"

    def __init__(self, dims, mix: dict, seed: int, device, spans: Spans,
                 traced: bool, *, family, ranks: Ranks = SINGLE):
        from audio_transformers_tpu_torch.infer import omni
        from audio_transformers_tpu_torch.models.unimoe import model as um

        if ranks.world > 1:
            raise SystemExit("an omni cell runs on one card")
        self.dims, self.mix, self.seed, self.device = dims, mix, seed, device
        self.family, self.um = family, um
        self.batch = mix["batch"]
        self.dtype = DTYPES[mix["compute_dtype"]]
        self.rows = sorted(random.Random(traffic.batch_seed(seed, 0, 3))
                           .sample(range(self.batch), mix["check_rows"]))
        cfg, mel_cfg = family.port_config(dims)
        self.pipe = omni.OmniPipeline(
            family.port_tree(family.make_weights(dims, seed, device,
                                                 self.dtype)),
            cfg, mel_cfg, device=device, compute_dtype=self.dtype,
            encoder_bucket=mix["encoder_bucket"],
            audio_after=mix["audio_after"])
        self.pool = [batch(mix, dims, seed, i, device)
                     for i in range(mix["pool"])]
        self.audio_s = sum(len(a) for a in self.pool[0][0]) / dims.sample_rate
        self.observer = None
        self._call(0)                            # warm-up: every shape

    def _call(self, i: int, observer=None) -> None:
        audio, prompts = self.pool[i % len(self.pool)]
        self.tokens = self.pipe.generate(audio, prompts,
                                         self.mix["max_new_tokens"],
                                         observer=observer)

    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """Whole batches until `seconds` have passed; with `trace_steps`,
        the device trace covers that many batches from the window's second
        (again from the next, up to three times, if a trace holds no
        device record)."""
        n, tries, trace, begin = 0, 0, None, 1
        self.t0_ns = time.perf_counter_ns()
        t0 = last = time.perf_counter()
        while last - t0 < seconds or (trace is not None and trace.t1 == 0):
            if trace_steps and n == begin and trace is None:
                trace = DeviceTrace().__enter__()
            if n == 0:
                self.observer = self.um.Observer(self.rows)
            self._call(n, self.observer if n == 0 else None)
            if n == 0:
                self.first_tokens = self.tokens
            last = time.perf_counter()
            n += 1
            if trace is not None and trace.t1 == 0 and n == begin + trace_steps:
                trace.__exit__(None, None, None)
                if not trace.records and tries < 2:
                    tries, trace, begin = tries + 1, None, n
        elapsed = last - t0
        self.calls = n
        self.rate_batches = n / elapsed
        return {"attempted": n * self.batch, "failed": 0,
                "rate": (n * self.audio_s / elapsed, "audio-s/s"),
                "trace": trace, "window_s": elapsed}

    def release(self) -> None:
        """The program's logits of the sampled rows, then the weights go."""
        if self.pipe is not None and self.observer is not None:
            vocab = self.pipe.cfg.llm.vocab_size
            hidden = torch.stack(self.observer.hidden, dim=1)   # (rows, S, D)
            self.logits = [self.um.logits(h, self.pipe.table, vocab)
                           for h in hidden]
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def _windows(self):
        """Each row's window count and first window in the first call's
        batch."""
        w = self.dims.window_samples
        counts = [max(1, -(-len(a) // w)) for a in self.pool[0][0]]
        starts = [sum(counts[:r]) for r in range(len(counts))]
        return counts, starts

    def reference(self, precision: str = "float32") -> list:
        """The reference's readings of the sampled rows of the window's
        first call."""
        audio, prompts = self.pool[0]
        counts, _ = self._windows()
        w = self.dims.window_samples
        rows = []
        for r in self.rows:
            wav = torch.zeros(counts[r] * w)
            wav[:len(audio[r])] = torch.from_numpy(audio[r])
            rows.append({"windows": wav.view(counts[r], w).to(self.device),
                         "ids": prompts[r], "after": self.mix["audio_after"],
                         "fed": self.first_tokens[r, :-1].tolist()})
        make = self.family.maker(self.dims, self.seed, self.device,
                                 self.dtype)
        return self.family.reference.evaluate(
            self.dims.reference_dims(), make, rows, precision)

    def _program(self) -> list:
        """The program's readings of the sampled rows, as `reference`
        gives the reference's."""
        obs, a = self.observer, self.dims.audio_tokens
        counts, starts = self._windows()
        mel = torch.cat(obs.mel)
        audio = torch.cat(obs.audio)
        routes = obs.routes
        layers = self.dims.layers
        prompts = self.pool[0][1]
        lengths = [len(p) + a * n for p, n in zip(prompts, counts)]
        out = []
        for j, r in enumerate(self.rows):
            s = slice(starts[r], starts[r] + counts[r])
            t0 = sum(lengths[:r])
            per_layer = []
            for i in range(layers):
                pre = routes[i][t0:t0 + lengths[r]]
                steps = [routes[(k + 1) * layers + i][r:r + 1]
                         for k in range(len(routes) // layers - 1)]
                per_layer.append(torch.cat([pre] + steps).long())
            out.append({"mel": mel[s], "audio": audio[s].reshape(
                counts[r] * a, -1), "logits": self.logits[j],
                "routes": per_layer, "tokens": torch.as_tensor(
                    self.first_tokens[r]).long()})
        return out

    def numbers(self, r: list, other: list = None) -> dict:
        """The five numbers of the sampled rows: the program's readings (or
        `other`'s) against the reference's `r`. The ids judged by
        `token_gap` are the program's greedy picks, or the ids `other`'s
        logits put first (the control, fed the program's ids)."""
        got = self._program() if other is None else other
        null = self.dims.experts + self.dims.null_experts
        diff = total = 0
        num = den = gap = 0.0
        for g, ref in zip(got, r):
            picked = (g["tokens"] if "tokens" in g
                      else g["logits"].argmax(dim=-1)).to(ref["logits"].device)
            at = ref["logits"].gather(1, picked[:, None])[:, 0]
            gap = max(gap, float((ref["logits"].max(dim=-1).values - at)
                                 .max()))
            for pg, pr in zip(g["routes"], ref["routes"]):
                a = [frozenset(s for s in row if 0 <= s < null)
                     for row in pg.tolist()]
                b = [frozenset(s for s in row if 0 <= s < null)
                     for row in pr.tolist()]
                diff += sum(x != y for x, y in zip(a, b))
                total += len(b)
            num += float((g["logits"].float() - ref["logits"]).square().sum())
            den += float(ref["logits"].square().sum())
        return {
            "mel_err": max(float((g["mel"].float() - ref["mel"]).abs().max())
                           for g, ref in zip(got, r)),
            "audio_err": max(rel_fro(g["audio"], ref["audio"])
                             for g, ref in zip(got, r)),
            "logit_err": (num / max(den, 1e-30)) ** 0.5,
            "route_gap": diff / max(total, 1),
            "token_gap": gap,
        }

    def control_numbers(self, r: list) -> dict:
        """The control's numbers: the reference in float8 in the program's
        place, against the float32 reference `r`."""
        return self.numbers(r, other=self.reference("fp8"))


def _two_slots(spans, kind):
    """Routing that ignores top-p: the two most probable slots are always
    kept."""
    from audio_transformers_tpu_torch.models.unimoe import model as um

    def route(orig):
        def both(router_w, u, cfg):
            p = torch.softmax(u.float() @ router_w.float().t(), dim=-1)
            top, idx = torch.sort(p, dim=-1, descending=True, stable=True)
            top, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
            return idx, torch.where(idx < cfg.num_experts, top, 0.0)
        return both
    spans.hook(um, "route", route)


def _second_best(spans, kind):
    """A greedy pick that returns each row's second most probable id at
    every step (the head's product in its dtype, the padded ids masked);
    the decode feeds it on."""
    from audio_transformers_tpu_torch.infer import omni
    from audio_transformers_tpu_torch.models.unimoe import model as um

    def pick(orig):
        def second(hidden, table, add, **kwargs):
            logits = (hidden @ table).float() + add
            return logits.topk(2, dim=-1).indices[:, 1].to(torch.int32)
        return second
    for module in (um, omni):
        spans.hook(module, "fused_greedy_step", pick)


def _no_shared(spans, kind):
    """An MoE FFN without its shared experts."""
    from audio_transformers_tpu_torch.models.unimoe import model as um
    spans.hook(um, "_swiglu", lambda orig: lambda p, u: torch.zeros_like(u))


# faults planted under the timed path, for reading the limits
# (`calibrate.readings` after `faults.PLANTS` and `faults.FOR_KIND` take
# them); none of them runs in a benchmark run
FAULTS = {"two_slots": _two_slots, "no_shared": _no_shared,
          "second_best": _second_best}
