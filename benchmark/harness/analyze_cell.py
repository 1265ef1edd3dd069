"""Offline analysis cells: `EmotionWhisperPipeline.analyze_windows` over
whole batches of model windows, issued back to back.

Set-up makes the served weights (bfloat16) and a pool of distinct batches
of windows from the seed, builds the pipeline and runs one batch (every
shape the window uses). The window calls `analyze_windows` until its
time is up; the last call started completes and counts. Captures for the
check: every call's tokens, and for the window's first call the sampled
rows' log-mel features, encoder states and cross K/V.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import program, traffic
from benchmark.harness.checks import rel_fro
from benchmark.harness.ranks import SINGLE, Ranks
from benchmark.harness.tracing import DeviceTrace, Spans

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class AnalyzeCell:
    kind = "analyze"

    def __init__(self, dims, mix: dict, seed: int, device, spans: Spans,
                 traced: bool, *, family, ranks: Ranks = SINGLE):
        from audio_transformers_tpu_torch.infer.pipeline import \
            EmotionWhisperPipeline

        if ranks.world > 1:
            raise SystemExit("an analyze cell runs on one card")
        self.dims, self.mix, self.seed, self.device = dims, mix, seed, device
        self.family = family
        self.spans = spans
        self.batch = mix["batch"]
        self.dtype = DTYPES[mix["compute_dtype"]]
        self.rows = sorted(random.Random(traffic.batch_seed(seed, 0, 3)).sample(
            range(self.batch), mix["check_rows"]))
        cfg, mel_cfg = family.port_config(dims)
        params = family.port_tree(family.make_weights(dims, seed, device,
                                                      self.dtype))
        self.pipe = EmotionWhisperPipeline(
            params, cfg, mel_cfg, device=device, compute_dtype=self.dtype,
            suppress_ids=dims.suppress, kv_quant=mix["kv_quant"])
        self.pool = [traffic.audio(mix, dims, seed, i, self.batch,
                                   device).cpu().numpy()
                     for i in range(mix["pool"])]
        self.audio_s = float(traffic.audio_lengths(
            mix, seed, 0, self.batch).clamp(
                max=dims.window_samples / dims.sample_rate).sum())
        self.tokens, self.probs, self.armed, self.capture = [], [], False, {}
        self._hooks(program.modules(), traced)
        self._call(0)                            # warm-up: every shape
        self.tokens, self.probs = [], []

    def _hooks(self, mods: dict, traced: bool) -> None:
        rows = torch.tensor(self.rows, device=self.device)
        spans = self.spans

        def keep(name):
            def after(out, args, kwargs):
                if not self.armed:
                    return
                if name == "cross":
                    self.capture[name] = [t.index_select(0, rows).clone()
                                          for kv in zip(out["k"], out["v"])
                                          for t in kv]
                else:
                    self.capture[name] = out.index_select(0, rows).clone()
            return after

        def tokens(out, args, kwargs):
            self.tokens.append(out["tokens"].clone())

        span = spans.wrap if traced else (
            lambda owner, attr, name, cuda_events=False, after=None:
            spans.hook(owner, attr, lambda f: _after(f, after)))
        span(mods["pipeline"], "log_mel", "log_mel", after=keep("mel"))
        span(mods["model"], "encode", "encode", cuda_events=True,
             after=keep("enc"))
        span(mods["model"], "precompute_cross_attention", "cross_kv",
             after=keep("cross"))
        span(mods["decode"], "generate", "generate", after=tokens)
        if traced:
            spans.wrap(mods["model"], "apply_decoder_step", "decoder_step")
            spans.wrap(mods["emotion"], "sequence_emotion_from_hiddens",
                       "emotion_head")

    def _call(self, i: int) -> None:
        _, probs = self.pipe.analyze_windows(
            self.pool[i % len(self.pool)],
            max_new_tokens=self.mix["max_new_tokens"],
            max_batch=self.mix["max_batch"])
        self.probs.append(probs)

    def window(self, seconds: float, trace_steps: int = 0) -> dict:
        """Whole batches until `seconds` have passed; with `trace_steps`,
        the device trace covers that many batches from the window's
        second (again from the next, up to three times, if a trace holds
        no device record)."""
        n, tries, trace, begin = 0, 0, None, 1
        self.t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        last = t0
        while last - t0 < seconds or (trace is not None and trace.t1 == 0):
            if trace_steps and n == begin and trace is None:
                trace = DeviceTrace().__enter__()
                before = program.launches()
            self.armed = n == 0
            self._call(n)
            self.armed = False
            last = time.perf_counter()
            n += 1
            if trace is not None and trace.t1 == 0 and n == begin + trace_steps:
                trace.__exit__(None, None, None)
                after = program.launches()
                launched = {k: after[k] - before[k] for k in after}
                if not trace.complete(launched) and tries < 2:
                    tries, trace, begin = tries + 1, None, n
        elapsed = last - t0
        self.calls = n
        self.traced_calls = trace_steps
        self.rate_batches = n / elapsed
        return {"attempted": n * self.batch, "failed": 0,
                "rate": (n * self.audio_s / elapsed, "audio-s/s"),
                "trace": trace, "window_s": elapsed}

    def release(self) -> None:
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def _sample(self):
        """(call, row) pairs to compare: the window's first call's sampled
        rows, the longest request, and draws from the seed."""
        mix = self.mix
        rng = random.Random(traffic.batch_seed(self.seed, 0, 4))
        lengths = [self._lengths(t) for t in self.tokens]
        picks = [(0, r) for r in self.rows]
        longest = max(((c, r) for c in range(len(lengths))
                       for r in range(self.batch)),
                      key=lambda cr: lengths[cr[0]][cr[1]])
        picks.append(longest)
        while len(picks) < mix["check_rows"] + mix["check_extra"] + 1:
            picks.append((rng.randrange(len(self.tokens)),
                          rng.randrange(self.batch)))
        return picks, lengths

    def _lengths(self, tokens: torch.Tensor) -> list:
        """Each row's length: up to and with its first EOS after the
        prompt, else the whole buffer."""
        eos, p = self.dims.eos_id, self.prompt_len
        out = []
        for row in tokens.cpu().tolist():
            hit = [i for i in range(p, len(row)) if row[i] == eos]
            out.append(hit[0] + 1 if hit else len(row))
        return out

    @property
    def prompt_len(self) -> int:
        return 2                  # <|startoftranscript|> <|notimestamps|>

    def _fed(self, tokens: torch.Tensor) -> int:
        """Positions the decode fed: up to the step at which every row had
        emitted EOS, or the whole buffer."""
        length = tokens.shape[1]
        eos = (tokens == self.dims.eos_id).cpu()
        eos[:, :self.prompt_len] = False
        done = eos.cumsum(dim=1) > 0
        every = done.all(dim=0).nonzero()
        last = int(every[0]) if len(every) else length - 1
        return min(last, length - 1) + 1

    def reference(self, precision: str = "float32") -> dict:
        """The reference's readings of the sampled requests."""
        d, mix = self.dims, self.mix
        ref = self.family.reference
        w = {n: t.float() for n, t in self.family.make_weights(
            d, self.seed, self.device, self.dtype).items()}
        model = ref.Whisper(d, w, precision)
        picks, lengths = self._sample()
        out = {"picks": picks, "mel": [], "enc": [], "cross": [],
               "logits": [], "probs": []}
        with torch.no_grad(), ref.exact_float32():
            for i, (call, row) in enumerate(picks):
                wav = torch.from_numpy(
                    self.pool[call % len(self.pool)][row:row + 1]).to(
                        self.device)
                mel = model.mel(wav)
                enc = model.encode(mel)
                tokens = self.tokens[call][row:row + 1].long()
                fed = self._fed(self.tokens[call])
                hidden = model.decode(enc, tokens[:, :fed])
                full = torch.zeros((1, tokens.shape[1], d.d_model),
                                   device=self.device)
                full[:, :fed] = hidden
                out["probs"].append(torch.softmax(
                    model.emotion_logits(full), dim=-1)[0].cpu())
                out["logits"].append(model.logits(hidden)[0])
                if i < len(self.rows):
                    out["mel"].append(mel[0])
                    out["enc"].append(enc[0])
                    out["cross"].append(model.cross_kv(enc))
        out["lengths"] = lengths
        return out

    def numbers(self, r: dict, control: dict = None) -> dict:
        """The five numbers of the sampled rows: the program's outputs
        against the reference `r`, or with `control`, the control's."""
        d, mix = self.dims, self.mix
        gaps, probs = [], []
        for i, (call, row) in enumerate(r["picks"]):
            toks = self.tokens[call][row].tolist()
            length = min(r["lengths"][call][row], self._fed(self.tokens[call]))
            gaps += self.family.reference.token_gaps(
                r["logits"][i], toks, length, d, self.prompt_len,
                mix["repetition_penalty"], mix["no_repeat_ngram"],
                chosen_logits=None if control is None
                else control["logits"][i])
            p_other = (control["probs"][i] if control is not None
                       else torch.from_numpy(self.probs[call][row]))
            probs.append(float((p_other.float() - r["probs"][i]).abs().max()))
        if control is None:
            mel = [self.capture["mel"][j] for j in range(len(self.rows))]
            enc = [self.capture["enc"][j] for j in range(len(self.rows))]
            cross = [[t[j] for t in self.capture["cross"]]
                     for j in range(len(self.rows))]
        else:
            mel, enc = control["mel"], control["enc"]
            cross = [[t[0] for t in c] for c in control["cross"]]
        return {
            "mel_err": max(float((m.float() - rm).abs().max())
                           for m, rm in zip(mel, r["mel"])),
            "encoder_err": max(rel_fro(e, re) for e, re in zip(enc, r["enc"])),
            "cross_kv_err": max(rel_fro(t, rt[0])
                                for c, rc in zip(cross, r["cross"])
                                for t, rt in zip(c, rc)),
            "token_gap": max(gaps),
            "emotion_err": max(probs),
        }


    def control_numbers(self, r: dict) -> dict:
        """The control's numbers: the reference in float8 in the
        program's place, against the float32 reference `r`."""
        return self.numbers(r, control=self.reference("fp8"))


def _after(fn, after):
    if after is None:
        return fn

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        after(out, args, kwargs)
        return out
    return wrapped
