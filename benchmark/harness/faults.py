"""Faults planted under the timed path, for the check's own tests and for
reading its upper limits on the card. Each is a `plant(spans, kind)` for
`cell.run`: it hooks a name of the program before set-up, and the run's
`close` restores it. None of them runs in a benchmark run."""

from __future__ import annotations


def state_unchanged(spans, kind):
    """A train step that leaves the parameters and the optimizer state as
    they were: AdamW's step does nothing."""
    from audio_transformers_tpu_torch.train import optim
    spans.hook(optim.Optimizer, "step", lambda orig: lambda self: None)


def half_batch(spans, kind):
    """A train step that leaves out the second half of the batch, the
    mean taken over the rest."""
    from audio_transformers_tpu_torch.train import whisper_emotion as we

    def make_steps(orig):
        def build(*args, **kwargs):
            train_step, eval_step = orig(*args, **kwargs)

            def half(params, batch, generator=None):
                n = batch["labels"].shape[0] // 2
                return train_step(params, {k: v[:n] for k, v in batch.items()},
                                  generator)
            return half, eval_step
        return build
    spans.hook(we, "make_steps", make_steps)


def token_altered(spans, kind):
    """A greedy step that, every 16th call, picks the neighbouring id
    (one below, or one above id 0) for every row, where the token is
    produced; the decode feeds it on."""
    import torch

    from audio_transformers_tpu_torch.ops import decode_logits
    calls = [0]

    def step(orig):
        def altered(*args, **kwargs):
            ids = orig(*args, **kwargs)
            calls[0] += 1
            if calls[0] % 16 == 5:
                ids = torch.where(ids > 0, ids - 1, ids + 1)
            return ids
        return altered
    spans.hook(decode_logits, "fused_greedy_step", step)


def no_exchange(spans, kind):
    """A data-parallel train step that leaves out the exchange between the
    cards: each rank steps on its own rows' gradient."""
    from audio_transformers_tpu_torch.train import whisper_emotion as we
    spans.hook(we, "average_gradients", lambda orig: lambda *a, **k: None)


PLANTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "no_exchange": no_exchange}
FOR_KIND = {"train": ("state_unchanged", "half_batch"),
            "analyze": ("token_altered",)}
# what a cell of a kind can have besides, on several cards
ACROSS_CARDS = {"train": ("no_exchange",)}


def for_cell(kind: str, chips: int) -> tuple:
    """The faults a cell of `kind` on `chips` cards can have."""
    return FOR_KIND.get(kind, ()) + (ACROSS_CARDS.get(kind, ())
                                     if chips > 1 else ())
