"""Text tokenization for the seq2seq pipeline.

The reference depends on `WhisperProcessor`'s tokenizer (reference:
whisper_finetune/dataset.py:65-66). Here tokenization is behind a small
protocol so the framework works offline:

  - WhisperTextTokenizer: wraps the HF whisper tokenizer when its vocab is
    available (cache/local path); used for real training/eval.
  - ByteTokenizer: deterministic byte-level fallback (offset into a small
    reserved-special region), self-contained — used by tests, synthetic
    datasets, and demos in hub-less environments.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    pad_token_id: int
    eos_token_id: int
    decoder_start_token_id: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes offset by `num_special`. Special ids:
    0=pad/eos, 1=start, 2=lang, 3=notimestamps, 4..=timestamps (optional)."""

    def __init__(self, num_special: int = 8, *, pad_token_id: int = 0,
                 eos_token_id: int = 0, decoder_start_token_id: int = 1):
        self.num_special = num_special
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.decoder_start_token_id = decoder_start_token_id
        self.vocab_size = 256 + num_special

    def encode(self, text: str) -> List[int]:
        return [b + self.num_special for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        # ids outside the byte range (e.g. from an untrained model with a
        # larger vocab) are skipped rather than crashing
        data = bytes(i - self.num_special for i in ids
                     if self.num_special <= i < self.num_special + 256)
        return data.decode("utf-8", errors="replace")

    def with_specials(self, ids: Sequence[int]) -> List[int]:
        return [self.decoder_start_token_id, *ids, self.eos_token_id]


class WhisperTextTokenizer:
    """HF whisper tokenizer wrapper (requires local vocab files or a warm
    HF cache; `from_pretrained` needs network otherwise)."""

    def __init__(self, name_or_path: str = "openai/whisper-tiny",
                 language: Optional[str] = "english",
                 task: str = "transcribe"):
        from transformers import WhisperTokenizer
        self._tok = WhisperTokenizer.from_pretrained(
            name_or_path, language=language, task=task)
        self.pad_token_id = self._tok.pad_token_id
        self.eos_token_id = self._tok.eos_token_id
        # derive from the vocab, never hardcode: <|startoftranscript|> is
        # 50258 in the multilingual vocab but 50257 in the English-only
        # (.en) vocab — a hardcoded id would make training labels disagree
        # with the config-driven decode prompt (models/whisper/load.py
        # derives the same id from the HF config)
        self.decoder_start_token_id = self._tok.convert_tokens_to_ids(
            "<|startoftranscript|>")
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        # matches the reference's `tokenizer(text_target=...)` path which
        # includes the special prefix + eos
        return self._tok(text_target=text).input_ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special)


def load_tokenizer(name_or_path: Optional[str]) -> Tokenizer:
    """WhisperTextTokenizer when possible, ByteTokenizer otherwise."""
    if name_or_path:
        try:
            return WhisperTextTokenizer(name_or_path)
        except Exception as e:
            print(f"[tokenizer] {name_or_path} unavailable ({e}); "
                  f"falling back to ByteTokenizer")
    return ByteTokenizer()
