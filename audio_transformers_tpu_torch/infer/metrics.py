"""Evaluation metrics: the port's copy of the reference package's
`compression_ratio` (`infer/metrics.py`), the one the decode fallback
reaches."""

from __future__ import annotations


def compression_ratio(text) -> float:
    """zlib compression ratio of the text (str or raw bytes) — whisper's
    repetition-detection heuristic (the reference passes
    compression_ratio_threshold=2.4 to generate, evaluate.py:52; ratios
    above the threshold indicate the degenerate repetition visible in its
    predictions.txt)."""
    import zlib

    data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))
