"""Evaluation metrics: the port's copies of the reference package's
`infer/metrics.py`: accuracy, weighted F1 and the text of scikit-learn's
`classification_report`, computed here in numpy (the port does not depend
on scikit-learn) with scikit-learn's arithmetic and format; the corpus
word error rate; and the zlib compression ratio the decode fallback
reaches.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np


def _per_class(y_true: np.ndarray, y_pred: np.ndarray, labels: Sequence[int]):
    """(precision, recall, f1, support) per label, float64 (support int),
    as sklearn's precision_recall_fscore_support(average=None,
    zero_division=0): a ratio whose denominator is 0 is 0."""
    lab = np.asarray(labels)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in lab])
    pred = np.array([np.sum(y_pred == c) for c in lab])
    true = np.array([np.sum(y_true == c) for c in lab])

    def divide(num, den):
        den = np.asarray(den, dtype=np.float64)
        mask = den == 0
        out = np.asarray(num, dtype=np.float64) / np.where(mask, 1.0, den)
        out[mask] = 0.0
        return out

    if not tp.any():
        # sklearn's counts are float zeros when no sample is right, and its
        # support column then prints as floats
        true = true.astype(np.float64)
    precision = divide(tp, pred)
    recall = divide(tp, true)
    # (1 + beta^2) tp / ((1 + beta^2) tp + beta^2 fn + fp), beta = 1
    f1 = divide(2.0 * tp.astype(np.float64),
                1.0 * true.astype(np.float64) + pred.astype(np.float64))
    return precision, recall, f1, true


def _report(names: List[str], p, r, f1, s, accuracy: float,
            digits: int = 3) -> str:
    """sklearn's classification_report text for single-label targets,
    every label given (its "accuracy" line stands for the micro avg)."""
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format(
        "", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    acc_fmt = ("{:>{width}s} " + " {:>9.{digits}}" * 2
               + " {:>9.{digits}f}" + " {:>9}\n")
    report += acc_fmt.format("accuracy", "", "", accuracy, np.sum(s),
                             width=width, digits=digits)
    for name, weights in (("macro avg", None), ("weighted avg", s)):
        report += row_fmt.format(
            name, *(float(np.average(x, weights=weights)) for x in (p, r, f1)),
            np.sum(s), width=width, digits=digits)
    return report


def classification_metrics(y_true: Sequence[int], y_pred: Sequence[int],
                           idx_to_name: Dict[int, str]) -> dict:
    """{"samples", "accuracy", "weighted_f1", "report"} as the reference
    computes them with sklearn (accuracy_score, f1_score(average=
    "weighted", zero_division=0), classification_report(labels=present,
    digits=3, zero_division=0)), present being the labels of y_true and
    y_pred together."""
    if not len(y_true):
        return {"samples": 0, "accuracy": 0.0, "weighted_f1": 0.0,
                "report": "No predictions available."}
    yt, yp = np.asarray(y_true), np.asarray(y_pred)
    present = sorted(set(list(y_true) + list(y_pred)))
    p, r, f1, s = _per_class(yt, yp, present)
    accuracy = float(np.average(yt == yp))
    names = [idx_to_name.get(i, f"Unknown_{i}") for i in present]
    return {
        "samples": len(y_true),
        "accuracy": accuracy,
        "weighted_f1": float(np.average(f1, weights=s)),
        "report": _report(names, p, r, f1, s, accuracy),
    }


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


def _normalize_text(s: str) -> List[str]:
    s = s.lower()
    s = re.sub(r"[^\w\s']", " ", s)
    return s.split()


def word_error_rate(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus WER: total edit distance / total reference words."""
    total_err = total_words = 0
    for ref, hyp in zip(refs, hyps):
        r, h = _normalize_text(ref), _normalize_text(hyp)
        total_words += len(r)
        total_err += _edit_distance(r, h)
    return total_err / max(total_words, 1)


def _edit_distance(a: List[str], b: List[str]) -> int:
    prev = np.arange(len(b) + 1)
    for i, wa in enumerate(a, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        for j, wb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (wa != wb))
        prev = cur
    return int(prev[-1])
