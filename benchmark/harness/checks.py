"""The numbers that decide `correct`, each against its limit.

Train cells compare the first three steps with the reference: each
step's loss, each leaf's first gradient norm and each leaf's change over
the three steps (gaps of norms, by the worst leaf, against the larger of
the reference's norm of that leaf and of the median leaf; leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change). Serving cells compare
the sampled rows' front-end features, encoder states, cross K/V, served
tokens (the widest gap by which a served token's logit lies below the
reference's best) and emotion probabilities.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Optional

import torch


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def worst_leaf(port: Dict[str, float], ref: Dict[str, float],
               skip=()) -> float:
    med = statistics.median(ref.values())
    return max(abs(port[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in ref if k not in skip)


def train_numbers(port: dict, ref: dict) -> Dict[str, float]:
    med = statistics.median(ref["grad_norm"].values())
    quiet = {k for k, g in ref["grad_norm"].items() if g < 1e-3 * med}
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(port["loss"], ref["loss"])),
        "grad_gap": worst_leaf(port["grad_norm"], ref["grad_norm"]),
        "change_gap": worst_leaf(port["change"], ref["change"], quiet),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    finite and at or under its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit: Optional[float] = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value == value or value > limit:
            ok = False
    return ok and bool(numbers), checks


def print_checks(checks: Dict[str, dict]) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
