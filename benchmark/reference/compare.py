"""The numbers that decide ``correct``, each from the program's readings
and the reference's, and their judgement against the cell's limits."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

#: A leaf whose reference first gradient is under this share of the
#: median leaf's is nought to rounding (a key's bias under softmax): Adam
#: moves it by round-off alone, so its change is not compared.
ROUNDING_GRAD_SHARE = 1e-3


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap, that leaf): per leaf the gap between the
    program's norm and the reference's, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    leaves = list(reference if leaves is None else leaves)
    median = statistics.median(reference[k] for k in leaves)
    worst, at = 0.0, ""
    for k in leaves:
        denom = max(reference[k], median)
        gap = abs(program[k] - reference[k]) / denom if denom > 0 else 0.0
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(reference_grad: Dict[str, float]) -> list:
    """The leaves whose change is compared (see :data:`ROUNDING_GRAD_SHARE`)."""
    median = statistics.median(reference_grad.values())
    return [k for k, g in reference_grad.items() if g >= ROUNDING_GRAD_SHARE * median]


def train_numbers(program: Dict, reference: Dict) -> Dict[str, Dict]:
    """The training cells' numbers: ``loss_rel``, the largest relative gap
    of a step's loss; ``grad_rel``, :func:`norm_gap` of the first
    gradient; ``change_rel``, :func:`norm_gap` of the change over the
    checked steps, over :func:`moving_leaves`."""
    loss_rel = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"], strict=True))
    grad_rel, grad_at = norm_gap(program["grad"], reference["grad"])
    change_rel, change_at = norm_gap(program["change"], reference["change"],
                                     moving_leaves(reference["grad"]))
    return {
        "loss_rel": {"value": loss_rel},
        "grad_rel": {"value": grad_rel, "leaf": grad_at},
        "change_rel": {"value": change_rel, "leaf": change_at},
    }


def judge(numbers: Dict[str, Dict], limits: Dict[str, float]) -> bool:
    """Set each number's limit beside it; True when every number is at or
    under its limit (a NaN is not)."""
    ok = True
    for name, entry in numbers.items():
        entry["limit"] = limits[name]
        ok = ok and entry["value"] <= limits[name]
    return ok
