"""Interleaved paired-ratio overhead measurement.

The bench's always-on-plane gates (flight recorder, decision events,
sampling profiler — each "≤ 5% overhead at 1,024 nodes") sit far below
a shared box's noise floor: CPU speed itself drifts ±15% over seconds
(steal / frequency scaling), so two monolithic A/B runs minutes apart
cannot resolve a 2% signal — that way measured ±25% *phantom*
overheads.  This module is the methodology that can, extracted from
``bench.py`` so every overhead probe shares ONE audited implementation
(the flight-recorder and decision-event probes used to duplicate it):

* the two sides interleave at **cycle granularity** — adjacent cycles
  share the box's momentary speed, so each pair's ratio is clean;
* side order is **randomized per pair** — a deterministic A/B/B/A
  pattern aliases with the collector's periodic gen-2 spikes, pinning
  +35%/-25% biases on one side;
* a full ``gc.collect()`` runs **before each pair** so no aged
  collection lands inside a timed window;
* the pair ratios aggregate by **interquartile mean** — the median's
  outlier immunity with the statistical power of the central half,
  which is what holds run-to-run spread inside a ±1% band.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Callable, List, Sequence

__all__ = ["interleaved_overhead_pct", "iq_mean"]

#: Deterministic default seed — the probes must be reproducible
#: run-to-run; vary it only to study the estimator itself.
DEFAULT_SEED = 0x5EED


def iq_mean(values: Sequence[float]) -> float:
    """Interquartile mean: the arithmetic mean of the central half of
    *values* (outer quartiles shed).  Keeps the median's outlier
    immunity while using every central sample."""
    if not values:
        raise ValueError("iq_mean needs at least one value")
    ordered = sorted(values)
    lo = len(ordered) // 4
    hi = len(ordered) - lo
    middle = ordered[lo:hi]
    return sum(middle) / len(middle)


def interleaved_overhead_pct(
    run_cycle: Callable[[], object],
    set_side: Callable[[bool], object],
    pairs: int,
    seed: int = DEFAULT_SEED,
) -> float:
    """Percent overhead of side ``True`` vs side ``False``, measured as
    the interquartile mean of per-pair wall-clock ratios with the two
    sides interleaved at cycle granularity (see module docstring for
    why the naive monolithic A/B cannot resolve a ≤5% gate).

    *run_cycle* executes one workload cycle; *set_side* flips the
    feature under test (``True`` = enabled).  The feature is left on
    side ``True`` after the last pair.  Returns e.g. ``2.7`` for a
    2.7% slowdown (negative = measured faster, i.e. noise floor).
    """
    if pairs < 1:
        raise ValueError("need at least one pair")
    rng = random.Random(seed)
    ratios: List[float] = []
    for _ in range(pairs):
        sides = (False, True) if rng.random() < 0.5 else (True, False)
        gc.collect()
        sample = {}
        for enabled in sides:
            set_side(enabled)
            t0 = time.perf_counter()
            run_cycle()
            sample[enabled] = time.perf_counter() - t0
        ratios.append(sample[True] / max(sample[False], 1e-9))
    set_side(True)
    return (iq_mean(ratios) - 1) * 100
