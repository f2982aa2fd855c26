"""Bounded in-process metrics-history ring.

The SLO engine (:mod:`.slo`) publishes burn rates, straggler counts and
the ETA as *instantaneous* gauges — good for dashboards, useless for a
gate: one noisy reconcile must not advance or abort a rollout.  This
module retains windowed samples of those gauges so the analysis engine
(:mod:`..upgrade.analysis`) can ask the question a gate actually needs
answered — "has this condition held **continuously** for N seconds?" —
over real observations instead of a single point.

Bounded two ways (per series): ``max_samples`` caps memory and
``retention_seconds`` ages samples out, so a week-long rollout costs
the same as an hour-long one.  The ring is also a debug surface:
``OpsServer GET /debug/slo?history=1`` serves :meth:`snapshot`.

Thread contract: ``record`` is called by the reconcile loop; readers
(``holds``/``window``/``snapshot``) may run on the ops-server thread —
everything locks, and snapshots copy out.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: Default per-series sample cap (a 5 s reconcile cadence retains ~3 h).
DEFAULT_MAX_SAMPLES = 2048
#: Default age bound (seconds) — matches the pacing/remediation windows.
DEFAULT_RETENTION_SECONDS = 3600.0

#: A series is STALE (never holds) once its last recording lags the
#: ring's global record counter by more than this many generations.
#: Two independent recorders feed the ring per reconcile (the SLO
#: engine's sample set + the analysis engine's queue/scale set), so 4
#: generations ≈ two full reconciles of slack — tolerant of one skipped
#: recording, far tighter than the 1 h retention bound.
STALE_GENERATIONS = 4

#: Comparison vocabulary shared with the analysis condition grammar.
OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


class MetricsHistory:
    """Per-series ring of ``(unix_ts, value)`` samples."""

    def __init__(
        self,
        max_samples: int = DEFAULT_MAX_SAMPLES,
        retention_seconds: float = DEFAULT_RETENTION_SECONDS,
    ) -> None:
        if max_samples < 1:
            raise ValueError("history needs max_samples >= 1")
        if retention_seconds <= 0:
            raise ValueError("history needs retention_seconds > 0")
        self.max_samples = max_samples
        self.retention_seconds = retention_seconds
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}  #: guarded-by: _lock
        #: Series whose source stopped reporting get pruned wholesale
        #: once every sample ages out (see :meth:`record`).
        self._last_seen: Dict[str, float] = {}  #: guarded-by: _lock
        #: Global record generation + per-series generation stamps: the
        #: cadence-independent staleness oracle.  A series whose stamp
        #: lags the global counter by more than STALE_GENERATIONS never
        #: ``holds`` — its source stopped reporting (e.g. an SLO removed
        #: from the block mid-rollout), and a frozen newest sample must
        #: not keep satisfying (or keep breaching) a sustained condition
        #: for the rest of the retention window.
        self._gen = 0  #: guarded-by: _lock
        self._series_gen: Dict[str, int] = {}  #: guarded-by: _lock

    # -------------------------------------------------------------- feeding
    def record(
        self, samples: Dict[str, float], now: Optional[float] = None
    ) -> None:
        """Append one observation per series; ages out stale samples and
        retires series that stopped reporting entirely (a removed SLO's
        burn series must not answer ``holds`` from beyond the grave)."""
        now = time.time() if now is None else now
        floor = now - self.retention_seconds
        with self._lock:
            self._gen += 1
            for name, value in samples.items():
                series = self._series.get(name)
                if series is None:
                    series = self._series[name] = deque(
                        maxlen=self.max_samples
                    )
                series.append((now, float(value)))
                self._last_seen[name] = now
                self._series_gen[name] = self._gen
                while series and series[0][0] < floor:
                    series.popleft()
            for name in [
                n for n, seen in self._last_seen.items() if seen < floor
            ]:
                self._series.pop(name, None)
                self._last_seen.pop(name, None)
                self._series_gen.pop(name, None)

    def _stale_locked(self, name: str) -> bool:
        return (
            self._gen - self._series_gen.get(name, self._gen)
            > STALE_GENERATIONS
        )

    # -------------------------------------------------------------- queries
    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            series = self._series.get(name)
            return series[-1] if series else None

    def window(
        self, name: str, seconds: float, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        """Samples of *name* inside the trailing window, oldest first."""
        now = time.time() if now is None else now
        floor = now - seconds
        with self._lock:
            series = self._series.get(name)
            if not series:
                return []
            return [(ts, v) for ts, v in series if ts >= floor]

    def holds(
        self,
        name: str,
        op: str,
        threshold: float,
        for_seconds: float = 0.0,
        now: Optional[float] = None,
    ) -> bool:
        """True when the newest sample satisfies ``value <op> threshold``
        AND the satisfying streak has covered at least *for_seconds* of
        wall clock (the streak's oldest sample is that old).  A series
        with no samples never holds — unobserved is not healthy — and
        neither does a STALE one (source stopped recording for more
        than :data:`STALE_GENERATIONS` record cycles): a frozen newest
        sample must not keep answering from beyond the grave."""
        compare = OPS.get(op)
        if compare is None:
            raise ValueError(f"unknown condition op {op!r}")
        now = time.time() if now is None else now
        with self._lock:
            series = self._series.get(name)
            if (
                not series
                or self._stale_locked(name)
                or not compare(series[-1][1], threshold)
            ):
                return False
            if for_seconds <= 0:
                return True
            streak_start = None
            for ts, value in reversed(series):
                if not compare(value, threshold):
                    break
                streak_start = ts
            return (
                streak_start is not None
                and now - streak_start >= for_seconds
            )

    def held_seconds(
        self,
        name: str,
        op: str,
        threshold: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """How long the condition's current satisfying streak has run
        (0.0 = newest sample satisfies but is the streak's start), or
        None when the newest sample does not satisfy / no samples."""
        compare = OPS.get(op)
        if compare is None:
            raise ValueError(f"unknown condition op {op!r}")
        now = time.time() if now is None else now
        with self._lock:
            series = self._series.get(name)
            if (
                not series
                or self._stale_locked(name)
                or not compare(series[-1][1], threshold)
            ):
                return None
            streak_start = series[-1][0]
            for ts, value in reversed(series):
                if not compare(value, threshold):
                    break
                streak_start = ts
            return max(0.0, now - streak_start)

    def snapshot(self, window_seconds: Optional[float] = None) -> dict:
        """The ``/debug/slo?history=1`` payload: every retained series
        (optionally window-scoped), timestamps rounded for the wire."""
        now = time.time()
        floor = (
            now - window_seconds if window_seconds is not None else float("-inf")
        )
        with self._lock:
            series = {
                name: [
                    [round(ts, 3), round(v, 6)]
                    for ts, v in samples
                    if ts >= floor
                ]
                for name, samples in sorted(self._series.items())
            }
        return {
            "retentionSeconds": self.retention_seconds,
            "maxSamplesPerSeries": self.max_samples,
            "series": series,
        }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._last_seen.clear()
            self._series_gen.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)
