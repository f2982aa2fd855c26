"""Continuous sampling profiler: *where the time goes*, always on.

The other observability planes answer *what* happened (tracing), *how
healthy* the rollout is (SLO engine) and *why a decision* was made
(events/explain).  This module answers the remaining question — which
**frames** the wall clock is actually spent in — without a debugger,
without cProfile's per-call tracing cost, and without restarting the
operator.  Every perf finding this repo records today lives in code
comments written after one-off profiling sessions
(``cluster/writepipeline.py`` "profiled ~300 µs/call",
``node_upgrade_state_provider.py`` "profiled as the top HTTP-path
cost"); the profiling plane makes those measurements a continuously
observed, regression-gated signal instead.

Design constraints, in order:

* **always-on cheap**: one daemon sampler thread walks
  ``sys._current_frames()`` at a configurable rate (default 67 Hz); the
  sampled threads pay NOTHING — no tracing hooks, no sys.settrace.  The
  cost is the sampler's own stack walk, measured by the profiler itself
  and published as ``profile_overhead`` (fraction of one core; the
  bench gates ``profile_overhead_pct_1024n`` ≤ 5%).
* **bounded**: samples fold into fixed-duration :class:`ProfileWindow`
  rings (default 15 s × 8 windows ≈ the last two minutes), each window
  capped at *max_stacks* distinct folded stacks (excess counted in
  ``dropped_stacks``, never an error).
* **span-attributed**: via a lightweight observer hook in
  :mod:`.tracing` (:func:`tracing.set_span_observer`) the profiler
  keeps a per-thread stack of ACTIVE spans, so every sample lands as
  **self-time** of the innermost span and **child-time** of its
  ancestors — "BuildState is slow" decomposes into named frames AND the
  span tree agrees about whose time it was.  Spans carried across
  threads by ``traceparent`` attribute to the thread actually running
  them, exactly like the tracer records them.

Formats: :func:`to_collapsed` (Brendan-Gregg collapsed stacks —
``flamegraph.pl`` / speedscope both import it), :func:`to_speedscope`
(https://speedscope.app JSON), and :func:`diff_collapsed` (top
regressing frames between two dumps — the differential-bench
workflow).  Optional allocation view: :func:`heap_snapshot` serves
tracemalloc's top allocation sites when tracing is on (the operator
opts in with ``PYTHONTRACEMALLOC`` or ``tracemalloc.start()``; the
sampler never starts it — 2-4× allocation slowdown is an application
decision).

Surfaces: ``OpsServer GET /debug/profile`` (continuous ring +
on-demand ``?seconds=`` windows), the ``profile`` CLI subcommand
(live capture, offline rendering, ``profile diff A B``), and
``bench.py``'s differential A/B profiles.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .. import metrics as metrics_mod
from . import tracing as tracing_mod

__all__ = [
    "ProfileWindow",
    "SamplingProfiler",
    "default_profiler",
    "diff_collapsed",
    "heap_snapshot",
    "merged_span_frames",
    "merged_span_times",
    "merged_stacks",
    "parse_collapsed",
    "render_report",
    "selftest",
    "set_default_profiler",
    "snapshot_from_payload",
    "to_collapsed",
    "to_speedscope",
    "top_self_frames",
    "top_span_frames",
]

#: Default sampling rate.  67 Hz resolves ~15 ms of self-time per
#: window at the default 15 s window (1,000 samples) while keeping the
#: sampler's own cost well under the 5% overhead gate; a deliberately
#: off-round rate so the sampler cannot phase-lock with 10/50/100 Hz
#: periodic work and alias it in or out of the profile.
DEFAULT_HZ = 67.0
#: Default window length — long enough that a reconcile-scale burst
#: (hundreds of ms) is statistically visible, short enough that "the
#: last window" answers "what is it doing NOW".
DEFAULT_WINDOW_SECONDS = 15.0
#: Completed windows retained (oldest evicted): 8 × 15 s ≈ the last
#: two minutes of history at the defaults.
DEFAULT_CAPACITY = 8
#: Frames walked per sampled thread — beyond this depth the stack is
#: truncated at the ROOT end (the leaf frames are what self-time
#: attribution needs).
DEFAULT_MAX_DEPTH = 64
#: Distinct folded stacks retained per window; samples landing in a
#: NEW stack past the cap are dropped from the stack map and counted
#: in ``dropped_stacks`` (``samples`` still counts them, so a window
#: where the two disagree is itself the high-cardinality signal).
DEFAULT_MAX_STACKS = 4096


#: code object -> its collapsed label, computed once ever: basename +
#: string formatting per frame per thread per tick was the sampler's
#: dominant cost (~10% of a core at fleet scale; cached it is a dict
#: hit).  Keyed by the code object itself — keeps it alive, which is
#: bounded by the process's distinct code objects and is what makes the
#: cache safe (an id() key could be reused after a GC).
_label_cache: Dict[Any, str] = {}


def _frame_label(frame) -> str:
    """One collapsed-format frame label: ``module.function`` with the
    module derived from the code object's file basename — stable across
    hosts/venvs (absolute paths are not) and short enough to survive
    the bench compact tail's string budget."""
    code = frame.f_code
    label = _label_cache.get(code)
    if label is None:
        base = os.path.basename(code.co_filename)
        if base.endswith(".py"):
            base = base[:-3]
        label = f"{base}.{code.co_name}"
        _label_cache[code] = label
    return label


#: Leaf frames naming a generic parking primitive rather than a
#: workload site: a wall-clock sampler lands in these constantly
#: (visibility waits, worker joins, socket reads), and an unqualified
#: "threading.wait 91%" answers nothing.  Self-time LABELS qualify them
#: with their caller — ``cache.wait_for_update>wait`` says which wait;
#: the folded stacks themselves are untouched.
GENERIC_WAIT_LEAVES = {
    "threading.wait": "wait",
    "threading._wait_for_tstate_lock": "join",
    "selectors.select": "select",
    "selectors.poll": "select",
    "socket.readinto": "recv",
    "socket.accept": "accept",
}


def _qualify_leaf(leaf: str, caller: Optional[str]) -> str:
    short = GENERIC_WAIT_LEAVES.get(leaf)
    if short is None or caller is None:
        return leaf
    return f"{caller}>{short}"


class ProfileWindow:
    """One fixed-duration accumulation of folded stack samples plus the
    per-span-kind self/total sample attribution."""

    __slots__ = (
        "started_unix", "ended_unix", "samples", "stacks", "span_self",
        "span_total", "span_frames", "dropped_stacks", "threads",
    )

    def __init__(self, now: Optional[float] = None) -> None:
        self.started_unix = time.time() if now is None else now
        self.ended_unix: Optional[float] = None
        #: total samples folded into this window (one per thread per tick)
        self.samples = 0
        #: folded stack (``root;...;leaf``) -> sample count
        self.stacks: Dict[str, int] = {}
        #: span kind -> samples taken while it was the INNERMOST span
        self.span_self: Dict[str, int] = {}
        #: span kind -> samples taken while it was ANYWHERE on the
        #: active-span stack (self + descendants; ``total - self`` is
        #: the child-time)
        self.span_total: Dict[str, int] = {}
        #: span kind -> leaf frame -> samples: the NAMED-FRAME
        #: decomposition of each span's self-time ("BuildState is slow"
        #: becomes "BuildState spends 60% in inmem.json_copy")
        self.span_frames: Dict[str, Dict[str, int]] = {}
        self.dropped_stacks = 0
        #: peak threads sampled in one tick
        self.threads = 0

    def to_dict(self) -> dict:
        return {
            "started_unix": self.started_unix,
            "ended_unix": self.ended_unix,
            "samples": self.samples,
            "threads": self.threads,
            "dropped_stacks": self.dropped_stacks,
            "stacks": dict(self.stacks),
            "span_self": dict(self.span_self),
            "span_total": dict(self.span_total),
            "span_frames": {
                name: dict(frames)
                for name, frames in self.span_frames.items()
            },
        }


class SamplingProfiler:
    """Wall-clock sampling profiler over ``sys._current_frames()``.

    ``install()`` wires the span observer into :mod:`.tracing` so
    samples attribute to the active span; ``start()`` launches the
    sampler thread.  Both are idempotent and reversible
    (``uninstall()`` / ``stop()``).  The profiler is safe to leave
    running for the life of the process — that is the point.
    """

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        window_seconds: float = DEFAULT_WINDOW_SECONDS,
        capacity: int = DEFAULT_CAPACITY,
        max_depth: int = DEFAULT_MAX_DEPTH,
        max_stacks: int = DEFAULT_MAX_STACKS,
        registry: Optional[metrics_mod.MetricsRegistry] = None,
    ) -> None:
        if hz <= 0:
            raise ValueError("sampling rate must be > 0 Hz")
        if window_seconds <= 0:
            raise ValueError("window_seconds must be > 0")
        if capacity < 1:
            raise ValueError("profiler capacity must be >= 1")
        self.hz = float(hz)
        self.window_seconds = float(window_seconds)
        self.max_depth = int(max_depth)
        self.max_stacks = int(max_stacks)
        #: Pause switch (the FlightRecorder/DecisionEventLog pattern):
        #: with ``enabled=False`` the sampler thread keeps its cadence
        #: but each tick is one bool check — how the bench's
        #: interleaved overhead probe flips sides WITHOUT per-pair
        #: thread churn (a start/stop per timed cycle bills the thread
        #: spawn's allocations to the "on" side and read ~10% for a
        #: real ~1%).
        self.enabled = True
        self._lock = threading.Lock()
        self._current: Optional[ProfileWindow] = None
        self._ring: "deque[ProfileWindow]" = deque(maxlen=capacity)
        #: extra accumulation targets for in-flight on-demand captures
        self._captures: List[ProfileWindow] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # lifecycle guard: two concurrent capture() calls on a stopped
        # profiler must not both pass the running check and spawn two
        # sampler threads (one would be orphaned and double-count every
        # window forever).  RLock: capture() starts under the guard.
        self._life_lock = threading.RLock()
        #: the sampler was started BY capture() (not the embedder) and
        #: this many captures are still riding it — the last one out
        #: stops it; an embedder start() while temp-running adopts it.
        self._temp_started = False
        self._temp_holds = 0
        #: per-thread-ident stacks of ACTIVE spans (innermost last),
        #: maintained by the tracing observer hook
        self._span_stacks: Dict[int, List[Any]] = {}
        self._span_lock = threading.Lock()
        #: cumulative samples taken / sampler-thread seconds spent
        #: sampling (the overhead numerator; wall time is the
        #: denominator)
        self.samples_total = 0
        self.sampling_seconds = 0.0
        self._started_mono: Optional[float] = None
        #: wall seconds accumulated over PREVIOUS runs — overhead must
        #: stay sampler-lifetime cost / sampler-lifetime wall, or every
        #: stop/start cycle (each ?seconds= capture on a stopped
        #: profiler is one) would divide the cumulative numerator by
        #: only the latest run's elapsed and inflate the gauge N-fold
        self._elapsed_accum = 0.0
        #: overhead as a fraction of ONE core's wall clock —
        #: sampling_seconds / elapsed (also published to the
        #: ``profile_overhead`` gauge)
        self.overhead = 0.0
        # metric handles bound once (the write-pipeline pattern): the
        # sampler tick must not take the registry's create-or-get lock
        reg = registry
        if reg is None:
            self._m_samples = metrics_mod.profiler_samples_counter()
            self._m_overhead = metrics_mod.profile_overhead_gauge()
        else:
            prev = metrics_mod.set_default_registry(reg)
            try:
                self._m_samples = metrics_mod.profiler_samples_counter()
                self._m_overhead = metrics_mod.profile_overhead_gauge()
            finally:
                metrics_mod.set_default_registry(prev)

    # ----------------------------------------------------- span observer
    def span_started(self, span) -> None:
        ident = threading.get_ident()
        # remembered on the span: it may END on a different thread (a
        # generator hopping executors) and the pop must find its stack
        span._profiling_ident = ident
        with self._span_lock:
            self._span_stacks.setdefault(ident, []).append(span)

    def span_ended(self, span) -> None:
        ident = getattr(span, "_profiling_ident", None)
        if ident is None:
            return  # started before install(); nothing to pop
        with self._span_lock:
            stack = self._span_stacks.get(ident)
            if not stack:
                return
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is span:
                    del stack[i]
                    break
            if not stack:
                self._span_stacks.pop(ident, None)

    def install(self) -> "SamplingProfiler":
        """Wire the span observer into :mod:`.tracing` (idempotent).
        Clears the span-stack registry: entries surviving a previous
        uninstall belong to spans whose ``span_ended`` was never
        delivered — left in place they would mis-attribute every later
        sample on their thread to a long-dead span."""
        if tracing_mod.span_observer() is not self:
            with self._span_lock:
                self._span_stacks.clear()
        tracing_mod.set_span_observer(self)
        return self

    def uninstall(self) -> None:
        """Remove the span observer if it is THIS profiler's, dropping
        the span-stack registry (spans still open will end unobserved —
        their pop is tolerant — and stale entries must not leak into a
        later install)."""
        if tracing_mod.span_observer() is self:
            tracing_mod.set_span_observer(None)
        with self._span_lock:
            self._span_stacks.clear()

    # ------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        with self._life_lock:
            if self.running:
                # an embedder start while a capture() temp-run is live
                # ADOPTS the sampler: captures no longer stop it
                self._temp_started = False
                return self
            self._stop.clear()
            self._started_mono = time.monotonic()
            with self._lock:
                if self._current is None:
                    self._current = ProfileWindow()
            self._thread = threading.Thread(
                target=self._run, name="sampling-profiler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        with self._life_lock:
            thread = self._thread
            if thread is None:
                return
            self._stop.set()
            thread.join(timeout)
            self._thread = None
            if self._started_mono is not None:
                self._elapsed_accum += time.monotonic() - self._started_mono
                self._started_mono = None
            with self._lock:
                self._rotate_locked()

    # ------------------------------------------------------------- sampling
    def _run(self) -> None:
        interval = 1.0 / self.hz
        own_ident = threading.get_ident()
        next_tick = time.monotonic()
        while not self._stop.is_set():
            next_tick += interval
            t0 = time.monotonic()
            if self.enabled:
                self._sample_once(own_ident, t0)
            spent = time.monotonic() - t0
            self.sampling_seconds += spent
            # lifetime cost over lifetime wall (prior runs included) —
            # a per-run denominator would inflate N-fold over N
            # stop/start cycles while the numerator stays cumulative
            #: lockcheck: unguarded(benign racy read feeding the overhead gauge; taking _life_lock here would convoy against stop()'s held-lock join for its full timeout)
            elapsed = self._elapsed_accum + (
                #: lockcheck: unguarded(same racy-gauge read as the line above)
                time.monotonic() - (self._started_mono or t0)
            )
            if elapsed > 0:
                self.overhead = self.sampling_seconds / elapsed
                self._m_overhead.set(self.overhead)
            # absolute schedule (not sleep(interval)): the sample cost
            # must not stretch the period, or heavy samples would
            # UNDER-sample exactly the moments that matter
            delay = next_tick - time.monotonic()
            if delay <= 0:
                next_tick = time.monotonic()
                continue
            if self._stop.wait(delay):
                break

    def _sample_once(self, own_ident: int, now_mono: float) -> None:
        frames = sys._current_frames()
        with self._span_lock:
            span_names: Dict[int, List[str]] = {
                ident: [s.name for s in stack]
                for ident, stack in self._span_stacks.items()
                if stack
            }
        folded: List[Tuple[str, str, Optional[List[str]]]] = []
        for ident, frame in frames.items():
            if ident == own_ident:
                continue
            parts: List[str] = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                parts.append(_frame_label(frame))
                frame = frame.f_back
                depth += 1
            if not parts:
                continue
            leaf = _qualify_leaf(
                parts[0], parts[1] if len(parts) > 1 else None
            )
            parts.reverse()  # collapsed format runs root -> leaf
            folded.append((";".join(parts), leaf, span_names.get(ident)))
        del frames  # drop the frame references promptly
        taken = len(folded)
        if taken == 0:
            return
        self.samples_total += taken
        self._m_samples.inc(amount=taken)
        with self._lock:
            window = self._current
            if window is None:
                window = self._current = ProfileWindow()
            targets = [window] + self._captures
            for target in targets:
                target.samples += taken
                target.threads = max(target.threads, taken)
                for stack, leaf, names in folded:
                    if (
                        stack not in target.stacks
                        and len(target.stacks) >= self.max_stacks
                    ):
                        target.dropped_stacks += 1
                    else:
                        target.stacks[stack] = target.stacks.get(stack, 0) + 1
                    if not names:
                        continue
                    innermost = names[-1]
                    target.span_self[innermost] = (
                        target.span_self.get(innermost, 0) + 1
                    )
                    frames_for = target.span_frames.setdefault(innermost, {})
                    frames_for[leaf] = frames_for.get(leaf, 0) + 1
                    for name in set(names):
                        target.span_total[name] = (
                            target.span_total.get(name, 0) + 1
                        )
            if (
                time.time() - window.started_unix >= self.window_seconds
            ):
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        window = self._current
        if window is not None and window.samples > 0:
            window.ended_unix = time.time()
            self._ring.append(window)
        self._current = ProfileWindow() if self.running else None

    # ------------------------------------------------------------ snapshots
    def snapshot(self, windows: Optional[int] = None) -> dict:
        """The continuous ring (+ the in-progress window) as one
        serializable payload; *windows* keeps only the newest N."""
        with self._lock:
            out = [w.to_dict() for w in self._ring]
            if self._current is not None and self._current.samples:
                out.append(self._current.to_dict())
        if windows is not None and windows > 0:
            out = out[-windows:]
        return {
            "running": self.running,
            "hz": self.hz,
            "window_seconds": self.window_seconds,
            "samples_total": self.samples_total,
            "overhead": round(self.overhead, 6),
            "windows": out,
        }

    def capture(self, seconds: float) -> dict:
        """Block for *seconds* and return a dict for JUST that interval
        (an on-demand window, independent of the ring's rotation).  If
        the sampler is not running it is started for the duration —
        the CLI's live-capture path against a cold profiler; concurrent
        captures hold a shared temp-start (the LAST one out stops the
        sampler, so an overlapping longer capture never loses its tail
        to a shorter one's cleanup)."""
        seconds = max(0.05, float(seconds))
        holding = False
        with self._life_lock:
            if not self.running:
                self._temp_started = True
                self.start()
            if self._temp_started:
                self._temp_holds += 1
                holding = True
        window = ProfileWindow()
        with self._lock:
            self._captures.append(window)
        try:
            time.sleep(seconds)
        finally:
            with self._lock:
                self._captures.remove(window)
            if holding:
                with self._life_lock:
                    self._temp_holds -= 1
                    if self._temp_started and self._temp_holds == 0:
                        self._temp_started = False
                        # stop WHILE holding the lock (RLock — stop()
                        # re-acquires it): released first, an embedder
                        # start() could adopt the sampler between the
                        # decision and the stop, and this deferred stop
                        # would kill the adopted sampler — a profiler
                        # that believes it is running but never samples
                        self.stop()
        window.ended_unix = time.time()
        return {
            "running": True,
            "hz": self.hz,
            "window_seconds": seconds,
            "samples_total": self.samples_total,
            "overhead": round(self.overhead, 6),
            "windows": [window.to_dict()],
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._current = ProfileWindow() if self.running else None


# ------------------------------------------------------------ process default
_default_profiler = SamplingProfiler()
_default_lock = threading.Lock()


def default_profiler() -> SamplingProfiler:
    """The process-wide profiler ``/debug/profile`` serves (not started
    by import — embedders opt in, like the GC profile)."""
    with _default_lock:
        return _default_profiler


def set_default_profiler(profiler: SamplingProfiler) -> SamplingProfiler:
    """Swap the process-default profiler (tests); returns the previous."""
    global _default_profiler
    with _default_lock:
        previous = _default_profiler
        _default_profiler = profiler
        return previous


# ------------------------------------------------------------------ exporters
def _iter_windows(payload) -> Iterable[dict]:
    if isinstance(payload, dict):
        return payload.get("windows") or ()
    return payload or ()


def merged_stacks(payload) -> Dict[str, int]:
    """All windows' folded stacks merged into one counter."""
    merged: Dict[str, int] = {}
    for window in _iter_windows(payload):
        for stack, count in (window.get("stacks") or {}).items():
            merged[stack] = merged.get(stack, 0) + int(count)
    return merged


def merged_span_times(payload) -> Dict[str, Dict[str, int]]:
    """Per-span-kind ``{"self": n, "total": n}`` merged over windows."""
    out: Dict[str, Dict[str, int]] = {}
    for window in _iter_windows(payload):
        for name, count in (window.get("span_self") or {}).items():
            out.setdefault(name, {"self": 0, "total": 0})["self"] += int(count)
        for name, count in (window.get("span_total") or {}).items():
            out.setdefault(name, {"self": 0, "total": 0})["total"] += int(count)
    return out


def merged_span_frames(payload) -> Dict[str, Dict[str, int]]:
    """Per-span-kind leaf-frame self-time counts merged over windows —
    the named-frame decomposition of each span's self-time."""
    out: Dict[str, Dict[str, int]] = {}
    for window in _iter_windows(payload):
        for name, frames in (window.get("span_frames") or {}).items():
            merged = out.setdefault(name, {})
            for leaf, count in frames.items():
                merged[leaf] = merged.get(leaf, 0) + int(count)
    return out


def to_collapsed(payload) -> str:
    """Brendan-Gregg collapsed-stack text (``stack count`` lines,
    deterministic order) — flamegraph.pl / speedscope both import it,
    and :func:`diff_collapsed` compares two of them."""
    merged = merged_stacks(payload)
    return "\n".join(
        f"{stack} {count}"
        for stack, count in sorted(merged.items())
    ) + ("\n" if merged else "")


def parse_collapsed(text: str) -> Dict[str, int]:
    """Inverse of :func:`to_collapsed`; tolerant of blank lines.
    Raises ``ValueError`` when a non-blank line has no trailing count
    (the clean "not a collapsed dump" error the CLI needs)."""
    counts: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, raw = line.rpartition(" ")
        if not stack or not raw.isdigit():
            raise ValueError(f"not a collapsed stack line: {line[:80]!r}")
        counts[stack] = counts.get(stack, 0) + int(raw)
    return counts


def to_speedscope(payload, name: str = "k8s-operator-libs-tpu") -> dict:
    """https://speedscope.app file format: one sampled profile over the
    merged windows (each folded stack becomes ``count`` identical
    samples with unit weight — the viewer's left-heavy ordering then
    matches the sample distribution)."""
    merged = merged_stacks(payload)
    frame_index: Dict[str, int] = {}
    frames: List[dict] = []
    samples: List[List[int]] = []
    weights: List[int] = []
    for stack, count in sorted(merged.items()):
        indexed = []
        for label in stack.split(";"):
            i = frame_index.get(label)
            if i is None:
                i = frame_index[label] = len(frames)
                frames.append({"name": label})
            indexed.append(i)
        samples.append(indexed)
        weights.append(int(count))
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": name,
                "unit": "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        ],
        "name": name,
        "activeProfileIndex": 0,
        "exporter": "k8s_operator_libs_tpu_torch.obs.profiling",
    }


def snapshot_from_payload(payload: dict) -> dict:
    """Normalize any of the dump shapes this plane emits back to the
    native snapshot dict: native (``{"windows": [...]}``), speedscope,
    or raw collapsed text already parsed into ``{"collapsed": str}``.
    Raises ``ValueError`` on an unrecognized payload."""
    if not isinstance(payload, dict):
        raise ValueError("profile payload must be a JSON object")
    if isinstance(payload.get("windows"), list):
        for window in payload["windows"]:
            if not isinstance(window, dict) or not isinstance(
                window.get("stacks"), dict
            ):
                raise ValueError(
                    "native profile windows must be objects with a stacks map"
                )
        return payload
    if "$schema" in payload and payload.get("profiles"):
        frames = [
            f.get("name", "?")
            for f in (payload.get("shared") or {}).get("frames") or ()
        ]
        stacks: Dict[str, int] = {}
        prof = payload["profiles"][0]
        for sample, weight in zip(
            prof.get("samples") or (), prof.get("weights") or ()
        ):
            key = ";".join(frames[i] for i in sample)
            stacks[key] = stacks.get(key, 0) + int(weight)
        return {
            "running": False,
            "windows": [
                {
                    "started_unix": 0.0,
                    "samples": sum(stacks.values()),
                    "stacks": stacks,
                    "span_self": {},
                    "span_total": {},
                }
            ],
        }
    raise ValueError(
        "unrecognized profile payload (expected windows / speedscope)"
    )


# --------------------------------------------------------------------- diffing
def self_frame_counts(stacks: Dict[str, int]) -> Dict[str, int]:
    """Leaf-frame (self-time) sample counts from folded stacks, with
    generic wait leaves qualified by their caller (see
    :data:`GENERIC_WAIT_LEAVES`)."""
    out: Dict[str, int] = {}
    for stack, count in stacks.items():
        head, _, leaf = stack.rpartition(";")
        caller = head.rpartition(";")[2] or None
        label = _qualify_leaf(leaf, caller)
        out[label] = out.get(label, 0) + int(count)
    return out


def top_self_frames(payload, n: int = 5) -> List[Tuple[str, float]]:
    """``(frame, share)`` of the top-*n* self-time frames (share of all
    samples, 0..1), hottest first."""
    selfs = self_frame_counts(merged_stacks(payload))
    total = sum(selfs.values())
    if total == 0:
        return []
    ranked = sorted(selfs.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(frame, count / total) for frame, count in ranked[:n]]


def top_span_frames(payload, n: int = 5) -> List[Tuple[str, float]]:
    """``(frame, share)`` of the top-*n* leaf frames among samples
    attributed to ACTIVE spans, aggregated over span kinds.  A
    wall-clock sampler sees every parked pool worker
    (``threading.wait`` forever); restricting to span-attributed
    samples ranks the frames of threads actually doing rollout work —
    the bench's differential tail uses this, falling back to the
    unattributed ranking when the workload carries no spans."""
    merged: Dict[str, int] = {}
    for frames in merged_span_frames(payload).values():
        for leaf, count in frames.items():
            merged[leaf] = merged.get(leaf, 0) + int(count)
    total = sum(merged.values())
    if total == 0:
        return top_self_frames(payload, n=n)
    ranked = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(frame, count / total) for frame, count in ranked[:n]]


def diff_collapsed(
    old: Dict[str, int], new: Dict[str, int], top: int = 10
) -> List[dict]:
    """Top regressing frames between two collapsed dumps: each frame's
    SELF-time share in *new* minus its share in *old* (shares, not raw
    counts — the two dumps rarely hold the same number of samples),
    sorted by regression.  Entries carry ``frame`` / ``old_pct`` /
    ``new_pct`` / ``delta_pct`` (percent points, + = slower in new)."""
    old_self = self_frame_counts(old)
    new_self = self_frame_counts(new)
    old_total = sum(old_self.values()) or 1
    new_total = sum(new_self.values()) or 1
    deltas = []
    for frame in set(old_self) | set(new_self):
        old_pct = 100.0 * old_self.get(frame, 0) / old_total
        new_pct = 100.0 * new_self.get(frame, 0) / new_total
        deltas.append(
            {
                "frame": frame,
                "old_pct": round(old_pct, 2),
                "new_pct": round(new_pct, 2),
                "delta_pct": round(new_pct - old_pct, 2),
            }
        )
    deltas.sort(key=lambda d: (-d["delta_pct"], d["frame"]))
    return deltas[:top]


# ----------------------------------------------------------------- heap view
def heap_snapshot(top: int = 20) -> dict:
    """Top allocation sites from :mod:`tracemalloc`, when the embedder
    has tracing on (``PYTHONTRACEMALLOC=1`` / ``tracemalloc.start()``).
    The profiler never starts tracing itself — the 2-4× allocation
    slowdown is an application decision, so with tracing off this
    reports ``{"tracing": False}`` instead of silently paying it."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return {"tracing": False, "top": []}
    snapshot = tracemalloc.take_snapshot()
    current, peak = tracemalloc.get_traced_memory()
    stats = snapshot.statistics("lineno")[: max(1, int(top))]
    return {
        "tracing": True,
        "traced_current_bytes": current,
        "traced_peak_bytes": peak,
        "top": [
            {
                "site": str(stat.traceback[0]) if stat.traceback else "?",
                "size_bytes": stat.size,
                "count": stat.count,
            }
            for stat in stats
        ],
    }


# ------------------------------------------------------------ pretty printer
def render_report(payload: dict, top: int = 10) -> str:
    """Human view: sampler state, per-span-kind self/child split, and
    the top self-time frames — the CLI's default rendering."""
    windows = list(_iter_windows(payload))
    total = sum(int(w.get("samples") or 0) for w in windows)
    lines = [
        f"profile: {len(windows)} window(s), {total} samples, "
        f"hz={payload.get('hz', '?')}, "
        f"overhead={100.0 * float(payload.get('overhead') or 0.0):.2f}% "
        f"of one core"
    ]
    spans = merged_span_times(payload)
    span_frames = merged_span_frames(payload)
    if spans:
        lines.append("")
        lines.append(
            f"{'span kind':<28} {'self':>7} {'child':>7} {'total':>7}  "
            f"self%  hottest frame"
        )
        ranked = sorted(
            spans.items(), key=lambda kv: (-kv[1]["total"], kv[0])
        )
        for name, counts in ranked:
            self_n = counts["self"]
            total_n = max(counts["total"], self_n)
            child_n = total_n - self_n
            pct = 100.0 * self_n / total_n if total_n else 0.0
            frames = span_frames.get(name) or {}
            hottest = (
                max(frames.items(), key=lambda kv: kv[1])[0]
                if frames
                else "-"
            )
            lines.append(
                f"{name:<28} {self_n:>7} {child_n:>7} {total_n:>7}  "
                f"{pct:5.1f}%  {hottest}"
            )
    hot = top_self_frames(payload, n=top)
    if hot:
        lines.append("")
        lines.append("top self-time frames:")
        for frame, share in hot:
            lines.append(f"  {100.0 * share:5.1f}%  {frame}")
    if not windows:
        lines.append("(no samples — is the profiler running?)")
    return "\n".join(lines)


# -------------------------------------------------------------------- selftest
def _selftest_hot_spin(seconds: float) -> int:
    """The synthetic hot function: a pure-CPU spin whose frame must
    dominate its span's self-time.  Module-level (not a closure) so its
    collapsed label — ``profiling._selftest_hot_spin`` — is stable."""
    deadline = time.monotonic() + seconds
    acc = 0
    while time.monotonic() < deadline:
        for i in range(1000):
            acc += i * i
    return acc


def _selftest_cold_wait(seconds: float) -> None:
    """The synthetic cold function: sleeps (self-time in the sampler's
    eyes, but a DIFFERENT frame than the hot spin)."""
    time.sleep(seconds)


def selftest() -> str:
    """End-to-end smoke of the profiling plane (the ``make
    verify-profile`` gate): a synthetic hot function inside a span must
    dominate that span's self-time through ALL the surfaces — the live
    snapshot, a real OpsServer ``GET /debug/profile`` in every format,
    the collapsed/speedscope round trips, and an offline
    :func:`diff_collapsed` that names the hot frame as the top
    regression.  Raises AssertionError on any violated expectation."""
    import json as json_mod
    import urllib.request

    from ..controller.ops_server import OpsServer

    hot_label = f"profiling.{_selftest_hot_spin.__name__}"
    registry = metrics_mod.MetricsRegistry()
    prev_registry = metrics_mod.set_default_registry(registry)
    tracer = tracing_mod.Tracer()
    prev_observer = tracing_mod.span_observer()
    profiler = SamplingProfiler(
        hz=250.0, window_seconds=30.0, registry=registry
    )
    ops = None
    try:
        profiler.install()
        profiler.start()
        with tracer.start_span("Reconcile"):
            with tracer.start_span("HotSpan"):
                _selftest_hot_spin(0.4)
            with tracer.start_span("ColdSpan"):
                _selftest_cold_wait(0.12)
        profiler.stop()

        # ---- plane 1: the live snapshot attributes the samples
        snap = profiler.snapshot()
        spans = merged_span_times(snap)
        assert spans.get("HotSpan", {}).get("self", 0) > 0, (
            f"no HotSpan self samples: {spans}"
        )
        assert spans["HotSpan"]["self"] > spans.get("ColdSpan", {}).get(
            "self", 0
        ), f"hot span must out-sample the cold one: {spans}"
        reconcile = spans.get("Reconcile", {"self": 0, "total": 0})
        child_time = reconcile["total"] - reconcile["self"]
        assert child_time > reconcile["self"], (
            "Reconcile's time must be CHILD time (it only wraps): "
            f"{reconcile}"
        )
        # the span-scoped named-frame decomposition: HotSpan's self-time
        # must be dominated by the synthetic hot function (span-scoped,
        # so an idle background thread parked in a wait frame cannot
        # out-sample it)
        hot_frames = merged_span_frames(snap).get("HotSpan") or {}
        assert hot_frames, f"HotSpan has no attributed frames: {spans}"
        top_frame = max(hot_frames.items(), key=lambda kv: kv[1])[0]
        assert top_frame == hot_label, (
            f"hot function must dominate HotSpan self-time, got "
            f"{top_frame} ({hot_frames})"
        )
        hot_selfs = self_frame_counts(merged_stacks(snap))
        assert hot_selfs.get(hot_label, 0) > 0, "hot frame missing globally"
        assert profiler.samples_total > 0 and profiler.overhead < 0.25, (
            f"sampler overhead implausible: {profiler.overhead}"
        )
        rendered = render_report(snap)
        assert hot_label in rendered and "HotSpan" in rendered

        # ---- plane 2: a real OpsServer serves the same data
        ops = OpsServer(port=0, host="127.0.0.1", profiler=profiler).start()
        with urllib.request.urlopen(
            ops.url + "/debug/profile", timeout=5
        ) as resp:
            served = json_mod.loads(resp.read().decode())
        assert served["windows"], "/debug/profile served no windows"
        assert merged_span_times(served)["HotSpan"]["self"] > 0
        with urllib.request.urlopen(
            ops.url + "/debug/profile?fmt=collapsed", timeout=5
        ) as resp:
            collapsed_body = resp.read().decode()
        assert hot_label in collapsed_body, "collapsed export lost the frame"
        with urllib.request.urlopen(
            ops.url + "/debug/profile?fmt=speedscope", timeout=5
        ) as resp:
            speedscope = json_mod.loads(resp.read().decode())
        back = snapshot_from_payload(speedscope)
        assert self_frame_counts(merged_stacks(back)).get(hot_label), (
            "speedscope round trip lost the hot frame"
        )
        with urllib.request.urlopen(
            ops.url + "/debug", timeout=5
        ) as resp:
            index = json_mod.loads(resp.read().decode())["endpoints"]
        assert "/debug/profile" in index, "profile missing from /debug index"

        # ---- plane 3: the offline diff names the regression.  The
        # baseline is the measured profile WITHOUT the hot function —
        # exactly the "before the regression landed" dump a real
        # ``profile diff A B`` compares against.
        current = parse_collapsed(collapsed_body)
        baseline = {
            stack: count
            for stack, count in current.items()
            if not stack.endswith(hot_label)
        }
        assert baseline and baseline != current, "hot frame not in dump"
        regressions = diff_collapsed(baseline, current)
        assert regressions and regressions[0]["frame"] == hot_label, (
            f"diff must lead with the hot frame: {regressions[:3]}"
        )

        # ---- metrics rode along
        exposition = registry.render()
        assert "profiler_samples_total" in exposition
        assert "profile_overhead" in exposition
        hot_total = spans["HotSpan"]["self"]
        return (
            f"profile selftest ok: {profiler.samples_total} samples, "
            f"HotSpan self={hot_total}, top frame {top_frame}, "
            f"overhead={100.0 * profiler.overhead:.2f}%, "
            f"diff leads with {regressions[0]['frame']} "
            f"(+{regressions[0]['delta_pct']:.1f}pp)"
        )
    finally:
        if ops is not None:
            ops.stop()
        profiler.stop()
        tracing_mod.set_span_observer(prev_observer)
        metrics_mod.set_default_registry(prev_registry)
