"""In-process span tracing for the upgrade pipeline.

The reference answers "where did this node's upgrade time go?" with logs
alone; this module supplies the span layer the metrics histograms cannot:
one **trace** per reconcile, with nested spans for BuildState/ApplyState,
per-node state processing, the async drain/eviction workers, and — via a
W3C-style ``traceparent`` carried in the checkpoint-on-drain handshake
annotation — the workload side's checkpoint save, even when it runs in a
different process.

Design constraints, in order:

* **always-on cheap**: span start/stop is a couple of dict writes and a
  ``random.getrandbits`` id under no lock; recording a finished span
  takes one lock.  The fleet-scale bench runs traced.
* **bounded**: the tracer keeps at most *capacity* traces (oldest
  evicted) and *max_spans_per_trace* recorded spans per trace (excess
  counted in ``dropped_spans``, never an error).
* **async-friendly**: spans land in their trace whenever they end — a
  drain worker's span recorded seconds after the reconcile root closed
  still appears in the already-"completed" trace (as long as the trace
  is still buffered; a child arriving after a full buffer evicted its
  trace is counted in :attr:`Tracer.orphan_spans` and dropped), exactly
  like the async label writes the state machine itself relies on.

Context propagation uses :mod:`contextvars`: within a thread, nested
``start_span`` calls parent automatically; across threads or processes
the caller carries :func:`current_traceparent` and hands it to
``start_span(..., traceparent=...)`` (the drain manager and the
checkpoint handshake do exactly this).

Exporters: :func:`to_chrome` (load the output at ``chrome://tracing`` /
https://ui.perfetto.dev) and :func:`to_otlp` (OTLP/JSON-flavoured —
the field names an OTLP collector expects, minus protobuf fidelity).

The workload's hot path (a train step and its phases, a decode call and
its steps) records into a tracer of its own, :func:`workload_tracer`,
through :mod:`.hotpath`, which holds a trace's spans until the card's
times are known and then records them with :meth:`Tracer.record_held`.
"""

from __future__ import annotations

import contextvars
import json
import logging
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Span",
    "Tracer",
    "TraceContextFilter",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "default_tracer",
    "format_traceparent",
    "install_trace_logging",
    "parse_traceparent",
    "record_span",
    "render_trace_tree",
    "selftest",
    "set_default_tracer",
    "set_span_observer",
    "set_workload_tracer",
    "span_observer",
    "start_span",
    "to_chrome",
    "to_otlp",
    "traces_from_payload",
    "workload_tracer",
]

_TRACEPARENT_VERSION = "00"
_SAMPLED_FLAGS = "01"

#: Default bound on retained traces (a reconcile-per-trace operator at a
#: 50 ms active cadence keeps the last ~3 s of history at minimum; real
#: cadences keep minutes).
DEFAULT_CAPACITY = 64
#: Default bound on recorded spans per trace — a 4,096-node reconcile
#: emits 2 + O(active nodes) spans; the cap protects the buffer from a
#: pathological hot loop, not from normal fleets.
DEFAULT_MAX_SPANS = 4096
#: Bound on the workload tracer's traces: one a train step or a decode
#: call, so a thousand steps of history (see :func:`workload_tracer`).
WORKLOAD_CAPACITY = 1024

_rand = random.Random()

#: Optional process-wide span lifecycle observer (an object with
#: ``span_started(span)`` / ``span_ended(span)``) — the hook the
#: sampling profiler (:mod:`.profiling`) uses to keep a per-thread
#: stack of ACTIVE spans so wall-clock samples attribute to span
#: kinds.  One attribute read per span start/end when unset, so the
#: tracer's always-on cost is unchanged for processes that never
#: profile.  Module-level (not per-Tracer): samples must attribute no
#: matter which tracer a component records into, exactly like the
#: metrics registry's process-default.
_span_observer = None


def span_observer():
    """The installed span observer, or None."""
    return _span_observer


def set_span_observer(observer):
    """Install (or with ``None`` remove) the process-wide span
    observer; returns the previous one.  Observer exceptions are NEVER
    swallowed here by design — the only installer is the profiler,
    whose callbacks are two dict operations; a broken observer should
    fail loudly in tests, not silently skew attribution."""
    global _span_observer
    previous = _span_observer
    _span_observer = observer
    return previous


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C ``traceparent`` header value (version 00, sampled)."""
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-{_SAMPLED_FLAGS}"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, span_id)`` from a traceparent, or None when the value
    is absent/malformed (propagation is best-effort: a corrupt carrier
    starts a fresh trace rather than failing the caller)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


class Span:
    """One timed operation.  Usable as a context manager (ends the span
    and restores the previous current-span on exit; an exception marks
    ``status="error"`` with the message before propagating)."""

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str,
        attributes: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.status = "unset"
        self.status_message = ""
        self.thread = threading.current_thread().name
        self.start_unix = time.time()
        self._start_mono = time.monotonic()
        self.duration: Optional[float] = None
        self._token: Optional[contextvars.Token] = None
        #: a held span is left out of the buffer when it ends; its owner
        #: records it with :meth:`Tracer.record_held` once its attributes
        #: are complete (device times known only after the step)
        self.held = False

    # ------------------------------------------------------------- recording
    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def set_status(self, status: str, message: str = "") -> "Span":
        self.status = status
        self.status_message = message
        return self

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    @property
    def ended(self) -> bool:
        return self.duration is not None

    def end(self) -> None:
        if self.ended:
            return
        self.duration = time.monotonic() - self._start_mono
        if self.status == "unset":
            self.status = "ok"
        observer = _span_observer
        if observer is not None:
            observer.span_ended(self)
        if not self.held:
            self._tracer._record(self)

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc is not None and self.status == "unset":
            self.set_status("error", f"{exc_type.__name__}: {exc}")
        if self._token is not None:
            try:
                self._tracer._current.reset(self._token)
            except ValueError:
                # ended in a different context than it was started in
                # (e.g. a generator moved across threads) — best effort
                pass
            self._token = None
        self.end()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_unix,
            "duration_s": self.duration,
            "status": self.status,
            "status_message": self.status_message,
            "thread": self.thread,
            "attributes": dict(self.attributes),
        }


class _Trace:
    """Mutable per-trace record inside the tracer's buffer."""

    __slots__ = ("trace_id", "name", "started_unix", "spans",
                 "dropped_spans", "complete")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.name = ""
        self.started_unix = time.time()
        self.spans: List[dict] = []
        self.dropped_spans = 0
        self.complete = False

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "started_unix": self.started_unix,
            "complete": self.complete,
            "dropped_spans": self.dropped_spans,
            "spans": list(self.spans),
        }


class Tracer:
    """Span factory + bounded buffer of recent traces."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        max_spans_per_trace: int = DEFAULT_MAX_SPANS,
    ) -> None:
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self._capacity = capacity
        self._max_spans = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        #: child spans dropped because their trace was already evicted
        #: from a FULL buffer (see :meth:`_record`) — observable so a
        #: busy operator losing late drain spans is diagnosable.
        self.orphan_spans = 0
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("tracing_current_span", default=None)
        )

    # ---------------------------------------------------------------- spans
    def start_span(
        self,
        name: str,
        attributes: Optional[Dict[str, Any]] = None,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
    ) -> Span:
        """Start (and make current) a span.  Parentage resolution order:
        explicit *parent* span → *traceparent* string (cross-thread /
        cross-process carrier) → the context's current span → new root."""
        parent_ctx: Optional[Tuple[str, str]] = None
        if parent is not None:
            parent_ctx = (parent.trace_id, parent.span_id)
        elif traceparent is not None:
            parent_ctx = parse_traceparent(traceparent)
        if parent_ctx is None:
            current = self._current.get()
            if current is not None and not current.ended:
                parent_ctx = (current.trace_id, current.span_id)
        if parent_ctx is not None:
            trace_id, parent_id = parent_ctx
        else:
            trace_id, parent_id = _new_trace_id(), ""
            # A ROOT creates its buffer entry eagerly (one lock per
            # trace, i.e. per reconcile): children record before the
            # root ends, and at a full buffer the orphan guard in
            # :meth:`_record` would otherwise mistake every child of an
            # open root for a child of an evicted trace and drop the
            # whole interior of the tree.
            with self._lock:
                self._get_or_create_locked(trace_id).name = name
        # No tracer lock for child spans: span start is the hot path
        # (per node per reconcile at fleet scale); children land in the
        # entry their root already created.
        span = Span(self, name, trace_id, _new_span_id(), parent_id, attributes)
        span._token = self._current.set(span)
        observer = _span_observer
        if observer is not None:
            observer.span_started(span)
        return span

    def record_span(
        self,
        name: str,
        seconds: float,
        attributes: Optional[Dict[str, Any]] = None,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
    ) -> Span:
        """Record an already-elapsed interval as a completed span ending
        now (e.g. the workqueue wait that preceded this reconcile).  The
        span never becomes current."""
        span = self.start_span(
            name, attributes=attributes, parent=parent, traceparent=traceparent
        )
        if span._token is not None:
            self._current.reset(span._token)
            span._token = None
        seconds = max(0.0, float(seconds))
        span.start_unix -= seconds
        span._start_mono -= seconds
        span.end()
        return span

    def current_span(self) -> Optional[Span]:
        span = self._current.get()
        if span is not None and span.ended:
            return None
        return span

    def current_traceparent(self) -> Optional[str]:
        span = self.current_span()
        return None if span is None else span.traceparent

    def current_trace_id(self) -> Optional[str]:
        span = self.current_span()
        return None if span is None else span.trace_id

    # --------------------------------------------------------------- buffer
    def _get_or_create_locked(self, trace_id: str) -> _Trace:
        trace = self._traces.get(trace_id)
        if trace is None:
            trace = _Trace(trace_id)
            self._traces[trace_id] = trace
            while len(self._traces) > self._capacity:
                self._traces.popitem(last=False)
        return trace

    def _record(self, span: Span) -> None:
        with self._lock:
            self._record_locked(span)

    def record_held(self, spans: Iterable[Span]) -> None:
        """Record ended held spans (:attr:`Span.held`), in the order given,
        under one lock; the bounds drop and count them as any others."""
        with self._lock:
            for span in spans:
                self._record_locked(span)

    def _record_locked(self, span: Span) -> None:
        if (
            span.parent_id
            and span.trace_id not in self._traces
            and len(self._traces) >= self._capacity
        ):
            # A child joining a trace the FULL buffer already
            # evicted: creating an entry would resurrect a ghost
            # (never-complete, invisible to /debug/traces) whose
            # insertion evicts a genuine completed trace.  Count and
            # drop; below capacity the entry is created normally so
            # split-process children (the workload-side handshake
            # tracer) stay visible.
            self.orphan_spans += 1
            return
        trace = self._get_or_create_locked(span.trace_id)
        if len(trace.spans) >= self._max_spans:
            # count-only: building the record dict for a span the
            # buffer will drop is pure overhead
            trace.dropped_spans += 1
        else:
            trace.spans.append(span.to_dict())
        if not span.parent_id:
            trace.complete = True
            trace.name = span.name
        elif not trace.name:
            trace.name = span.name

    def traces(self, complete_only: bool = True) -> List[dict]:
        """Buffered traces, oldest first.  *complete_only* keeps traces
        whose root span has ended (in-flight reconciles excluded)."""
        with self._lock:
            out = [t.to_dict() for t in self._traces.values()]
        if complete_only:
            out = [t for t in out if t["complete"]]
        return out

    def get_trace(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            trace = self._traces.get(trace_id)
            return None if trace is None else trace.to_dict()

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


# ------------------------------------------------------------ process default
_default_tracer = Tracer()
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer every instrumented component records into."""
    with _default_lock:
        return _default_tracer


def set_default_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer (tests); returns the previous."""
    global _default_tracer
    with _default_lock:
        previous = _default_tracer
        _default_tracer = tracer
        return previous


_workload_tracer = Tracer(capacity=WORKLOAD_CAPACITY)


def workload_tracer() -> Tracer:
    """The process-wide tracer of the workload's hot path (the trainer's
    steps and the decode calls, :mod:`.hotpath`): a tracer of its own, so
    that a thousand steps never evict the control plane's traces."""
    with _default_lock:
        return _workload_tracer


def set_workload_tracer(tracer: Tracer) -> Tracer:
    """Swap the workload tracer (tests); returns the previous."""
    global _workload_tracer
    with _default_lock:
        previous = _workload_tracer
        _workload_tracer = tracer
        return previous


def start_span(
    name: str,
    attributes: Optional[Dict[str, Any]] = None,
    parent: Optional[Span] = None,
    traceparent: Optional[str] = None,
) -> Span:
    return default_tracer().start_span(
        name, attributes=attributes, parent=parent, traceparent=traceparent
    )


def record_span(
    name: str,
    seconds: float,
    attributes: Optional[Dict[str, Any]] = None,
    parent: Optional[Span] = None,
    traceparent: Optional[str] = None,
) -> Span:
    return default_tracer().record_span(
        name, seconds, attributes=attributes, parent=parent,
        traceparent=traceparent,
    )


def current_span() -> Optional[Span]:
    return default_tracer().current_span()


def current_traceparent() -> Optional[str]:
    return default_tracer().current_traceparent()


def current_trace_id() -> Optional[str]:
    return default_tracer().current_trace_id()


# ------------------------------------------------------------- log injection
class TraceContextFilter(logging.Filter):
    """Stamp every record with ``trace_id``/``span_id`` from the current
    span (``-`` outside any span), so a formatter like
    ``"%(levelname)s %(trace_id)s %(message)s"`` correlates log lines
    with ``/debug/traces`` and the histogram exemplars."""

    def __init__(self, tracer: Optional[Tracer] = None) -> None:
        super().__init__()
        self._tracer = tracer

    def filter(self, record: logging.LogRecord) -> bool:
        tracer = self._tracer or default_tracer()
        span = tracer.current_span()
        record.trace_id = span.trace_id if span is not None else "-"
        record.span_id = span.span_id if span is not None else "-"
        return True


def install_trace_logging(
    logger: Optional[logging.Logger] = None,
    tracer: Optional[Tracer] = None,
) -> TraceContextFilter:
    """Attach a :class:`TraceContextFilter` to *logger* (default: the
    root logger's handlers, so every formatted record carries the ids
    regardless of which child logger emitted it).  Returns the filter
    for later ``removeFilter``."""
    filt = TraceContextFilter(tracer)
    if logger is not None:
        logger.addFilter(filt)
        return filt
    root = logging.getLogger()
    root.addFilter(filt)
    for handler in root.handlers:
        handler.addFilter(filt)
    return filt


# ------------------------------------------------------------------ exporters
def to_chrome(traces: Iterable[dict]) -> dict:
    """Chrome trace-event JSON (``chrome://tracing`` / Perfetto): one
    complete ("X") event per span, microsecond timestamps, one pid per
    trace so concurrent reconciles render as separate tracks."""
    events = []
    for pid, trace in enumerate(traces, start=1):
        for span in trace.get("spans", ()):
            duration = span.get("duration_s") or 0.0
            args = {
                "trace_id": span.get("trace_id", ""),
                "span_id": span.get("span_id", ""),
                "parent_id": span.get("parent_id", ""),
                "status": span.get("status", ""),
            }
            args.update(span.get("attributes") or {})
            events.append(
                {
                    "name": span.get("name", ""),
                    "cat": "span",
                    "ph": "X",
                    "ts": round(span.get("start_unix", 0.0) * 1e6, 1),
                    "dur": round(duration * 1e6, 1),
                    "pid": pid,
                    "tid": span.get("thread", "main"),
                    "args": args,
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _otlp_attributes(attrs: Dict[str, Any]) -> List[dict]:
    out = []
    for key, value in attrs.items():
        if isinstance(value, bool):
            typed = {"boolValue": value}
        elif isinstance(value, int):
            typed = {"intValue": str(value)}
        elif isinstance(value, float):
            typed = {"doubleValue": value}
        else:
            typed = {"stringValue": str(value)}
        out.append({"key": str(key), "value": typed})
    return out


_OTLP_STATUS_CODES = {"unset": 0, "ok": 1, "error": 2}


def to_otlp(traces: Iterable[dict], service_name: str = "k8s-operator-libs-tpu") -> dict:
    """OTLP/JSON-flavoured dump: the ``resourceSpans`` shape an OTLP
    collector's JSON receiver expects (hex ids, unix-nano timestamps,
    typed attributes)."""
    spans = []
    for trace in traces:
        for span in trace.get("spans", ()):
            start_ns = int(span.get("start_unix", 0.0) * 1e9)
            end_ns = start_ns + int((span.get("duration_s") or 0.0) * 1e9)
            spans.append(
                {
                    "traceId": span.get("trace_id", ""),
                    "spanId": span.get("span_id", ""),
                    "parentSpanId": span.get("parent_id", ""),
                    "name": span.get("name", ""),
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(start_ns),
                    "endTimeUnixNano": str(end_ns),
                    "attributes": _otlp_attributes(span.get("attributes") or {}),
                    "status": {
                        "code": _OTLP_STATUS_CODES.get(
                            span.get("status", "unset"), 0
                        ),
                        "message": span.get("status_message", ""),
                    },
                }
            )
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _otlp_attributes(
                        {"service.name": service_name}
                    )
                },
                "scopeSpans": [
                    {
                        "scope": {"name": __name__},
                        "spans": spans,
                    }
                ],
            }
        ]
    }


# ----------------------------------------------------------------- importers
def _spans_from_otlp(payload: dict) -> List[dict]:
    spans = []
    for rs in payload.get("resourceSpans") or ():
        for ss in rs.get("scopeSpans") or ():
            for span in ss.get("spans") or ():
                attrs = {}
                for attr in span.get("attributes") or ():
                    value = attr.get("value") or {}
                    attrs[attr.get("key", "")] = next(
                        iter(value.values()), ""
                    )
                start_ns = int(span.get("startTimeUnixNano") or 0)
                end_ns = int(span.get("endTimeUnixNano") or 0)
                code = span.get("status", {}).get("code", 0)
                status = {v: k for k, v in _OTLP_STATUS_CODES.items()}.get(
                    code, "unset"
                )
                spans.append(
                    {
                        "name": span.get("name", ""),
                        "trace_id": span.get("traceId", ""),
                        "span_id": span.get("spanId", ""),
                        "parent_id": span.get("parentSpanId", ""),
                        "start_unix": start_ns / 1e9,
                        "duration_s": max(0, end_ns - start_ns) / 1e9,
                        "status": status,
                        "status_message": span.get("status", {}).get(
                            "message", ""
                        ),
                        "thread": "",
                        "attributes": attrs,
                    }
                )
    return spans


def _spans_from_chrome(payload: dict) -> List[dict]:
    spans = []
    for event in payload.get("traceEvents") or ():
        if event.get("ph") != "X":
            continue
        args = dict(event.get("args") or {})
        spans.append(
            {
                "name": event.get("name", ""),
                "trace_id": args.pop("trace_id", ""),
                "span_id": args.pop("span_id", ""),
                "parent_id": args.pop("parent_id", ""),
                "start_unix": float(event.get("ts") or 0.0) / 1e6,
                "duration_s": float(event.get("dur") or 0.0) / 1e6,
                "status": args.pop("status", "unset"),
                "status_message": "",
                "thread": str(event.get("tid", "")),
                "attributes": args,
            }
        )
    return spans


def traces_from_payload(payload: dict) -> List[dict]:
    """Native trace dicts from any of the three dump shapes this module
    emits (native ``{"traces": [...]}``, OTLP-flavoured, Chrome).  Raises
    ``ValueError`` on an unrecognized payload."""
    if not isinstance(payload, dict):
        raise ValueError("trace payload must be a JSON object")
    if isinstance(payload.get("traces"), list):
        traces = payload["traces"]
        # validate here, not when the CLI walks the tree: a hand-edited
        # dump must be a clean "not a trace dump" error, not a traceback
        for trace in traces:
            if not isinstance(trace, dict) or not isinstance(
                trace.get("spans"), list
            ):
                raise ValueError(
                    "native trace entries must be objects with a spans list"
                )
            if not all(isinstance(s, dict) for s in trace["spans"]):
                raise ValueError("native trace spans must be objects")
        return list(traces)
    if "resourceSpans" in payload:
        spans = _spans_from_otlp(payload)
    elif "traceEvents" in payload:
        spans = _spans_from_chrome(payload)
    else:
        raise ValueError(
            "unrecognized trace payload (expected traces / resourceSpans / "
            "traceEvents)"
        )
    by_trace: "OrderedDict[str, dict]" = OrderedDict()
    for span in spans:
        trace = by_trace.setdefault(
            span["trace_id"],
            {
                "trace_id": span["trace_id"],
                "name": "",
                "started_unix": span["start_unix"],
                "complete": False,
                "dropped_spans": 0,
                "spans": [],
            },
        )
        trace["spans"].append(span)
        trace["started_unix"] = min(trace["started_unix"], span["start_unix"])
        if not span.get("parent_id"):
            trace["complete"] = True
            trace["name"] = trace["name"] or span["name"]
    return list(by_trace.values())


# ------------------------------------------------------------ pretty printer
def render_trace_tree(trace: dict) -> str:
    """Indented span tree with durations — the CLI's human view."""
    spans = sorted(
        trace.get("spans") or (), key=lambda s: s.get("start_unix", 0.0)
    )
    by_parent: Dict[str, List[dict]] = {}
    ids = {s.get("span_id") for s in spans}
    for span in spans:
        parent = span.get("parent_id") or ""
        # spans whose parent never landed in the buffer render at root
        if parent not in ids:
            parent = ""
        by_parent.setdefault(parent, []).append(span)
    lines = [
        f"trace {trace.get('trace_id', '?')}  "
        f"{trace.get('name') or '(unnamed)'}  "
        f"spans={len(spans)} dropped={trace.get('dropped_spans', 0)}"
    ]

    def walk(parent_id: str, depth: int) -> None:
        for span in by_parent.get(parent_id, ()):  # already time-ordered
            duration = span.get("duration_s")
            dur = "   ...s" if duration is None else f"{duration * 1e3:8.2f}ms"
            status = span.get("status", "")
            mark = " !" if status == "error" else ""
            attrs = span.get("attributes") or {}
            node = f"  node={attrs['node']}" if "node" in attrs else ""
            lines.append(
                f"{dur}  {'  ' * depth}{span.get('name', '?')}{mark}{node}"
            )
            walk(span.get("span_id", ""), depth + 1)

    walk("", 1)
    return "\n".join(lines)


# -------------------------------------------------------------------- selftest
def selftest() -> str:
    """End-to-end smoke of the tracing pipeline on a private tracer:
    nested spans, a cross-"process" traceparent hop, both exporters
    round-tripped through their importers, and the log filter.  Returns
    a human summary; raises AssertionError on any failure (the CLI and
    ``make verify-obs`` run this)."""
    tracer = Tracer(capacity=4)
    with tracer.start_span("Reconcile", attributes={"selftest": True}) as root:
        with tracer.start_span("BuildState"):
            time.sleep(0.001)
        carrier = tracer.current_traceparent()
        assert carrier is not None and parse_traceparent(carrier) == (
            root.trace_id,
            root.span_id,
        ), "traceparent round trip"
        with tracer.start_span("ApplyState"):
            with tracer.start_span(
                "ProcessNodeState", attributes={"node": "selftest-node"}
            ):
                pass
        # the cross-boundary hop: only the carrier string crosses
        with tracer.start_span("drain", traceparent=carrier) as drain:
            assert drain.trace_id == root.trace_id, "carrier joins the trace"
            tracer.record_span("drain-handshake", 0.002, parent=drain)
    traces = tracer.traces()
    assert len(traces) == 1 and traces[0]["complete"], "one completed trace"
    names = {s["name"] for s in traces[0]["spans"]}
    assert {
        "Reconcile", "BuildState", "ApplyState", "ProcessNodeState",
        "drain", "drain-handshake",
    } <= names, f"span tree incomplete: {names}"
    assert tracer.current_span() is None, "context restored"

    chrome = json.loads(json.dumps(to_chrome(traces)))
    assert chrome["traceEvents"] and all(
        e["ph"] == "X" and e["dur"] >= 0 for e in chrome["traceEvents"]
    ), "chrome export"
    assert traces_from_payload(chrome)[0]["trace_id"] == root.trace_id

    otlp = json.loads(json.dumps(to_otlp(traces)))
    back = traces_from_payload(otlp)
    assert back and back[0]["trace_id"] == root.trace_id, "otlp round trip"
    assert {s["name"] for s in back[0]["spans"]} == names, "otlp span loss"

    record = logging.LogRecord("t", logging.INFO, __file__, 1, "m", (), None)
    TraceContextFilter(tracer).filter(record)
    assert record.trace_id == "-", "no-span log stamp"
    with tracer.start_span("log-span") as span:
        TraceContextFilter(tracer).filter(record)
        assert record.trace_id == span.trace_id, "in-span log stamp"
    return (
        f"traces selftest ok: 1 trace, {len(traces[0]['spans'])} spans, "
        f"chrome={len(chrome['traceEvents'])} events, otlp round trip ok"
    )
