"""In-process span tracing: the part the drain handshake needs.

A copy of the span layer of ``k8s_operator_libs_tpu/obs/tracing.py``:
W3C ``traceparent`` formatting and parsing, :class:`Span` (same
``to_dict`` keys), and :class:`Tracer` with its bounded buffer of recent
traces.  The orchestrator's gate writes its ``drain-handshake`` span's
traceparent next to the checkpoint request; the workload side parents
its ``checkpoint-drain`` span under it, so the save appears in the
orchestrator's reconcile trace although it runs in another process.

Within a thread nested ``start_span`` calls parent automatically
(:mod:`contextvars`); across threads or processes the caller hands the
carrier to ``start_span(..., traceparent=...)``.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

_TRACEPARENT_VERSION = "00"
_SAMPLED_FLAGS = "01"

#: Bound on retained traces (oldest evicted).
DEFAULT_CAPACITY = 64
#: Bound on recorded spans per trace (excess counted, never an error).
DEFAULT_MAX_SPANS = 4096

_rand = random.Random()


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C ``traceparent`` header value (version 00, sampled)."""
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-{_SAMPLED_FLAGS}"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, span_id)`` from a traceparent, or None when the value
    is absent or malformed (propagation is best-effort: a corrupt carrier
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
    and restores the previous current span on exit; an exception marks
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
        self._tracer._record(self)

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

    __slots__ = ("trace_id", "name", "started_unix", "spans", "dropped_spans", "complete")

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
    """Span factory and bounded buffer of recent traces."""

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
        #: child spans dropped because the full buffer had already
        #: evicted their trace (see :meth:`_record`)
        self.orphan_spans = 0
        self._current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
            "tracing_current_span", default=None
        )

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
            # a root creates its buffer entry at once: its children
            # record before it ends
            with self._lock:
                self._get_or_create_locked(trace_id).name = name
        span = Span(self, name, trace_id, _new_span_id(), parent_id, attributes)
        span._token = self._current.set(span)
        return span

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
            if (
                span.parent_id
                and span.trace_id not in self._traces
                and len(self._traces) >= self._capacity
            ):
                # a child of a trace the full buffer already evicted:
                # an entry for it would evict a genuine trace
                self.orphan_spans += 1
                return
            trace = self._get_or_create_locked(span.trace_id)
            if len(trace.spans) >= self._max_spans:
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
        whose root span has ended (a span parented from another process
        lands in a trace whose root this tracer never sees)."""
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


_default_tracer = Tracer()
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer the drain handshake records into."""
    with _default_lock:
        return _default_tracer


def set_default_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer; returns the previous one."""
    global _default_tracer
    with _default_lock:
        previous = _default_tracer
        _default_tracer = tracer
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
