"""Spans of the workload's hot path, with the card's times on the host's
clock.

One trace a train step (``train.step``, from
:meth:`..tpu.workload.CheckpointingTrainer.run`) or a decode call
(``decode.generate``, from :func:`..tpu.workload.generate`), recorded
into :func:`.tracing.workload_tracer`:

* a :class:`StepTrace` holds its root span and its phase spans
  (:attr:`.tracing.Span.held`) until it ends, then records them under one
  lock, children first, so that the device times it resolves last land in
  the records' ``attributes``;
* a timed phase records a CUDA timing event at its start, and with
  *closes* another at its end, taken from a pool.  Its ``device_ms`` runs
  from its event to the trace's next one; the root's, from the trace's
  first event to its last;
* :meth:`StepTrace.anchor` marks where the host knows that the card has
  passed the last event: a host read that waits for the step in any case,
  or a wait on that event.  Each event's device time is taken back from
  there along the events' elapsed times.  ``device_start_ns`` is when the
  card reached a span's start event, ``recorded_ns`` when the host
  recorded it, both in unix ns on the host's clock; their difference is
  how long the span's work waited in the launch queue.  The anchor lies
  after the card's last event by the host's wake-up (and, for a host read,
  the copy it waits for): microseconds;
* no event is recorded on the CPU, or while the stream captures a CUDA
  graph (the spans are recorded without device times), and a trace left
  by an exception keeps none;
* while a ``torch.profiler`` records, and only then, each span also enters
  ``torch.profiler.record_function`` under its name, so that the profile
  holds the span beside the kernels; otherwise the check is one flag read.

:func:`phase` opens a phase of the trace that is open in this context, and
nothing where none is: a train step function called outside
:meth:`~..tpu.workload.CheckpointingTrainer.run` records no span.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from . import tracing

__all__ = ["StepTrace", "phase"]

_open: contextvars.ContextVar[Optional["StepTrace"]] = contextvars.ContextVar(
    "hotpath_step_trace", default=None
)
_NO_PHASE = contextlib.nullcontext()

#: Timing events free for reuse, by device index.  A trace holds its
#: events until it ends, so the pool grows to the most one trace takes (a
#: decode call, one a step).
_pool: Dict[int, List[torch.cuda.Event]] = {}


def _take_event(index: int) -> torch.cuda.Event:
    try:
        return _pool.setdefault(index, []).pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _annotate(name: str):
    """``record_function(name)``, entered, while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    annotation = torch.profiler.record_function(name)
    annotation.__enter__()
    return annotation


class _Phase:
    """A held child span of a :class:`StepTrace`, timed on the card or not."""

    __slots__ = ("_trace", "_name", "_timed", "_closes", "_attributes", "_span", "_annotation")

    def __init__(self, trace: "StepTrace", name: str, timed: bool, closes: bool,
                 attributes: Dict[str, Any]) -> None:
        self._trace, self._name, self._timed, self._closes = trace, name, timed, closes
        self._attributes = attributes

    def __enter__(self) -> "_Phase":
        trace = self._trace
        self._span = span = trace.tracer.start_span(self._name, self._attributes, parent=trace.root)
        span.held = True
        self._annotation = _annotate(self._name)
        if self._timed:
            trace.mark(span)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._closes:
            self._trace.mark()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        self._span.__exit__(exc_type, exc, tb)
        self._trace._held.append(self._span)


class StepTrace:
    """One trace of the hot path: ``with StepTrace(name, device, attrs) as
    trace``, its phases ``with trace.phase(...)``.  *device* decides
    whether phases are timed on the card (a CUDA device) or not."""

    def __init__(self, name: str, device, attributes: Optional[Dict[str, Any]] = None) -> None:
        self.tracer = tracing.workload_tracer()
        self.name = name
        self._attributes = attributes
        device = torch.device(device)
        self._timed = device.type == "cuda"
        self._index = device.index
        self.root: Optional[tracing.Span] = None
        self._held: List[tracing.Span] = []
        #: (event, host ns when recorded, the span it starts or None)
        self._events: List[Tuple[torch.cuda.Event, int, Optional[tracing.Span]]] = []
        self._anchor_ns: Optional[int] = None

    def __enter__(self) -> "StepTrace":
        self.root = self.tracer.start_span(self.name, self._attributes)
        self.root.held = True
        if self._timed:
            if self._index is None:
                self._index = torch.cuda.current_device()
            self._stream = torch.cuda.current_stream(self._index)
        self._token = _open.set(self)
        self._annotation = _annotate(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        _open.reset(self._token)
        self.root.__exit__(exc_type, exc, tb)
        try:
            if exc is None and self._anchor_ns is not None:
                self._resolve()
        finally:
            if self._events:
                _pool.setdefault(self._index, []).extend(e for e, _, _ in self._events)
                self._events = []
            self.tracer.record_held(self._held + [self.root])

    def phase(self, name: str, timed: bool = False, closes: bool = False, **attributes) -> _Phase:
        """A child span; *timed*: a timing event at its start, *closes*:
        one at its end too."""
        return _Phase(self, name, timed, closes, attributes)

    def mark(self, span: Optional[tracing.Span] = None) -> None:
        """A timing event on the card, now, starting *span* (or closing the
        last timed span); nothing on the CPU or under graph capture."""
        if not self._timed or torch.cuda.is_current_stream_capturing():
            return
        event = _take_event(self._index)
        recorded = time.perf_counter_ns()
        event.record(self._stream)
        self._events.append((event, recorded, span))

    def anchor(self, wait: bool = False) -> None:
        """The card has passed the last event by now: the host has just read
        a result that waits for it, or, with *wait*, waits for it here."""
        if not self._events:
            return
        if wait:
            self._events[-1][0].synchronize()
        self._anchor_ns = time.perf_counter_ns()

    def _resolve(self) -> None:
        last = self._events[-1][0]
        to_unix = time.time_ns() - time.perf_counter_ns()
        anchor = self._anchor_ns + to_unix
        back = [event.elapsed_time(last) for event, _, _ in self._events]  # ms before the last
        for k, (_, recorded, span) in enumerate(self._events):
            if span is None:
                continue
            span.attributes["device_start_ns"] = anchor - round(back[k] * 1e6)
            span.attributes["recorded_ns"] = recorded + to_unix
            if k + 1 < len(back):
                span.attributes["device_ms"] = back[k] - back[k + 1]
        self.root.attributes["device_start_ns"] = anchor - round(back[0] * 1e6)
        self.root.attributes["device_ms"] = back[0]


def phase(name: str, timed: bool = False, closes: bool = False):
    """:meth:`StepTrace.phase` of the trace open in this context, or a
    context that records nothing where none is."""
    trace = _open.get()
    return _NO_PHASE if trace is None else trace.phase(name, timed, closes)
