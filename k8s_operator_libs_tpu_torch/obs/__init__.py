"""Observability surfaces that sit NEXT to the control plane.

The reference library is logr-only (SURVEY.md §5 — even its one
aggregate-progress event is commented out); this package holds the
signals this reproduction grew beyond it: :mod:`.tracing` (in-process
spans + W3C traceparent propagation + Chrome/OTLP exporters),
:mod:`.profiling` (the continuous sampling profiler with span
self-time attribution), and :mod:`.overhead` (the interleaved
paired-ratio methodology the bench's overhead gates share).  Metrics
live in :mod:`..metrics` (predating this package); the HTTP surface
for all of them is :class:`~..controller.ops_server.OpsServer`.
"""

from . import events, history, overhead, profiling, racewatch, slo
from .tracing import (
    Span,
    TraceContextFilter,
    Tracer,
    current_span,
    current_trace_id,
    current_traceparent,
    default_tracer,
    format_traceparent,
    install_trace_logging,
    parse_traceparent,
    record_span,
    render_trace_tree,
    set_default_tracer,
    start_span,
    to_chrome,
    to_otlp,
    traces_from_payload,
)

__all__ = [
    "events",
    "history",
    "overhead",
    "profiling",
    "slo",
    "Span",
    "TraceContextFilter",
    "Tracer",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "default_tracer",
    "format_traceparent",
    "install_trace_logging",
    "parse_traceparent",
    "record_span",
    "render_trace_tree",
    "set_default_tracer",
    "start_span",
    "to_chrome",
    "to_otlp",
    "traces_from_payload",
]
