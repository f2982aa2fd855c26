"""Observability surfaces that sit next to the control plane:
:mod:`.tracing` (in-process spans, W3C traceparent propagation, Chrome
and OTLP exporters), :mod:`.events` (the reason-coded decision log) and
:mod:`.history` (bounded metric history).  Metrics live in
:mod:`..metrics`.
"""

from . import events, history
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
