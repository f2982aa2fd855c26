"""The port's minimal tracer (k8s_operator_libs_tpu_torch/obs/tracing.py)
against the JAX package's obs/tracing.py.

The traceparent carrier is what the two sides of the drain handshake
meet on, so formatting and parsing must agree with the orchestrator's on
every input; spans keep the orchestrator's record keys and parentage
order.
"""

import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_operator_libs_tpu.obs import tracing as jtracing
from k8s_operator_libs_tpu_torch.obs import tracing

HEX = "0123456789abcdef"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN_ID = "00f067aa0ba902b7"


@pytest.mark.parametrize(
    "value",
    [
        f"00-{TRACE_ID}-{SPAN_ID}-01",
        f"  00-{TRACE_ID}-{SPAN_ID}-00  ",  # whitespace, unsampled
        f"ff-{TRACE_ID.upper()}-{SPAN_ID}-01",
        f"00-{TRACE_ID}-{SPAN_ID}",  # three parts
        f"00-{TRACE_ID}-{SPAN_ID}-01-extra",
        f"0-{TRACE_ID}-{SPAN_ID}-01",  # wrong lengths
        f"00-{TRACE_ID[:-1]}-{SPAN_ID}-01",
        f"00-{TRACE_ID}-{SPAN_ID}0-01",
        f"00-{'0' * 32}-{SPAN_ID}-01",  # all-zero ids
        f"00-{TRACE_ID}-{'0' * 16}-01",
        f"00-{TRACE_ID[:-1]}g-{SPAN_ID}-01",  # not hex
        "",
        None,
        42,
        "garbage",
    ],
)
def test_parse_traceparent_equals_the_orchestrators(value):
    assert tracing.parse_traceparent(value) == jtracing.parse_traceparent(value)


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=80))
def test_parse_traceparent_equals_the_orchestrators_on_any_text(value):
    assert tracing.parse_traceparent(value) == jtracing.parse_traceparent(value)


@settings(max_examples=200, deadline=None)
@given(
    st.text(HEX, min_size=30, max_size=34),
    st.text(HEX, min_size=14, max_size=18),
    st.sampled_from(["00", "01", "ff", "0", "000"]),
)
def test_format_and_parse_equal_the_orchestrators(trace_id, span_id, version):
    value = tracing.format_traceparent(trace_id, span_id)
    assert value == jtracing.format_traceparent(trace_id, span_id)
    assert tracing.parse_traceparent(value) == jtracing.parse_traceparent(value)
    other = f"{version}-{trace_id}-{span_id}-01"
    assert tracing.parse_traceparent(other) == jtracing.parse_traceparent(other)


def test_span_to_dict_has_the_orchestrators_keys():
    port = tracing.Tracer().start_span("s", attributes={"node": "n"})
    ref = jtracing.Tracer().start_span("s", attributes={"node": "n"})
    port.end()
    ref.end()
    assert list(port.to_dict()) == list(ref.to_dict())
    assert port.to_dict()["attributes"] == {"node": "n"} and port.status == "ok"
    assert len(port.trace_id) == 32 and len(port.span_id) == 16
    assert tracing.parse_traceparent(port.traceparent) == (port.trace_id, port.span_id)


def test_parentage_order_parent_then_traceparent_then_current_then_root():
    tracer = tracing.Tracer()
    carrier = tracing.format_traceparent(TRACE_ID, SPAN_ID)
    with tracer.start_span("root") as root:
        assert root.parent_id == ""
        with tracer.start_span("current-child") as child:
            assert (child.trace_id, child.parent_id) == (root.trace_id, root.span_id)
        with tracer.start_span("carried", traceparent=carrier) as carried:
            assert (carried.trace_id, carried.parent_id) == (TRACE_ID, SPAN_ID)
        with tracer.start_span("explicit", parent=root, traceparent=carrier) as explicit:
            assert explicit.parent_id == root.span_id  # the explicit parent wins
        with tracer.start_span("malformed", traceparent="garbage") as bad:
            assert bad.parent_id == root.span_id  # a bad carrier falls to the current span
    with tracer.start_span("after") as after:
        assert after.parent_id == "" and after.trace_id != root.trace_id


def test_tracer_buffer_records_completes_and_evicts():
    tracer = tracing.Tracer(capacity=2)
    with tracer.start_span("a") as a:
        with tracer.start_span("a-child"):
            pass
        assert tracer.traces() == []  # the root is still open
        assert [t["complete"] for t in tracer.traces(complete_only=False)] == [False]
    trace = tracer.get_trace(a.trace_id)
    assert trace["complete"] and trace["name"] == "a"
    assert [s["name"] for s in trace["spans"]] == ["a-child", "a"]
    for name in ("b", "c"):
        tracer.start_span(name).__exit__(None, None, None)
    assert [t["name"] for t in tracer.traces()] == ["b", "c"]  # "a" evicted
    tracer.start_span("late", traceparent=a.traceparent).end()
    assert tracer.orphan_spans == 1  # a child of an evicted trace is dropped
    tracer.clear()
    assert tracer.traces(complete_only=False) == []
    with pytest.raises(ValueError):
        tracing.Tracer(capacity=0)


def test_an_exception_marks_the_span_error_and_propagates():
    tracer = tracing.Tracer()
    with pytest.raises(KeyError):
        with tracer.start_span("fails") as span:
            raise KeyError("x")
    assert span.status == "error" and span.status_message.startswith("KeyError")
    assert tracer.traces()[0]["spans"][0]["status"] == "error"


def test_spans_per_trace_are_bounded():
    tracer = tracing.Tracer(max_spans_per_trace=2)
    with tracer.start_span("root") as root:
        for _ in range(3):
            with tracer.start_span("child"):
                pass
    trace = tracer.get_trace(root.trace_id)
    assert len(trace["spans"]) == 2 and trace["dropped_spans"] == 2


def test_default_tracer_swap_and_a_thread_does_not_inherit_the_current_span():
    fresh = tracing.Tracer()
    previous = tracing.set_default_tracer(fresh)
    try:
        assert tracing.default_tracer() is fresh
        seen = []
        with tracing.start_span("main") as main:
            worker = threading.Thread(target=lambda: seen.append(tracing.start_span("t")))
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
        assert seen[0].parent_id == "" and seen[0].trace_id != main.trace_id
    finally:
        tracing.set_default_tracer(previous)
