"""The port's tracer (k8s_operator_libs_tpu_torch/obs/tracing.py) against
the JAX package's obs/tracing.py.

The traceparent carrier is what the two sides of the drain handshake
meet on, so formatting and parsing must agree with the orchestrator's on
every input; spans keep the orchestrator's record keys and parentage
order.  ``TestSpanBasics``, ``TestLogInjection``, the exporter round
trips of ``TestExportersAndCli``, ``TestEndToEndUpgradeTrace`` (one
traced rollout through the port's ``ClusterUpgradeStateManager``, served
by its ``OpsServer``) and ``TestQueueWaitSpans`` (its controller) from
``tests/test_tracing.py`` run on the port as cases of the same names
(the CLI test waits for the port's ``__main__``); a trace exported by either package is
read back by the other, and the same trace dicts export to the same
Chrome and OTLP payloads.
"""

import json
import logging
import threading
import time
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_operator_libs_tpu.obs import tracing as jtracing
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, PreDrainCheckpointSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import tracing
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import CheckpointDrainGate, DrainSignalWatcher
from k8s_operator_libs_tpu_torch.upgrade import consts
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


HEX = "0123456789abcdef"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN_ID = "00f067aa0ba902b7"


def _run_traced_rollout(nodes: int = 3):
    """A full stub-cluster upgrade under ONE root span, with the
    checkpoint-drain handshake answered by a workload-side thread.
    Returns (tracer, registry, root_span)."""
    tracer = tracing.Tracer()
    prev_tracer = tracing.set_default_tracer(tracer)
    registry = metrics.MetricsRegistry()
    prev_registry = metrics.set_default_registry(registry)
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for i in range(nodes):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("v2")
    gate = CheckpointDrainGate(
        cluster, PreDrainCheckpointSpec(enable=True, timeout_second=5)
    )
    manager = ClusterUpgradeStateManager(
        cluster,
        pre_drain_gate=gate,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    stop = threading.Event()

    def responder():
        watchers = [
            DrainSignalWatcher(cluster, f"n{i}") for i in range(nodes)
        ]
        while not stop.is_set():
            for watcher in watchers:
                watcher.check_and_acknowledge(lambda: None)
            time.sleep(0.005)

    thread = threading.Thread(target=responder, daemon=True)
    thread.start()
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )
    try:
        with tracing.start_span("Upgrade", attributes={"nodes": nodes}) as root:
            for _ in range(40):
                state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
                manager.apply_state(state, policy)
                manager.drain_manager.wait_idle(10.0)
                manager.pod_manager.wait_idle(10.0)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            else:
                raise AssertionError(f"no convergence: {fleet.states()}")
    finally:
        stop.set()
        thread.join(2.0)
        manager.shutdown()
        tracing.set_default_tracer(prev_tracer)
        metrics.set_default_registry(prev_registry)
    return tracer, registry, root


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


# ---- the full tracer: the JAX package's classes, then the exporters across packages


class TestSpanBasics:
    def test_nesting_and_context_restore(self):
        tracer = tracing.Tracer()
        with tracer.start_span("root") as root:
            assert tracer.current_span() is root
            with tracer.start_span("child") as child:
                assert child.trace_id == root.trace_id
                assert child.parent_id == root.span_id
            assert tracer.current_span() is root
        assert tracer.current_span() is None
        (trace,) = tracer.traces()
        assert trace["complete"] and trace["name"] == "root"
        assert {s["name"] for s in trace["spans"]} == {"root", "child"}

    def test_exception_marks_error_status(self):
        tracer = tracing.Tracer()
        with pytest.raises(RuntimeError):
            with tracer.start_span("boom"):
                raise RuntimeError("drain wedged")
        (trace,) = tracer.traces()
        (span,) = trace["spans"]
        assert span["status"] == "error"
        assert "drain wedged" in span["status_message"]

    def test_traceparent_round_trip_and_rejects_garbage(self):
        with tracing.start_span("root") as root:
            carrier = tracing.current_traceparent()
        assert tracing.parse_traceparent(carrier) == (
            root.trace_id,
            root.span_id,
        )
        for bad in (None, "", "junk", "00-zz-yy-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01"):
            assert tracing.parse_traceparent(bad) is None

    def test_cross_thread_handoff_joins_the_trace(self):
        tracer = tracing.Tracer()
        seen = {}

        def worker(carrier):
            with tracer.start_span("async-work", traceparent=carrier) as span:
                seen["trace_id"] = span.trace_id

        with tracer.start_span("root") as root:
            t = threading.Thread(target=worker, args=(root.traceparent,))
            t.start()
            t.join(2.0)
        assert seen["trace_id"] == root.trace_id
        (trace,) = tracer.traces()
        assert {s["name"] for s in trace["spans"]} == {"root", "async-work"}

    def test_late_async_span_lands_in_completed_trace(self):
        """A drain worker ending after the reconcile root closed must
        still append to the (already completed) trace — the async-result
        pattern the whole state machine is built on."""
        tracer = tracing.Tracer()
        with tracer.start_span("root") as root:
            carrier = root.traceparent
        assert tracer.traces()[0]["complete"]
        with tracer.start_span("late-drain", traceparent=carrier):
            pass
        (trace,) = tracer.traces()
        assert "late-drain" in {s["name"] for s in trace["spans"]}

    def test_orphan_child_of_evicted_trace_dropped_not_resurrected(self):
        """A child span whose trace a FULL buffer already evicted must
        not create a ghost (never-complete) entry that evicts a real
        completed trace — it is counted and dropped."""
        tracer = tracing.Tracer(capacity=2)
        with tracer.start_span("old") as old:
            carrier = old.traceparent
        for i in range(2):  # evicts "old"
            with tracer.start_span(f"new{i}"):
                pass
        survivors = {t["name"] for t in tracer.traces()}
        with tracer.start_span("late-child", traceparent=carrier):
            pass
        assert tracer.orphan_spans == 1
        assert {t["name"] for t in tracer.traces()} == survivors

    def test_full_buffer_keeps_interiors_of_new_traces(self):
        """Steady state (buffer at capacity for the rest of the process
        lifetime): new reconcile trees must keep their INTERIOR spans —
        children record before their root, and a naive orphan guard
        would drop them all once eviction holds the buffer at
        capacity."""
        tracer = tracing.Tracer(capacity=2)
        for i in range(5):  # well past capacity
            with tracer.start_span(f"root{i}"):
                with tracer.start_span("child"):
                    pass
        traces = tracer.traces()
        assert len(traces) == 2
        for trace in traces:
            assert {s["name"] for s in trace["spans"]} >= {"child"}
        assert tracer.orphan_spans == 0

    def test_capacity_evicts_oldest(self):
        tracer = tracing.Tracer(capacity=2)
        ids = []
        for i in range(3):
            with tracer.start_span(f"r{i}") as span:
                ids.append(span.trace_id)
        kept = {t["trace_id"] for t in tracer.traces()}
        assert kept == set(ids[1:])

    def test_span_cap_counts_drops(self):
        tracer = tracing.Tracer(max_spans_per_trace=2)
        with tracer.start_span("root"):
            for _ in range(3):
                with tracer.start_span("child"):
                    pass
        (trace,) = tracer.traces()
        assert len(trace["spans"]) == 2
        assert trace["dropped_spans"] == 2  # 2 extra children + root

    def test_record_span_backdates(self):
        tracer = tracing.Tracer()
        with tracer.start_span("root") as root:
            queued = tracer.record_span("queue-wait", 1.5, parent=root)
        assert queued.duration == pytest.approx(1.5, abs=0.05)
        assert queued.parent_id == root.span_id
        assert tracer.current_span() is None

    def test_default_tracer_swap(self):
        mine = tracing.Tracer()
        prev = tracing.set_default_tracer(mine)
        try:
            with tracing.start_span("via-module"):
                assert tracing.current_trace_id() is not None
            assert mine.traces()
        finally:
            tracing.set_default_tracer(prev)


class TestExportersAndCli:
    def _one_trace(self):
        tracer = tracing.Tracer()
        with tracer.start_span("Reconcile") as root:
            with tracer.start_span("BuildState"):
                time.sleep(0.001)
        return tracer.traces(), root

    def test_chrome_export_and_reimport(self):
        traces, root = self._one_trace()
        chrome = json.loads(json.dumps(tracing.to_chrome(traces)))
        assert all(e["ph"] == "X" for e in chrome["traceEvents"])
        assert {e["name"] for e in chrome["traceEvents"]} == {
            "Reconcile", "BuildState",
        }
        back = tracing.traces_from_payload(chrome)
        assert back[0]["trace_id"] == root.trace_id

    def test_otlp_export_and_reimport(self):
        traces, root = self._one_trace()
        otlp = json.loads(json.dumps(tracing.to_otlp(traces)))
        spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert all(
            int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
            for s in spans
        )
        back = tracing.traces_from_payload(otlp)
        assert {s["name"] for s in back[0]["spans"]} == {
            "Reconcile", "BuildState",
        }

    def test_render_tree_orders_and_indents(self):
        traces, _ = self._one_trace()
        text = tracing.render_trace_tree(traces[0])
        lines = text.splitlines()
        assert "Reconcile" in lines[1]
        assert "BuildState" in lines[2]
        assert lines[2].index("BuildState") > lines[1].index("Reconcile")

    def test_selftest_passes(self):
        assert "ok" in tracing.selftest()



class TestLogInjection:
    def test_filter_stamps_trace_and_span_ids(self):
        tracer = tracing.Tracer()
        filt = tracing.TraceContextFilter(tracer)
        record = logging.LogRecord("x", logging.INFO, __file__, 1, "m", (), None)
        filt.filter(record)
        assert record.trace_id == "-" and record.span_id == "-"
        with tracer.start_span("spanful") as span:
            record2 = logging.LogRecord(
                "x", logging.INFO, __file__, 1, "m", (), None
            )
            filt.filter(record2)
            assert record2.trace_id == span.trace_id
            assert record2.span_id == span.span_id

    def test_install_on_logger_formats_trace_id(self):
        tracer = tracing.Tracer()
        prev = tracing.set_default_tracer(tracer)
        logger = logging.getLogger("test.trace.inject")
        import io

        stream = io.StringIO()
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter("%(trace_id)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        filt = tracing.install_trace_logging(logger)
        try:
            with tracing.start_span("logged") as span:
                logger.info("hello")
            assert stream.getvalue().startswith(span.trace_id)
        finally:
            logger.removeFilter(filt)
            logger.removeHandler(handler)
            tracing.set_default_tracer(prev)


def _traces_of(module):
    tracer = module.Tracer()
    with tracer.start_span("Reconcile", attributes={"nodes": 3}) as root:
        with tracer.start_span("BuildState"):
            pass
        with tracer.start_span("drain", attributes={"node": "n0"}):
            with tracer.start_span("checkpoint-drain"):
                pass
    return tracer.traces(), root


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("fmt", ["chrome", "otlp"])
def test_a_trace_exported_by_one_package_is_read_by_the_other(direction, fmt):
    source, sink = (jtracing, tracing) if direction == "jax-to-port" else (tracing, jtracing)
    traces, root = _traces_of(source)
    payload = json.loads(json.dumps(getattr(source, f"to_{fmt}")(traces)))
    back, same = sink.traces_from_payload(payload), source.traces_from_payload(payload)
    assert back == same
    assert back[0]["trace_id"] == root.trace_id
    assert sink.render_trace_tree(back[0]) == source.render_trace_tree(same[0])


def test_the_same_traces_export_to_the_same_payloads():
    traces, _ = _traces_of(jtracing)
    assert tracing.to_chrome(traces) == jtracing.to_chrome(traces)
    ours, theirs = tracing.to_otlp(traces), jtracing.to_otlp(traces)
    for payload in (ours, theirs):  # the instrumentation scope names the module
        for resource in payload["resourceSpans"]:
            for scope in resource["scopeSpans"]:
                scope["scope"]["name"] = "<module>"
    assert ours == theirs
    assert tracing.render_trace_tree(traces[0]) == jtracing.render_trace_tree(traces[0])


class TestEndToEndUpgradeTrace:
    """The acceptance test: a ≥3-node stub-cluster upgrade produces ONE
    trace spanning BuildState → per-node processing → drain → handshake →
    pod restart, exportable as Chrome JSON, with the trace ID surfaced
    as a drain_seconds exemplar."""

    @pytest.fixture(scope="class")
    def rollout(self):
        return _run_traced_rollout(nodes=3)

    def test_one_trace_spans_the_whole_pipeline(self, rollout):
        tracer, _, root = rollout
        trace = tracer.get_trace(root.trace_id)
        assert trace is not None and trace["complete"]
        names = {s["name"] for s in trace["spans"]}
        assert {
            "Upgrade",
            "BuildState",
            "ApplyState",
            "ProcessNodeState",
            "cordon",
            "drain",
            "drain-handshake",
            "checkpoint-drain",
            "pod-restart",
        } <= names, f"missing spans: {names}"
        # per-node coverage: every node got ProcessNodeState and drain spans
        for name in ("ProcessNodeState", "drain"):
            nodes_seen = {
                s["attributes"].get("node")
                for s in trace["spans"]
                if s["name"] == name
            }
            assert {"n0", "n1", "n2"} <= nodes_seen

    def test_handshake_child_carries_parent_trace_id(self, rollout):
        tracer, _, root = rollout
        trace = tracer.get_trace(root.trace_id)
        spans = {s["span_id"]: s for s in trace["spans"]}
        handshakes = [
            s for s in trace["spans"] if s["name"] == "checkpoint-drain"
        ]
        assert handshakes
        for span in handshakes:
            # crossed the annotation boundary, still the same trace…
            assert span["trace_id"] == root.trace_id
            # …and parented under the gate's wait span inside the drain
            parent = spans[span["parent_id"]]
            assert parent["name"] == "drain-handshake"
            grandparent = spans[parent["parent_id"]]
            assert grandparent["name"] == "drain"

    def test_drain_seconds_exemplar_carries_trace_id(self, rollout):
        _, registry, root = rollout
        exemplar = registry.histogram("drain_seconds", "x").exemplar()
        assert exemplar is not None
        labels, value, ts = exemplar
        assert labels == {"trace_id": root.trace_id}
        assert value >= 0 and ts > 0
        # the OpenMetrics rendering exposes it; the 0.0.4 one must not
        assert "# {trace_id=" in registry.render(openmetrics=True)
        assert "# {trace_id=" not in registry.render()
        reconcile_ex = registry.histogram(
            "reconcile_seconds", "x", ("phase",)
        ).exemplar("build")
        assert reconcile_ex is not None
        assert reconcile_ex[0]["trace_id"] == root.trace_id

    def test_debug_traces_endpoint_serves_chrome_json(self, rollout):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        tracer, registry, root = rollout
        srv = OpsServer(port=0, registry=registry, tracer=tracer).start()
        try:
            with urllib.request.urlopen(
                srv.url + "/debug/traces?fmt=chrome", timeout=5.0
            ) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == "application/json"
                chrome = json.loads(resp.read().decode())
            events = chrome["traceEvents"]
            assert events and all(
                e["ph"] == "X" and isinstance(e["ts"], (int, float))
                for e in events
            )
            assert {"BuildState", "drain", "checkpoint-drain"} <= {
                e["name"] for e in events
            }
            # default (OTLP-flavoured) + trace_id filter round trips
            with urllib.request.urlopen(
                srv.url + f"/debug/traces?trace_id={root.trace_id}",
                timeout=5.0,
            ) as resp:
                otlp = json.loads(resp.read().decode())
            back = tracing.traces_from_payload(otlp)
            assert len(back) == 1 and back[0]["trace_id"] == root.trace_id
        finally:
            srv.stop()


class TestQueueWaitSpans:
    def test_controller_reconcile_trace_includes_queue_wait(self, cluster):
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node
        from k8s_operator_libs_tpu_torch.controller import Controller

        tracer = tracing.Tracer()
        prev = tracing.set_default_tracer(tracer)

        class Noop:
            def reconcile(self, request):
                return None

        cluster.create(make_node("n1"))
        ctrl = Controller(cluster, Noop(), name="traced").watches("Node")
        try:
            ctrl.start()
            assert ctrl.wait_quiet(5.0)
        finally:
            ctrl.stop()
            tracing.set_default_tracer(prev)
        reconciles = [t for t in tracer.traces() if t["name"] == "Reconcile"]
        assert reconciles
        names = {s["name"] for s in reconciles[0]["spans"]}
        assert "queue-wait" in names
        root = next(
            s for s in reconciles[0]["spans"] if s["name"] == "Reconcile"
        )
        assert root["attributes"]["controller"] == "traced"
        assert root["attributes"]["queue_wait_s"] >= 0

    def test_workqueue_reports_wait(self):
        from k8s_operator_libs_tpu_torch.controller import WorkQueue

        q = WorkQueue()
        q.add("item")
        time.sleep(0.02)
        assert q.get(timeout=1.0) == "item"
        wait = q.queue_wait("item")
        assert wait is not None and wait >= 0.02
        q.done("item")
        assert q.queue_wait("item") is None
