"""The port's metrics: primitives, exposition and the write-pipeline
series.

The classes ``TestCounter``, ``TestGauge``, ``TestHistogram``,
``TestRegistry``, ``TestWritePipelineMetrics``,
``TestWatchAndLeaderMetrics`` and ``TestStateMachineWiring`` of
``tests/test_metrics.py``, as cases of the same names, run on the port's
``metrics`` module, the last two through the port's ``LeaderElector``
and ``ClusterUpgradeStateManager``.  Then the parity half: the same seeded
sequence of counter, gauge and histogram calls, and every recording
helper of the module, give the same exposition text (Prometheus and
OpenMetrics) from the port as from the JAX package.  The metric names
keep the project's ``k8s_operator_libs_tpu_`` prefix on both sides, so
dashboards and alert rules read the same series.
"""

from __future__ import annotations

import inspect
import threading

import numpy as np
import pytest

from k8s_operator_libs_tpu import metrics as jmetrics
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from k8s_operator_libs_tpu_torch.upgrade import consts
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE


@pytest.fixture()
def cluster():
    return InMemoryCluster()


@pytest.fixture(autouse=True)
def fresh_registry():
    """Isolate every test behind its own default registry."""
    registry = MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    yield registry
    metrics.set_default_registry(previous)


class TestCounter:
    def test_inc_and_value(self):
        c = Counter("t_total", "help")
        c.inc()
        c.inc(amount=2.5)
        assert c.value() == 3.5

    def test_labeled_series_independent(self):
        c = Counter("t_total", "help", ("state",))
        c.inc("a")
        c.inc("a")
        c.inc("b")
        assert c.value("a") == 2
        assert c.value("b") == 1
        assert c.value("never") == 0

    def test_negative_rejected(self):
        c = Counter("t_total", "help")
        with pytest.raises(ValueError):
            c.inc(amount=-1)

    def test_label_arity_enforced(self):
        c = Counter("t_total", "help", ("state",))
        with pytest.raises(ValueError):
            c.inc()
        with pytest.raises(ValueError):
            c.inc("a", "b")

    def test_render(self):
        c = Counter("t_total", "help text", ("state",))
        c.inc("done")
        lines = c.render()
        assert "# HELP t_total help text" in lines
        assert "# TYPE t_total counter" in lines
        assert 't_total{state="done"} 1' in lines

    def test_thread_safety(self):
        c = Counter("t_total", "help")

        def worker():
            for _ in range(1000):
                c.inc()

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value() == 8000


class TestGauge:
    def test_set_inc_dec(self):
        g = Gauge("t", "help")
        g.set(5)
        g.inc()
        g.dec(amount=2)
        assert g.value() == 4

    def test_clear_drops_series(self):
        g = Gauge("t", "help", ("state",))
        g.set(3, "cordon-required")
        g.clear()
        assert 't{state="cordon-required"}' not in "\n".join(g.render())


class TestHistogram:
    def test_cumulative_buckets(self):
        h = Histogram("t_seconds", "help", buckets=(0.1, 1.0, 10.0))
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        h.observe(50.0)  # above every bound — only _count/+Inf sees it
        text = "\n".join(h.render())
        assert 't_seconds_bucket{le="0.1"} 1' in text
        assert 't_seconds_bucket{le="1"} 2' in text
        assert 't_seconds_bucket{le="10"} 3' in text
        assert 't_seconds_bucket{le="+Inf"} 4' in text
        assert "t_seconds_count 4" in text
        assert h.count() == 4
        assert h.sum() == pytest.approx(55.55)

    def test_labeled(self):
        h = Histogram("t_seconds", "help", ("phase",), buckets=(1.0,))
        h.observe(0.5, "build")
        h.observe(2.0, "apply")
        assert h.count("build") == 1
        assert h.count("apply") == 1
        assert h.count("other") == 0

    def test_explicit_inf_bucket_not_duplicated(self):
        h = Histogram("t_seconds", "help", buckets=(1.0, float("inf")))
        h.observe(0.5)
        text = "\n".join(h.render())
        assert text.count('le="+Inf"') == 1


class TestRegistry:
    def test_create_or_get_same_object(self, fresh_registry):
        a = fresh_registry.counter("x_total", "h")
        b = fresh_registry.counter("x_total", "h")
        assert a is b

    def test_type_conflict_rejected(self, fresh_registry):
        fresh_registry.counter("x_total", "h")
        with pytest.raises(ValueError):
            fresh_registry.gauge("x_total", "h")

    def test_label_conflict_rejected(self, fresh_registry):
        fresh_registry.counter("x_total", "h", ("a",))
        with pytest.raises(ValueError):
            fresh_registry.counter("x_total", "h", ("b",))

    def test_bucket_conflict_rejected(self, fresh_registry):
        fresh_registry.histogram("x_seconds", "h", buckets=(0.1, 1.0))
        with pytest.raises(ValueError):
            fresh_registry.histogram("x_seconds", "h", buckets=(5.0, 60.0))
        # same bounds (modulo the implicit +Inf) re-register fine
        again = fresh_registry.histogram(
            "x_seconds", "h", buckets=(1.0, 0.1, float("inf"))
        )
        assert again.buckets == (0.1, 1.0)

    def test_render_is_valid_exposition(self, fresh_registry):
        fresh_registry.counter("a_total", "ha").inc()
        fresh_registry.gauge("b", "hb").set(2)
        text = fresh_registry.render()
        assert text.endswith("\n")
        # every non-comment line is "name{labels} value"
        for line in text.strip().splitlines():
            if line.startswith("#"):
                continue
            name, _, value = line.rpartition(" ")
            assert name
            float(value)  # parses

    def test_swap_default_registry(self):
        mine = MetricsRegistry()
        prev = metrics.set_default_registry(mine)
        try:
            metrics.record_state_transition("upgrade-done")
            assert (
                mine.counter(
                    "upgrade_state_transitions_total", "", ("to_state",)
                ).value("upgrade-done")
                == 1
            )
        finally:
            metrics.set_default_registry(prev)


class TestWritePipelineMetrics:
    def test_dispatcher_exposes_pipeline_family(self, fresh_registry):
        """A real dispatcher run lands `write_queue_depth`,
        `http_inflight_writes` and `write_batch_size` in the /metrics
        exposition — the wiring, not just the registry helpers."""
        from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
        from k8s_operator_libs_tpu_torch.cluster.writepipeline import (
            WriteDispatcher,
            WriteOp,
        )

        store = InMemoryCluster()
        store.create(
            {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n0"}}
        )
        dispatcher = WriteDispatcher(store, max_workers=2, use_batch=False)
        try:
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name="n0",
                    body={"metadata": {"labels": {"k": "v"}}},
                )
            )
            dispatcher.flush()
        finally:
            dispatcher.close()
        out = fresh_registry.render()
        for family in (
            "k8s_operator_libs_tpu_write_queue_depth",
            "k8s_operator_libs_tpu_http_inflight_writes",
            "k8s_operator_libs_tpu_write_batch_size",
            "k8s_operator_libs_tpu_writes_coalesced_total",
        ):
            assert family in out, f"{family} missing from exposition"
        # the lone write rode exactly one batch of size 1
        assert (
            'k8s_operator_libs_tpu_write_batch_size_bucket{le="1"} 1' in out
        )


# ------------------------------------------------------------ JAX parity
@pytest.fixture()
def both_registries():
    """Fresh default registries on both sides, restored afterwards."""
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    prev_ours = metrics.set_default_registry(ours)
    prev_theirs = jmetrics.set_default_registry(theirs)
    yield ours, theirs
    metrics.set_default_registry(prev_ours)
    jmetrics.set_default_registry(prev_theirs)


def _render_both(ours, theirs):
    for openmetrics in (False, True):
        assert ours.render(openmetrics=openmetrics) == theirs.render(openmetrics=openmetrics)


@pytest.mark.parametrize("seed", range(4))
def test_primitive_calls_render_as_the_jax_module_renders(seed, both_registries):
    ours, theirs = both_registries
    rng = np.random.RandomState(seed)
    for reg in (ours, theirs):
        reg.counter("ops_total", "Ops.", ("verb",))
        reg.gauge("depth", "Queue depth.", ("queue",))
        reg.histogram("latency_seconds", "Latency.", ("verb",), buckets=(0.01, 0.1, 1.0))
    for _ in range(200):
        verb = ("get", "patch", 'we"ird\\n')[rng.randint(3)]
        roll, value = rng.randint(5), float(rng.randint(0, 2000)) / 1000.0
        for reg in (ours, theirs):
            if roll == 0:
                reg.counter("ops_total", "Ops.", ("verb",)).inc(verb, amount=value)
            elif roll == 1:
                reg.gauge("depth", "Queue depth.", ("queue",)).set(value, verb)
            elif roll == 2:
                reg.gauge("depth", "Queue depth.", ("queue",)).dec(verb, amount=value)
            else:
                reg.histogram("latency_seconds", "Latency.", ("verb",), buckets=(0.01, 0.1, 1.0)).observe(value, verb)
    _render_both(ours, theirs)


_ARGS = {"str": "drain", "float": 0.25, "int": 3}


def _helpers(module):
    """Public recording helpers whose required arguments are plain
    strings and numbers, with the arguments to call them with."""
    out = {}
    for name, fn in inspect.getmembers(module, inspect.isfunction):
        if fn.__module__ != module.__name__ or name.startswith("_"):
            continue
        if name in ("default_registry", "set_default_registry"):
            continue
        required = [p for p in inspect.signature(fn).parameters.values()
                    if p.default is inspect.Parameter.empty]
        if all(p.annotation in _ARGS for p in required):
            out[name] = tuple(_ARGS[p.annotation] for p in required)
    return out


def test_the_port_has_every_metrics_function():
    def public(module):
        return sorted(n for n, fn in inspect.getmembers(module, inspect.isfunction)
                      if fn.__module__ == module.__name__ and not n.startswith("_"))

    assert public(metrics) == public(jmetrics)


@pytest.mark.parametrize("helper", sorted(_helpers(jmetrics)))
def test_each_recording_helper_renders_as_the_jax_one(helper, both_registries):
    ours, theirs = both_registries
    args = _helpers(jmetrics)[helper]
    getattr(metrics, helper)(*args)
    getattr(jmetrics, helper)(*args)
    _render_both(ours, theirs)


class TestWatchAndLeaderMetrics:
    """Round-3 observability: watch-stream and leader-election metrics."""

    def test_watch_expired_counter(self, fresh_registry):
        from k8s_operator_libs_tpu_torch import metrics

        metrics.record_watch_expired("Node")
        metrics.record_watch_expired("Node")
        out = fresh_registry.render()
        assert (
            'watch_expirations_total{kind="Node"} 2' in out
        )

    def test_reconnect_counter_and_queue_gauge(self, fresh_registry):
        from k8s_operator_libs_tpu_torch import metrics

        metrics.record_watch_reconnect("Pod")
        metrics.set_held_queue_depth(7)
        out = fresh_registry.render()
        assert 'watch_stream_reconnects_total{kind="Pod"} 1' in out
        assert "held_watch_queue_depth 7" in out

    def test_leader_transitions_from_elector(self, fresh_registry):
        import time

        from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
        from k8s_operator_libs_tpu_torch.controller import LeaderElector

        cluster = InMemoryCluster()
        elector = LeaderElector(
            cluster,
            "bench-lock",
            "me",
            lease_duration=0.6,
            renew_deadline=0.4,
            retry_period=0.05,
        )
        elector.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not elector.is_leader:
            time.sleep(0.02)
        assert elector.is_leader
        elector.stop()
        out = fresh_registry.render()
        # >=1, not ==1: a loaded CI box can deadline-demote and
        # re-acquire mid-test; a voluntary stop records "released"
        assert 'leader_transitions_total{event="acquired"}' in out
        assert 'leader_transitions_total{event="released"} 1' in out


class TestStateMachineWiring:
    """Run a real rollout and assert the metrics land."""

    def test_rollout_records_everything(self, cluster, fresh_registry):
        fleet = Fleet(cluster, revision_hash="v1")
        for h in range(3):
            fleet.add_node(f"host{h}")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=30),
        )
        for _ in range(25):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            if all(
                s == consts.UPGRADE_STATE_DONE for s in fleet.states().values()
            ):
                break
        else:
            pytest.fail("rollout did not converge")
        # one settling reconcile so the gauges reflect the converged fleet
        manager.apply_state(manager.build_state(NAMESPACE, DRIVER_LABELS), policy)

        reg = fresh_registry
        transitions = reg.counter(
            "upgrade_state_transitions_total", "", ("to_state",)
        )
        assert transitions.value(consts.UPGRADE_STATE_DONE) == 3
        assert transitions.value(consts.UPGRADE_STATE_CORDON_REQUIRED) == 3
        drains = reg.counter("drains_total", "", ("result",))
        assert drains.value("ok") == 3
        assert reg.histogram("reconcile_seconds", "", ("phase",)).count("build") > 0
        assert reg.histogram("reconcile_seconds", "", ("phase",)).count("apply") > 0
        assert reg.gauge("upgrades_done", "").value() == 3
        assert reg.gauge("managed_nodes", "").value() == 3
        # steady state: the in-progress gauge has settled back to zero
        assert reg.gauge("upgrades_in_progress", "").value() == 0
        text = reg.render()
        assert "k8s_operator_libs_tpu_nodes_in_state" in text

    def test_paused_rollout_refreshes_gauges(self, cluster, fresh_registry):
        """auto_upgrade=false must not leave stale in-progress gauges
        frozen at their last active values (alerting would never clear)."""
        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        active = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=30),
        )
        # two reconciles: classify (unknown → upgrade-required), then admit
        for _ in range(2):
            manager.apply_state(
                manager.build_state(NAMESPACE, DRIVER_LABELS), active
            )
        reg = fresh_registry
        assert (
            reg.gauge("upgrades_in_progress", "").value()
            + reg.gauge("upgrades_pending", "").value()
            > 0
        )
        # ...then the operator pauses the rollout mid-flight.  Swap in a
        # brand-new registry first: any gauge present afterwards can only
        # have been published by the paused apply_state itself.
        paused = UpgradePolicySpec(auto_upgrade=False)
        paused_reg = MetricsRegistry()
        metrics.set_default_registry(paused_reg)
        try:
            manager.apply_state(
                manager.build_state(NAMESPACE, DRIVER_LABELS), paused
            )
        finally:
            metrics.set_default_registry(reg)
        # the paused branch re-published the whole gauge family from the
        # live snapshot — the node is still mid-upgrade and says so
        assert paused_reg.gauge("managed_nodes", "").value() == 1
        text = paused_reg.render()
        assert "nodes_in_state" in text
        assert (
            paused_reg.gauge("upgrades_in_progress", "").value()
            + paused_reg.gauge("upgrades_pending", "").value()
            > 0
        )

    def test_drain_failure_counted(self, cluster, fresh_registry):
        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        fleet.publish_new_revision("v2")
        # a bare pod (no controller) makes the drain plan error without force
        cluster.create(
            {
                "kind": "Pod",
                "metadata": {"name": "naked", "namespace": NAMESPACE},
                "spec": {"nodeName": "host0"},
                "status": {"phase": "Running"},
            }
        )
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=DrainSpec(enable=True, force=False, timeout_second=5),
        )
        for _ in range(10):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            if fleet.states().get("host0") == consts.UPGRADE_STATE_FAILED:
                break
        else:
            pytest.fail("drain never failed")
        assert (
            fresh_registry.counter("drains_total", "", ("result",)).value("failed")
            >= 1
        )
