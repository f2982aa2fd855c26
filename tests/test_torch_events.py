"""The port's decision-event log (k8s_operator_libs_tpu_torch/obs/
events.py) against the JAX package's obs/events.py.

* the classes of ``tests/test_events.py``, as cases of the same names,
  run on the port, the scheduler's and drain's emissions, ``explain``
  and the status integration through its ``ClusterUpgradeStateManager``
  (``TestOpsServerSurfaces`` and ``TestCli`` wait for the controller and
  the CLI);
* a differential test: one seeded stream of decisions goes to a log of
  each package and, pump by pump, through each package's
  :class:`ClusterDecisionEventSink` into its in-memory cluster.  The logs'
  views, the persisted Events and the stream read back from the cluster
  must agree after :func:`test_torch_vocab.to_port_vocab`, with the
  sink's random instance id and the store's uid and creation time masked.
"""

import time

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.obs import events as jevents
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, MaintenanceWindowSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.obs import tracing
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_cluster import mask
from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


def reconcile_once(manager, policy):
    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
    manager.apply_state(state, policy)
    manager.drain_manager.wait_idle(10.0)
    manager.pod_manager.wait_idle(10.0)
    return state


def throttled_policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def closed_window() -> MaintenanceWindowSpec:
    """A 1-hour window opening 6 hours from now — closed regardless of
    when the test runs."""
    from datetime import datetime, timedelta, timezone

    opens = datetime.now(timezone.utc) + timedelta(hours=6)
    return MaintenanceWindowSpec(
        start=f"{opens.hour:02d}:{opens.minute:02d}", duration_minutes=60
    )


class TestDecisionEventLog:
    def test_dedup_aggregates_with_count_and_advancing_seq(self):
        log = events_mod.DecisionEventLog()
        s1 = log.emit("NodeDeferred", "budget", "n0", "m1", now=10.0)
        s2 = log.emit("NodeDeferred", "budget", "n0", "m2", now=11.0)
        s3 = log.emit("NodeDeferred", "pacing", "n0", now=12.0)
        assert (s1, s2, s3) == (1, 2, 3)
        events = log.events()
        assert len(events) == 2  # (budget) aggregated, (pacing) separate
        budget = next(e for e in events if e["reason"] == "budget")
        assert budget["count"] == 2
        assert budget["seq"] == 2 and budget["firstSeq"] == 1
        assert budget["message"] == "m2"  # latest message wins
        assert budget["firstTimestamp"] == 10.0
        assert budget["lastTimestamp"] == 11.0

    def test_ring_bound_evicts_lru_and_counts_drops(self):
        log = events_mod.DecisionEventLog(capacity=2)
        log.emit("NodeDeferred", "budget", "n0")
        log.emit("NodeDeferred", "budget", "n1")
        log.emit("NodeDeferred", "budget", "n0")  # refresh n0
        log.emit("NodeDeferred", "budget", "n2")  # evicts n1 (LRU)
        targets = {e["target"] for e in log.events()}
        assert targets == {"n0", "n2"}
        assert log.dropped_events == 1

    def test_disabled_log_records_nothing(self):
        log = events_mod.DecisionEventLog(enabled=False)
        assert log.emit("NodeDeferred", "budget", "n0") is None
        assert log.events() == []

    def test_trace_id_captured_from_enclosing_span(self):
        log = events_mod.DecisionEventLog()
        with tracing.start_span("Reconcile") as span:
            log.emit("NodeAdmitted", "fresh", "n0")
        assert log.events()[0]["traceId"] == span.trace_id

    def test_snapshot_filters_and_limit(self):
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0")
        log.emit("NodeAdmitted", "fresh", "n1")
        log.emit("NodeDeferred", "canary", "n2")
        snap = log.snapshot(type_="NodeDeferred")
        assert [e["target"] for e in snap["events"]] == ["n0", "n2"]
        snap = log.snapshot(target="n1")
        assert [e["type"] for e in snap["events"]] == ["NodeAdmitted"]
        snap = log.snapshot(limit=1)
        assert len(snap["events"]) == 1
        assert snap["emitted"] == 3

    def test_drain_since_is_incremental(self):
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0")
        changed, cursor = log.drain_since(0)
        assert len(changed) == 1
        changed, cursor2 = log.drain_since(cursor)
        assert changed == [] and cursor2 == cursor
        log.emit("NodeDeferred", "budget", "n0")  # count advances
        changed, _ = log.drain_since(cursor)
        assert len(changed) == 1 and changed[0]["count"] == 2

    def test_emissions_count_into_metrics(self):
        registry = metrics.MetricsRegistry()
        prev = metrics.set_default_registry(registry)
        try:
            log = events_mod.DecisionEventLog()
            log.emit("NodeDeferred", "budget", "n0")
            log.emit("NodeDeferred", "budget", "n0")
            out = registry.render()
        finally:
            metrics.set_default_registry(prev)
        assert (
            'k8s_operator_libs_tpu_upgrade_events_total'
            '{type="NodeDeferred",reason="budget"} 2' in out
        )


class TestClusterSink:
    def test_pump_persists_and_is_o_changed(self, cluster):
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0", "slot budget exhausted")
        sink = events_mod.ClusterDecisionEventSink(cluster)
        assert sink.pump(log) == 1
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1
        ev = events[0]
        assert ev["reason"] == "NodeDeferred"
        assert ev["message"].startswith("[budget]")
        assert ev["involvedObject"]["name"] == "n0"
        assert ev["count"] == 1
        # quiet pump: nothing changed, nothing written
        assert sink.pump(log) == 0
        # a repeat patches count/lastTimestamp on the SAME object
        log.emit("NodeDeferred", "budget", "n0")
        assert sink.pump(log) == 1
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1 and events[0]["count"] == 2

    def test_offline_reconstruction_round_trip(self, cluster):
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0", "msg one")
        log.emit("BreakerTripped", "failure-budget", "fleet", "3/4 failed")
        events_mod.ClusterDecisionEventSink(cluster).pump(log)
        decisions = events_mod.decisions_from_cluster(cluster)
        assert [(d["type"], d["reason"], d["target"]) for d in decisions] == [
            ("NodeDeferred", "budget", "n0"),
            ("BreakerTripped", "failure-budget", "fleet"),
        ]
        assert decisions[0]["message"] == "msg one"

    def test_ttl_expired_event_is_recreated_on_next_pump(self, cluster):
        """A decision Event GC'd between pumps must not dead-end the
        stream: the count-advance patch 404s and the sink recreates the
        full Event."""
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0", "m")
        sink = events_mod.ClusterDecisionEventSink(cluster)
        sink.pump(log)
        name = cluster.list("Event", namespace="default")[0]["metadata"][
            "name"
        ]
        cluster.delete("Event", name, "default")  # the TTL GC's effect
        log.emit("NodeDeferred", "budget", "n0")
        assert sink.pump(log) == 1
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1 and events[0]["count"] == 2

    def test_failed_create_does_not_poison_the_entry(self, cluster):
        """A transiently failed create clears the sink's written cache,
        so the next count advance re-creates instead of patching a name
        that never existed."""
        from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0", "m")
        sink = events_mod.ClusterDecisionEventSink(cluster)
        real_create = cluster.create
        cluster.create = lambda body: (_ for _ in ()).throw(
            ApiError("brownout")
        )
        try:
            assert sink.pump(log) == 0
        finally:
            cluster.create = real_create
        log.emit("NodeDeferred", "budget", "n0")
        assert sink.pump(log) == 1
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1 and events[0]["count"] == 2

    def test_one_shot_event_survives_transient_write_failure(self, cluster):
        """Edge-triggered decisions (a breaker trips ONCE) must not
        vanish from the persisted trail because one pump hit a
        transient apiserver error: the failed entry is retried on the
        next pump even though its count never advances again."""
        from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

        log = events_mod.DecisionEventLog()
        log.emit("BreakerTripped", "failure-budget", "fleet", "3/4 failed")
        sink = events_mod.ClusterDecisionEventSink(cluster)
        real_create = cluster.create
        cluster.create = lambda body: (_ for _ in ()).throw(
            ApiError("brownout")
        )
        try:
            assert sink.pump(log) == 0
        finally:
            cluster.create = real_create
        # NOTHING new emitted — the retry alone must persist the trip
        assert sink.pump(log) == 1
        decisions = events_mod.decisions_from_cluster(cluster)
        assert [d["type"] for d in decisions] == ["BreakerTripped"]

    def test_events_cli_strict_read_failure_exits_2(self, capsys):
        class DownCluster:
            def list(self, *a, **k):
                from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

                raise ApiError("connection refused")

        from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

        with pytest.raises(ApiError):
            events_mod.decisions_from_cluster(DownCluster(), strict=True)
        # non-strict (status / explain decoration) degrades to empty
        assert events_mod.decisions_from_cluster(DownCluster()) == []

    def test_one_shot_event_survives_batch_transport_failure(self, cluster):
        """The batch write path raising WHOLESALE (connection reset —
        no per-item results) must not lose edge-triggered decisions
        either: _written rolls back so the retry actually writes."""
        from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

        log = events_mod.DecisionEventLog()
        log.emit("BreakerTripped", "failure-budget", "fleet", "3/4 failed")
        log.emit("RollbackStarted", "breaker", "fleet", "rev2 -> rev1")
        sink = events_mod.ClusterDecisionEventSink(cluster)

        def explode(*_a, **_k):
            raise ApiError("connection reset")

        real_apply = sink._apply
        sink._apply = explode
        try:
            assert sink.pump(log) == 0
        finally:
            sink._apply = real_apply
        assert sink.pump(log) == 2
        types = {
            d["type"] for d in events_mod.decisions_from_cluster(cluster)
        }
        assert types == {"BreakerTripped", "RollbackStarted"}

    def test_adopted_count_is_preserved_by_later_patches(self, cluster):
        """Restart adoption folds the previous process's count in; a
        later patch from the new process must build on that base, not
        regress the persisted count to its local one."""
        old = events_mod.DecisionEventLog()
        for _ in range(5):
            old.emit("NodeDeferred", "budget", "n1", now=1000.0)
        events_mod.ClusterDecisionEventSink(cluster).pump(old)
        fresh = events_mod.DecisionEventLog()  # restarted process
        fresh.emit("NodeDeferred", "budget", "n1", now=2000.0)
        sink2 = events_mod.ClusterDecisionEventSink(cluster)
        sink2.pump(fresh)  # create -> AlreadyExists -> adopt: 5 + 1
        assert cluster.list("Event", namespace="default")[0]["count"] == 6
        fresh.emit("NodeDeferred", "budget", "n1", now=2001.0)
        sink2.pump(fresh)  # patch must write base(5) + local(2) = 7
        assert cluster.list("Event", namespace="default")[0]["count"] == 7

    def test_gc_sweep_racing_adopt_read_recreates_with_seq(self, cluster):
        """The Event-GC race: a restart adoption
        whose create conflicted can find the conflicting Event GONE by
        the time it reads it — the in-mem store's TTL sweep won the
        race.  The sink must degrade to a plain recreate that KEEPS the
        seq annotation (the offline ordering oracle) and counts only
        its own occurrences — never drop the entry, never double-count
        the swept history."""
        from k8s_operator_libs_tpu_torch.cluster.errors import NotFoundError

        old = events_mod.DecisionEventLog()
        for _ in range(5):
            old.emit("NodeDeferred", "budget", "n2", now=1000.0)
        events_mod.ClusterDecisionEventSink(cluster).pump(old)
        name = cluster.list("Event", namespace="default")[0]["metadata"][
            "name"
        ]

        fresh = events_mod.DecisionEventLog()  # restarted process
        fresh.emit("NodeDeferred", "budget", "n2", now=2000.0)
        sink2 = events_mod.ClusterDecisionEventSink(cluster)
        real_get = cluster.get

        def sweep_wins_get(kind, *args, **kwargs):
            if kind == "Event":
                # the TTL sweep collects the object between the failed
                # create and the adopt's read
                try:
                    cluster.delete("Event", name, "default")
                except NotFoundError:
                    pass
            return real_get(kind, *args, **kwargs)

        cluster.get = sweep_wins_get
        try:
            assert sink2.pump(fresh) == 1
        finally:
            cluster.get = real_get
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1
        ev = events[0]
        # our occurrences only — the swept history must not resurrect
        assert ev["count"] == 1
        annotations = ev["metadata"]["annotations"]
        assert annotations.get(events_mod.SEQ_ANNOTATION) == "1"
        assert annotations.get(events_mod.SRC_ANNOTATION) == fresh.instance
        # and later patches build on the recreated object, not a ghost
        fresh.emit("NodeDeferred", "budget", "n2", now=2001.0)
        assert sink2.pump(fresh) == 1
        assert cluster.list("Event", namespace="default")[0]["count"] == 2

    def test_gc_sweep_racing_adopt_patch_does_not_double_count(
        self, cluster
    ):
        """The sweep can also win between the adopt's READ and its
        merge patch: the patch 404s.  Recreating with the merged count
        would resurrect the swept history as a double count — the sink
        must recreate with its own occurrences only."""
        from k8s_operator_libs_tpu_torch.cluster.errors import NotFoundError

        old = events_mod.DecisionEventLog()
        for _ in range(5):
            old.emit("NodeDeferred", "budget", "n3", now=1000.0)
        events_mod.ClusterDecisionEventSink(cluster).pump(old)
        name = cluster.list("Event", namespace="default")[0]["metadata"][
            "name"
        ]

        fresh = events_mod.DecisionEventLog()
        fresh.emit("NodeDeferred", "budget", "n3", now=2000.0)
        sink2 = events_mod.ClusterDecisionEventSink(cluster)
        real_patch = cluster.patch

        def sweep_wins_patch(kind, *args, **kwargs):
            if kind == "Event":
                try:
                    cluster.delete("Event", name, "default")
                except NotFoundError:
                    pass
            return real_patch(kind, *args, **kwargs)

        cluster.patch = sweep_wins_patch
        try:
            assert sink2.pump(fresh) == 1
        finally:
            cluster.patch = real_patch
        events = cluster.list("Event", namespace="default")
        assert len(events) == 1
        assert events[0]["count"] == 1, (
            "the swept history double-counted through the recreate"
        )
        assert events[0]["metadata"]["annotations"].get(
            events_mod.SEQ_ANNOTATION
        )

    def test_transient_adopt_failure_parks_entry_for_retry(self, cluster):
        """An adoption that fails TRANSIENTLY (the read 500s) must park
        the entry for the next pump like any other failed write — the
        previous behavior dropped it, and an edge-triggered decision
        (deduped into an existing Event name) would be lost for good."""
        from k8s_operator_libs_tpu_torch.cluster.errors import ApiError

        old = events_mod.DecisionEventLog()
        old.emit("BreakerTripped", "failure-budget", "fleet", now=1000.0)
        events_mod.ClusterDecisionEventSink(cluster).pump(old)

        fresh = events_mod.DecisionEventLog()  # restarted process
        fresh.emit("BreakerTripped", "failure-budget", "fleet", now=2000.0)
        sink2 = events_mod.ClusterDecisionEventSink(cluster)
        real_get = cluster.get

        def down_get(kind, *args, **kwargs):
            if kind == "Event":
                raise ApiError("etcd leader election")
            return real_get(kind, *args, **kwargs)

        cluster.get = down_get
        try:
            assert sink2.pump(fresh) == 0
        finally:
            cluster.get = real_get
        # NOTHING new emitted — the parked retry alone must land the
        # adoption (old 1 + ours 1)
        assert sink2.pump(fresh) == 1
        assert cluster.list("Event", namespace="default")[0]["count"] == 2

    def test_offline_order_survives_operator_restart(self, cluster):
        """The per-process sequence restarts at 0; the reconstruction
        orders by timestamp FIRST so a restarted operator's fresh
        decisions never sort before the previous process's."""
        old = events_mod.DecisionEventLog()
        for _ in range(5):
            old.emit("NodeDeferred", "budget", "n0", now=1000.0)
        sink = events_mod.ClusterDecisionEventSink(cluster)
        sink.pump(old)  # seq 5 persisted, timestamp t=1000
        fresh = events_mod.DecisionEventLog()  # the restarted process
        fresh.emit("BreakerTripped", "failure-budget", "fleet", now=2000.0)
        events_mod.ClusterDecisionEventSink(cluster).pump(fresh)  # seq 1
        decisions = events_mod.decisions_from_cluster(cluster)
        assert [d["type"] for d in decisions] == [
            "NodeDeferred",
            "BreakerTripped",
        ]

    def test_foreign_events_are_ignored(self, cluster):
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "kubelet-noise", "namespace": "default"},
                "involvedObject": {"kind": "Node", "name": "n0"},
                "reason": "NodeHasSufficientMemory",
                "message": "status is now: NodeHasSufficientMemory",
            }
        )
        assert events_mod.decisions_from_cluster(cluster) == []

    def test_event_ttl_gc(self):
        cluster = InMemoryCluster(event_ttl_seconds=3600.0)
        log = events_mod.DecisionEventLog()
        log.emit("NodeDeferred", "budget", "n0", now=time.time())
        events_mod.ClusterDecisionEventSink(cluster).pump(log)
        assert len(cluster.list("Event", namespace="default")) == 1
        # within TTL: kept
        assert cluster.gc_events(now=time.time() + 1800) == 0
        # past TTL: collected, and the deletion is journaled
        head = cluster.journal_seq()
        assert cluster.gc_events(now=time.time() + 7200) == 1
        assert cluster.list("Event", namespace="default") == []
        assert cluster.journal_seq() > head

    def test_ttl_zero_disables_gc(self):
        cluster = InMemoryCluster(event_ttl_seconds=0.0)
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "old", "namespace": "default"},
                "lastTimestamp": "2000-01-01T00:00:00Z",
            }
        )
        assert cluster.gc_events() == 0
        assert len(cluster.list("Event", namespace="default")) == 1

    def test_opportunistic_gc_on_event_create(self):
        cluster = InMemoryCluster(event_ttl_seconds=10.0)
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "ancient", "namespace": "default"},
                "lastTimestamp": "2000-01-01T00:00:00Z",
            }
        )
        # the rate limiter has never run: the next Event write sweeps
        cluster._last_event_gc = 0.0
        cluster.create(
            {
                "kind": "Event",
                "metadata": {"name": "fresh", "namespace": "default"},
                "lastTimestamp": events_mod.ClusterDecisionEventSink._iso(
                    time.time()
                ),
            }
        )
        names = {
            e["metadata"]["name"]
            for e in cluster.list("Event", namespace="default")
        }
        assert names == {"fresh"}


def _decisions(seed: int, n: int = 120):
    rng = np.random.RandomState(seed)
    kinds = (
        ("NodeDeferred", "budget"), ("NodeDeferred", "pacing"), ("NodeAdmitted", "fresh"),
        ("NodeAdmitted", "bypass"), ("BreakerTripped", "failure-budget"), ("NodeQuarantined", "quarantine"),
    )
    for i in range(n):
        type_, reason = kinds[rng.randint(len(kinds))]
        target = "fleet" if type_ == "BreakerTripped" else f"gpu-node-{rng.randint(12):02d}"
        yield type_, reason, target, f"m{rng.randint(3)}", 1_780_000_000.0 + i


def _masked_src(tree, key):
    if isinstance(tree, dict):
        return {k: ("<src>" if k == key else _masked_src(v, key)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_masked_src(v, key) for v in tree]
    return tree


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [8, 4096])
def test_the_log_and_the_sink_act_as_the_jax_ones(seed, capacity):
    jlog, log = jevents.DecisionEventLog(capacity=capacity), events_mod.DecisionEventLog(capacity=capacity)
    jstore, store = JaxInMemoryCluster(), InMemoryCluster()
    jsink, sink = jevents.ClusterDecisionEventSink(jstore), events_mod.ClusterDecisionEventSink(store)
    for i, (type_, reason, target, message, now) in enumerate(_decisions(seed)):
        assert log.emit(type_, reason, target, message, now=now) == jlog.emit(
            type_, reason, target, message, now=now
        )
        if i % 30 == 29:
            assert sink.pump(log) == jsink.pump(jlog)
            ours = _masked_src(mask(store.to_dict()), events_mod.SRC_ANNOTATION)
            theirs = _masked_src(mask(to_port_vocab(jstore.to_dict())), events_mod.SRC_ANNOTATION)
            assert ours == theirs, i
    assert log.dropped_events == jlog.dropped_events
    assert log.events() == to_port_vocab(jlog.events())
    for query in ({}, {"type_": "NodeDeferred"}, {"target": "fleet"}, {"limit": 5}):
        assert log.snapshot(**query) == to_port_vocab(jlog.snapshot(**query))
    assert log.drain_since(7) == to_port_vocab(jlog.drain_since(7))
    read_back = lambda decisions: [  # noqa: E731
        {k: v for k, v in d.items() if k != "src"} for d in decisions
    ]
    assert read_back(events_mod.decisions_from_cluster(store)) == to_port_vocab(
        read_back(jevents.decisions_from_cluster(jstore))
    )


def test_the_annotations_are_the_jax_ones_rewritten():
    assert events_mod.SEQ_ANNOTATION == to_port_vocab(jevents.SEQ_ANNOTATION) == "nvidia.com/decision-seq"
    assert events_mod.SRC_ANNOTATION == to_port_vocab(jevents.SRC_ANNOTATION) == "nvidia.com/decision-src"


# ------------------------------------------------------------ emission sites
class TestSchedulerEmissions:
    def make_fleet(self, cluster, n=3):
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(n):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        return fleet

    def test_admission_and_budget_deferral_and_wave(self, cluster):
        self.make_fleet(cluster)
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy()
            reconcile_once(manager, policy)  # classify
            reconcile_once(manager, policy)  # admit 1, defer 2
        finally:
            manager.shutdown()
        log = events_mod.default_log()
        admitted = log.events(type_="NodeAdmitted")
        assert len(admitted) == 1 and admitted[0]["reason"] == "fresh"
        deferred = log.events(type_="NodeDeferred")
        assert {e["reason"] for e in deferred} == {"budget"}
        assert len(deferred) == 2
        waves = log.events(type_="WavePlanned")
        assert waves and waves[0]["target"] == "fleet"

    def test_window_closed_defers_with_window_reason(self, cluster):
        self.make_fleet(cluster)
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy(maintenance_window=closed_window())
            reconcile_once(manager, policy)
            reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        deferred = events_mod.default_log().events(type_="NodeDeferred")
        assert deferred and {e["reason"] for e in deferred} == {"window"}

    def test_canary_hold_defers_with_canary_reason(self, cluster):
        self.make_fleet(cluster)
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy(canary_domains=1)
            policy.max_parallel_upgrades = 0
            reconcile_once(manager, policy)
            reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        reasons = {
            e["reason"]
            for e in events_mod.default_log().events(type_="NodeDeferred")
        }
        assert "canary" in reasons


class TestDrainEmissions:
    def test_drain_success_and_failure_emit(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("n0")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy()
            for _ in range(6):
                reconcile_once(manager, policy)
                fleet.reconcile_daemonset()
                if fleet.all_done():
                    break
        finally:
            manager.shutdown()
        drained = events_mod.default_log().events(type_="NodeDrained")
        assert [e["target"] for e in drained] == ["n0"]
        assert drained[0]["reason"] == "ok"


# ------------------------------------------------------------------ explain
class TestExplain:
    def deferred_fleet(self, cluster, policy=None):
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(3):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = policy or throttled_policy()
            reconcile_once(manager, policy)
            state = reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        return fleet, state, policy

    def test_deferred_node_names_its_reason(self, cluster):
        _fleet, state, policy = self.deferred_fleet(cluster)
        decisions = events_mod.default_log().events()
        deferred = [
            d["target"]
            for d in decisions
            if d["type"] == "NodeDeferred" and d["reason"] == "budget"
        ]
        answer = events_mod.explain_node(
            deferred[0], state, policy=policy, decisions=decisions
        )
        assert answer["verdict"] == "blocked"
        assert answer["reasonCode"] == "budget"
        assert answer["phase"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED

    def test_pending_without_stream_falls_back_to_gates(self, cluster):
        _fleet, state, policy = self.deferred_fleet(
            cluster, throttled_policy(maintenance_window=closed_window())
        )
        pending = [
            ns.node["metadata"]["name"]
            for ns in state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        answer = events_mod.explain_node(
            pending[0], state, policy=policy, decisions=None
        )
        assert answer["reasonCode"] == "window"
        assert answer["blockingGate"]["gate"] == "maintenanceWindow"

    def test_unknown_node_returns_none(self, cluster):
        _fleet, state, policy = self.deferred_fleet(cluster)
        assert (
            events_mod.explain_node("ghost", state, policy=policy) is None
        )

    def test_done_and_quarantined_and_failed_codes(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("done-0")
        fleet.add_node("quar-0")
        fleet.add_node("fail-0")
        state_key = util.get_upgrade_state_label_key()
        q_key = util.get_quarantine_annotation_key()
        for name, bucket in (
            ("done-0", consts.UPGRADE_STATE_DONE),
            ("quar-0", consts.UPGRADE_STATE_UPGRADE_REQUIRED),
            ("fail-0", consts.UPGRADE_STATE_FAILED),
        ):
            cluster.patch(
                "Node", name, {"metadata": {"labels": {state_key: bucket}}}
            )
        cluster.patch(
            "Node",
            "quar-0",
            {
                "metadata": {
                    "annotations": {
                        q_key: consts.REMEDIATION_QUARANTINE_PREFIX
                        + "node:quar-0"
                    }
                }
            },
        )
        manager = ClusterUpgradeStateManager(cluster)
        try:
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        finally:
            manager.shutdown()
        done = events_mod.explain_node("done-0", state)
        assert (done["verdict"], done["reasonCode"]) == ("complete", "done")
        quar = events_mod.explain_node("quar-0", state)
        assert quar["reasonCode"] == "quarantine"
        assert quar["quarantine"]["remediationOwned"] is True
        failed = events_mod.explain_node("fail-0", state)
        assert failed["verdict"] == "failed"


# -------------------------------------------------------- rollout_status
class TestRolloutStatusIntegration:
    def test_gate_cites_deferred_nodes_and_last_decisions_render(
        self, cluster
    ):
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(3):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy(maintenance_window=closed_window())
            reconcile_once(manager, policy)
            state = reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        decisions = events_mod.default_log().events()
        status = RolloutStatus.from_cluster_state(
            state, policy=policy, decisions=decisions
        )
        summary = status.summary()
        assert "GATED [maintenanceWindow]" in summary
        assert "defers 3 node(s), e.g. n0" in summary
        # the citation is scoped to STILL-pending nodes: a deferral
        # retained for a node that has since been admitted must not
        # inflate the count past the pending counter on the same line
        stale = decisions + [
            {
                "type": "NodeDeferred",
                "reason": "window",
                "target": "long-gone-node",
                "count": 9,
            }
        ]
        rescored = RolloutStatus.from_cluster_state(
            state, policy=policy, decisions=stale
        )
        assert "defers 3 node(s)" in rescored.summary()
        rendered = status.render()
        assert "defers 3 node(s)" in rendered
        assert "last decisions:" in rendered
        assert "NodeDeferred[window]" in rendered
        payload = status.to_dict()
        assert payload["decisions"]

    def test_without_stream_render_degrades_cleanly(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("n0")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy(maintenance_window=closed_window())
            reconcile_once(manager, policy)
            state = reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        assert "defers" not in status.summary()
        assert "last decisions:" not in status.render()
        assert "decisions" not in status.to_dict()


# ----------------------------------------------------- manager explain plane
class TestManagerSurface:
    def test_manager_explain_before_first_apply_is_none(self, cluster):
        manager = ClusterUpgradeStateManager(cluster)
        try:
            assert manager.explain_node("n0") is None
            assert manager.events_status()["events"] == []
        finally:
            manager.shutdown()

    def test_manager_explain_answers_after_apply(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(2):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(cluster)
        try:
            policy = throttled_policy()
            reconcile_once(manager, policy)
            reconcile_once(manager, policy)
            deferred = [
                d["target"]
                for d in events_mod.default_log().events(
                    type_="NodeDeferred"
                )
            ]
            answer = manager.explain_node(deferred[0])
            assert answer is not None
            assert answer["reasonCode"] == "budget"
        finally:
            manager.shutdown()
