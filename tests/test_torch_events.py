"""The port's decision-event log (k8s_operator_libs_tpu_torch/obs/
events.py) against the JAX package's obs/events.py.

* ``TestDecisionEventLog`` and ``TestClusterSink`` of
  ``tests/test_events.py``, as cases of the same names, run on the port;
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
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.obs import tracing

from test_torch_cluster import mask
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


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
