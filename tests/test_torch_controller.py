"""The port's controller runtime (k8s_operator_libs_tpu_torch/controller/)
— workqueue contract, watch loop, backoff, relist, and the end-to-end
operator driving a rollout purely from events.

Every class of ``tests/test_controller.py``, as cases of the same names,
on the port's cluster and harness (``tests/test_torch_harness.py``), in
the port's vocabulary (``GpuUpgradePolicy``)."""

from __future__ import annotations

import threading
import time

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.controller import (
    Controller,
    ExponentialBackoffRateLimiter,
    RateLimitedQueue,
    Result,
    ShutDown,
    WorkQueue,
    new_upgrade_controller,
)
from k8s_operator_libs_tpu_torch.upgrade import consts
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import (
    DRIVER_LABELS,
    NAMESPACE,
    Fleet,
    daemonset_loop,
    wait_for_converged,
)
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


class TestWorkQueue:
    def test_fifo(self):
        q = WorkQueue()
        q.add("a")
        q.add("b")
        assert q.get(0.1) == "a"
        assert q.get(0.1) == "b"

    def test_dedup_while_queued(self):
        q = WorkQueue()
        q.add("a")
        q.add("a")
        q.add("a")
        assert len(q) == 1
        assert q.get(0.1) == "a"
        q.done("a")
        assert q.get(0.05) is None

    def test_coalesce_while_processing(self):
        """An add during processing re-queues exactly once at done()."""
        q = WorkQueue()
        q.add("a")
        item = q.get(0.1)
        q.add("a")  # racing change
        q.add("a")  # coalesces with the one above
        assert len(q) == 0  # not queued yet — still processing
        q.done(item)
        assert len(q) == 1
        assert q.get(0.1) == "a"
        q.done("a")
        assert q.get(0.05) is None

    def test_get_blocks_until_add(self):
        q = WorkQueue()
        got = []

        def consumer():
            got.append(q.get(2.0))

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        q.add("x")
        t.join(2.0)
        assert got == ["x"]

    def test_shutdown_raises_for_waiters(self):
        q = WorkQueue()
        q.shutdown()
        with pytest.raises(ShutDown):
            q.get(0.1)

    def test_add_after_shutdown_dropped(self):
        q = WorkQueue()
        q.shutdown()
        q.add("a")
        assert len(q) == 0

    def test_queue_is_deque_backed(self):
        """Regression pin for the O(n) pop: get() must pop from a deque
        head, not a list (list.pop(0) made a fleet-sized burst cost
        O(n²) in the queue alone)."""
        from collections import deque

        q = WorkQueue()
        assert isinstance(q._queue, deque)
        for i in range(100):
            q.add(i)
        assert [q.get(0.1) for _ in range(100)] == list(range(100))

    def test_drain_pops_enqueue_bookkeeping(self):
        """Every drained item drops its enqueue stamp; done() drops the
        wait attribution — nothing accumulates across the lifecycle."""
        q = WorkQueue()
        for i in range(5):
            q.add(i)
        for _ in range(5):
            item = q.get(0.1)
            assert item not in q._enqueued_at
            assert q.queue_wait(item) is not None
            q.done(item)
            assert item not in q._last_wait
        assert q._enqueued_at == {}
        assert q._last_wait == {}

    def test_shutdown_clears_bookkeeping_for_queued_items(self):
        """shutdown() with items still queued must not pin their
        metadata forever — queued items stay drainable, but enqueue
        stamps, dirty marks, the delay heap, and the limiter's failure
        history are dropped."""
        q = RateLimitedQueue(ExponentialBackoffRateLimiter(base_delay=30.0))
        q.add("queued-1")
        q.add("queued-2")
        processing = q.get(0.1)  # "queued-1" now processing
        q.add(processing)  # dirty while processing
        q.add_after("delayed", 30.0)  # would fire long after shutdown
        q.add_rate_limited("failing")  # limiter failure history, 30s delay
        q.shutdown()
        assert q._enqueued_at == {}
        assert q._dirty == set()
        assert q._heap == []
        assert q.num_requeues("failing") == 0
        # drain semantics preserved: the still-queued item is handed
        # out, then ShutDown
        assert q.get(0.1) == "queued-2"
        q.done("queued-2")
        q.done(processing)
        with pytest.raises(ShutDown):
            q.get(0.1)


class TestRateLimiting:
    def test_backoff_doubles_and_caps(self):
        rl = ExponentialBackoffRateLimiter(base_delay=0.1, max_delay=0.5)
        assert rl.when("a") == pytest.approx(0.1)
        assert rl.when("a") == pytest.approx(0.2)
        assert rl.when("a") == pytest.approx(0.4)
        assert rl.when("a") == pytest.approx(0.5)  # capped
        assert rl.num_requeues("a") == 4
        rl.forget("a")
        assert rl.when("a") == pytest.approx(0.1)

    def test_per_item_isolation(self):
        rl = ExponentialBackoffRateLimiter(base_delay=0.1)
        rl.when("a")
        assert rl.when("b") == pytest.approx(0.1)

    def test_delayed_add_delivers_after_delay(self):
        q = RateLimitedQueue()
        started = time.monotonic()
        q.add_after("a", 0.15)
        assert q.get(0.05) is None  # not yet due
        item = q.get(2.0)
        assert item == "a"
        assert time.monotonic() - started >= 0.14
        q.shutdown()

    def test_rate_limited_adds_back_off(self):
        q = RateLimitedQueue(
            ExponentialBackoffRateLimiter(base_delay=0.05, max_delay=1.0)
        )
        q.add_rate_limited("a")  # ~0.05s
        assert q.get(2.0) == "a"
        q.done("a")
        started = time.monotonic()
        q.add_rate_limited("a")  # ~0.1s now
        assert q.get(2.0) == "a"
        assert time.monotonic() - started >= 0.09
        q.shutdown()


class _CountingReconciler:
    def __init__(self, fail_times: int = 0, result: Result | None = None):
        self.calls = []
        self.lock = threading.Lock()
        self.fail_times = fail_times
        self.result = result

    def reconcile(self, request):
        with self.lock:
            self.calls.append(request)
            if len(self.calls) <= self.fail_times:
                raise RuntimeError("boom")
        return self.result

    @property
    def count(self):
        with self.lock:
            return len(self.calls)


def _node(name, labels=None):
    return {
        "kind": "Node",
        "metadata": {"name": name, "labels": labels or {}},
        "spec": {},
        "status": {},
    }


class TestController:
    def test_event_triggers_reconcile(self):
        cluster = InMemoryCluster()
        rec = _CountingReconciler()
        ctrl = Controller(cluster, rec).watches("Node")
        ctrl.start()
        try:
            cluster.create(_node("n1"))
            deadline = time.monotonic() + 2.0
            while rec.count < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rec.count >= 1
        finally:
            ctrl.stop()

    def test_initial_list_enqueues_existing_objects(self):
        cluster = InMemoryCluster()
        cluster.create(_node("pre-existing"))
        rec = _CountingReconciler()
        ctrl = Controller(cluster, rec).watches("Node")
        ctrl.start()
        try:
            assert ctrl.wait_quiet(2.0)
            assert any(r.name == "pre-existing" for r in rec.calls)
        finally:
            ctrl.stop()

    def test_unwatched_kind_ignored(self):
        cluster = InMemoryCluster()
        rec = _CountingReconciler()
        ctrl = Controller(cluster, rec).watches("Node")
        ctrl.start()
        try:
            cluster.create({"kind": "Pod", "metadata": {"name": "p"}})
            assert ctrl.wait_quiet(1.0)
            assert rec.count == 0
        finally:
            ctrl.stop()

    def test_predicate_filters_events(self):
        cluster = InMemoryCluster()
        rec = _CountingReconciler()
        only_adds = lambda ev: ev.type == "Added"  # noqa: E731
        ctrl = Controller(cluster, rec).watches("Node", predicate=only_adds)
        ctrl.start()
        try:
            cluster.create(_node("n1"))
            assert ctrl.wait_quiet(2.0)
            adds = rec.count
            assert adds >= 1
            cluster.patch("Node", "n1", {"metadata": {"labels": {"x": "y"}}})
            assert ctrl.wait_quiet(2.0)
            assert rec.count == adds  # Modified filtered out
        finally:
            ctrl.stop()

    def test_failure_retried_with_backoff_then_succeeds(self):
        cluster = InMemoryCluster()
        rec = _CountingReconciler(fail_times=3)
        ctrl = Controller(
            cluster,
            rec,
            queue=RateLimitedQueue(
                ExponentialBackoffRateLimiter(base_delay=0.01, max_delay=0.1)
            ),
        ).watches("Node")
        ctrl.start()
        try:
            cluster.create(_node("n1"))
            deadline = time.monotonic() + 5.0
            while rec.count < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rec.count == 4  # 3 failures + 1 success
        finally:
            ctrl.stop()

    def test_max_retries_drops_request(self):
        cluster = InMemoryCluster()
        rec = _CountingReconciler(fail_times=10**6)
        ctrl = Controller(
            cluster,
            rec,
            max_retries=2,
            queue=RateLimitedQueue(
                ExponentialBackoffRateLimiter(base_delay=0.01, max_delay=0.05)
            ),
        ).watches("Node")
        ctrl.start()
        try:
            cluster.create(_node("n1"))
            deadline = time.monotonic() + 5.0
            while not ctrl.dropped and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ctrl.dropped
            settled = rec.count
            time.sleep(0.2)
            assert rec.count == settled  # no further retries
        finally:
            ctrl.stop()

    def test_requeue_after_schedules_another_pass(self):
        cluster = InMemoryCluster()

        class Once:
            def __init__(self):
                self.calls = 0

            def reconcile(self, request):
                self.calls += 1
                if self.calls == 1:
                    return Result(requeue_after=0.05)
                return None

        rec = Once()
        ctrl = Controller(cluster, rec).watches("Node")
        ctrl.start()
        try:
            cluster.create(_node("n1"))
            deadline = time.monotonic() + 2.0
            while rec.calls < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rec.calls >= 2
        finally:
            ctrl.stop()

    def test_journal_expiry_triggers_relist(self):
        """Shrink the journal so the watcher's position expires; the
        controller must relist (not silently miss events)."""
        cluster = InMemoryCluster()
        cluster._journal_cap = 5  # tiny window
        rec = _CountingReconciler()
        ctrl = Controller(cluster, rec, watch_poll_seconds=0.2).watches("Node")
        ctrl.start()
        try:
            # Burst far past the journal cap while the watcher sleeps.
            for i in range(40):
                cluster.create(_node(f"n{i}"))
            deadline = time.monotonic() + 5.0
            names = set()
            while time.monotonic() < deadline:
                names = {r.name for r in rec.calls}
                if len(names) == 40:
                    break
                time.sleep(0.02)
            assert len(names) == 40, f"missed nodes: got {len(names)}"
        finally:
            ctrl.stop()

    def test_watch_survives_raising_mapper(self):
        """A user mapper raising on one event must not kill the watch
        thread — later events still reconcile."""
        cluster = InMemoryCluster()
        rec = _CountingReconciler()

        def flaky_mapper(obj):
            if obj["metadata"]["name"] == "poison":
                raise ValueError("unexpected shape")
            return [obj["metadata"]["name"]]

        ctrl = Controller(cluster, rec).watches("Node", mapper=flaky_mapper)
        ctrl.start()
        try:
            cluster.create(_node("poison"))
            cluster.create(_node("good"))
            deadline = time.monotonic() + 2.0
            while "good" not in rec.calls and time.monotonic() < deadline:
                time.sleep(0.01)
            assert "good" in rec.calls
            assert "poison" not in rec.calls
        finally:
            ctrl.stop()

    def test_wait_quiet_sees_in_flight_and_delayed_work(self):
        """pending_work must count items being processed and items in the
        delay heap, not just the queued list."""
        q = RateLimitedQueue()
        q.add("a")
        item = q.get(0.5)
        assert len(q) == 0
        assert q.pending_work() == 1  # processing
        q.done(item)
        q.add_after("b", 10.0)
        assert len(q) == 0
        assert q.pending_work() == 1  # delayed
        q.shutdown()

    def test_burst_collapses_onto_busy_reconciler(self):
        """Dedup-while-processing: many events during a slow reconcile
        cost exactly one follow-up pass."""
        cluster = InMemoryCluster()
        gate = threading.Event()

        class Slow:
            def __init__(self):
                self.calls = 0

            def reconcile(self, request):
                self.calls += 1
                if self.calls == 1:
                    gate.wait(5.0)
                return None

        rec = Slow()
        ctrl = Controller(
            cluster, rec, watch_poll_seconds=0.002
        ).watches("Node", mapper=lambda obj: ["all"])
        ctrl.start()
        try:
            cluster.create(_node("n0"))
            deadline = time.monotonic() + 2.0
            while rec.calls < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert rec.calls == 1
            for i in range(1, 20):
                cluster.create(_node(f"n{i}"))
            time.sleep(0.1)  # let the watcher enqueue all 19 events
            gate.set()
            assert ctrl.wait_quiet(2.0)
            # 1 slow pass + exactly 1 coalesced follow-up
            assert rec.calls == 2
        finally:
            ctrl.stop()


class TestUpgradeOperator:
    """The L5 consumer assembled from this runtime: a rollout driven
    entirely by watch events + requeue, no manual reconcile loop."""

    def test_event_driven_rollout_converges(self, cluster):
        fleet = Fleet(cluster, revision_hash="v1")
        for s in range(2):
            for h in range(2):
                fleet.add_node(
                    f"slice{s}-host{h}",
                    labels={consts.SLICE_ID_LABEL_KEYS[0]: f"slice-{s}"},
                )
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("50%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=30),
        )
        ctrl = new_upgrade_controller(
            cluster, manager, NAMESPACE, DRIVER_LABELS, policy,
            resync_seconds=0.1, active_requeue_seconds=0.02,
        )
        # the simulated DaemonSet controller restarts deleted driver pods
        with daemonset_loop(fleet):
            ctrl.start()
            try:
                assert wait_for_converged(fleet), (
                    f"rollout did not converge: {fleet.states()}"
                )
            finally:
                ctrl.stop()

    def test_steady_fleet_goes_quiet(self, cluster):
        """No rollout pending — the reconciler must not self-requeue
        forever (hot-loop guard)."""
        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(enable=True, force=True),
        )
        rec_calls = []
        ctrl = new_upgrade_controller(
            cluster, manager, NAMESPACE, DRIVER_LABELS, policy,
            resync_seconds=0.0,  # no resync: only events drive it
        )
        original = ctrl._reconciler.reconcile

        def counting(request):
            rec_calls.append(time.monotonic())
            return original(request)

        ctrl._reconciler = type(
            "R", (), {"reconcile": staticmethod(counting)}
        )()
        ctrl.start()
        try:
            assert ctrl.wait_quiet(5.0)
            settled = len(rec_calls)
            time.sleep(0.3)
            # pod at current revision, nothing to do: no self-requeue churn
            assert len(rec_calls) == settled
        finally:
            ctrl.stop()


class TestCrDrivenPolicy:
    """The operator driven entirely by a GpuUpgradePolicy CR: edits apply
    live, deletion pauses, invalid specs keep the last good policy."""

    POLICY = {
        "kind": "GpuUpgradePolicy",
        "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
        "spec": {
            "autoUpgrade": False,
            "maxParallelUpgrades": 0,
            "maxUnavailable": "100%",
            "drain": {"enable": True, "force": True, "timeoutSeconds": 10},
        },
    }

    def _boot(self, cluster):
        from k8s_operator_libs_tpu_torch.controller import (
            CrPolicySource,
            new_upgrade_controller,
        )

        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        source = CrPolicySource(cluster, "fleet-policy", NAMESPACE)
        ctrl = new_upgrade_controller(
            cluster,
            manager,
            NAMESPACE,
            DRIVER_LABELS,
            policy_source=source,
            resync_seconds=0.1,
            active_requeue_seconds=0.02,
        )
        return ctrl, source

    def test_cr_enable_starts_and_edit_applies_live(self, cluster):
        import copy as _copy

        fleet = Fleet(cluster)
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        cluster.create(_copy.deepcopy(self.POLICY))
        ctrl, _ = self._boot(cluster)
        with daemonset_loop(fleet):
            ctrl.start()
            try:
                time.sleep(0.3)  # paused: autoUpgrade=False
                assert fleet.node_state("n1") in (
                    "",
                    consts.UPGRADE_STATE_DONE,
                )
                # flip the switch on the live CR
                cluster.patch(
                    "GpuUpgradePolicy",
                    "fleet-policy",
                    {"spec": {"autoUpgrade": True}},
                    NAMESPACE,
                )
                assert wait_for_converged(fleet, timeout=20.0), fleet.states()
            finally:
                ctrl.stop()

    def test_cr_deleted_mid_rollout_pauses(self, cluster):
        import copy as _copy

        fleet = Fleet(cluster)
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        spec = _copy.deepcopy(self.POLICY)
        spec["spec"]["autoUpgrade"] = True
        # serialize: one node at a time so there is a mid-rollout window
        spec["spec"]["maxParallelUpgrades"] = 1
        spec["spec"]["maxUnavailable"] = 1
        cluster.create(spec)
        ctrl, _ = self._boot(cluster)
        with daemonset_loop(fleet):
            ctrl.start()
            try:
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    done = [
                        s
                        for s in fleet.states().values()
                        if s == consts.UPGRADE_STATE_DONE
                    ]
                    if 0 < len(done) < 4:
                        break
                    time.sleep(0.01)
                else:
                    pytest.fail("never observed a mid-rollout window")
                cluster.delete("GpuUpgradePolicy", "fleet-policy", NAMESPACE)
                time.sleep(0.5)  # the operator processes the deletion
                snapshot = fleet.states()
                time.sleep(0.5)
                # paused: no further progress after the settle window
                later = fleet.states()
                new_done = sum(
                    1
                    for n, s in later.items()
                    if s == consts.UPGRADE_STATE_DONE
                    and snapshot[n] != consts.UPGRADE_STATE_DONE
                )
                # nothing NEW reaches done after the pause settled, and
                # un-admitted nodes stay put
                assert new_done == 0, (snapshot, later)
                assert any(
                    s == consts.UPGRADE_STATE_UPGRADE_REQUIRED
                    for s in later.values()
                ), later
            finally:
                ctrl.stop()

    def test_invalid_edit_keeps_last_good(self, cluster):
        import copy as _copy

        from k8s_operator_libs_tpu_torch.controller import CrPolicySource

        spec = _copy.deepcopy(self.POLICY)
        spec["spec"]["autoUpgrade"] = True
        cluster.create(spec)
        source = CrPolicySource(cluster, "fleet-policy", NAMESPACE)
        good = source.current()
        assert good is not None and good.auto_upgrade
        cluster.patch(
            "GpuUpgradePolicy",
            "fleet-policy",
            {"spec": {"maxParallelUpgrades": -5}},
            NAMESPACE,
        )
        kept = source.current()
        assert kept is good  # invalid edit → last good retained
        assert kept.max_parallel_upgrades == 0

    def test_missing_cr_is_paused(self, cluster):
        from k8s_operator_libs_tpu_torch.controller import CrPolicySource

        source = CrPolicySource(cluster, "absent", NAMESPACE)
        assert source.current() is None

    def test_policy_xor_source_enforced(self, cluster):
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller

        manager = ClusterUpgradeStateManager(cluster)
        with pytest.raises(ValueError, match="exactly one"):
            new_upgrade_controller(
                cluster, manager, NAMESPACE, DRIVER_LABELS
            )

    def test_string_boolean_edit_rejected(self, cluster):
        """Regression: `autoUpgrade: "false"` (string, truthy) must be
        rejected by validate(), not accepted as an enabled policy."""
        import copy as _copy

        from k8s_operator_libs_tpu_torch.controller import CrPolicySource

        spec = _copy.deepcopy(self.POLICY)
        spec["spec"]["autoUpgrade"] = True
        cluster.create(spec)
        source = CrPolicySource(cluster, "fleet-policy", NAMESPACE)
        good = source.current()
        cluster.patch(
            "GpuUpgradePolicy",
            "fleet-policy",
            {"spec": {"autoUpgrade": "false"}},
            NAMESPACE,
        )
        assert source.current() is good  # invalid type → last good kept

    def test_bad_policy_source_fails_at_assembly(self, cluster):
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller

        manager = ClusterUpgradeStateManager(cluster)
        with pytest.raises(TypeError, match="current"):
            new_upgrade_controller(
                cluster,
                manager,
                NAMESPACE,
                DRIVER_LABELS,
                policy_source=UpgradePolicySpec(auto_upgrade=True),
            )


class TestOpsServer:
    """The controller-runtime manager's /metrics + /healthz + /readyz
    surface (SURVEY §1 L5: consumers get these from the manager; here
    OpsServer supplies them for the assembled operator)."""

    def _get(self, url):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                return resp.status, resp.read().decode(), dict(resp.headers)
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode(), dict(err.headers)

    def test_metrics_endpoint_serves_registry(self):
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        registry = metrics.MetricsRegistry()
        registry.counter("ops_test_total", "test counter").inc()
        srv = OpsServer(port=0, registry=registry).start()
        try:
            status, body, headers = self._get(srv.url + "/metrics")
            assert status == 200
            assert "0.0.4" in headers.get("Content-Type", "")
            assert "ops_test_total 1" in body
        finally:
            srv.stop()

    def test_metrics_default_registry(self):
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        registry = metrics.MetricsRegistry()
        prev = metrics.set_default_registry(registry)
        srv = OpsServer(port=0).start()
        try:
            registry.gauge("ops_default_gauge", "g").set(7)
            status, body, _ = self._get(srv.url + "/metrics")
            assert status == 200
            assert "ops_default_gauge 7" in body
        finally:
            srv.stop()
            metrics.set_default_registry(prev)

    def test_healthz_and_readyz_pass_and_fail(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        try:
            # no checks registered: vacuously healthy/ready
            for path in ("/healthz", "/readyz"):
                status, body, _ = self._get(srv.url + path)
                assert status == 200
                assert body.strip().endswith("ok")

            srv.add_health_check("alive", lambda: True)
            srv.add_ready_check("leading", lambda: False)
            status, body, _ = self._get(srv.url + "/healthz")
            assert status == 200
            assert "[+] alive" in body
            status, body, _ = self._get(srv.url + "/readyz")
            assert status == 500
            assert "[-] leading" in body and body.strip().endswith("failed")
        finally:
            srv.stop()

    def test_raising_check_fails_probe_with_reason(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        try:
            def boom():
                raise RuntimeError("cache not synced")

            srv.add_ready_check("informer", boom)
            status, body, _ = self._get(srv.url + "/readyz")
            assert status == 500
            assert "[-] informer: cache not synced" in body
        finally:
            srv.stop()

    def test_unknown_path_404(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        try:
            status, _, _ = self._get(srv.url + "/nope")
            assert status == 404
        finally:
            srv.stop()

    def _head(self, url):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as err:
            return err.code, err.read(), dict(err.headers)

    def test_head_answers_without_body(self):
        """Probe fleets that HEAD before GET must see the real status and
        headers with an empty body — not http.server's default 501."""
        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        registry = metrics.MetricsRegistry()
        registry.counter("head_probe_total", "c").inc()
        srv = OpsServer(port=0, registry=registry).start()
        try:
            status, body, headers = self._head(srv.url + "/metrics")
            assert status == 200
            assert body == b""
            # Content-Length still advertises the (non-empty) GET body size
            assert int(headers["Content-Length"]) > 0
            status, body, _ = self._head(srv.url + "/healthz")
            assert status == 200 and body == b""
            # regression: unknown paths answer 404 for HEAD too — no
            # 500, no hang
            status, body, _ = self._head(srv.url + "/nope")
            assert status == 404 and body == b""
        finally:
            srv.stop()

    def test_metrics_openmetrics_negotiation(self):
        """Accept: application/openmetrics-text switches to the
        OpenMetrics rendering (exemplar-capable, # EOF terminated);
        plain scrapes keep the 0.0.4 exposition."""
        import urllib.request

        from k8s_operator_libs_tpu_torch import metrics
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        registry = metrics.MetricsRegistry()
        registry.histogram("om_seconds", "h").observe(
            0.2, exemplar={"trace_id": "abc123"}
        )
        srv = OpsServer(port=0, registry=registry).start()
        try:
            status, body, headers = self._get(srv.url + "/metrics")
            assert status == 200
            assert "0.0.4" in headers.get("Content-Type", "")
            assert "# EOF" not in body and "trace_id" not in body
            req = urllib.request.Request(
                srv.url + "/metrics",
                headers={"Accept": "application/openmetrics-text"},
            )
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                om_type = resp.headers.get("Content-Type", "")
                om_body = resp.read().decode()
            assert "openmetrics-text" in om_type
            assert om_body.rstrip().endswith("# EOF")
            assert '# {trace_id="abc123"} 0.2' in om_body
        finally:
            srv.stop()

    def test_debug_traces_bad_fmt_400(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer
        from k8s_operator_libs_tpu_torch.obs import tracing

        srv = OpsServer(port=0, tracer=tracing.Tracer()).start()
        try:
            status, body, _ = self._get(srv.url + "/debug/traces?fmt=wat")
            assert status == 400 and "unknown fmt" in body
            status, body, _ = self._get(srv.url + "/debug/traces")
            assert status == 200
            import json as _json

            assert _json.loads(body)["resourceSpans"]
        finally:
            srv.stop()

    def test_stop_is_idempotent_and_restart_refused(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        srv.stop()
        srv.stop()  # no raise
        srv2 = OpsServer(port=0).start()
        try:
            with pytest.raises(RuntimeError, match="already started"):
                srv2.start()
        finally:
            srv2.stop()

    def test_running_probe_tracks_lifecycle(self):
        """Controller.running() is the /healthz liveness source: False
        before start, True while the threads run, False after stop."""
        cluster = InMemoryCluster()
        ctrl = Controller(cluster, _CountingReconciler()).watches("Node")
        assert not ctrl.running()
        ctrl.start()
        try:
            assert ctrl.running()
        finally:
            ctrl.stop()
        assert not ctrl.running()


class TestAdmissionWaveCadence:
    """A pass that just admitted a wave snapshots as
    pending-with-nothing-in-flight; the reconciler must requeue at the
    ACTIVE cadence (work is now in flight), not the gated one — a
    watch-less/poll-only assembly otherwise pays ~5 s per wave."""

    def test_admission_pass_requeues_at_active_cadence(self, cluster):
        from k8s_operator_libs_tpu_torch.controller.upgrade_reconciler import (
            UpgradeReconciler,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        for h in range(2):
            fleet.add_node(f"host{h}")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        rec = UpgradeReconciler(
            manager=manager,
            namespace=NAMESPACE,
            driver_labels=DRIVER_LABELS,
            policy=UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                drain_spec=DrainSpec(enable=True, force=True),
            ),
            active_requeue_seconds=0.02,
            gated_requeue_seconds=5.0,
        )
        result = rec.reconcile("upgrade-cycle")
        # the first pass ADMITS host(s): transitions occurred, so the
        # requeue must be the active cadence even though the snapshot
        # still classified everything as pending
        assert manager.last_apply_transitions > 0
        assert result is not None
        assert result.requeue_after == pytest.approx(0.02)

    def test_gated_pass_keeps_gated_cadence(self, cluster):
        """A genuinely gated pass (admissions blocked by a closed
        maintenance window) performs no transitions and stays on the
        gated cadence — the hot-loop guard is not regressed.  The FIRST
        pass still classifies fresh nodes (transitions → active cadence,
        correct); the SECOND is the steady gated state."""
        import datetime as _dt

        from k8s_operator_libs_tpu_torch.api.upgrade_spec import MaintenanceWindowSpec
        from k8s_operator_libs_tpu_torch.controller.upgrade_reconciler import (
            UpgradeReconciler,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        # a 1-hour window starting 6 h from now (UTC): closed for the
        # whole test no matter when it runs
        start = (
            _dt.datetime.now(_dt.timezone.utc) + _dt.timedelta(hours=6)
        ).strftime("%H:00")
        rec = UpgradeReconciler(
            manager=manager,
            namespace=NAMESPACE,
            driver_labels=DRIVER_LABELS,
            policy=UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                maintenance_window=MaintenanceWindowSpec(
                    start=start, duration_minutes=60
                ),
                drain_spec=DrainSpec(enable=True, force=True),
            ),
            active_requeue_seconds=0.02,
            gated_requeue_seconds=5.0,
        )
        rec.reconcile("upgrade-cycle")  # classification pass
        result = rec.reconcile("upgrade-cycle")  # steady gated pass
        assert manager.last_apply_transitions == 0
        assert result is not None
        assert result.requeue_after == pytest.approx(5.0)


class TestInformerTee:
    """Controller(event_sink/relist_sink) + InformerCache(externally_fed):
    the single-reflector rule — one watch consumer feeds both the cache
    and the workqueue."""

    def _reconciler(self):
        class R:
            def reconcile(self, request):
                return Result()

        return R()

    def test_drained_events_flow_into_cache_before_fanout(self):
        from k8s_operator_libs_tpu_torch.cluster import InformerCache
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node

        cluster = InMemoryCluster()
        cache = InformerCache(
            cluster, lag_seconds=5.0, kinds=("Node",), externally_fed=True
        )
        c = Controller(
            cluster,
            self._reconciler(),
            event_sink=cache.ingest,
            relist_sink=cache.sync,
            watch_poll_seconds=0.01,
        )
        c.watches("Node", mapper=lambda obj: ())
        c.start(workers=1)
        try:
            cluster.create(make_node("n1"))
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                try:
                    cache.get("Node", "n1")
                    break
                except Exception:  # noqa: BLE001
                    time.sleep(0.01)
            # the 5s lag would have kept a self-refreshing cache stale;
            # only the tee can have delivered this
            assert cache.get("Node", "n1")["metadata"]["name"] == "n1"
        finally:
            c.stop()

    def test_start_resyncs_gap_after_downtime(self):
        """HA-failover shape: frames written while NO controller drained
        the stream must appear in the externally-fed cache once a new
        controller starts (the startup relist sink)."""
        from k8s_operator_libs_tpu_torch.cluster import InformerCache
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node

        cluster = InMemoryCluster()
        cache = InformerCache(
            cluster, lag_seconds=5.0, kinds=("Node",), externally_fed=True
        )
        # downtime: a write lands while nothing drains the stream
        cluster.create(make_node("gap-node"))
        with pytest.raises(Exception):
            cache.get("Node", "gap-node")  # not seeded/fed yet: miss or raise
        c = Controller(
            cluster,
            self._reconciler(),
            event_sink=cache.ingest,
            relist_sink=cache.sync,
            watch_poll_seconds=0.01,
        )
        c.watches("Node", mapper=lambda obj: ())
        c.start(workers=1)
        try:
            # visible immediately after start: the startup resync closed
            # the gap without waiting for any new event
            assert cache.get("Node", "gap-node")["metadata"]["name"] == (
                "gap-node"
            )
        finally:
            c.stop()


class TestDeadlineAwareQueue:
    """The workqueue keeps at most ONE live deadline per item
    (earliest wins) and an immediate add disarms it — the reconciler's
    requeue timers are safety nets, not the scheduling mechanism."""

    def test_later_arm_is_noop_earlier_supersedes(self):
        q = RateLimitedQueue()
        q.add_after("a", 0.4)
        q.add_after("a", 5.0)  # later than the armed one: no-op
        assert q.pending_work() == 1  # ONE live deadline, not a heap count
        q.add_after("a", 0.05)  # earlier: supersedes
        t0 = time.monotonic()
        assert q.get(1.0) == "a"
        assert time.monotonic() - t0 < 0.3  # delivered at ~0.05, not 0.4
        q.done("a")
        # neither superseded entry ever fires
        assert q.get(0.6) is None
        q.shutdown()

    def test_immediate_add_disarms_pending_deadline(self):
        q = RateLimitedQueue()
        q.add_after("a", 0.15)
        q.add("a")  # a real wakeup: the safety net is obsolete
        assert q.get(0.1) == "a"
        q.done("a")
        assert q.get(0.35) is None  # the 0.15s deadline never fires
        q.shutdown()

    def test_wakeup_listener_counts_accepted_adds_only(self):
        seen = []
        q = RateLimitedQueue(
            wakeup_listener=lambda _item, trigger: seen.append(trigger)
        )
        assert q.add("a", "watch") is True
        assert q.add("a", "watch") is False  # dedup'd: not counted
        assert seen == ["watch"]
        item = q.get(0.1)
        assert q.add("a", "worker") is True  # dirty-mark: one more pass
        assert q.add("a", "worker") is False  # coalesces into the same
        q.done(item)
        assert seen == ["watch", "worker"]
        q.shutdown()

    def test_delayed_fire_reports_its_trigger(self):
        seen = []
        q = RateLimitedQueue(
            wakeup_listener=lambda _item, trigger: seen.append(trigger)
        )
        q.add_after("a", 0.01, "fallback")
        assert q.get(1.0) == "a"
        assert seen == ["fallback"]
        q.done("a")
        q.shutdown()


class TestWaitQuietPoll:
    def test_wait_quiet_polls_at_configured_interval(self, monkeypatch):
        """Regression: wait_quiet busy-polled at a
        hardcoded 5 ms regardless of watch_poll_seconds; it must ride
        the configured interval."""
        from k8s_operator_libs_tpu_torch.controller import controller as ctrl_mod

        cluster = InMemoryCluster()

        class R:
            def reconcile(self, request):
                return None

        c = Controller(cluster, R(), watch_poll_seconds=0.05)
        sleeps = []
        real_sleep = time.sleep
        monkeypatch.setattr(
            ctrl_mod.time,
            "sleep",
            lambda s: (sleeps.append(s), real_sleep(0.001)),
        )
        assert c.wait_quiet(0.3, settle=0.1)
        assert sleeps, "wait_quiet never polled"
        assert all(s == pytest.approx(0.05) for s in sleeps)


def _wakeup_count(trigger: str) -> float:
    from k8s_operator_libs_tpu_torch import metrics as metrics_mod

    for metric in metrics_mod.default_registry().collect():
        if metric.name.endswith("reconcile_wakeups_total"):
            return metric.value(trigger)
    return 0.0


class TestEventDrivenWakeups:
    """Journal deltas SCHEDULE reconciles — an idle
    fleet performs zero passes over a multi-interval window, and a
    single node change triggers exactly one coalesced pass (asserted
    via reconcile_wakeups_total{trigger} and InMemoryCluster.list_ops)."""

    def _assemble(self, cluster, policy, **kwargs):
        manager = ClusterUpgradeStateManager(
            cluster,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        ctrl = new_upgrade_controller(
            cluster,
            manager,
            NAMESPACE,
            DRIVER_LABELS,
            policy,
            resync_seconds=0.0,
            event_driven=True,
            **kwargs,
        )
        passes = []
        inner = ctrl._reconciler

        class Counting:
            def reconcile(self, request):
                passes.append(time.monotonic())
                return inner.reconcile(request)

        ctrl._reconciler = Counting()
        return ctrl, manager, passes

    def test_idle_fleet_zero_passes_then_flip_one_pass(self, cluster):
        from k8s_operator_libs_tpu_torch.upgrade import util as upgrade_util

        state_key = upgrade_util.get_upgrade_state_label_key()
        fleet = Fleet(cluster, revision_hash="v1")
        for h in range(3):
            fleet.add_node(
                f"host{h}", labels={state_key: consts.UPGRADE_STATE_DONE}
            )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(enable=True, force=True),
        )
        ctrl, manager, passes = self._assemble(cluster, policy)
        ctrl.start()
        try:
            assert ctrl.wait_quiet(5.0)
            settled = len(passes)
            lists_before = cluster.list_ops
            watch_before = _wakeup_count("watch")
            # A multi-interval window: 10x the old 0.05 s active
            # cadence, 2 intervals of a 0.25 s poll — the poll-driven
            # reconciler would have run 5-10 passes here.
            time.sleep(0.5)
            assert len(passes) == settled, "idle fleet still reconciling"
            assert cluster.list_ops == lists_before, (
                "idle fleet paid store LISTs with no reconcile pending"
            )
            assert _wakeup_count("watch") == watch_before
            # One node change: a label write the watch maps onto the
            # upgrade request — exactly one wakeup, one coalesced pass.
            cluster.patch(
                "Node", "host0", {"metadata": {"labels": {"probe": "1"}}}
            )
            deadline = time.monotonic() + 3.0
            while len(passes) == settled and time.monotonic() < deadline:
                time.sleep(0.005)
            assert len(passes) == settled + 1, "flip did not wake exactly once"
            assert _wakeup_count("watch") == watch_before + 1
            # ...and only one: the fleet is still done, no requeue armed
            time.sleep(0.3)
            assert len(passes) == settled + 1
        finally:
            ctrl.stop()
            manager.shutdown(wait=False)

    def test_gated_fleet_requeues_at_gate_deadline(self, cluster):
        """Event-driven mode: a gated pass requeues AT the computed gate
        deadline (closed maintenance window -> its opening, clamped to
        the 1 h re-check ceiling), not at the 5 s gated poll."""
        import datetime as _dt

        from k8s_operator_libs_tpu_torch.api.upgrade_spec import (
            MaintenanceWindowSpec,
        )
        from k8s_operator_libs_tpu_torch.controller.upgrade_reconciler import (
            UpgradeReconciler,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        start = (
            _dt.datetime.now(_dt.timezone.utc) + _dt.timedelta(hours=6)
        ).strftime("%H:00")
        rec = UpgradeReconciler(
            manager=manager,
            namespace=NAMESPACE,
            driver_labels=DRIVER_LABELS,
            policy=UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                maintenance_window=MaintenanceWindowSpec(
                    start=start, duration_minutes=60
                ),
                drain_spec=DrainSpec(enable=True, force=True),
            ),
            event_driven=True,
            gated_requeue_seconds=5.0,
        )
        rec.reconcile("upgrade-cycle")  # classification pass
        result = rec.reconcile("upgrade-cycle")  # steady gated pass
        assert manager.last_apply_transitions == 0
        assert result is not None
        # the window opens in ~5-6 h: far past the gated poll, clamped
        # to the hourly re-check ceiling
        assert result.requeue_after > 60.0
        assert result.requeue_after <= rec.MAX_GATE_DEADLINE_SECONDS
        manager.shutdown(wait=False)

    def test_in_flight_uses_fallback_cadence(self, cluster):
        """Event-driven mode: the active requeue is a SAFETY NET at the
        fallback cadence — worker completions and watch deltas are the
        real pickup mechanism."""
        from k8s_operator_libs_tpu_torch.controller.upgrade_reconciler import (
            UpgradeReconciler,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        for h in range(2):
            fleet.add_node(f"host{h}")
        fleet.publish_new_revision("v2")
        manager = ClusterUpgradeStateManager(
            cluster,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        rec = UpgradeReconciler(
            manager=manager,
            namespace=NAMESPACE,
            driver_labels=DRIVER_LABELS,
            policy=UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=1,
                drain_spec=DrainSpec(enable=True, force=True),
            ),
            active_requeue_seconds=0.02,
            event_driven=True,
            active_fallback_seconds=1.5,
        )
        result = rec.reconcile("upgrade-cycle")
        assert manager.last_apply_transitions > 0
        assert result is not None
        assert result.requeue_after == pytest.approx(1.5)
        manager.shutdown(wait=False)

    def test_worker_completion_wakes_reconcile(self, cluster):
        """The WakeupSource contract: an async drain worker completion
        enqueues the reconcile key with trigger=worker."""
        from k8s_operator_libs_tpu_torch.controller import (
            UPGRADE_REQUEST,
            RateLimitedQueue,
            WakeupSource,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        fleet.add_node("host0")
        manager = ClusterUpgradeStateManager(
            cluster,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        seen = []
        q = RateLimitedQueue(
            wakeup_listener=lambda _item, trigger: seen.append(trigger)
        )
        manager.set_wakeup_source(WakeupSource(q, UPGRADE_REQUEST))
        node = cluster.get("Node", "host0")
        # drive a real drain through the manager's drain workers
        from k8s_operator_libs_tpu_torch.upgrade.drain_manager import (
            DrainConfiguration,
        )

        manager.drain_manager.schedule_nodes_drain(
            DrainConfiguration(
                spec=DrainSpec(enable=True, force=True, timeout_second=10),
                nodes=[node],
            )
        )
        assert manager.drain_manager.wait_idle(10.0)
        deadline = time.monotonic() + 2.0
        while "worker" not in seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "worker" in seen
        q.shutdown()
        manager.shutdown(wait=False)
