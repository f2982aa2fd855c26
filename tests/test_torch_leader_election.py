"""The port's Lease-based leader election (k8s_operator_libs_tpu_torch/
controller/leader_election.py and ha.py) — acquisition, mutual
exclusion, renewal, failover, clean handoff, and the race where two
candidates fight for one expired lease.

Every class of ``tests/test_leader_election.py``, as cases of the same
names, on the port's cluster and harness."""

from __future__ import annotations

import threading
import time

import pytest

from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.controller import LeaderElector

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()

# short timings so specs run fast; ratios mirror the k8s defaults
# (15s / 10s / 2s)
FAST = dict(lease_duration=0.6, renew_deadline=0.4, retry_period=0.05)


def wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def make_elector(cluster, identity, **overrides):
    events = []
    kwargs = dict(FAST)
    kwargs.update(overrides)
    elector = LeaderElector(
        cluster,
        "upgrade-operator",
        identity,
        on_started_leading=lambda: events.append(("started", identity)),
        on_stopped_leading=lambda: events.append(("stopped", identity)),
        **kwargs,
    )
    return elector, events


class TestAcquisition:
    def test_sole_candidate_becomes_leader(self):
        cluster = InMemoryCluster()
        a, events = make_elector(cluster, "a")
        a.start()
        try:
            assert wait_for(lambda: a.is_leader)
            assert a.leader_identity() == "a"
            assert events == [("started", "a")]
        finally:
            a.stop()

    def test_config_validation(self):
        cluster = InMemoryCluster()
        with pytest.raises(ValueError):
            LeaderElector(cluster, "l", "x", lease_duration=1.0,
                          renew_deadline=1.0, retry_period=0.1)
        with pytest.raises(ValueError):
            LeaderElector(cluster, "l", "x", lease_duration=1.0,
                          renew_deadline=0.5, retry_period=0.5)

    def test_second_candidate_excluded_while_leader_renews(self):
        cluster = InMemoryCluster()
        a, _ = make_elector(cluster, "a")
        b, b_events = make_elector(cluster, "b")
        a.start()
        assert wait_for(lambda: a.is_leader)
        b.start()
        try:
            # b keeps campaigning across several lease durations and never
            # wins while a renews on time
            time.sleep(FAST["lease_duration"] * 2)
            assert a.is_leader
            assert not b.is_leader
            assert b_events == []
        finally:
            a.stop()
            b.stop()

    def test_distinct_locks_are_independent(self):
        cluster = InMemoryCluster()
        a = LeaderElector(cluster, "lock-1", "a", **FAST)
        b = LeaderElector(cluster, "lock-2", "b", **FAST)
        a.start()
        b.start()
        try:
            assert wait_for(lambda: a.is_leader and b.is_leader)
        finally:
            a.stop()
            b.stop()


class TestFailover:
    def test_clean_stop_releases_for_fast_handoff(self):
        cluster = InMemoryCluster()
        a, _ = make_elector(cluster, "a")
        b, _ = make_elector(cluster, "b")
        a.start()
        assert wait_for(lambda: a.is_leader)
        b.start()
        try:
            started = time.monotonic()
            a.stop()
            assert wait_for(lambda: b.is_leader)
            # released, not expired: well under a full lease duration +
            # retry; give scheduling slack
            assert time.monotonic() - started < FAST["lease_duration"] + 0.3
            assert b.leader_identity() == "b"
        finally:
            b.stop()

    def test_stop_demotes_before_releasing_lease(self):
        """Fencing on clean shutdown: on_stopped_leading (stop doing
        leader work) must run while we still hold the lease — releasing
        first would let a successor lead concurrently with our teardown."""
        cluster = InMemoryCluster()
        holder_when_stopped = []

        def on_stopped():
            lease = cluster.get("Lease", "upgrade-operator", "kube-system")
            holder_when_stopped.append(lease["spec"]["holderIdentity"])

        elector = LeaderElector(
            cluster, "upgrade-operator", "a",
            on_stopped_leading=on_stopped, **FAST,
        )
        elector.start()
        assert wait_for(lambda: elector.is_leader)
        elector.stop()
        # at callback time the lease still named us; released only after
        assert holder_when_stopped == ["a"]
        lease = cluster.get("Lease", "upgrade-operator", "kube-system")
        assert lease["spec"]["holderIdentity"] == ""

    def test_crashed_leader_expires_and_successor_acquires(self):
        cluster = InMemoryCluster()
        a, _ = make_elector(cluster, "a")
        b, _ = make_elector(cluster, "b")
        a.start()
        assert wait_for(lambda: a.is_leader)
        # crash: the campaign thread dies without release (no stop())
        a._stop.set()
        a._thread.join(2.0)
        b.start()
        try:
            assert wait_for(lambda: b.is_leader, timeout=5.0)
            lease = cluster.get("Lease", "upgrade-operator", "kube-system")
            assert lease["spec"]["holderIdentity"] == "b"
            assert lease["spec"]["leaseTransitions"] >= 1
        finally:
            b.stop()

    def test_leader_demotes_on_renew_failure_before_ttl(self):
        """A holder that cannot reach the store must stop leading by the
        renew deadline — the fencing property."""
        cluster = InMemoryCluster()
        a, events = make_elector(cluster, "a")
        a.start()
        assert wait_for(lambda: a.is_leader)
        # partition: every write conflicts from now on
        original_update = cluster.update

        def failing_update(obj):
            raise RuntimeError("network partition")

        cluster.update = failing_update
        try:
            assert wait_for(lambda: not a.is_leader, timeout=5.0)
            assert ("stopped", "a") in events
        finally:
            cluster.update = original_update
            a.stop()


class TestAcquireRace:
    def test_exactly_one_winner_for_expired_lease(self):
        """Two candidates see the same expired lease and both try the
        RV-checked update: the store must crown exactly one."""
        cluster = InMemoryCluster()
        # an expired lease from a long-gone holder
        cluster.create(
            {
                "kind": "Lease",
                "metadata": {"name": "upgrade-operator",
                             "namespace": "kube-system"},
                "spec": {
                    "holderIdentity": "ghost",
                    "leaseDurationSeconds": 0.1,
                    "acquireTime": time.time() - 10,
                    "renewTime": time.time() - 10,
                    "leaseTransitions": 0,
                },
            }
        )
        a = LeaderElector(cluster, "upgrade-operator", "a", **FAST)
        b = LeaderElector(cluster, "upgrade-operator", "b", **FAST)
        barrier = threading.Barrier(2)
        results = {}

        def campaign(elector, key):
            barrier.wait()
            results[key] = elector._try_acquire_or_renew()

        threads = [
            threading.Thread(target=campaign, args=(a, "a")),
            threading.Thread(target=campaign, args=(b, "b")),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert sorted(results.values()) == [False, True]
        holder = cluster.get("Lease", "upgrade-operator", "kube-system")[
            "spec"
        ]["holderIdentity"]
        winner = "a" if results["a"] else "b"
        assert holder == winner

    def test_two_full_electors_converge_to_one_leader(self):
        cluster = InMemoryCluster()
        a, _ = make_elector(cluster, "a")
        b, _ = make_elector(cluster, "b")
        a.start()
        b.start()
        try:
            assert wait_for(lambda: a.is_leader or b.is_leader)
            time.sleep(FAST["lease_duration"])
            assert a.is_leader != b.is_leader  # exactly one
        finally:
            a.stop()
            b.stop()


class TestLeaderGatedOperator:
    """The HA deployment pattern: two operator replicas, only the leader
    reconciles; failover hands the rollout to the standby."""

    def test_standby_takes_over_rollout(self, cluster):
        import time as _time

        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import (
            DRIVER_LABELS,
            NAMESPACE,
            Fleet,
            daemonset_loop,
            wait_for_converged,
        )

        fleet = Fleet(cluster, revision_hash="v1")
        for h in range(2):
            fleet.add_node(f"host{h}")
        fleet.publish_new_revision("v2")
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=30),
        )

        def replica(identity):
            """Controller whose start is gated on winning the election."""
            manager = ClusterUpgradeStateManager(
                cluster,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            ctrl = new_upgrade_controller(
                cluster, manager, NAMESPACE, DRIVER_LABELS, policy,
                resync_seconds=0.1, active_requeue_seconds=0.02,
            )
            elector = LeaderElector(
                cluster,
                "upgrade-operator",
                identity,
                on_started_leading=lambda: ctrl.start(),
                **FAST,
            )
            return ctrl, elector

        with daemonset_loop(fleet):
            ctrl_a, elector_a = replica("a")
            ctrl_b, elector_b = replica("b")
            elector_a.start()
            assert wait_for(lambda: elector_a.is_leader)
            elector_b.start()
            try:
                # kill the leader almost immediately — the standby must
                # win the lease and finish the rollout
                _time.sleep(0.05)
                elector_a.stop()
                ctrl_a.stop()
                assert wait_for(lambda: elector_b.is_leader, timeout=5.0)
                assert wait_for_converged(fleet), (
                    f"standby never finished: {fleet.states()}"
                )
            finally:
                elector_b.stop()
                ctrl_b.stop()


class TestCallbackSafety:
    def test_raising_on_started_steps_down_instead_of_wedging(self):
        """Regression: an exception from on_started_leading used to kill
        the campaign thread outside its try/except, leaving is_leader
        permanently True with renewals stopped — a silent split-brain once
        a standby took over.  The elector must step down and release."""
        cluster = InMemoryCluster()

        def boom():
            raise RuntimeError("controller already started")

        a = LeaderElector(
            cluster, "upgrade-operator", "a", on_started_leading=boom, **FAST
        )
        a.start()
        try:
            # promote fires, callback raises → elector demotes + releases;
            # but the campaign thread stays alive and will re-promote (and
            # re-fail) each retry — so assert on the server-side lease and
            # that is_leader is never stuck True while the holder is gone
            assert wait_for(lambda: a.leader_identity() in (None, "a"))
            time.sleep(0.2)  # several promote/fail cycles
            assert a._thread.is_alive()  # campaign thread survived
            # a standby can take over because the lease keeps being freed
            b, b_events = make_elector(cluster, "b")
            b.start()
            try:
                assert wait_for(lambda: b.is_leader, timeout=5.0)
            finally:
                b.stop()
        finally:
            a.stop()

    def test_raising_on_stopped_does_not_kill_campaign(self):
        cluster = InMemoryCluster()

        def boom():
            raise RuntimeError("teardown failed")

        a = LeaderElector(
            cluster, "upgrade-operator", "a", on_stopped_leading=boom, **FAST
        )
        a.start()
        assert wait_for(lambda: a.is_leader)
        # partition → deadline demotion runs the raising callback
        original_update = cluster.update
        cluster.update = lambda obj: (_ for _ in ()).throw(
            RuntimeError("partition")
        )
        try:
            assert wait_for(lambda: not a.is_leader, timeout=5.0)
            assert a._thread.is_alive()  # thread survived the raise
        finally:
            cluster.update = original_update
        # store heals → the same elector re-acquires
        assert wait_for(lambda: a.is_leader, timeout=5.0)
        a.stop()

    def test_stop_after_deadline_demotion_still_releases_lease(self):
        """Regression: stop() used to skip release() when is_leader was
        already False — but a deadline-demoted leader can still be the
        nominal holder on the server after a healed partition, forcing the
        successor to wait out the TTL."""
        cluster = InMemoryCluster()
        # long lease, short deadline: demotion happens well before expiry
        a, _ = make_elector(
            cluster, "a",
            lease_duration=30.0, renew_deadline=0.3, retry_period=0.05,
        )
        a.start()
        assert wait_for(lambda: a.is_leader)
        original_update = cluster.update
        cluster.update = lambda obj: (_ for _ in ()).throw(
            RuntimeError("partition")
        )
        assert wait_for(lambda: not a.is_leader, timeout=5.0)
        cluster.update = original_update  # partition heals
        a.stop()  # demoted already — must STILL release the lease
        lease = cluster.get("Lease", "upgrade-operator", "kube-system")
        assert lease["spec"]["holderIdentity"] == ""


class TestHaOperator:
    """HaOperator assembly: controller lifecycle tied to leadership."""

    class _FakeController:
        def __init__(self):
            self.started = 0
            self.stopped = 0
            self.alive = True

        def start(self, workers=1):
            self.started += 1

        def stop(self, timeout=10.0):
            self.stopped += 1
            self.alive = False

        def running(self):
            return self.alive

    def _make(self, cluster, identity, built):
        from k8s_operator_libs_tpu_torch.controller import HaOperator

        def factory():
            c = self._FakeController()
            built.append(c)
            return c

        return HaOperator(
            cluster,
            factory,
            identity=identity,
            lease_duration=0.6,
            renew_deadline=0.4,
            retry_period=0.05,
        )

    def test_controller_starts_on_lead_stops_on_stepdown(self):
        cluster = InMemoryCluster()
        built = []
        op = self._make(cluster, "a", built)
        op.start()
        assert wait_for(lambda: op.is_leader)
        assert len(built) == 1 and built[0].started == 1
        assert op.controller is built[0]
        op.stop()
        assert built[0].stopped == 1
        assert op.controller is None

    def test_standby_builds_nothing_until_failover(self):
        cluster = InMemoryCluster()
        built_a, built_b = [], []
        op_a = self._make(cluster, "a", built_a)
        op_a.start()
        assert wait_for(lambda: op_a.is_leader)
        op_b = self._make(cluster, "b", built_b)
        op_b.start()
        time.sleep(0.3)
        assert built_b == []  # hot standby: no controller built
        op_a.stop()  # clean handoff releases the lease
        assert wait_for(lambda: op_b.is_leader, timeout=5.0)
        assert len(built_b) == 1 and built_b[0].started == 1
        op_b.stop()

    def test_each_term_builds_a_fresh_controller(self):
        """A stopped controller's workqueue is shut down — re-promotion
        must build a new one, not restart the old."""
        cluster = InMemoryCluster()
        built = []
        op = self._make(cluster, "a", built)
        op.start()
        assert wait_for(lambda: op.is_leader)
        op.stop()
        op2 = self._make(cluster, "a", built)
        op2.start()
        assert wait_for(lambda: op2.is_leader)
        assert len(built) == 2
        assert built[0] is not built[1]
        op2.stop()


class TestHaOperatorLiveness:
    """HaOperator.running(): the probe wired to /healthz — a dead
    campaign thread or a dead promoted controller must fail it while a
    hot standby stays healthy."""

    def test_running_truth_table(self):
        cluster = InMemoryCluster()
        built = []
        op = TestHaOperator()._make(cluster, "probe", built)
        assert op.running() is False  # not started: campaign dead
        op.start()
        assert wait_for(lambda: op.is_leader)
        assert op.running() is True  # leading + controller alive
        # leader whose controller died must fail the probe
        built[0].alive = False
        assert op.running() is False
        op.stop()
        assert op.running() is False
