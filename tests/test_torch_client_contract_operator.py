"""The port's assembled operator over its HTTP stack: the controller
classes of ``tests/test_client_contract.py``, as cases of the same names,
on the port's controller, ``HaOperator``, ``KubeApiClient`` and
``ApiServerFacade``, in the port's vocabulary:

* ``TestOperatorOverHttp``: the controller rolls a fleet over bounded
  watches;
* ``TestSecondReviewRegressions::test_controller_bookmark_survives_unwatched_churn``;
* ``TestHaOperatorOverHttp``: two leader-elected replicas, the leader
  crashes mid-rollout and the standby converges it;
* ``TestHeldWatchStreams::test_controller_rollout_over_held_streams``;
* ``TestCombinedChaosSoak``: an apiserver restart, a pause and resume by
  CR edit, an invalid edit refused at admission (the port's own CRDs)
  and a leader crash, in one rollout;
* ``TestFlakyApiserverChaos::test_rollout_converges_through_dropped_connections``.

The chaos classes judge the journal against the reference lifecycle
graph, ``LEGAL_TRANSITIONS`` of the JAX package's chaos module (state
names, which both packages share), read from the port's store with the
port's state label by :func:`observed_transitions`.  Threads are joined
with a timeout and the join is checked; every client a test makes is
closed when it ends (``test_torch_vocab.close_every_client``).
"""

import time
from pathlib import Path

import pytest

from k8s_operator_libs_tpu.upgrade.chaos import LEGAL_TRANSITIONS
from k8s_operator_libs_tpu_torch.cluster import (
    ApiServerFacade,
    InMemoryCluster,
    KubeApiClient,
    KubeConfig,
)
from k8s_operator_libs_tpu_torch.cluster.objects import make_node, make_pod
from k8s_operator_libs_tpu_torch.upgrade import util

from test_torch_vocab import close_every_client, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals", "close_every_client")

ROOT_CRDS = Path(__file__).resolve().parent.parent / "k8s_operator_libs_tpu_torch" / "crd"


def observed_transitions(cluster, since_seq: int = 0):
    """Every node state-label change in the port store's watch journal
    after *since_seq*, as the JAX chaos module's reader gives them."""
    key = util.get_upgrade_state_label_key()
    moves = []
    for ev in cluster.events_since(since_seq, kind="Node"):
        if ev.new is None:
            continue
        old_state = (((ev.old or {}).get("metadata") or {}).get("labels") or {}).get(key, "")
        new_state = ((ev.new.get("metadata") or {}).get("labels") or {}).get(key, "")
        if old_state != new_state:
            moves.append((old_state, new_state))
    return moves


def crash(leader):
    """Kill *leader* as a process death would: its campaign thread stops
    without demoting or releasing the Lease, and its controller dies."""
    leader.elector._stop.set()
    leader.elector._thread.join(5.0)
    assert not leader.elector._thread.is_alive(), "the leader's campaign thread did not stop"
    leader._stop_controller()


class TestOperatorOverHttp:
    """The assembled controller runtime — watch loop, workqueue,
    reconciler — driven entirely through KubeApiClient bounded watches
    against the HTTP facade.  Proves the watch→journal shim feeds the
    Controller exactly like the in-mem journal does."""

    def test_controller_rollout_over_http(self):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller
        from k8s_operator_libs_tpu_torch.upgrade import consts
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            fleet = Fleet(client)
            for i in range(2):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            manager = ClusterUpgradeStateManager(
                client,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            controller = new_upgrade_controller(
                client,
                manager,
                NAMESPACE,
                DRIVER_LABELS,
                policy=UpgradePolicySpec(
                    auto_upgrade=True,
                    max_parallel_upgrades=0,
                    max_unavailable=IntOrString("100%"),
                    drain_spec=DrainSpec(
                        enable=True, force=True, timeout_second=10
                    ),
                ),
                resync_seconds=0.2,
                active_requeue_seconds=0.02,
                watch_poll_seconds=0.02,
            )
            controller.start(workers=1)
            try:
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    fleet.reconcile_daemonset()
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        break
                    time.sleep(0.05)
                assert set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }
            finally:
                controller.stop()


class TestSecondReviewRegressions:

    def test_controller_bookmark_survives_unwatched_churn(self):
        """Unwatched-kind churn past the journal retention window must
        not strand the controller in 410 relist storms: the bookmark
        advances with the journal head even when polls return nothing."""
        from k8s_operator_libs_tpu_torch.controller.controller import Controller

        store = InMemoryCluster()
        store._journal_cap = 20
        store.create(make_node("n1"))

        class Noop:
            def reconcile(self, request):
                return None

        controller = Controller(
            store, Noop(), name="churn-test", watch_poll_seconds=0.005
        )
        controller.watches("Node")
        controller.start(workers=1)
        try:
            for i in range(100):  # way past the 20-event retention
                store.create(make_pod(f"p{i}", "ml", "n1"))
                if i % 10 == 0:
                    time.sleep(0.01)
            deadline = time.monotonic() + 5.0
            head = store.journal_seq()
            while controller._last_seq < head:
                assert time.monotonic() < deadline, (
                    f"bookmark stuck at {controller._last_seq} < {head}"
                )
                time.sleep(0.01)
        finally:
            controller.stop()


class TestHaOperatorOverHttp:
    """Two leader-elected operator replicas over
    the HTTP facade; the leader dies mid-rollout, the standby acquires
    the Lease and converges the rollout with throttle invariants held."""

    def test_leader_crash_failover_converges_rollout(self):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.controller import (
            HaOperator,
            new_upgrade_controller,
        )
        from k8s_operator_libs_tpu_torch.upgrade import consts
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

        store = InMemoryCluster()
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,  # slow rollout: one node at a time
            max_unavailable=IntOrString(1),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        with ApiServerFacade(store) as facade:

            def make_replica(identity):
                # Each replica gets its OWN client: the HTTP watch stream
                # is single-consumer per client instance.
                client = KubeApiClient(
                    KubeConfig(server=facade.url), timeout=10.0
                )
                manager = ClusterUpgradeStateManager(
                    client,
                    cache_sync_timeout_seconds=2.0,
                    cache_sync_poll_seconds=0.01,
                )

                def factory():
                    return new_upgrade_controller(
                        client,
                        manager,
                        NAMESPACE,
                        DRIVER_LABELS,
                        policy=policy,
                        resync_seconds=0.1,
                        active_requeue_seconds=0.02,
                        watch_poll_seconds=0.02,
                    )

                return HaOperator(
                    client,
                    factory,
                    identity=identity,
                    lease_duration=0.9,
                    renew_deadline=0.6,
                    retry_period=0.1,
                )

            fleet = Fleet(store)  # simulated kubelet/DS controller
            for i in range(6):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")

            op_a = make_replica("replica-a")
            op_b = make_replica("replica-b")
            op_a.start()
            op_b.start()
            try:
                # exactly one replica leads
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if op_a.is_leader != op_b.is_leader:
                        break
                    time.sleep(0.02)
                assert op_a.is_leader != op_b.is_leader
                leader, standby = (
                    (op_a, op_b) if op_a.is_leader else (op_b, op_a)
                )
                assert leader.controller is not None
                assert standby.controller is None

                # let the rollout get mid-flight (>=1 node done, not all)
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    fleet.reconcile_daemonset()
                    states = fleet.states()
                    if any(
                        s == consts.UPGRADE_STATE_DONE
                        for s in states.values()
                    ) and not all(
                        s == consts.UPGRADE_STATE_DONE
                        for s in states.values()
                    ):
                        break
                    time.sleep(0.02)
                states = fleet.states()
                assert any(
                    s == consts.UPGRADE_STATE_DONE for s in states.values()
                )
                assert not all(
                    s == consts.UPGRADE_STATE_DONE for s in states.values()
                )

                # CRASH the leader: campaign thread dies without demoting
                # or releasing the lease; its controller dies with the
                # process.
                crash(leader)

                # the standby acquires once the un-renewed lease expires
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    if standby.is_leader:
                        break
                    time.sleep(0.02)
                assert standby.is_leader
                assert standby.controller is not None

                # ...and converges the rollout, never exceeding the
                # 1-unavailable throttle budget
                deadline = time.monotonic() + 40.0
                while time.monotonic() < deadline:
                    fleet.reconcile_daemonset()
                    unavailable = sum(
                        1
                        for node in store.list("Node")
                        if (node.get("spec") or {}).get("unschedulable")
                    )
                    assert unavailable <= 1, "throttle budget exceeded"
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        break
                    time.sleep(0.02)
                assert set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }
            finally:
                op_a.stop()
                op_b.stop()


class TestHeldWatchStreams:
    """Held watch streams — a long watch per kind
    pushed by the server (the controller-runtime informer pattern)
    instead of per-poll bounded watches."""

    def _client(self, facade, hold=3.0, kinds=("Node",)):
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        client.start_held_watches(kinds, hold_seconds=hold)
        return client

    def _drain_until(self, client, seq, pred, timeout=10.0):
        """Poll events_since until pred(all_events) or timeout.  A 410
        mid-drain is handled the way a controller does — note it, relist
        conceptually, keep consuming."""
        collected = []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            client.wait_for_held_event(seq, timeout=0.25)
            try:
                batch = client.events_since(
                    seq, kind=tuple(client._held_kinds)
                )
            except ExpiredError:
                continue
            collected.extend(batch)
            if batch:
                seq = max(seq, max(e.seq for e in batch))
            if pred(collected):
                return collected, seq
        raise AssertionError(f"condition not met; got {collected}")

    def test_controller_rollout_over_held_streams(self):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller
        from k8s_operator_libs_tpu_torch.upgrade import consts
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

        store = InMemoryCluster()
        with ApiServerFacade(store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            client.start_held_watches(
                ("Node", "Pod", "DaemonSet"), hold_seconds=3.0
            )
            fleet = Fleet(client)
            for i in range(2):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            manager = ClusterUpgradeStateManager(
                client,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            controller = new_upgrade_controller(
                client,
                manager,
                NAMESPACE,
                DRIVER_LABELS,
                policy=UpgradePolicySpec(
                    auto_upgrade=True,
                    max_parallel_upgrades=0,
                    max_unavailable=IntOrString("100%"),
                    drain_spec=DrainSpec(
                        enable=True, force=True, timeout_second=10
                    ),
                ),
                resync_seconds=0.2,
                active_requeue_seconds=0.02,
                watch_poll_seconds=0.02,
            )
            controller.start(workers=1)
            try:
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    fleet.reconcile_daemonset()
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        break
                    time.sleep(0.05)
                assert set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }
            finally:
                controller.stop()
                client.stop_held_watches()


class TestCombinedChaosSoak:
    """The capstone e2e: everything that can go wrong, in ONE scenario
    over the real HTTP stack.  Two leader-elected replicas run a
    CR-driven rollout; mid-flight the apiserver dies and comes back
    (taking every continue-token snapshot with it), the policy CR
    pauses and resumes the rollout, an INVALID policy edit is refused
    at admission, and the leader crashes.  The whole scenario runs with
    a server-enforced 3-item LIST page cap (every list the operators
    issue paginates) and the CRDs applied (every policy write passes
    structural-schema admission).  The fleet must converge with the
    throttle budget never exceeded and no node ever riding an
    undefined transition edge."""

    def test_soak_apiserver_restart_policy_edit_leader_crash(self):
        from urllib.parse import urlparse

        import yaml

        from k8s_operator_libs_tpu_torch.api import UpgradePolicySpec
        from k8s_operator_libs_tpu_torch.cluster import InvalidError
        from k8s_operator_libs_tpu_torch.controller import (
            CrPolicySource,
            HaOperator,
            new_upgrade_controller,
        )
        from k8s_operator_libs_tpu_torch.upgrade import consts
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

        store = InMemoryCluster()
        for crd_path in (
            f"{ROOT_CRDS}/nvidia.com_gpuupgradepolicies.yaml",
            f"{ROOT_CRDS}/maintenance.nvidia.com_nodemaintenances.yaml",
        ):
            with open(crd_path, "r", encoding="utf-8") as fh:
                store.create(yaml.safe_load(fh))
        store.create(
            {
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
                "spec": {
                    "autoUpgrade": True,
                    "maxParallelUpgrades": 1,
                    "maxUnavailable": 1,
                    "drain": {
                        "enable": True,
                        "force": True,
                        "timeoutSeconds": 10,
                    },
                },
            }
        )
        facade = ApiServerFacade(store, max_list_page=3).start()
        port = urlparse(facade.url).port

        def make_replica(identity):
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            manager = ClusterUpgradeStateManager(
                client,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )

            def factory():
                return new_upgrade_controller(
                    client,
                    manager,
                    NAMESPACE,
                    DRIVER_LABELS,
                    policy_source=CrPolicySource(
                        client, "fleet-policy", NAMESPACE
                    ),
                    resync_seconds=0.1,
                    active_requeue_seconds=0.02,
                    watch_poll_seconds=0.02,
                )

            return HaOperator(
                client,
                factory,
                identity=identity,
                lease_duration=0.9,
                renew_deadline=0.6,
                retry_period=0.1,
            )

        fleet = Fleet(store)
        for i in range(6):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")

        def done_count():
            return sum(
                1
                for s in fleet.states().values()
                if s == consts.UPGRADE_STATE_DONE
            )

        def assert_budget():
            unavailable = sum(
                1
                for node in store.list("Node")
                if (node.get("spec") or {}).get("unschedulable")
            )
            assert unavailable <= 1, "throttle budget exceeded during chaos"

        op_a = make_replica("replica-a")
        op_b = make_replica("replica-b")
        op_a.start()
        op_b.start()
        try:
            # ---- phase 1: rollout gets mid-flight
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and done_count() < 1:
                fleet.reconcile_daemonset()
                assert_budget()
                time.sleep(0.02)
            assert done_count() >= 1, fleet.states()

            # ---- phase 2: the apiserver dies and comes back (etcd—the
            # store—survives); replicas ride out the outage
            facade.stop()
            time.sleep(0.3)
            facade = ApiServerFacade(store, port=port, max_list_page=3).start()

            # ---- phase 3: pause via a live CR edit, then resume
            editor = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            editor.patch(
                "GpuUpgradePolicy",
                "fleet-policy",
                {"spec": {"autoUpgrade": False}},
                NAMESPACE,
            )
            time.sleep(0.6)  # the pause propagates via the policy watch
            # Journal-based pause check: over the paused window, NO node
            # may enter an admission state (a point-in-time label sample
            # misses transient cordon-required).
            pause_seq = store.journal_seq()
            time.sleep(1.0)
            admitted_while_paused = [
                t
                for t in observed_transitions(store, pause_seq)
                if t[1]
                in (
                    consts.UPGRADE_STATE_CORDON_REQUIRED,
                    consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
                )
            ]
            assert admitted_while_paused == [], (
                f"paused rollout kept admitting: {admitted_while_paused}"
            )
            editor.patch(
                "GpuUpgradePolicy",
                "fleet-policy",
                {"spec": {"autoUpgrade": True}},
                NAMESPACE,
            )

            # ---- phase 3b: an invalid edit dies at admission (422 over
            # HTTP) — the CR is untouched and the rollout unaffected
            with pytest.raises(InvalidError):
                editor.patch(
                    "GpuUpgradePolicy",
                    "fleet-policy",
                    {"spec": {"maxParallelUpgrades": "garbage"}},
                    NAMESPACE,
                )
            kept = editor.get("GpuUpgradePolicy", "fleet-policy", NAMESPACE)
            assert kept["spec"]["maxParallelUpgrades"] == 1
            assert kept["spec"]["autoUpgrade"] is True

            # ---- phase 4: crash whichever replica leads now
            deadline = time.monotonic() + 10.0
            leader = None
            while time.monotonic() < deadline:
                fleet.reconcile_daemonset()
                if op_a.is_leader != op_b.is_leader:
                    leader = op_a if op_a.is_leader else op_b
                    break
                time.sleep(0.02)
            assert leader is not None, "no single leader after restart"
            standby = op_b if leader is op_a else op_a
            crash(leader)

            # ---- phase 5: the standby takes over and converges
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                fleet.reconcile_daemonset()
                assert_budget()
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
                time.sleep(0.02)
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            assert standby.is_leader

            # ---- epilogue: the journal shows only legal edges
            illegal = [
                t
                for t in observed_transitions(store)
                if t not in LEGAL_TRANSITIONS
            ]
            assert illegal == [], f"illegal transitions: {illegal}"
        finally:
            op_a.stop()
            op_b.stop()
            facade.stop()


class TestFlakyApiserverChaos:
    """Fault injection at the transport: a seeded fraction of apiserver
    requests is dropped with an abrupt connection close before
    processing.  The assembled operator must converge anyway — retries
    for idempotent verbs, next-reconcile idempotency for everything
    else — with only legal transition edges in the journal."""

    def test_rollout_converges_through_dropped_connections(self):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller
        from k8s_operator_libs_tpu_torch.upgrade import consts
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

        store = InMemoryCluster()
        # max_list_page: the chaos also hits paginated LISTs mid-drain —
        # a dropped continue GET must be retried/restarted safely
        with ApiServerFacade(store, max_list_page=3).with_chaos(
            0.15, seed=7
        ) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
            fleet = Fleet(store)
            for i in range(4):
                fleet.add_node(f"n{i}", pod_hash="rev1")
            fleet.publish_new_revision("rev2")
            manager = ClusterUpgradeStateManager(
                client,
                cache_sync_timeout_seconds=2.0,
                cache_sync_poll_seconds=0.01,
            )
            policy = UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                drain_spec=DrainSpec(
                    enable=True, force=True, timeout_second=10
                ),
            )
            controller = new_upgrade_controller(
                client,
                manager,
                NAMESPACE,
                DRIVER_LABELS,
                policy=policy,
                resync_seconds=0.1,
                active_requeue_seconds=0.02,
                gated_requeue_seconds=0.1,
                watch_poll_seconds=0.02,
            )
            controller.start(workers=1)
            try:
                # Phase 1 (chaos on): run up to 30 s.  A dropped API call
                # mid-drain legitimately fails that node (reference
                # semantics: drain error -> upgrade-failed; recovery
                # needs the pod back in sync), so full convergence is not
                # guaranteed yet.
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    fleet.reconcile_daemonset()
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        break
                    time.sleep(0.02)

                # Phase 2: the fault clears; ops repairs any drain-failed
                # node the documented way (replace its driver pod — the
                # DS recreates at the target revision, the failed node
                # self-heals once the pod is back in sync).
                facade.with_chaos(0.0)
                from k8s_operator_libs_tpu_torch.upgrade import util as _util

                state_key = _util.get_upgrade_state_label_key()

                def repair_failed_nodes() -> None:
                    # replace the driver pod of any drain-failed node so
                    # the DS recreates it at the target revision and the
                    # node self-heals.  Runs INSIDE the polling loop: a
                    # chaos-era drain failure can land a few ms after
                    # chaos is disabled (the controller processes the
                    # dropped call's outcome asynchronously).
                    for node in store.list("Node"):
                        labels = node["metadata"].get("labels") or {}
                        if labels.get(state_key) != consts.UPGRADE_STATE_FAILED:
                            continue
                        for pod in store.list("Pod", NAMESPACE):
                            if (pod.get("spec") or {}).get("nodeName") == node[
                                "metadata"
                            ]["name"]:
                                store.delete(
                                    "Pod",
                                    pod["metadata"]["name"],
                                    NAMESPACE,
                                    grace_period_seconds=0,
                                )

                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    repair_failed_nodes()
                    fleet.reconcile_daemonset()
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        break
                    time.sleep(0.02)
                assert set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }, f"did not recover after chaos cleared: {fleet.states()}"
            finally:
                controller.stop()
        illegal = [
            t
            for t in observed_transitions(store)
            if t not in LEGAL_TRANSITIONS
        ]
        assert illegal == [], f"illegal transitions under chaos: {illegal}"

