"""The port's remediation engine (k8s_operator_libs_tpu_torch/upgrade/
remediation.py) and the RemediationSpec it reads (api/upgrade_spec.py).

The classes of ``tests/test_remediation.py``, as cases of the same names,
run on the port, the breaker, rollback, retry budget and surfaces
through its ``ClusterUpgradeStateManager``; ``remediation_report`` over a
rollout's snapshot, with retry and quarantine annotations, is also held
to the JAX package's in ``tests/test_torch_rollout_parity.py``.  Left in
the JAX file: ``TestReconcilerCadence`` (the controller's reconciler) and
the CLI and ``OpsServer`` tests of ``TestSurfaces``.
"""

import json

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, RemediationSpec, UpgradePolicySpec, ValidationError
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster, InformerCache
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.remediation import is_remediation_quarantined, remediation_report, render_report
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


def make_manager(cluster) -> ClusterUpgradeStateManager:
    return ClusterUpgradeStateManager(
        cluster,
        cache=InformerCache(cluster, lag_seconds=0.0),
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005,
    )


def remediation_policy(**kwargs) -> UpgradePolicySpec:
    spec = dict(
        failure_threshold=0.5,
        min_attempted=1,
        auto_rollback=True,
        max_node_attempts=4,
        backoff_seconds=0.0,
    )
    spec.update(kwargs.pop("remediation", {}))
    defaults = dict(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        remediation=RemediationSpec(**spec),
    )
    defaults.update(kwargs)
    return UpgradePolicySpec(**defaults)


def cycle(manager, fleet, policy, n=1):
    for _ in range(n):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
    return state


def healthy_fleet(cluster, nodes=4) -> Fleet:
    fleet = Fleet(cluster)
    for i in range(nodes):
        fleet.add_node(f"n{i}")
    return fleet


def ds_annotation(cluster, key) -> str:
    ds = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
    return (ds["metadata"].get("annotations") or {}).get(key)


STATE_KEY = util.get_upgrade_state_label_key


class TestRemediationSpec:
    def test_round_trip_camel_case(self):
        spec = RemediationSpec(
            failure_threshold=0.1,
            min_attempted=5,
            window_seconds=600.0,
            auto_rollback=True,
            max_node_attempts=2,
            backoff_seconds=30.0,
            backoff_max_seconds=900.0,
        )
        d = spec.to_dict()
        assert d["failureThreshold"] == 0.1
        assert d["autoRollback"] is True
        assert d["maxNodeAttempts"] == 2
        assert RemediationSpec.from_dict(d) == spec

    def test_policy_round_trip_carries_remediation(self):
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            remediation=RemediationSpec(auto_rollback=True),
        )
        policy.validate()
        back = UpgradePolicySpec.from_dict(policy.to_dict())
        assert back.remediation == policy.remediation
        assert UpgradePolicySpec.from_dict({}).remediation is None

    @pytest.mark.parametrize(
        "bad",
        [
            {"failure_threshold": 0.0},
            {"failure_threshold": 1.5},
            {"window_seconds": 0},
            {"min_attempted": -1},
            {"max_node_attempts": -2},
            {"backoff_seconds": -1.0},
            {"auto_rollback": "true"},
        ],
    )
    def test_validation_rejects(self, bad):
        spec = RemediationSpec(**bad)
        with pytest.raises(ValidationError):
            spec.validate()

    def test_policy_validates_embedded_spec(self):
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            remediation=RemediationSpec(failure_threshold=2.0),
        )
        with pytest.raises(ValidationError):
            policy.validate()


class TestLastKnownGoodTracker:
    def test_seed_then_record_previous_target(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        policy = remediation_policy()
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            record = json.loads(
                ds_annotation(cluster, util.get_last_known_good_annotation_key())
            )
            assert record == {"lkg": "rev1", "target": "rev1"}
            fleet.publish_new_revision("rev2")
            cycle(manager, fleet, policy)
            record = json.loads(
                ds_annotation(cluster, util.get_last_known_good_annotation_key())
            )
            assert record == {"lkg": "rev1", "target": "rev2"}
        finally:
            manager.shutdown()

    def test_rollback_does_not_promote_bad_revision_to_lkg(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        policy = remediation_policy()
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            cycle(manager, fleet, policy, 30)
            record = json.loads(
                ds_annotation(cluster, util.get_last_known_good_annotation_key())
            )
            # after trip + rollback the target is rev1 again and rev2
            # was never recorded as an LKG
            assert record == {"lkg": "rev1", "target": "rev1"}
        finally:
            manager.shutdown()


class TestBreakerAndRollback:
    def drive_to_trip(self, auto_rollback=True, **spec):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        policy = remediation_policy(
            remediation=dict(auto_rollback=auto_rollback, **spec)
        )
        manager = make_manager(cluster)
        cycle(manager, fleet, policy, 2)
        fleet.bad_revisions.add("rev2")
        fleet.publish_new_revision("rev2")
        return cluster, fleet, policy, manager

    def test_trip_pauses_admissions_without_rollback(self):
        cluster, fleet, policy, manager = self.drive_to_trip(
            auto_rollback=False
        )
        try:
            cycle(manager, fleet, policy, 25)
            breaker = json.loads(
                ds_annotation(cluster, util.get_breaker_annotation_key())
            )
            assert breaker["state"] == "open"
            assert breaker["target"] == "rev2"
            status = manager.remediation_status()
            assert status["paused"] is True
            # no rollback: the DS target stays on the bad revision
            assert fleet.revision_hash == "rev2"
            # a freshly out-of-sync node (unlimited parallelism, budget
            # available) would be admitted immediately absent the
            # breaker — with it open, the node stays upgrade-required
            fleet.add_node("n99", pod_hash="rev1")
            cycle(manager, fleet, policy, 4)
            assert (
                fleet.node_state("n99")
                == consts.UPGRADE_STATE_UPGRADE_REQUIRED
            ), fleet.states()
        finally:
            manager.shutdown()

    def test_trip_with_auto_rollback_reverts_and_converges(self):
        cluster, fleet, policy, manager = self.drive_to_trip()
        try:
            for _ in range(60):
                cycle(manager, fleet, policy)
                states = set(fleet.states().values())
                if states == {consts.UPGRADE_STATE_DONE}:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                assert (
                    pod["metadata"]["labels"]["controller-revision-hash"]
                    == "rev1"
                )
            from k8s_operator_libs_tpu_torch import metrics

            reg = metrics.default_registry()
            assert reg.counter(
                "remediation_breaker_trips_total",
                "Failure-budget circuit breaker trips.",
            ).value() >= 1
            assert reg.counter(
                "rollbacks_total",
                "Automatic last-known-good DaemonSet rollbacks initiated.",
            ).value() >= 1
        finally:
            manager.shutdown()

    def test_small_sample_does_not_trip(self):
        cluster, fleet, policy, manager = self.drive_to_trip(
            min_attempted=1000
        )
        try:
            cycle(manager, fleet, policy, 10)
            assert (
                ds_annotation(cluster, util.get_breaker_annotation_key())
                is None
            )
            assert manager.remediation_status()["paused"] is False
        finally:
            manager.shutdown()

    def test_breaker_record_retires_after_recovery(self):
        cluster, fleet, policy, manager = self.drive_to_trip()
        try:
            for _ in range(60):
                cycle(manager, fleet, policy)
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            # converged: one more pass retires the rolled-back record
            cycle(manager, fleet, policy, 2)
            assert (
                ds_annotation(cluster, util.get_breaker_annotation_key())
                is None
            )
        finally:
            manager.shutdown()


    def test_republished_bad_revision_trips_again(self):
        """A rolled-back record must not disarm the breaker: if the SAME
        bad revision is published again (user retries the build), the
        breaker trips and rolls back again."""
        cluster, fleet, policy, manager = self.drive_to_trip()
        try:
            for _ in range(60):
                cycle(manager, fleet, policy)
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            from k8s_operator_libs_tpu_torch import metrics

            trips = metrics.default_registry().counter(
                "remediation_breaker_trips_total",
                "Failure-budget circuit breaker trips.",
            )
            first_round = trips.value()
            # the same bad build again: promote the rev2 CR back to newest
            cr = cluster.get(
                "ControllerRevision", "gpu-driver-rev2", NAMESPACE
            )
            newest = max(
                c.get("revision", 0)
                for c in cluster.list(
                    "ControllerRevision", namespace=NAMESPACE
                )
            )
            cluster.patch(
                "ControllerRevision",
                "gpu-driver-rev2",
                {"revision": newest + 1},
                NAMESPACE,
            )
            del cr
            for _ in range(80):
                cycle(manager, fleet, policy)
                if (
                    trips.value() > first_round
                    and fleet.revision_hash == "rev1"
                    and set(fleet.states().values())
                    == {consts.UPGRADE_STATE_DONE}
                ):
                    break
            assert trips.value() > first_round, "breaker did not re-trip"
            assert fleet.revision_hash == "rev1"
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
        finally:
            manager.shutdown()

    def test_rollback_reverts_real_ds_template_from_cr_data(self):
        """On a real cluster pods are recreated from ds.spec.template —
        promoting the LKG ControllerRevision alone would be a no-op
        fight with the DaemonSet controller.  When the CR carries the
        real apiserver's `.data` template patch, the rollback must apply
        it to the DaemonSet (the `kubectl rollout undo` mechanism)."""
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        # decorate the harness CRs with real-apiserver-style data
        for cr in cluster.list("ControllerRevision", namespace=NAMESPACE):
            hash_ = cr["metadata"]["labels"]["controller-revision-hash"]
            cr["data"] = {
                "spec": {"template": {"metadata": {"labels": {
                    "controller-revision-hash": hash_
                }}}}
            }
            cluster.update(cr)
        policy = remediation_policy()
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            cr2 = cluster.get(
                "ControllerRevision", "gpu-driver-rev2", NAMESPACE
            )
            cr2["data"] = {
                "spec": {"template": {"metadata": {"labels": {
                    "controller-revision-hash": "rev2"
                }}}}
            }
            cluster.update(cr2)
            cycle(manager, fleet, policy, 25)
            ds = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
            template_labels = (
                ds.get("spec", {})
                .get("template", {})
                .get("metadata", {})
                .get("labels", {})
            )
            assert template_labels.get("controller-revision-hash") == "rev1", ds.get(
                "spec"
            )
        finally:
            manager.shutdown()

    def test_stale_failures_outside_window_do_not_trip(self):
        """Failures are window-bounded like attempts: a chronic/
        quarantined node whose episode opened before the window must not
        trip the breaker against a revision whose recent record is
        healthy."""
        import time as _time

        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        policy = remediation_policy(
            remediation=dict(min_attempted=2, failure_threshold=0.25)
        )
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            now = _time.time()
            # n0: failed long ago (outside the window), charged to rev1
            cluster.patch(
                "Node",
                "n0",
                {
                    "metadata": {
                        "labels": {
                            STATE_KEY(): consts.UPGRADE_STATE_FAILED
                        },
                        "annotations": {
                            util.get_attempt_count_annotation_key(): "3",
                            util.get_last_failure_at_annotation_key(): repr(
                                now - 7200.0
                            ),
                            util.get_failure_target_annotation_key(): "rev1",
                        },
                    }
                },
            )
            # n1..n3: freshly admitted (in-window attempts, all healthy)
            for name in ("n1", "n2", "n3"):
                cluster.patch(
                    "Node",
                    name,
                    {
                        "metadata": {
                            "annotations": {
                                util.get_admitted_at_annotation_key(): repr(
                                    now - 60.0
                                )
                            }
                        }
                    },
                )
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            decision = manager.remediation.evaluate(
                state, policy, manager.common, now=now
            )
            assert decision.failures == 0, decision.to_dict()
            assert decision.paused is False
            # the same failure INSIDE the window does count
            cluster.patch(
                "Node",
                "n0",
                {
                    "metadata": {
                        "annotations": {
                            util.get_last_failure_at_annotation_key(): repr(
                                now - 30.0
                            )
                        }
                    }
                },
            )
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            decision = manager.remediation.evaluate(
                state, policy, manager.common, now=now
            )
            assert decision.failures == 1
        finally:
            manager.shutdown()

    def test_removing_remediation_block_retires_status_and_gauges(self):
        cluster, fleet, policy, manager = self.drive_to_trip(
            auto_rollback=False
        )
        try:
            cycle(manager, fleet, policy, 25)
            assert manager.remediation_status()["paused"] is True
            from k8s_operator_libs_tpu_torch import metrics

            reg = metrics.default_registry()
            assert "remediation_breaker_state 1" in reg.render()
            # admin disables the engine: remediation block removed
            bare = UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                drain_spec=DrainSpec(
                    enable=True, force=True, timeout_second=10
                ),
            )
            cycle(manager, fleet, bare, 1)
            assert manager.remediation_status() is None
            assert "remediation_breaker_state 0" in reg.render()
        finally:
            manager.shutdown()


class TestSurfaces:
    def _tripped(self):
        helper = TestBreakerAndRollback()
        cluster, fleet, policy, manager = helper.drive_to_trip(
            auto_rollback=False
        )
        cycle(manager, fleet, policy, 25)
        # one stranded pending node so the gate has admissions to block
        fleet.add_node("n99", pod_hash="rev1")
        cycle(manager, fleet, policy, 3)
        return cluster, fleet, policy, manager

    def test_rollout_status_gate_blocks_and_leads(self):
        cluster, fleet, policy, manager = self._tripped()
        try:
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            status = RolloutStatus.from_cluster_state(state, policy=policy)
            gates = {g.gate: g for g in status.gates}
            assert gates["remediation"].blocking is True
            assert "BREAKER OPEN" in gates["remediation"].reason
            # satellite: the first blocking gate LEADS the text surfaces
            assert status.summary().startswith("GATED [remediation]:")
            assert status.render().startswith("BLOCKED [remediation]:")
        finally:
            manager.shutdown()

    def test_rollout_status_gate_closed_when_no_trip(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster)
        policy = remediation_policy()
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            status = RolloutStatus.from_cluster_state(state, policy=policy)
            gates = {g.gate: g for g in status.gates}
            assert gates["remediation"].blocking is False
            # no remediation block -> no gate at all
            bare = UpgradePolicySpec(auto_upgrade=True)
            status2 = RolloutStatus.from_cluster_state(state, policy=bare)
            assert "remediation" not in {g.gate for g in status2.gates}
        finally:
            manager.shutdown()

    def test_report_and_render(self):
        cluster, fleet, policy, manager = self._tripped()
        try:
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            report = remediation_report(state, policy=policy)
            assert report["enabled"] is True
            assert report["blocking"] is True
            assert report["breaker"]["target"] == "rev2"
            assert report["lastKnownGood"]["gpu-driver"]["lkg"] == "rev1"
            assert any(e["attempts"] >= 1 for e in report["nodes"])
            text = render_report(report)
            assert "OPEN" in text and "ADMISSIONS PAUSED" in text
        finally:
            manager.shutdown()

    def test_metrics_published(self):
        cluster, fleet, policy, manager = self._tripped()
        try:
            from k8s_operator_libs_tpu_torch import metrics

            reg = metrics.default_registry()
            rendered = reg.render()
            assert "remediation_breaker_state 1" in rendered
            assert "quarantined_nodes" in rendered
        finally:
            manager.shutdown()


class TestRetryBudget:
    def test_backoff_delays_retry(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=2)
        policy = remediation_policy(
            remediation=dict(backoff_seconds=3600.0, min_attempted=1000)
        )
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            cycle(manager, fleet, policy, 12)
            # nodes failed; the hour-long backoff parks them in failed
            # (no immediate retry churn)
            states = fleet.states()
            assert consts.UPGRADE_STATE_FAILED in set(states.values())
            for name, state in states.items():
                if state != consts.UPGRADE_STATE_FAILED:
                    continue
                ann = cluster.get("Node", name)["metadata"].get(
                    "annotations"
                ) or {}
                assert ann.get(util.get_attempt_count_annotation_key()) == "1"
                assert util.get_last_failure_at_annotation_key() in ann
        finally:
            manager.shutdown()

    def test_selfheal_emits_event_and_closes_episode(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=2)
        recorder = util.EventRecorder()
        policy = remediation_policy(
            remediation=dict(min_attempted=1000, backoff_seconds=3600.0)
        )
        manager = ClusterUpgradeStateManager(
            cluster,
            cache=InformerCache(cluster, lag_seconds=0.0),
            recorder=recorder,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
        )
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            cycle(manager, fleet, policy, 10)
            assert consts.UPGRADE_STATE_FAILED in set(
                fleet.states().values()
            )
            # ops repairs the bad release out-of-band: pods come back
            # healthy at rev2
            fleet.bad_revisions.clear()
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                statuses = pod["status"].get("containerStatuses") or []
                if any(not s.get("ready") for s in statuses):
                    cluster.delete(
                        "Pod",
                        pod["metadata"]["name"],
                        pod["metadata"]["namespace"],
                    )
            fleet.reconcile_daemonset()
            for _ in range(30):
                cycle(manager, fleet, policy)
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            # settle: the release pass runs at the NEXT evaluate after a
            # node lands in done
            cycle(manager, fleet, policy, 2)
            assert any(
                "self-healed" in m for m in recorder.messages()
            ), recorder.messages()[-10:]
            # success resets the budget: counters cleared at done
            for node in cluster.list("Node"):
                ann = node["metadata"].get("annotations") or {}
                assert (
                    util.get_attempt_count_annotation_key() not in ann
                ), ann
                assert util.get_last_failure_at_annotation_key() not in ann
        finally:
            manager.shutdown()

    def test_quarantine_released_after_out_of_band_repair(self):
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=2)
        policy = remediation_policy(
            remediation=dict(
                min_attempted=1000, max_node_attempts=1, backoff_seconds=0.0
            )
        )
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            for _ in range(20):
                cycle(manager, fleet, policy)
                quarantined = [
                    n
                    for n in cluster.list("Node")
                    if is_remediation_quarantined(n)
                ]
                if quarantined:
                    break
            assert quarantined, fleet.states()
            node = quarantined[0]
            taints = (node.get("spec") or {}).get("taints") or []
            assert any(
                t.get("key") == util.get_quarantine_taint_key()
                for t in taints
            )
            # repair out-of-band: healthy pods at rev2 again
            fleet.bad_revisions.clear()
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                statuses = pod["status"].get("containerStatuses") or []
                if any(not s.get("ready") for s in statuses):
                    cluster.delete(
                        "Pod",
                        pod["metadata"]["name"],
                        pod["metadata"]["namespace"],
                    )
            fleet.reconcile_daemonset()
            for _ in range(30):
                cycle(manager, fleet, policy)
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                } and not any(
                    is_remediation_quarantined(n)
                    for n in cluster.list("Node")
                ):
                    break
            for n in cluster.list("Node"):
                assert not is_remediation_quarantined(n)
                taints = (n.get("spec") or {}).get("taints") or []
                assert not any(
                    t.get("key") == util.get_quarantine_taint_key()
                    for t in taints
                )
        finally:
            manager.shutdown()

    def test_quarantine_releases_even_after_engine_disabled(self):
        """Leftover quarantines must not outlive a removed remediation
        block: the release path (repaired node back at done, in sync)
        runs with the engine OFF too, lifting the taint and annotation."""
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=2)
        policy = remediation_policy(
            remediation=dict(
                min_attempted=1000, max_node_attempts=1, backoff_seconds=0.0
            )
        )
        manager = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            for _ in range(20):
                cycle(manager, fleet, policy)
                if any(
                    is_remediation_quarantined(n)
                    for n in cluster.list("Node")
                ):
                    break
            assert any(
                is_remediation_quarantined(n) for n in cluster.list("Node")
            )
            # engine off + out-of-band repair
            bare = UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                drain_spec=DrainSpec(
                    enable=True, force=True, timeout_second=10
                ),
            )
            fleet.bad_revisions.clear()
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                statuses = pod["status"].get("containerStatuses") or []
                if any(not s.get("ready") for s in statuses):
                    cluster.delete(
                        "Pod",
                        pod["metadata"]["name"],
                        pod["metadata"]["namespace"],
                    )
            fleet.reconcile_daemonset()
            for _ in range(30):
                cycle(manager, fleet, bare)
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                } and not any(
                    is_remediation_quarantined(n)
                    for n in cluster.list("Node")
                ):
                    break
            for n in cluster.list("Node"):
                assert not is_remediation_quarantined(n), n["metadata"]
                taints = (n.get("spec") or {}).get("taints") or []
                assert not any(
                    t.get("key") == util.get_quarantine_taint_key()
                    for t in taints
                )
        finally:
            manager.shutdown()

    def test_health_manager_leaves_remediation_quarantine_alone(self):
        from k8s_operator_libs_tpu_torch.tpu.health import SliceHealthManager

        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=2)
        del fleet
        key = util.get_quarantine_annotation_key()
        cluster.patch(
            "Node",
            "n0",
            {
                "metadata": {
                    "annotations": {
                        key: consts.REMEDIATION_QUARANTINE_PREFIX + "node:n0"
                    }
                }
            },
        )
        SliceHealthManager(cluster).reconcile()
        value = (cluster.get("Node", "n0")["metadata"].get("annotations") or {}).get(
            key
        )
        assert value == consts.REMEDIATION_QUARANTINE_PREFIX + "node:n0"


class TestStateIndexRemediationWrites:
    def test_bookkeeping_write_does_not_dirty_fleet(self):
        from k8s_operator_libs_tpu_torch.upgrade.state_index import ClusterStateIndex

        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=4)
        del fleet
        index = ClusterStateIndex(cluster, NAMESPACE, dict(DRIVER_LABELS))
        state, dirty = index.build_state()
        assert dirty is None  # seed: unknown, scan everything
        index.ack_dirty()
        state, dirty = index.build_state()
        assert dirty == set()
        index.ack_dirty()
        # a remediation bookkeeping write on the DS...
        cluster.patch(
            "DaemonSet",
            "gpu-driver",
            {
                "metadata": {
                    "annotations": {
                        util.get_last_known_good_annotation_key(): json.dumps(
                            {"lkg": "rev1", "target": "rev1"}
                        )
                    }
                }
            },
            NAMESPACE,
        )
        state, dirty = index.build_state()
        # ...must NOT dirty the fleet (dirty stays empty, not None)
        assert dirty == set(), dirty
        # and the handed-out snapshot still sees the fresh annotation
        ds = state.all_node_states()[0].driver_daemonset
        assert (
            util.get_last_known_good_annotation_key()
            in (ds["metadata"].get("annotations") or {})
        )
        # a REAL DaemonSet change still dirties everything
        ds_obj = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
        ds_obj["status"]["desiredNumberScheduled"] = 4
        cluster.update(ds_obj)
        state, dirty = index.build_state()
        assert dirty is None

    def test_indexed_manager_equivalent_under_remediation(self):
        """The incremental build must agree with the full rebuild while
        the remediation engine is writing its annotations mid-rollback."""
        cluster = InMemoryCluster()
        fleet = healthy_fleet(cluster, nodes=4)
        policy = remediation_policy()
        manager = ClusterUpgradeStateManager(
            cluster,
            cache=InformerCache(cluster, lag_seconds=0.0),
            use_state_index=True,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
        )
        probe = make_manager(cluster)
        try:
            cycle(manager, fleet, policy, 2)
            fleet.bad_revisions.add("rev2")
            fleet.publish_new_revision("rev2")
            for _ in range(40):
                state = manager.build_state(NAMESPACE, DRIVER_LABELS)
                full = probe._build_state(NAMESPACE, DRIVER_LABELS)
                assert state == full
                manager.apply_state(state, policy)
                manager.drain_manager.wait_idle(10.0)
                manager.pod_manager.wait_idle(10.0)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            assert set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }, fleet.states()
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                assert (
                    pod["metadata"]["labels"]["controller-revision-hash"]
                    == "rev1"
                )
        finally:
            manager.shutdown()
            probe.shutdown()
