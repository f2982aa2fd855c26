"""The port's state machine (k8s_operator_libs_tpu_torch/upgrade/
upgrade_state.py): BuildState + ApplyState on its in-memory cluster.

Every class of ``tests/test_upgrade_state.py``, as cases of the same
names, runs here on the port in its vocabulary, over the port's harness
(``tests/test_torch_harness.py``): BuildState (empty, scheduled,
unscheduled, orphaned), ApplyState for every state, the
maxParallelUpgrades x maxUnavailable throttle matrix, pod deletion,
drain policy, pod restart, safe load, validation, uncordon, the
upgrade-requested annotation flow, the slice-aware and multislice
throttles, the cascade, the write pipeline and the PDB-aware drain.
"""

import time

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    PodDeletionSpec,
    UpgradePolicySpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import (
    get_annotation,
    get_label,
    make_node,
    make_pod,
    set_condition,
)
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
    ClusterUpgradeStateManager,
    UpgradeStateError,
)

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def recorder():
    return util.EventRecorder()


@pytest.fixture()
def cluster():
    return InMemoryCluster()


@pytest.fixture()
def fleet(cluster):
    return Fleet(cluster)


def make_manager(cluster, **kwargs):
    return ClusterUpgradeStateManager(
        cluster,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
        **kwargs,
    )


def reconcile(manager, fleet, policy, cycles=1, settle=True):
    """One or more reconcile rounds: build → apply → wait for async work →
    fake DS controller recreates deleted driver pods."""
    for _ in range(cycles):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        if settle:
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()


def run_to_completion(manager, fleet, policy, max_cycles=20):
    for _ in range(max_cycles):
        reconcile(manager, fleet, policy)
        states = set(fleet.states().values())
        if states == {consts.UPGRADE_STATE_DONE}:
            return True
    return False


class TestBuildState:
    def test_empty_cluster(self, cluster):
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        assert state.node_states == {}

    def test_buckets_by_state_label(self, cluster, fleet):
        fleet.add_node("n1")
        n2 = fleet.add_node("n2")
        cluster.patch(
            "Node",
            "n2",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): consts.UPGRADE_STATE_DONE
                    }
                }
            },
        )
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        assert len(state.nodes_in(consts.UPGRADE_STATE_UNKNOWN)) == 1
        assert len(state.nodes_in(consts.UPGRADE_STATE_DONE)) == 1

    def test_unscheduled_pods_hard_error(self, cluster, fleet):
        fleet.add_node("n1")
        fleet._bump_desired(+1)  # desired=2 but only one pod exists
        manager = make_manager(cluster)
        with pytest.raises(UpgradeStateError, match="unscheduled"):
            manager.build_state(NAMESPACE, DRIVER_LABELS)

    def test_orphaned_pods_included_without_daemonset(self, cluster, fleet):
        fleet.add_node("n1")
        cluster.create(make_node("n-orphan"))
        cluster.create(
            make_pod(
                "orphan-pod",
                NAMESPACE,
                "n-orphan",
                labels=dict(DRIVER_LABELS),
                revision_hash="whatever",
            )
        )
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        unknown = state.nodes_in(consts.UPGRADE_STATE_UNKNOWN)
        assert len(unknown) == 2
        orphaned = [ns for ns in unknown if ns.is_orphaned_pod()]
        assert len(orphaned) == 1

    def test_pending_unassigned_pod_skipped(self, cluster, fleet):
        fleet.add_node("n1")
        pod = make_pod(
            "floating",
            NAMESPACE,
            "",
            labels=dict(DRIVER_LABELS),
            owner=fleet.ds,
            phase="Pending",
            revision_hash="x",
        )
        cluster.create(pod)
        fleet._bump_desired(+1)
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        assert len(state.all_node_states()) == 1


class TestApplyStateGuards:
    def test_nil_state_rejected(self, cluster):
        manager = make_manager(cluster)
        with pytest.raises(UpgradeStateError):
            manager.apply_state(None, UpgradePolicySpec(auto_upgrade=True))

    def test_disabled_policy_is_noop(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="old")
        fleet.publish_new_revision("new")
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, UpgradePolicySpec(auto_upgrade=False))
        manager.apply_state(state, None)
        assert fleet.node_state("n1") == ""


class TestClassification:
    def test_in_sync_unknown_becomes_done(self, cluster, fleet):
        fleet.add_node("n1")
        manager = make_manager(cluster)
        reconcile(manager, fleet, UpgradePolicySpec(auto_upgrade=True))
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE

    def test_out_of_sync_becomes_upgrade_required_then_progresses(
        self, cluster, fleet
    ):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True, max_parallel_upgrades=0)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        # one ApplyState only advances a node through the phases of its
        # snapshot bucket — classification lands it in upgrade-required and
        # the throttle picks it up on the NEXT reconcile (the buckets are
        # fixed at BuildState, reference upgrade_state.go:158-160)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        assert fleet.node_state("n1") in (
            consts.UPGRADE_STATE_CORDON_REQUIRED,
            consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
        )

    def test_upgrade_requested_annotation_forces_cycle(self, cluster, fleet):
        fleet.add_node("n1")  # in sync
        cluster.patch(
            "Node",
            "n1",
            {
                "metadata": {
                    "annotations": {
                        util.get_upgrade_requested_annotation_key(): "true"
                    }
                }
            },
        )
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        node = cluster.get("Node", "n1")
        assert (
            get_label(node, util.get_upgrade_state_label_key())
            == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )
        # next reconcile: the throttle phase consumes the annotation
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        node = cluster.get("Node", "n1")
        assert (
            util.get_upgrade_requested_annotation_key()
            not in node["metadata"]["annotations"]
        )

    def test_safe_load_waiting_forces_cycle(self, cluster, fleet):
        fleet.add_node("n1")
        cluster.patch(
            "Node",
            "n1",
            {
                "metadata": {
                    "annotations": {
                        util.get_wait_for_safe_load_annotation_key(): "pod-x"
                    }
                }
            },
        )
        manager = make_manager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, UpgradePolicySpec(auto_upgrade=True))
        assert fleet.node_state("n1") != consts.UPGRADE_STATE_DONE


class TestFullLifecycle:
    def test_single_node_full_upgrade(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy)
        node = cluster.get("Node", "n1")
        assert node["spec"]["unschedulable"] is False  # uncordoned at end
        pods = cluster.list("Pod", namespace=NAMESPACE)
        assert [get_label(p, "controller-revision-hash") for p in pods] == ["rev2"]

    def test_multi_node_rolling_upgrade_respects_serial_order(
        self, cluster, fleet
    ):
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        seen_in_progress = []
        for _ in range(40):
            reconcile(manager, fleet, policy)
            states = fleet.states()
            in_progress = [
                n
                for n, s in states.items()
                if s
                not in ("", consts.UPGRADE_STATE_DONE, consts.UPGRADE_STATE_UPGRADE_REQUIRED)
            ]
            seen_in_progress.append(len(in_progress))
            if set(states.values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}
        assert max(seen_in_progress) <= 1  # maxParallel=1 honored

    def test_initially_cordoned_node_stays_cordoned(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1", unschedulable=True)
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy)
        node = cluster.get("Node", "n1")
        assert node["spec"]["unschedulable"] is True  # uncordon skipped
        assert (
            util.get_upgrade_initial_state_annotation_key()
            not in node["metadata"]["annotations"]
        )

    def test_wait_for_jobs_then_pod_deletion_then_drain(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        rs = {"kind": "ReplicaSet", "metadata": {"name": "rs", "namespace": "ml"}}
        cluster.create(
            make_pod("job", "ml", "n1", labels={"kind": "job"}, owner=rs,
                     phase="Succeeded")
        )
        cluster.create(
            make_pod("sidecar", "ml", "n1", labels={"kind": "deletable"}, owner=rs)
        )
        manager = make_manager(cluster).with_pod_deletion_enabled(
            lambda pod: get_label(pod, "kind") == "deletable"
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            wait_for_completion=WaitForCompletionSpec(pod_selector="kind=job"),
            pod_deletion=PodDeletionSpec(force=True, timeout_second=10),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=30)
        remaining = [p["metadata"]["name"] for p in cluster.list("Pod", namespace="ml")]
        assert remaining == ["job"]  # deletable evicted, finished job left

    def test_validation_gate(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster).with_validation_enabled("app=validator")
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        for _ in range(10):
            reconcile(manager, fleet, policy)
        # no validator pod yet → parked in validation-required
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_VALIDATION_REQUIRED
        vpod = make_pod("validator", NAMESPACE, "n1", labels={"app": "validator"})
        vpod["status"]["containerStatuses"] = [{"name": "v", "ready": True}]
        cluster.create(vpod)
        assert run_to_completion(manager, fleet, policy)

    def test_failing_driver_pod_goes_failed_then_self_heals(
        self, cluster, fleet
    ):
        fleet.add_node("n1", pod_hash="rev1", pod_ready=False, restart_count=11)
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)  # drain disabled
        for _ in range(6):
            reconcile(manager, fleet, policy, settle=True)
            if fleet.node_state("n1") == consts.UPGRADE_STATE_FAILED:
                break
        # restart loop: recreated pod also arrives failing
        pods = cluster.list("Pod", namespace=NAMESPACE)
        for p in pods:
            p["status"]["containerStatuses"][0].update(
                {"ready": False, "restartCount": 11}
            )
            cluster.update(p)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_FAILED
        # now the pod comes up healthy at the new revision → self-heal
        for p in cluster.list("Pod", namespace=NAMESPACE):
            p["status"]["containerStatuses"][0].update(
                {"ready": True, "restartCount": 0}
            )
            p["metadata"]["labels"]["controller-revision-hash"] = "rev2"
            cluster.update(p)
        assert run_to_completion(manager, fleet, policy)


class TestObservability:
    def test_aggregate_progress_event_emitted(self, cluster, fleet, recorder):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster, recorder=recorder)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy, cycles=2)
        progress = [m for m in recorder.messages() if "Upgrade progress" in m]
        assert progress and "pending" in progress[-1]

    def test_progress_event_silent_at_steady_state(
        self, cluster, fleet, recorder
    ):
        fleet.add_node("n1")  # in sync: nothing to do
        manager = make_manager(cluster, recorder=recorder)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy, cycles=3)
        assert not [m for m in recorder.messages() if "Upgrade progress" in m]

    def test_zap_level_mapping(self):
        import logging

        from k8s_operator_libs_tpu_torch import consts as shared_consts

        assert shared_consts.stdlib_level(shared_consts.LOG_LEVEL_ERROR) == logging.ERROR
        assert shared_consts.stdlib_level(shared_consts.LOG_LEVEL_DEBUG) == logging.DEBUG
        assert shared_consts.stdlib_level(7) == logging.DEBUG  # chattier clamps
        assert shared_consts.stdlib_level(-5) == logging.ERROR  # severe clamps up


class TestOrphanedPodLifecycle:
    def test_orphaned_pod_classifies_done_until_requested(self, cluster, fleet):
        """Reference semantics (upgrade_state_test.go:1180-1295): an
        orphaned driver pod does NOT trigger an upgrade by itself —
        classification forces upgrade only when out-of-sync AND owned.  An
        explicit upgrade-requested annotation pushes the orphaned node
        through the flow; the restart phase deletes the orphan and the DS
        controller's replacement (owned, current revision) completes it."""
        fleet.add_node("n-owned")
        cluster.create(make_node("n-orphan"))
        cluster.create(
            make_pod(
                "orphan-pod",
                NAMESPACE,
                "n-orphan",
                labels=dict(DRIVER_LABELS),
                revision_hash="rev1",
            )
        )
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True, max_parallel_upgrades=0)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n-orphan") == consts.UPGRADE_STATE_DONE
        assert cluster.exists("Pod", "orphan-pod", NAMESPACE)
        # force an upgrade cycle on the orphaned node
        cluster.patch(
            "Node",
            "n-orphan",
            {
                "metadata": {
                    "annotations": {
                        util.get_upgrade_requested_annotation_key(): "true"
                    }
                }
            },
        )
        for _ in range(10):
            reconcile(manager, fleet, policy)
            if not cluster.exists("Pod", "orphan-pod", NAMESPACE):
                break
        # the restart phase deleted the orphan; with no DaemonSet targeting
        # the node, it drops out of BuildState (reference semantics: nodes
        # are managed through their driver pods)
        assert not cluster.exists("Pod", "orphan-pod", NAMESPACE)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        assert {ns.node["metadata"]["name"] for ns in state.all_node_states()} == {
            "n-owned"
        }


class TestThrottleMatrix:
    """Reference: upgrade_state_test.go:294-613."""

    @pytest.mark.parametrize(
        "max_parallel,max_unavailable,expect_started",
        [
            (1, None, 1),
            (2, None, 2),
            (4, None, 4),
            (0, None, 8),          # 0 = unlimited
            (8, 2, 2),             # absolute maxUnavailable caps
            (8, "25%", 2),         # 25% of 8
            (8, "50%", 4),
            (0, "25%", 2),         # unlimited parallel still capped
            (3, "100%", 3),
        ],
    )
    def test_slots(self, cluster, fleet, max_parallel, max_unavailable, expect_started):
        for i in range(8):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=max_parallel,
            max_unavailable=(
                IntOrString(max_unavailable) if max_unavailable is not None else None
            ),
        )
        # cycle 1: classification; cycle 2: throttle admits
        reconcile(manager, fleet, policy, cycles=2)
        states = fleet.states()
        started = [
            n
            for n, s in states.items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert len(started) == expect_started

    def test_precordoned_nodes_bypass_throttle(self, cluster, fleet):
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1", unschedulable=(i < 2))
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("100%"),
        )
        reconcile(manager, fleet, policy, cycles=2)
        states = fleet.states()
        started = {
            n
            for n, s in states.items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        }
        # the two pre-cordoned nodes progress regardless of the 1-slot limit
        assert {"n0", "n1"} <= started

    def test_unavailable_nodes_consume_budget(self, cluster, fleet):
        fleet.add_node("sick", pod_hash="rev1", ready=False)
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),  # the sick node eats the budget
        )
        reconcile(manager, fleet, policy, cycles=2)
        healthy_started = [
            n
            for n, s in fleet.states().items()
            if n != "sick" and s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert healthy_started == []

    def test_garbage_state_label_does_not_leak_slots(self, cluster, fleet):
        # Regression: a corrupted state label must not permanently consume
        # maxParallelUpgrades budget and stall the rollout.
        fleet.add_node("corrupt", pod_hash="rev1")
        cluster.patch(
            "Node",
            "corrupt",
            {
                "metadata": {
                    "labels": {util.get_upgrade_state_label_key(): "some-garbage"}
                }
            },
        )
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("100%"),
        )
        reconcile(manager, fleet, policy, cycles=2)
        assert fleet.node_state("n1") not in (
            "",
            consts.UPGRADE_STATE_UPGRADE_REQUIRED,
        )

    def test_prefix_overlapping_daemonset_revisions_isolated(self, cluster):
        from k8s_operator_libs_tpu_torch.cluster.objects import (
            make_controller_revision,
            make_daemonset,
        )
        from k8s_operator_libs_tpu_torch.upgrade.pod_manager import PodManager

        ds_a = cluster.create(make_daemonset("gpu-driver", NAMESPACE))
        ds_b = cluster.create(make_daemonset("gpu-driver-v2", NAMESPACE))
        cluster.create(make_controller_revision(ds_a, 1, "aaa"))
        cluster.create(make_controller_revision(ds_b, 9, "zzz"))
        mgr = PodManager(cluster, provider=None)
        assert mgr.get_daemonset_controller_revision_hash(ds_a) == "aaa"
        assert mgr.get_daemonset_controller_revision_hash(ds_b) == "zzz"

    def test_skip_label_excludes_node(self, cluster, fleet):
        fleet.add_node(
            "skipme",
            pod_hash="rev1",
            labels={util.get_upgrade_skip_node_label_key(): "true"},
        )
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True, max_parallel_upgrades=8)
        reconcile(manager, fleet, policy, cycles=2)
        assert fleet.node_state("skipme") == consts.UPGRADE_STATE_UPGRADE_REQUIRED


class TestPolicyVariants:
    """Reference: the drain-policy matrix (upgrade_state_test.go:696-788)
    at the state-machine level, plus mid-rollout perturbations.  The
    pod-deletion matrix (:615-694) is covered in TestFullLifecycle and
    tests/test_node_managers.py::TestPodEviction."""

    def test_drain_pod_selector_spares_unselected_pods(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        rs = {"kind": "ReplicaSet", "metadata": {"name": "rs", "namespace": "ml"}}
        cluster.create(
            make_pod("evictme", "ml", "n1", labels={"tier": "batch"}, owner=rs)
        )
        cluster.create(
            make_pod("keepme", "ml", "n1", labels={"tier": "critical"}, owner=rs)
        )
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(
                enable=True, force=True, pod_selector="tier=batch",
                timeout_second=10,
            ),
        )
        assert run_to_completion(manager, fleet, policy)
        remaining = [p["metadata"]["name"] for p in cluster.list("Pod", namespace="ml")]
        assert remaining == ["keepme"]

    def test_revision_bump_mid_rollout_converges_to_newest(self, cluster, fleet):
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        # progress partway, then a newer revision lands
        for _ in range(8):
            reconcile(manager, fleet, policy)
        fleet.publish_new_revision("rev3")
        assert run_to_completion(manager, fleet, policy, max_cycles=60)
        hashes = {
            get_label(p, "controller-revision-hash")
            for p in cluster.list("Pod", namespace=NAMESPACE)
        }
        assert hashes == {"rev3"}

    def test_node_turning_not_ready_pauses_new_admissions(self, cluster, fleet):
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),
        )
        reconcile(manager, fleet, policy)  # classification
        # a node goes NotReady before any admission
        sick = cluster.get("Node", "n3")
        set_condition(sick, "Ready", "False")
        cluster.update(sick)
        reconcile(manager, fleet, policy)
        started = [
            n
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert started == []  # the sick node consumed the whole budget
        # node recovers: admissions resume
        sick = cluster.get("Node", "n3")
        set_condition(sick, "Ready", "True")
        cluster.update(sick)
        reconcile(manager, fleet, policy)
        started = [
            n
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert len(started) == 1

    def test_wait_for_jobs_timeout_at_state_level(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        rs = {"kind": "ReplicaSet", "metadata": {"name": "rs", "namespace": "ml"}}
        cluster.create(
            make_pod("stuck-job", "ml", "n1", labels={"kind": "job"}, owner=rs,
                     phase="Running")
        )
        manager = make_manager(cluster)
        # large timeout: expiry is driven by explicit backdating below, so
        # wall-clock hiccups on a loaded machine can't trip it early
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            wait_for_completion=WaitForCompletionSpec(
                pod_selector="kind=job", timeout_second=3600
            ),
        )
        for _ in range(4):
            reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED
        # back-date the tracked start time past the timeout to force expiry
        key = util.get_wait_for_pod_completion_start_time_annotation_key()
        cluster.patch(
            "Node",
            "n1",
            {"metadata": {"annotations": {key: str(int(time.time()) - 7200)}}},
        )
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") in (
            consts.UPGRADE_STATE_POD_DELETION_REQUIRED,
            consts.UPGRADE_STATE_DRAIN_REQUIRED,
            consts.UPGRADE_STATE_POD_RESTART_REQUIRED,
        )


class TestSliceAwareThrottle:
    """TPU-native: unavailability counted in slice domains (SURVEY §7.4)."""

    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]

    def _fleet_with_slices(self, cluster, fleet, slices=2, hosts_per_slice=4):
        for s in range(slices):
            for h in range(hosts_per_slice):
                fleet.add_node(
                    f"slice{s}-host{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"slice-{s}"},
                )
        fleet.publish_new_revision("rev2")

    def test_whole_slice_coscheduled_as_one_slot(self, cluster, fleet):
        self._fleet_with_slices(cluster, fleet, slices=2, hosts_per_slice=4)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("50%"),
            slice_aware=True,
        )
        reconcile(manager, fleet, policy, cycles=2)
        states = fleet.states()
        started = {
            n
            for n, s in states.items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        }
        # exactly one whole slice (4 hosts), not one host
        assert len(started) == 4
        slices_started = {n.split("-")[0] for n in started}
        assert len(slices_started) == 1

    def test_node_mode_would_strand_slice_budget(self, cluster, fleet):
        # Contrast case documenting the win: without slice_aware, 25% of 8
        # nodes = 2 hosts from (potentially) the same slice, leaving the
        # other slice untouched but the first slice half-broken.
        self._fleet_with_slices(cluster, fleet, slices=2, hosts_per_slice=4)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("25%"),
            slice_aware=False,
        )
        reconcile(manager, fleet, policy, cycles=2)
        started = [
            n
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert len(started) == 2  # half a slice — the failure mode

    def test_slice_aware_full_rolling_upgrade(self, cluster, fleet):
        self._fleet_with_slices(cluster, fleet, slices=3, hosts_per_slice=2)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("34%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=60)

    def test_mixed_slice_and_singleton_nodes(self, cluster, fleet):
        fleet.add_node(
            "s0-h0", pod_hash="rev1", labels={self.SLICE_KEY: "s0"}
        )
        fleet.add_node(
            "s0-h1", pod_hash="rev1", labels={self.SLICE_KEY: "s0"}
        )
        fleet.add_node("lonely", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),  # one *domain*
            slice_aware=True,
        )
        reconcile(manager, fleet, policy, cycles=2)
        started = {
            n
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        }
        # exactly one domain started: either both s0 hosts or just lonely
        assert started in ({"s0-h0", "s0-h1"}, {"lonely"})


class TestMultisliceThrottle:
    """TPU-native: a DCN-coupled multislice job group (MegaScale-style)
    is one atomic domain — all member slices co-schedule and count once
    toward maxUnavailable, because draining any slice kills the job."""

    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
    GROUP_KEY = consts.MULTISLICE_GROUP_LABEL_KEYS[0]

    def _multislice_fleet(self, fleet):
        """job-A spans slices s0+s1 (2 hosts each); s2 is independent."""
        for s in range(2):
            for h in range(2):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}", self.GROUP_KEY: "job-A"},
                )
        for h in range(2):
            fleet.add_node(
                f"s2-h{h}", pod_hash="rev1", labels={self.SLICE_KEY: "s2"}
            )
        fleet.publish_new_revision("rev2")

    def test_whole_job_group_coscheduled_as_one_slot(self, cluster, fleet):
        self._multislice_fleet(fleet)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),  # one *domain* of the two
            slice_aware=True,
        )
        reconcile(manager, fleet, policy, cycles=2)
        started = {
            n
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        }
        # either all 4 hosts of job-A advanced together, or the 2 hosts of
        # the independent slice — never a partial job group
        assert started in ({"s0-h0", "s0-h1", "s1-h0", "s1-h1"},
                           {"s2-h0", "s2-h1"})

    def test_sick_host_in_one_slice_blocks_whole_group_budget(
        self, cluster, fleet
    ):
        self._multislice_fleet(fleet)
        # one host of s1 is down: job-A's domain is already unavailable,
        # consuming the single maxUnavailable slot — nothing new starts
        sick = cluster.get("Node", "s1-h0")
        set_condition(sick, "Ready", "False")
        cluster.update(sick)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),
            slice_aware=True,
        )
        reconcile(manager, fleet, policy, cycles=2)
        advanced = {
            n
            for n, s in fleet.states().items()
            if s
            not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED,
                    consts.UPGRADE_STATE_DONE)
        }
        assert advanced == set()

    def test_multislice_full_rolling_upgrade(self, cluster, fleet):
        self._multislice_fleet(fleet)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString(1),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=60)


class TestCascadeReconcile:
    """Pipelined ApplyState: one pass carries a node through every
    synchronous transition (bucket migration between phases), cutting the
    reconcile count per wave roughly in half.  Off by default — the
    reference advances one state per reconcile (its requeue cycle is the
    event loop, SURVEY §3.2) — and opt-in via the ``cascade`` flag."""

    DRAIN = DrainSpec(enable=True, force=True, timeout_second=10)

    def test_one_pass_reaches_drain_completion(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster, cascade=True)
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=1, drain_spec=self.DRAIN
        )
        # cycle 1: admission → cordon → wait-for-jobs → drain scheduled,
        # async drain lands pod-restart-required before the settle returns
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        # non-cascade advances exactly one transition in the same cycle
        cluster2 = InMemoryCluster()
        fleet2 = Fleet(cluster2)
        fleet2.add_node("n1", pod_hash="rev1")
        fleet2.publish_new_revision("rev2")
        plain = make_manager(cluster2)
        reconcile(plain, fleet2, policy)
        assert fleet2.node_state("n1") == consts.UPGRADE_STATE_UPGRADE_REQUIRED

    def test_full_upgrade_in_three_cycles(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster, cascade=True)
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=1, drain_spec=self.DRAIN
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=3)
        node = cluster.get("Node", "n1")
        assert node["spec"]["unschedulable"] is False
        pods = cluster.list("Pod", namespace=NAMESPACE)
        assert [get_label(p, "controller-revision-hash") for p in pods] == ["rev2"]

    def test_cascade_respects_slice_throttle(self, cluster, fleet):
        slice_key = consts.SLICE_ID_LABEL_KEYS[0]
        for s in range(2):
            for h in range(4):
                fleet.add_node(
                    f"s{s}-h{h}", pod_hash="rev1", labels={slice_key: f"sl-{s}"}
                )
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster, cascade=True)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("50%"),
            slice_aware=True,
            drain_spec=self.DRAIN,
        )
        reconcile(manager, fleet, policy)
        # exactly one whole slice in flight despite the deep cascade
        active_slices = {
            n.split("-")[0]
            for n, s in fleet.states().items()
            if s not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        }
        assert len(active_slices) == 1
        assert run_to_completion(manager, fleet, policy, max_cycles=10)

    def test_cascade_with_optional_states_and_requestor_untouched(
        self, cluster, fleet
    ):
        """Cascade + wait-for-jobs + validation still settle correctly."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster, cascade=True).with_validation_enabled(
            "app=validator"
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=1, drain_spec=self.DRAIN
        )
        # cascade parks in validation-required (no validator pod yet) in 3
        # cycles: pass 1 ends drain-scheduled → async pod-restart-required;
        # pass 2 schedules the driver-pod restart (recreated between
        # cycles); pass 3 sees the pod in sync and cascades into validation
        reconcile(manager, fleet, policy, cycles=3)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_VALIDATION_REQUIRED
        vpod = make_pod("validator", NAMESPACE, "n1", labels={"app": "validator"})
        vpod["status"]["containerStatuses"] = [{"name": "v", "ready": True}]
        cluster.create(vpod)
        # one more pass: validation → uncordon → done cascades through
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE


class TestWritePipeline:
    """write_pipeline_workers > 0: phase processors overlap node patches
    over a bounded pool with a per-phase barrier (provider
    .pipelined_writes) — same final states and observable transition
    order as sequential writes, round trips amortized (built for the
    HTTP path, exercised here over the in-memory cluster where any
    ordering bug still corrupts the rollout)."""

    DRAIN = DrainSpec(enable=True, force=True, timeout_second=10)

    def _fleet(self, cluster, n=8):
        fleet = Fleet(cluster)
        slice_key = consts.SLICE_ID_LABEL_KEYS[0]
        for s in range(n // 4):
            for h in range(4):
                fleet.add_node(
                    f"s{s}-h{h}", pod_hash="rev1",
                    labels={slice_key: f"sl-{s}"},
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def test_pipelined_rollout_converges_like_sequential(self, cluster):
        fleet = self._fleet(cluster)
        manager = make_manager(
            cluster, cascade=True, write_pipeline_workers=8
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("50%"),
            slice_aware=True,
            drain_spec=self.DRAIN,
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=10)
        for node in cluster.list("Node"):
            assert node["spec"]["unschedulable"] is False
        pods = cluster.list("Pod", namespace=NAMESPACE)
        assert {get_label(p, "controller-revision-hash") for p in pods} == {
            "rev2"
        }

    def test_pipelined_non_cascade_converges(self, cluster):
        fleet = self._fleet(cluster)
        manager = make_manager(cluster, write_pipeline_workers=4)
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"), drain_spec=self.DRAIN,
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=30)

    def test_patch_failure_surfaces_at_phase_barrier(self, cluster):
        """A failed pipelined patch must abort the pass like a
        synchronous failure would — late, but never silently."""
        fleet = self._fleet(cluster, n=4)

        class FailingCluster:
            def __init__(self, inner):
                self._inner = inner
                self.fail_node = None

            def patch(self, kind, name, patch, **kw):
                if kind == "Node" and name == self.fail_node:
                    raise RuntimeError("injected patch failure")
                return self._inner.patch(kind, name, patch, **kw)

            def __getattr__(self, attr):
                return getattr(self._inner, attr)

        wrapped = FailingCluster(cluster)
        manager = ClusterUpgradeStateManager(
            wrapped,
            cascade=True,
            write_pipeline_workers=4,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"), drain_spec=self.DRAIN,
        )
        wrapped.fail_node = "s0-h2"
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        with pytest.raises(RuntimeError, match="injected patch failure"):
            manager.apply_state(state, policy)
        # the machine is label-resident-idempotent: lift the fault and
        # the rollout completes from wherever the aborted pass left it
        wrapped.fail_node = None
        assert run_to_completion(manager, fleet, policy, max_cycles=10)

    def test_transition_order_matches_sequential(self, cluster):
        """The transition listener (cascade's bucket-migration feed)
        must observe the same per-node sequence pipelined as
        sequentially — the listener fires on the reconcile thread at
        submit time, in submit order."""
        fleet = self._fleet(cluster, n=4)
        manager = make_manager(
            cluster, cascade=True, write_pipeline_workers=4
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"), drain_spec=self.DRAIN,
        )
        seen: dict = {}
        provider = manager._provider
        original = provider.change_node_upgrade_state

        def recording(node, new_state):
            # submit-order record on the reconcile thread (async drain
            # workers record too — their transitions are also legal)
            seen.setdefault(node["metadata"]["name"], []).append(new_state)
            original(node, new_state)

        provider.change_node_upgrade_state = recording
        try:
            assert run_to_completion(manager, fleet, policy, max_cycles=10)
        finally:
            provider.change_node_upgrade_state = original
        legal_next = {
            consts.UPGRADE_STATE_UPGRADE_REQUIRED: {
                consts.UPGRADE_STATE_CORDON_REQUIRED
            },
            consts.UPGRADE_STATE_CORDON_REQUIRED: {
                consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED
            },
            consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED: {
                consts.UPGRADE_STATE_POD_DELETION_REQUIRED,
                consts.UPGRADE_STATE_DRAIN_REQUIRED,
            },
        }
        for node, transitions in seen.items():
            for prev, nxt in zip(transitions, transitions[1:]):
                allowed = legal_next.get(prev)
                if allowed is not None:
                    assert nxt in allowed, (node, transitions)


class TestSliceCoherentSafeLoad:
    """TPU-native slice-coherent safe-load: the state machine releases a
    slice's safe-load barriers only once every host of the slice has its
    driver pod at the target revision — no host initializes the runtime
    (and the ICI fabric) against old-revision peers.  The reference's
    per-node release (safe_driver_load_manager.go:57-71) is the contrast
    case below."""

    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]

    def _slice_pair_mid_restart(self, cluster, fleet):
        """A 2-host slice mid-rollout: h0's pod is already recreated at the
        new revision and its init container is blocked on safe load; h1's
        pod is still at the old revision.  Both sit in
        pod-restart-required."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "s0-h0",
            pod_hash="rev2",
            pod_ready=False,
            labels={self.SLICE_KEY: "s0"},
            annotations={safe_key: "pod-h0"},
        )
        fleet.add_node(
            "s0-h1", pod_hash="rev1", labels={self.SLICE_KEY: "s0"}
        )
        fleet.publish_new_revision("rev2")
        state_key = util.get_upgrade_state_label_key()
        for name in ("s0-h0", "s0-h1"):
            cluster.patch(
                "Node",
                name,
                {
                    "metadata": {
                        "labels": {
                            state_key: consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                        }
                    }
                },
            )
        return safe_key

    def test_host_held_until_peer_reaches_target_revision(
        self, cluster, fleet
    ):
        safe_key = self._slice_pair_mid_restart(cluster, fleet)
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        policy = UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
        reconcile(manager, fleet, policy)
        # h0 is parked at the barrier: annotation retained, state unchanged
        assert (
            get_annotation(cluster.get("Node", "s0-h0"), safe_key) == "pod-h0"
        )
        assert (
            fleet.node_state("s0-h0")
            == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        )
        # h1's old pod was restarted and recreated at rev2 by the fleet's
        # DS controller; the next pass opens the barrier for the slice
        reconcile(manager, fleet, policy)
        assert not get_annotation(cluster.get("Node", "s0-h0"), safe_key)

    def test_reference_mode_releases_per_node(self, cluster, fleet):
        """Contrast: without slice coherence the barrier opens per host,
        torn slice and all (reference behavior)."""
        safe_key = self._slice_pair_mid_restart(cluster, fleet)
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        assert not get_annotation(cluster.get("Node", "s0-h0"), safe_key)

    def test_singleton_domain_never_held(self, cluster, fleet):
        """A node with no slice label is its own domain: other nodes'
        revisions are irrelevant to its barrier."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "lonely",
            pod_hash="rev2",
            pod_ready=False,
            annotations={safe_key: "pod-l"},
        )
        fleet.add_node("other", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "lonely",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                        )
                    }
                }
            },
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        reconcile(
            manager,
            fleet,
            UpgradePolicySpec(auto_upgrade=True, slice_aware=True),
        )
        assert not get_annotation(cluster.get("Node", "lonely"), safe_key)

    def test_coherent_mode_rejects_node_granular_policy(self, cluster, fleet):
        """Regression: slice-coherent + node-granular throttle is a
        guaranteed livelock (a barrier-held host pins the slot its peer
        needs) — apply_state must fail fast instead of wedging."""
        fleet.add_node("n1")
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        with pytest.raises(UpgradeStateError, match="slice_aware"):
            manager.apply_state(
                state, UpgradePolicySpec(auto_upgrade=True, slice_aware=False)
            )

    def test_validation_clock_does_not_run_while_held(self, cluster, fleet):
        """A host parked at the barrier in validation-required must not
        start (or run down) the 600 s validation timeout clock."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "s0-h0",
            pod_hash="rev2",
            labels={self.SLICE_KEY: "s0"},
            annotations={safe_key: "pod-h0"},
        )
        fleet.add_node(
            "s0-h1", pod_hash="rev1", labels={self.SLICE_KEY: "s0"}
        )
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "s0-h0",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_VALIDATION_REQUIRED
                        )
                    }
                }
            },
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        manager.with_validation_enabled("app=validator")
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(
            state, UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
        )
        node = cluster.get("Node", "s0-h0")
        assert get_annotation(node, safe_key) == "pod-h0"  # still held
        assert not get_annotation(
            node, util.get_validation_start_time_annotation_key()
        )

    def test_slice_coherent_full_rolling_upgrade_converges(
        self, cluster, fleet
    ):
        """End to end: slice-aware co-scheduling + coherent safe-load still
        drives a 2-slice fleet to upgrade-done."""
        for s in range(2):
            for h in range(2):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString("50%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        assert run_to_completion(manager, fleet, policy, max_cycles=60)

    def test_requestor_mode_rejected(self, cluster, fleet):
        """Regression: requestor mode delegates admission to the external
        maintenance operator, whose node-by-node budget can strand a
        barrier-held host — the combination must fail fast."""
        fleet.add_node("n1")
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_requestor import (
            RequestorNodeStateManager,
            RequestorOptions,
        )

        manager = make_manager(cluster).with_slice_coherent_safe_load()
        requestor = RequestorNodeStateManager(
            manager.common, RequestorOptions(use_maintenance_operator=True)
        )
        manager.with_requestor(requestor)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        with pytest.raises(UpgradeStateError, match="requestor"):
            manager.apply_state(
                state, UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
            )

    def test_skip_labeled_peer_does_not_wedge_slice(self, cluster, fleet):
        """Regression: a skip-labeled peer never syncs by design; it must
        not hold its slice's barrier closed forever."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "s0-h0",
            pod_hash="rev2",
            pod_ready=False,
            labels={self.SLICE_KEY: "s0"},
            annotations={safe_key: "pod-h0"},
        )
        fleet.add_node(
            "s0-h1",
            pod_hash="rev1",
            labels={
                self.SLICE_KEY: "s0",
                util.get_upgrade_skip_node_label_key(): consts.TRUE_STRING,
            },
        )
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "s0-h0",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                        )
                    }
                }
            },
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        policy = UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
        reconcile(manager, fleet, policy)
        # h0 released despite h1 being unsynced: h1 is exempted by choice
        assert not get_annotation(cluster.get("Node", "s0-h0"), safe_key)

    def test_failed_peer_does_not_wedge_slice(self, cluster, fleet):
        """Regression: a peer parked in upgrade-failed must not hold its
        slice's healthy hosts at the barrier (the slice is already broken;
        the failed node recovers out-of-band)."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "s0-h0",
            pod_hash="rev2",
            pod_ready=False,
            labels={self.SLICE_KEY: "s0"},
            annotations={safe_key: "pod-h0"},
        )
        fleet.add_node(
            "s0-h1", pod_hash="rev1", labels={self.SLICE_KEY: "s0"}
        )
        fleet.publish_new_revision("rev2")
        state_key = util.get_upgrade_state_label_key()
        cluster.patch(
            "Node",
            "s0-h0",
            {"metadata": {"labels": {
                state_key: consts.UPGRADE_STATE_POD_RESTART_REQUIRED}}},
        )
        cluster.patch(
            "Node",
            "s0-h1",
            {"metadata": {"labels": {state_key: consts.UPGRADE_STATE_FAILED}}},
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        policy = UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
        reconcile(manager, fleet, policy)
        assert not get_annotation(cluster.get("Node", "s0-h0"), safe_key)

    def test_unsynced_own_pod_in_validation_does_not_self_hold(
        self, cluster, fleet
    ):
        """Regression: a validation-required node whose own pod went
        unsynced (revision bumped mid-validation) used to land its own
        domain in the blocked set and hold itself forever."""
        safe_key = util.get_wait_for_safe_load_annotation_key()
        fleet.add_node(
            "s0-h0",
            pod_hash="rev2",
            labels={self.SLICE_KEY: "s0"},
            annotations={safe_key: "pod-h0"},
        )
        fleet.publish_new_revision("rev3")  # bumped again mid-validation
        cluster.patch(
            "Node",
            "s0-h0",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_VALIDATION_REQUIRED
                        )
                    }
                }
            },
        )
        manager = make_manager(cluster).with_slice_coherent_safe_load()
        manager.with_validation_enabled("app=validator")
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(
            state, UpgradePolicySpec(auto_upgrade=True, slice_aware=True)
        )
        # not self-held: the unblock ran (annotation gone) so the node can
        # recover through the normal lifecycle
        assert not get_annotation(cluster.get("Node", "s0-h0"), safe_key)


class TestPdbDrainIntegration:
    def test_pdb_blocked_drain_fails_node(self, cluster, fleet):
        """A workload pod protected by an exhausted PodDisruptionBudget
        blocks the drain (eviction 429s) until the drain timeout; the
        node then lands in upgrade-failed, like any drain failure."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        rs = {"kind": "ReplicaSet", "metadata": {"name": "rs", "namespace": "ml"}}
        cluster.create(
            make_pod("train", "ml", "n1", labels={"job": "train"}, owner=rs)
        )
        cluster.create(
            {
                "kind": "PodDisruptionBudget",
                "metadata": {"name": "pdb", "namespace": "ml"},
                "spec": {
                    "selector": {"matchLabels": {"job": "train"}},
                    "minAvailable": 1,
                },
            }
        )
        manager = make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=1),
        )
        for _ in range(8):
            reconcile(manager, fleet, policy)
            if fleet.node_state("n1") == consts.UPGRADE_STATE_FAILED:
                break
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_FAILED
        assert cluster.exists("Pod", "train", "ml")  # PDB held: never evicted
