"""The port's requestor mode (k8s_operator_libs_tpu_torch/upgrade/
upgrade_requestor.py): the NodeMaintenance handoff, the shared-requestor
protocol, the watch predicates and the env-var options.

Every class of ``tests/test_upgrade_requestor.py``, as cases of the same
names, runs here on the port in its vocabulary (the NodeMaintenance name
prefix is ``nvidia-operator``), over the port's harness and its
``SimMaintenanceOperator``.
"""

import threading

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    PreDrainCheckpointSpec,
    UpgradePolicySpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu_torch.cluster import ConflictError, InMemoryCluster, retry_on_conflict
from k8s_operator_libs_tpu_torch.cluster.objects import make_node_maintenance
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_requestor import (
    DEFAULT_NODE_MAINTENANCE_NAME_PREFIX,
    NodeMaintenanceUpgradeDisabledError,
    RequestorNodeStateManager,
    RequestorOptions,
    condition_changed_predicate,
    convert_policy_to_maintenance_spec,
    get_requestor_opts_from_envs,
    new_requestor_id_predicate,
)
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, NAMESPACE, FakeMaintenanceOperator, Fleet

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


def make_requestor_manager(cluster, requestor_id="tpu-gpu-operator", ns="default"):
    manager = ClusterUpgradeStateManager(
        cluster,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    opts = RequestorOptions(
        use_maintenance_operator=True,
        requestor_id=requestor_id,
        requestor_namespace=ns,
    )
    requestor = RequestorNodeStateManager(manager.common, opts)
    manager.with_requestor(requestor, enabled=True)
    return manager, requestor


@pytest.fixture()
def fleet(cluster):
    return Fleet(cluster)


def reconcile(manager, fleet, policy):
    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
    manager.apply_state(state, policy)
    manager.drain_manager.wait_idle(10.0)
    manager.pod_manager.wait_idle(10.0)
    fleet.reconcile_daemonset()


class TestRequestorLifecycle:
    def test_disabled_opts_rejected(self, cluster):
        manager = ClusterUpgradeStateManager(cluster)
        with pytest.raises(NodeMaintenanceUpgradeDisabledError):
            RequestorNodeStateManager(
                manager.common, RequestorOptions(use_maintenance_operator=False)
            )

    def test_full_requestor_lifecycle(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        mop = FakeMaintenanceOperator(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )

        # cycle 1: classification
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        # cycle 2: handoff — CR created, annotation set
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm is not None
        assert nm["spec"]["requestorID"] == "tpu-gpu-operator"
        assert util.is_node_in_requestor_mode(cluster.get("Node", "n1"))
        # cycle 3: CR not ready yet → state holds
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        # external operator cordons/drains and reports Ready
        assert mop.reconcile() == 1
        assert cluster.get("Node", "n1")["spec"]["unschedulable"] is True
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        # driver pod restarts at new revision → uncordon-required → done
        for _ in range(6):
            reconcile(manager, fleet, policy)
            if fleet.node_state("n1") == consts.UPGRADE_STATE_DONE:
                break
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE
        assert not util.is_node_in_requestor_mode(cluster.get("Node", "n1"))
        # deletion is a request; the external operator completes it since no
        # additional requestors remain
        lingering = requestor.get_node_maintenance_obj("n1")
        assert lingering is None or lingering["metadata"]["deletionTimestamp"]
        mop.reconcile()
        assert requestor.get_node_maintenance_obj("n1") is None

    def test_missing_cr_returns_to_upgrade_required(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        cluster.delete(
            "NodeMaintenance",
            requestor.get_node_maintenance_name("n1"),
            "default",
        )
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_UPGRADE_REQUIRED

    def test_inplace_node_finishes_inplace_under_requestor_mode(
        self, cluster, fleet
    ):
        # A node already at uncordon-required WITHOUT the requestor-mode
        # annotation must be finished by the in-place processor even though
        # requestor mode is enabled (reference upgrade_state.go:311-325).
        node = fleet.add_node("n1", unschedulable=True)
        cluster.patch(
            "Node",
            "n1",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_UNCORDON_REQUIRED
                        )
                    }
                }
            },
        )
        manager, _ = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        node = cluster.get("Node", "n1")
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE
        assert node["spec"]["unschedulable"] is False  # in-place uncordon ran


class TestSharedRequestorProtocol:
    def _nm(self, cluster, owner="operator-a", node="n1", additional=None):
        nm = make_node_maintenance(
            f"{DEFAULT_NODE_MAINTENANCE_NAME_PREFIX}-{node}",
            "default",
            owner,
            node,
        )
        if additional:
            nm["spec"]["additionalRequestors"] = list(additional)
        return cluster.create(nm)

    def test_secondary_requestor_appends_additional(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        self._nm(cluster, owner="operator-a")
        manager, requestor = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["requestorID"] == "operator-a"
        assert nm["spec"]["additionalRequestors"] == ["operator-b"]

    def test_lost_create_race_joins_membership(self, cluster, fleet):
        """Review regression (two-operator e2e): when another operator's
        CR appears between our snapshot and our create, the AlreadyExists
        adoption must JOIN additionalRequestors — piggybacking without
        membership lets the owner delete the CR out from under us."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)  # classify -> upgrade-required
        # operator-a's CR lands AFTER our snapshot would attach it: create
        # it via a transition listener right before our create runs — the
        # snapshot for the next reconcile is taken first, so
        # node_maintenance is None and the create path races and loses.
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        ns = state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED)[0]
        assert ns.node_maintenance is None
        self._nm(cluster, owner="operator-a")  # the race winner
        manager.apply_state(state, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["requestorID"] == "operator-a"
        assert nm["spec"]["additionalRequestors"] == ["operator-b"]
        assert fleet.node_state("n1") == (
            consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        )

    def test_append_is_idempotent(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        self._nm(cluster, owner="operator-a", additional=["operator-b"])
        manager, requestor = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["additionalRequestors"] == ["operator-b"]

    def test_concurrent_patchers_conflict_and_converge(self, cluster):
        """The subtle core (reference :344-357): two operators appending to
        additionalRequestors concurrently — the optimistic lock makes one
        fail; the retry (= next reconcile) must converge with both IDs."""
        nm = self._nm(cluster, owner="operator-a")
        name = nm["metadata"]["name"]
        barrier = threading.Barrier(2)
        results = []

        def join(requestor_id):
            manager = ClusterUpgradeStateManager(cluster)
            opts = RequestorOptions(
                use_maintenance_operator=True, requestor_id=requestor_id
            )
            req = RequestorNodeStateManager(manager.common, opts)

            from k8s_operator_libs_tpu_torch.upgrade.common_manager import (
                NodeUpgradeState,
            )

            first_attempt = [True]

            def attempt():
                ns = NodeUpgradeState(
                    node={"metadata": {"name": "n1"}},
                    driver_pod={},
                    node_maintenance=req.get_node_maintenance_obj("n1"),
                )
                if first_attempt[0]:
                    # synchronize only the first round so both writers race
                    # on the same resourceVersion; retries run free
                    first_attempt[0] = False
                    try:
                        barrier.wait(timeout=5)
                    except threading.BrokenBarrierError:
                        pass
                req.create_or_update_node_maintenance(ns)

            try:
                retry_on_conflict(attempt, steps=5)
                results.append((requestor_id, "ok"))
            except ConflictError:
                results.append((requestor_id, "conflict"))

        threads = [
            threading.Thread(target=join, args=(rid,))
            for rid in ("operator-b", "operator-c")
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(status == "ok" for _, status in results)
        final = cluster.get("NodeMaintenance", name, "default")
        assert sorted(final["spec"]["additionalRequestors"]) == [
            "operator-b",
            "operator-c",
        ]

    def test_owner_deletes_secondary_removes_self(self, cluster):
        from k8s_operator_libs_tpu_torch.upgrade.common_manager import NodeUpgradeState

        nm = self._nm(cluster, owner="operator-a", additional=["operator-b"])
        manager_b, req_b = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        ns = NodeUpgradeState(
            node={"metadata": {"name": "n1"}},
            driver_pod={},
            node_maintenance=req_b.get_node_maintenance_obj("n1"),
        )
        req_b.delete_or_update_node_maintenance(ns)
        current = req_b.get_node_maintenance_obj("n1")
        assert current["spec"]["additionalRequestors"] == []
        manager_a, req_a = make_requestor_manager(
            cluster, requestor_id="operator-a"
        )
        ns_a = NodeUpgradeState(
            node={"metadata": {"name": "n1"}},
            driver_pod={},
            node_maintenance=current,
        )
        req_a.delete_or_update_node_maintenance(ns_a)
        assert req_a.get_node_maintenance_obj("n1") is None

    def test_shared_node_not_uncordoned_by_inplace_pass(self, cluster, fleet):
        """Regression (wrapper ordering): a requestor-mode node finishing
        its upgrade must NOT be uncordoned by the in-place processor in the
        same pass after the requestor strips the mode annotation."""
        fleet.add_node("n1", unschedulable=True)
        key = util.get_upgrade_requestor_mode_annotation_key()
        cluster.patch(
            "Node",
            "n1",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_UNCORDON_REQUIRED
                        )
                    },
                    "annotations": {key: "true"},
                }
            },
        )
        self._nm(cluster, owner="operator-b", additional=["tpu-gpu-operator"])
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        node = cluster.get("Node", "n1")
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE
        # the external maintenance operator still owns cordon/uncordon
        assert node["spec"]["unschedulable"] is True
        # and our membership was removed from the shared CR
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["additionalRequestors"] == []

    def test_node_maintenance_carries_slice_id(self, cluster, fleet):
        fleet.add_node(
            "n1",
            pod_hash="rev1",
            labels={consts.SLICE_ID_LABEL_KEYS[0]: "slice-7"},
        )
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["sliceId"] == "slice-7"

    def test_node_maintenance_carries_multislice_domain(self, cluster, fleet):
        """A multislice-group node's CR must hint the *job-group* domain,
        not its individual slice — an external operator batching by
        sliceId would otherwise disrupt the DCN-coupled job once per
        member slice."""
        fleet.add_node(
            "n1",
            pod_hash="rev1",
            labels={
                consts.SLICE_ID_LABEL_KEYS[0]: "slice-7",
                consts.MULTISLICE_GROUP_LABEL_KEYS[0]: "job-A",
            },
        )
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["spec"]["sliceId"] == "msgroup:job-A"

    def test_stale_snapshot_of_deleted_cr_is_noop(self, cluster):
        """Regression: the owner deleted the CR between BuildState and the
        uncordon pass — the secondary's cleanup must no-op, not crash the
        reconcile with NotFound."""
        from k8s_operator_libs_tpu_torch.upgrade.common_manager import NodeUpgradeState

        nm = self._nm(cluster, owner="operator-a", additional=["operator-b"])
        _manager, req_b = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        stale = req_b.get_node_maintenance_obj("n1")
        cluster.delete("NodeMaintenance", nm["metadata"]["name"], "default")
        ns = NodeUpgradeState(
            node={"metadata": {"name": "n1"}},
            driver_pod={},
            node_maintenance=stale,
        )
        req_b.delete_or_update_node_maintenance(ns)  # must not raise
        assert ns.node_maintenance is None

    def test_owner_delete_while_shared_is_graceful(self, cluster):
        """The owner's delete is only a request: with the maintenance
        operator's finalizer in place, the CR lingers terminating until the
        last additional requestor leaves (reference upgrade_requestor.go:
        241-246 delegates actual deletion to the maintenance operator)."""
        from k8s_operator_libs_tpu_torch.upgrade.common_manager import NodeUpgradeState

        nm = self._nm(cluster, owner="operator-a", additional=["operator-b"])
        mop = FakeMaintenanceOperator(cluster)
        mop.reconcile()  # installs the finalizer, reports Ready
        _manager_a, req_a = make_requestor_manager(
            cluster, requestor_id="operator-a"
        )
        ns_a = NodeUpgradeState(
            node={"metadata": {"name": "n1"}},
            driver_pod={},
            node_maintenance=req_a.get_node_maintenance_obj("n1"),
        )
        req_a.delete_or_update_node_maintenance(ns_a)
        lingering = req_a.get_node_maintenance_obj("n1")
        assert lingering is not None
        assert lingering["metadata"]["deletionTimestamp"]
        mop.reconcile()  # still shared: must NOT release
        assert req_a.get_node_maintenance_obj("n1") is not None
        # operator-b leaves
        _manager_b, req_b = make_requestor_manager(
            cluster, requestor_id="operator-b"
        )
        ns_b = NodeUpgradeState(
            node={"metadata": {"name": "n1"}},
            driver_pod={},
            node_maintenance=req_b.get_node_maintenance_obj("n1"),
        )
        req_b.delete_or_update_node_maintenance(ns_b)
        mop.reconcile()  # now released
        assert req_a.get_node_maintenance_obj("n1") is None

    def test_custom_prefix_disables_sharing(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        opts = RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="operator-b",
            node_maintenance_name_prefix="custom-prefix",
        )
        requestor = RequestorNodeStateManager(manager.common, opts)
        manager.with_requestor(requestor, enabled=True)
        policy = UpgradePolicySpec(auto_upgrade=True)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        nm = requestor.get_node_maintenance_obj("n1")
        assert nm["metadata"]["name"] == "custom-prefix-n1"
        assert nm["spec"]["requestorID"] == "operator-b"


class TestSpecConversion:
    def test_policy_converted_including_checkpoint_gate(self):
        opts = RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="op",
            pod_eviction_filters=[{"byPodSelector": "app=workload"}],
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=42),
            pod_deletion=__import__(
                "k8s_operator_libs_tpu_torch.api", fromlist=["PodDeletionSpec"]
            ).PodDeletionSpec(),
            wait_for_completion=WaitForCompletionSpec(
                pod_selector="app=train", timeout_second=7
            ),
            pre_drain_checkpoint=PreDrainCheckpointSpec(
                enable=True, timeout_second=120
            ),
        )
        spec = convert_policy_to_maintenance_spec(policy, opts)
        assert spec["drainSpec"]["timeoutSeconds"] == 42
        assert spec["drainSpec"]["podEvictionFilters"] == [
            {"byPodSelector": "app=workload"}
        ]
        assert spec["waitForPodCompletion"]["podSelector"] == "app=train"
        assert spec["preDrainCheckpoint"]["enable"] is True

    def test_none_policy(self):
        assert convert_policy_to_maintenance_spec(None, RequestorOptions()) == {}


class TestPredicates:
    def test_requestor_id_predicate(self, cluster):
        pred = new_requestor_id_predicate("op-b")
        owned = make_node_maintenance("nm1", "default", "op-b", "n1")
        shared = make_node_maintenance("nm2", "default", "op-a", "n2")
        shared["spec"]["additionalRequestors"] = ["op-b"]
        other = make_node_maintenance("nm3", "default", "op-a", "n3")
        assert pred(owned) and pred(shared) and not pred(other)
        assert not pred({"kind": "Node", "metadata": {"name": "x"}})

    def test_condition_changed_predicate_fires_on_condition_diff(self, cluster):
        nm = cluster.create(make_node_maintenance("nm1", "default", "op", "n1"))
        seq = cluster.journal_seq()
        # a label-only change must NOT enqueue
        cluster.patch(
            "NodeMaintenance", "nm1", {"metadata": {"labels": {"x": "1"}}}, "default"
        )
        events = cluster.events_since(seq, kind="NodeMaintenance")
        assert [condition_changed_predicate(e) for e in events] == [False]
        # a condition change must enqueue
        seq = cluster.journal_seq()
        nm = cluster.get("NodeMaintenance", "nm1", "default")
        nm["status"]["conditions"] = [
            {"type": "Ready", "status": "True", "reason": "Ready"}
        ]
        cluster.update(nm)
        events = cluster.events_since(seq, kind="NodeMaintenance")
        assert [condition_changed_predicate(e) for e in events] == [True]

    def test_condition_changed_predicate_fires_on_finalizer_removal(
        self, cluster
    ):
        nm = make_node_maintenance("nm1", "default", "op", "n1")
        nm["metadata"]["finalizers"] = ["maintenance.nvidia.com/guard"]
        cluster.create(nm)
        cluster.delete("NodeMaintenance", "nm1", "default")  # marks terminating
        seq = cluster.journal_seq()
        current = cluster.get("NodeMaintenance", "nm1", "default")
        current["metadata"]["finalizers"] = []
        cluster.update(current)  # removes object, emits Deleted
        events = cluster.events_since(seq, kind="NodeMaintenance")
        # Deleted events are not Update events; predicate handles the
        # preceding Modified with finalizer removal when the object is kept
        # alive by other finalizers — here the removal deletes outright, so
        # only a Deleted event exists and the predicate correctly ignores it
        assert all(not condition_changed_predicate(e) for e in events)

    def test_condition_changed_predicate_finalizer_shrink_while_terminating(
        self, cluster
    ):
        nm = make_node_maintenance("nm1", "default", "op", "n1")
        nm["metadata"]["finalizers"] = ["a", "b"]
        cluster.create(nm)
        cluster.delete("NodeMaintenance", "nm1", "default")
        seq = cluster.journal_seq()
        current = cluster.get("NodeMaintenance", "nm1", "default")
        current["metadata"]["finalizers"] = []
        cluster.update(current)
        events = cluster.events_since(seq, kind="NodeMaintenance")
        # finalizers ["a","b"] -> [] while terminating: object removed; the
        # final event is Deleted (ignored). Simulate the intermediate case:
        nm2 = make_node_maintenance("nm2", "default", "op", "n2")
        nm2["metadata"]["finalizers"] = ["a"]
        cluster.create(nm2)
        cluster.delete("NodeMaintenance", "nm2", "default")
        seq = cluster.journal_seq()
        ev = type(events[0])(
            seq + 1,
            "Modified",
            cluster.get("NodeMaintenance", "nm2", "default"),
            {
                **cluster.get("NodeMaintenance", "nm2", "default"),
                "metadata": {
                    **cluster.get("NodeMaintenance", "nm2", "default")["metadata"],
                    "finalizers": [],
                },
            },
        )
        assert condition_changed_predicate(ev) is True


class TestEnvOpts:
    def test_defaults(self, monkeypatch):
        for var in (
            "MAINTENANCE_OPERATOR_ENABLED",
            "MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE",
            "MAINTENANCE_OPERATOR_REQUESTOR_ID",
            "MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX",
        ):
            monkeypatch.delenv(var, raising=False)
        opts = get_requestor_opts_from_envs()
        assert opts.use_maintenance_operator is False
        assert opts.requestor_namespace == "default"
        assert (
            opts.node_maintenance_name_prefix
            == DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
        )

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("MAINTENANCE_OPERATOR_ENABLED", "true")
        monkeypatch.setenv("MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE", "ops")
        monkeypatch.setenv("MAINTENANCE_OPERATOR_REQUESTOR_ID", "tpu-op")
        monkeypatch.setenv(
            "MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX", "myprefix"
        )
        opts = get_requestor_opts_from_envs()
        assert opts.use_maintenance_operator is True
        assert opts.requestor_namespace == "ops"
        assert opts.requestor_id == "tpu-op"
        assert opts.node_maintenance_name_prefix == "myprefix"


class TestPostMaintenanceGate:
    """The state the reference declares but never enters (consts.go:70;
    TODO at upgrade_state.go:249-250): with a post-maintenance hook
    installed, maintenance completion routes through
    post-maintenance-required, and the hook gates the driver-pod restart."""

    def _manager_with_hook(self, cluster, hook):
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        opts = RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="tpu-gpu-operator",
            requestor_namespace="default",
        )
        requestor = RequestorNodeStateManager(
            manager.common, opts, post_maintenance_hook=hook
        )
        manager.with_requestor(requestor, enabled=True)
        return manager, requestor

    def _to_maintenance_ready(self, cluster, fleet, manager, policy):
        mop = FakeMaintenanceOperator(cluster)
        reconcile(manager, fleet, policy)  # classification
        reconcile(manager, fleet, policy)  # handoff
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        assert mop.reconcile() == 1
        return mop

    def test_hook_gates_restart_until_true(self, cluster, fleet):
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        verdicts = [False, True]
        seen = []

        def hook(node):
            seen.append(node["metadata"]["name"])
            return verdicts.pop(0)

        manager, _ = self._manager_with_hook(cluster, hook)
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )
        mop = self._to_maintenance_ready(cluster, fleet, manager, policy)
        # maintenance Ready → post-maintenance-required (hook not yet run:
        # the node entered the bucket after its phase in this pass)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
        assert seen == []
        # hook says False → parked; says True → advances to pod-restart
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        assert seen == ["n1", "n1"]
        # and the node still finishes the lifecycle
        for _ in range(8):
            reconcile(manager, fleet, policy)
            if fleet.node_state("n1") == consts.UPGRADE_STATE_DONE:
                break
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE

    def test_hook_exception_parks_and_retries(self, cluster, fleet):
        """A hook exception must NOT fail the node: the driver pod is still
        at the old revision here, so the upgrade-failed self-heal (pod back
        in sync) could never fire and the node would wedge.  Transient
        probe errors park and retry instead."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        calls = []

        def hook(node):
            calls.append(1)
            if len(calls) < 2:
                raise RuntimeError("ICI link check timed out")
            return True

        manager, _ = self._manager_with_hook(cluster, hook)
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )
        self._to_maintenance_ready(cluster, fleet, manager, policy)
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
        # exception → parked, not failed
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
        # next probe succeeds → advances
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED

    def test_cascade_with_requestor_same_pass_gate(self, cluster, fleet):
        """Cascade + requestor interaction: the Ready transition migrates
        the node into the post-maintenance bucket mid-pass, so the hook
        runs (and can release) in the SAME reconcile that observed
        readiness; admission likewise cascades into CR creation."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        hook_calls = []

        def hook(node):
            hook_calls.append(node["metadata"]["name"])
            return True

        manager = ClusterUpgradeStateManager(
            cluster,
            cascade=True,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        opts = RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="tpu-gpu-operator",
            requestor_namespace="default",
        )
        requestor = RequestorNodeStateManager(
            manager.common, opts, post_maintenance_hook=hook
        )
        manager.with_requestor(requestor, enabled=True)
        mop = FakeMaintenanceOperator(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )
        # pass 1: classification cascades into admission + CR handoff
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        assert requestor.get_node_maintenance_obj("n1") is not None
        # external operator completes maintenance
        assert mop.reconcile() == 1
        # pass 2: Ready observed → post-maintenance → hook → pod-restart,
        # all in one pass
        reconcile(manager, fleet, policy)
        assert hook_calls == ["n1"]
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        # and the lifecycle still completes
        for _ in range(8):
            reconcile(manager, fleet, policy)
            if fleet.node_state("n1") == consts.UPGRADE_STATE_DONE:
                break
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_DONE
        assert not util.is_node_in_requestor_mode(cluster.get("Node", "n1"))

    def test_no_hook_passes_state_through(self, cluster, fleet):
        """A resumed fleet whose labels already carry the state (e.g. the
        hook was removed across an operator restart) must not wedge."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, _ = make_requestor_manager(cluster)
        cluster.patch(
            "Node",
            "n1",
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key(): (
                            consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
                        )
                    },
                    "annotations": {
                        util.get_upgrade_requestor_mode_annotation_key(): "true"
                    },
                }
            },
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED

    def test_without_hook_reference_shortcut_taken(self, cluster, fleet):
        """No hook installed → the reference's direct
        node-maintenance-required → pod-restart-required transition."""
        fleet.add_node("n1", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, _ = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True, drain_spec=DrainSpec(enable=True, force=True)
        )
        mop = FakeMaintenanceOperator(cluster)
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        assert mop.reconcile() == 1
        reconcile(manager, fleet, policy)
        assert fleet.node_state("n1") == consts.UPGRADE_STATE_POD_RESTART_REQUIRED


class TestRequestorCanary:
    """canaryDomains gates the maintenance HANDOFF (review gap: the
    gate existed only in-place — a consumer switching modes silently
    lost canary protection).  Unit accounting mirrors in-place: fresh
    units charge the budget, participating units keep flowing, a
    failed canary freezes all further handoffs."""

    def _policy(self, canary=1):
        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=None,
            drain_spec=DrainSpec(enable=True, force=True),
            canary_domains=canary,
        )

    def test_canary_caps_handoffs_then_opens_fleet(self, cluster, fleet):
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        mop = FakeMaintenanceOperator(cluster)
        policy = self._policy(canary=1)

        reconcile(manager, fleet, policy)  # classify
        reconcile(manager, fleet, policy)  # handoff pass
        in_maint = [
            n for n in ("n0", "n1", "n2", "n3")
            if fleet.node_state(n)
            == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        ]
        assert len(in_maint) == 1, (
            f"canary=1 must hand off exactly one node, got {in_maint}"
        )
        # drive the canary node to done; the fleet must then open
        for _ in range(12):
            mop.reconcile()
            reconcile(manager, fleet, policy)
            states = {n: fleet.node_state(n) for n in ("n0", "n1", "n2", "n3")}
            if sum(
                1
                for s in states.values()
                if s == consts.UPGRADE_STATE_DONE
            ) >= 1 and sum(
                1
                for s in states.values()
                if s == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
            ) >= 1:
                break
        done = [n for n in states if states[n] == consts.UPGRADE_STATE_DONE]
        assert done, f"canary never finished: {states}"
        handed_off_after = [
            n
            for n in states
            if states[n]
            not in ("", consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        ]
        assert len(handed_off_after) >= 2, (
            f"fleet never opened after canary success: {states}"
        )

    def test_failed_canary_freezes_handoffs(self, cluster, fleet):
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        policy = self._policy(canary=1)

        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        canary_node = next(
            n for n in ("n0", "n1", "n2")
            if fleet.node_state(n)
            == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        )
        # the canary fails (e.g. driver pod crashloop post-maintenance)
        cluster.patch(
            "Node",
            canary_node,
            {
                "metadata": {
                    "labels": {
                        util.get_upgrade_state_label_key():
                            consts.UPGRADE_STATE_FAILED
                    }
                }
            },
        )
        for _ in range(3):
            reconcile(manager, fleet, policy)
        frozen = [
            n for n in ("n0", "n1", "n2")
            if n != canary_node
            and fleet.node_state(n) == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(frozen) == 2, (
            "a failed canary must freeze all further handoffs: "
            f"{[fleet.node_state(n) for n in ('n0', 'n1', 'n2')]}"
        )


class TestRequestorQuarantine:
    """quarantineDegraded bars the maintenance handoff too: handing a
    degraded slice to the maintenance operator starts exactly the
    disruption the quarantine exists to prevent."""

    def test_quarantined_node_not_handed_off(self, cluster, fleet):
        fleet.add_node("healthy", pod_hash="rev1")
        fleet.add_node("sick", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "sick",
            {
                "metadata": {
                    "annotations": {
                        util.get_quarantine_annotation_key(): "degraded"
                    }
                }
            },
        )
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            drain_spec=DrainSpec(enable=True, force=True),
            quarantine_degraded=True,
        )
        reconcile(manager, fleet, policy)  # classify
        reconcile(manager, fleet, policy)  # handoff pass
        assert (
            fleet.node_state("healthy")
            == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        )
        assert (
            fleet.node_state("sick") == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )
        assert requestor.get_node_maintenance_obj("sick") is None


class TestRequestorQuarantineStraggler:
    """Review regression (in-place `fresh` exemption parity): a domain
    already mid-handoff finishes even if it becomes quarantined —
    stranding a slice half-upgraded is worse than finishing it."""

    def test_active_domain_straggler_still_handed_off(self, cluster, fleet):
        slice_key = consts.SLICE_ID_LABEL_KEYS[0]
        for name in ("s0-a", "s0-b"):
            fleet.add_node(
                name, pod_hash="rev1", labels={slice_key: "slice-0"}
            )
        fleet.publish_new_revision("rev2")
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            drain_spec=DrainSpec(enable=True, force=True),
            quarantine_degraded=True,
            slice_aware=True,
        )
        reconcile(manager, fleet, policy)  # classify
        # hand off ONE member, then quarantine the domain mid-flight
        cluster.patch(
            "Node", "s0-b",
            {"metadata": {"labels": {
                util.get_upgrade_state_label_key():
                    consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED}}},
        )
        cluster.patch(
            "Node", "s0-a",
            {"metadata": {"annotations": {
                util.get_quarantine_annotation_key(): "degraded"}}},
        )
        reconcile(manager, fleet, policy)
        # the straggler of the ACTIVE domain is still handed off
        assert (
            fleet.node_state("s0-a")
            == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        ), fleet.node_state("s0-a")

    def test_fresh_quarantined_domain_still_blocked(self, cluster, fleet):
        slice_key = consts.SLICE_ID_LABEL_KEYS[0]
        fleet.add_node("q-a", pod_hash="rev1",
                       labels={slice_key: "slice-q"})
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node", "q-a",
            {"metadata": {"annotations": {
                util.get_quarantine_annotation_key(): "degraded"}}},
        )
        manager, requestor = make_requestor_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            drain_spec=DrainSpec(enable=True, force=True),
            quarantine_degraded=True,
            slice_aware=True,
        )
        reconcile(manager, fleet, policy)
        reconcile(manager, fleet, policy)
        assert (
            fleet.node_state("q-a") == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )
