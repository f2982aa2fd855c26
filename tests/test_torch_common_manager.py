"""The port's CommonUpgradeManager (k8s_operator_libs_tpu_torch/upgrade/
common_manager.py) over mocked node-op managers.

The four classes of ``tests/test_common_manager_mocked.py``, as cases of
the same names, run on the port.  The doubles are ``tests/mocks.py``'s,
which import neither package, but for the state provider: its label
write names the JAX package's key, so :class:`PortMockProvider` writes the
port's.
"""

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    PodDeletionSpec,
    WaitForCompletionSpec,
)
from k8s_operator_libs_tpu_torch.cluster.objects import make_node, make_pod
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.common_manager import (
    ClusterUpgradeState,
    CommonUpgradeManager,
    NodeUpgradeState,
)

from mocks import (
    MockCordonManager,
    MockDrainManager,
    MockNodeUpgradeStateProvider,
    MockPodManager,
    MockSafeDriverLoadManager,
    MockValidationManager,
)
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


class PortMockProvider(MockNodeUpgradeStateProvider):
    """``MockNodeUpgradeStateProvider`` writing the port's state label."""

    def change_node_upgrade_state(self, node, new_state: str) -> None:
        self.log.record("change_node_upgrade_state", node, new_state)
        key = util.get_upgrade_state_label_key()
        labels = node.setdefault("metadata", {}).setdefault("labels", {})
        if new_state == "":
            labels.pop(key, None)
        else:
            labels[key] = new_state


@pytest.fixture()
def mocks():
    return {
        "provider": PortMockProvider(),
        "cordon": MockCordonManager(),
        "drain": MockDrainManager(),
        "pod": MockPodManager(),
        "validation": MockValidationManager(),
        "safe_load": MockSafeDriverLoadManager(),
    }


def make_common(mocks, pod_deletion=False, validation=False):
    return CommonUpgradeManager(
        cluster=None,
        provider=mocks["provider"],
        cordon_manager=mocks["cordon"],
        drain_manager=mocks["drain"],
        pod_manager=mocks["pod"],
        validation_manager=mocks["validation"],
        safe_driver_load_manager=mocks["safe_load"],
        pod_deletion_enabled=pod_deletion,
        validation_enabled=validation,
    )


def ns(name, pod_hash="rev1", **node_kwargs):
    node = make_node(name, **node_kwargs)
    pod = make_pod(f"driver-{name}", "ops", name, revision_hash=pod_hash)
    ds = {"kind": "DaemonSet", "metadata": {"name": "d", "namespace": "ops"}}
    pod["metadata"]["ownerReferences"] = [
        {"kind": "DaemonSet", "name": "d", "uid": "u1", "controller": True}
    ]
    return NodeUpgradeState(node=node, driver_pod=pod, driver_daemonset=ds)


def bucket(state_name, *node_states):
    return ClusterUpgradeState(node_states={state_name: list(node_states)})


def state_label(node):
    return (node.get("metadata", {}).get("labels") or {}).get(
        util.get_upgrade_state_label_key(), ""
    )


class TestClassificationMocked:
    def test_out_of_sync_goes_upgrade_required(self, mocks):
        common = make_common(mocks)
        mocks["pod"].ds_hash = "rev2"
        s = ns("n1", pod_hash="rev1")
        common.process_done_or_unknown_nodes(
            bucket(consts.UPGRADE_STATE_UNKNOWN, s),
            consts.UPGRADE_STATE_UNKNOWN,
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_UPGRADE_REQUIRED

    def test_in_sync_unknown_goes_done_but_done_untouched(self, mocks):
        common = make_common(mocks)
        s1, s2 = ns("n1"), ns("n2")
        common.process_done_or_unknown_nodes(
            bucket(consts.UPGRADE_STATE_UNKNOWN, s1),
            consts.UPGRADE_STATE_UNKNOWN,
        )
        common.process_done_or_unknown_nodes(
            bucket(consts.UPGRADE_STATE_DONE, s2), consts.UPGRADE_STATE_DONE
        )
        assert state_label(s1.node) == consts.UPGRADE_STATE_DONE
        assert mocks["provider"].log.count("change_node_upgrade_state") == 1

    def test_unschedulable_node_gets_initial_state_annotation(self, mocks):
        common = make_common(mocks)
        mocks["pod"].ds_hash = "rev2"
        s = ns("n1", pod_hash="rev1", unschedulable=True)
        common.process_done_or_unknown_nodes(
            bucket(consts.UPGRADE_STATE_UNKNOWN, s),
            consts.UPGRADE_STATE_UNKNOWN,
        )
        anns = s.node["metadata"]["annotations"]
        assert (
            anns[util.get_upgrade_initial_state_annotation_key()]
            == consts.TRUE_STRING
        )

    def test_safe_load_waiting_forces_upgrade(self, mocks):
        mocks["safe_load"].waiting = True
        common = make_common(mocks)
        s = ns("n1")  # in sync!
        common.process_done_or_unknown_nodes(
            bucket(consts.UPGRADE_STATE_UNKNOWN, s),
            consts.UPGRADE_STATE_UNKNOWN,
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_UPGRADE_REQUIRED


class TestPhaseDispatchMocked:
    def test_cordon_phase_calls_manager_then_advances(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        common.process_cordon_required_nodes(
            bucket(consts.UPGRADE_STATE_CORDON_REQUIRED, s)
        )
        assert mocks["cordon"].log.names() == ["cordon"]
        assert state_label(s.node) == consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED

    def test_wait_for_jobs_skipped_without_selector(self, mocks):
        common = make_common(mocks, pod_deletion=True)
        s = ns("n1")
        common.process_wait_for_jobs_required_nodes(
            bucket(consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED, s), None
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_POD_DELETION_REQUIRED
        assert mocks["pod"].log.count("schedule_check_on_pod_completion") == 0

    def test_wait_for_jobs_delegates_with_selector(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        common.process_wait_for_jobs_required_nodes(
            bucket(consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED, s),
            WaitForCompletionSpec(pod_selector="app=job"),
        )
        assert mocks["pod"].log.count("schedule_check_on_pod_completion") == 1

    def test_pod_deletion_disabled_advances_to_drain(self, mocks):
        common = make_common(mocks, pod_deletion=False)
        s = ns("n1")
        common.process_pod_deletion_required_nodes(
            bucket(consts.UPGRADE_STATE_POD_DELETION_REQUIRED, s),
            PodDeletionSpec(),
            drain_enabled=True,
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_DRAIN_REQUIRED
        assert mocks["pod"].log.count("schedule_pod_eviction") == 0

    def test_drain_disabled_advances_to_pod_restart(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        common.process_drain_nodes(
            bucket(consts.UPGRADE_STATE_DRAIN_REQUIRED, s),
            DrainSpec(enable=False),
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_POD_RESTART_REQUIRED
        assert mocks["drain"].log.count("schedule_nodes_drain") == 0

    def test_drain_enabled_delegates(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        common.process_drain_nodes(
            bucket(consts.UPGRADE_STATE_DRAIN_REQUIRED, s),
            DrainSpec(enable=True),
        )
        assert mocks["drain"].log.count("schedule_nodes_drain") == 1


class TestPodRestartMocked:
    def test_out_of_sync_pod_scheduled_for_restart(self, mocks):
        common = make_common(mocks)
        mocks["pod"].ds_hash = "rev2"
        s = ns("n1", pod_hash="rev1")
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        (name, args, _k) = mocks["pod"].log.calls[-1]
        assert name == "schedule_pods_restart"
        assert args[0] == [s.driver_pod]

    def test_terminating_pod_not_restarted_again(self, mocks):
        common = make_common(mocks)
        mocks["pod"].ds_hash = "rev2"
        s = ns("n1", pod_hash="rev1")
        s.driver_pod["metadata"]["deletionTimestamp"] = 123.0
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        (name, args, _k) = mocks["pod"].log.calls[-1]
        assert args[0] == []

    def test_synced_ready_pod_advances_to_uncordon(self, mocks):
        common = make_common(mocks, validation=False)
        s = ns("n1")
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_UNCORDON_REQUIRED
        assert mocks["safe_load"].log.count("unblock_loading") == 1

    def test_synced_ready_pod_with_validation_goes_validation(self, mocks):
        common = make_common(mocks, validation=True)
        s = ns("n1")
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_VALIDATION_REQUIRED

    def test_restart_storm_goes_failed(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        s.driver_pod["status"]["containerStatuses"][0].update(
            {"ready": False, "restartCount": 11}
        )
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_FAILED

    def test_restart_count_at_threshold_not_failed(self, mocks):
        common = make_common(mocks)
        s = ns("n1")
        s.driver_pod["status"]["containerStatuses"][0].update(
            {"ready": False, "restartCount": 10}  # threshold is strict >
        )
        common.process_pod_restart_nodes(
            bucket(consts.UPGRADE_STATE_POD_RESTART_REQUIRED, s)
        )
        assert state_label(s.node) == ""


class TestValidationAndUncordonMocked:
    def test_validation_pass_advances(self, mocks):
        mocks["validation"].result = True
        common = make_common(mocks, validation=True)
        s = ns("n1")
        common.process_validation_required_nodes(
            bucket(consts.UPGRADE_STATE_VALIDATION_REQUIRED, s)
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_UNCORDON_REQUIRED

    def test_validation_pending_holds(self, mocks):
        mocks["validation"].result = False
        common = make_common(mocks, validation=True)
        s = ns("n1")
        common.process_validation_required_nodes(
            bucket(consts.UPGRADE_STATE_VALIDATION_REQUIRED, s)
        )
        assert state_label(s.node) == ""

    def test_initially_unschedulable_goes_done_and_annotation_cleared(
        self, mocks
    ):
        common = make_common(mocks)
        s = ns("n1")
        key = util.get_upgrade_initial_state_annotation_key()
        s.node["metadata"]["annotations"][key] = consts.TRUE_STRING
        common.update_node_to_uncordon_or_done_state(s)
        assert state_label(s.node) == consts.UPGRADE_STATE_DONE
        assert key not in s.node["metadata"]["annotations"]

    def test_failed_node_self_heals_when_pod_back_in_sync(self, mocks):
        common = make_common(mocks)
        s = ns("n1")  # pod in sync + ready
        common.process_upgrade_failed_nodes(
            bucket(consts.UPGRADE_STATE_FAILED, s)
        )
        assert state_label(s.node) == consts.UPGRADE_STATE_UNCORDON_REQUIRED
