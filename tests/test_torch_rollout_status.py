"""The port's RolloutStatus (k8s_operator_libs_tpu_torch/upgrade/
rollout_status.py) over snapshots of its state machine.

``TestRolloutStatus``, ``TestCountInvariant`` and the tests of
``TestGateReasons`` that do not call the CLI, from
``tests/test_rollout_status.py``, run here as cases of the same names on
the port in its vocabulary.  The JAX file imports the package's
``__main__`` (the ``status`` and ``repair`` CLI), which the port does not
hold yet: its CLI classes stay there.
"""

import pytest

from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import set_condition
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
STATE_KEY_OF = util.get_upgrade_state_label_key


def _mixed_fleet(cluster):
    """2-host slice mid-wave + singleton done + singleton failed."""
    fleet = Fleet(cluster)
    fleet.add_node(
        "s0-h0", pod_hash="rev1", labels={SLICE_KEY: "s0"}, unschedulable=True
    )
    fleet.add_node("s0-h1", pod_hash="rev1", labels={SLICE_KEY: "s0"})
    fleet.add_node("done-node")
    fleet.add_node("sick", pod_hash="rev1")
    fleet.publish_new_revision("rev2")
    states = {
        "s0-h0": consts.UPGRADE_STATE_DRAIN_REQUIRED,
        "s0-h1": consts.UPGRADE_STATE_CORDON_REQUIRED,
        "done-node": consts.UPGRADE_STATE_DONE,
        "sick": consts.UPGRADE_STATE_FAILED,
    }
    for name, st in states.items():
        cluster.patch(
            "Node", name, {"metadata": {"labels": {STATE_KEY_OF(): st}}}
        )
    return fleet


def _status(cluster):
    manager = ClusterUpgradeStateManager(cluster)
    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
    return RolloutStatus.from_cluster_state(state)


class TestRolloutStatus:
    def test_aggregate_counts(self, cluster):
        _mixed_fleet(cluster)
        s = _status(cluster)
        assert s.total_nodes == 4
        assert s.done == 1
        assert s.failed == 1
        assert s.in_progress == 3  # 2 slice hosts + failed (active census)
        assert s.pending == 0
        assert not s.complete
        assert s.percent_done == pytest.approx(25.0)

    def test_domain_breakdown(self, cluster):
        _mixed_fleet(cluster)
        s = _status(cluster)
        assert s.total_domains == 3
        by_name = {d.domain: d for d in s.domains}
        slice_dom = by_name["s0"]
        assert slice_dom.nodes == 2
        assert slice_dom.unavailable  # h0 is cordoned
        assert slice_dom.active and not slice_dom.done
        assert by_name["node:done-node"].done
        assert by_name["node:done-node"].singleton

    def test_complete_fleet(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("n1")
        cluster.patch(
            "Node",
            "n1",
            {"metadata": {"labels": {STATE_KEY_OF(): consts.UPGRADE_STATE_DONE}}},
        )
        s = _status(cluster)
        assert s.complete and s.percent_done == 100.0

    def test_not_ready_node_marks_domain_unavailable(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("s0-h0", labels={SLICE_KEY: "s0"})
        fleet.add_node("s0-h1", labels={SLICE_KEY: "s0"})
        node = cluster.get("Node", "s0-h1")
        set_condition(node, "Ready", "False")
        cluster.update(node)
        s = _status(cluster)
        assert s.domains[0].unavailable

    def test_render_and_dict(self, cluster):
        _mixed_fleet(cluster)
        s = _status(cluster)
        text = s.render()
        assert "DOMAIN" in text and "s0" in text and "drain-required=1" in text
        d = s.to_dict()
        assert d["totalNodes"] == 4 and len(d["domains"]) == 3
        assert d["byState"][consts.UPGRADE_STATE_FAILED] == 1




class TestCountInvariant:
    def test_corrupted_state_label_counts_as_unknown(self, cluster):
        """A node whose state label is corrupted must still satisfy
        done + in_progress + pending + unknown == total_nodes (ADVICE r1
        finding)."""
        fleet = Fleet(cluster)
        fleet.add_node("ok")
        fleet.add_node("bad")
        cluster.patch(
            "Node",
            "bad",
            {"metadata": {"labels": {STATE_KEY_OF(): "totally-bogus"}}},
        )
        s = _status(cluster)
        assert s.total_nodes == 2
        assert s.unknown >= 1
        assert (
            s.done + s.in_progress + s.pending + s.unknown == s.total_nodes
        )
        assert s.to_dict()["unknown"] == s.unknown

    def test_fresh_nodes_count_as_unknown(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("fresh")
        s = _status(cluster)
        assert s.unknown == 1
        assert s.done + s.in_progress + s.pending + s.unknown == 1


class TestGateReasons:
    """VERDICT r2 weak #4 / round-1 task 8: status explains WHY
    admissions are gated — frozen canary (which domain), closed window
    (next open), exhausted pacing (next budget)."""

    SLICE = SLICE_KEY

    def _slice_fleet(self, cluster, slices=3, hosts=2):
        fleet = Fleet(cluster)
        for s in range(slices):
            for h in range(hosts):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def _policy(self, **kw):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )

        base = dict(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        base.update(kw)
        return UpgradePolicySpec(**base)

    def _state(self, cluster):
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.01,
        )
        return manager, manager.build_state(NAMESPACE, DRIVER_LABELS)

    def test_frozen_canary_gate_names_failed_domain(self, cluster):
        fleet = self._slice_fleet(cluster)
        policy = self._policy(canary_domains=1)
        manager, _ = self._state(cluster)
        for _i in range(2):  # classify unknown -> admit the canary
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
        admitted = [
            n for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert admitted
        for name in admitted:  # force the canary into upgrade-failed
            cluster.patch(
                "Node",
                name,
                {"metadata": {"labels": {
                    STATE_KEY_OF(): consts.UPGRADE_STATE_FAILED
                }}},
            )
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        gates = {g.gate: g for g in status.gates}
        assert gates["canary"].blocking is True
        failed_domain = admitted[0].split("-")[0]
        assert gates["canary"].detail["failedDomains"] == [failed_domain]
        assert "FROZEN" in gates["canary"].reason
        assert failed_domain in gates["canary"].reason
        assert "GATED" in status.summary()
        assert "canary" in status.render()
        assert "gates" in status.to_dict()

    def test_soaking_canary_gate_blocking_but_not_failed(self, cluster):
        fleet = self._slice_fleet(cluster)
        policy = self._policy(canary_domains=1)
        manager, _ = self._state(cluster)
        for _i in range(2):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
        del fleet
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        gates = {g.gate: g for g in status.gates}
        assert gates["canary"].blocking is True
        assert gates["canary"].detail["failedDomains"] == []
        # "in progress" = units mid-flight; "baking"/"soaking" now names
        # the canarySoakSeconds window after they succeed
        assert "in progress" in gates["canary"].reason

    def test_closed_window_gate_reports_next_open(
        self, cluster, monkeypatch
    ):
        from datetime import datetime, timezone

        from k8s_operator_libs_tpu_torch.api import MaintenanceWindowSpec
        from k8s_operator_libs_tpu_torch.upgrade import schedule

        self._slice_fleet(cluster)
        monkeypatch.setattr(
            schedule,
            "_now_utc",
            lambda: datetime(2026, 7, 29, 12, 0, tzinfo=timezone.utc),
        )
        policy = self._policy(
            maintenance_window=MaintenanceWindowSpec(
                start="22:00", duration_minutes=60
            )
        )
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        gates = {g.gate: g for g in status.gates}
        assert gates["maintenanceWindow"].blocking is True
        assert gates["maintenanceWindow"].detail["nextOpen"] == (
            "2026-07-29T22:00:00+00:00"
        )
        assert "22:00" in gates["maintenanceWindow"].reason

    def test_exhausted_pacing_gate_reports_next_budget(self, cluster):
        import time as _time

        self._slice_fleet(cluster, slices=2, hosts=1)
        stamp = _time.time() - 600  # admitted 10 minutes ago
        cluster.patch(
            "Node",
            "s0-h0",
            {"metadata": {"annotations": {
                util.get_admitted_at_annotation_key(): repr(stamp)
            }}},
        )
        policy = self._policy(max_nodes_per_hour=1)
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        gates = {g.gate: g for g in status.gates}
        assert gates["pacing"].blocking is True
        assert gates["pacing"].detail["nextBudgetAt"] is not None
        # the budget returns when the 10-minute-old stamp ages out
        from datetime import datetime

        next_at = datetime.fromisoformat(
            gates["pacing"].detail["nextBudgetAt"]
        ).timestamp()
        assert abs(next_at - (stamp + 3600)) < 1.0

    def test_open_gates_not_blocking(self, cluster):
        self._slice_fleet(cluster)
        policy = self._policy(max_nodes_per_hour=100)
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        gates = {g.gate: g for g in status.gates}
        assert gates["pacing"].blocking is False
        assert status.blocking_gates == []
        assert "GATED" not in status.summary()

    def test_no_policy_no_gates(self, cluster):
        self._slice_fleet(cluster)
        _, state = self._state(cluster)
        status = RolloutStatus.from_cluster_state(state)
        assert status.gates == []
        assert "gates" not in status.to_dict()







        # (frame COUNT is timing-dependent — a fast rollout may finish
        # before the first poll, making one frame the correct output)


