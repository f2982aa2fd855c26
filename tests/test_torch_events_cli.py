"""The classes of ``tests/test_events.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestCli``."""

import json

import pytest

from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    MaintenanceWindowSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


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


# ------------------------------------------------------------------- CLI
class TestCli:
    def dump_deferred_fleet(self, tmp_path):
        cluster = InMemoryCluster()
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(3):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        sink = events_mod.ClusterDecisionEventSink(cluster)
        manager = ClusterUpgradeStateManager(
            cluster, decision_event_sink=sink
        )
        try:
            policy = throttled_policy()
            reconcile_once(manager, policy)
            reconcile_once(manager, policy)
        finally:
            manager.shutdown()
        deferred = sorted(
            d["target"]
            for d in events_mod.default_log().events(type_="NodeDeferred")
        )
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        return str(path), deferred

    def test_explain_offline_json(self, tmp_path, capsys):
        path, deferred = self.dump_deferred_fleet(tmp_path)
        rc = cli_main(
            [
                "explain",
                "--state-file", path,
                "--node", deferred[0],
                "--json",
            ]
        )
        assert rc == 0
        answer = json.loads(capsys.readouterr().out)
        assert answer["reasonCode"] == "budget"
        assert answer["verdict"] == "blocked"

    def test_explain_human_and_unknown_node(self, tmp_path, capsys):
        path, deferred = self.dump_deferred_fleet(tmp_path)
        rc = cli_main(["explain", "--state-file", path, "--node", deferred[0]])
        assert rc == 0
        out = capsys.readouterr().out
        assert "BLOCKED [budget]" in out
        rc = cli_main(["explain", "--state-file", path, "--node", "ghost"])
        assert rc == 3

    def test_explain_requires_node(self, tmp_path, capsys):
        path, _ = self.dump_deferred_fleet(tmp_path)
        rc = cli_main(["explain", "--state-file", path])
        assert rc == 2

    def test_events_cli_lists_persisted_stream(self, tmp_path, capsys):
        path, deferred = self.dump_deferred_fleet(tmp_path)
        rc = cli_main(["events", "--state-file", path, "--json"])
        assert rc == 0
        decisions = json.loads(capsys.readouterr().out)
        assert any(d["type"] == "NodeDeferred" for d in decisions)
        rc = cli_main(
            ["events", "--state-file", path, "--node", deferred[0]]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "NodeDeferred[budget]" in out

    def test_status_offline_carries_decisions(self, tmp_path, capsys):
        path, _deferred = self.dump_deferred_fleet(tmp_path)
        rc = cli_main(["status", "--state-file", path, "--json"])
        assert rc == 0
        payload = json.loads(capsys.readouterr().out)
        assert any(
            d["type"] == "NodeDeferred" for d in payload.get("decisions", [])
        )
