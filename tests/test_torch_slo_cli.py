"""The classes of ``tests/test_slo.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestSloCli``, ``TestHistoryJsonParity``."""

import json

import pytest

from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, SloSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager, consts, util

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

    return InMemoryCluster()


STATE_KEY_OF = util.get_upgrade_state_label_key


def drive_rollout(cluster, fleet, policy, manager=None, max_cycles=200):
    """Reconcile until every managed node is done; returns the manager
    (caller shuts it down)."""
    manager = manager or ClusterUpgradeStateManager(cluster)
    for _ in range(max_cycles):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
        if fleet.all_done():
            return manager
    raise AssertionError(f"rollout did not converge: {fleet.states()}")


def rollout_policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def small_fleet(cluster, n=4):
    fleet = Fleet(cluster)
    for i in range(n):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("rev2")
    return fleet


class TestSloCli:
    def _dump(self, cluster, tmp_path, policy=None):
        if policy is not None:
            cluster.create(
                {
                    "kind": "GpuUpgradePolicy",
                    "apiVersion": "nvidia.com/v1alpha1",
                    "metadata": {"name": "pol", "namespace": NAMESPACE},
                    "spec": policy.to_dict(),
                }
            )
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        return str(path)

    def _rolled_dump(self, cluster, tmp_path, slos=None):
        fleet = small_fleet(cluster)
        policy = rollout_policy(slos=slos)
        manager = drive_rollout(cluster, fleet, policy)
        manager.shutdown()
        return self._dump(cluster, tmp_path, policy=policy)

    def test_offline_report_from_annotation_checkpoints(
        self, cluster, tmp_path, capsys
    ):
        path = self._rolled_dump(cluster, tmp_path)
        rc = cli_main(
            ["slo", "--state-file", path, "--namespace", NAMESPACE]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert "done 4/4" in out
        assert consts.UPGRADE_STATE_DRAIN_REQUIRED in out

    def test_offline_json_carries_phases_and_eta(
        self, cluster, tmp_path, capsys
    ):
        path = self._rolled_dump(cluster, tmp_path)
        rc = cli_main(
            ["slo", "--state-file", path, "--namespace", NAMESPACE, "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["counts"]["done"] == 4
        assert consts.UPGRADE_STATE_DRAIN_REQUIRED in data["phases"]
        assert data["eta"]["seconds"] == 0.0
        # no slos block in play -> analytics only
        assert "slos" not in data

    def test_policy_slos_evaluated_and_wait_exit_code(
        self, cluster, tmp_path, capsys
    ):
        path = self._rolled_dump(
            cluster, tmp_path, slos=SloSpec(max_node_phase_seconds=1e-6)
        )
        rc = cli_main(
            [
                "slo", "--state-file", path, "--namespace", NAMESPACE,
                "--policy", "pol", "--json", "--wait-exit-code",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 3
        assert [b["slo"] for b in data["slos"]["breaches"]] == [
            "maxNodePhaseSeconds"
        ]

    def test_selftest_green(self, capsys):
        rc = cli_main(["slo", "--selftest"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "slo selftest OK" in out

    def test_needs_a_source(self, capsys):
        rc = cli_main(["slo"])
        assert rc == 2
        assert "needs a source" in capsys.readouterr().err

    def test_status_cli_surfaces_breach(self, cluster, tmp_path, capsys):
        """The status CLI renders the SLO fragments beside the gates."""
        path = self._rolled_dump(
            cluster, tmp_path, slos=SloSpec(max_node_phase_seconds=1e-6)
        )
        rc = cli_main(
            [
                "status", "--state-file", path, "--namespace", NAMESPACE,
                "--policy", "pol",
            ]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert "SLO BREACH [maxNodePhaseSeconds]" in out


class TestHistoryJsonParity:
    def test_json_entries_match_rendered_rows(self, cluster, tmp_path, capsys):
        """Satellite: `history --json` is the machine view of exactly
        the rendered table (same entries, same order) so the slo
        tooling and external consumers can build on it."""
        from k8s_operator_libs_tpu_torch.upgrade.history import render_history

        fleet = small_fleet(cluster, n=2)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        manager.shutdown()
        # the rollout above wrote no Events (no recorder); write some
        recorder = util.ClusterEventRecorder(cluster, namespace="default")
        recorder.event("n0", "Normal", "gpu-driverUpgrade", "state set")
        recorder.event("n1", "Normal", "gpu-driverUpgrade", "state set")
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(["history", "--state-file", str(path), "--json"])
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert [e["node"] for e in data] == ["n0", "n1"]
        assert {
            "node", "type", "reason", "message", "count",
            "firstTimestamp", "lastTimestamp", "component",
        } <= set(data[0])
        from k8s_operator_libs_tpu_torch.upgrade.history import HistoryEntry

        rendered = render_history(
            [
                HistoryEntry(
                    node=e["node"],
                    type=e["type"],
                    reason=e["reason"],
                    message=e["message"],
                    count=e["count"],
                    first_timestamp=e["firstTimestamp"],
                    last_timestamp=e["lastTimestamp"],
                    component=e["component"],
                )
                for e in data
            ]
        )
        rc = cli_main(["history", "--state-file", str(path)])
        assert capsys.readouterr().out.strip() == rendered.strip()
