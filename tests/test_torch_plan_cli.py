"""The classes of ``tests/test_plan.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestPlanCli``, ``TestPlanReviewRegressions`` (``test_explicit_policy_not_found_is_fatal``, ``test_inconsistent_snapshot_exits_2_not_traceback``, ``test_live_dump_rv_floor_prevents_collisions``), ``TestPlanModes`` (``test_requestor_cli_flag``, ``test_requestor_cli_honors_prefix_env``)."""

from __future__ import annotations

import json

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.upgrade import consts

from test_torch_harness import NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

    return InMemoryCluster()


def _policy(**kwargs) -> UpgradePolicySpec:
    kwargs.setdefault("auto_upgrade", True)
    kwargs.setdefault(
        "drain_spec", DrainSpec(enable=True, force=True, timeout_second=60)
    )
    return UpgradePolicySpec(**kwargs)


def _fleet(n_slices=3, hosts=2) -> tuple:
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for s in range(n_slices):
        for h in range(hosts):
            fleet.add_node(
                f"slice{s}-host{h}",
                labels={consts.SLICE_ID_LABEL_KEYS[0]: f"slice-{s}"},
            )
    fleet.publish_new_revision("v2")
    return cluster, fleet


class TestPlanCli:
    def _dump(self, cluster, tmp_path):
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        return str(path)

    def test_plan_table_output(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        rc = cli_main(["plan", "--state-file", self._dump(cluster, tmp_path)])
        captured = capsys.readouterr()
        assert rc == 0
        assert "Next admissions" in captured.out
        assert "Cycle 1:" in captured.out
        assert "reference-default policy" in captured.err

    def test_plan_json_with_policy_cr(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        cluster.create(
            {
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
                "spec": {
                    "autoUpgrade": True,
                    "maxParallelUpgrades": 0,
                    "maxUnavailable": "100%",
                    "sliceAware": True,
                },
            }
        )
        rc = cli_main(
            [
                "plan",
                "--state-file",
                self._dump(cluster, tmp_path),
                "--policy",
                "fleet-policy",
                "--json",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["converged"] is True
        # slice-aware 100%: both slices admitted in the first admitting cycle
        assert len(data["nextAdmissions"]) == 4

    def test_plan_never_writes_to_state_file(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        path = self._dump(cluster, tmp_path)
        before = open(path).read()
        rc = cli_main(["plan", "--state-file", path])
        assert rc == 0
        assert open(path).read() == before

    def test_plan_live_mode_reads_only(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        cluster, _ = _fleet(n_slices=2)
        rv_before = cluster.journal_seq()
        with ApiServerFacade(cluster) as facade:
            kubeconfig = tmp_path / "kubeconfig"
            kubeconfig.write_text(
                "\n".join(
                    [
                        "apiVersion: v1",
                        "kind: Config",
                        "current-context: test",
                        "contexts:",
                        "- name: test",
                        "  context: {cluster: test, user: test}",
                        "clusters:",
                        "- name: test",
                        f"  cluster: {{server: {facade.url}}}",
                        "users:",
                        "- name: test",
                        "  user: {token: dummy}",
                    ]
                )
            )
            rc = cli_main(
                ["plan", "--kubeconfig", str(kubeconfig), "--json"]
            )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["transitions"]
        # read-only: no write advanced the source cluster's RV
        assert cluster.journal_seq() == rv_before

    def test_plan_cycles_flag_caps_horizon(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        rc = cli_main(
            [
                "plan",
                "--state-file",
                self._dump(cluster, tmp_path),
                "--cycles",
                "1",
                "--json",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["cyclesSimulated"] == 1
        assert data["converged"] is False


class TestPlanReviewRegressions:
    """Fixes from review: bystander nodes, explicit-policy failures,
    snapshot-inconsistency exit codes, and sandbox thread cleanup."""

    def test_explicit_policy_not_found_is_fatal(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            [
                "plan",
                "--state-file",
                str(path),
                "--policy",
                "typo-name",
            ]
        )
        assert rc == 2
        err = capsys.readouterr().err
        assert "could not be loaded" in err

    def test_inconsistent_snapshot_exits_2_not_traceback(
        self, tmp_path, capsys
    ):
        """An unscheduled-driver-pod snapshot makes build_state raise
        UpgradeStateError; the CLI must exit 2 with a message."""
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, fleet = _fleet(n_slices=2)
        ds = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
        ds["status"]["desiredNumberScheduled"] = 99
        cluster.update(ds)
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(["plan", "--state-file", str(path)])
        assert rc == 2
        assert "cannot plan" in capsys.readouterr().err

    def test_live_dump_rv_floor_prevents_collisions(self, tmp_path, capsys):
        """Live-mode plan seeds the sandbox RV counter above every
        restored RV (rv=0 let sandbox writes mint
        colliding resourceVersions)."""
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        cluster, _ = _fleet(n_slices=2)
        with ApiServerFacade(cluster) as facade:
            kubeconfig = tmp_path / "kubeconfig"
            kubeconfig.write_text(
                "\n".join(
                    [
                        "apiVersion: v1",
                        "kind: Config",
                        "current-context: test",
                        "contexts:",
                        "- name: test",
                        "  context: {cluster: test, user: test}",
                        "clusters:",
                        "- name: test",
                        f"  cluster: {{server: {facade.url}}}",
                        "users:",
                        "- name: test",
                        "  user: {token: dummy}",
                    ]
                )
            )
            rc = cli_main(["plan", "--kubeconfig", str(kubeconfig), "--json"])
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        # the projection runs a full rollout on the clone; RV collisions
        # would surface as missed conflicts / stuck transitions
        assert data["converged"] is True


class TestPlanModes:
    """Planning with the operator's optional assembly mirrored: requestor
    mode (NodeMaintenance handoff) and the validation builder state."""

    def test_requestor_cli_flag(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        cluster, _ = _fleet(n_slices=2)
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            ["plan", "--state-file", str(path), "--requestor", "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert any(
            t["to"] == consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
            for t in data["transitions"]
        )

    def test_requestor_cli_honors_prefix_env(self, tmp_path, capsys, monkeypatch):
        """--requestor builds its options through the operator's env
        contract (the CR name prefix was dropped, so the
        plan would miss in-flight CRs and project duplicates)."""
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        monkeypatch.setenv(
            "MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX", "myprefix"
        )
        cluster, _ = _fleet(n_slices=1)
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            ["plan", "--state-file", str(path), "--requestor", "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["converged"] is True
