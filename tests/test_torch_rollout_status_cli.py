"""The classes of ``tests/test_rollout_status.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestStatusCli``, ``TestCliPolicyTopologyAndValidation``, ``TestStatusCliLiveMode``, ``TestStatusWatchMode``, ``TestRepairCli``, ``TestGateReasons`` (``test_cli_policy_flag_shows_gate``)."""

import json

import pytest

from k8s_operator_libs_tpu_torch.__main__ import main as cli_main
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    RolloutStatus,
    consts,
    util,
)

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

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


class TestStatusCli:
    def _dump(self, cluster, tmp_path):
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        return str(path)

    def test_table_output(self, cluster, tmp_path, capsys):
        _mixed_fleet(cluster)
        rc = cli_main(
            ["status", "--state-file", self._dump(cluster, tmp_path)]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert "done 1/4 nodes" in out
        assert "s0" in out

    def test_json_output(self, cluster, tmp_path, capsys):
        _mixed_fleet(cluster)
        rc = cli_main(
            ["status", "--state-file", self._dump(cluster, tmp_path), "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["done"] == 1 and data["failed"] == 1

    def test_wait_exit_code(self, cluster, tmp_path, capsys):
        _mixed_fleet(cluster)
        rc = cli_main(
            [
                "status",
                "--state-file",
                self._dump(cluster, tmp_path),
                "--wait-exit-code",
            ]
        )
        assert rc == 3  # rollout incomplete

    def test_missing_state_file(self, tmp_path, capsys):
        rc = cli_main(
            ["status", "--state-file", str(tmp_path / "nope.json")]
        )
        assert rc == 2

    def test_corrupt_state_file(self, tmp_path, capsys):
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        rc = cli_main(["status", "--state-file", str(bad)])
        assert rc == 2
        assert "not a cluster dump" in capsys.readouterr().err

    def test_empty_selection_reports_zero_percent(
        self, cluster, tmp_path, capsys
    ):
        """A selector matching nothing must not claim 100% done while the
        wait exit code says incomplete."""
        _mixed_fleet(cluster)
        rc = cli_main(
            [
                "status",
                "--state-file",
                self._dump(cluster, tmp_path),
                "--selector",
                "app=no-such-driver",
                "--json",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["percentDone"] == 0.0 and data["complete"] is False

    def test_unknown_state_keyed_readably_in_json(
        self, cluster, tmp_path, capsys
    ):
        fleet = Fleet(cluster)
        fleet.add_node("fresh")  # no state label yet
        cli_main(
            ["status", "--state-file", self._dump(cluster, tmp_path), "--json"]
        )
        data = json.loads(capsys.readouterr().out)
        assert data["byState"] == {"unknown": 1}


class TestGateReasons:
    """Status explains WHY
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

    def test_cli_policy_flag_shows_gate(self, cluster, tmp_path, capsys):
        """`python -m k8s_operator_libs_tpu status --policy ...` during a
        frozen canary shows the gate."""
        fleet = self._slice_fleet(cluster)
        policy = self._policy(canary_domains=1)
        manager, _ = self._state(cluster)
        for _i in range(2):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
        admitted = [
            n for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        for name in admitted:
            cluster.patch(
                "Node",
                name,
                {"metadata": {"labels": {
                    STATE_KEY_OF(): consts.UPGRADE_STATE_FAILED
                }}},
            )
        cluster.create(
            {
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "pol", "namespace": NAMESPACE},
                "spec": policy.to_dict(),
            }
        )
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            [
                "status",
                "--state-file",
                str(path),
                "--namespace",
                NAMESPACE,
                "--policy",
                "pol",
            ]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert "admission gates:" in out
        assert "FROZEN" in out
        # and --json carries the machine-readable gate
        cli_main(
            [
                "status",
                "--state-file",
                str(path),
                "--namespace",
                NAMESPACE,
                "--policy",
                "pol",
                "--json",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        canary = [g for g in data["gates"] if g["gate"] == "canary"][0]
        assert canary["blocking"] is True
        assert canary["detail"]["failedDomains"]


class TestCliPolicyTopologyAndValidation:
    """Review regressions: the status CLI must apply the policy's
    topology label keys and reject invalid policies gracefully."""

    RACK = "example.com/rack"

    def _rack_fleet(self, cluster):
        fleet = Fleet(cluster)
        for r in range(2):
            for h in range(2):
                fleet.add_node(
                    f"r{r}-h{h}", labels={self.RACK: f"rack-{r}"}
                )
        return fleet

    def _dump_with_policy(self, cluster, tmp_path, spec_dict):
        import json as _json

        cluster.create(
            {
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "pol", "namespace": NAMESPACE},
                "spec": spec_dict,
            }
        )
        path = tmp_path / "cluster.json"
        path.write_text(_json.dumps(cluster.to_dict()))
        return str(path)

    def test_cli_applies_policy_topology_keys(
        self, cluster, tmp_path, capsys
    ):
        self._rack_fleet(cluster)
        path = self._dump_with_policy(
            cluster,
            tmp_path,
            {
                "autoUpgrade": True,
                "sliceAware": True,
                "sliceLabelKeys": [self.RACK],
            },
        )
        rc = cli_main(
            [
                "status", "--state-file", path,
                "--namespace", NAMESPACE,
                "--policy", "pol", "--json",
            ]
        )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        domains = {d["domain"] for d in data["domains"]}
        assert domains == {"rack-0", "rack-1"}  # NOT node: singletons

    def test_cli_rejects_invalid_policy(self, cluster, tmp_path, capsys):
        self._rack_fleet(cluster)
        path = self._dump_with_policy(
            cluster,
            tmp_path,
            {"autoUpgrade": True, "validation": {"onMissingPods": "explode"}},
        )
        rc = cli_main(
            [
                "status", "--state-file", path,
                "--namespace", NAMESPACE, "--policy", "pol",
            ]
        )
        assert rc == 2
        assert "invalid" in capsys.readouterr().err


class TestStatusCliLiveMode:
    """`status --kubeconfig`: the CLI computes live from a real apiserver
    through KubeApiClient — no dump file."""

    def test_live_status_over_http(self, cluster, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        _mixed_fleet(cluster)
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
                ["status", "--kubeconfig", str(kubeconfig), "--json"]
            )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert data["done"] == 1 and data["totalNodes"] == 4

    def test_no_source_is_an_error(self, capsys):
        rc = cli_main(["status"])
        assert rc == 2
        assert "needs a source" in capsys.readouterr().err

    def test_live_mode_unreachable_server_exits_2(self, tmp_path, capsys):
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
                    "  cluster: {server: 'http://127.0.0.1:1'}",
                    "users:",
                    "- name: test",
                    "  user: {token: dummy}",
                ]
            )
        )
        rc = cli_main(["status", "--kubeconfig", str(kubeconfig)])
        assert rc == 2
        assert "cannot read cluster state" in capsys.readouterr().err

    def test_conflicting_sources_rejected(self, tmp_path, capsys):
        dump = tmp_path / "dump.json"
        dump.write_text("{}")
        rc = cli_main(
            [
                "status",
                "--state-file",
                str(dump),
                "--kubeconfig",
                str(tmp_path / "kc"),
            ]
        )
        assert rc == 2
        assert "ONE source" in capsys.readouterr().err


class TestStatusWatchMode:
    """status --watch: block until the rollout completes, printing on
    change (kubectl rollout status behavior)."""

    def _kubeconfig(self, tmp_path, url):
        kc = tmp_path / "kubeconfig"
        kc.write_text(
            "\n".join(
                [
                    "apiVersion: v1",
                    "kind: Config",
                    "current-context: t",
                    "contexts:",
                    "- name: t",
                    "  context: {cluster: t, user: t}",
                    "clusters:",
                    f"- name: t\n  cluster: {{server: {url}}}",
                    "users:",
                    "- name: t\n  user: {token: x}",
                ]
            )
        )
        return str(kc)

    def test_watch_rejects_state_file(self, cluster, tmp_path, capsys):
        dump = tmp_path / "d.json"
        dump.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(
            ["status", "--state-file", str(dump), "--watch"]
        )
        assert rc == 2
        assert "live source" in capsys.readouterr().err

    def test_watch_blocks_until_complete(self, cluster, tmp_path, capsys):
        import threading

        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        fleet = Fleet(cluster)
        for i in range(2):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")

        roll_errors = []

        def roll():
            try:
                manager = ClusterUpgradeStateManager(
                    cluster,
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
                for _ in range(40):
                    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
                    manager.apply_state(state, policy)
                    manager.drain_manager.wait_idle(10.0)
                    manager.pod_manager.wait_idle(10.0)
                    fleet.reconcile_daemonset()
                    if set(fleet.states().values()) == {
                        consts.UPGRADE_STATE_DONE
                    }:
                        return
                raise AssertionError("background rollout did not converge")
            except Exception as err:  # noqa: BLE001 — surfaced below
                roll_errors.append(err)
                # force completion so the watch loop in the MAIN thread
                # terminates — otherwise a rollout regression would hang
                # the test until the CI job-level timeout with no message
                for node in cluster.list("Node"):
                    cluster.patch(
                        "Node",
                        node["metadata"]["name"],
                        {
                            "metadata": {
                                "labels": {
                                    STATE_KEY_OF(): consts.UPGRADE_STATE_DONE
                                }
                            }
                        },
                    )

        with ApiServerFacade(cluster) as facade:
            t = threading.Thread(target=roll, daemon=True)
            t.start()
            rc = cli_main(
                [
                    "status",
                    "--kubeconfig",
                    self._kubeconfig(tmp_path, facade.url),
                    "--watch",
                    "--interval",
                    "0.05",
                ]
            )
            t.join(15.0)
        out = capsys.readouterr().out
        assert roll_errors == [], f"background rollout failed: {roll_errors}"
        assert rc == 0  # returned only once complete
        assert "done 2/2" in out  # final frame shows completion


class TestRepairCli:
    """`repair`: the upgrade-failed runbook (replace the driver pod so
    the node self-heals) as a CLI — dry-run by default, writes need
    --yes, dumps are rejected (it mutates the cluster)."""

    def _kubeconfig(self, tmp_path, url):
        kc = tmp_path / "kubeconfig"
        kc.write_text(
            "\n".join(
                [
                    "apiVersion: v1",
                    "kind: Config",
                    "current-context: t",
                    "contexts:",
                    "- name: t",
                    "  context: {cluster: t, user: t}",
                    "clusters:",
                    f"- name: t\n  cluster: {{server: {url}}}",
                    "users:",
                    "- name: t\n  user: {token: x}",
                ]
            )
        )
        return str(kc)

    def _failed_fleet(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("good", pod_hash="rev2")
        fleet.add_node("sick", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "good",
            {"metadata": {"labels": {STATE_KEY_OF(): consts.UPGRADE_STATE_DONE}}},
        )
        cluster.patch(
            "Node",
            "sick",
            {
                "metadata": {
                    "labels": {STATE_KEY_OF(): consts.UPGRADE_STATE_FAILED}
                }
            },
        )
        return fleet

    def test_rejects_state_file(self, cluster, tmp_path, capsys):
        dump = tmp_path / "d.json"
        dump.write_text(json.dumps(cluster.to_dict()))
        rc = cli_main(["repair", "--state-file", str(dump)])
        assert rc == 2
        assert "live source" in capsys.readouterr().err

    def test_dry_run_lists_without_deleting(self, cluster, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        self._failed_fleet(cluster)
        pods_before = len(cluster.list("Pod", namespace=NAMESPACE))
        with ApiServerFacade(cluster) as facade:
            rc = cli_main(
                ["repair", "--kubeconfig", self._kubeconfig(tmp_path, facade.url)]
            )
        out = capsys.readouterr().out
        assert rc == 0
        assert "sick" in out and "dry run" in out
        assert "good" not in out.split("dry run")[0]  # only failed nodes
        assert len(cluster.list("Pod", namespace=NAMESPACE)) == pods_before

    def test_yes_deletes_and_node_self_heals(self, cluster, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.api import (
            DrainSpec,
            IntOrString,
            UpgradePolicySpec,
        )
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
            ClusterUpgradeStateManager,
        )

        fleet = self._failed_fleet(cluster)
        with ApiServerFacade(cluster) as facade:
            rc = cli_main(
                [
                    "repair",
                    "--kubeconfig",
                    self._kubeconfig(tmp_path, facade.url),
                    "--yes",
                ]
            )
        assert rc == 0
        assert "repaired 1/1" in capsys.readouterr().out
        # DS recreates the pod at the target revision; the state machine
        # self-heals the failed node (failed-recovery processor)
        fleet.reconcile_daemonset()
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        for _ in range(20):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_node_filter_and_not_failed_exit(self, cluster, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        self._failed_fleet(cluster)
        with ApiServerFacade(cluster) as facade:
            kc = self._kubeconfig(tmp_path, facade.url)
            rc = cli_main(["repair", "--kubeconfig", kc, "--node", "good"])
            assert rc == 3
            assert "not in upgrade-failed" in capsys.readouterr().err
            rc = cli_main(
                ["repair", "--kubeconfig", kc, "--node", "sick", "--json"]
            )
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert len(data) == 1 and data[0]["node"] == "sick"

    def test_json_yes_reports_apply_outcomes(self, cluster, tmp_path, capsys):
        """ADVICE r3: with --yes the JSON output must report what
        actually happened (applied/error per entry), not the pre-apply
        plan — machine consumers otherwise never learn which deletions
        succeeded."""
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        self._failed_fleet(cluster)
        with ApiServerFacade(cluster) as facade:
            kc = self._kubeconfig(tmp_path, facade.url)
            rc = cli_main(["repair", "--kubeconfig", kc, "--json", "--yes"])
        data = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert len(data) == 1
        assert data[0]["node"] == "sick"
        assert data[0]["applied"] is True
        assert "error" not in data[0]
        # the pod really is gone
        pods = cluster.list("Pod", namespace=NAMESPACE)
        assert all(
            (p.get("spec") or {}).get("nodeName") != "sick" for p in pods
        )

    def test_json_yes_empty_plan_prints_empty_list(
        self, cluster, tmp_path, capsys
    ):
        from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade

        Fleet(cluster).add_node("healthy", pod_hash="rev1")
        with ApiServerFacade(cluster) as facade:
            kc = self._kubeconfig(tmp_path, facade.url)
            rc = cli_main(["repair", "--kubeconfig", kc, "--json", "--yes"])
        assert rc == 0
        assert json.loads(capsys.readouterr().out) == []
