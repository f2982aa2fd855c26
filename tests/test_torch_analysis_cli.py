"""The classes of ``tests/test_analysis.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestGateSloThreePlanes``, ``TestRolloutStatusAnalysis`` (its CLI tests)."""

import json
import urllib.request

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import (
    AdaptivePacingSpec,
    AnalysisSpec,
    AnalysisStepSpec,
    DrainSpec,
    IntOrString,
    SloSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade import ClusterUpgradeStateManager, consts, util
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


STATE_KEY = util.get_upgrade_state_label_key()


@pytest.fixture()
def fresh_registry():
    registry = metrics.MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    yield registry
    metrics.set_default_registry(previous)


def rollout_policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def reconcile(manager, fleet, policy):
    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
    manager.apply_state(state, policy)
    manager.drain_manager.wait_idle(10.0)
    manager.pod_manager.wait_idle(10.0)
    fleet.reconcile_daemonset()
    return state


# ------------------------------------------------------- engine behavior
@pytest.fixture()
def gated_fleet():
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="rev1")
    for i in range(6):
        fleet.add_node(f"node-{i}")
    manager = ClusterUpgradeStateManager(cluster)
    yield cluster, fleet, manager
    manager.shutdown()


def analysis_policy(**analysis_kw):
    return rollout_policy(
        slos=SloSpec(fleet_completion_deadline_seconds=86400.0),
        analysis=AnalysisSpec(**analysis_kw),
    )


# ---------------------------------------------- three-plane explain e2e
class TestGateSloThreePlanes:
    def test_gate_slo_explained_live_http_and_offline(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder, tmp_path,
    ):
        from k8s_operator_libs_tpu_torch.controller.ops_server import OpsServer

        cluster, fleet, manager = gated_fleet
        sink = events_mod.ClusterDecisionEventSink(cluster)
        manager._decision_event_sink = sink
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0 for 3600s",),  # holds
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        for _ in range(3):
            reconcile(manager, fleet, policy)
        # plane 1: the live manager API
        gated = None
        for name in fleet.managed_nodes:
            answer = manager.explain_node(name) or {}
            if answer.get("reasonCode") == events_mod.REASON_SLO_GATE:
                gated = (name, answer)
                break
        assert gated is not None
        assert gated[1]["blockingGate"]["gate"] == "analysis"
        # plane 2: a real /debug/explain GET
        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            explain_source=manager.explain_node,
            analysis_source=manager.analysis_status,
        ).start()
        try:
            with urllib.request.urlopen(
                ops.url + f"/debug/explain?node={gated[0]}", timeout=5
            ) as rsp:
                served = json.loads(rsp.read())
            assert served["reasonCode"] == events_mod.REASON_SLO_GATE
            with urllib.request.urlopen(
                ops.url + "/debug", timeout=5
            ) as rsp:
                index = json.loads(rsp.read())
            assert "/debug/analysis" in index["endpoints"]
        finally:
            ops.stop()
        # plane 3: the offline explain CLI over a dump with the
        # persisted decision Events (the same reason code end to end)
        dump = dict(cluster.to_dict())
        dump["objects"] = list(dump["objects"]) + [
            {
                "apiVersion": "nvidia.com/v1",
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
                "spec": policy.to_dict(),
            }
        ]
        state_file = tmp_path / "dump.json"
        state_file.write_text(json.dumps(dump))
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        rc = cli_main(
            [
                "explain",
                "--state-file",
                str(state_file),
                "--node",
                gated[0],
                "--policy",
                "fleet-policy",
                "--json",
            ]
        )
        assert rc == 0

    def test_offline_explain_reason_code_matches(
        self, gated_fleet, fresh_decision_log, fresh_flight_recorder,
    ):
        from k8s_operator_libs_tpu_torch.upgrade import timeline as timeline_mod

        cluster, fleet, manager = gated_fleet
        sink = events_mod.ClusterDecisionEventSink(cluster)
        manager._decision_event_sink = sink
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0 for 3600s",),
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        for _ in range(3):
            reconcile(manager, fleet, policy)
        gated = next(
            n for n, s in fleet.states().items()
            if s == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )
        offline = InMemoryCluster.from_dict(cluster.to_dict())
        recorder = timeline_mod.FlightRecorder()
        offline_mgr = ClusterUpgradeStateManager(
            offline, flight_recorder=recorder
        )
        try:
            state = offline_mgr.build_state(NAMESPACE, DRIVER_LABELS)
        finally:
            offline_mgr.shutdown()
        decisions = events_mod.decisions_from_cluster(offline)
        answer = events_mod.explain_node(
            gated,
            state,
            policy=policy,
            recorder=recorder,
            decisions=decisions,
        )
        assert answer is not None
        assert answer["reasonCode"] == events_mod.REASON_SLO_GATE


# ------------------------------------------------- status / gate surface
class TestRolloutStatusAnalysis:
    def test_pacing_cli_offline_report(
        self, gated_fleet, fresh_decision_log, fresh_flight_recorder,
        tmp_path, capsys,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0",),
                ),
            ),
            pacing=AdaptivePacingSpec(),
        )
        fleet.publish_new_revision("rev2")
        for _ in range(2):
            reconcile(manager, fleet, policy)
        dump = dict(cluster.to_dict())
        dump["objects"] = list(dump["objects"]) + [
            {
                "apiVersion": "nvidia.com/v1",
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
                "spec": policy.to_dict(),
            }
        ]
        state_file = tmp_path / "dump.json"
        state_file.write_text(json.dumps(dump))
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        rc = cli_main(
            [
                "pacing",
                "--state-file",
                str(state_file),
                "--policy",
                "fleet-policy",
                "--json",
            ]
        )
        assert rc == 0
        report = json.loads(capsys.readouterr().out.strip())
        assert report["offline"] is True
        assert report["steps"][0]["name"] == "soak"

    def test_pacing_cli_requires_analysis_block(self, tmp_path, capsys):
        cluster = InMemoryCluster()
        Fleet(cluster, revision_hash="rev1")
        dump = dict(cluster.to_dict())
        dump["objects"] = list(dump["objects"]) + [
            {
                "apiVersion": "nvidia.com/v1",
                "kind": "GpuUpgradePolicy",
                "metadata": {"name": "p", "namespace": NAMESPACE},
                "spec": {"autoUpgrade": True},
            }
        ]
        state_file = tmp_path / "dump.json"
        state_file.write_text(json.dumps(dump))
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        assert (
            cli_main(
                [
                    "pacing",
                    "--state-file",
                    str(state_file),
                    "--policy",
                    "p",
                ]
            )
            == 3
        )
