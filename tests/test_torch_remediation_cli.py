"""The classes of ``tests/test_remediation.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestSurfaces`` (``test_cli_remediation_offline_dump``)."""

import json

import pytest

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster import InformerCache
from k8s_operator_libs_tpu_torch.upgrade import util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_remediation import TestBreakerAndRollback as _BreakerRig
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


STATE_KEY = util.get_upgrade_state_label_key


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


class TestSurfaces:
    def _tripped(self):
        helper = _BreakerRig()
        cluster, fleet, policy, manager = helper.drive_to_trip(
            auto_rollback=False
        )
        cycle(manager, fleet, policy, 25)
        # one stranded pending node so the gate has admissions to block
        fleet.add_node("n99", pod_hash="rev1")
        cycle(manager, fleet, policy, 3)
        return cluster, fleet, policy, manager

    def test_cli_remediation_offline_dump(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main

        cluster, fleet, policy, manager = self._tripped()
        try:
            dump = tmp_path / "cluster.json"
            dump.write_text(json.dumps(cluster.to_dict()))
        finally:
            manager.shutdown()
        rc = main(
            [
                "remediation",
                "--state-file",
                str(dump),
                "--json",
            ]
        )
        out = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert out["blocking"] is True
        assert out["breaker"]["state"] == "open"
        # poll-friendly exit code
        rc = main(
            [
                "remediation",
                "--state-file",
                str(dump),
                "--wait-exit-code",
            ]
        )
        capsys.readouterr()
        assert rc == 3
