"""The classes of ``tests/test_tracing.py`` that waited for the CLI, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestExportersAndCli`` (``test_cli_traces_file_and_selftest``)."""

from __future__ import annotations

import json
import threading
import time

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    PreDrainCheckpointSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import tracing
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import (
    CheckpointDrainGate,
    DrainSignalWatcher,
)
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    consts,
)

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


class TestExportersAndCli:
    def _one_trace(self):
        tracer = tracing.Tracer()
        with tracer.start_span("Reconcile") as root:
            with tracer.start_span("BuildState"):
                time.sleep(0.001)
        return tracer.traces(), root

    def test_cli_traces_file_and_selftest(self, tmp_path, capsys):
        from k8s_operator_libs_tpu_torch.__main__ import main as cli_main

        traces, root = self._one_trace()
        path = tmp_path / "traces.json"
        path.write_text(json.dumps(tracing.to_otlp(traces)))
        assert cli_main(["traces", "--file", str(path)]) == 0
        out = capsys.readouterr().out
        assert "Reconcile" in out and root.trace_id in out

        assert cli_main(["traces", "--file", str(path), "--fmt", "chrome"]) == 0
        chrome = json.loads(capsys.readouterr().out)
        assert chrome["traceEvents"]

        assert cli_main(["traces", "--selftest"]) == 0
        assert "selftest ok" in capsys.readouterr().out

        assert cli_main(["traces", "--file", str(tmp_path / "absent.json")]) == 2
        capsys.readouterr()
        (tmp_path / "junk.json").write_text("{\"nope\": 1}")
        assert cli_main(["traces", "--file", str(tmp_path / "junk.json")]) == 2
        capsys.readouterr()
        assert (
            cli_main(
                ["traces", "--file", str(path), "--trace-id", "f" * 32]
            )
            == 3
        )


def _run_traced_rollout(nodes: int = 3):
    """A full stub-cluster upgrade under ONE root span, with the
    checkpoint-drain handshake answered by a workload-side thread.
    Returns (tracer, registry, root_span)."""
    tracer = tracing.Tracer()
    prev_tracer = tracing.set_default_tracer(tracer)
    registry = metrics.MetricsRegistry()
    prev_registry = metrics.set_default_registry(registry)
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for i in range(nodes):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("v2")
    gate = CheckpointDrainGate(
        cluster, PreDrainCheckpointSpec(enable=True, timeout_second=5)
    )
    manager = ClusterUpgradeStateManager(
        cluster,
        pre_drain_gate=gate,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    stop = threading.Event()

    def responder():
        watchers = [
            DrainSignalWatcher(cluster, f"n{i}") for i in range(nodes)
        ]
        while not stop.is_set():
            for watcher in watchers:
                watcher.check_and_acknowledge(lambda: None)
            time.sleep(0.005)

    thread = threading.Thread(target=responder, daemon=True)
    thread.start()
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )
    try:
        with tracing.start_span("Upgrade", attributes={"nodes": nodes}) as root:
            for _ in range(40):
                state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
                manager.apply_state(state, policy)
                manager.drain_manager.wait_idle(10.0)
                manager.pod_manager.wait_idle(10.0)
                fleet.reconcile_daemonset()
                if set(fleet.states().values()) == {
                    consts.UPGRADE_STATE_DONE
                }:
                    break
            else:
                raise AssertionError(f"no convergence: {fleet.states()}")
    finally:
        stop.set()
        thread.join(2.0)
        manager.shutdown()
        tracing.set_default_tracer(prev_tracer)
        metrics.set_default_registry(prev_registry)
    return tracer, registry, root
