"""The port's command line (``python -m k8s_operator_libs_tpu_torch``)
held to the JAX package's.

One harness fleet is taken part-way through a rollout by the JAX
package's ``ClusterUpgradeStateManager`` under a ``TpuUpgradePolicy``
CR, and dumped.  Each read-only subcommand then runs in process through
each package's ``main(argv)``: the JAX CLI on the dump, the port's on
the dump mapped by ``to_port_vocab``.  Exit codes are equal, and each
``--json`` output of the port is the JAX one after ``to_port_vocab``;
the error paths of ``tests/test_cli_edges.py`` too.  Last, the CLI's
logger: ``chaos`` silences the port's own log records unless
``--verbose``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from k8s_operator_libs_tpu import __main__ as jcli
from k8s_operator_libs_tpu.api import (
    DrainSpec as JDrainSpec,
    IntOrString as JIntOrString,
    RemediationSpec as JRemediationSpec,
    SloSpec as JSloSpec,
    UpgradePolicySpec as JUpgradePolicySpec,
)
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JInMemoryCluster
from k8s_operator_libs_tpu.obs import events as jevents
from k8s_operator_libs_tpu.obs import tracing as jtracing
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade.upgrade_state import (
    ClusterUpgradeStateManager as JManager,
)
from k8s_operator_libs_tpu_torch import __main__ as cli

from harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

ROOT = Path(__file__).resolve().parent.parent
POLICY = "fleet"


def _policy() -> JUpgradePolicySpec:
    return JUpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=4,
        max_unavailable=JIntOrString("50%"),
        drain_spec=JDrainSpec(enable=True, force=True, timeout_second=30),
        slice_aware=True,
        remediation=JRemediationSpec(failure_threshold=0.5, min_attempted=2),
        slos=JSloSpec(max_node_phase_seconds=600.0, drain_p99_seconds=300.0),
    )


@pytest.fixture()
def dumps(tmp_path):
    """(JAX dump, port dump, JAX trace file, port trace file): a 12-node
    fleet of three slices four passes into a rollout to rev2."""
    cluster = JInMemoryCluster()
    fleet = Fleet(cluster, revision_hash="rev1")
    for i in range(12):
        fleet.add_node(
            f"n{i:02d}", labels={jconsts.SLICE_ID_LABEL_KEYS[0]: f"s{i // 4}"}
        )
    policy = _policy()
    cluster.create({
        "apiVersion": "tpu.google.com/v1", "kind": "TpuUpgradePolicy",
        "metadata": {"name": POLICY, "namespace": NAMESPACE},
        "spec": policy.to_dict(),
    })
    fleet.publish_new_revision("rev2")
    manager = JManager(cluster, decision_event_sink=jevents.ClusterDecisionEventSink(cluster))
    try:
        for _ in range(4):
            manager.apply_state(manager.build_state(NAMESPACE, DRIVER_LABELS), policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
    finally:
        manager.shutdown()
    dump = cluster.to_dict()
    traces = {"traces": jtracing.default_tracer().traces()}
    paths = {}
    for name, tree in (("jax", dump), ("port", to_port_vocab(dump)),
                       ("jax-traces", traces), ("port-traces", to_port_vocab(traces))):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(tree))
    return paths


def test_the_dump_is_mid_rollout(dumps, capsys, frozen_clock):
    """The cases below compare something: the port's status counts nodes
    in flight and waiting, and the event stream is not empty."""
    rc, out = _run(cli.main, ["status", "--json", "--state-file", str(dumps["port"])], capsys)
    status = json.loads(out)
    assert rc == 0 and status["totalNodes"] == 12 and status["inProgress"] and status["pending"]
    rc, out = _run(cli.main, ["events", "--json", "--state-file", str(dumps["port"])], capsys)
    assert rc == 0 and json.loads(out)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out


CASES = {
    "status": ["status", "--json"],
    "status-policy": ["status", "--json", "--policy", POLICY],
    "plan": ["plan", "--json", "--policy", POLICY],
    "history": ["history", "--json"],
    "history-node": ["history", "--json", "--node", "n00"],
    "explain": ["explain", "--json", "--node", "n00"],
    "events": ["events", "--json"],
    "slo": ["slo", "--json", "--policy", POLICY],
    "remediation": ["remediation", "--json", "--policy", POLICY],
    "pacing": ["pacing", "--json", "--policy", POLICY],
    "repair-dry-run": ["repair", "--json"],
}


@pytest.fixture()
def frozen_clock(monkeypatch):
    """Both CLIs read one wall clock: their reports stamp it."""
    import time

    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_only_subcommands_match_the_jax_cli(case, dumps, capsys, frozen_clock):
    argv = CASES[case]
    jrc, jout = _run(jcli.main, argv + ["--state-file", str(dumps["jax"])], capsys)
    rc, out = _run(cli.main, argv + ["--state-file", str(dumps["port"])], capsys)
    assert rc == jrc
    if jout.strip():
        assert json.loads(out) == to_port_vocab(json.loads(jout))
    else:
        assert out == jout


@pytest.mark.parametrize("fmt", ["json", "chrome", "otlp"])
def test_traces_file_matches_the_jax_cli(fmt, dumps, capsys):
    argv = ["traces", "--json"] if fmt == "json" else ["traces", "--fmt", fmt]
    jrc, jout = _run(jcli.main, argv + ["--file", str(dumps["jax-traces"])], capsys)
    rc, out = _run(cli.main, argv + ["--file", str(dumps["port-traces"])], capsys)
    assert rc == jrc == 0
    # OTLP's instrumentation scope is the tracing module's own name
    jout = jout.replace('"k8s_operator_libs_tpu.obs.tracing"',
                        '"k8s_operator_libs_tpu_torch.obs.tracing"')
    assert json.loads(out) == to_port_vocab(json.loads(jout))
    assert json.loads(out)  # the rollout left traces to render


ERROR_CASES = {
    "missing-state-file": ["status", "--state-file", "{tmp}/absent.json"],
    "no-source": ["status"],
    "two-sources": ["status", "--state-file", "{dump}", "--in-cluster"],
    "unknown-policy": ["status", "--state-file", "{dump}", "--policy", "nope"],
    "plan-unknown-policy": ["plan", "--state-file", "{dump}", "--policy", "nope"],
    "unknown-node": ["history", "--state-file", "{dump}", "--node", "nope"],
    "watch-state-file": ["status", "--state-file", "{dump}", "--watch"],
    "traces-no-file": ["traces"],
    "traces-missing-file": ["traces", "--file", "{tmp}/absent.json"],
    "bad-fleet": ["chaos", "--fleet", "0"],
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_paths_match_the_jax_cli(case, dumps, tmp_path, capsys):
    """The exit code and what is said, on both sides, for the edges
    ``tests/test_cli_edges.py`` and the subcommands guard."""
    said = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        argv = [a.format(tmp=tmp_path, dump=dumps[side]) for a in ERROR_CASES[case]]
        rc = main(argv)
        out = capsys.readouterr()
        said[side] = (rc, (out.out + out.err).replace(str(dumps[side]), "DUMP"))
    assert said["port"] == to_port_vocab(said["jax"])


def test_chaos_silences_the_ports_own_log_records():
    """The CLI quiets the port's package logger (``k8s_operator_libs_tpu_torch``,
    not the JAX package's name, which is no parent of the port's loggers):
    the operator-crash scenario's absorbed crashes, logged with their
    tracebacks under ``--verbose``, leave stderr empty without it."""
    argv = [sys.executable, "-m", "k8s_operator_libs_tpu_torch", "chaos",
            "--scenario", "operator-crash", "--transport", "inmem", "--driver", "polling",
            "--json"]
    quiet = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=120)
    loud = subprocess.run(argv + ["--verbose"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert quiet.returncode == loud.returncode == 0, (quiet.stderr, loud.stderr)
    assert json.loads(quiet.stdout)["cells_passed"] == json.loads(quiet.stdout)["cells_total"]
    assert "k8s_operator_libs_tpu_torch/upgrade/chaos.py" in loud.stderr
    assert quiet.stderr == ""
