"""Two-operator shared-requestor e2e over the HTTP facade.

The shared-requestor protocol
(reference upgrade_requestor.go:320-368 — create-or-append with an
optimistic-locked patch, delete-or-remove-self on finish) exercised by
TWO COMPLETE OPERATORS in SEPARATE PROCESSES, each with its own
component name, client, and controller runtime, racing over the same
nodes' NodeMaintenance CRs through real localhost HTTP.  The test
process plays kubelet/DaemonSet-controller and the external maintenance
operator, and records CR membership snapshots to prove sharing (and the
Conflict-retried append) actually happened.

The port's copy of ``tests/test_shared_requestor_e2e.py``: both operators
are the port's (``tests/test_torch_requestor_runner.py``), in its
GPU-fleet vocabulary.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import pytest

from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade, InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import (
    make_controller_revision,
    make_daemonset,
    make_node,
    make_pod,
)
from k8s_operator_libs_tpu_torch.upgrade import consts

from test_torch_harness import FakeMaintenanceOperator
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

NAMESPACE = "tpu-ops"
COMPONENTS = ("gpu-driver-a", "gpu-driver-b")
NODES = ("n0", "n1", "n2")
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RUNNER = os.path.join(os.path.dirname(__file__), "test_torch_requestor_runner.py")


class ComponentFleet:
    """One component's DaemonSet + pods across the shared nodes."""

    def __init__(self, store, component, node_names):
        self.store = store
        self.component = component
        self.revision_hash = "rev1"
        self.ds = store.create(
            make_daemonset(component, NAMESPACE, {"app": component})
        )
        store.create(make_controller_revision(self.ds, 1, "rev1"))
        self._seq = 0
        for node in node_names:
            self._make_pod(node)
        ds = store.get("DaemonSet", component, NAMESPACE)
        ds["status"]["desiredNumberScheduled"] = len(node_names)
        self.ds = store.update(ds)

    def _make_pod(self, node):
        self.store.create(
            make_pod(
                f"{self.component}-{self._seq}",
                NAMESPACE,
                node,
                labels={"app": self.component},
                owner=self.ds,
                revision_hash=self.revision_hash,
            )
        )
        self._seq += 1

    def publish_new_revision(self, revision_hash):
        self.revision_hash = revision_hash
        self.store.create(
            make_controller_revision(self.ds, 2, revision_hash)
        )

    def reconcile(self):
        """Recreate missing driver pods at the newest revision."""
        pods = self.store.list(
            "Pod", namespace=NAMESPACE, label_selector=f"app={self.component}"
        )
        covered = {(p.get("spec") or {}).get("nodeName") for p in pods}
        for node in NODES:
            if node not in covered:
                self._make_pod(node)

    def states(self):
        key = consts.UPGRADE_STATE_LABEL_KEY_FMT % self.component
        return {
            n["metadata"]["name"]: (
                (n["metadata"].get("labels") or {}).get(key, "")
            )
            for n in self.store.list("Node")
        }


def test_two_operator_shared_requestor_rollout():
    store = InMemoryCluster()
    for node in NODES:
        store.create(make_node(node))
    fleets = [ComponentFleet(store, comp, NODES) for comp in COMPONENTS]
    for fleet in fleets:
        fleet.publish_new_revision("rev2")
    # Real maintenance takes time: holding CRs open ~1 s guarantees the
    # two operators' handoff windows overlap, forcing the append path.
    mop = FakeMaintenanceOperator(store, ready_delay_seconds=1.0)

    #: Every NodeMaintenance write, recorded synchronously at the store:
    #: (requestorID, tuple(additionalRequestors)).
    sharing_seen = []
    record_lock = threading.Lock()

    def _record(obj):
        if isinstance(obj, dict) and obj.get("kind") == "NodeMaintenance":
            spec = obj.get("spec") or {}
            with record_lock:
                sharing_seen.append(
                    (
                        spec.get("requestorID", ""),
                        tuple(spec.get("additionalRequestors") or ()),
                    )
                )
        return obj

    for verb in ("create", "update", "patch"):
        original = getattr(store, verb)

        def wrapper(*a, _original=original, **kw):
            return _record(_original(*a, **kw))

        setattr(store, verb, wrapper)

    stop = threading.Event()

    def background_controllers():
        while not stop.is_set():
            for fleet in fleets:
                fleet.reconcile()
            mop.reconcile()
            time.sleep(0.02)

    thread = threading.Thread(target=background_controllers, daemon=True)
    with ApiServerFacade(store) as facade:
        thread.start()
        procs = []
        try:
            for comp in COMPONENTS:
                env = dict(os.environ)
                env["PYTHONPATH"] = REPO_ROOT
                procs.append(
                    subprocess.Popen(
                        [
                            sys.executable,
                            RUNNER,
                            "--server",
                            facade.url,
                            "--component",
                            comp,
                            "--requestor-id",
                            f"{comp}-operator",
                            "--namespace",
                            NAMESPACE,
                            "--timeout",
                            "90",
                        ],
                        env=env,
                        stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT,
                        text=True,
                    )
                )
            outputs = []
            for proc in procs:
                out, _ = proc.communicate(timeout=120)
                outputs.append(out)
            assert all(p.returncode == 0 for p in procs), (
                "operator subprocess failed:\n" + "\n---\n".join(outputs)
            )
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            stop.set()
            thread.join(2.0)
    assert not thread.is_alive()

    # both components' rollouts converged on every node
    for fleet in fleets:
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}, (
            fleet.component,
            fleet.states(),
        )
    # the CRs were genuinely SHARED: some snapshot shows one operator as
    # owner and the other appended via the optimistic-locked
    # additionalRequestors patch (upgrade_requestor.go:320-368)
    requestor_ids = {f"{comp}-operator" for comp in COMPONENTS}
    shared = [
        (owner, extra)
        for owner, extra in sharing_seen
        if owner in requestor_ids and set(extra) & requestor_ids
    ]
    assert shared, (
        "no NodeMaintenance CR was ever shared between the two operators; "
        f"snapshots={set(sharing_seen)}"
    )
    # and the maintenance handoff fully unwound: no CRs remain
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        mop.reconcile()
        if not store.list("NodeMaintenance"):
            break
        time.sleep(0.05)
    assert store.list("NodeMaintenance") == []
