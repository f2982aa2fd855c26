"""End-to-end drive of the port's operator,
``k8s_operator_libs_tpu_torch/examples/operator.py`` `run_real` — the deployed
operator's exact code path (KubeApiClient from a kubeconfig file, held
watch streams, externally-fed informer cache with cache-backed manager
reads, CrPolicySource) — against the HTTP facade, and against the TLS
facade (a real operator never talks plain HTTP to an apiserver).

Regression anchor for the single-reflector rule: the controller's
watch loop is the ONE journal consumer and tees frames into the cache;
a cache refreshing itself next to the controller split the pop-once
stream and wedged cache-visibility waits (caught by exactly this
drive).

Both tests of ``tests/test_operator_example_e2e.py``, as cases of the same
names: the port's operator runs as ``python -m
k8s_operator_libs_tpu_torch.examples.operator`` in a subprocess, over
HTTP and over TLS, and must import nothing of JAX or the JAX package."""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import yaml

from k8s_operator_libs_tpu_torch.cluster import (
    ApiServerFacade,
    InMemoryCluster,
    KubeApiClient,
    KubeConfig,
)
from k8s_operator_libs_tpu_torch.upgrade import consts

from test_torch_harness import NAMESPACE, Fleet
from test_torch_vocab import close_every_client, port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals", "close_every_client")

REPO = Path(__file__).resolve().parent.parent


def _write_kubeconfig(server: str, path: Path, ca_file: str = "") -> None:
    cluster = {"server": server}
    if ca_file:
        cluster["certificate-authority"] = ca_file
    path.write_text(
        yaml.safe_dump(
            {
                "apiVersion": "v1",
                "kind": "Config",
                "clusters": [{"name": "c", "cluster": cluster}],
                "users": [{"name": "u", "user": {}}],
                "contexts": [
                    {
                        "name": "ctx",
                        "context": {"cluster": "c", "user": "u"},
                    }
                ],
                "current-context": "ctx",
            }
        )
    )


def _drive_operator(facade, client, kcpath: Path, label: str) -> None:
    """Create the policy CR + 3-node fleet, run examples/operator.py as
    a SUBPROCESS against *kcpath*, and require convergence to
    upgrade-done — the shared rollout drive for every transport."""
    proc = None
    try:
        client.create(
            {
                "apiVersion": "nvidia.com/v1alpha1",
                "kind": "GpuUpgradePolicy",
                "metadata": {
                    "name": "fleet-policy",
                    "namespace": NAMESPACE,
                },
                "spec": {
                    "autoUpgrade": True,
                    "maxParallelUpgrades": 0,
                    "maxUnavailable": "100%",
                    "drain": {
                        "enable": True,
                        "force": True,
                        "timeoutSeconds": 60,
                    },
                },
            }
        )
        fleet = Fleet(client)
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")

        proc = subprocess.Popen(
            [
                sys.executable,
                "-X", "importtime",
                "-m", "k8s_operator_libs_tpu_torch.examples.operator",
                "--kubeconfig", str(kcpath),
                "--namespace", NAMESPACE,
                "--run-seconds", "60",
                "--qps", "0",
            ],
            cwd=str(REPO),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        deadline = time.monotonic() + 60
        done = False
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break  # operator died — fail below with its output
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {
                consts.UPGRADE_STATE_DONE
            }:
                done = True
                break
            time.sleep(0.1)
        proc.terminate()
        out, _ = proc.communicate(timeout=20)
        assert done, (
            f"fleet never converged over {label}: {fleet.states()}\n"
            f"operator output tail:\n{out[-2000:]}"
        )
        # -X importtime lists every module the operator imported
        imported = {line.split("|")[-1].strip() for line in out.splitlines() if line.startswith("import time:")}
        assert "k8s_operator_libs_tpu_torch.controller.upgrade_reconciler" in imported
        assert not [m for m in imported if m.split(".")[0] in ("jax", "k8s_operator_libs_tpu")]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()


def test_operator_example_rolls_fleet_over_http():
    store = InMemoryCluster()
    facade = ApiServerFacade(store).start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kcpath = Path(tmp) / "kubeconfig.yaml"
            _write_kubeconfig(facade.url, kcpath)
            client = KubeApiClient(KubeConfig(server=facade.url))
            _drive_operator(facade, client, kcpath, "http")
    finally:
        facade.stop()


def test_operator_example_rolls_fleet_over_tls():
    """The deployed shape exactly: the operator SUBPROCESS loads a
    kubeconfig whose cluster entry carries a certificate-authority,
    builds its TLS context, and drives the rollout over HTTPS held
    streams."""
    pytest.importorskip("cryptography")

    from pki import server_context, write_pki

    store = InMemoryCluster()
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_pki(tmp)
        facade = ApiServerFacade(
            store, ssl_context=server_context(paths)
        ).start()
        try:
            kcpath = Path(tmp) / "kubeconfig.yaml"
            _write_kubeconfig(facade.url, kcpath, ca_file=paths["ca.pem"])
            client = KubeApiClient(
                KubeConfig(server=facade.url, ca_file=paths["ca.pem"])
            )
            _drive_operator(facade, client, kcpath, "tls")
        finally:
            facade.stop()
