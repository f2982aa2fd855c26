"""HTTPS and mTLS on the port: its facade serving TLS and its client's
certificate paths.

* every class of ``tests/test_tls.py``, as cases of the same names, run
  on the port's facade and client (certificates made in-test with the
  ``cryptography`` package);
* across packages: the port's client reads the JAX package's TLS facade,
  and the JAX package's client the port's, with the same answers.
"""

from __future__ import annotations





import ssl


import pytest


pytest.importorskip(
    "cryptography", reason="in-test PKI needs the cryptography package"
)


from k8s_operator_libs_tpu_torch.cluster import (
    ApiServerFacade,
    InMemoryCluster,
    KubeApiClient,
    KubeConfig,
)


from k8s_operator_libs_tpu_torch.cluster.objects import make_node


from test_torch_vocab import close_every_client, port_globals  # noqa: F401
from pki import server_context as _server_ctx_impl, write_pki


pytestmark = pytest.mark.usefixtures("port_globals", "close_every_client")


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """CA + server cert (SAN 127.0.0.1) + client cert, as PEM files."""
    return write_pki(tmp_path_factory.mktemp("pki"))


def _server_ctx(pki, require_client_cert=False) -> ssl.SSLContext:
    return _server_ctx_impl(pki, require_client_cert)


class TestHttpsContract:
    def test_crud_over_verified_tls(self, pki):
        store = InMemoryCluster()
        with ApiServerFacade(store, ssl_context=_server_ctx(pki)) as facade:
            assert facade.url.startswith("https://")
            client = KubeApiClient(
                KubeConfig(server=facade.url, ca_file=pki["ca.pem"]),
                timeout=10.0,
            )
            client.create(make_node("n1"))
            assert client.get("Node", "n1")["metadata"]["name"] == "n1"
            client.patch(
                "Node", "n1", {"metadata": {"labels": {"a": "1"}}}
            )
            assert client.get("Node", "n1")["metadata"]["labels"] == {
                "a": "1"
            }

    def test_unverified_server_rejected(self, pki):
        store = InMemoryCluster()
        with ApiServerFacade(store, ssl_context=_server_ctx(pki)) as facade:
            # no ca_file: the default trust store does not know test-ca
            client = KubeApiClient(
                KubeConfig(server=facade.url), timeout=10.0
            )
            with pytest.raises((ssl.SSLError, OSError)):
                client.list("Node")

    def test_insecure_skip_tls_verify(self, pki):
        store = InMemoryCluster()
        with ApiServerFacade(store, ssl_context=_server_ctx(pki)) as facade:
            client = KubeApiClient(
                KubeConfig(server=facade.url, insecure_skip_tls_verify=True),
                timeout=10.0,
            )
            client.create(make_node("n1"))
            assert client.exists("Node", "n1")

    def test_mtls_client_certificate(self, pki):
        store = InMemoryCluster()
        ctx = _server_ctx(pki, require_client_cert=True)
        with ApiServerFacade(store, ssl_context=ctx) as facade:
            with_cert = KubeApiClient(
                KubeConfig(
                    server=facade.url,
                    ca_file=pki["ca.pem"],
                    client_cert_file=pki["client.pem"],
                    client_key_file=pki["client.key"],
                ),
                timeout=10.0,
            )
            with_cert.create(make_node("n1"))
            assert with_cert.exists("Node", "n1")
            without = KubeApiClient(
                KubeConfig(server=facade.url, ca_file=pki["ca.pem"]),
                timeout=10.0,
            )
            with pytest.raises((ssl.SSLError, OSError)):
                without.list("Node")

    def test_held_stream_over_tls(self, pki):
        store = InMemoryCluster()
        with ApiServerFacade(store, ssl_context=_server_ctx(pki)) as facade:
            client = KubeApiClient(
                KubeConfig(server=facade.url, ca_file=pki["ca.pem"]),
                timeout=10.0,
            )
            client.start_held_watches(("Node",), hold_seconds=2.0)
            try:
                store.create(make_node("n-tls"))
                assert client.wait_for_held_event(timeout=10.0)
                events = client.events_since(0, kind=("Node",))
                assert any(
                    (e.new or {}).get("metadata", {}).get("name") == "n-tls"
                    for e in events
                )
            finally:
                client.stop_held_watches()


class TestExecIssuedClientCert:
    """GKE-style auth: the exec plugin issues a CLIENT CERTIFICATE pair
    (not a token) and the client must build its TLS context from it —
    the `cred.client_cert_file` branch of _build_ssl_context plus the
    generation-tracked context rebuild."""

    def test_mtls_via_exec_plugin(self, pki, tmp_path):
        import json as _json
        from pathlib import Path as _Path

        from test_execauth import (
            API_VERSION,
            exec_kubeconfig,
            write_plugin,
        )

        script, cred_file, calls_file = write_plugin(tmp_path)
        cred_file.write_text(
            _json.dumps(
                {
                    "apiVersion": API_VERSION,
                    "kind": "ExecCredential",
                    "status": {
                        "clientCertificateData": _Path(
                            pki["client.pem"]
                        ).read_text(),
                        "clientKeyData": _Path(
                            pki["client.key"]
                        ).read_text(),
                    },
                }
            )
        )
        store = InMemoryCluster()
        ctx = _server_ctx(pki, require_client_cert=True)
        with ApiServerFacade(store, ssl_context=ctx) as facade:
            kubeconfig = exec_kubeconfig(tmp_path, script, facade.url)
            # the exec kubeconfig carries no CA — point the cluster
            # entry at the test CA so server verification passes
            import yaml as _yaml

            kc_path = _Path(kubeconfig)
            cfg = _yaml.safe_load(kc_path.read_text())
            cfg["clusters"][0]["cluster"]["certificate-authority"] = pki[
                "ca.pem"
            ]
            kc_path.write_text(_yaml.safe_dump(cfg))
            client = KubeApiClient(KubeConfig.load(kubeconfig), timeout=10.0)
            client.create(make_node("n-exec-mtls"))
            assert client.exists("Node", "n-exec-mtls")


class TestHandshakeIsolation:
    """Review regression: the TLS handshake must run in the per-
    connection handler thread — wrapping the LISTENING socket put it on
    the single accept thread, where one peer that never sends a
    ClientHello wedged the whole facade."""

    def test_stalled_peer_does_not_block_other_clients(self, pki):
        import socket
        import time as _time

        store = InMemoryCluster()
        with ApiServerFacade(store, ssl_context=_server_ctx(pki)) as facade:
            port = int(facade.url.rsplit(":", 1)[1])
            # open a TCP connection and go silent mid-handshake
            stalled = socket.create_connection(("127.0.0.1", port))
            try:
                client = KubeApiClient(
                    KubeConfig(server=facade.url, ca_file=pki["ca.pem"]),
                    timeout=8.0,
                )
                t0 = _time.monotonic()
                client.create(make_node("n1"))
                assert client.exists("Node", "n1")
                # well under the stalled peer's handshake deadline:
                # proof the handshakes are not serialized
                assert _time.monotonic() - t0 < 5.0
            finally:
                stalled.close()


@pytest.mark.parametrize("direction", ["port-client-jax-facade", "jax-client-port-facade"])
def test_each_client_reads_the_other_packages_tls_facade(pki, direction):
    from k8s_operator_libs_tpu.cluster import ApiServerFacade as JaxFacade
    from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxCluster
    from k8s_operator_libs_tpu.cluster import KubeApiClient as JaxClient
    from k8s_operator_libs_tpu.cluster import KubeConfig as JaxConfig
    from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node

    if direction == "port-client-jax-facade":
        store, node, facade_cls, client_cls, config_cls = JaxCluster(), jax_make_node, JaxFacade, KubeApiClient, KubeConfig
    else:
        store, node, facade_cls, client_cls, config_cls = InMemoryCluster(), make_node, ApiServerFacade, JaxClient, JaxConfig
    for i in range(3):
        store.create(node(f"n{i}", labels={"rack": str(i % 2)}))
    facade = facade_cls(store, ssl_context=_server_ctx(pki)).start()
    try:
        assert facade.url.startswith("https://")
        client = client_cls(config_cls(server=facade.url, ca_file=pki["ca.pem"]), timeout=10.0)
        names = [n["metadata"]["name"] for n in client.list("Node", label_selector="rack=1")]
        assert names == ["n1"]
        client.patch("Node", "n0", {"metadata": {"labels": {"x": "1"}}})
        assert store.get("Node", "n0")["metadata"]["labels"]["x"] == "1"
        assert client.get("Node", "n2")["metadata"]["name"] == "n2"
    finally:
        facade.stop()
