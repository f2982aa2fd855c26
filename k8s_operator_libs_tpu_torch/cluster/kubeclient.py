"""A minimal Kubernetes API client for Nodes, over ``urllib``.

What the drain worker of a multi-process job needs to reach its node:
``get("Node", name)`` is ``GET /api/v1/nodes/{name}`` and
``patch("Node", name, body)`` is a ``PATCH`` with
``application/merge-patch+json``, as the JAX package's ``KubeApiClient``
sends them.  A 404 raises :class:`~.inmem.NotFoundError`.  Nodes only: no
watch, no retry, no authentication.

:class:`NodeStoreServer` serves the same two calls from an
:class:`~.inmem.InMemoryNodeStore` on a local port, so that a job's
workers can be pointed at a node without an apiserver.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict
from urllib.parse import quote, unquote

from .inmem import InMemoryNodeStore, NotFoundError

JsonObj = Dict[str, Any]
_NODES = "/api/v1/nodes/"


def _check_kind(kind: str) -> None:
    if kind != "Node":
        raise ValueError(f"this client reaches Nodes, not {kind!r}")


class KubeApiClient:
    """``get`` and ``patch`` of Nodes at *server* (``http://host:port``)."""

    def __init__(self, server: str, timeout: float = 10.0) -> None:
        self.server = server.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, name: str, body=None, content_type=None) -> JsonObj:
        req = urllib.request.Request(
            self.server + _NODES + quote(name),
            data=None if body is None else json.dumps(body).encode(),
            method=method,
            headers={"Accept": "application/json"},
        )
        if content_type is not None:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as err:
            if err.code == 404:
                raise NotFoundError(name) from err
            raise

    def get(self, kind: str, name: str) -> JsonObj:
        _check_kind(kind)
        obj = self._request("GET", name)
        obj.setdefault("kind", kind)
        return obj

    def patch(self, kind: str, name: str, patch_body: JsonObj) -> JsonObj:
        """PATCH with JSON merge-patch (RFC 7386) semantics."""
        _check_kind(kind)
        return self._request("PATCH", name, patch_body, "application/merge-patch+json")


class _NodeHandler(BaseHTTPRequestHandler):
    store: InMemoryNodeStore  # set on the per-server subclass

    def _name(self):
        if not self.path.startswith(_NODES):
            return None
        return unquote(self.path[len(_NODES):].split("?", 1)[0])

    def _reply(self, code: int, obj: JsonObj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _serve(self, call) -> None:
        name = self._name()
        if not name:
            self._reply(404, {"kind": "Status", "code": 404, "reason": "NotFound"})
            return
        try:
            self._reply(200, call(name))
        except NotFoundError:
            self._reply(404, {"kind": "Status", "code": 404, "reason": "NotFound"})

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        self._serve(lambda name: self.store.get("Node", name))

    def do_PATCH(self) -> None:  # noqa: N802
        if self.headers.get("Content-Type") != "application/merge-patch+json":
            self._reply(415, {"kind": "Status", "code": 415, "reason": "UnsupportedMediaType"})
            return
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
        self._serve(lambda name: self.store.patch("Node", name, body))

    def log_message(self, *args) -> None:  # quiet: the callers log
        pass


class NodeStoreServer:
    """Serve *store*'s Nodes at ``self.url`` (127.0.0.1, a free port) to
    :class:`KubeApiClient`, from a daemon thread, until :meth:`stop`.
    Usable as a context manager."""

    def __init__(self, store: InMemoryNodeStore) -> None:
        handler = type("NodeHandler", (_NodeHandler,), {"store": store})
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    def __enter__(self) -> "NodeStoreServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
