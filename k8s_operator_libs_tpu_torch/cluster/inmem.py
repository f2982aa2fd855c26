"""A minimal in-memory node store: node JSON objects by name, with a JSON
merge patch (RFC 7386) in which ``None`` deletes a key.

It offers what :class:`~..tpu.drain_handshake.DrainSignalWatcher` asks of
a client, ``get("Node", name)`` and ``patch("Node", name, merge_patch)``,
so that the port can run the drain handshake without the JAX package's
``InMemoryCluster``.  Nodes only: it is no apiserver.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict

JsonObj = Dict[str, Any]


class NotFoundError(KeyError):
    """The named node does not exist."""


def merge_patch(target: JsonObj, patch: JsonObj) -> JsonObj:
    """RFC 7386 JSON merge patch: dicts merge recursively, ``None``
    deletes.  Returns a new object; neither argument is changed."""
    out = dict(target)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        elif isinstance(value, dict):
            prev = out.get(key)
            out[key] = merge_patch(prev if isinstance(prev, dict) else {}, value)
        else:
            out[key] = copy.deepcopy(value)
    return out


class InMemoryNodeStore:
    """Nodes by name.  Thread-safe: the orchestrator side and the trainer
    may patch the same node from different threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: Dict[str, JsonObj] = {}

    @staticmethod
    def _check_kind(kind: str) -> None:
        if kind != "Node":
            raise ValueError(f"the node store holds Nodes, not {kind!r}")

    def create(self, node: JsonObj) -> JsonObj:
        self._check_kind(node.get("kind", "Node"))
        name = node["metadata"]["name"]
        with self._lock:
            if name in self._nodes:
                raise ValueError(f"node {name!r} already exists")
            self._nodes[name] = copy.deepcopy({"kind": "Node", **node})
            return copy.deepcopy(self._nodes[name])

    def get(self, kind: str, name: str) -> JsonObj:
        self._check_kind(kind)
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(name)
            return copy.deepcopy(self._nodes[name])

    def patch(self, kind: str, name: str, patch_body: JsonObj) -> JsonObj:
        self._check_kind(kind)
        with self._lock:
            if name not in self._nodes:
                raise NotFoundError(name)
            self._nodes[name] = merge_patch(self._nodes[name], patch_body)
            return copy.deepcopy(self._nodes[name])


def make_node(name: str) -> JsonObj:
    """A bare node object named *name*."""
    return {"kind": "Node", "metadata": {"name": name, "annotations": {}}}
