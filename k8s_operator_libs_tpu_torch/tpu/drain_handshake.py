"""Checkpoint-on-drain handshake: both sides.

The port of :class:`CheckpointDrainGate` and :class:`DrainSignalWatcher`
from ``k8s_operator_libs_tpu/tpu/drain_handshake.py``.  The orchestrator sets
the node annotation ``nvidia.com/<component>-pre-drain-checkpoint`` to
``requested:<token>`` before it drains; the trainer, polling between
steps, saves a checkpoint and answers ``done:<token>``, echoing the token
so that the orchestrator can reject an acknowledgement left over from an
earlier cycle.

The save and the acknowledgement run under a ``checkpoint-drain`` span
(:mod:`..obs.tracing`), parented by the W3C traceparent that the
orchestrator writes beside the request
(``nvidia.com/<component>-pre-drain-traceparent``) from its own
``drain-handshake`` span: the cross-process leg of the reconcile trace.
A missing or malformed traceparent starts a new root.

The orchestrator side, :class:`CheckpointDrainGate`, lives beside the
watcher: the drain manager (:mod:`..upgrade.drain_manager`) runs it after
cordon and before eviction.  It writes the request with a per-cycle token
and the traceparent of its own ``drain-handshake`` span, polls for
``done:<token>``, fails open into eviction on timeout (the checkpoint is
an optimisation, not a correctness gate, as kubectl drain's own timeout
fails open), and clears both annotations.

Both sides take any client with ``get("Node", name)`` and
``patch("Node", name, merge_patch)``: the port's
:class:`~..cluster.inmem.InMemoryCluster` or
:class:`~..cluster.kubeclient.KubeApiClient`.  The watcher also takes an
orchestrator's own cluster client; the gate, a copy of the JAX
package's class, knows a node is gone by the port's ``NotFoundError``.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Callable, Optional

from ..api.upgrade_spec import PreDrainCheckpointSpec
from ..cluster.client import ClusterClient
from ..cluster.errors import NotFoundError
from ..cluster.inmem import JsonObj
from ..cluster.objects import get_annotation, name_of
from ..obs import tracing
from ..upgrade import consts, util

logger = logging.getLogger(__name__)

DEFAULT_POLL_SECONDS = 0.05


def _is_not_found(err: Exception) -> bool:
    """True for a client's missing-object error.  Clients name it
    ``NotFoundError`` (the port's cluster and any orchestrator's
    cluster clients alike); matching the name lets the watcher take
    another package's client."""
    return any(cls.__name__ == "NotFoundError" for cls in type(err).__mro__)


class CheckpointDrainGate:
    """Orchestrator side — plugs into :class:`~..upgrade.drain_manager.
    DrainManager` as its ``pre_drain_gate`` (runs after cordon, before
    eviction)."""

    def __init__(
        self,
        cluster: ClusterClient,
        spec: Optional[PreDrainCheckpointSpec] = None,
        poll_seconds: float = DEFAULT_POLL_SECONDS,
    ) -> None:
        self._cluster = cluster
        self.spec = spec or PreDrainCheckpointSpec()
        self._poll = poll_seconds

    def wait_for_checkpoint(self, node: JsonObj) -> None:
        if not self.spec.enable:
            return
        name = name_of(node)
        key = util.get_pre_drain_checkpoint_annotation_key()
        tp_key = util.get_pre_drain_traceparent_annotation_key()
        # Per-cycle token: the ack must echo it, so a laggard "done" from a
        # previous timed-out cycle can never satisfy this cycle's gate.
        token = uuid.uuid4().hex[:12]
        requested = f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}"
        expected_ack = f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}"
        with tracing.start_span(
            "drain-handshake", attributes={"node": name}
        ) as span:
            # The handshake payload carries the span's W3C traceparent so
            # the workload side (another process, another tracer) parents
            # its checkpoint-drain span under THIS wait.
            self._cluster.patch(
                "Node",
                name,
                {
                    "metadata": {
                        "annotations": {
                            key: requested,
                            tp_key: span.traceparent,
                        }
                    }
                },
            )
            deadline = (
                time.monotonic() + self.spec.timeout_second
                if self.spec.timeout_second > 0
                else None
            )
            while True:
                try:
                    current = self._cluster.get("Node", name)
                except NotFoundError:
                    span.set_attribute("result", "node-gone")
                    return
                if get_annotation(current, key) == expected_ack:
                    logger.info(
                        "node %s checkpoint acknowledged before drain", name
                    )
                    span.set_attribute("result", "acknowledged")
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    logger.warning(
                        "node %s checkpoint wait timed out after %ss; "
                        "draining anyway",
                        name,
                        self.spec.timeout_second,
                    )
                    span.set_attribute("result", "timeout")
                    break
                time.sleep(self._poll)
            # Clear the handshake so the next upgrade cycle starts fresh.
            self._cluster.patch(
                "Node",
                name,
                {"metadata": {"annotations": {key: None, tp_key: None}}},
            )


class DrainSignalWatcher:
    """Workload side — polled by the trainer between training steps.

    :meth:`check_and_acknowledge` is the one-call integration point:
    returns True (after running ``on_checkpoint`` and acknowledging)
    when a checkpoint was requested.  *read_annotation* and
    *read_traceparent* replace the client reads (e.g. downward-API file
    readers)."""

    def __init__(
        self,
        cluster,
        node_name: str,
        read_annotation: Optional[Callable[[], str]] = None,
        read_traceparent: Optional[Callable[[], str]] = None,
    ) -> None:
        self._cluster = cluster
        self.node_name = node_name
        self._key = util.get_pre_drain_checkpoint_annotation_key()
        self._tp_key = util.get_pre_drain_traceparent_annotation_key()
        self._read = read_annotation or self._read_from_cluster
        self._read_tp = read_traceparent or self._read_traceparent_from_cluster

    def _read_node_annotation(self, key: str) -> str:
        if self._cluster is None:
            return ""
        try:
            node = self._cluster.get("Node", self.node_name)
        except Exception as err:
            if _is_not_found(err):
                return ""
            raise
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        return annotations.get(key, "")

    def _read_from_cluster(self) -> str:
        return self._read_node_annotation(self._key)

    def _read_traceparent_from_cluster(self) -> str:
        return self._read_node_annotation(self._tp_key)

    def checkpoint_requested(self) -> bool:
        value = self._read()
        return value.split(":", 1)[0] == consts.PRE_DRAIN_CHECKPOINT_REQUESTED

    def acknowledge(self) -> None:
        """Report checkpoint-saved back to the orchestrator, echoing the
        request's per-cycle token (if any)."""
        parts = self._read().split(":", 1)
        ack = consts.PRE_DRAIN_CHECKPOINT_DONE
        if len(parts) == 2 and parts[0] == consts.PRE_DRAIN_CHECKPOINT_REQUESTED:
            ack = f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{parts[1]}"
        self._cluster.patch(
            "Node",
            self.node_name,
            {"metadata": {"annotations": {self._key: ack}}},
        )

    def check_and_acknowledge(self, on_checkpoint: Callable[[], None]) -> bool:
        """If a checkpoint was requested: run ``on_checkpoint`` (the
        trainer's save), acknowledge, and return True.  Both run under a
        ``checkpoint-drain`` span parented by the traceparent the gate
        wrote next to the request."""
        if not self.checkpoint_requested():
            return False
        traceparent = self._read_tp() or None
        with tracing.start_span(
            "checkpoint-drain",
            attributes={"node": self.node_name},
            traceparent=traceparent,
        ):
            on_checkpoint()
            self.acknowledge()
        return True
