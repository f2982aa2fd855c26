"""Concurrency primitives, key builders and event helpers.

Reference parity: ``pkg/upgrade/util.go`` —

* ``StringSet``   (util.go:29-70)  — mutex-guarded set used to dedupe
  in-flight drains/evictions across reconcile cycles;
* ``KeyedMutex``  (util.go:72-89)  — per-key lock (returns an unlock
  closure in Go; here a context manager);
* ``SetDriverName`` (util.go:91-99) — process-global component name that
  parameterizes every label/annotation key (we call it *component name*);
* key-builder funcs (util.go:102-155);
* event-reason builder + nil-safe event emission (util.go:157-177).
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

from . import consts


# --------------------------------------------------------------------------
# Concurrency primitives (reference C14)
# --------------------------------------------------------------------------


class StringSet:
    """Thread-safe string set.

    Used by :class:`~..drain_manager.DrainManager` and
    :class:`~..pod_manager.PodManager` to deduplicate nodes that already
    have an async operation in flight (reference: util.go:29-70,
    drain_manager.go:98-137).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: set[str] = set()

    def add(self, item: str) -> None:
        with self._lock:
            self._items.add(item)

    def remove(self, item: str) -> None:
        with self._lock:
            self._items.discard(item)

    def has(self, item: str) -> bool:
        with self._lock:
            return item in self._items

    def add_if_absent(self, item: str) -> bool:
        """Atomically add *item*; return True if it was newly added.

        The Go reference checks ``Has`` then ``Add`` under the caller's
        single-reconcile-goroutine assumption; we make the test-and-set
        atomic so the scheduling API is safe under concurrent reconciles.
        """
        with self._lock:
            if item in self._items:
                return False
            self._items.add(item)
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class KeyedMutex:
    """Per-key mutual exclusion (reference: util.go:72-89).

    The reference stores ``sync.Mutex`` values in a ``sync.Map`` and returns
    an unlock closure; here :meth:`lock` is a context manager::

        with keyed.lock(node_name):
            ...patch node...
    """

    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._locks: Dict[str, threading.Lock] = {}

    def _get(self, key: str) -> threading.Lock:
        with self._guard:
            lk = self._locks.get(key)
            if lk is None:
                lk = threading.Lock()
                self._locks[key] = lk
            return lk

    @contextmanager
    def lock(self, key: str) -> Iterator[None]:
        lk = self._get(key)
        lk.acquire()
        try:
            yield
        finally:
            lk.release()

    @contextmanager
    def lock_many(self, keys) -> Iterator[None]:
        """Hold several keys' locks at once — acquired in SORTED key
        order so concurrent multi-key holders can never deadlock each
        other (and single-key holders can never close a cycle).  Used by
        the batched write dispatcher
        (:class:`~..cluster.writepipeline.WriteDispatcher`) to serialize
        a whole batch against the per-node synchronous writers."""
        ordered = sorted(set(keys))
        held = []
        try:
            for key in ordered:
                lk = self._get(key)
                lk.acquire()
                held.append(lk)
            yield
        finally:
            for lk in reversed(held):
                lk.release()


# --------------------------------------------------------------------------
# Component-name global + key builders (reference C13 half)
# --------------------------------------------------------------------------

_component_name = "gpu-driver"
_component_lock = threading.Lock()


def set_component_name(name: str) -> None:
    """Set the process-global managed-component name.

    Reference: ``SetDriverName`` (util.go:91-99) — set once by the consumer
    before any manager is constructed; parameterizes every label/annotation
    key (e.g. ``nvidia.com/<name>-upgrade-state``).
    """
    if not name:
        raise ValueError("component name must be non-empty")
    global _component_name
    with _component_lock:
        _component_name = name


def get_component_name() -> str:
    with _component_lock:
        return _component_name


def get_upgrade_state_label_key() -> str:
    """Reference: GetUpgradeStateLabelKey (util.go:102-105)."""
    return consts.UPGRADE_STATE_LABEL_KEY_FMT % get_component_name()


def get_upgrade_skip_node_label_key() -> str:
    return consts.UPGRADE_SKIP_NODE_LABEL_KEY_FMT % get_component_name()

def get_upgrade_requested_annotation_key() -> str:
    return consts.UPGRADE_REQUESTED_ANNOTATION_KEY_FMT % get_component_name()


def get_upgrade_initial_state_annotation_key() -> str:
    return consts.UPGRADE_INITIAL_STATE_ANNOTATION_KEY_FMT % get_component_name()


def get_wait_for_safe_load_annotation_key() -> str:
    return (
        consts.UPGRADE_WAIT_FOR_SAFE_LOAD_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_wait_for_pod_completion_start_time_annotation_key() -> str:
    return (
        consts.UPGRADE_WAIT_FOR_POD_COMPLETION_START_TIME_ANNOTATION_KEY_FMT
        % get_component_name()
    )


def get_validation_start_time_annotation_key() -> str:
    return (
        consts.UPGRADE_VALIDATION_START_TIME_ANNOTATION_KEY_FMT
        % get_component_name()
    )


def get_upgrade_requestor_mode_annotation_key() -> str:
    """Reference: GetUpgradeRequestorModeAnnotationKey (util.go:134-138)."""
    return consts.UPGRADE_REQUESTOR_MODE_ANNOTATION_KEY_FMT % get_component_name()


def get_pre_drain_checkpoint_annotation_key() -> str:
    """Checkpoint-on-drain handshake annotation key."""
    return consts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT % get_component_name()


def get_pre_drain_traceparent_annotation_key() -> str:
    """Trace-context carrier for the checkpoint handshake."""
    return consts.PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT % get_component_name()


def get_quarantine_annotation_key() -> str:
    """Degraded-domain quarantine annotation key."""
    return consts.UPGRADE_QUARANTINE_ANNOTATION_KEY_FMT % get_component_name()


def get_admitted_at_annotation_key() -> str:
    """Admission timestamp (pacing gate) annotation key."""
    return consts.UPGRADE_ADMITTED_AT_ANNOTATION_KEY_FMT % get_component_name()


def get_done_at_annotation_key() -> str:
    """Done timestamp (canary soak gate) annotation key."""
    return consts.UPGRADE_DONE_AT_ANNOTATION_KEY_FMT % get_component_name()


def get_admitted_bypass_annotation_key() -> str:
    """Throttle-bypass admission marker (pacing-exempt) annotation key."""
    return (
        consts.UPGRADE_ADMITTED_BYPASS_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_last_known_good_annotation_key() -> str:
    """Remediation: DaemonSet LKG-revision record annotation key."""
    return (
        consts.UPGRADE_LAST_KNOWN_GOOD_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_breaker_annotation_key() -> str:
    """Remediation: DaemonSet failure-budget breaker record key."""
    return consts.UPGRADE_BREAKER_ANNOTATION_KEY_FMT % get_component_name()


def get_attempt_count_annotation_key() -> str:
    """Remediation: per-node upgrade-attempt counter key."""
    return (
        consts.UPGRADE_ATTEMPT_COUNT_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_last_failure_at_annotation_key() -> str:
    """Remediation: open-failure-episode timestamp key."""
    return (
        consts.UPGRADE_LAST_FAILURE_AT_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_failure_target_annotation_key() -> str:
    """Remediation: revision hash the failure episode was attempted on."""
    return (
        consts.UPGRADE_FAILURE_TARGET_ANNOTATION_KEY_FMT % get_component_name()
    )


def get_federation_record_annotation_key() -> str:
    """Federation: coordinator record annotation key (audit cell DS)."""
    return (
        consts.UPGRADE_FEDERATION_RECORD_ANNOTATION_KEY_FMT
        % get_component_name()
    )


def get_timeline_annotation_key() -> str:
    """Flight recorder: per-node timeline checkpoint annotation key."""
    return consts.UPGRADE_TIMELINE_ANNOTATION_KEY_FMT % get_component_name()


def get_quarantine_taint_key() -> str:
    """Remediation: NoSchedule taint key for quarantined nodes."""
    return consts.UPGRADE_QUARANTINE_TAINT_KEY_FMT % get_component_name()


def get_event_reason() -> str:
    """Reference: GetEventReason (util.go:157-160)."""
    return "%sUpgrade" % get_component_name()


def is_node_in_requestor_mode(node) -> bool:
    """True when this node's upgrade is delegated to the external
    maintenance operator (reference: IsNodeInRequestorMode, util.go:134-138
    — tracked by a node annotation)."""
    annotations = (node.get("metadata") or {}).get("annotations") or {}
    return (
        annotations.get(get_upgrade_requestor_mode_annotation_key())
        == consts.TRUE_STRING
    )


# --------------------------------------------------------------------------
# Events (reference: util.go:162-177 — nil-safe logEvent helpers)
# --------------------------------------------------------------------------


@dataclass
class Event:
    """A recorded Kubernetes-style Event."""

    object_name: str
    event_type: str  # "Normal" | "Warning"
    reason: str
    message: str


class EventRecorder:
    """In-process stand-in for ``record.EventRecorder``.

    The reference emits real Kubernetes Events via a controller-runtime
    recorder and wraps every call in nil-safe helpers (util.go:162-177);
    tests use ``record.NewFakeRecorder(100)`` (upgrade_suit_test.go:69).
    This recorder is both — consumers may subclass to forward to a real
    event sink.
    """

    def __init__(self, capacity: int = 1000) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity
        self.events: List[Event] = []

    def event(self, obj_name: str, event_type: str, reason: str, message: str) -> None:
        with self._lock:
            self.events.append(Event(obj_name, event_type, reason, message))
            if len(self.events) > self._capacity:
                self.events.pop(0)

    # -- query helpers for tests -------------------------------------------
    def messages(self) -> List[str]:
        with self._lock:
            return [e.message for e in self.events]


def log_event(
    recorder: Optional[EventRecorder],
    obj_name: str,
    event_type: str,
    reason: str,
    message: str,
) -> None:
    """Nil-safe event emission (reference: util.go:162-177)."""
    if recorder is None:
        return
    recorder.event(obj_name, event_type, reason, message)


class ClusterEventRecorder(EventRecorder):
    """EventRecorder that also writes deduplicated core/v1 ``Event``
    objects through a :class:`~..cluster.client.ClusterClient`.

    The reference emits real cluster Events via controller-runtime's
    ``record.EventRecorder`` (util.go:162-177), whose client-go correlator
    collapses repeats of the same (object, type, reason, message) into one
    Event with an incremented ``count`` and updated ``lastTimestamp``.
    This recorder reproduces that contract:

    * the Event name is a deterministic hash of the dedup key, so a
      restarted operator finds its prior Event (AlreadyExists → read +
      patch) instead of duplicating it;
    * repeats merge-patch ``count``/``lastTimestamp`` only;
    * cluster-write failures never break the rollout — the event is still
      recorded in-process and the error logged (nil-safe spirit).

    Events about Nodes (cluster-scoped) land in *namespace* (default
    ``"default"``, matching kubectl's behavior for node events).
    """

    def __init__(
        self,
        cluster,
        namespace: str = "default",
        involved_kind: str = "Node",
        source_component: Optional[str] = None,
        capacity: int = 1000,
    ) -> None:
        super().__init__(capacity=capacity)
        self._cluster = cluster
        self._namespace = namespace
        self._involved_kind = involved_kind
        self._source_component = source_component
        #: dedup key -> (event object name, last known count)
        self._seen: Dict[tuple, tuple] = {}

    @staticmethod
    def _now() -> str:
        import datetime as _dt

        return (
            _dt.datetime.now(_dt.timezone.utc)
            .replace(microsecond=0)
            .isoformat()
            .replace("+00:00", "Z")
        )

    def event(self, obj_name: str, event_type: str, reason: str, message: str) -> None:
        super().event(obj_name, event_type, reason, message)
        try:
            self._write(obj_name, event_type, reason, message)
        except Exception:  # cluster-write failures must not break rollouts
            logging.getLogger(__name__).warning(
                "failed to write Event %s/%s for %s to the cluster",
                event_type,
                reason,
                obj_name,
                exc_info=True,
            )

    def _write(
        self, obj_name: str, event_type: str, reason: str, message: str
    ) -> None:
        import hashlib

        key = (self._involved_kind, obj_name, event_type, reason, message)
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        ev_name = f"{obj_name}.{digest}"
        now = self._now()
        with self._lock:
            seen = self._seen.get(key)
        if seen is None:
            body = {
                "kind": "Event",
                "apiVersion": "v1",
                "metadata": {"name": ev_name, "namespace": self._namespace},
                "involvedObject": {
                    "kind": self._involved_kind,
                    "name": obj_name,
                    "namespace": "",
                },
                "reason": reason,
                "message": message,
                "type": event_type,
                "source": {
                    "component": self._source_component or get_event_reason()
                },
                "count": 1,
                "firstTimestamp": now,
                "lastTimestamp": now,
            }
            from ..cluster.errors import AlreadyExistsError

            try:
                self._cluster.create(body)
                count = 1
            except AlreadyExistsError:
                # Operator restart: adopt the prior Event.
                existing = self._cluster.get("Event", ev_name, self._namespace)
                count = int(existing.get("count") or 1) + 1
                self._cluster.patch(
                    "Event",
                    ev_name,
                    {"count": count, "lastTimestamp": now},
                    self._namespace,
                )
        else:
            count = seen[1] + 1
            self._cluster.patch(
                "Event",
                ev_name,
                {"count": count, "lastTimestamp": now},
                self._namespace,
            )
        with self._lock:
            self._seen[key] = (ev_name, count)
