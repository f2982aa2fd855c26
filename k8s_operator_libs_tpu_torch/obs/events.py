"""Reason-coded decision events + the explain plane.

PRs 1 and 4 made rollouts *visible* (traces, flight recorder, SLO
gauges) but not *explainable*: every reconcile the scheduler, the
remediation gate, the breaker and the drain manager decide to admit,
defer, quarantine or roll back a node — and none of those decisions was
recorded with a reason.  "Why is node X stuck?" meant reading logs.
This module is the durable decision stream that turns the dashboards
into answers:

* :class:`DecisionEventLog` — a bounded **dedup ring** of typed,
  reason-coded events (``NodeAdmitted``, ``NodeDeferred{reason=budget|
  window|pacing|canary|quarantine|gate:remediation|...}``,
  ``WavePlanned``, ``BreakerTripped``, ``RollbackStarted``,
  ``SloBreached``, ...).  Each event carries the node/target, the
  emitting reconcile's **trace ID** (:mod:`.tracing` correlation), and a
  **monotonic sequence**; repeat-identical events aggregate with a
  ``count`` exactly like kubelet's event correlator, so a gated
  16k-node fleet costs O(distinct decisions) memory, not O(reconciles).
  Every emission counts into ``upgrade_events_total{type,reason}``.
* :class:`ClusterDecisionEventSink` — optional persistence of the
  stream as real core/v1 ``Event`` objects (``reason`` = event type,
  message prefixed with the machine-readable ``[reason-code]``),
  batched/coalesced per reconcile so steady-state cluster-write cost is
  O(changed): only entries whose count advanced since the last pump are
  written, through the transport's batch endpoint when it has one.  The
  in-memory apiserver garbage-collects them after
  ``event_ttl_seconds`` (the kube-apiserver ``--event-ttl`` analog).
* :func:`explain_node` — the answer to "why is node X not
  progressing": current phase (flight recorder), the first blocking
  gate with its **machine-readable reason code**, retry/backoff state,
  and the SLO ETA — computable live (the operator's
  ``GET /debug/explain?node=``) and offline (a dump's node annotations
  + persisted decision Events reconstruct the same verdict).

Process-default plumbing mirrors the tracer / metrics registry /
flight recorder: components emit into :func:`default_log`, tests swap
it with :func:`set_default_log`, and the bench A/Bs a disabled log
(``DecisionEventLog(enabled=False)`` short-circuits at one attribute
check per decision).
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..cluster.errors import AlreadyExistsError, ApiError, NotFoundError
from . import tracing

logger = logging.getLogger(__name__)

#: Event-object annotation carrying the log's monotonic sequence — the
#: offline reconstruction's ORDER oracle (ISO timestamps have 1-second
#: resolution; a reconcile emits many decisions inside one second).
SEQ_ANNOTATION = "nvidia.com/decision-seq"
#: Companion annotation naming the LOG INSTANCE that minted the seq:
#: sequences restart at 0 per process, so the adopt path may only treat
#: "existing seq >= mine" as already-written when both came from the
#: SAME instance — across instances (operator restart) it must merge.
SRC_ANNOTATION = "nvidia.com/decision-src"

# --------------------------------------------------------------- vocabulary
#: Event types (the K8s Event ``reason`` field when persisted).
EVENT_NODE_ADMITTED = "NodeAdmitted"
EVENT_NODE_DEFERRED = "NodeDeferred"
EVENT_NODE_UNADMITTED = "NodeUnadmitted"
EVENT_WAVE_PLANNED = "WavePlanned"
EVENT_NODE_DRAINED = "NodeDrained"
EVENT_NODE_DRAIN_FAILED = "NodeDrainFailed"
EVENT_NODE_UPGRADE_FAILED = "NodeUpgradeFailed"
EVENT_NODE_RETRIED = "NodeRetried"
EVENT_NODE_QUARANTINED = "NodeQuarantined"
EVENT_QUARANTINE_RELEASED = "QuarantineReleased"
EVENT_BREAKER_TRIPPED = "BreakerTripped"
EVENT_ROLLBACK_STARTED = "RollbackStarted"
EVENT_SLO_BREACHED = "SloBreached"
EVENT_ANALYSIS_STEP_ADVANCED = "AnalysisStepAdvanced"
EVENT_ANALYSIS_ABORTED = "AnalysisAborted"
EVENT_PACING_ADAPTED = "PacingAdapted"
# -- federation plane (one coordinator, N clusters; see
# :mod:`..federation`): whole CELLS are the admission unit.
EVENT_CELL_ADMITTED = "CellAdmitted"
EVENT_CELL_PROMOTED = "CellPromoted"
EVENT_CELL_HELD = "CellHeld"

#: Reason codes (machine-readable; the full table lives in
#: docs/observability.md and must stay in sync with it).
REASON_FRESH = "fresh"                  # NodeAdmitted: new version exposure
REASON_BYPASS = "bypass"                # NodeAdmitted: throttle bypass
REASON_BUDGET = "budget"                # NodeDeferred: slot budget exhausted
REASON_WINDOW = "window"                # NodeDeferred: maintenance window closed
REASON_PACING = "pacing"                # NodeDeferred: hourly pacing spent
REASON_CANARY = "canary"                # NodeDeferred: canary stage holding
REASON_QUARANTINE = "quarantine"        # NodeDeferred: domain/node quarantined
REASON_REMEDIATION = "gate:remediation"  # NodeDeferred: breaker open
REASON_SKIP = "skip"                    # NodeDeferred: skip label
REASON_SLICE_DOMAIN = "slice-domain"    # NodeDeferred: domain can never fit pacing
REASON_ROLLBACK_OVERTOOK = "rollback-overtook"  # NodeUnadmitted
REASON_SLO_GATE = "gate:slo"            # NodeDeferred/Analysis*: analysis gate
REASON_PACING_ADAPT = "pacing:adapt"    # PacingAdapted: AIMD scale change
REASON_CELL_PROMOTE = "cell:promote"    # CellAdmitted/CellPromoted: wave order
REASON_CELL_HOLD = "cell:hold"          # CellHeld: rollout order / conditions
REASON_FEDERATION_GATE = "gate:federation"  # CellHeld: global breaker open
REASON_FEDERATION = "federation"        # BreakerTripped: global budget rollup

#: Fleet-level events (no single node) carry this target.
FLEET_TARGET = "fleet"

#: Gate name (rollout_status.GateStatus.gate) → the NodeDeferred reason
#: codes that gate emits — the one mapping rollout_status and explain
#: share, so "which gate" and "which reason" can never disagree.
GATE_REASONS: Dict[str, Tuple[str, ...]] = {
    "canary": (REASON_CANARY,),
    "maintenanceWindow": (REASON_WINDOW,),
    "pacing": (REASON_PACING, REASON_SLICE_DOMAIN),
    "remediation": (REASON_REMEDIATION, REASON_QUARANTINE),
    "analysis": (REASON_SLO_GATE,),
}

#: Event type → the reason codes that type legally carries, or None for
#: a policy-defined vocabulary (SloBreached's reason is the declared SLO
#: name).  This IS the legal-reason-path oracle the chaos campaign's
#: rollout-invariant checker (:mod:`..upgrade.chaos`) validates the
#: decision stream against — an emit site inventing a reason without
#: registering it here fails the campaign, which is the point.
EVENT_REASONS: Dict[str, Optional[frozenset]] = {
    EVENT_NODE_ADMITTED: frozenset({REASON_FRESH, REASON_BYPASS}),
    EVENT_NODE_DEFERRED: frozenset(
        {
            REASON_BUDGET,
            REASON_WINDOW,
            REASON_PACING,
            REASON_CANARY,
            REASON_QUARANTINE,
            REASON_REMEDIATION,
            REASON_SKIP,
            REASON_SLICE_DOMAIN,
            REASON_SLO_GATE,
        }
    ),
    EVENT_NODE_UNADMITTED: frozenset({REASON_ROLLBACK_OVERTOOK}),
    EVENT_WAVE_PLANNED: frozenset({"scheduled"}),
    EVENT_NODE_DRAINED: frozenset({"ok"}),
    EVENT_NODE_DRAIN_FAILED: frozenset({"drain-error"}),
    EVENT_NODE_UPGRADE_FAILED: frozenset({"attempt-failed"}),
    EVENT_NODE_RETRIED: frozenset({"resync", "pod-replace"}),
    EVENT_NODE_QUARANTINED: frozenset({"retry-budget"}),
    EVENT_QUARANTINE_RELEASED: frozenset({"repaired"}),
    EVENT_BREAKER_TRIPPED: frozenset(
        {"failure-budget", "slo", REASON_FEDERATION}
    ),
    EVENT_ROLLBACK_STARTED: frozenset({"breaker"}),
    EVENT_SLO_BREACHED: None,  # reason = the declared SLO's name
    EVENT_ANALYSIS_STEP_ADVANCED: frozenset({REASON_SLO_GATE}),
    EVENT_ANALYSIS_ABORTED: frozenset({REASON_SLO_GATE}),
    EVENT_PACING_ADAPTED: frozenset({REASON_PACING_ADAPT}),
    EVENT_CELL_ADMITTED: frozenset({REASON_CELL_PROMOTE}),
    EVENT_CELL_PROMOTED: frozenset({REASON_CELL_PROMOTE}),
    EVENT_CELL_HELD: frozenset({REASON_CELL_HOLD, REASON_FEDERATION_GATE}),
}

#: Default bound on retained (deduplicated) decision entries.
DEFAULT_CAPACITY = 4096


class _Entry:
    """One deduplicated decision in the ring."""

    __slots__ = (
        "first_seq", "seq", "type", "reason", "target", "message",
        "trace_id", "first_ts", "last_ts", "count",
    )

    def __init__(
        self,
        seq: int,
        type_: str,
        reason: str,
        target: str,
        message: str,
        trace_id: Optional[str],
        now: float,
    ) -> None:
        self.first_seq = seq
        self.seq = seq
        self.type = type_
        self.reason = reason
        self.target = target
        self.message = message
        self.trace_id = trace_id
        self.first_ts = now
        self.last_ts = now
        self.count = 1

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "firstSeq": self.first_seq,
            "type": self.type,
            "reason": self.reason,
            "target": self.target,
            "message": self.message,
            "traceId": self.trace_id,
            "firstTimestamp": round(self.first_ts, 3),
            "lastTimestamp": round(self.last_ts, 3),
            "count": self.count,
        }


class DecisionEventLog:
    """Bounded, deduplicating ring of decision events.

    Dedup key is ``(type, reason, target)`` — a node deferred for the
    same reason every reconcile stays ONE entry with an advancing
    ``count``/``lastTimestamp``/``seq`` (kubelet's correlator contract);
    a reason change (budget → canary) opens a new entry, which is
    exactly the edge an operator cares about.  Eviction is
    least-recently-updated (``dropped_events`` counts)."""

    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True
    ) -> None:
        if capacity < 1:
            raise ValueError("decision log capacity must be >= 1")
        self._capacity = capacity
        #: Recording switch — a disabled log costs one attribute check
        #: per decision (the bench's off-side A/B).
        self.enabled = enabled
        #: Identity of THIS log instance (rides the persisted Events'
        #: src annotation — see :data:`SRC_ANNOTATION`).
        import uuid

        self.instance = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()  #: guarded-by: _lock
        self._seq = 0  #: guarded-by: _lock
        self.dropped_events = 0
        #: (registry, Counter) handle cache: re-resolving the counter
        #: through the registry's create-or-get lock PER EMISSION was
        #: the top cost of a fully-gated fleet's reconcile (the bench's
        #: event_overhead probe); re-resolved only when the process
        #: registry is swapped (tests).
        self._metric_cache: Tuple[Optional[object], Optional[object]] = (
            None,
            None,
        )

    def _counter(self):
        registry = metrics.default_registry()
        cached_registry, counter = self._metric_cache
        if cached_registry is not registry:
            # the ONE family definition lives in metrics.py; only the
            # resolved handle is cached here
            counter = metrics.upgrade_events_counter()
            self._metric_cache = (registry, counter)
        return counter

    # -------------------------------------------------------------- feeding
    def emit(
        self,
        type_: str,
        reason: str,
        target: str,
        message: str = "",
        now: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Optional[int]:
        """Record one decision occurrence; returns its sequence number
        (None when recording is disabled).  The emitting reconcile's
        trace ID is captured automatically for NEW entries (dedup
        repeats keep the first occurrence's trace — capturing per
        repeat would put a tracer lookup on the fully-gated fleet's per
        -node hot path for a value that rarely changes mid-gate; pass
        *trace_id* explicitly to override)."""
        if not self.enabled:
            return None
        now = time.time() if now is None else now
        key = (type_, reason, target)
        with self._lock:
            self._seq += 1
            seq = self._seq
            entry = self._entries.get(key)
            if entry is None:
                if trace_id is None:
                    trace_id = tracing.current_trace_id()
                self._entries[key] = _Entry(
                    seq, type_, reason, target, message, trace_id, now
                )
                while len(self._entries) > self._capacity:
                    self._entries.popitem(last=False)
                    self.dropped_events += 1
            else:
                entry.count += 1
                entry.seq = seq
                if now > entry.last_ts:
                    entry.last_ts = now
                if message and message != entry.message:
                    entry.message = message
                if trace_id:
                    entry.trace_id = trace_id
                self._entries.move_to_end(key)
        self._counter().inc(type_, reason)
        return seq

    def emit_many(
        self,
        type_: str,
        reason: str,
        targets,
        message: str = "",
        now: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Optional[int]:
        """Bulk form of :meth:`emit` for one decision applied to many
        targets (a gated wave deferring a whole fleet): ONE lock
        acquisition per chunk, one trace lookup, one metrics update —
        the per-node cost collapses to a couple of dict operations,
        which is what keeps ``event_overhead_pct_1024n`` inside its
        ≤5% gate.  Semantics identical to per-target emit() calls in
        iteration order; returns the last sequence number."""
        if not self.enabled:
            return None
        targets = list(targets)
        if not targets:
            return None
        now = time.time() if now is None else now
        if trace_id is None:
            trace_id = tracing.current_trace_id()
        seq = None
        # chunked lock holds, like the flight recorder's sweep: a
        # 16k-target wave must not stall /debug/events readers for the
        # whole walk.  Inner loop runs on local aliases — it IS the
        # fully-gated fleet's per-node hot path.
        #: lockcheck: unguarded(alias hoist for the hot loop — the _entries binding never changes after __init__; every mutation below runs under the chunked _lock holds)
        entries = self._entries
        entries_get = entries.get
        move_to_end = entries.move_to_end
        for i in range(0, len(targets), 1024):
            with self._lock:
                seq = self._seq
                for target in targets[i:i + 1024]:
                    seq += 1
                    key = (type_, reason, target)
                    entry = entries_get(key)
                    if entry is None:
                        entries[key] = _Entry(
                            seq, type_, reason, target, message, trace_id,
                            now,
                        )
                    else:
                        entry.count += 1
                        entry.seq = seq
                        if now > entry.last_ts:
                            entry.last_ts = now
                        if message and message != entry.message:
                            entry.message = message
                        move_to_end(key)
                self._seq = seq
                while len(entries) > self._capacity:
                    entries.popitem(last=False)
                    self.dropped_events += 1
        self._counter().inc(type_, reason, amount=float(len(targets)))
        return seq

    # -------------------------------------------------------------- queries
    def events(
        self,
        target: Optional[str] = None,
        type_: Optional[str] = None,
    ) -> List[dict]:
        """Retained entries, oldest-occurrence-last order (ascending by
        last sequence), optionally filtered."""
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.seq)
            out = [
                e.to_dict()
                for e in entries
                if (target is None or e.target == target)
                and (type_ is None or e.type == type_)
            ]
        return out

    def snapshot(
        self,
        target: Optional[str] = None,
        type_: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> dict:
        """The ``/debug/events`` payload.  *limit* keeps only the
        newest N entries; 0 (like a Kubernetes LIST limit) and None
        both mean unlimited."""
        events = self.events(target=target, type_=type_)
        total = len(events)
        if limit is not None and limit > 0:
            events = events[-limit:]
        with self._lock:
            emitted = self._seq
        return {
            "emitted": emitted,
            "entries": total,
            "droppedEvents": self.dropped_events,
            "events": events,
        }

    def drain_since(self, cursor: int) -> Tuple[List[dict], int]:
        """Entries whose last occurrence is newer than *cursor*, plus
        the new cursor — the sink's O(changed) pull: a steady-state
        fleet emitting nothing returns an empty list for free."""
        with self._lock:
            head = self._seq
            if head <= cursor:
                return [], head
            changed = sorted(
                (e for e in self._entries.values() if e.seq > cursor),
                key=lambda e: e.seq,
            )
            return [e.to_dict() for e in changed], head

    def export_stream(self) -> List[dict]:
        """The checker's feed: every retained entry ordered by FIRST
        occurrence (``firstSeq``) — the order decisions were first made,
        which is what per-node reason-path legality is judged against
        (``events()`` orders by last occurrence, the operator view)."""
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.first_seq)
            return [e.to_dict() for e in entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seq = 0
            self.dropped_events = 0


# ------------------------------------------------------------ process default
_default_log = DecisionEventLog()
_default_lock = threading.Lock()


def default_log() -> DecisionEventLog:
    """The process-wide decision log every component emits into."""
    with _default_lock:
        return _default_log


def set_default_log(log: DecisionEventLog) -> DecisionEventLog:
    """Swap the process-default log (tests/bench); returns the previous."""
    global _default_log
    with _default_lock:
        previous = _default_log
        _default_log = log
        return previous


def emit(
    type_: str,
    reason: str,
    target: str,
    message: str = "",
    log: Optional[DecisionEventLog] = None,
) -> Optional[int]:
    """Emit into *log* (default: the process log).  ``is None`` check,
    not truthiness — an empty injected log is falsy via ``__len__`` but
    still the one the caller chose."""
    return (log if log is not None else default_log()).emit(
        type_, reason, target, message
    )


# --------------------------------------------------------- cluster persistence
class ClusterDecisionEventSink:
    """Persist the decision stream as deduplicated core/v1 ``Event``
    objects (``kubectl get events`` / the ``history`` CLI see them, and
    an offline dump reconstructs the stream via
    :func:`decisions_from_cluster`).

    Shape: ``Event.reason`` carries the decision TYPE (``NodeDeferred``),
    the message is prefixed with the machine-readable ``[reason-code]``,
    ``involvedObject`` is the target Node (fleet-level decisions
    reference the component), and ``count``/``firstTimestamp``/
    ``lastTimestamp`` follow the client-go correlator contract.

    Cost contract: :meth:`pump` is called once per reconcile and writes
    only entries whose count advanced since the last pump (the log's
    ``drain_since`` cursor) — a steady-state fleet costs zero writes,
    and a wave's worth of decisions coalesces into one batch round trip
    when the transport serves the batch endpoint.  Write failures never
    break the rollout (nil-safe spirit of the reference's recorder)."""

    def __init__(
        self,
        cluster,
        namespace: str = "default",
        source_component: Optional[str] = None,
    ) -> None:
        self._cluster = cluster
        self._namespace = namespace
        self._source_component = source_component
        self._cursor = 0
        #: the log instance whose entries the last pump carried (rides
        #: the src annotation; see SRC_ANNOTATION).
        self._source_instance = ""
        #: event-object name -> the persisted count this sink last
        #: wrote/observed (create-vs-patch decision + change detection).
        self._written: Dict[str, int] = {}
        #: event-object name -> count carried by the persisted Event
        #: BEFORE this process's occurrences (set by adopt): persisted
        #: count = base + entry.count, so a restart's folded-in history
        #: is preserved by every later patch instead of being regressed
        #: to the new process's local count.
        self._base: Dict[str, int] = {}
        #: event-object name -> entry dict whose write FAILED — retried
        #: on the next pump.  Without this, an edge-triggered decision
        #: (BreakerTripped fires once) lost to a transient apiserver
        #: error would be absent from the persisted audit trail forever:
        #: its count never advances again, so the drain cursor alone
        #: would never re-serve it.  Bounded by the log's own entry
        #: capacity (keyed by name).
        self._pending_retry: Dict[str, dict] = {}

    @staticmethod
    def _iso(ts: float) -> str:
        import datetime as _dt

        return (
            _dt.datetime.fromtimestamp(ts, _dt.timezone.utc)
            .replace(microsecond=0)
            .isoformat()
            .replace("+00:00", "Z")
        )

    def _component(self) -> str:
        if self._source_component:
            return self._source_component
        from ..upgrade import util as upgrade_util

        return upgrade_util.get_event_reason()

    def _event_name(self, entry: dict) -> str:
        digest = hashlib.sha1(
            repr((entry["type"], entry["reason"], entry["target"])).encode()
        ).hexdigest()[:12]
        target = (entry["target"] or FLEET_TARGET).replace("/", "-")
        return f"decision.{target}.{digest}"

    def _event_body(self, entry: dict, name: str) -> dict:
        node = entry["target"] if entry["target"] != FLEET_TARGET else ""
        message = f"[{entry['reason']}] {entry.get('message') or ''}".rstrip()
        return {
            "kind": "Event",
            "apiVersion": "v1",
            "metadata": {
                "name": name,
                "namespace": self._namespace,
                "annotations": {
                    SEQ_ANNOTATION: str(int(entry.get("seq") or 0)),
                    SRC_ANNOTATION: self._source_instance,
                },
            },
            "involvedObject": (
                {"kind": "Node", "name": node, "namespace": ""}
                if node
                else {"kind": "Fleet", "name": self._component(),
                      "namespace": ""}
            ),
            "reason": entry["type"],
            "message": message,
            "type": (
                "Warning"
                if entry["type"]
                in (
                    EVENT_BREAKER_TRIPPED,
                    EVENT_ROLLBACK_STARTED,
                    EVENT_NODE_QUARANTINED,
                    EVENT_NODE_DRAIN_FAILED,
                    EVENT_NODE_UPGRADE_FAILED,
                    EVENT_SLO_BREACHED,
                    EVENT_ANALYSIS_ABORTED,
                )
                else "Normal"
            ),
            "source": {"component": self._component()},
            "count": self._base.get(name, 0) + int(entry.get("count") or 1),
            "firstTimestamp": self._iso(entry["firstTimestamp"]),
            "lastTimestamp": self._iso(entry["lastTimestamp"]),
        }

    def pump(self, log: Optional[DecisionEventLog] = None) -> int:
        """Write every entry that changed since the last pump (plus any
        earlier entry whose write failed — see ``_pending_retry``);
        returns how many Event objects were created/patched.
        O(changed): a quiet reconcile with nothing to retry is one
        integer compare."""
        source = log if log is not None else default_log()
        self._source_instance = getattr(source, "instance", "")
        entries, cursor = source.drain_since(self._cursor)
        # The cursor may advance even when writes fail: failed entries
        # are carried in _pending_retry by NAME (re-draining the whole
        # backlog would be the opposite of O(changed)).
        self._cursor = cursor
        if self._pending_retry:
            fresh = {self._event_name(e) for e in entries}
            retry = [
                e
                for name, e in self._pending_retry.items()
                if name not in fresh
            ]
            self._pending_retry = {}
            entries = retry + entries
        if not entries:
            return 0
        creates: List[Tuple[str, dict, dict]] = []
        patches: List[Tuple[str, dict, dict, dict]] = []
        by_name: Dict[str, dict] = {}
        attempted: List[str] = []
        for entry in entries:
            name = self._event_name(entry)
            body = self._event_body(entry, name)
            by_name[name] = entry
            if self._written.get(name) is None:
                creates.append((name, body, entry))
                attempted.append(name)
            elif self._written[name] != body["count"]:
                patches.append(
                    (
                        name,
                        {
                            "count": body["count"],
                            "lastTimestamp": body["lastTimestamp"],
                            "message": body["message"],
                            "metadata": {
                                "annotations": {
                                    SEQ_ANNOTATION: str(
                                        int(entry.get("seq") or 0)
                                    ),
                                    SRC_ANNOTATION: self._source_instance,
                                }
                            },
                        },
                        body,
                        entry,
                    )
                )
                attempted.append(name)
            self._written[name] = body["count"]
        written = 0
        failed: List[str] = []
        try:
            written = self._apply(creates, patches, failed)
        except Exception:  # noqa: BLE001 — persistence must not break rollouts
            logger.warning(
                "failed to persist decision events to the cluster",
                exc_info=True,
            )
            # Only the ATTEMPTED writes failed (already-persisted no-op
            # entries must not be rolled back into re-creates); _written
            # is rolled back too — without that, the retried entries
            # would compare equal to the pre-set count and the retry
            # would no-op, losing edge-triggered decisions for good.
            failed = attempted
            for name in failed:
                self._written.pop(name, None)
        for name in failed:
            entry = by_name.get(name)
            if entry is not None:
                self._pending_retry[name] = entry
        return written

    def _apply(self, creates, patches, failed: List[str]) -> int:
        from ..cluster.writepipeline import WriteOp, transport_batch_fn

        ops: List[Tuple[WriteOp, str, dict, dict]] = []
        for name, body, entry in creates:
            ops.append(
                (
                    WriteOp(op="create", kind="Event", body=body),
                    name,
                    body,
                    entry,
                )
            )
        for name, patch, body, entry in patches:
            ops.append(
                (
                    WriteOp(
                        op="patch",
                        kind="Event",
                        name=name,
                        namespace=self._namespace,
                        body=patch,
                    ),
                    name,
                    body,
                    entry,
                )
            )
        if not ops:
            return 0
        written = 0
        batch_fn = transport_batch_fn(self._cluster)
        if batch_fn is not None and len(ops) > 1:
            # one round trip for the whole reconcile's decisions; per-op
            # fallout (adopt / TTL-expired recreate / failure) handled
            # below exactly like the per-op path
            results = batch_fn([op for op, _, _, _ in ops])
            for (op, name, body, entry), (_, err) in zip(ops, results):
                written += self._settle(op.op, name, body, entry, err, failed)
            return written
        for op, name, body, entry in ops:
            err = None
            try:
                if op.op == "create":
                    self._cluster.create(body)
                else:
                    self._cluster.patch(
                        "Event", name, op.body, self._namespace
                    )
            except (ApiError, OSError) as caught:
                err = caught
            written += self._settle(op.op, name, body, entry, err, failed)
        return written

    def _settle(
        self,
        verb: str,
        name: str,
        body: dict,
        entry: dict,
        err,
        failed: List[str],
    ) -> int:
        """Resolve one write's outcome (shared by the batch and per-op
        paths).  A TTL-expired patch target is recreated; a create that
        lost the race adopts; any OTHER failure DROPS the ``_written``
        entry (so the eventual rewrite creates instead of patching a
        name that may not exist) and records the name in *failed* for
        the caller's retry bookkeeping — a transiently failed write
        must neither poison later writes NOR silently lose an
        edge-triggered decision."""
        if err is None:
            return 1
        if isinstance(err, AlreadyExistsError):
            return self._adopt(name, entry, failed)
        if isinstance(err, NotFoundError) and verb == "patch":
            # The patch target is gone: the store's Event-TTL sweep
            # collected it between pumps.  Recreate — the body carries
            # the seq/src annotations, so the audit trail keeps its
            # ordering oracle across the GC.
            try:
                self._cluster.create(body)
                return 1
            except AlreadyExistsError:
                return self._adopt(name, entry, failed)
            except (ApiError, OSError):
                logger.warning("decision event recreate failed for %s", name)
                self._written.pop(name, None)
                failed.append(name)
                return 0
        logger.warning("decision event %s failed for %s: %s", verb, name, err)
        self._written.pop(name, None)
        failed.append(name)
        return 0

    def _adopt(self, name: str, entry: dict, failed: List[str]) -> int:
        """A create raced an Event that already exists under our
        deterministic name.  Two cases, told apart by the persisted
        sequence annotation:

        * the existing Event came from ANOTHER log instance (operator
          restart; src annotations differ): record its count as this
          name's ``_base`` and fold our occurrences on top, so every
          LATER patch (``base + entry.count``) preserves the adopted
          history instead of regressing it;
        * the existing Event is OUR OWN instance's at/after this
          entry's seq — an uncertain write (batch connection died after
          the server applied): adopt the count WITHOUT re-adding ours,
          which would double-count.

        The store's Event-TTL sweep can RACE this whole path (the
        Event-GC race): the Event that made our create conflict may be
        gone by the time we read or patch it.  Both windows degrade to
        a plain recreate — with the seq annotation intact and without
        inheriting the swept count — never to a dropped entry; any
        other failure parks the entry in *failed* for the next pump's
        retry (an edge-triggered decision must not be lost to a
        transient)."""
        entry_seq = int(entry.get("seq") or 0)
        entry_count = int(entry.get("count") or 1)
        try:
            existing = self._cluster.get("Event", name, self._namespace)
        except NotFoundError:
            # TTL sweep collected it between our failed create and this
            # read: recreate fresh (base dropped with the swept history).
            self._base.pop(name, None)
            try:
                self._cluster.create(self._event_body(entry, name))
                self._written[name] = entry_count
                return 1
            except (ApiError, OSError) as err:
                logger.warning(
                    "decision event adopt-recreate failed for %s: %s",
                    name,
                    err,
                )
                self._written.pop(name, None)
                failed.append(name)
                return 0
        except (ApiError, OSError) as err:
            logger.warning("decision event adopt failed for %s: %s", name, err)
            self._written.pop(name, None)
            failed.append(name)
            return 0
        annotations = (existing.get("metadata") or {}).get("annotations") or {}
        try:
            existing_seq = int(annotations.get(SEQ_ANNOTATION) or 0)
        except ValueError:
            existing_seq = 0
        existing_count = int(existing.get("count") or 1)
        same_instance = (
            bool(self._source_instance)
            and annotations.get(SRC_ANNOTATION) == self._source_instance
        )
        if same_instance and existing_seq >= entry_seq:
            # our own write already landed — no re-add, no double count
            self._base[name] = max(0, existing_count - entry_count)
            self._written[name] = existing_count
            return 1
        self._base[name] = existing_count
        merged = existing_count + entry_count
        try:
            self._cluster.patch(
                "Event",
                name,
                {
                    "count": merged,
                    "lastTimestamp": self._iso(entry["lastTimestamp"]),
                    "message": self._event_body(entry, name)["message"],
                    "metadata": {
                        "annotations": {
                            SEQ_ANNOTATION: str(entry_seq),
                            SRC_ANNOTATION: self._source_instance,
                        }
                    },
                },
                self._namespace,
            )
        except NotFoundError:
            # swept between the read and the merge patch: the adopted
            # history is gone — recreate with OUR occurrences only (a
            # merged count would resurrect the swept history as a
            # double count on the fresh object).
            self._base.pop(name, None)
            try:
                self._cluster.create(self._event_body(entry, name))
                self._written[name] = entry_count
                return 1
            except (ApiError, OSError) as err:
                logger.warning(
                    "decision event adopt-recreate failed for %s: %s",
                    name,
                    err,
                )
                self._written.pop(name, None)
                failed.append(name)
                return 0
        except (ApiError, OSError) as err:
            logger.warning("decision event adopt failed for %s: %s", name, err)
            self._written.pop(name, None)
            self._base.pop(name, None)
            failed.append(name)
            return 0
        self._written[name] = merged
        return 1


#: Decision types this module ever persists — the offline reconstructor's
#: recognizer (a kubelet Event named "NodeDeferred" cannot exist; ours can
#: only have come from the sink).
_KNOWN_TYPES = frozenset(
    (
        EVENT_NODE_ADMITTED,
        EVENT_NODE_DEFERRED,
        EVENT_NODE_UNADMITTED,
        EVENT_WAVE_PLANNED,
        EVENT_NODE_DRAINED,
        EVENT_NODE_DRAIN_FAILED,
        EVENT_NODE_UPGRADE_FAILED,
        EVENT_NODE_RETRIED,
        EVENT_NODE_QUARANTINED,
        EVENT_QUARANTINE_RELEASED,
        EVENT_BREAKER_TRIPPED,
        EVENT_ROLLBACK_STARTED,
        EVENT_SLO_BREACHED,
        EVENT_ANALYSIS_STEP_ADVANCED,
        EVENT_ANALYSIS_ABORTED,
        EVENT_PACING_ADAPTED,
        EVENT_CELL_ADMITTED,
        EVENT_CELL_PROMOTED,
        EVENT_CELL_HELD,
    )
)


def decisions_from_cluster(
    cluster, namespace: Optional[str] = None, strict: bool = False
) -> List[dict]:
    """Reconstruct the decision stream from the persisted ``Event``
    objects (offline dumps and live clusters alike): Events whose
    ``reason`` is a known decision type and whose message carries the
    ``[reason-code]`` prefix parse back into the same dict shape the
    live log serves, sorted oldest-first by lastTimestamp.  Missing or
    foreign Events simply yield an empty list — the stream is optional
    everywhere it is consumed.  *strict* re-raises READ failures
    (ApiError/OSError) instead of degrading to empty: the ``events``
    CLI must distinguish "no events" from "could not reach the
    apiserver" (an Events kind the source does not serve stays an empty
    answer either way)."""
    try:
        events = cluster.list("Event", namespace=namespace)
    except NotFoundError:
        return []
    except (ApiError, OSError):
        if strict:
            raise
        return []
    out: List[dict] = []
    for ev in events:
        type_ = ev.get("reason") or ""
        message = ev.get("message") or ""
        if type_ not in _KNOWN_TYPES or not message.startswith("["):
            continue
        code, _, rest = message[1:].partition("]")
        if not code:
            continue
        involved = ev.get("involvedObject") or {}
        target = (
            involved.get("name") or FLEET_TARGET
            if involved.get("kind") == "Node"
            else FLEET_TARGET
        )
        annotations = (ev.get("metadata") or {}).get("annotations") or {}
        try:
            seq = int(annotations.get(SEQ_ANNOTATION) or 0)
        except ValueError:
            seq = 0
        out.append(
            {
                "seq": seq,
                "type": type_,
                "reason": code,
                "target": target,
                "message": rest.strip(),
                "count": int(ev.get("count") or 1),
                "firstTimestamp": ev.get("firstTimestamp") or "",
                "lastTimestamp": ev.get("lastTimestamp") or "",
                "traceId": None,
                # the LOG INSTANCE whose sink last wrote this Event —
                # lets a live merge recognize (and keep exactly one
                # copy of) its OWN persisted decisions
                "src": annotations.get(SRC_ANNOTATION) or "",
            }
        )
    # Timestamp first, sequence as the SUB-second tiebreaker: the seq
    # restarts at 0 with each operator process, so sorting by it alone
    # would order a restarted operator's fresh decisions BEFORE the
    # previous process's (ISO timestamps order correctly across
    # restarts; within one second the same process's seq decides).
    out.sort(
        key=lambda d: (str(d["lastTimestamp"]), d["seq"], d["target"])
    )
    return out


def _merge_sort_key(decision: dict) -> tuple:
    """THE cross-stream ordering: timestamp first (ISO strings — or the
    live log's float epoch stamps rendered to a sortable form — order
    correctly across processes and clusters), per-process sequence as
    the sub-second tiebreaker, then (cell, type, target) so two streams
    merged in any input order produce byte-identical output.  The same
    rule :func:`decisions_from_cluster` applies within one cluster,
    promoted here to the federation merge."""
    ts = decision.get("lastTimestamp")
    if isinstance(ts, (int, float)):
        # live-log epoch floats and persisted ISO strings may meet in
        # one merge (live view vs offline reconstruction): render the
        # float the way the sink's _iso does, at whole-second
        # resolution, so the two spellings of the same instant compare
        # equal and the seq tiebreaker decides
        ts = ClusterDecisionEventSink._iso(float(ts))
    return (
        str(ts or ""),
        int(decision.get("seq") or 0),
        str(decision.get("cell") or ""),
        str(decision.get("type") or ""),
        str(decision.get("target") or ""),
    )


def merge_cell_streams(streams) -> List[dict]:
    """Merge per-cluster decision streams into ONE globally ordered
    audit trail (the federation plane's merged view).

    *streams* maps cell name -> decision list (each as served by
    :meth:`DecisionEventLog.events`/``snapshot`` or reconstructed by
    :func:`decisions_from_cluster`); iterables of ``(cell, decisions)``
    pairs are accepted too.  Every output decision is tagged with its
    source ``cell``.  Guarantees (property-tested in
    tests/test_federation.py):

    * **order-stable** — output is a pure function of the decision SET,
      independent of input stream order (timestamp-first, seq-tiebreak,
      then cell/type/target: the cross-process rule
      :func:`decisions_from_cluster` already applies within one
      cluster, so per-cell restarts and skewed clocks order exactly as
      they do in the single-cluster offline view);
    * **lossless** — every input decision appears exactly once; feeding
      the same cell's stream twice (a duplicate adoption — e.g. the
      live log AND its own persisted reconstruction) dedups on the
      decision's identity, never double-counts.
    """
    if isinstance(streams, dict):
        pairs = streams.items()
    else:
        pairs = streams
    merged: List[dict] = []
    seen = set()
    for cell, decisions in sorted(pairs, key=lambda p: str(p[0])):
        for d in decisions or []:
            tagged = dict(d, cell=str(cell))
            identity = (
                tagged["cell"],
                str(tagged.get("type") or ""),
                str(tagged.get("reason") or ""),
                str(tagged.get("target") or ""),
                int(tagged.get("seq") or 0),
            )
            if identity in seen:
                continue
            seen.add(identity)
            merged.append(tagged)
    merged.sort(key=_merge_sort_key)
    return merged


def merged_decisions_from_clusters(
    clusters, namespace: Optional[str] = None, strict: bool = False
) -> List[dict]:
    """The offline federated audit trail: reconstruct each cell's
    persisted decision Events and merge them
    (:func:`merge_cell_streams`).  *clusters* maps cell name ->
    ClusterClient."""
    return merge_cell_streams(
        {
            cell: decisions_from_cluster(
                cluster, namespace=namespace, strict=strict
            )
            for cell, cluster in clusters.items()
        }
    )


def format_decision_line(decision: dict) -> str:
    """THE one-line rendering of a decision dict —
    ``Type[reason] target ×count — message`` — shared by the ``events``
    CLI, ``rollout_status``'s last-decisions block and ``explain``'s
    recent-decisions list, so the three surfaces can never drift apart
    on the same decision."""
    target = decision.get("target", "")
    if decision.get("cell"):
        # a federation-merged decision names its source cluster
        target = f"{decision['cell']}/{target}"
    line = (
        f"{decision.get('type', '?')}[{decision.get('reason', '?')}] "
        f"{target}"
    ).rstrip()
    count = int(decision.get("count") or 1)
    if count > 1:
        line += f" ×{count}"
    message = decision.get("message") or ""
    if message:
        line += f" — {message}"
    return line


# ----------------------------------------------------------------- explain
#: GateStatus.gate → the explain reason code (first-blocking-gate
#: path), DERIVED from GATE_REASONS — the documented single source —
#: so a gate added there can never desynchronize explain's fallback
#: code from rollout_status's deferral note.
_GATE_CODE = {gate: reasons[0] for gate, reasons in GATE_REASONS.items()}


def explain_node(
    node_name: str,
    state,
    policy=None,
    recorder=None,
    slo_report: Optional[dict] = None,
    decisions: Optional[List[dict]] = None,
    now: Optional[float] = None,
    analysis: Optional[dict] = None,
) -> Optional[dict]:
    """"Why is node X not progressing" as one machine-readable dict, or
    None when the snapshot does not manage the node.

    Pure function of (snapshot, policy, timelines, decision stream, now)
    — the live operator passes its last snapshot + the process log; the
    offline CLI passes a dump-built snapshot + the persisted decision
    Events (:func:`decisions_from_cluster`), and both produce the same
    ``reasonCode`` for the same cluster state.

    Precedence of the verdict: done → quarantine → failed (retry
    state) → deferred (the node's own last NodeDeferred decision, else
    the first blocking gate, else slot budget) → in-progress."""
    from ..upgrade import consts, util as upgrade_util
    from ..upgrade.remediation import is_remediation_quarantined
    from ..upgrade.rollout_status import _evaluate_gates

    now = time.time() if now is None else now
    found = None
    found_bucket: Optional[str] = None
    for bucket, node_states in state.node_states.items():
        for ns in node_states:
            if ((ns.node.get("metadata") or {}).get("name") or "") == node_name:
                found, found_bucket = ns, bucket
                break
        if found is not None:
            break
    if found is None:
        return None
    node = found.node
    phase = found_bucket or "unknown"
    annotations = (node.get("metadata") or {}).get("annotations") or {}

    # ---- current phase from the flight recorder (checkpoint-reloaded
    # offline, live-fed online — same recorder either way)
    if recorder is None:
        from ..upgrade import timeline as timeline_mod

        recorder = timeline_mod.default_recorder()
    tl = recorder.timeline(node_name)
    phase_since: Optional[float] = None
    if tl is not None and (tl.get("current") or "unknown") == phase:
        phase_since = float(tl.get("currentSince") or 0.0) or None
    out: dict = {
        "node": node_name,
        "phase": phase,
        "phaseSince": phase_since,
        "phaseElapsedSeconds": (
            round(max(0.0, now - phase_since), 3)
            if phase_since is not None
            else None
        ),
    }

    # ---- the node's own decision history (newest-last)
    node_decisions = [
        d for d in (decisions or []) if d.get("target") == node_name
    ]
    out["recentEvents"] = node_decisions[-10:]

    # ---- gates (policy-defined; empty without one).  The analysis
    # gate rides the caller's live report when given, else the pure
    # offline approximation over the same slo_report this explain uses.
    if (
        analysis is None
        and policy is not None
        and getattr(policy, "analysis", None) is not None
    ):
        from ..upgrade.analysis import analysis_report

        analysis = analysis_report(state, policy, slo_report, now=now)
    gates = (
        _evaluate_gates(state, policy, analysis=analysis)
        if policy is not None
        else []
    )
    blocking = [g for g in gates if g.blocking]
    out["blockingGate"] = blocking[0].to_dict() if blocking else None

    # ---- retry/backoff state (remediation annotations)
    spec = getattr(policy, "remediation", None) if policy is not None else None
    attempts_raw = annotations.get(
        upgrade_util.get_attempt_count_annotation_key()
    )
    failed_at_raw = annotations.get(
        upgrade_util.get_last_failure_at_annotation_key()
    )
    retry: Optional[dict] = None
    if attempts_raw or failed_at_raw:
        try:
            attempts = int(attempts_raw or 0)
        except ValueError:
            attempts = 0
        retry = {"attempts": attempts, "episodeOpen": bool(failed_at_raw)}
        if failed_at_raw:
            try:
                failed_at = float(failed_at_raw)
            except ValueError:
                failed_at = now
            retry["lastFailureAt"] = failed_at
            if spec is not None:
                backoff = min(
                    spec.backoff_max_seconds,
                    spec.backoff_seconds * (2 ** max(0, attempts - 1)),
                )
                retry["backoffRemainingSeconds"] = round(
                    max(0.0, backoff - (now - failed_at)), 3
                )
        if spec is not None and spec.max_node_attempts > 0:
            retry["maxAttempts"] = spec.max_node_attempts
        target = annotations.get(
            upgrade_util.get_failure_target_annotation_key()
        )
        if target:
            retry["failureTarget"] = target
    out["retry"] = retry

    # ---- SLO plane: fleet ETA + straggler membership
    out["eta"] = (slo_report or {}).get("eta")
    straggler = None
    for s in (slo_report or {}).get("stragglers") or []:
        if s.get("node") == node_name:
            straggler = s
            break
    out["straggler"] = straggler

    # ---- verdict + reason code (precedence in the docstring)
    quarantine_value = annotations.get(
        upgrade_util.get_quarantine_annotation_key()
    )
    if phase == consts.UPGRADE_STATE_DONE:
        verdict, code = "complete", "done"
    elif quarantine_value:
        verdict, code = "quarantined", REASON_QUARANTINE
        out["quarantine"] = {
            "value": quarantine_value,
            "remediationOwned": is_remediation_quarantined(node),
        }
    elif phase == consts.UPGRADE_STATE_FAILED:
        verdict = "failed"
        if retry is None:
            code = "failed:awaiting-repair"
        elif (
            retry.get("maxAttempts")
            and retry["attempts"] >= retry["maxAttempts"]
        ):
            code = "retry-budget-exhausted"
        elif retry.get("backoffRemainingSeconds", 0) > 0:
            code = "retry-backoff"
        else:
            code = "retry-pending"
    elif phase == consts.UPGRADE_STATE_UPGRADE_REQUIRED:
        deferral = None
        for d in reversed(node_decisions):
            if d.get("type") == EVENT_NODE_DEFERRED:
                deferral = d
                break
        out["deferral"] = deferral
        if deferral is not None:
            verdict, code = "blocked", deferral["reason"]
        elif blocking:
            verdict, code = "blocked", _GATE_CODE.get(
                blocking[0].gate, blocking[0].gate
            )
        else:
            # nothing gate-shaped blocks it: the node is waiting for a
            # throttle slot (maxParallelUpgrades / maxUnavailable)
            verdict, code = "blocked", REASON_BUDGET
    elif straggler is not None:
        verdict, code = "in-progress", "straggler"
    else:
        verdict, code = "in-progress", "in-progress"
    out["verdict"] = verdict
    out["reasonCode"] = code
    return out


def render_explanation(explanation: dict) -> str:
    """Human rendering of an :func:`explain_node` answer."""
    lines: List[str] = []
    lines.append(
        f"node {explanation['node']}: {explanation['verdict'].upper()} "
        f"[{explanation['reasonCode']}]"
    )
    elapsed = explanation.get("phaseElapsedSeconds")
    lines.append(
        f"  phase: {explanation['phase']}"
        + (f" (for {elapsed:.0f}s)" if elapsed is not None else "")
    )
    gate = explanation.get("blockingGate")
    if gate:
        lines.append(f"  gate:  [{gate['gate']}] {gate['reason']}")
    deferral = explanation.get("deferral")
    if deferral:
        lines.append(
            f"  deferred: [{deferral['reason']}] ×{deferral.get('count', 1)}"
            + (f" — {deferral['message']}" if deferral.get("message") else "")
        )
    retry = explanation.get("retry")
    if retry:
        bits = [f"attempts {retry['attempts']}"]
        if retry.get("maxAttempts"):
            bits[-1] += f"/{retry['maxAttempts']}"
        if retry.get("backoffRemainingSeconds"):
            bits.append(f"backoff {retry['backoffRemainingSeconds']:.0f}s left")
        lines.append("  retry: " + ", ".join(bits))
    quarantine = explanation.get("quarantine")
    if quarantine:
        lines.append(f"  quarantine: {quarantine['value']}")
    straggler = explanation.get("straggler")
    if straggler:
        lines.append(
            f"  straggler: {straggler['elapsedSeconds']:.0f}s in "
            f"{straggler['phase']} (p95 {straggler['phaseP95Seconds']:g}s)"
        )
    eta = explanation.get("eta")
    if eta and eta.get("seconds") is not None:
        lines.append(f"  fleet ETA: {eta['seconds']:.0f}s")
    events = explanation.get("recentEvents") or []
    if events:
        lines.append("  recent decisions:")
        for d in events[-5:]:
            lines.append("    " + format_decision_line(d))
    return "\n".join(lines)


# ------------------------------------------------------------------ selftest
def selftest() -> str:
    """End-to-end explain smoke (the ``make verify-events`` gate): a
    small fleet under a slot-throttled remediation policy defers nodes
    (budget), a bad revision trips the breaker (gate:remediation) and
    the retry budget quarantines a node (quarantine) — and ``explain``
    answers each with the machine-readable reason code through all
    three planes: the live manager surface, a real OpsServer
    ``GET /debug/explain`` + ``/debug/events``, and an offline dump
    rebuilt via ``InMemoryCluster.from_dict`` with decisions
    reconstructed from the persisted Event objects.  Raises
    AssertionError on any violated expectation."""
    import json as json_mod
    import urllib.request

    from ..api.upgrade_spec import (
        DrainSpec,
        IntOrString,
        RemediationSpec,
        UpgradePolicySpec,
    )
    from ..cluster.cache import InformerCache
    from ..cluster.inmem import InMemoryCluster
    from ..cluster.objects import (
        CONTROLLER_REVISION_HASH_LABEL,
        make_controller_revision,
        make_daemonset,
        make_node,
        make_pod,
    )
    from ..controller.ops_server import OpsServer
    from ..upgrade import timeline as timeline_mod
    from ..upgrade.upgrade_state import ClusterUpgradeStateManager

    namespace, labels = "events-selftest", {"app": "selftest-runtime"}
    prev_registry = metrics.set_default_registry(metrics.MetricsRegistry())
    prev_log = set_default_log(DecisionEventLog())
    prev_recorder = timeline_mod.set_default_recorder(
        timeline_mod.FlightRecorder()
    )
    ops = None
    manager = None
    try:
        cluster = InMemoryCluster()
        ds = cluster.create(
            make_daemonset("selftest-runtime", namespace, dict(labels))
        )
        cluster.create(make_controller_revision(ds, 1, "good"))
        nodes = [f"node-{i}" for i in range(4)]
        seq = iter(range(10_000))

        def spawn_pod(node: str, revision: str) -> None:
            bad = revision == "bad"
            cluster.create(
                make_pod(
                    f"selftest-runtime-{next(seq)}",
                    namespace,
                    node,
                    labels=dict(labels),
                    owner=ds,
                    revision_hash=revision,
                    ready=not bad,
                    restart_count=11 if bad else 0,
                )
            )

        for node in nodes:
            cluster.create(make_node(node))
            spawn_pod(node, "good")
        fresh = cluster.get("DaemonSet", "selftest-runtime", namespace)
        fresh["status"]["desiredNumberScheduled"] = len(nodes)
        cluster.update(fresh)

        def newest_hash() -> str:
            crs = cluster.list("ControllerRevision", namespace=namespace)
            newest = max(crs, key=lambda c: c.get("revision", 0))
            return newest["metadata"]["labels"][CONTROLLER_REVISION_HASH_LABEL]

        def ds_controller() -> None:
            covered = {
                p["spec"]["nodeName"]
                for p in cluster.list("Pod", namespace=namespace)
            }
            for node in nodes:
                if node not in covered:
                    spawn_pod(node, newest_hash())

        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,  # throttled: the rest defer{budget}
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=5),
            remediation=RemediationSpec(
                failure_threshold=0.5,
                min_attempted=1,
                auto_rollback=False,  # the breaker STAYS open: gate visible
                max_node_attempts=1,  # first failure quarantines
                backoff_seconds=0.0,
            ),
        )
        policy.validate()
        sink = ClusterDecisionEventSink(cluster, namespace="default")
        manager = ClusterUpgradeStateManager(
            cluster,
            cache=InformerCache(cluster, lag_seconds=0.0),
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=sink,
        )

        def reconcile() -> None:
            state = manager.build_state(namespace, labels)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            ds_controller()

        # ---- phase 1: deferral.  Publish a new revision; with ONE slot
        # the first admitted node holds it and the rest defer{budget}.
        cluster.create(make_controller_revision(ds, 2, "bad"))
        reconcile()
        reconcile()
        deferred = None
        for node in nodes:
            answer = manager.explain_node(node)
            if answer and answer["reasonCode"] == REASON_BUDGET:
                deferred = (node, answer)
                break
        assert deferred is not None, (
            "no node explained as deferred{budget}: "
            + str({n: (manager.explain_node(n) or {}).get("reasonCode")
                   for n in nodes})
        )

        # ---- phase 2: the bad revision fails pods → breaker trips and
        # stays open (autoRollback off) → pending nodes explain as
        # gate:remediation; the exhausted retry budget quarantines.
        for _ in range(30):
            reconcile()
            status = manager.remediation_status() or {}
            if status.get("paused"):
                break
        else:
            raise AssertionError("breaker never tripped")
        reconcile()  # one more pass so deferrals re-emit under the open gate

        gated = None
        quarantined = None
        for node in nodes:
            answer = manager.explain_node(node) or {}
            if answer.get("reasonCode") == REASON_REMEDIATION:
                gated = (node, answer)
            if answer.get("reasonCode") == REASON_QUARANTINE:
                quarantined = (node, answer)
        assert gated is not None, (
            "no node explained as gate:remediation: "
            + str({n: (manager.explain_node(n) or {}).get("reasonCode")
                   for n in nodes})
        )
        assert quarantined is not None, (
            "no node explained as quarantined: "
            + str({n: (manager.explain_node(n) or {}).get("reasonCode")
                   for n in nodes})
        )
        assert gated[1]["blockingGate"] is not None
        assert gated[1]["blockingGate"]["gate"] == "remediation"

        # decision stream carries the trip + the deferrals
        log_events = default_log().snapshot()
        types = {e["type"] for e in log_events["events"]}
        assert EVENT_BREAKER_TRIPPED in types, types
        assert EVENT_NODE_DEFERRED in types, types

        # plane 1: metrics
        exposition = metrics.default_registry().render()
        assert "upgrade_events_total" in exposition, "event counter missing"

        # plane 2: OpsServer /debug/events + /debug/explain over real HTTP
        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            events_source=manager.events_status,
            explain_source=manager.explain_node,
        ).start()
        with urllib.request.urlopen(
            ops.url + "/debug/events", timeout=5
        ) as rsp:
            served = json_mod.loads(rsp.read())
        assert any(
            e["type"] == EVENT_BREAKER_TRIPPED
            for e in served.get("events") or []
        ), served
        with urllib.request.urlopen(
            ops.url + f"/debug/explain?node={gated[0]}", timeout=5
        ) as rsp:
            served_explain = json_mod.loads(rsp.read())
        assert served_explain["reasonCode"] == REASON_REMEDIATION, (
            served_explain
        )
        with urllib.request.urlopen(ops.url + "/debug", timeout=5) as rsp:
            index = json_mod.loads(rsp.read())
        assert "/debug/events" in (index.get("endpoints") or []), index
        assert "/debug/explain" in (index.get("endpoints") or []), index

        # plane 3: OFFLINE — dump the cluster, rebuild from the dict,
        # reconstruct decisions from the persisted Events, and explain
        # again: the reason codes must survive the round trip.
        dump = cluster.to_dict()
        offline = InMemoryCluster.from_dict(dump)
        recorder = timeline_mod.FlightRecorder()
        offline_mgr = ClusterUpgradeStateManager(
            offline, flight_recorder=recorder
        )
        try:
            offline_state = offline_mgr.build_state(namespace, labels)
        finally:
            offline_mgr.shutdown()
        offline_decisions = decisions_from_cluster(offline)
        assert offline_decisions, "persisted decision Events not found"
        for name, expected in (
            (gated[0], REASON_REMEDIATION),
            (quarantined[0], REASON_QUARANTINE),
        ):
            answer = explain_node(
                name,
                offline_state,
                policy=policy,
                recorder=recorder,
                decisions=offline_decisions,
            )
            assert answer is not None and answer["reasonCode"] == expected, (
                f"offline explain for {name}: {answer}"
            )
        # the deferred{budget} answer is offline-reconstructable too
        # (from the persisted NodeDeferred Event), unless the node has
        # since been admitted — check the PERSISTED stream instead
        assert any(
            d["type"] == EVENT_NODE_DEFERRED and d["reason"] == REASON_BUDGET
            for d in offline_decisions
        ), offline_decisions

        return (
            "events selftest OK: deferral{budget}, breaker "
            "gate{gate:remediation} and quarantine explained with "
            "machine-readable reason codes via the live manager, "
            "/debug/explain + /debug/events over HTTP, and an offline "
            f"dump ({len(offline_decisions)} persisted decision events)"
        )
    finally:
        if ops is not None:
            ops.stop()
        if manager is not None:
            manager.shutdown()
        metrics.set_default_registry(prev_registry)
        set_default_log(prev_log)
        timeline_mod.set_default_recorder(prev_recorder)
