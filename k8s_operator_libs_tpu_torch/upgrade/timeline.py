"""FlightRecorder — per-node phase timelines derived from state transitions.

The state machine tells you *what state* each node is in; mid-rollout an
on-call operator needs to know *how long each phase is taking*, which
nodes are dragging, and when the wave will finish.  This module derives
per-node **phase intervals** (upgrade-required → cordon-required →
wait-for-jobs → drain → pod-restart → done/failed, plus quarantine
episodes) from the transitions the managers already make — it adds no
new writes of its own, and its bookkeeping rides the pipeline the
machine already runs:

* **single-writer hook**: :class:`~.node_upgrade_state_provider.\
  NodeUpgradeStateProvider` (the one component that writes the state
  label) calls :meth:`FlightRecorder.transition` while building each
  label patch; the returned **checkpoint** (a compact JSON annotation)
  rides the SAME patch as the label, so a timeline survives operator
  crash / HA failover exactly like the done-at stamp does — the next
  leader reloads it from the node object already in its snapshot;
* **observation sweep**: :meth:`observe` reconciles the recorder against
  each BuildState snapshot, scoped by the snapshot's dirty-node set
  (:class:`~.state_index.ClusterStateIndex` deltas) so steady-state cost
  is O(changed), not O(fleet).  The sweep is what (a) restores
  checkpointed timelines after a crash, (b) records transitions made by
  other actors (a previous leader, manual label edits), and (c) tracks
  quarantine episodes from the quarantine annotation.

Design constraints, in order (same contract as :mod:`..obs.tracing`):

* **always-on cheap**: a clean node costs one dict lookup and a string
  compare per observed build; a transition costs a couple of list ops
  and one small json.dumps (the checkpoint that was going to ride the
  patch anyway).  The fleet-scale bench runs recorded, and
  ``timeline_overhead_pct_1024n`` holds the line (≤ 5%).
* **bounded**: at most *capacity* node timelines (least-recently-updated
  evicted) and *max_intervals* intervals per node (oldest dropped,
  counted in ``dropped_intervals``); checkpoints carry only the last
  *checkpoint_intervals* so the annotation stays small.
* **truth-reconciling**: the recorder never blocks or fails a write; a
  transition recorded optimistically for a patch that then failed is
  corrected by the next observation sweep (the same way the machine
  itself re-derives state from the cluster every cycle).

Interval phases are the state-label values themselves
(``upgrade-required``, ``cordon-required``, ..., ``upgrade-done``) with
the empty "unknown" state surfaced as ``unknown``.  Quarantine episodes
are kept separately — quarantine is an overlay on a state, not a state.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import List, Optional

from ..cluster.inmem import JsonObj
from . import consts, util

logger = logging.getLogger(__name__)

#: Default bound on retained node timelines (LRU-evicted beyond it).
DEFAULT_CAPACITY = 16384
#: Default bound on intervals kept per node (a full lifecycle is ~8).
DEFAULT_MAX_INTERVALS = 64
#: Intervals carried in the node-annotation checkpoint — enough for one
#: full lifecycle plus a retry, small enough to stay an annotation.
DEFAULT_CHECKPOINT_INTERVALS = 12

#: Phase name surfaced for the empty ("no label yet") state.
UNKNOWN_PHASE = "unknown"

_CHECKPOINT_VERSION = 1


def phase_name(state: str) -> str:
    """The surfaced phase name for a state-label value."""
    return state or UNKNOWN_PHASE


#: Phases that constitute rollout WORK (pending + active states): the
#: single definition both the wall-clock derivation below and the SLO
#: engine's analytics build on — a new active state added here moves
#: every consumer at once.
WORK_PHASES = frozenset(
    phase_name(s)
    for s in consts.ACTIVE_STATES + (consts.UPGRADE_STATE_UPGRADE_REQUIRED,)
)


class _NodeTimeline:
    """Mutable per-node record inside the recorder."""

    __slots__ = (
        "name", "intervals", "current", "current_since", "quarantines",
        "dropped_intervals",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        #: Closed intervals, oldest first: [phase, start_unix, end_unix].
        self.intervals: List[List] = []
        #: Phase currently open (None before the first observation).
        self.current: Optional[str] = None
        self.current_since: float = 0.0
        #: Quarantine episodes: [start_unix, end_unix | None].
        self.quarantines: List[List] = []
        self.dropped_intervals = 0

    def to_dict(self) -> dict:
        return {
            "node": self.name,
            "current": self.current,
            "currentSince": self.current_since,
            "intervals": [list(iv) for iv in self.intervals],
            "quarantines": [list(q) for q in self.quarantines],
            "droppedIntervals": self.dropped_intervals,
        }


class FlightRecorder:
    """Bounded in-memory ring of per-node phase timelines."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        max_intervals: int = DEFAULT_MAX_INTERVALS,
        checkpoint_intervals: int = DEFAULT_CHECKPOINT_INTERVALS,
        enabled: bool = True,
    ) -> None:
        if capacity < 1:
            raise ValueError("recorder capacity must be >= 1")
        self._capacity = capacity
        self._max_intervals = max_intervals
        self._checkpoint_intervals = checkpoint_intervals
        #: Recording switch — a disabled recorder costs one attribute
        #: check per hook (the bench's off-side A/B).
        self.enabled = enabled
        self._lock = threading.Lock()
        self._nodes: "OrderedDict[str, _NodeTimeline]" = OrderedDict()  #: guarded-by: _lock
        #: Timelines evicted because the ring was full (observable, like
        #: the tracer's orphan_spans).
        self.evicted_timelines = 0

    # -------------------------------------------------------------- feeding
    def transition(
        self, node: JsonObj, new_state: str, now: Optional[float] = None
    ) -> Optional[str]:
        """Record a state-label transition the provider is about to
        write; returns the checkpoint annotation VALUE to ride the same
        patch (None when recording is disabled).

        Optimistic like the provider's own in-place node mutation: if
        the patch later fails, the next :meth:`observe` sweep corrects
        the timeline from the cluster's actual label."""
        if not self.enabled:
            return None
        now = time.time() if now is None else now
        name = (node.get("metadata") or {}).get("name") or ""
        with self._lock:
            tl = self._get_or_create_locked(name, node)
            self._enter_phase_locked(tl, phase_name(new_state), now)
            return self._checkpoint_locked(tl)

    def observe(self, state, now: Optional[float] = None) -> None:
        """Reconcile the recorder against a BuildState snapshot.  Scoped
        by ``state.dirty_nodes`` when the snapshot carries one (the
        incremental index's delta set): clean, already-known nodes cost
        one set lookup each; None means scan everything (full rebuild —
        exactly when everything may have changed)."""
        if not self.enabled:
            return
        now = time.time() if now is None else now
        dirty = getattr(state, "dirty_nodes", None)
        # hoisted out of the per-node loop: the key builder takes the
        # component-name lock, and at fleet scale "once per node per
        # build" is exactly the overhead budget this sweep lives on
        q_key = util.get_quarantine_annotation_key()
        # CHUNKED locking, like timelines(): one bounded hold per slice
        # of the fleet instead of one O(fleet) hold per reconcile —
        # drain/restart workers finishing transitions through the same
        # lock must not stall behind the sweep.  A transition landing
        # between chunks is harmless: the sweep is truth-reconciling by
        # design and the next build re-observes.
        chunk = 256
        #: lockcheck: unguarded(alias hoist for the sweep — the _nodes binding never changes after __init__; every mutation below runs under the chunked _lock holds)
        nodes = self._nodes
        seen = set()
        for bucket, node_states in state.node_states.items():
            phase = phase_name(bucket)
            for i in range(0, len(node_states), chunk):
                with self._lock:
                    for ns in node_states[i:i + chunk]:
                        node = ns.node
                        if node is None:
                            continue
                        meta = node.get("metadata") or {}
                        name = meta.get("name") or ""
                        seen.add(name)
                        tl = nodes.get(name)
                        if tl is not None:
                            if dirty is not None and name not in dirty:
                                continue
                            # clean fast path: same phase, same
                            # quarantine position — no mutation, no
                            # LRU churn
                            quarantined = bool(
                                (meta.get("annotations") or {}).get(q_key)
                            )
                            if tl.current == phase and quarantined == (
                                bool(tl.quarantines)
                                and tl.quarantines[-1][1] is None
                            ):
                                continue
                        self._observe_node_locked(node, phase, now, q_key)
        # Prune timelines of nodes that LEFT the snapshot (deleted /
        # repaired-and-replaced / descoped): a vanished node's open
        # phase would otherwise grow forever — a permanent phantom
        # straggler and maxNodePhaseSeconds breach.  Scoped like the
        # sweep itself: the indexed path checks only the dirty names
        # (a deletion event dirties its node), the full rebuild
        # reconciles against everything.
        with self._lock:
            if dirty is None:
                stale = [n for n in nodes if n not in seen]
            else:
                stale = [n for n in dirty if n in nodes and n not in seen]
            for name in stale:
                nodes.pop(name, None)

    def observe_node(
        self,
        node: JsonObj,
        bucket: Optional[str] = None,
        now: Optional[float] = None,
    ) -> None:
        """Reconcile one node (offline reconstruction, tests)."""
        if not self.enabled:
            return
        now = time.time() if now is None else now
        if bucket is None:
            labels = (node.get("metadata") or {}).get("labels") or {}
            bucket = labels.get(util.get_upgrade_state_label_key(), "")
        with self._lock:
            self._observe_node_locked(node, phase_name(bucket), now)

    # ------------------------------------------------------------- internals
    def _observe_node_locked(
        self,
        node: JsonObj,
        phase: str,
        now: float,
        q_key: Optional[str] = None,
    ) -> None:
        name = (node.get("metadata") or {}).get("name") or ""
        tl = self._get_or_create_locked(name, node)
        if tl.current != phase:
            # A transition this recorder did not make (crash recovery
            # past the checkpoint, another leader, a manual edit) —
            # record it at observation resolution.
            self._enter_phase_locked(tl, phase, now)
        # Quarantine overlay: an episode opens when the quarantine
        # annotation appears and closes when it is lifted.
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        quarantined = bool(
            annotations.get(q_key or util.get_quarantine_annotation_key())
        )
        open_episode = tl.quarantines and tl.quarantines[-1][1] is None
        if quarantined and not open_episode:
            tl.quarantines.append([now, None])
            if len(tl.quarantines) > self._max_intervals:
                del tl.quarantines[0]
        elif not quarantined and open_episode:
            tl.quarantines[-1][1] = now

    def _get_or_create_locked(
        self, name: str, node: Optional[JsonObj]
    ) -> _NodeTimeline:
        tl = self._nodes.get(name)
        if tl is not None:
            self._nodes.move_to_end(name)
            return tl
        tl = _NodeTimeline(name)
        if node is not None:
            self._restore_checkpoint_locked(tl, node)
        self._nodes[name] = tl
        while len(self._nodes) > self._capacity:
            self._nodes.popitem(last=False)
            self.evicted_timelines += 1
        return tl

    def _enter_phase_locked(
        self, tl: _NodeTimeline, phase: str, now: float
    ) -> None:
        if tl.current is not None:
            # Clamp twice: a checkpoint restored from another host's
            # clock, an NTP step backwards, or an observation racing a
            # transition must never produce a negative interval OR an
            # overlap with the previous one — non-overlapping,
            # time-ordered intervals are the recorder's one hard
            # promise (the property test hammers exactly this).
            start = min(tl.current_since, now)
            end = max(start, now)
            if tl.intervals:
                floor = tl.intervals[-1][2]
                start = max(start, floor)
                end = max(end, start)
            tl.intervals.append([tl.current, start, end])
            if len(tl.intervals) > self._max_intervals:
                del tl.intervals[0]
                tl.dropped_intervals += 1
            now = end
        tl.current = phase
        tl.current_since = now

    # ----------------------------------------------------------- checkpoints
    def _checkpoint_locked(self, tl: _NodeTimeline) -> str:
        tail = tl.intervals[-self._checkpoint_intervals:]
        payload = {
            "v": _CHECKPOINT_VERSION,
            "s": tl.current,
            "t": round(tl.current_since, 3),
            "i": [[p, round(s, 3), round(e, 3)] for p, s, e in tail],
        }
        open_q = [q for q in tl.quarantines if q[1] is None]
        if open_q:
            payload["q"] = round(open_q[-1][0], 3)
        return json.dumps(payload, separators=(",", ":"))

    def _restore_checkpoint_locked(
        self, tl: _NodeTimeline, node: JsonObj
    ) -> None:
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        raw = annotations.get(util.get_timeline_annotation_key())
        if not raw:
            return
        try:
            payload = json.loads(raw)
            if not isinstance(payload, dict) or payload.get("v") != (
                _CHECKPOINT_VERSION
            ):
                return
            intervals = []
            for entry in payload.get("i") or ():
                phase, start, end = entry
                intervals.append([str(phase), float(start), float(end)])
            current = payload.get("s")
            since = float(payload.get("t") or 0.0)
        except (ValueError, TypeError):
            # A hand-edited checkpoint must not take the reconcile down;
            # the timeline simply restarts from live observations.
            logger.debug("unparseable timeline checkpoint on %s", tl.name)
            return
        tl.intervals = intervals[-self._max_intervals:]
        tl.current = str(current) if current is not None else None
        tl.current_since = since
        q_open = payload.get("q")
        if isinstance(q_open, (int, float)):
            tl.quarantines = [[float(q_open), None]]

    # -------------------------------------------------------------- queries
    def timeline(self, node_name: str) -> Optional[dict]:
        with self._lock:
            tl = self._nodes.get(node_name)
            return None if tl is None else tl.to_dict()

    def timelines(self) -> List[dict]:
        """Every retained timeline, node-name order.  Serialization is
        CHUNKED — one short lock acquisition per node, never one long
        hold over the whole fleet: this runs once per reconcile (the SLO
        engine) while drain/restart workers are finishing transitions
        through the same lock, and a multi-ms fleet-wide hold would
        stall the write hot path the overhead bench doesn't measure.
        Nodes evicted or added mid-walk simply miss/join this snapshot —
        the next evaluation sees them."""
        with self._lock:
            names = sorted(self._nodes)
        out: List[dict] = []
        for name in names:
            with self._lock:
                tl = self._nodes.get(name)
                if tl is not None:
                    out.append(tl.to_dict())
        return out

    def snapshot(self, node: Optional[str] = None) -> dict:
        """The ``/debug/timeline`` payload; *node* filters at the
        source — a single-node query must not serialize (and hold the
        lock for) the whole fleet's timelines."""
        if node is not None:
            with self._lock:
                tl = self._nodes.get(node)
                out = [] if tl is None else [tl.to_dict()]
        else:
            out = self.timelines()
        return {
            "nodes": len(out),
            "evictedTimelines": self.evicted_timelines,
            "timelines": out,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def clear(self) -> None:
        with self._lock:
            self._nodes.clear()


# ------------------------------------------------------------ process default
_default_recorder = FlightRecorder()
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    """The process-wide recorder the provider hook records into."""
    with _default_lock:
        return _default_recorder


def set_default_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-default recorder (tests); returns the previous."""
    global _default_recorder
    with _default_lock:
        previous = _default_recorder
        _default_recorder = recorder
        return previous


def wall_clock_samples(timelines: List[dict]) -> List[float]:
    """Completed per-node rollout wall-clocks: entering the first active
    (or pending) phase of a contiguous run → entering done.  One sample
    per done-entry; the ``cordon→done`` number the analytics and tests
    use."""
    samples: List[float] = []
    work_phases = WORK_PHASES
    for tl in timelines:
        run_start: Optional[float] = None
        for phase, start, _end in tl.get("intervals") or []:
            if phase in work_phases:
                if run_start is None:
                    run_start = start
            elif phase == consts.UPGRADE_STATE_DONE:
                # a CLOSED done interval: the node entered done at
                # *start* (retried nodes keep them in history)
                if run_start is not None:
                    samples.append(max(0.0, start - run_start))
                run_start = None
            else:
                run_start = None
        # done is usually the OPEN phase (nothing follows it): the
        # trailing work run ended when the current done phase opened.
        if (
            tl.get("current") == consts.UPGRADE_STATE_DONE
            and run_start is not None
        ):
            samples.append(
                max(0.0, float(tl.get("currentSince") or 0.0) - run_start)
            )
    return samples
