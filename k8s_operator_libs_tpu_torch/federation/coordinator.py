"""FederationCoordinator — one coordinator, N managers, cells as the
admission unit.

The per-cluster library is unchanged: each cell keeps its own manager,
scheduler gates, remediation breaker and decision stream.  This module
layers the *fleet-of-fleets* wave on top, built entirely from the seams
earlier PRs left:

* **cell-based rollout order** — the
  :class:`~..api.federation_spec.FederationPolicySpec` declares cells
  (canary cluster → region → global); the coordinator ADMITS a cell by
  publishing the target ControllerRevision into it (the cross-cluster
  analog of a DS template bump — the cell's own manager then drives its
  rollout exactly as if an operator had published it), and PROMOTES it
  when its rollout completes, its ``soakSeconds`` bake elapses, and its
  ``advanceOn`` conditions hold sustained over the coordinator's
  per-cell metrics-history ring (the analysis grammar at cluster
  granularity).  Every promote/hold/admit decision flows through the
  decision-event vocabulary (``CellAdmitted``/``CellPromoted``/
  ``CellHeld`` with reasons ``cell:promote``/``cell:hold``/
  ``gate:federation``).
* **cross-cluster failure-budget rollup** — per-cell breaker/abort
  state and failure census (failed nodes over admitted-at-stamped
  attempts, the remediation engine's own vocabulary) roll up into a
  GLOBAL breaker: it opens when ``maxBreachedCells`` cells are breached
  or the aggregate ratio crosses ``failureThreshold``, pauses fresh
  cell admissions, and — per the spec — drives LKG rollback in breached
  (and optionally already-promoted) cells through the existing
  :meth:`~..upgrade.remediation.RemediationManager.trip_for_slo`
  machinery with event reason ``federation``.
* **fleet rollup + merged audit** — per-cell ETA/burn roll up into a
  global ETA (``/debug/federation``, the ``fedstatus`` CLI), and
  :func:`explain_cell` answers "why is cell Y not promoting" from the
  same status dict live and offline; the audit trail merges per-cluster
  persisted decision Events via
  :func:`~..obs.events.merge_cell_streams` (the
  timestamp-first/seq-tiebreak ordering built for cross-process merge
  already handles cross-CLUSTER merge).

Like everything else in this library, coordinator state is
cluster-resident: the federation record (per-cell stamps + the global
breaker) rides a DaemonSet annotation in the AUDIT cell, so a
coordinator restart resumes the wave instead of re-admitting from
scratch.
"""

from __future__ import annotations

import json
import logging
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .. import metrics
from ..api.federation_spec import FederationCellSpec, FederationPolicySpec
from ..cluster.errors import AlreadyExistsError, ApiError
from ..cluster.objects import (
    CONTROLLER_REVISION_HASH_LABEL,
    get_annotation,
    make_controller_revision,
    name_of,
)
from ..obs import events as events_mod
from ..obs import history as history_mod
from ..upgrade import consts, util
from ..upgrade.analysis import history_key, resolve_metric

logger = logging.getLogger(__name__)

#: Decision targets for cell events read ``cell:<name>`` — unambiguous
#: beside node targets in a merged stream.
CELL_TARGET_PREFIX = "cell:"

#: Cell phases (the ``federation_cell_phase`` gauge's vocabulary lives
#: in :data:`~..metrics.FEDERATION_PHASE_CODES`).
PHASE_PENDING = "pending"
PHASE_ROLLING = "rolling"
PHASE_SOAKING = "soaking"
PHASE_PROMOTED = "promoted"
PHASE_HELD = "held"
PHASE_BREACHED = "breached"
PHASE_UNREACHABLE = "unreachable"
#: Ordinary wave-order waiting (predecessors not yet promoted, breaker
#: closed) — distinct from HELD so the ``federation_cells_held`` gauge
#: and its alert fire only on ABNORMAL holds, not on every cell behind
#: the in-flight one during a healthy multi-hour wave.
PHASE_QUEUED = "queued"


def cell_target(name: str) -> str:
    return CELL_TARGET_PREFIX + name


@dataclass
class Cell:
    """One cell handle: the cluster plus (optionally) its local
    manager.  The coordinator only NEEDS the ``ClusterClient`` —
    census, admission and the persisted audit all ride the protocol —
    but a wired manager/policy unlocks the live SLO report (advanceOn
    conditions) and the coordinator-driven LKG rollback
    (:meth:`trip`)."""

    name: str
    cluster: object
    namespace: str
    selector: Dict[str, str]
    #: Local :class:`~..upgrade.upgrade_state.ClusterUpgradeStateManager`
    #: (optional — None for a purely remote/offline cell).
    manager: Optional[object] = None
    #: The cell's own UpgradePolicySpec (the trip hook needs its
    #: remediation block).
    policy: Optional[object] = None
    #: The cell's decision log (multi-cell processes give each cell its
    #: own so per-cluster streams stay per-cluster); None = whatever
    #: the process default is when the hook runs.
    log: Optional[events_mod.DecisionEventLog] = None
    #: Override returning the cell's SLO report dict (tests/offline);
    #: None = the manager's live ``slo_status``.
    slo_source: Optional[Callable[[], Optional[dict]]] = None

    def slo_report(self) -> Optional[dict]:
        if self.slo_source is not None:
            return self.slo_source()
        if self.manager is not None:
            status = getattr(self.manager, "slo_status", None)
            if status is not None:
                return status()
        return None

    def trip(self, reason: str) -> bool:
        """Drive this cell's breaker/LKG-rollback machinery off a
        FEDERATION verdict (the existing ``trip_for_slo`` path with
        event reason ``federation``).  Returns False when the cell has
        no manager/policy (or no remediation block) to drive."""
        if self.manager is None or self.policy is None:
            return False
        if getattr(self.policy, "remediation", None) is None:
            return False
        previous = None
        if self.log is not None:
            previous = events_mod.set_default_log(self.log)
        try:
            state = self.manager.build_state(self.namespace, self.selector)
            decision = self.manager.remediation.trip_for_slo(
                state,
                self.policy,
                self.manager.common,
                reason,
                event_reason=events_mod.REASON_FEDERATION,
            )
            # the trip decision must reach the cell's persisted audit
            # trail even between reconciles
            pump = getattr(self.manager, "_pump_decision_events", None)
            if pump is not None:
                pump()
            return decision is not None
        except (ApiError, OSError) as err:
            logger.warning(
                "federation: trip of cell %s failed: %s", self.name, err
            )
            return False
        finally:
            if previous is not None:
                events_mod.set_default_log(previous)


def _selector_string(selector: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(selector.items()))


def cell_census(
    cell: Cell,
    target: str,
    window_seconds: float,
    now: Optional[float] = None,
) -> Optional[dict]:
    """One cell's point-in-time rollout accounting, computed purely
    through the ``ClusterClient`` protocol (an HTTP cell costs three
    LISTs).  Returns None when the cell's apiserver is unreachable —
    the coordinator treats that as *unknown*, holds later admissions,
    and retries next tick (a dead cell must pause the wave, never
    crash the coordinator or be presumed healthy)."""
    now_ts = time.time() if now is None else now
    try:
        pods = cell.cluster.list(
            "Pod",
            namespace=cell.namespace,
            label_selector=_selector_string(cell.selector),
        )
        nodes = cell.cluster.list("Node")
        daemon_sets = cell.cluster.list(
            "DaemonSet", namespace=cell.namespace
        )
        revisions = cell.cluster.list(
            "ControllerRevision", namespace=cell.namespace
        )
    except (ApiError, OSError) as err:
        logger.debug("federation: cell %s unreachable: %s", cell.name, err)
        return None

    owner_names = set()
    pod_revision: Dict[str, str] = {}
    for pod in pods:
        node = (pod.get("spec") or {}).get("nodeName") or ""
        if not node:
            continue
        pod_revision[node] = (
            (pod.get("metadata") or {}).get("labels") or {}
        ).get(CONTROLLER_REVISION_HASH_LABEL, "")
        for ref in (pod.get("metadata") or {}).get("ownerReferences") or []:
            if ref.get("kind") == "DaemonSet" and ref.get("name"):
                owner_names.add(ref["name"])
    managed = set(pod_revision)

    ds_objs = [ds for ds in daemon_sets if name_of(ds) in owner_names]
    if not ds_objs and daemon_sets:
        ds_objs = list(daemon_sets)

    newest_hash = ""
    newest_rev = -1
    for cr in revisions:
        if not any(
            name_of(cr).startswith(name_of(ds) + "-") for ds in ds_objs
        ):
            continue
        rev = int(cr.get("revision") or 0)
        if rev > newest_rev:
            newest_rev = rev
            newest_hash = (
                (cr.get("metadata") or {}).get("labels") or {}
            ).get(CONTROLLER_REVISION_HASH_LABEL, "")

    state_key = util.get_upgrade_state_label_key()
    admitted_key = util.get_admitted_at_annotation_key()
    breaker_key = util.get_breaker_annotation_key()
    idle_states = ("", consts.UPGRADE_STATE_DONE)
    failed = 0
    failed_now = 0
    attempted = 0
    active = 0
    at_target = 0
    for node in nodes:
        node_name = (node.get("metadata") or {}).get("name") or ""
        if node_name not in managed:
            continue
        meta = node.get("metadata") or {}
        state = (meta.get("labels") or {}).get(state_key, "")
        raw = (meta.get("annotations") or {}).get(admitted_key)
        try:
            admitted_at = float(raw) if raw else 0.0
        except ValueError:
            admitted_at = 0.0
        in_window = bool(admitted_at) and now_ts - admitted_at < window_seconds
        if state == consts.UPGRADE_STATE_FAILED:
            # failed_now is the RAW count (the breaker-release latch);
            # the ratio numerator is window-bounded like the attempts —
            # a FAILED label left over from an old incident (admission
            # stamp outside the window, or never admitted) must not
            # trip a fresh wave's breaker, mirroring the per-cluster
            # remediation census's failures-window-bounded rule
            failed_now += 1
            if in_window:
                failed += 1
        if state not in idle_states:
            active += 1
        if in_window:
            attempted += 1
        if state in idle_states and pod_revision.get(node_name) == target:
            at_target += 1

    breaker = None
    for ds in ds_objs:
        raw = get_annotation(ds, breaker_key)
        if raw:
            try:
                parsed = json.loads(raw)
            except ValueError:
                parsed = None
            if isinstance(parsed, dict):
                breaker = parsed
                break

    total = len(managed)
    return {
        "total": total,
        "failed": failed,
        "failedNow": failed_now,
        "attempted": attempted,
        "active": active,
        "atTarget": at_target,
        "completed": total > 0 and at_target == total,
        "published": bool(newest_hash) and newest_hash == target,
        "newestRevision": newest_hash,
        "localBreaker": breaker,
        "dsNames": [name_of(ds) for ds in ds_objs],
    }


def publish_target(cell: Cell, census: dict, target: str) -> bool:
    """Admit the cell: publish *target* as the newest
    ControllerRevision of each driver DaemonSet (the cell's own
    manager/DS-controller takes it from there).  Idempotent — an
    already-newest target is a no-op."""
    if census.get("published"):
        return False
    published = False
    try:
        revisions = cell.cluster.list(
            "ControllerRevision", namespace=cell.namespace
        )
        daemon_sets = {
            name_of(ds): ds
            for ds in cell.cluster.list(
                "DaemonSet", namespace=cell.namespace
            )
            if name_of(ds) in set(census.get("dsNames") or [])
        }
        for ds_name, ds in sorted(daemon_sets.items()):
            newest = 0
            newest_hash = ""
            for cr in revisions:
                if not name_of(cr).startswith(ds_name + "-"):
                    continue
                rev = int(cr.get("revision") or 0)
                if rev > newest:
                    newest = rev
                    newest_hash = (
                        (cr.get("metadata") or {}).get("labels") or {}
                    ).get(CONTROLLER_REVISION_HASH_LABEL, "")
            if newest_hash == target:
                continue
            try:
                cell.cluster.create(
                    make_controller_revision(ds, newest + 1, target)
                )
                published = True
            except AlreadyExistsError:
                # a crashed previous coordinator already created it but
                # died before recording the admission: adopt
                published = True
    except (ApiError, OSError) as err:
        logger.warning(
            "federation: publishing %s into cell %s failed: %s",
            target,
            cell.name,
            err,
        )
        return False
    return published


class FederationCoordinator:
    """Drives one :class:`~..api.federation_spec.FederationPolicySpec`
    over N :class:`Cell` handles.  :meth:`evaluate` is one tick —
    census every cell, promote/admit/hold per the wave order, roll the
    failure budgets up into the global breaker — and is safe to call
    from any loop cadence (all state is re-derived from cluster-
    resident facts plus the persisted federation record)."""

    def __init__(
        self,
        spec: FederationPolicySpec,
        cells: List[Cell],
        audit_cell: Optional[str] = None,
        log: Optional[events_mod.DecisionEventLog] = None,
        sink: Optional[events_mod.ClusterDecisionEventSink] = None,
    ) -> None:
        spec.validate()
        by_name = {c.name: c for c in cells}
        missing = [c.name for c in spec.cells if c.name not in by_name]
        if missing:
            raise ValueError(
                f"federation spec declares cells with no handle: {missing}"
            )
        self._spec = spec
        #: Handles in SPEC order — the wave order.
        self._cells: List[Cell] = [by_name[c.name] for c in spec.cells]
        audit_name = audit_cell or spec.cells[0].name
        if audit_name not in by_name:
            raise ValueError(f"unknown audit cell {audit_name!r}")
        self._audit_cell = by_name[audit_name]
        #: The coordinator's OWN decision log — cell managers emit into
        #: their own (usually the per-cell process default); mixing the
        #: two would persist every cell's node decisions into the audit
        #: cluster twice.
        self._log = log if log is not None else events_mod.DecisionEventLog()
        #: Optional persistence of the coordinator's decisions as real
        #: Events in the audit cell (the merged offline plane includes
        #: them); pumped once per evaluate.
        self._sink = sink
        #: Per-cell metrics-history ring: the sustained-condition
        #: substrate for ``advanceOn`` (same machinery as the analysis
        #: engine's inside one cluster).
        self._history: Dict[str, history_mod.MetricsHistory] = {
            c.name: history_mod.MetricsHistory() for c in self._cells
        }
        #: The durable record: per-cell stamps + the global breaker.
        #: Loaded lazily from the audit cell's DS annotation (restart
        #: resume); written back whenever it changes.
        self._record: Optional[dict] = None
        self._record_ds: Optional[str] = None
        self._last_status: Optional[dict] = None

    # ------------------------------------------------------------- plumbing
    @property
    def log(self) -> events_mod.DecisionEventLog:
        return self._log

    @property
    def spec(self) -> FederationPolicySpec:
        return self._spec

    def status(self) -> Optional[dict]:
        """The latest evaluate's report (the ``/debug/federation``
        payload); None before the first tick."""
        return self._last_status

    def explain_cell(self, name: str) -> Optional[dict]:
        """Live "why is cell Y not promoting" (see module-level
        :func:`explain_cell`)."""
        return explain_cell(name, self._last_status, self._log.events())

    def merged_decisions(self) -> List[dict]:
        """The LIVE merged audit trail: the coordinator's own stream
        plus every cell's persisted decision Events, globally ordered
        by the timestamp-first/seq-tiebreak rule.  When a sink is
        wired, the audit cell's cluster carries persisted COPIES of the
        coordinator's own decisions — those are recognized by the
        sink's src annotation (this log's instance id) and dropped in
        favor of the live originals, so the merged view never shows one
        decision twice while the audit cell's own distinct decisions
        (even same-type/reason/target collisions) are kept.  The
        offline path, which has no live log, keeps the persisted copies
        as the only copies; a prior coordinator's copies carry a
        different instance id and are likewise kept."""
        own = self._log.events()
        instance = self._log.instance
        streams: Dict[str, List[dict]] = {"federation": own}
        for cell in self._cells:
            decisions = events_mod.decisions_from_cluster(cell.cluster)
            if self._sink is not None and cell is self._audit_cell:
                decisions = [
                    d for d in decisions if d.get("src") != instance
                ]
            streams[cell.name] = decisions
        return events_mod.merge_cell_streams(streams)

    # ------------------------------------------------------------- record
    def _empty_record(self) -> dict:
        return {
            "target": self._spec.target_revision,
            "cells": {c.name: {} for c in self._cells},
            "breaker": None,
        }

    def _load_record(self) -> dict:
        if self._record is not None:
            return self._record
        key = util.get_federation_record_annotation_key()
        record = None
        try:
            for ds in self._audit_cell.cluster.list(
                "DaemonSet", namespace=self._audit_cell.namespace
            ):
                raw = get_annotation(ds, key)
                if raw:
                    try:
                        parsed = json.loads(raw)
                    except ValueError:
                        parsed = None
                    if (
                        isinstance(parsed, dict)
                        and parsed.get("target") == self._spec.target_revision
                    ):
                        record = parsed
                        self._record_ds = name_of(ds)
                        break
                if self._record_ds is None:
                    self._record_ds = name_of(ds)
        except (ApiError, OSError) as err:
            logger.warning(
                "federation: loading the record from audit cell %s "
                "failed (%s); starting fresh in memory",
                self._audit_cell.name,
                err,
            )
        self._record = record if record is not None else self._empty_record()
        # a record for a DIFFERENT target is a finished/abandoned wave
        self._record.setdefault("cells", {})
        for cell in self._cells:
            self._record["cells"].setdefault(cell.name, {})
        return self._record

    def _persist_record(self) -> None:
        if self._record is None or self._record_ds is None:
            return
        key = util.get_federation_record_annotation_key()
        try:
            self._audit_cell.cluster.patch(
                "DaemonSet",
                self._record_ds,
                {
                    "metadata": {
                        "annotations": {
                            key: json.dumps(self._record, sort_keys=True)
                        }
                    }
                },
                self._audit_cell.namespace,
            )
        except (ApiError, OSError) as err:
            logger.warning(
                "federation: persisting the record failed (%s); the "
                "in-memory copy stands until the next tick",
                err,
            )

    # ------------------------------------------------------------ evaluate
    def evaluate(self, now: Optional[float] = None) -> dict:
        """One coordinator tick.  Returns the status report (also
        served by :meth:`status` until the next tick)."""
        now_ts = time.time() if now is None else now
        spec = self._spec
        breaker_spec = spec.global_breaker
        record = self._load_record()
        if self._record_ds is None and not any(
            record["cells"].values()
        ) and record.get("breaker") is None:
            # the audit cell was unreachable at first load and nothing
            # has happened in memory yet: retry the full load (a
            # previous coordinator's persisted record may be waiting).
            # Once the in-memory record carries state, never discard it
            # for a reload — an audit cell that STAYS down must not
            # reset the wave every tick.
            self._record = None
            record = self._load_record()
        changed = False

        censuses: Dict[str, Optional[dict]] = {}
        slo_reports: Dict[str, Optional[dict]] = {}
        for cell in self._cells:
            censuses[cell.name] = cell_census(
                cell,
                spec.target_revision,
                breaker_spec.window_seconds,
                now=now_ts,
            )
            slo_reports[cell.name] = cell.slo_report()

        # ---- per-cell facts: completion stamps + condition history
        for cell_spec, cell in zip(spec.cells, self._cells):
            facts = record["cells"][cell.name]
            census = censuses[cell.name]
            if census is None:
                continue
            if census.get("published") and not facts.get("admittedAt"):
                # an externally-admitted cell (or a crash between the
                # CR create and the record write): adopt the admission
                facts["admittedAt"] = now_ts
                changed = True
            if facts.get("admittedAt") and not facts.get("completedAt"):
                if census["completed"]:
                    facts["completedAt"] = now_ts
                    changed = True
            if facts.get("admittedAt") and not facts.get("promotedAt"):
                self._record_condition_samples(
                    cell_spec, slo_reports[cell.name], now_ts
                )

        # ---- failure-budget rollup → the global breaker
        breached: Dict[str, str] = {}
        failures = 0
        attempted = 0
        for cell in self._cells:
            census = censuses[cell.name]
            if census is None:
                continue
            failures += census["failed"]
            attempted += census["attempted"]
            reason = self._cell_breach(census, breaker_spec)
            if reason:
                breached[cell.name] = reason
        ratio = failures / attempted if attempted else 0.0
        breaker = record.get("breaker")
        open_ = breaker is not None and breaker.get("state") == "open"
        if not open_:
            trip_reason = ""
            if len(breached) >= breaker_spec.max_breached_cells:
                trip_reason = (
                    f"{len(breached)} cell(s) breached their failure "
                    f"budget: "
                    + "; ".join(
                        f"{n} ({breached[n]})" for n in sorted(breached)
                    )
                )
            elif (
                attempted >= max(1, breaker_spec.min_attempted)
                and ratio >= breaker_spec.failure_threshold
            ):
                trip_reason = (
                    f"aggregate failure ratio {ratio:.2f} over "
                    f"{attempted} attempted nodes crossed "
                    f"{breaker_spec.failure_threshold:g} fleet-wide"
                )
                # an aggregate trip charges the cells CONTRIBUTING
                # failures even if none crossed its own threshold: the
                # release latch and the rollback drive key off this
                # list, and an empty one would make both vacuous
                for cell in self._cells:
                    census = censuses.get(cell.name)
                    if (
                        census is not None
                        and census["failed"]
                        and cell.name not in breached
                    ):
                        breached[cell.name] = (
                            f"{census['failed']} failed node(s) "
                            "contributing to the aggregate breach"
                        )
            if trip_reason:
                breaker = {
                    "state": "open",
                    "target": spec.target_revision,
                    "trippedAt": now_ts,
                    "reason": trip_reason,
                    "breachedCells": sorted(breached),
                    "rolledBackCells": [],
                    "failures": failures,
                    "attempted": attempted,
                }
                record["breaker"] = breaker
                changed = True
                open_ = True
                metrics.record_federation_trip()
                self._log.emit(
                    events_mod.EVENT_BREAKER_TRIPPED,
                    events_mod.REASON_FEDERATION,
                    events_mod.FLEET_TARGET,
                    "federation breaker tripped: " + trip_reason,
                    now=now_ts,
                )
                logger.warning(
                    "federation breaker tripped: %s", trip_reason
                )
                if self._drive_rollbacks(
                    record, breaker, censuses, trip_reason
                ):
                    changed = True
        elif open_ and breaker is not None:
            # the breaker stands: RETRY any rollback drive that failed
            # transiently at trip time (trip_for_slo is re-trip-guarded
            # per target, and rolledBackCells bounds the re-walk to
            # cells not yet successfully driven — a one-blip apiserver
            # must not leave a breached cell running the bad revision
            # for the episode's whole life)
            if self._drive_rollbacks(
                record, breaker, censuses, str(breaker.get("reason", ""))
            ):
                changed = True
        if open_ and (
            not breached
            and ratio < breaker_spec.failure_threshold
            and self._breached_cells_recovered(breaker, censuses)
        ):
            # every breached cell DEMONSTRABLY recovered (zero
            # currently-failed nodes, local breaker closed): the
            # episode closes and fresh admissions resume.  The third
            # clause is the latch: failure evidence merely AGING out of
            # the census window (a hold-only cell nobody repaired) must
            # not release the breaker and resume publishing the same
            # bad revision.
            record["breaker"] = None
            changed = True
            open_ = False
            logger.info(
                "federation breaker released: breached cells recovered"
            )

        # ---- promotion (in wave order; a cascade of promotions in one
        # tick is legal — a fast canary may complete within a tick)
        for ordinal, (cell_spec, cell) in enumerate(
            zip(spec.cells, self._cells)
        ):
            facts = record["cells"][cell.name]
            if facts.get("promotedAt") or not facts.get("completedAt"):
                continue
            if cell.name in breached:
                continue
            soak_left = self._soak_remaining(cell_spec, facts, now_ts)
            if soak_left > 0:
                continue
            if not self._conditions_hold(cell_spec, now_ts):
                continue
            facts["promotedAt"] = now_ts
            changed = True
            metrics.record_cell_promotion()
            self._log.emit(
                events_mod.EVENT_CELL_PROMOTED,
                events_mod.REASON_CELL_PROMOTE,
                cell_target(cell.name),
                f"cell {cell.name} promoted (rollout complete, soak + "
                f"advance conditions satisfied; ordinal {ordinal})",
                now=now_ts,
            )

        # ---- admission: the first unadmitted cell, strictly in order
        next_cell = None
        next_spec = None
        for cell_spec, cell in zip(spec.cells, self._cells):
            if not record["cells"][cell.name].get("admittedAt"):
                next_cell, next_spec = cell, cell_spec
                break
        if next_cell is not None:
            census = censuses[next_cell.name]
            predecessors = []
            for cell_spec, cell in zip(spec.cells, self._cells):
                if cell.name == next_cell.name:
                    break
                if not record["cells"][cell.name].get("promotedAt"):
                    predecessors.append(cell.name)
            if open_:
                self._log.emit(
                    events_mod.EVENT_CELL_HELD,
                    events_mod.REASON_FEDERATION_GATE,
                    cell_target(next_cell.name),
                    "global breaker open: "
                    + str((record.get("breaker") or {}).get("reason", "")),
                    now=now_ts,
                )
            elif predecessors:
                self._log.emit(
                    events_mod.EVENT_CELL_HELD,
                    events_mod.REASON_CELL_HOLD,
                    cell_target(next_cell.name),
                    "waiting for earlier cell(s) to promote: "
                    + ", ".join(predecessors),
                    now=now_ts,
                )
            elif census is None:
                self._log.emit(
                    events_mod.EVENT_CELL_HELD,
                    events_mod.REASON_CELL_HOLD,
                    cell_target(next_cell.name),
                    f"cell {next_cell.name} unreachable; admission "
                    "deferred until its apiserver answers",
                    now=now_ts,
                )
            else:
                if publish_target(
                    next_cell, census, spec.target_revision
                ) or census.get("published"):
                    record["cells"][next_cell.name]["admittedAt"] = now_ts
                    changed = True
                    self._log.emit(
                        events_mod.EVENT_CELL_ADMITTED,
                        events_mod.REASON_CELL_PROMOTE,
                        cell_target(next_cell.name),
                        f"cell {next_cell.name} admitted: target "
                        f"{spec.target_revision} published "
                        f"(wave position "
                        f"{spec.cell_names().index(next_cell.name)})",
                        now=now_ts,
                    )
                    censuses[next_cell.name] = cell_census(
                        next_cell,
                        spec.target_revision,
                        breaker_spec.window_seconds,
                        now=now_ts,
                    )

        if changed:
            self._persist_record()
        status = self._assemble_status(
            record, censuses, slo_reports, breached,
            failures, attempted, ratio, now_ts,
        )
        self._publish_gauges(status)
        if self._sink is not None:
            try:
                self._sink.pump(self._log)
            except Exception:  # noqa: BLE001 — audit must not break the wave
                logger.warning(
                    "federation: decision sink pump failed", exc_info=True
                )
        self._last_status = status
        return status

    # ------------------------------------------------------------- helpers
    def _breached_cells_recovered(
        self, breaker: Optional[dict], censuses: Dict[str, Optional[dict]]
    ) -> bool:
        """True when every cell the standing breaker record charged is
        demonstrably healthy NOW: reachable, zero currently-FAILED
        managed nodes (the raw ``failedNow`` count, deliberately
        unwindowed — wreckage does not age into health), and no open
        local breaker.  A record with NO charged cells (a pre-upgrade
        persisted record) falls back to requiring EVERY cell healthy —
        an empty list must never make the latch vacuous."""
        names = (breaker or {}).get("breachedCells") or [
            c.name for c in self._cells
        ]
        for name in names:
            census = censuses.get(name)
            if census is None:
                return False
            if census.get("failedNow"):
                return False
            local = census.get("localBreaker")
            if local is not None and local.get("state") == "open":
                return False
        return True

    @staticmethod
    def _cell_breach(census: dict, breaker_spec) -> str:
        """Why this cell counts as breached, or '' when healthy."""
        local = census.get("localBreaker")
        if local is not None and local.get("state") == "open":
            return "local breaker open: " + str(local.get("reason", ""))
        attempted = census["attempted"]
        if attempted >= max(1, breaker_spec.cell_min_attempted):
            cell_ratio = census["failed"] / attempted
            if cell_ratio >= breaker_spec.cell_failure_threshold:
                return (
                    f"{census['failed']}/{attempted} attempted nodes "
                    f"failed (threshold "
                    f"{breaker_spec.cell_failure_threshold:g})"
                )
        return ""

    def _drive_rollbacks(
        self,
        record: dict,
        breaker: dict,
        censuses: Dict[str, Optional[dict]],
        trip_reason: str,
    ) -> bool:
        """Drive the per-cell trip/LKG-rollback machinery in the
        breaker record's charged cells (and, per the spec, already-
        promoted cells on the target).  Successfully driven cells are
        recorded in ``breaker["rolledBackCells"]`` so each later tick
        with the breaker standing retries ONLY the cells a transient
        error skipped (trip_for_slo is re-trip-guarded per target, so
        a retry against an already-tripped cell is a no-op even if the
        bookkeeping was lost to a crash).  Cells without a manager
        handle degrade to hold-only (warned once per episode via the
        same list).  Returns True when the record changed."""
        breaker_spec = self._spec.global_breaker
        done = set(breaker.get("rolledBackCells") or [])
        breached_names = set(breaker.get("breachedCells") or [])
        targets: List[Cell] = []
        if breaker_spec.rollback_breached:
            targets.extend(
                c for c in self._cells if c.name in breached_names
            )
        if breaker_spec.rollback_promoted:
            for cell in self._cells:
                facts = record["cells"][cell.name]
                census = censuses.get(cell.name)
                if (
                    cell.name not in breached_names
                    and facts.get("promotedAt")
                    and census is not None
                    and census.get("newestRevision")
                    == self._spec.target_revision
                ):
                    targets.append(cell)
        changed = False
        for cell in targets:
            if cell.name in done:
                continue
            reason = (
                f"[{events_mod.REASON_FEDERATION_GATE}] global federation "
                f"breaker: {trip_reason}"
            )
            if cell.trip(reason):
                done.add(cell.name)
                changed = True
            elif cell.manager is None or cell.policy is None or getattr(
                cell.policy, "remediation", None
            ) is None:
                # no hook to ever succeed: record it as handled so the
                # hold-only degradation is warned once, not every tick
                logger.warning(
                    "federation: cell %s has no trip hook (manager/"
                    "policy/remediation missing) — held only, not "
                    "rolled back",
                    cell.name,
                )
                done.add(cell.name)
                changed = True
        if changed:
            breaker["rolledBackCells"] = sorted(done)
        return changed

    def _record_condition_samples(
        self,
        cell_spec: FederationCellSpec,
        slo_report: Optional[dict],
        now_ts: float,
    ) -> None:
        if not cell_spec.advance_on:
            return
        history = self._history[cell_spec.name]
        samples: Dict[str, float] = {}
        for cond in cell_spec.parsed_advance():
            value = resolve_metric(cond.metric, slo_report)
            if value is not None:
                samples[history_key(cond.metric)] = float(value)
        # record UNCONDITIONALLY (an empty dict still advances the
        # ring's generation counter): a cell whose SLO source goes
        # silent mid-rollout must see its series go STALE within a few
        # ticks — never satisfy `holds` from an hour-old frozen sample
        # (the same rule SloEngine.evaluate applies inside one cluster)
        history.record(samples, now=now_ts)

    def _conditions_hold(
        self, cell_spec: FederationCellSpec, now_ts: float
    ) -> bool:
        history = self._history[cell_spec.name]
        for cond in cell_spec.parsed_advance():
            if not history.holds(
                history_key(cond.metric),
                cond.op,
                cond.value,
                for_seconds=cond.for_seconds,
                now=now_ts,
            ):
                return False
        return True

    @staticmethod
    def _soak_remaining(
        cell_spec: FederationCellSpec, facts: dict, now_ts: float
    ) -> float:
        completed_at = facts.get("completedAt")
        if not completed_at or cell_spec.soak_seconds <= 0:
            return 0.0
        return max(
            0.0, cell_spec.soak_seconds - (now_ts - float(completed_at))
        )

    def _condition_views(
        self,
        cell_spec: FederationCellSpec,
        slo_report: Optional[dict],
        now_ts: float,
    ) -> List[dict]:
        history = self._history[cell_spec.name]
        views = []
        for cond in cell_spec.parsed_advance():
            held = history.held_seconds(
                history_key(cond.metric), cond.op, cond.value, now=now_ts
            )
            views.append(
                {
                    "raw": cond.raw,
                    "value": resolve_metric(cond.metric, slo_report),
                    "satisfied": history.holds(
                        history_key(cond.metric),
                        cond.op,
                        cond.value,
                        for_seconds=cond.for_seconds,
                        now=now_ts,
                    ),
                    "heldForSeconds": (
                        round(held, 3) if held is not None else None
                    ),
                    "forSeconds": cond.for_seconds,
                }
            )
        return views

    def _assemble_status(
        self,
        record: dict,
        censuses: Dict[str, Optional[dict]],
        slo_reports: Dict[str, Optional[dict]],
        breached: Dict[str, str],
        failures: int,
        attempted: int,
        ratio: float,
        now_ts: float,
    ) -> dict:
        breaker = record.get("breaker")
        open_ = breaker is not None and breaker.get("state") == "open"
        cells_out: List[dict] = []
        held: List[str] = []
        promoted_durations: List[float] = []
        predecessors_promoted = True
        for ordinal, (cell_spec, cell) in enumerate(
            zip(self._spec.cells, self._cells)
        ):
            facts = record["cells"][cell.name]
            census = censuses.get(cell.name)
            slo_report = slo_reports.get(cell.name)
            eta = (slo_report or {}).get("eta")
            phase = self._phase(
                facts,
                census,
                cell.name in breached,
                open_,
                predecessors_promoted,
            )
            if phase in (PHASE_HELD, PHASE_BREACHED, PHASE_UNREACHABLE):
                held.append(cell.name)
            if facts.get("promotedAt") and facts.get("admittedAt"):
                promoted_durations.append(
                    float(facts["promotedAt"]) - float(facts["admittedAt"])
                )
            predecessors_promoted = predecessors_promoted and bool(
                facts.get("promotedAt")
            )
            entry = {
                "name": cell.name,
                "ordinal": ordinal,
                "phase": phase,
                "breached": cell.name in breached,
                "breachReason": breached.get(cell.name, ""),
                "admittedAt": facts.get("admittedAt"),
                "completedAt": facts.get("completedAt"),
                "promotedAt": facts.get("promotedAt"),
                "soakRemainingSeconds": round(
                    self._soak_remaining(cell_spec, facts, now_ts), 3
                ),
                "conditions": self._condition_views(
                    cell_spec, slo_report, now_ts
                ),
                "eta": eta,
                "burnRates": (
                    ((slo_report or {}).get("slos") or {}).get("burnRates")
                    or {}
                ),
            }
            if census is not None:
                entry.update(
                    {
                        "total": census["total"],
                        "failed": census["failed"],
                        "attempted": census["attempted"],
                        "atTarget": census["atTarget"],
                        "completed": census["completed"],
                        "published": census["published"],
                        "localBreaker": census["localBreaker"],
                    }
                )
            else:
                entry["unreachable"] = True
            cells_out.append(entry)

        eta_seconds = self._global_eta(
            record, censuses, slo_reports, promoted_durations, now_ts
        )
        return {
            "name": self._spec.name,
            "target": self._spec.target_revision,
            "cells": cells_out,
            "cellsTotal": len(self._cells),
            "promotedCells": sum(
                1 for c in cells_out if c["phase"] == PHASE_PROMOTED
            ),
            "heldCells": held,
            "breaker": breaker,
            "breachedCells": sorted(breached),
            "failures": failures,
            "attempted": attempted,
            "ratio": round(ratio, 4),
            "eta": (
                {"seconds": round(eta_seconds, 3)}
                if eta_seconds is not None
                else None
            ),
            "evaluatedAt": round(now_ts, 3),
        }

    @staticmethod
    def _phase(
        facts: dict,
        census: Optional[dict],
        breached: bool,
        breaker_open: bool,
        predecessors_promoted: bool,
    ) -> str:
        if census is None:
            return PHASE_UNREACHABLE
        if breached:
            return PHASE_BREACHED
        if facts.get("promotedAt"):
            return PHASE_PROMOTED
        if facts.get("completedAt"):
            return PHASE_SOAKING
        if facts.get("admittedAt"):
            return PHASE_ROLLING
        if breaker_open:
            return PHASE_HELD
        if not predecessors_promoted:
            return PHASE_QUEUED
        return PHASE_PENDING

    def _global_eta(
        self,
        record: dict,
        censuses: Dict[str, Optional[dict]],
        slo_reports: Dict[str, Optional[dict]],
        promoted_durations: List[float],
        now_ts: float,
    ) -> Optional[float]:
        """The fleet-of-fleets ETA rollup: the in-flight cell's own
        ``rollout_eta_seconds`` (its SLO engine's projection) plus
        remaining soak, plus — for still-pending cells — the median
        promoted-cell duration as the per-cell estimate.  None
        (gauge -1) when nothing is projectable yet; 0 when every cell
        promoted.  Deliberately simple and documented
        (docs/federation.md) rather than clever: the rollup's job is a
        stable trend line, not a prophecy."""
        total = 0.0
        known = False
        pending = 0
        for cell_spec, cell in zip(self._spec.cells, self._cells):
            facts = record["cells"][cell.name]
            if facts.get("promotedAt"):
                known = True
                continue
            if facts.get("completedAt"):
                total += self._soak_remaining(cell_spec, facts, now_ts)
                known = True
                continue
            if facts.get("admittedAt"):
                eta = ((slo_reports.get(cell.name) or {}).get("eta") or {})
                seconds = eta.get("seconds")
                if seconds is not None:
                    total += float(seconds) + cell_spec.soak_seconds
                    known = True
                else:
                    pending += 1
                continue
            pending += 1
        if pending:
            if not promoted_durations:
                return None
            total += pending * statistics.median(promoted_durations)
        return total if known or promoted_durations else None

    def _publish_gauges(self, status: dict) -> None:
        eta = (status.get("eta") or {}).get("seconds")
        metrics.publish_federation_gauges(
            status["cellsTotal"],
            len(status["heldCells"]),
            bool(
                status["breaker"]
                and status["breaker"].get("state") == "open"
            ),
            -1 if eta is None else eta,
            {c["name"]: c["phase"] for c in status["cells"]},
        )


# ----------------------------------------------------------------- explain
def explain_cell(
    name: str,
    status: Optional[dict],
    decisions: Optional[List[dict]] = None,
) -> Optional[dict]:
    """"Why is cell Y not promoting" as one machine-readable dict, or
    None when the federation does not know the cell (or has no status
    yet).  Pure function of (status report, decision stream) — the live
    coordinator passes its latest status + its own log; the offline
    path passes :func:`federation_report_from_clusters` + the merged
    persisted stream, and both produce the same ``reasonCode`` for the
    same fleet state."""
    if status is None:
        return None
    entry = None
    for cell in status.get("cells") or []:
        if cell.get("name") == name:
            entry = cell
            break
    if entry is None:
        return None
    target = cell_target(name)
    recent = [
        d
        for d in (decisions or [])
        if d.get("target") == target
        or (d.get("target") == events_mod.FLEET_TARGET
            and d.get("type") == events_mod.EVENT_BREAKER_TRIPPED)
    ]
    breaker = status.get("breaker")
    breaker_open = bool(breaker and breaker.get("state") == "open")
    phase = entry.get("phase")
    out = {
        "cell": name,
        "phase": phase,
        "ordinal": entry.get("ordinal"),
        "recentEvents": recent[-10:],
        "breachedCells": status.get("breachedCells") or [],
        "eta": entry.get("eta"),
    }
    if phase == PHASE_PROMOTED:
        verdict, code = "complete", events_mod.REASON_CELL_PROMOTE
        message = "cell promoted"
    elif phase == PHASE_BREACHED:
        verdict, code = "breached", events_mod.REASON_FEDERATION_GATE
        message = entry.get("breachReason") or "cell failure budget breached"
    elif phase == PHASE_UNREACHABLE:
        verdict, code = "unreachable", events_mod.REASON_CELL_HOLD
        message = "cell apiserver unreachable; wave holds"
    elif breaker_open and phase in (
        PHASE_HELD, PHASE_QUEUED, PHASE_PENDING
    ):
        verdict, code = "blocked", events_mod.REASON_FEDERATION_GATE
        cited = ", ".join(status.get("breachedCells") or []) or "unknown"
        message = (
            f"global breaker open (breaching cell(s): {cited}): "
            + str((breaker or {}).get("reason", ""))
        )
    elif phase in (PHASE_HELD, PHASE_QUEUED, PHASE_PENDING):
        verdict, code = "blocked", events_mod.REASON_CELL_HOLD
        waiting = [
            c["name"]
            for c in status.get("cells") or []
            if c.get("ordinal", 0) < (entry.get("ordinal") or 0)
            and c.get("phase") != PHASE_PROMOTED
        ]
        message = (
            "waiting for earlier cell(s) to promote: "
            + (", ".join(waiting) or "none")
        )
    elif phase == PHASE_SOAKING:
        verdict, code = "soaking", events_mod.REASON_CELL_HOLD
        unsatisfied = [
            c["raw"]
            for c in entry.get("conditions") or []
            if not c.get("satisfied")
        ]
        bits = []
        if entry.get("soakRemainingSeconds"):
            bits.append(f"soak {entry['soakRemainingSeconds']:.0f}s left")
        if unsatisfied:
            bits.append("conditions not yet holding: " + "; ".join(unsatisfied))
        message = ", ".join(bits) or "bake complete; promoting next tick"
    else:
        verdict, code = "in-progress", "in-progress"
        message = (
            f"rolling: {entry.get('atTarget', '?')}/"
            f"{entry.get('total', '?')} nodes at target"
        )
    out["verdict"] = verdict
    out["reasonCode"] = code
    out["message"] = message
    return out


def render_cell_explanation(explanation: dict) -> str:
    """Human rendering of an :func:`explain_cell` answer."""
    lines = [
        f"cell {explanation['cell']}: {explanation['verdict'].upper()} "
        f"[{explanation['reasonCode']}]",
        f"  phase: {explanation['phase']} — {explanation['message']}",
    ]
    eta = explanation.get("eta")
    if eta and eta.get("seconds") is not None:
        lines.append(f"  cell ETA: {eta['seconds']:.0f}s")
    events = explanation.get("recentEvents") or []
    if events:
        lines.append("  recent decisions:")
        for d in events[-5:]:
            lines.append("    " + events_mod.format_decision_line(d))
    return "\n".join(lines)


# ----------------------------------------------------------------- offline
def federation_report_from_clusters(
    spec: FederationPolicySpec,
    clusters: Dict[str, object],
    namespace: str,
    selector: Dict[str, str],
    audit_cell: Optional[str] = None,
    now: Optional[float] = None,
) -> dict:
    """The OFFLINE federation report: rebuild the same status dict the
    live coordinator serves, from per-cell cluster dumps alone — the
    persisted federation record (audit cell DS annotation) supplies the
    durable stamps + the global breaker, each cell's objects supply the
    census.  ``explain_cell`` over this report answers with the same
    reason codes as the live plane (contract-tested; the fedstatus
    selftest proves it end-to-end)."""
    cells = [
        Cell(
            name=cell_spec.name,
            cluster=clusters[cell_spec.name],
            namespace=namespace,
            selector=selector,
        )
        for cell_spec in spec.cells
        if cell_spec.name in clusters
    ]
    missing = [c.name for c in spec.cells if c.name not in clusters]
    if missing:
        raise ValueError(
            f"federation spec declares cells with no dump: {missing}"
        )
    coordinator = FederationCoordinator(
        spec, cells, audit_cell=audit_cell
    )
    now_ts = time.time() if now is None else now
    record = coordinator._load_record()
    breaker_spec = spec.global_breaker
    censuses: Dict[str, Optional[dict]] = {}
    slo_reports: Dict[str, Optional[dict]] = {}
    breached: Dict[str, str] = {}
    failures = 0
    attempted = 0
    for cell in cells:
        census = cell_census(
            cell, spec.target_revision, breaker_spec.window_seconds, now=now_ts
        )
        censuses[cell.name] = census
        slo_reports[cell.name] = None
        if census is not None:
            failures += census["failed"]
            attempted += census["attempted"]
            reason = FederationCoordinator._cell_breach(census, breaker_spec)
            if reason:
                breached[cell.name] = reason
    ratio = failures / attempted if attempted else 0.0
    return coordinator._assemble_status(
        record, censuses, slo_reports, breached,
        failures, attempted, ratio, now_ts,
    )


def render_federation_report(status: dict) -> str:
    """Human rendering of the federation status (the ``fedstatus``
    CLI's default output)."""
    breaker = status.get("breaker")
    lines = [
        f"federation {status.get('name', '?')} → target "
        f"{status.get('target', '?')}: "
        f"{status.get('promotedCells', 0)}/{status.get('cellsTotal', 0)} "
        "cells promoted"
        + (
            "  [GLOBAL BREAKER OPEN]"
            if breaker and breaker.get("state") == "open"
            else ""
        )
    ]
    if breaker:
        lines.append(
            f"  breaker: {breaker.get('state')} — {breaker.get('reason', '')}"
        )
    eta = status.get("eta")
    if eta and eta.get("seconds") is not None:
        lines.append(f"  global ETA: {eta['seconds']:.0f}s")
    lines.append(
        f"  fleet failure census: {status.get('failures', 0)}/"
        f"{status.get('attempted', 0)} attempted "
        f"(ratio {status.get('ratio', 0.0):g})"
    )
    for cell in status.get("cells") or []:
        bits = [f"  [{cell.get('ordinal')}] {cell.get('name')}: "
                f"{cell.get('phase')}"]
        if cell.get("unreachable"):
            bits.append("(unreachable)")
        else:
            bits.append(
                f"{cell.get('atTarget', 0)}/{cell.get('total', 0)} at target"
            )
            if cell.get("failed"):
                bits.append(f"failed={cell['failed']}")
        if cell.get("breached"):
            bits.append(f"BREACHED: {cell.get('breachReason', '')}")
        if cell.get("soakRemainingSeconds"):
            bits.append(f"soak {cell['soakRemainingSeconds']:.0f}s left")
        unsatisfied = [
            c["raw"]
            for c in cell.get("conditions") or []
            if not c.get("satisfied")
        ]
        if unsatisfied and cell.get("phase") == PHASE_SOAKING:
            bits.append("holding on: " + "; ".join(unsatisfied))
        lines.append(" ".join(bits))
    return "\n".join(lines)
