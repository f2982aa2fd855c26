"""RemediationManager — the detect→decide→recover loop.

The reference's state machine stops at *detection*: a failed canary
freezes the rollout (``api/upgrade_spec.py`` canary semantics), and a
failed node waits passively for its driver pod to come back in sync
(``common_manager.go:528-570``) — a bad driver revision parks the fleet
until a human intervenes.  This module closes the loop with three
cooperating parts, all opt-in via
:class:`~..api.upgrade_spec.RemediationSpec` on the policy:

* **last-known-good (LKG) tracker** — the first time a new target
  DaemonSet ControllerRevision is observed, the previous target is
  recorded as the LKG on a DaemonSet annotation
  (:func:`~.util.get_last_known_good_annotation_key`), so the rollback
  target survives operator restarts exactly like every other piece of
  state in this library;
* **fleet failure-budget circuit breaker** — a sliding-window census of
  upgrade-failed nodes (attributed to the current target revision via
  the per-episode ``failure-target`` annotation) plus upgrade-done nodes
  whose post-upgrade ``tpu/health`` probe is degraded, normalized by
  nodes attempted (admitted) inside the window.  On trip the breaker
  record is persisted on the DaemonSet, fresh admissions pause (the
  ``remediation`` gate beside canary/window/pacing), and with
  ``autoRollback`` the DaemonSet is reverted to the LKG revision — the
  *normal* state machine then drives every upgraded node back (done
  nodes go out-of-sync → upgrade-required; failed nodes ride the retry
  path below).  The breaker stops blocking the moment the observed
  target moves off the tripped revision (rollback landed, or a fixed
  revision was published), which is exactly what lets the rollback wave
  itself flow;
* **per-node retry budget** — entering ``upgrade-failed`` opens a
  failure *episode* (attempt counter + timestamp annotations); once the
  exponential backoff for the episode elapses AND the node's pod is out
  of sync with the target (i.e. a retry can actually change something —
  a new revision or the LKG is waiting), the node is transitioned
  ``upgrade-failed → upgrade-required`` and re-enters the wave.  After
  ``maxNodeAttempts`` failures the node is quarantined: a
  remediation-owned value in the SliceHealthManager quarantine
  annotation (so the slice-aware schedulers route around its domain) and
  a ``NoSchedule`` taint.  Quarantine and counters release when the node
  reaches ``upgrade-done`` with an in-sync pod (out-of-band repair).

Like the rest of the library, every decision is derived from
cluster-resident state (node/DS annotations), so remediation resumes
mid-rollback across operator crashes and HA failovers.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .. import metrics
from ..cluster.client import ClusterClient
from ..cluster.errors import ApiError, NotFoundError
from ..cluster.inmem import JsonObj
from ..cluster.objects import (
    CONTROLLER_REVISION_HASH_LABEL,
    is_owned_by,
    name_of,
    namespace_of,
    owner_references,
)
from ..obs import events as events_mod
from ..tpu import health, topology
from . import consts, util
from .common_manager import ClusterUpgradeState, CommonUpgradeManager
from .util import EventRecorder, log_event

logger = logging.getLogger(__name__)


def _parse_json_annotation(raw: Optional[str]) -> Optional[dict]:
    """A hand-edited/corrupted record must degrade to 'absent', never
    traceback the reconcile."""
    if not raw:
        return None
    try:
        out = json.loads(raw)
    except ValueError:
        return None
    return out if isinstance(out, dict) else None


def _annotations(obj: JsonObj) -> Dict[str, str]:
    return (obj.get("metadata") or {}).get("annotations") or {}


def is_remediation_quarantined(node: JsonObj) -> bool:
    """True when the retry budget quarantined this node (the value is
    remediation-prefixed; health-owned quarantines carry the bare
    domain id — see :class:`~..tpu.health.SliceHealthManager`)."""
    value = _annotations(node).get(util.get_quarantine_annotation_key()) or ""
    return value.startswith(consts.REMEDIATION_QUARANTINE_PREFIX)


@dataclass
class RemediationDecision:
    """One reconcile's remediation verdict (also the /debug payload)."""

    #: Fresh admissions blocked (breaker open for the current target).
    paused: bool = False
    reason: str = ""
    breaker: Optional[dict] = None
    #: LKG record per DaemonSet name: {"lkg": hash, "target": hash}.
    lkg: Dict[str, dict] = field(default_factory=dict)
    #: Current target revision hash (first DS; the census attribution key).
    target: str = ""
    failures: int = 0
    attempted: int = 0
    ratio: float = 0.0
    #: Domains the retry budget quarantined — the schedulers route
    #: around these regardless of policy.quarantine_degraded.
    quarantined_domains: frozenset = frozenset()
    quarantined_nodes: tuple = ()
    #: True while the fleet is being driven back to the LKG revision.
    rollback_active: bool = False

    def to_dict(self) -> dict:
        return {
            "paused": self.paused,
            "reason": self.reason,
            "breaker": self.breaker,
            "lastKnownGood": dict(self.lkg),
            "target": self.target,
            "failures": self.failures,
            "attempted": self.attempted,
            "ratio": round(self.ratio, 4),
            "quarantinedDomains": sorted(self.quarantined_domains),
            "quarantinedNodes": list(self.quarantined_nodes),
            "rollbackActive": self.rollback_active,
        }


class RemediationManager:
    """Breaker + LKG + retry budget, wired into the reconcile loop by
    :class:`~.upgrade_state.ClusterUpgradeStateManager`.

    :meth:`evaluate` runs before the phase loop (reads the fleet census,
    maintains the DS annotations, executes a rollback on trip) and
    returns the :class:`RemediationDecision` the admission phase
    consults; :meth:`process_failed_nodes` runs as a phase right after
    the reference self-heal processor (episode bookkeeping, backoff'd
    retries, quarantine).
    """

    def __init__(
        self,
        cluster: ClusterClient,
        provider,
        recorder: Optional[EventRecorder] = None,
    ) -> None:
        self._cluster = cluster
        self._provider = provider
        self._recorder = recorder
        self._last_decision: Optional[RemediationDecision] = None
        #: (ds name, annotation key) -> (rv at write, value) — this
        #: manager's own bookkeeping writes, overlaid on snapshot reads
        #: until the cache catches up (see :meth:`_fresh_ds`).
        self._written: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------- status
    def disable(self) -> None:
        """The policy no longer carries a remediation block (or the
        policy CR is gone): retire the published decision and zero the
        gauges, so monitoring never reads a breaker as open on a fleet
        whose engine is off.  Idempotent and write-free when already
        disabled (called every non-remediation reconcile)."""
        if self._last_decision is not None:
            self._last_decision = None
            metrics.publish_remediation_gauges(False, 0)

    def last_status(self) -> Optional[dict]:
        """The most recent decision as a JSON-able dict (the
        ``/debug/remediation`` payload); None before the first pass."""
        decision = self._last_decision
        return None if decision is None else decision.to_dict()

    # ----------------------------------------------------------- evaluate
    def evaluate(
        self,
        state: ClusterUpgradeState,
        policy,
        common: CommonUpgradeManager,
        now: Optional[float] = None,
    ) -> RemediationDecision:
        spec = policy.remediation
        decision = RemediationDecision()
        if spec is None:
            self._last_decision = decision
            return decision
        now_ts = time.time() if now is None else now

        # ONE fleet pass collects everything fleet-wide the engine needs
        # (DS discovery, the attempted census, the quarantine census) —
        # an enabled feature costs one O(fleet) walk per reconcile, like
        # the canary and pacing gates, never several.
        daemon_sets: Dict[str, JsonObj] = {}
        admitted_key = util.get_admitted_at_annotation_key()
        attempted = 0
        q_nodes: List[str] = []
        q_domains: Set[str] = set()
        for ns in state.managed_node_states():
            ds = ns.driver_daemonset
            if ds is not None:
                daemon_sets.setdefault(name_of(ds), ds)
            ann = _annotations(ns.node)
            admitted_at = self._float_annotation(ann.get(admitted_key), 0.0)
            if admitted_at and now_ts - admitted_at < spec.window_seconds:
                attempted += 1
            if is_remediation_quarantined(ns.node):
                q_nodes.append(name_of(ns.node))
                q_domains.add(topology.domain_of(ns.node))
        decision.quarantined_nodes = tuple(sorted(q_nodes))
        decision.quarantined_domains = frozenset(q_domains)

        fresh_sets, primary, targets, breaker, _ = self._load_ds_records(
            daemon_sets, common
        )
        for ds_name, target in targets.items():
            decision.lkg[ds_name] = self._track_lkg(
                fresh_sets[ds_name], target, breaker
            )
        if primary is not None:
            decision.target = targets.get(name_of(primary), "")

        # ---- breaker failure census (attributed per target revision)
        failures, by_target = self._failure_census(
            state, set(targets.values()), spec, now_ts
        )
        decision.failures, decision.attempted = failures, attempted
        decision.ratio = failures / attempted if attempted else 0.0

        open_for_current = breaker is not None and (
            breaker.get("state") == "open"
            and breaker.get("target") in targets.values()
        )
        # A lingering record must not block a fresh trip: neither one for
        # an ABANDONED revision (rolled back, or a fix published past it)
        # nor a rolled-back record whose revision was RE-published (the
        # user retrying the same bad build — the breaker must trip and
        # roll back again, not sit disarmed in 'rolled-back').
        can_trip = primary is not None and not open_for_current
        if (
            can_trip
            and attempted >= max(1, spec.min_attempted)
            and decision.ratio >= spec.failure_threshold
        ):
            # The trip is charged to the revision actually failing —
            # with several driver DaemonSets in scope, recording the
            # (healthy) primary's hash would both skip the rollback of
            # the bad DS and wedge the breaker open forever (the
            # primary's hash never leaves the target set).
            trip_target = (
                max(by_target, key=lambda k: by_target[k])
                if by_target
                else decision.target
            )
            breaker = {
                "state": "open",
                "target": trip_target,
                "trippedAt": now_ts,
                "failures": failures,
                "attempted": attempted,
                "reason": (
                    f"{failures}/{attempted} nodes failed on revision "
                    f"{trip_target} (threshold "
                    f"{spec.failure_threshold:g})"
                ),
            }
            metrics.record_breaker_trip()
            events_mod.emit(
                events_mod.EVENT_BREAKER_TRIPPED,
                "failure-budget",
                events_mod.FLEET_TARGET,
                breaker["reason"],
            )
            log_event(
                self._recorder,
                util.get_component_name(),
                "Warning",
                util.get_event_reason(),
                "Remediation breaker TRIPPED: " + breaker["reason"],
            )
            logger.warning("remediation breaker tripped: %s", breaker["reason"])
            open_for_current = True

        if open_for_current and spec.auto_rollback and primary is not None:
            rolled = self._rollback(
                daemon_sets, targets, decision.lkg, breaker
            )
            if rolled:
                breaker["state"] = "rolled-back"
                breaker["rolledBackAt"] = now_ts
                open_for_current = False
                decision.rollback_active = True

        if breaker is not None and breaker.get("target") not in targets.values():
            # The tripped revision has been abandoned.  The record stays
            # (visibility: WHY the fleet is rolling back) while any
            # failure episode is still charged to it; once the wreckage
            # is cleaned the record retires so the gate reads closed.
            wreckage = any(
                _annotations(ns.node).get(
                    util.get_failure_target_annotation_key()
                )
                == breaker.get("target")
                for ns in state.nodes_in(consts.UPGRADE_STATE_FAILED)
            )
            if breaker.get("state") == "rolled-back":
                decision.rollback_active = decision.rollback_active or wreckage
            if not wreckage:
                breaker = None

        self._persist_breaker(primary, breaker)
        decision.breaker = breaker
        decision.paused = open_for_current
        if decision.paused:
            decision.reason = (
                "remediation breaker open: "
                + str((breaker or {}).get("reason", ""))
                + ("" if spec.auto_rollback else " (autoRollback off — "
                   "publish a fixed revision or roll back manually)")
            )

        metrics.publish_remediation_gauges(
            decision.paused, len(decision.quarantined_nodes)
        )
        self._last_decision = decision
        return decision

    def _load_ds_records(
        self, daemon_sets: Dict[str, JsonObj], common: CommonUpgradeManager
    ) -> tuple:
        """``(fresh_sets, primary, targets, breaker, lkg_records)`` off
        the (overlay-freshened) driver DaemonSets — the shared head of
        :meth:`evaluate` and :meth:`trip_for_slo`, so target resolution,
        first-DS-by-name primary selection, and breaker/LKG record
        parsing can never diverge between the failure-budget and SLO
        trip paths."""
        fresh_sets: Dict[str, JsonObj] = {}
        primary: Optional[JsonObj] = None
        targets: Dict[str, str] = {}
        breaker: Optional[dict] = None
        lkg_records: Dict[str, dict] = {}
        for ds_name in sorted(daemon_sets):
            fresh = self._fresh_ds(daemon_sets[ds_name])
            fresh_sets[ds_name] = fresh
            target = self._target_hash(common, fresh)
            if not target:
                continue
            targets[ds_name] = target
            if primary is None:
                primary = fresh
                breaker = _parse_json_annotation(
                    _annotations(fresh).get(util.get_breaker_annotation_key())
                )
            record = _parse_json_annotation(
                _annotations(fresh).get(
                    util.get_last_known_good_annotation_key()
                )
            )
            if record is not None:
                lkg_records[ds_name] = record
        return fresh_sets, primary, targets, breaker, lkg_records

    # ------------------------------------------------------ SLO-driven trip
    def trip_for_slo(
        self,
        state: ClusterUpgradeState,
        policy,
        common: CommonUpgradeManager,
        reason: str,
        now: Optional[float] = None,
        event_reason: str = "slo",
    ) -> Optional[RemediationDecision]:
        """Trip the breaker on an ANALYSIS verdict (a sustained SLO
        breach — see :mod:`.analysis`) instead of the failure census:
        the rollout is aborting on *slowness*, not breakage.  Persists
        the same breaker record the failure path writes (reason carries
        the analysis condition), pauses fresh admissions, and — under
        ``autoRollback`` — reverts to the last-known-good revision in
        the same pass, exactly like a failure-budget trip.  No-ops (and
        returns the standing decision) when the breaker is already open
        for the current target or the engine is off.

        *event_reason* is the decision-stream reason code the trip is
        audited under — ``"slo"`` for the analysis engine's aborts,
        ``"federation"`` when the federation coordinator drives this
        cell's rollback off the GLOBAL failure-budget rollup
        (:mod:`..federation`); it must stay registered in
        :data:`~..obs.events.EVENT_REASONS` for ``BreakerTripped``."""
        spec = getattr(policy, "remediation", None)
        if spec is None:
            return None
        now_ts = time.time() if now is None else now
        daemon_sets: Dict[str, JsonObj] = {}
        for ns in state.managed_node_states():
            if ns.driver_daemonset is not None:
                daemon_sets.setdefault(
                    name_of(ns.driver_daemonset), ns.driver_daemonset
                )
        fresh_sets, primary, targets, breaker, lkg_records = (
            self._load_ds_records(daemon_sets, common)
        )
        if primary is None:
            return self._last_decision
        trip_target = targets.get(name_of(primary), "")
        if breaker is not None and (
            (
                breaker.get("state") == "open"
                and breaker.get("target") in targets.values()
            )
            # A record (open OR rolled-back) already charged to this
            # very target: the abort latch is doing its job — re-tripping
            # every reconcile until the rollback becomes visible would
            # spam trips into the counter and the audit stream.
            or breaker.get("target") == trip_target
        ):
            return self._last_decision
        breaker = {
            "state": "open",
            "target": trip_target,
            "trippedAt": now_ts,
            "failures": 0,
            "attempted": 0,
            "reason": reason,
        }
        metrics.record_breaker_trip()
        events_mod.emit(
            events_mod.EVENT_BREAKER_TRIPPED,
            event_reason,
            events_mod.FLEET_TARGET,
            reason,
        )
        log_event(
            self._recorder,
            util.get_component_name(),
            "Warning",
            util.get_event_reason(),
            "Remediation breaker TRIPPED on SLO analysis: " + reason,
        )
        logger.warning("remediation breaker tripped on SLO: %s", reason)
        paused = True
        rollback_active = False
        if spec.auto_rollback:
            if self._rollback(fresh_sets, targets, lkg_records, breaker):
                breaker["state"] = "rolled-back"
                breaker["rolledBackAt"] = now_ts
                paused = False
                rollback_active = True
        self._persist_breaker(primary, breaker)
        previous = self._last_decision or RemediationDecision()
        decision = RemediationDecision(
            paused=paused,
            reason=(
                "remediation breaker open: " + reason
                if paused
                else previous.reason
            ),
            breaker=breaker,
            lkg=dict(previous.lkg) or dict(lkg_records),
            target=trip_target,
            failures=previous.failures,
            attempted=previous.attempted,
            ratio=previous.ratio,
            quarantined_domains=previous.quarantined_domains,
            quarantined_nodes=previous.quarantined_nodes,
            rollback_active=rollback_active,
        )
        metrics.publish_remediation_gauges(
            decision.paused, len(decision.quarantined_nodes)
        )
        self._last_decision = decision
        return decision

    # ------------------------------------------------------- failed phase
    def process_failed_nodes(
        self,
        state: ClusterUpgradeState,
        policy,
        common: CommonUpgradeManager,
        now: Optional[float] = None,
    ) -> None:
        """The retry-budget phase: episode bookkeeping, backoff'd
        ``failed → upgrade-required`` retries, quarantine on exhaustion.

        Full-bucket scan (not dirty-scoped): backoff expiry is
        wall-clock behavior — a parked node's inputs never change, yet
        its verdict flips when the clock does (the scan_scope contract
        in :class:`~.common_manager.ClusterUpgradeState`)."""
        spec = policy.remediation
        if spec is None:
            return
        now_ts = time.time() if now is None else now
        state_key = util.get_upgrade_state_label_key()
        attempt_key = util.get_attempt_count_annotation_key()
        failure_at_key = util.get_last_failure_at_annotation_key()
        failure_target_key = util.get_failure_target_annotation_key()
        for node_state in state.nodes_in(consts.UPGRADE_STATE_FAILED):
            node = node_state.node
            labels = (node.get("metadata") or {}).get("labels") or {}
            if labels.get(state_key) != consts.UPGRADE_STATE_FAILED:
                continue  # self-healed earlier in this pass
            ann = _annotations(node)
            attempts = self._int_annotation(ann.get(attempt_key))
            quarantined = is_remediation_quarantined(node)
            if failure_at_key not in ann:
                # New failure episode: count the attempt and stamp the
                # revision it was charged against (the breaker census
                # attribution).  Charged to the revision the pod actually
                # RAN — after a same-cycle rollback the DS target already
                # points at the LKG, and charging the bad revision's
                # wreckage to the LKG would re-trip the breaker against
                # the very revision the fleet is recovering to.
                attempts += 1
                target = (
                    (node_state.driver_pod.get("metadata") or {}).get(
                        "labels"
                    )
                    or {}
                ).get(CONTROLLER_REVISION_HASH_LABEL) or self._target_hash(
                    common, node_state.driver_daemonset
                )
                self._provider.change_node_upgrade_annotation(
                    node, attempt_key, str(attempts)
                )
                self._provider.change_node_upgrade_annotation(
                    node, failure_at_key, repr(now_ts)
                )
                if target:
                    self._provider.change_node_upgrade_annotation(
                        node, failure_target_key, target
                    )
                events_mod.emit(
                    events_mod.EVENT_NODE_UPGRADE_FAILED,
                    "attempt-failed",
                    name_of(node),
                    f"attempt {attempts} failed"
                    + (f" (revision {target})" if target else ""),
                )
                log_event(
                    self._recorder,
                    name_of(node),
                    "Warning",
                    util.get_event_reason(),
                    f"Upgrade attempt {attempts} failed"
                    + (
                        f" (revision {target})" if target else ""
                    ),
                )
            if (
                spec.max_node_attempts > 0
                and attempts >= spec.max_node_attempts
            ):
                if not quarantined:
                    self._quarantine(node)
                continue
            if quarantined:
                continue
            failed_at = self._float_annotation(ann.get(failure_at_key), now_ts)
            backoff = min(
                spec.backoff_max_seconds,
                spec.backoff_seconds * (2 ** max(0, attempts - 1)),
            )
            if now_ts - failed_at < backoff:
                continue
            attempt_label = f"attempt {attempts + 1}" + (
                f" of {spec.max_node_attempts}"
                if spec.max_node_attempts > 0
                else ""
            )
            # Two retry flavors, both of which can actually change the
            # outcome (re-running the same failure forever is what the
            # budget exists to prevent):
            synced, orphaned = common.pod_in_sync_with_ds(node_state)
            if not synced and not orphaned:
                # (a) the pod is OUT of sync — a new revision (or the
                # LKG rollback) is waiting: re-enter the wave.
                self._provider.change_node_upgrade_state(
                    node, consts.UPGRADE_STATE_UPGRADE_REQUIRED
                )
                # Episode closed by the retry; the attempt counter
                # persists until the node succeeds (release path) so the
                # budget accumulates across retries.
                self._provider.change_node_upgrade_annotation(
                    node, failure_at_key, consts.NULL_STRING
                )
                events_mod.emit(
                    events_mod.EVENT_NODE_RETRIED,
                    "resync",
                    name_of(node),
                    f"re-entered the wave ({attempt_label})",
                )
                log_event(
                    self._recorder,
                    name_of(node),
                    "Normal",
                    util.get_event_reason(),
                    f"Retrying upgrade ({attempt_label})",
                )
            elif (
                not orphaned
                and common.is_driver_pod_failing(node_state.driver_pod)
                and not (node_state.driver_pod.get("metadata") or {}).get(
                    "deletionTimestamp"
                )
            ):
                # (b) the pod IS at the target but storming — the repair
                # runbook codified: replace it so the DaemonSet recreates
                # it fresh (transient init faults, corrupted downloads).
                # The node stays in upgrade-failed; a healthy replacement
                # self-heals it, a broken one opens the next episode.
                pod = node_state.driver_pod
                try:
                    self._cluster.delete(
                        "Pod",
                        name_of(pod),
                        (pod.get("metadata") or {}).get("namespace", ""),
                    )
                except NotFoundError:
                    pass  # DaemonSet controller beat us to it
                except (ApiError, OSError) as err:
                    logger.warning(
                        "remediation: failed to replace driver pod on %s: "
                        "%s",
                        name_of(node),
                        err,
                    )
                    continue
                self._provider.change_node_upgrade_annotation(
                    node, failure_at_key, consts.NULL_STRING
                )
                events_mod.emit(
                    events_mod.EVENT_NODE_RETRIED,
                    "pod-replace",
                    name_of(node),
                    f"replaced failing driver pod ({attempt_label})",
                )
                log_event(
                    self._recorder,
                    name_of(node),
                    "Normal",
                    util.get_event_reason(),
                    f"Replacing failing driver pod ({attempt_label})",
                )

    def process_recovered_nodes(
        self,
        state: ClusterUpgradeState,
        policy,
        common: CommonUpgradeManager,
    ) -> None:
        """Phase 2b: release the retry bookkeeping (and quarantine +
        taint) of nodes back at done with an in-sync pod, and — engine
        on — un-admit pending nodes the rollback overtook.  The release
        half runs even when the policy carries NO remediation block:
        leftover quarantines from a since-removed block would otherwise
        keep their taint and keep their domain out of every future wave
        forever, with the engine-off gauges showing nothing wrong."""
        self._release_repaired(state, common)
        if getattr(policy, "remediation", None) is not None:
            self.process_reverted_pending_nodes(state, policy, common)

    def process_reverted_pending_nodes(
        self,
        state: ClusterUpgradeState,
        policy,
        common: CommonUpgradeManager,
    ) -> None:
        """Un-admit pending nodes the rollback overtook: a node moved
        ``done → upgrade-required`` by the bad revision whose pod is back
        IN sync after the LKG revert has nothing to upgrade — running it
        through the wave anyway would cordon and *drain real workloads*
        for a no-op.  The exact inverse of the done/unknown
        classification's out-of-sync test, so the two can never both
        claim a node.  Dirty-scoped: the verdict is a pure function of
        event-visible inputs (pod revision sync, the safe-load and
        requested annotations), and the rollback's ControllerRevision
        publish dirties the whole fleet anyway."""
        if policy.remediation is None:
            return
        state_key = util.get_upgrade_state_label_key()
        initial_key = util.get_upgrade_initial_state_annotation_key()
        for node_state in state.scan_scope(
            consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ):
            node = node_state.node
            labels = (node.get("metadata") or {}).get("labels") or {}
            if labels.get(state_key) != consts.UPGRADE_STATE_UPGRADE_REQUIRED:
                continue  # migrated earlier in this pass (cascade)
            if common.is_upgrade_requested(node):
                continue  # explicit request: honor it
            if common.safe_driver_load_manager.is_waiting_for_safe_driver_load(
                node
            ):
                continue
            if not common.is_driver_pod_in_sync(node_state):
                continue
            self._provider.change_node_upgrade_state(
                node, consts.UPGRADE_STATE_DONE
            )
            ann = _annotations(node)
            if initial_key in ann:
                self._provider.change_node_upgrade_annotation(
                    node, initial_key, consts.NULL_STRING
                )
            events_mod.emit(
                events_mod.EVENT_NODE_UNADMITTED,
                events_mod.REASON_ROLLBACK_OVERTOOK,
                name_of(node),
                "pod already at the target revision; returned to done "
                "without a wave pass",
            )
            log_event(
                self._recorder,
                name_of(node),
                "Normal",
                util.get_event_reason(),
                "Rollback overtook admission: pod already at the target "
                "revision; returning to done without a wave pass",
            )

    # ----------------------------------------------------------- plumbing
    @staticmethod
    def _int_annotation(raw: Optional[str]) -> int:
        try:
            return int(raw or 0)
        except (TypeError, ValueError):
            return 0

    @staticmethod
    def _float_annotation(raw: Optional[str], default: float) -> float:
        try:
            return float(raw)
        except (TypeError, ValueError):
            return default

    @staticmethod
    def _rv_of(obj: JsonObj) -> int:
        try:
            return int(
                (obj.get("metadata") or {}).get("resourceVersion") or 0
            )
        except (TypeError, ValueError):
            return 0

    def _fresh_ds(self, ds: JsonObj) -> JsonObj:
        """The DS with this manager's own bookkeeping writes overlaid.

        The snapshot copy can lag one cycle behind a write this manager
        just made (lagged informer cache) — but a per-cycle direct
        apiserver GET on the reconcile hot path would bypass the cache
        the rest of the library deliberately reads through (~20 extra
        round trips/s per DS at the active cadence).  Instead each write
        records (rv, value); the overlay applies only while the snapshot
        still serves an OLDER rv, so an out-of-band edit (e.g. an
        operator hand-deleting the breaker record to reset it) wins the
        moment the cache catches up."""
        overlay = [
            (key, rv, value)
            for (ds_name, key), (rv, value) in self._written.items()
            if ds_name == name_of(ds)
        ]
        if not overlay:
            return ds
        snapshot_rv = self._rv_of(ds)
        out = None
        for key, rv, value in overlay:
            if rv <= snapshot_rv:
                self._written.pop((name_of(ds), key), None)
                continue
            if out is None:
                out = dict(ds)
                out["metadata"] = dict(ds.get("metadata") or {})
                out["metadata"]["annotations"] = dict(
                    out["metadata"].get("annotations") or {}
                )
            if value is None:
                out["metadata"]["annotations"].pop(key, None)
            else:
                out["metadata"]["annotations"][key] = value
        return out if out is not None else ds

    @staticmethod
    def _target_hash(
        common: CommonUpgradeManager, ds: Optional[JsonObj]
    ) -> str:
        if ds is None:
            return ""
        try:
            return common.pod_manager.get_daemonset_controller_revision_hash(ds)
        except Exception:  # noqa: BLE001 — no revisions yet / stub manager
            return ""

    def _track_lkg(
        self, ds: JsonObj, target: str, breaker: Optional[dict]
    ) -> dict:
        """Advance the DS's LKG record for the observed *target*; returns
        the current record.  Writes only on change — an unconditional
        per-cycle DS patch would dirty the whole fleet in the state
        index every reconcile."""
        key = util.get_last_known_good_annotation_key()
        record = _parse_json_annotation(_annotations(ds).get(key))
        if record is None:
            record = {"lkg": target, "target": target}  # seed: nothing older
        elif record.get("target") == target:
            return record
        elif record.get("lkg") == target:
            # Rollback (ours or manual): the LKG is the target again —
            # do NOT record the abandoned revision as a new LKG.
            record = {"lkg": record["lkg"], "target": target}
        else:
            previous = record.get("target", target)
            tripped = breaker is not None and breaker.get("target") == previous
            # Roll-forward fix after a trip: the tripped revision must
            # never be promoted to LKG.
            record = {
                "lkg": record.get("lkg", previous) if tripped else previous,
                "target": target,
            }
        self._patch_ds_annotation(ds, key, json.dumps(record))
        return record

    def _persist_breaker(
        self, ds: Optional[JsonObj], breaker: Optional[dict]
    ) -> None:
        if ds is None:
            return
        key = util.get_breaker_annotation_key()
        current = _annotations(ds).get(key)
        wanted = None if breaker is None else json.dumps(breaker)
        if current == wanted or (current is None and wanted is None):
            return
        self._patch_ds_annotation(ds, key, wanted)

    def _patch_ds_annotation(
        self, ds: JsonObj, key: str, value: Optional[str]
    ) -> None:
        try:
            updated = self._cluster.patch(
                "DaemonSet",
                name_of(ds),
                {"metadata": {"annotations": {key: value}}},
                namespace_of(ds),
            )
        except (ApiError, OSError) as err:
            # Bookkeeping must never take the reconcile down; the next
            # pass re-derives and re-writes.
            logger.warning(
                "remediation: failed to patch DaemonSet %s annotation %s: %s",
                name_of(ds),
                key,
                err,
            )
            return
        # Overlay entry so next cycle's (possibly lagged) snapshot read
        # still sees this write — see _fresh_ds.
        self._written[(name_of(ds), key)] = (self._rv_of(updated), value)
        ds.setdefault("metadata", {}).setdefault("annotations", {})
        if value is None:
            ds["metadata"]["annotations"].pop(key, None)
        else:
            ds["metadata"]["annotations"][key] = value

    def _failure_census(
        self,
        state: ClusterUpgradeState,
        targets: Set[str],
        spec,
        now_ts: float,
    ) -> tuple:
        """(failures, failures_by_target) inside the sliding window:
        failed nodes whose episode is charged to a CURRENT target (a
        rolled-back revision's wreckage must not re-trip the breaker
        against the fixed one) + done nodes at a target whose TPU
        health degraded post-upgrade (done-at in-window).  The
        by-target breakdown picks WHICH revision a trip is recorded
        against (the failing one, not necessarily the primary DS's)."""
        done_key = util.get_done_at_annotation_key()
        failure_target_key = util.get_failure_target_annotation_key()
        window = spec.window_seconds
        failures = 0
        by_target: Dict[str, int] = {}
        for ns in state.nodes_in(consts.UPGRADE_STATE_FAILED):
            ann = _annotations(ns.node)
            # Window bound: a stale failure (chronic/quarantined node
            # whose episode opened before the window) must not trip the
            # breaker against a revision whose RECENT record is healthy —
            # only the trailing window's failures count, mirroring the
            # attempted census.  A missing stamp means the episode opened
            # this cycle: in-window by definition.
            failed_at = self._float_annotation(
                ann.get(util.get_last_failure_at_annotation_key()), now_ts
            )
            if now_ts - failed_at >= window:
                continue
            # Attribution: the stamped episode target, else the revision
            # the pod actually runs (an episode the failed phase has not
            # stamped yet — e.g. a crash between trip and stamping — must
            # not be charged to a just-rolled-back LKG target).
            episode_target = ann.get(failure_target_key) or (
                (ns.driver_pod.get("metadata") or {}).get("labels") or {}
            ).get(CONTROLLER_REVISION_HASH_LABEL)
            if episode_target is None or episode_target in targets:
                failures += 1
                if episode_target in targets:
                    by_target[episode_target] = (
                        by_target.get(episode_target, 0) + 1
                    )
        for ns in state.nodes_in(consts.UPGRADE_STATE_DONE):
            node = ns.node
            if not health.node_is_degraded(node):
                continue
            done_at = self._float_annotation(
                _annotations(node).get(done_key), 0.0
            )
            if not done_at or now_ts - done_at >= window:
                continue
            pod_hash = (
                (ns.driver_pod.get("metadata") or {}).get("labels") or {}
            ).get(CONTROLLER_REVISION_HASH_LABEL)
            if pod_hash in targets:
                failures += 1
                by_target[pod_hash] = by_target.get(pod_hash, 0) + 1
        return failures, by_target

    # ------------------------------------------------------------ rollback
    def _rollback(
        self,
        daemon_sets: Dict[str, JsonObj],
        targets: Dict[str, str],
        lkg_records: Dict[str, dict],
        breaker: Optional[dict],
    ) -> bool:
        """Revert every DS still pointing at the tripped revision to its
        recorded LKG by promoting the LKG ControllerRevision to newest —
        exactly what ``kubectl rollout undo daemonset`` effects (the DS
        controller bumps the old ControllerRevision's ``.revision``).
        Returns True when at least one DS was reverted."""
        bad = (breaker or {}).get("target")
        reverted = False
        for ds_name, ds in sorted(daemon_sets.items()):
            target = targets.get(ds_name)
            record = lkg_records.get(ds_name) or {}
            lkg = record.get("lkg")
            if not target or target != bad or not lkg or lkg == target:
                continue
            if self._promote_revision(ds, lkg):
                reverted = True
                metrics.record_rollback()
                events_mod.emit(
                    events_mod.EVENT_ROLLBACK_STARTED,
                    "breaker",
                    events_mod.FLEET_TARGET,
                    f"DaemonSet {ds_name}: revision {target} -> "
                    f"last-known-good {lkg}",
                )
                log_event(
                    self._recorder,
                    util.get_component_name(),
                    "Warning",
                    util.get_event_reason(),
                    f"Rolling back DaemonSet {ds_name} from revision "
                    f"{target} to last-known-good {lkg}",
                )
                logger.warning(
                    "remediation: rolling back DaemonSet %s %s -> %s",
                    ds_name,
                    target,
                    lkg,
                )
        return reverted

    def _promote_revision(self, ds: JsonObj, lkg_hash: str) -> bool:
        namespace = namespace_of(ds)
        ds_name = name_of(ds)
        try:
            revisions = [
                cr
                for cr in self._cluster.list(
                    "ControllerRevision", namespace=namespace
                )
                if is_owned_by(cr, ds)
                or (
                    not owner_references(cr)
                    and name_of(cr).startswith(f"{ds_name}-")
                )
            ]
        except (ApiError, OSError) as err:
            logger.error("remediation: cannot list ControllerRevisions: %s", err)
            return False
        if not revisions:
            return False
        newest = max(cr.get("revision", 0) for cr in revisions)
        lkg_crs = [
            cr
            for cr in revisions
            if ((cr.get("metadata") or {}).get("labels") or {}).get(
                CONTROLLER_REVISION_HASH_LABEL
            )
            == lkg_hash
            or name_of(cr) == f"{ds_name}-{lkg_hash}"
        ]
        if not lkg_crs:
            logger.error(
                "remediation: LKG ControllerRevision %s for DaemonSet %s is "
                "gone (history GC?) — cannot roll back automatically",
                lkg_hash,
                ds_name,
            )
            log_event(
                self._recorder,
                util.get_component_name(),
                "Warning",
                util.get_event_reason(),
                f"Cannot roll back {ds_name}: last-known-good revision "
                f"{lkg_hash} no longer exists",
            )
            return False
        cr = max(lkg_crs, key=lambda c: c.get("revision", 0))
        # The real rollback mechanism first (`kubectl rollout undo`):
        # apply the LKG ControllerRevision's stored template patch to the
        # DaemonSet spec, so a REAL DaemonSet controller recreates pods
        # from the good template (it will then bump the matching
        # ControllerRevision itself).  Real apiserver CRs always carry
        # `.data`; the in-memory harness's don't — there the revision
        # promotion below IS the oracle, so both backends converge.
        data = cr.get("data")
        if isinstance(data, dict) and data:
            try:
                self._cluster.patch("DaemonSet", ds_name, data, namespace)
            except (ApiError, OSError) as err:
                logger.error(
                    "remediation: failed to revert DaemonSet %s template "
                    "from ControllerRevision %s: %s",
                    ds_name,
                    name_of(cr),
                    err,
                )
                return False
        try:
            self._cluster.patch(
                "ControllerRevision",
                name_of(cr),
                {"revision": newest + 1},
                namespace,
            )
        except (ApiError, OSError) as err:
            logger.error(
                "remediation: failed to promote ControllerRevision %s: %s",
                name_of(cr),
                err,
            )
            return False
        return True

    # ---------------------------------------------------------- quarantine
    def _quarantine(self, node: JsonObj) -> None:
        domain = topology.domain_of(node)
        self._provider.change_node_upgrade_annotation(
            node,
            util.get_quarantine_annotation_key(),
            consts.REMEDIATION_QUARANTINE_PREFIX + domain,
        )
        self._set_taint(node, add=True)
        metrics.record_node_quarantine()
        events_mod.emit(
            events_mod.EVENT_NODE_QUARANTINED,
            "retry-budget",
            name_of(node),
            f"retry budget exhausted (domain {domain})",
        )
        log_event(
            self._recorder,
            name_of(node),
            "Warning",
            util.get_event_reason(),
            f"Quarantined after exhausting the upgrade retry budget "
            f"(domain {domain}); the wave routes around it until the node "
            "is repaired out-of-band",
        )
        logger.warning(
            "remediation: node %s quarantined (domain %s) after retry "
            "budget exhaustion",
            name_of(node),
            domain,
        )

    def _release_repaired(
        self, state: ClusterUpgradeState, common: CommonUpgradeManager
    ) -> None:
        """Clear retry bookkeeping (and quarantine) for nodes that made
        it back to done with an in-sync pod — success resets the budget.
        Dirty-scoped: the verdict is a pure function of the node's own
        annotations + pod sync, all event-visible inputs."""
        attempt_key = util.get_attempt_count_annotation_key()
        failure_at_key = util.get_last_failure_at_annotation_key()
        failure_target_key = util.get_failure_target_annotation_key()
        quarantine_key = util.get_quarantine_annotation_key()
        for node_state in state.scan_scope(consts.UPGRADE_STATE_DONE):
            node = node_state.node
            ann = _annotations(node)
            had_budget = attempt_key in ann or failure_at_key in ann
            quarantined = is_remediation_quarantined(node)
            if not had_budget and not quarantined:
                continue
            if not common.is_driver_pod_in_sync(node_state):
                continue
            for key in (attempt_key, failure_at_key, failure_target_key):
                if key in ann:
                    self._provider.change_node_upgrade_annotation(
                        node, key, consts.NULL_STRING
                    )
            if quarantined:
                self._provider.change_node_upgrade_annotation(
                    node, quarantine_key, consts.NULL_STRING
                )
                self._set_taint(node, add=False)
                events_mod.emit(
                    events_mod.EVENT_QUARANTINE_RELEASED,
                    "repaired",
                    name_of(node),
                    "node repaired and back in sync at the target revision",
                )
                log_event(
                    self._recorder,
                    name_of(node),
                    "Normal",
                    util.get_event_reason(),
                    "Quarantine released: node repaired and back in sync "
                    "at the target revision",
                )

    def _set_taint(self, node: JsonObj, add: bool) -> None:
        taint_key = util.get_quarantine_taint_key()
        taints = [
            t
            for t in ((node.get("spec") or {}).get("taints") or [])
            if t.get("key") != taint_key
        ]
        if add:
            taints.append(
                {"key": taint_key, "value": "true", "effect": "NoSchedule"}
            )
        try:
            self._cluster.patch(
                "Node", name_of(node), {"spec": {"taints": taints}}
            )
        except (ApiError, OSError) as err:
            logger.warning(
                "remediation: failed to update taints on %s: %s",
                name_of(node),
                err,
            )
            return
        node.setdefault("spec", {})["taints"] = taints


# ---------------------------------------------------------------- reporting
def remediation_report(state: ClusterUpgradeState, policy=None) -> dict:
    """Pure snapshot view of the remediation state (CLI + offline dumps):
    LKG/breaker records read straight off the DaemonSet annotations the
    live engine maintains, per-node retry budgets and quarantines off the
    node annotations.  No writes, no API calls — computable from a
    persisted cluster dump exactly like RolloutStatus."""
    lkg_key = util.get_last_known_good_annotation_key()
    breaker_key = util.get_breaker_annotation_key()
    attempt_key = util.get_attempt_count_annotation_key()
    failure_at_key = util.get_last_failure_at_annotation_key()
    failure_target_key = util.get_failure_target_annotation_key()

    daemon_sets: Dict[str, JsonObj] = {}
    for ns in state.all_node_states():
        if ns.driver_daemonset is not None:
            daemon_sets[name_of(ns.driver_daemonset)] = ns.driver_daemonset

    lkg: Dict[str, dict] = {}
    breaker: Optional[dict] = None
    for ds_name in sorted(daemon_sets):
        ann = _annotations(daemon_sets[ds_name])
        record = _parse_json_annotation(ann.get(lkg_key))
        if record is not None:
            lkg[ds_name] = record
        if breaker is None:
            breaker = _parse_json_annotation(ann.get(breaker_key))

    blocking = breaker is not None and breaker.get("state") == "open" and any(
        rec.get("target") == breaker.get("target") for rec in lkg.values()
    )

    nodes: List[dict] = []
    quarantined: List[str] = []
    for ns in state.managed_node_states():
        node = ns.node
        ann = _annotations(node)
        attempts = ann.get(attempt_key)
        q = is_remediation_quarantined(node)
        if attempts is None and failure_at_key not in ann and not q:
            continue
        entry = {
            "node": name_of(node),
            "attempts": int(attempts) if (attempts or "").isdigit() else 0,
            "quarantined": q,
        }
        if failure_at_key in ann:
            entry["lastFailureAt"] = ann[failure_at_key]
        if failure_target_key in ann:
            entry["failureTarget"] = ann[failure_target_key]
        nodes.append(entry)
        if q:
            quarantined.append(name_of(node))
    nodes.sort(key=lambda e: e["node"])

    out = {
        "enabled": policy is not None
        and getattr(policy, "remediation", None) is not None,
        "breaker": breaker,
        "blocking": blocking,
        "lastKnownGood": lkg,
        "nodes": nodes,
        "quarantinedNodes": sorted(quarantined),
    }
    return out


def render_report(report: dict) -> str:
    """Human rendering of :func:`remediation_report`."""
    lines: List[str] = []
    breaker = report.get("breaker")
    if breaker is None:
        lines.append("breaker: closed (no trip recorded)")
    else:
        state_word = str(breaker.get("state", "?"))
        lines.append(
            f"breaker: {state_word.upper()}"
            + (" — ADMISSIONS PAUSED" if report.get("blocking") else "")
        )
        lines.append(f"  reason:  {breaker.get('reason', '')}")
        lines.append(
            f"  target:  {breaker.get('target', '')}  "
            f"failures {breaker.get('failures', 0)}/"
            f"{breaker.get('attempted', 0)}"
        )
    lkg = report.get("lastKnownGood") or {}
    for ds_name in sorted(lkg):
        rec = lkg[ds_name]
        lines.append(
            f"daemonset {ds_name}: target={rec.get('target', '?')} "
            f"lastKnownGood={rec.get('lkg', '?')}"
        )
    if not lkg:
        lines.append("daemonset: no last-known-good record yet")
    nodes = report.get("nodes") or []
    if nodes:
        lines.append("")
        lines.append(f"{'NODE':<28} {'ATTEMPTS':>8} {'QUARANTINED':>11}")
        for entry in nodes:
            lines.append(
                f"{entry['node']:<28} {entry['attempts']:>8} "
                f"{'yes' if entry['quarantined'] else 'no':>11}"
            )
    else:
        lines.append("no nodes with retry-budget state")
    return "\n".join(lines)


# ------------------------------------------------------------------ selftest
def selftest() -> str:
    """End-to-end breaker smoke on the in-memory apiserver: a bad
    revision fails every recreated pod, the breaker trips, autoRollback
    reverts to the LKG revision, and the retry path drives the fleet
    back to done at the LKG — all inside one process, no test harness.
    Raises AssertionError on any violated expectation; returns a
    summary line (the ``make verify-remediation`` gate)."""
    from ..api.upgrade_spec import (
        DrainSpec,
        IntOrString,
        RemediationSpec,
        UpgradePolicySpec,
    )
    from ..cluster.cache import InformerCache
    from ..cluster.inmem import InMemoryCluster
    from ..cluster.objects import (
        make_controller_revision,
        make_daemonset,
        make_node,
        make_pod,
    )
    from .upgrade_state import ClusterUpgradeStateManager

    namespace, labels = "remediation-selftest", {"app": "selftest-runtime"}
    cluster = InMemoryCluster()
    ds = cluster.create(make_daemonset("selftest-runtime", namespace, dict(labels)))
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
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=5),
        remediation=RemediationSpec(
            failure_threshold=0.5,
            min_attempted=2,
            auto_rollback=True,
            max_node_attempts=5,
            backoff_seconds=0.0,
        ),
    )
    policy.validate()
    manager = ClusterUpgradeStateManager(
        cluster,
        cache=InformerCache(cluster, lag_seconds=0.0),
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005,
    )
    tripped_cycle = rolled_cycle = None
    try:
        # Healthy era first: the LKG tracker must observe the good
        # revision as the standing target BEFORE the bad one lands, or
        # there is nothing recorded to roll back to.
        for _ in range(3):
            state = manager.build_state(namespace, labels)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            ds_controller()
        cluster.create(make_controller_revision(ds, 2, "bad"))
        for cycle in range(60):
            state = manager.build_state(namespace, labels)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            ds_controller()
            status = manager.remediation_status() or {}
            breaker = status.get("breaker") or {}
            if tripped_cycle is None and breaker:
                tripped_cycle = cycle
            if rolled_cycle is None and breaker.get("state") == "rolled-back":
                rolled_cycle = cycle
            state_key = util.get_upgrade_state_label_key()
            done = all(
                (n["metadata"].get("labels") or {}).get(state_key)
                == consts.UPGRADE_STATE_DONE
                for n in cluster.list("Node")
            )
            if done and rolled_cycle is not None:
                break
        else:
            raise AssertionError(
                "selftest did not converge after rollback: "
                + str(
                    {
                        n["metadata"]["name"]: (
                            n["metadata"].get("labels") or {}
                        ).get(util.get_upgrade_state_label_key())
                        for n in cluster.list("Node")
                    }
                )
            )
    finally:
        manager.shutdown()
    assert tripped_cycle is not None, "breaker never tripped"
    assert rolled_cycle is not None, "autoRollback never fired"
    assert newest_hash() == "good", "DS not reverted to the LKG revision"
    for pod in cluster.list("Pod", namespace=namespace):
        assert (
            pod["metadata"]["labels"][CONTROLLER_REVISION_HASH_LABEL]
            == "good"
        ), "a pod is still on the bad revision"
    return (
        "remediation selftest OK: tripped@cycle "
        f"{tripped_cycle}, rolled back@cycle {rolled_cycle}, fleet "
        "converged on the last-known-good revision"
    )
