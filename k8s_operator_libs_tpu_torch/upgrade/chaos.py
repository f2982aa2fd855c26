"""Chaos campaign engine: declarative scenario sweeps checked against
the decision stream.

The fault-injection substrate (:meth:`~..cluster.apiserver
.ApiServerFacade.with_chaos` / ``with_faults``), the resilience property
suites (tests/test_resilience.py) and the persisted decision-event audit
trail (:mod:`..obs.events`) all exist — this module is the harness that
COMPOSES them into a repeatable resilience scorecard:

* a **scenario catalog** of named fault injections (apiserver brownouts,
  latency brownouts, informer partitions, held-stream truncation, clock
  skew, journal-retention 410 storms, batch-endpoint 404 degradation,
  HA failover mid-wave, operator crash-resume, concurrent policy edits,
  Event-GC races, bad-revision rollback), each with an **evidence
  probe** — a chaos cell that cannot show its chaos actually fired
  proves nothing;
* a **campaign** crosses scenarios with config axes Reframe-style
  (transport: in-mem vs real HTTP; policy gates on/off; fleet size),
  every cell replayed deterministically from a seed derived from
  (campaign seed, scenario, axis values);
* after each cell a **rollout-invariant checker** consumes the decision
  stream plus the journal audit tape plus final cluster state and
  asserts the global safety properties no unit test can: no lost nodes,
  the failure budget never overshot at any settled point, monotone
  completion in the final revision era, every observed state-label
  transition on a legal edge, every terminal state explained by a legal
  reason-code path through the decision vocabulary
  (:data:`~..obs.events.EVENT_REASONS`), and breaker/rollback episodes
  closed;
* results land as a compact **scorecard** artifact (``chaos`` CLI,
  ``bench.py`` tail) so regressions in *resilience* are tracked per
  round exactly like regressions in speed;
* the checker also emits graded **fitness signals** (budget headroom at
  settled points, breaker margin, audit near-gap width, decision-stream
  anomaly density, stream-parity slack) so the coverage-guided searcher
  (:mod:`.chaossearch`) can climb toward violations instead of merely
  enumerating cells, and ratcheted **regression cells** (minimal
  reproducers the searcher shrank) ride the campaign after the matrix.

:data:`LEGAL_TRANSITIONS` lives here as the canonical edge set of the
reference lifecycle graph (SURVEY.md §2); the resilience test suite
imports it from here so the campaign checker and the property tests can
never disagree about which edges exist.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from ..api.upgrade_spec import (
    DrainSpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from ..cluster.errors import ApiError, ExpiredError, NotFoundError
from ..cluster.inmem import InMemoryCluster, JsonObj
from ..cluster.objects import (
    CONTROLLER_REVISION_HASH_LABEL,
    make_controller_revision,
    make_daemonset,
    make_node,
    make_pod,
    node_is_ready,
    node_is_unschedulable,
)
from ..obs import events as events_mod
from . import consts, util
from . import timeline as timeline_mod
from .upgrade_state import ClusterUpgradeStateManager, UpgradeStateError

logger = logging.getLogger(__name__)

# --------------------------------------------------------------------------
# The legal lifecycle edge set (canonical home; tests import from here).
# Sources: ApplyState's per-state processors (upgrade_state.go:204-278),
# this library's post-maintenance gate, the requestor's missing-CR
# fallback (upgrade_requestor.go:420-432), and the remediation engine's
# two documented recovery edges (docs/state-diagram.md).
# --------------------------------------------------------------------------
_C = consts
LEGAL_TRANSITIONS = frozenset(
    {
        (_C.UPGRADE_STATE_UNKNOWN, _C.UPGRADE_STATE_DONE),
        (_C.UPGRADE_STATE_UNKNOWN, _C.UPGRADE_STATE_UPGRADE_REQUIRED),
        (_C.UPGRADE_STATE_DONE, _C.UPGRADE_STATE_UPGRADE_REQUIRED),
        (_C.UPGRADE_STATE_UPGRADE_REQUIRED, _C.UPGRADE_STATE_CORDON_REQUIRED),
        (
            _C.UPGRADE_STATE_UPGRADE_REQUIRED,
            _C.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_CORDON_REQUIRED,
            _C.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
            _C.UPGRADE_STATE_POD_DELETION_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
            _C.UPGRADE_STATE_DRAIN_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_POD_DELETION_REQUIRED,
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_POD_DELETION_REQUIRED,
            _C.UPGRADE_STATE_DRAIN_REQUIRED,
        ),
        (_C.UPGRADE_STATE_POD_DELETION_REQUIRED, _C.UPGRADE_STATE_FAILED),
        (
            _C.UPGRADE_STATE_DRAIN_REQUIRED,
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
        ),
        (_C.UPGRADE_STATE_DRAIN_REQUIRED, _C.UPGRADE_STATE_FAILED),
        (
            _C.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
            _C.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
            _C.UPGRADE_STATE_UPGRADE_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED,
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
            _C.UPGRADE_STATE_VALIDATION_REQUIRED,
        ),
        (
            _C.UPGRADE_STATE_POD_RESTART_REQUIRED,
            _C.UPGRADE_STATE_UNCORDON_REQUIRED,
        ),
        (_C.UPGRADE_STATE_POD_RESTART_REQUIRED, _C.UPGRADE_STATE_DONE),
        (_C.UPGRADE_STATE_POD_RESTART_REQUIRED, _C.UPGRADE_STATE_FAILED),
        (
            _C.UPGRADE_STATE_VALIDATION_REQUIRED,
            _C.UPGRADE_STATE_UNCORDON_REQUIRED,
        ),
        (_C.UPGRADE_STATE_VALIDATION_REQUIRED, _C.UPGRADE_STATE_DONE),
        (_C.UPGRADE_STATE_VALIDATION_REQUIRED, _C.UPGRADE_STATE_FAILED),
        (_C.UPGRADE_STATE_FAILED, _C.UPGRADE_STATE_UNCORDON_REQUIRED),
        (_C.UPGRADE_STATE_FAILED, _C.UPGRADE_STATE_DONE),
        # remediation retry budget: a failed node whose pod is out of
        # sync with the target re-enters the wave after its backoff
        (_C.UPGRADE_STATE_FAILED, _C.UPGRADE_STATE_UPGRADE_REQUIRED),
        # remediation rollback overtaking admission: a pending node whose
        # pod is back in sync after the LKG revert returns straight to
        # done (no cordon/drain for a no-op)
        (_C.UPGRADE_STATE_UPGRADE_REQUIRED, _C.UPGRADE_STATE_DONE),
        (_C.UPGRADE_STATE_UNCORDON_REQUIRED, _C.UPGRADE_STATE_DONE),
    }
)

#: States a node may legally END a converged cell in.
TERMINAL_STATES = frozenset(
    {_C.UPGRADE_STATE_DONE, _C.UPGRADE_STATE_FAILED}
)

#: Decision type → types that must appear EARLIER (by first occurrence)
#: for the same target before it is legal — the reason-code *path*
#: component of "every terminal state explained by a legal reason-code
#: path".  A release without a quarantine, a retry without a failure, a
#: rollback without a breaker trip: each means the audit trail lies.
DECISION_PREREQUISITES: Dict[str, Tuple[str, ...]] = {
    events_mod.EVENT_QUARANTINE_RELEASED: (
        events_mod.EVENT_NODE_QUARANTINED,
    ),
    events_mod.EVENT_NODE_RETRIED: (events_mod.EVENT_NODE_UPGRADE_FAILED,),
    # NodeUnadmitted deliberately has NO NodeAdmitted prerequisite: the
    # rollback-overtook path un-admits PENDING nodes the wave never
    # reached (their pods are back in sync at the LKG, so they return
    # straight to done without ever having been admitted).
    events_mod.EVENT_ROLLBACK_STARTED: (events_mod.EVENT_BREAKER_TRIPPED,),
}

#: Invariant names the checker can report (the scorecard's vocabulary).
INVARIANTS = (
    "no-lost-nodes",
    "budget-never-overshot",
    "monotone-completion",
    "transition-legality",
    "terminal-states-explained",
    "decision-vocabulary",
    "decision-path-legality",
    "breaker-episodes-closed",
    "stream-parity",
    "converged",
    "audit-continuity",
    # not an invariant over cluster state but part of the violation
    # vocabulary: the scenario's fault demonstrably never fired
    "evidence",
    # federated scenarios: the cell-wave safety property — no
    # un-admitted cell admits a node while the wave is held (global
    # breaker open, unreachable cell, or unpromoted predecessor)
    "federation-wave",
)


def observed_transitions(cluster, since_seq: int = 0):
    """Every node state-label change in the watch journal after
    *since_seq* — the direct-read form the property tests use (the
    campaign itself audits incrementally via :class:`AuditTape` so a
    rolled journal cannot blind it)."""
    key = util.get_upgrade_state_label_key()
    moves = []
    for ev in cluster.events_since(since_seq, kind="Node"):
        if ev.new is None:
            continue
        old_state = (
            ((ev.old or {}).get("metadata") or {}).get("labels") or {}
        ).get(key, "")
        new_state = (
            (ev.new.get("metadata") or {}).get("labels") or {}
        ).get(key, "")
        if old_state != new_state:
            moves.append((old_state, new_state))
    return moves


@dataclass
class Violation:
    """One broken invariant, as the scorecard reports it."""

    invariant: str
    detail: str

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail}


# --------------------------------------------------------------------------
# Audit tape: the incremental journal consumer.  Collected once per
# settled reconcile cycle (and around deliberate journal rolls), so a
# scenario that 410s every OTHER consumer cannot blind the auditor.
# --------------------------------------------------------------------------
class AuditTape:
    """Incrementally drains the store journal into an audit record:
    node state-label transitions (for legality + monotone completion),
    ControllerRevision write sequences (revision-era boundaries), and a
    settled-point budget check against the policy in force — with an
    in-flight grace after policy edits, mirroring the property suites
    (a shrunk budget cannot retract an admitted node; it must only stop
    admitting new ones)."""

    IDLE_STATES = (
        "",
        consts.UPGRADE_STATE_DONE,
        consts.UPGRADE_STATE_UPGRADE_REQUIRED,
    )

    def __init__(self, store: InMemoryCluster, policy: UpgradePolicySpec):
        self._store = store
        self._policy = policy
        self._cursor = store.journal_seq()
        self._state_key = util.get_upgrade_state_label_key()
        self.transitions: List[Tuple[int, str, str, str]] = []
        self.cr_seqs: List[int] = []
        self.gaps = 0
        self.budget_violations: List[str] = []
        #: graded fitness-signal inputs (``fitness_signals``): the
        #: TIGHTEST margins observed at settled points, not just
        #: pass/fail — a searcher needs to know how close a healthy
        #: cell came to the cliff, not only whether it fell off
        self.min_unavail_headroom: Optional[int] = None
        self.min_parallel_headroom: Optional[int] = None
        #: narrowest (cursor - eviction floor) observed while the
        #: journal was actively evicting; None = eviction never ran
        self.min_journal_slack: Optional[int] = None
        self.journal_cap_seen: int = 0
        self._grace_active = 0
        self._grace_unavailable = 0
        self._nodes: Dict[str, JsonObj] = {
            (n.get("metadata") or {}).get("name") or "": n
            for n in store.list("Node")
        }

    # ------------------------------------------------------------- feeding
    def note_policy_change(self, policy: UpgradePolicySpec) -> None:
        """A live policy edit: in-flight work admitted under the old
        policy may finish — record the current exposure as grace."""
        self._policy = policy
        active, unavailable = self._census()
        self._grace_active = active
        # an ADMITTED node that has not yet been cordoned will still
        # become unavailable under the new policy — in-flight work
        # finishes (the property suites' contract), so the grace covers
        # the larger of the two exposures
        self._grace_unavailable = max(unavailable, active)

    def resync(self) -> None:
        """Skip the tape past a DELIBERATE journal roll (a 410-storm
        scenario rolling retention): reposition at the head and reseed
        the node map so the next collect resumes cleanly.  Anything
        rolled past between the last collect and this resync is
        unaudited by construction — callers collect() first."""
        self._cursor = self._store.journal_seq()
        self._nodes = {
            (n.get("metadata") or {}).get("name") or "": n
            for n in self._store.list("Node")
        }

    def collect(self) -> None:
        """Drain journal events since the last collect (call at settled
        points: post wait_idle each cycle).  An UNPLANNED retention gap
        counts — the checker fails the cell on it unless the scenario
        declared the roll."""
        floor = getattr(self._store, "_journal_floor", 0)
        if floor > 0:
            # eviction is live: record how close the tape's cursor sits
            # to the retention frontier (the near-gap width)
            slack = self._cursor - floor
            if (
                self.min_journal_slack is None
                or slack < self.min_journal_slack
            ):
                self.min_journal_slack = slack
            self.journal_cap_seen = int(
                getattr(self._store, "_journal_cap", 0) or 0
            )
        try:
            events = self._store.events_since(self._cursor)
        except ExpiredError:
            self.gaps += 1
            self.resync()
            return
        for ev in events:
            if ev.seq > self._cursor:
                self._cursor = ev.seq
            obj = ev.new if ev.new is not None else ev.old
            if obj is None:
                continue
            kind = obj.get("kind") or ""
            if kind == "ControllerRevision":
                self.cr_seqs.append(ev.seq)
                continue
            if kind != "Node":
                continue
            name = (obj.get("metadata") or {}).get("name") or ""
            old_state = (
                ((ev.old or {}).get("metadata") or {}).get("labels") or {}
            ).get(self._state_key, "")
            new_state = (
                ((ev.new or {}).get("metadata") or {}).get("labels") or {}
            ).get(self._state_key, "")
            if old_state != new_state:
                self.transitions.append((ev.seq, name, old_state, new_state))
            if ev.type == "Deleted":
                self._nodes.pop(name, None)
            elif ev.new is not None:
                self._nodes[name] = ev.new
        self._check_budgets()

    # ------------------------------------------------------------- budgets
    def _census(self) -> Tuple[int, int]:
        active = 0
        unavailable = 0
        for node in self._nodes.values():
            state = (
                (node.get("metadata") or {}).get("labels") or {}
            ).get(self._state_key, "")
            if state not in self.IDLE_STATES:
                active += 1
            if node_is_unschedulable(node) or not node_is_ready(node):
                unavailable += 1
        return active, unavailable

    def _check_budgets(self) -> None:
        policy = self._policy
        if policy is None or not policy.auto_upgrade:
            return
        active, unavailable = self._census()
        total = len(self._nodes)
        if total == 0:
            return
        budget = policy.max_unavailable.scaled_value(total, round_up=True)
        allowed_unavail = max(budget, self._grace_unavailable)
        headroom = allowed_unavail - unavailable
        if (
            self.min_unavail_headroom is None
            or headroom < self.min_unavail_headroom
        ):
            self.min_unavail_headroom = headroom
        if unavailable > allowed_unavail and len(self.budget_violations) < 8:
            self.budget_violations.append(
                f"{unavailable} unavailable exceeds maxUnavailable={budget} "
                f"(grace {self._grace_unavailable}) at seq {self._cursor}"
            )
        if unavailable <= budget:
            self._grace_unavailable = 0
        if policy.max_parallel_upgrades > 0:
            allowed_active = max(
                policy.max_parallel_upgrades, self._grace_active
            )
            p_headroom = allowed_active - active
            if (
                self.min_parallel_headroom is None
                or p_headroom < self.min_parallel_headroom
            ):
                self.min_parallel_headroom = p_headroom
            if active > allowed_active and len(self.budget_violations) < 8:
                self.budget_violations.append(
                    f"{active} concurrent upgrades exceed "
                    f"maxParallelUpgrades={policy.max_parallel_upgrades} "
                    f"(grace {self._grace_active}) at seq {self._cursor}"
                )
            if active <= policy.max_parallel_upgrades:
                self._grace_active = 0


# --------------------------------------------------------------------------
# The rollout-invariant checker.
# --------------------------------------------------------------------------
def check_rollout_invariants(
    store: InMemoryCluster,
    *,
    managed_nodes,
    policy: Optional[UpgradePolicySpec],
    decisions: List[dict],
    tape: Optional[AuditTape] = None,
    persisted_decisions: Optional[List[dict]] = None,
    ds_name: str = "",
    ds_namespace: str = "",
    target_revision: str = "",
    converged: Optional[bool] = None,
    expect: Optional[dict] = None,
) -> List[Violation]:
    """Assert the global safety properties over a finished cell: final
    cluster state + the audit tape + the decision stream.  Returns the
    (possibly empty) violation list; pure function — the selftest runs
    it twice, once against a healthy cell and once against a tampered
    one, to prove it can actually fail.

    *expect* relaxes checks a scenario legitimately breaks:
    ``audit_gaps`` (deliberate journal rolls), ``stream_gaps``
    (crash-truncated reconciles may lose an emission between a write
    and its event), ``breaker_open`` (a no-rollback policy leaves the
    breaker standing), ``rollback`` (a RollbackStarted episode is
    REQUIRED and must have closed at the LKG)."""
    expect = expect or {}
    violations: List[Violation] = []
    state_key = util.get_upgrade_state_label_key()
    quarantine_key = util.get_quarantine_annotation_key()
    managed = set(managed_nodes)

    # ---- no lost nodes: every managed node still exists and carries a
    # known state value
    live: Dict[str, JsonObj] = {}
    for node in store.list("Node"):
        name = (node.get("metadata") or {}).get("name") or ""
        live[name] = node
    for name in sorted(managed):
        node = live.get(name)
        if node is None:
            violations.append(
                Violation("no-lost-nodes", f"managed node {name} vanished")
            )
            continue
        state = ((node.get("metadata") or {}).get("labels") or {}).get(
            state_key, ""
        )
        if state not in consts.ALL_STATES:
            violations.append(
                Violation(
                    "no-lost-nodes",
                    f"node {name} carries unknown state {state!r}",
                )
            )

    # ---- audit continuity + budget-over-time + transition legality +
    # monotone completion (all ride the tape)
    if tape is not None:
        if tape.gaps and not expect.get("audit_gaps"):
            violations.append(
                Violation(
                    "audit-continuity",
                    f"{tape.gaps} unplanned journal retention gap(s) — "
                    "transitions in the gap are unaudited",
                )
            )
        for msg in tape.budget_violations:
            violations.append(Violation("budget-never-overshot", msg))
        illegal = [
            (old, new)
            for _, _, old, new in tape.transitions
            if (old, new) not in LEGAL_TRANSITIONS
        ]
        if illegal:
            violations.append(
                Violation(
                    "transition-legality",
                    f"illegal edges observed: {sorted(set(illegal))[:5]}",
                )
            )
        # monotone completion in the FINAL revision era: once a node
        # enters done after the last ControllerRevision write, it never
        # leaves done again.
        era_start = max(tape.cr_seqs) if tape.cr_seqs else 0
        entered_done: Dict[str, int] = {}
        for seq, name, old, new in tape.transitions:
            if seq <= era_start:
                continue
            if new == consts.UPGRADE_STATE_DONE:
                entered_done.setdefault(name, seq)
            elif (
                old == consts.UPGRADE_STATE_DONE
                and name in entered_done
                and seq > entered_done[name]
            ):
                violations.append(
                    Violation(
                        "monotone-completion",
                        f"node {name} left done at seq {seq} after "
                        f"completing in the final revision era",
                    )
                )

    # ---- decision-stream checks: vocabulary + per-target path legality
    for d in decisions:
        type_ = d.get("type") or ""
        reason = d.get("reason") or ""
        if type_ not in events_mod.EVENT_REASONS:
            violations.append(
                Violation(
                    "decision-vocabulary", f"unknown decision type {type_!r}"
                )
            )
            continue
        legal = events_mod.EVENT_REASONS[type_]
        if legal is not None and reason not in legal:
            violations.append(
                Violation(
                    "decision-vocabulary",
                    f"{type_} carries unregistered reason {reason!r}",
                )
            )
    if not expect.get("stream_gaps"):
        first_seen: Dict[Tuple[str, str], int] = {}
        ordered = sorted(
            decisions, key=lambda d: int(d.get("firstSeq") or d.get("seq") or 0)
        )
        for d in ordered:
            key = (d.get("type") or "", d.get("target") or "")
            first_seen.setdefault(
                key, int(d.get("firstSeq") or d.get("seq") or 0)
            )
        for d in ordered:
            type_ = d.get("type") or ""
            prereqs = DECISION_PREREQUISITES.get(type_)
            if not prereqs:
                continue
            target = d.get("target") or ""
            mine = int(d.get("firstSeq") or d.get("seq") or 0)
            if not any(
                (p, target) in first_seen and first_seen[(p, target)] <= mine
                for p in prereqs
            ):
                violations.append(
                    Violation(
                        "decision-path-legality",
                        f"{type_}[{d.get('reason')}] for {target} has no "
                        f"preceding {'/'.join(prereqs)}",
                    )
                )

    # ---- terminal states explained by the stream
    decided: Dict[Tuple[str, str], dict] = {}
    for d in decisions:
        decided[(d.get("type") or "", d.get("target") or "")] = d
    remediation_on = (
        policy is not None and getattr(policy, "remediation", None) is not None
    )
    for name in sorted(managed):
        node = live.get(name)
        if node is None:
            continue
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        state = ((node.get("metadata") or {}).get("labels") or {}).get(
            state_key, ""
        )
        if annotations.get(quarantine_key, "").startswith(
            consts.REMEDIATION_QUARANTINE_PREFIX
        ) and (events_mod.EVENT_NODE_QUARANTINED, name) not in decided:
            violations.append(
                Violation(
                    "terminal-states-explained",
                    f"node {name} is remediation-quarantined with no "
                    "NodeQuarantined decision in the stream",
                )
            )
        if (
            state == consts.UPGRADE_STATE_FAILED
            and remediation_on
            and not expect.get("stream_gaps")
            and (events_mod.EVENT_NODE_UPGRADE_FAILED, name) not in decided
        ):
            violations.append(
                Violation(
                    "terminal-states-explained",
                    f"node {name} ended upgrade-failed with no "
                    "NodeUpgradeFailed decision in the stream",
                )
            )

    # ---- convergence (scenario-declared target)
    if converged is False:
        pending = {
            name: (
                (live.get(name, {}).get("metadata") or {}).get("labels") or {}
            ).get(state_key, "")
            for name in sorted(managed)
            if (
                (live.get(name, {}).get("metadata") or {}).get("labels") or {}
            ).get(state_key, "")
            != consts.UPGRADE_STATE_DONE
        }
        violations.append(
            Violation(
                "converged",
                f"fleet did not converge to {target_revision or 'target'}: "
                f"{dict(list(pending.items())[:5])}",
            )
        )

    # ---- breaker / rollback episodes closed
    if ds_name:
        breaker = None
        lkg = None
        try:
            ds = store.get("DaemonSet", ds_name, ds_namespace)
        except (ApiError, OSError):
            ds = None
        if ds is not None:
            ds_ann = (ds.get("metadata") or {}).get("annotations") or {}
            raw = ds_ann.get(util.get_breaker_annotation_key())
            if raw:
                try:
                    breaker = json.loads(raw)
                except ValueError:
                    violations.append(
                        Violation(
                            "breaker-episodes-closed",
                            "breaker annotation is not valid JSON",
                        )
                    )
            raw = ds_ann.get(util.get_last_known_good_annotation_key())
            if raw:
                try:
                    lkg = json.loads(raw)
                except ValueError:
                    lkg = None
        if (
            breaker is not None
            and breaker.get("state") == "open"
            and not expect.get("breaker_open")
        ):
            violations.append(
                Violation(
                    "breaker-episodes-closed",
                    "breaker record left open at cell end",
                )
            )
        rolled_back = any(
            d.get("type") == events_mod.EVENT_ROLLBACK_STARTED
            for d in decisions
        )
        if expect.get("rollback"):
            if not rolled_back:
                violations.append(
                    Violation(
                        "breaker-episodes-closed",
                        "scenario expected a RollbackStarted episode; "
                        "none in the stream",
                    )
                )
            elif lkg is None:
                violations.append(
                    Violation(
                        "breaker-episodes-closed",
                        "rollback episode has no last-known-good record",
                    )
                )
            elif target_revision and lkg.get("target") != target_revision:
                violations.append(
                    Violation(
                        "breaker-episodes-closed",
                        f"LKG record {lkg.get('target')!r} != expected "
                        f"{target_revision!r}",
                    )
                )

    # ---- stream parity: every decision reconstructed from the
    # persisted Events must exist in the live stream (the sink can lag
    # or be GC'd, so subset — never invention)
    if persisted_decisions is not None:
        live_triples = {
            (d.get("type"), d.get("reason"), d.get("target"))
            for d in decisions
        }
        for d in persisted_decisions:
            triple = (d.get("type"), d.get("reason"), d.get("target"))
            if triple not in live_triples:
                violations.append(
                    Violation(
                        "stream-parity",
                        f"persisted decision {triple} absent from the "
                        "live stream",
                    )
                )
    return violations


# --------------------------------------------------------------------------
# Graded fitness signals: how CLOSE a cell came to violating each
# invariant family, not just whether it did.  The searcher
# (:mod:`.chaossearch`) climbs these — a fixed matrix only needs the
# binary verdict, a mutating one needs the gradient.  Every signal is
# normalized to [0, 1] where 1 means "at the cliff edge"; an actual
# violation dominates every signal (see fitness_score).
# --------------------------------------------------------------------------
FITNESS_SIGNALS = (
    "budget-headroom",
    "breaker-margin",
    "audit-near-gap",
    "decision-anomalies",
    "stream-parity-slack",
)

#: decision types that mark a remediation/abort/hold episode — their
#: density is the decision-stream anomaly count the searcher rewards
ANOMALY_DECISION_TYPES = frozenset(
    value
    for value in (
        getattr(events_mod, attr, None)
        for attr in (
            "EVENT_NODE_UPGRADE_FAILED",
            "EVENT_NODE_RETRIED",
            "EVENT_NODE_QUARANTINED",
            "EVENT_NODE_DRAIN_FAILED",
            "EVENT_BREAKER_TRIPPED",
            "EVENT_ROLLBACK_STARTED",
            "EVENT_SLO_BREACHED",
            "EVENT_ANALYSIS_ABORTED",
            "EVENT_CELL_HELD",
        )
    )
    if value
)


def fitness_signals(
    *,
    tape: Optional[AuditTape] = None,
    decisions: Optional[List[dict]] = None,
    persisted_decisions: Optional[List[dict]] = None,
    store: Optional[InMemoryCluster] = None,
    policy: Optional[UpgradePolicySpec] = None,
    ds_name: str = "",
    ds_namespace: str = "",
) -> Dict[str, float]:
    """Proximity-to-violation signals over a finished cell, by name
    (:data:`FITNESS_SIGNALS`).  Same inputs as the checker; pure — and
    deterministic for a deterministic cell, which is what lets the
    searcher treat fitness as part of the replay contract."""
    decisions = decisions or []
    signals = {name: 0.0 for name in FITNESS_SIGNALS}

    # ---- budget headroom at settled points: 1/(1+h) so h=0 (one more
    # unavailable node trips the budget) scores 1.0 and relaxes
    # hyperbolically with slack
    headrooms = []
    if tape is not None:
        if tape.min_unavail_headroom is not None:
            headrooms.append(tape.min_unavail_headroom)
        if tape.min_parallel_headroom is not None:
            headrooms.append(tape.min_parallel_headroom)
    if headrooms:
        h = max(0, min(headrooms))
        signals["budget-headroom"] = 1.0 / (1.0 + h)

    # ---- remediation breaker margin: observed failure ratio against
    # the trip threshold; a trip (or an open record) saturates
    margin = 0.0
    tripped = any(
        d.get("type") == events_mod.EVENT_BREAKER_TRIPPED for d in decisions
    )
    remediation = getattr(policy, "remediation", None) if policy else None
    if tripped:
        margin = 1.0
    elif remediation is not None:
        failed = {
            d.get("target")
            for d in decisions
            if d.get("type") == events_mod.EVENT_NODE_UPGRADE_FAILED
        }
        attempted = {
            d.get("target")
            for d in decisions
            if d.get("type") == events_mod.EVENT_NODE_ADMITTED
        }
        if failed and attempted:
            ratio = len(failed) / len(attempted)
            threshold = remediation.failure_threshold or 1.0
            margin = min(1.0, ratio / threshold)
    if store is not None and ds_name and margin < 1.0:
        try:
            ds = store.get("DaemonSet", ds_name, ds_namespace)
        except (ApiError, OSError):
            ds = None
        if ds is not None:
            raw = ((ds.get("metadata") or {}).get("annotations") or {}).get(
                util.get_breaker_annotation_key()
            )
            if raw:
                try:
                    record = json.loads(raw)
                except ValueError:
                    record = None
                if record and record.get("state") == "open":
                    margin = 1.0
    signals["breaker-margin"] = margin

    # ---- audit-continuity near-gap width: narrowest cursor-to-floor
    # slack while the journal was evicting, normalized by the cap; an
    # actual gap saturates
    if tape is not None:
        if tape.gaps:
            signals["audit-near-gap"] = 1.0
        elif tape.min_journal_slack is not None and tape.journal_cap_seen:
            slack = max(0, tape.min_journal_slack)
            cap = float(tape.journal_cap_seen)
            signals["audit-near-gap"] = max(0.0, min(1.0, 1.0 - slack / cap))

    # ---- decision-stream anomaly density (saturating count)
    anomalies = sum(
        1 for d in decisions if (d.get("type") or "") in ANOMALY_DECISION_TYPES
    )
    signals["decision-anomalies"] = anomalies / (anomalies + 4.0)

    # ---- stream-parity slack: live decisions the persisted plane has
    # not yet landed (sink lag).  The invariant breaks in the OTHER
    # direction (persisted inventing decisions); lag is the distance to
    # the cliff where a GC'd live stream would strand persisted extras
    if persisted_decisions is not None:
        persisted_triples = {
            (d.get("type"), d.get("reason"), d.get("target"))
            for d in persisted_decisions
        }
        lag = sum(
            1
            for d in decisions
            if (d.get("type"), d.get("reason"), d.get("target"))
            not in persisted_triples
        )
        signals["stream-parity-slack"] = lag / (lag + 4.0)
    return signals


def fitness_score(
    signals: Dict[str, float], violations: Optional[List] = None
) -> float:
    """Collapse per-signal proximities into the searcher's scalar.  A
    violating cell dominates EVERY non-violating one (1 + violation
    count, always > 1); otherwise the mean over the signal vocabulary,
    bounded below 1."""
    if violations:
        return round(1.0 + float(len(violations)), 4)
    if not signals:
        return 0.0
    total = sum(float(signals.get(name, 0.0)) for name in FITNESS_SIGNALS)
    return round(min(total / len(FITNESS_SIGNALS), 0.9999), 4)


# --------------------------------------------------------------------------
# Simulated fleet (library-resident analog of tests/harness.Fleet): a
# driver DaemonSet + nodes + pods + the one DS-controller behavior the
# state machine depends on — deleted driver pods are recreated at the
# NEWEST ControllerRevision (which is what makes an LKG rollback real).
# --------------------------------------------------------------------------
class SimFleet:
    NAMESPACE = "chaos-ops"
    LABELS = {"app": "chaos-runtime"}
    DS_NAME = "chaos-runtime"

    def __init__(self, client, n_nodes: int):
        self.client = client
        self.revision = 1
        self.revision_hash = "rev1"
        self.bad_revisions: set = set()
        self.managed_nodes: set = set()
        self._pod_seq = itertools.count()
        self.ds = client.create(
            make_daemonset(self.DS_NAME, self.NAMESPACE, dict(self.LABELS))
        )
        client.create(make_controller_revision(self.ds, 1, "rev1"))
        for i in range(n_nodes):
            self.add_node(f"c{i:03d}")

    def add_node(self, name: str) -> None:
        self.client.create(make_node(name))
        self._spawn_pod(name, self.revision_hash)
        self.managed_nodes.add(name)
        ds = self.client.get("DaemonSet", self.DS_NAME, self.NAMESPACE)
        ds["status"]["desiredNumberScheduled"] = (
            ds["status"].get("desiredNumberScheduled", 0) + 1
        )
        self.ds = self.client.update(ds)

    def _spawn_pod(self, node: str, revision_hash: str) -> None:
        bad = revision_hash in self.bad_revisions
        self.client.create(
            make_pod(
                f"{self.DS_NAME}-{next(self._pod_seq)}",
                self.NAMESPACE,
                node,
                labels=dict(self.LABELS),
                owner=self.ds,
                revision_hash=revision_hash,
                ready=not bad,
                restart_count=11 if bad else 0,
            )
        )

    def publish(self, revision_hash: str) -> None:
        self.revision += 1
        self.revision_hash = revision_hash
        self.client.create(
            make_controller_revision(self.ds, self.revision, revision_hash)
        )

    def _refresh_revision(self) -> None:
        revisions = [
            cr
            for cr in self.client.list(
                "ControllerRevision", namespace=self.NAMESPACE
            )
            if ((cr.get("metadata") or {}).get("name") or "").startswith(
                f"{self.DS_NAME}-"
            )
        ]
        if not revisions:
            return
        newest = max(revisions, key=lambda cr: cr.get("revision", 0))
        self.revision = newest.get("revision", self.revision)
        self.revision_hash = (
            (newest.get("metadata") or {}).get("labels") or {}
        ).get(CONTROLLER_REVISION_HASH_LABEL, self.revision_hash)

    def reconcile(self) -> int:
        """The fake DS controller pass: recreate missing driver pods at
        the newest revision (failing when the revision is marked bad)."""
        self._refresh_revision()
        covered = {
            (p.get("spec") or {}).get("nodeName")
            for p in self.client.list(
                "Pod",
                namespace=self.NAMESPACE,
                label_selector="app=chaos-runtime",
            )
        }
        created = 0
        for name in sorted(self.managed_nodes - covered):
            try:
                self.client.get("Node", name)
            except NotFoundError:
                continue
            self._spawn_pod(name, self.revision_hash)
            created += 1
        return created

    def states(self, reader=None) -> Dict[str, str]:
        """Managed-node state labels.  *reader* lets the campaign probe
        the in-proc store directly — the convergence check must not ride
        a transport a scenario is actively sabotaging."""
        reader = reader if reader is not None else self.client
        key = util.get_upgrade_state_label_key()
        out = {}
        for n in reader.list("Node"):
            name = (n.get("metadata") or {}).get("name") or ""
            if name in self.managed_nodes:
                out[name] = (
                    (n.get("metadata") or {}).get("labels") or {}
                ).get(key, "")
        return out

    def converged(self, target_hash: str, reader=None) -> bool:
        reader = reader if reader is not None else self.client
        if set(self.states(reader).values()) != {consts.UPGRADE_STATE_DONE}:
            return False
        for p in reader.list("Pod", namespace=self.NAMESPACE):
            labels = (p.get("metadata") or {}).get("labels") or {}
            if all(
                labels.get(k) == v for k, v in self.LABELS.items()
            ) and labels.get(CONTROLLER_REVISION_HASH_LABEL) != target_hash:
                return False
        return True


class SimulatedCrash(RuntimeError):
    """The injected operator death (write-sequence truncation)."""


class CrashingClient:
    """Wraps a cluster client; after an armed budget of mutating calls
    from the arming thread it raises :class:`SimulatedCrash`, truncating
    the reconcile's write sequence exactly where an operator crash
    would."""

    _MUTATORS = frozenset({"create", "update", "patch", "delete", "evict"})

    def __init__(self, inner):
        self._inner = inner
        self._budget = None
        self._thread = None

    def arm(self, budget: int) -> None:
        self._budget = budget
        self._thread = threading.get_ident()

    def disarm(self) -> None:
        self._budget = None

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self._MUTATORS:

            def wrapped(*args, **kwargs):
                if (
                    self._budget is not None
                    and threading.get_ident() == self._thread
                ):
                    if self._budget <= 0:
                        raise SimulatedCrash(f"crashed before {name}")
                    self._budget -= 1
                return attr(*args, **kwargs)

            return wrapped
        return attr


# --------------------------------------------------------------------------
# Scenario catalog.
# --------------------------------------------------------------------------
@dataclass
class Scenario:
    """One named fault injection: how to install it, how to keep it
    alive per cycle, and how to PROVE it fired (evidence)."""

    name: str
    description: str
    transports: Tuple[str, ...] = ("inmem", "http")
    gates: Tuple[str, ...] = ("on", "off")
    #: reconcile drivers the scenario supports: "polling" runs one pass
    #: per cycle unconditionally (the reference consumers' cadence);
    #: "event" schedules passes through a real workqueue + WakeupSource
    #: (journal-delta watch wakes, async worker-completion wakes, a
    #: bounded fallback) — the event-driven reconcile under faults
    drivers: Tuple[str, ...] = ("polling", "event")
    #: install the fault before the rollout starts: fn(cell)
    setup: Optional[Callable] = None
    #: per-cycle hook (policy edits, journal rolls, failovers): fn(cell, cycle)
    tick: Optional[Callable] = None
    #: evidence probe: fn(cell) -> "" when the fault demonstrably fired,
    #: else a message (reported as an evidence failure)
    evidence: Optional[Callable] = None
    #: checker relaxations/requirements (see check_rollout_invariants)
    expect: dict = field(default_factory=dict)
    #: scenario tunables a mutation can rewrite without touching code:
    #: plain JSON-able values read by setup/tick/runner hooks (e.g. the
    #: federated runner's ``outage_cycles``/``hold_ticks``, the seeded
    #: selftest scenario's ``stress`` level).  Part of the cell's
    #: deterministic identity via the mutation vector in cell_seed.
    params: dict = field(default_factory=dict)
    #: expected final revision hash ("rev1" for rollback scenarios)
    target: str = "rev2"
    #: facade construction overrides (http cells)
    facade_kwargs: dict = field(default_factory=dict)
    #: manager construction overrides
    manager_kwargs: dict = field(default_factory=dict)
    #: "held" = held watch streams + lagged cache + reads_from_cache
    client_mode: str = "plain"
    #: wrap the in-mem store in a CrashingClient (inmem cells)
    crashing: bool = False
    max_cycles: int = 150
    #: Scenario-owned cell runner: fn(scenario, transport, gates,
    #: fleet_size, seed, driver) -> scorecard row.  Scenarios whose
    #: harness is NOT the single-cluster CampaignCell (the federated
    #: fleet-of-fleets scenarios spin up a 3-cell coordinator rig)
    #: plug in here; run_cell dispatches before building anything.
    runner: Optional[Callable] = None


def _setup_brownout(cell) -> None:
    cell.facade.with_chaos(0.08, seed=cell.seed)


def _setup_latency(cell) -> None:
    cell.facade.with_faults(
        request_latency_seconds=0.002, latency_seed=cell.seed
    )


def _setup_partition(cell) -> None:
    budget = {"left": 0}
    cell.notes["partition_budget"] = budget

    def hook(method, info, namespace, name, query) -> bool:
        if budget["left"] > 0 and info.kind in ("Pod", "Node"):
            budget["left"] -= 1
            return True
        return False

    cell.facade.with_faults(partition_hook=hook)


def _tick_partition(cell, cycle: int) -> None:
    # two partition windows, each cutting the next 12 Pod/Node requests
    if cycle in (2, 5):
        cell.notes["partition_budget"]["left"] = 12


def _setup_held_truncation(cell) -> None:
    cell.facade.with_faults(held_stream_max_frames=4)


def _tick_held_truncation(cell, cycle: int) -> None:
    # keep frames flowing so the truncation demonstrably fires even on
    # a fast convergence (frames must be OF a held kind)
    try:
        cell.store.patch(
            "Node",
            sorted(cell.fleet.managed_nodes)[0],
            {"metadata": {"annotations": {"chaos-tick": str(cycle)}}},
        )
    except (ApiError, OSError):
        pass


def _setup_clock_skew(cell) -> None:
    flip = {"n": 0}

    def hook(method, path, body):
        if (body.get("kind") or "") != "Event":
            return None
        flip["n"] += 1
        if flip["n"] % 2:
            return None
        skewed = dict(body)
        for key in ("firstTimestamp", "lastTimestamp"):
            if skewed.get(key):
                # a flat future offset: the second operator's clock
                # running 10 minutes ahead
                skewed[key] = "2099-01-01T00:00:00Z"
        return skewed

    cell.facade.with_faults(body_hook=hook)


def _setup_journal_storm(cell) -> None:
    cell.store._journal_cap = 60


def _tick_journal_storm(cell, cycle: int) -> None:
    if cycle and cycle % 2 == 0:
        # audit first, THEN roll: the roll only expires churn the tape
        # has already consumed, never node transitions
        cell.audit.collect()
        for i in range(80):
            cell.notes["churn"] = cell.notes.get("churn", 0) + 1
            cell.store.create(
                {
                    "kind": "Event",
                    "metadata": {
                        "name": f"chaos-churn-{cell.notes['churn']}",
                        "namespace": SimFleet.NAMESPACE,
                    },
                    "reason": "ChaosChurn",
                }
            )
        cell.audit.resync()
        cell.notes["journal_rolls"] = cell.notes.get("journal_rolls", 0) + 1


def _evidence_journal_storm(cell) -> str:
    rebuilds = metrics.default_registry().counter(
        "state_index_rebuilds_total",
        "Full ClusterStateIndex resyncs, by reason "
        "(seed | journal-expired | relist).",
        ("reason",),
    ).value("journal-expired")
    if rebuilds < 2:
        return (
            f"only {rebuilds:g} journal-expired index rebuilds — the 410 "
            "storm did not exercise the auto-rebuild path"
        )
    return ""


def _evidence_batch_404(cell) -> str:
    fallbacks = metrics.default_registry().counter(
        "batch_endpoint_fallbacks_total",
        "Batch write endpoint probes that found no endpoint (client "
        "degraded to per-op writes).",
    ).value()
    if fallbacks < 1:
        return "no batch-endpoint fallback recorded — degradation not hit"
    return ""


def _tick_failover(cell, cycle: int) -> None:
    if cycle == 3:
        cell.restart_operator()


def _tick_crash(cell, cycle: int) -> None:
    if cell.rng.random() < 0.5:
        cell.client.arm(cell.rng.randint(0, 6))


def _tick_policy_edits(cell, cycle: int) -> None:
    if cycle == 8:
        permissive = _campaign_policy("off")
        cell.policy = permissive
        cell.audit.note_policy_change(permissive)
        cell.notes["policy_edits"] = cell.notes.get("policy_edits", 0) + 1
    elif cycle and cycle < 8 and (cycle == 2 or cell.rng.random() < 0.3):
        edited = UpgradePolicySpec(
            auto_upgrade=cell.rng.random() > 0.2,
            max_parallel_upgrades=cell.rng.choice([0, 1, 2]),
            max_unavailable=IntOrString(cell.rng.choice([1, 2, "25%", "50%"])),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        cell.policy = edited
        cell.audit.note_policy_change(edited)
        cell.notes["policy_edits"] = cell.notes.get("policy_edits", 0) + 1


def _setup_gc_race(cell) -> None:
    cell.store.event_ttl_seconds = 0.01


def _tick_gc_race(cell, cycle: int) -> None:
    # sweep every cycle; restart the operator mid-wave so the fresh
    # sink's adoption path races the sweep
    time.sleep(0.012)
    swept = cell.store.gc_events()
    cell.notes["events_swept"] = cell.notes.get("events_swept", 0) + swept
    if cycle == 4:
        cell.restart_operator()


def _setup_bad_revision(cell) -> None:
    cell.fleet.bad_revisions.add("rev2")


# --------------------------------------------------------------------------
# Federated scenarios (ROADMAP item 5 leftover: plug the federation
# subsystem in as campaign cells).  These run their OWN harness — a
# 3-cell in-mem fleet-of-fleets under a real FederationCoordinator —
# via the Scenario.runner hook, and are judged by the same per-cell
# rollout-invariant checker PLUS the cell-wave property: no un-admitted
# cell admits a node while the wave is held.
# --------------------------------------------------------------------------
class _OutageClient:
    """Cluster-client proxy that, while armed, answers every call with
    a connection error — the coordinator's view of a dead cell
    apiserver.  Counts refusals as the scenario's evidence."""

    def __init__(self, inner):
        self._inner = inner
        self.down = False
        self.refused = 0

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def wrapped(*args, **kwargs):
            if self.down:
                self.refused += 1
                raise OSError("cell apiserver down (chaos outage)")
            return attr(*args, **kwargs)

        return wrapped


class _FedRig:
    """One in-mem federation cell for the chaos runner: store + fleet
    sim + manager + per-cell decision log/sink."""

    def __init__(self, name: str, fleet_size: int, policy) -> None:
        self.name = name
        self.store = InMemoryCluster()
        self.store._journal_cap = 500_000
        self.fleet = SimFleet(self.store, fleet_size)
        self.log = events_mod.DecisionEventLog()
        self.sink = events_mod.ClusterDecisionEventSink(
            self.store, namespace="default"
        )
        self.policy = policy
        from ..cluster.cache import InformerCache

        self.manager = ClusterUpgradeStateManager(
            self.store,
            cache=InformerCache(self.store, lag_seconds=0.0),
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=self.sink,
        )
        self.tape = AuditTape(self.store, policy)

    def reconcile(self) -> None:
        previous = events_mod.set_default_log(self.log)
        try:
            state = self.manager.build_state(
                SimFleet.NAMESPACE, SimFleet.LABELS
            )
            self.manager.apply_state(state, self.policy)
            self.manager.drain_manager.wait_idle(10.0)
            self.manager.pod_manager.wait_idle(10.0)
        except (ApiError, OSError, UpgradeStateError):
            pass
        finally:
            events_mod.set_default_log(previous)
        try:
            self.fleet.reconcile()
        except (ApiError, OSError):
            pass
        self.tape.collect()

    def close(self) -> None:
        self.manager.shutdown()


def _fed_policy() -> UpgradePolicySpec:
    from ..api.upgrade_spec import SloSpec

    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=2,
        max_unavailable=IntOrString("50%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        # lax local breaker: the federated scenarios exercise the
        # COORDINATOR's rollup, not the per-cluster trip
        remediation=RemediationSpec(
            failure_threshold=0.95,
            min_attempted=1000,
            auto_rollback=True,
            backoff_seconds=0.0,
        ),
        slos=SloSpec(fleet_completion_deadline_seconds=86400),
    )


def _run_federated_cell(
    scenario: Scenario,
    transport: str,
    gates: str,
    fleet_size: int,
    seed: int,
    driver: str = "polling",
) -> dict:
    """Scenario.runner for the federated cells: a 3-cell in-mem
    fleet-of-fleets wave under a real coordinator, with the scenario's
    fault injected mid-global-wave.  Judged by the per-cell rollout
    invariants, the decision vocabulary over BOTH planes (cells + the
    coordinator's stream), the cell-wave hold property, and the
    scenario's evidence probe."""
    from ..api.federation_spec import (
        FederationCellSpec,
        FederationPolicySpec,
    )
    from ..federation.coordinator import Cell, FederationCoordinator

    started = time.monotonic()
    rng = random.Random(seed)
    per_cell = max(2, fleet_size // 2)
    prev_registry = metrics.set_default_registry(metrics.MetricsRegistry())
    prev_log = events_mod.set_default_log(events_mod.DecisionEventLog())
    prev_recorder = timeline_mod.set_default_recorder(
        timeline_mod.FlightRecorder()
    )
    violations: List[Violation] = []
    notes: Dict[str, object] = {}
    rigs: List[_FedRig] = []
    cycles = 0
    converged = False
    try:
        brownout = scenario.name == "federated-cell-brownout"
        # mutation-reachable fault timing: how many coordinator ticks
        # the outage lasts / the burn must hold before clearing (the
        # historical constants 3 and 5 remain the defaults)
        outage_cycles = int((scenario.params or {}).get("outage_cycles", 3))
        hold_ticks = int((scenario.params or {}).get("hold_ticks", 5))
        rigs = [
            _FedRig("canary", per_cell, _fed_policy()),
            _FedRig("region", per_cell, _fed_policy()),
            _FedRig("global", per_cell, _fed_policy()),
        ]
        region, global_rig = rigs[1], rigs[2]
        outage = _OutageClient(region.store)
        burn = {"rate": 0.2}

        def region_slo() -> dict:
            # the forged SLO surface the brownout condition reads; the
            # failover scenario leaves it healthy throughout
            return {
                "slos": {
                    "burnRates": {
                        "fleetCompletionDeadlineSeconds": burn["rate"]
                    },
                    "breaches": [],
                },
                "stragglers": [],
                "eta": None,
            }

        cells = []
        for rig in rigs:
            cells.append(
                Cell(
                    name=rig.name,
                    cluster=(
                        outage if rig is region else rig.store
                    ),
                    namespace=SimFleet.NAMESPACE,
                    selector=dict(SimFleet.LABELS),
                    manager=rig.manager,
                    policy=rig.policy,
                    log=rig.log,
                    slo_source=region_slo if rig is region else None,
                )
            )
        spec = FederationPolicySpec(
            name=scenario.name,
            target_revision="rev2",
            cells=(
                FederationCellSpec(name="canary"),
                FederationCellSpec(
                    name="region",
                    advance_on=(
                        ("burn:fleetCompletionDeadlineSeconds < 1.0",)
                        if brownout
                        else ()
                    ),
                ),
                FederationCellSpec(name="global"),
            ),
        )
        coordinator = FederationCoordinator(spec, cells)

        fault_window = 0
        status: dict = {}
        for cycle in range(scenario.max_cycles):
            cycles = cycle + 1
            status = coordinator.evaluate()
            phases = {c["name"]: c["phase"] for c in status["cells"]}
            admitted = {
                c["name"]: bool(c.get("admittedAt"))
                for c in status["cells"]
            }
            if brownout:
                # arm the burn the moment the region is ADMITTED (its
                # samples then read breached before completion can
                # promote it): the completed-but-burning cell must hold
                # in soaking, healthy cells unaffected
                if phases.get("region") == PHASE_ROLLING_FED and (
                    fault_window == 0
                ):
                    burn["rate"] = 5.0
                    fault_window = 1
                    notes["burn_armed_at"] = cycle
                elif fault_window and burn["rate"] > 1.0:
                    if phases.get("region") == "soaking":
                        # completed, held on the breached condition
                        notes["held_ticks"] = (
                            int(notes.get("held_ticks", 0)) + 1
                        )
                        if admitted["global"]:
                            violations.append(
                                Violation(
                                    "federation-wave",
                                    "global cell admitted while the "
                                    "region's SLO burn held its "
                                    "promotion",
                                )
                            )
                        if phases.get("canary") != "promoted":
                            violations.append(
                                Violation(
                                    "federation-wave",
                                    "healthy canary cell disturbed by "
                                    f"the region brownout ({phases})",
                                )
                            )
                        if int(notes.get("held_ticks", 0)) >= hold_ticks:
                            burn["rate"] = 0.2  # brownout clears
                            notes["burn_cleared_at"] = cycle
            else:
                # failover: the region's apiserver dies mid-wave (while
                # it is rolling), for a few coordinator ticks
                if (
                    phases.get("region") == PHASE_ROLLING_FED
                    and fault_window == 0
                ):
                    outage.down = True
                    fault_window = 1
                    notes["outage_at"] = cycle
                elif fault_window and fault_window < 1 + outage_cycles:
                    fault_window += 1
                    if admitted["global"]:
                        violations.append(
                            Violation(
                                "federation-wave",
                                "global cell admitted while the region "
                                "cell's apiserver was down",
                            )
                        )
                elif fault_window >= 1 + outage_cycles and outage.down:
                    outage.down = False
                    notes["outage_cleared_at"] = cycle
            for rig in rigs:
                if rig is region and outage.down:
                    # a dead apiserver means its operator cannot
                    # reconcile either
                    notes["region_skipped"] = (
                        int(notes.get("region_skipped", 0)) + 1
                    )
                    continue
                rig.reconcile()
            if status.get("promotedCells") == 3:
                converged = True
                break
        # settle one final census so the row reflects the end state
        status = coordinator.evaluate()
        converged = converged or status.get("promotedCells") == 3

        # ---- evidence: the fault demonstrably fired AND the hold was
        # audited with the new reason codes
        coord_stream = coordinator.log.export_stream()
        held_targets = {
            d["target"]
            for d in coord_stream
            if d["type"] == events_mod.EVENT_CELL_HELD
        }
        if brownout:
            if not notes.get("held_ticks"):
                violations.append(
                    Violation(
                        "evidence",
                        "the region's SLO burn never demonstrably held "
                        "its promotion",
                    )
                )
        else:
            if outage.refused < 1:
                violations.append(
                    Violation(
                        "evidence",
                        "the region outage never refused a coordinator "
                        "request",
                    )
                )
        if "cell:global" not in held_targets:
            violations.append(
                Violation(
                    "evidence",
                    "no CellHeld decision for the global cell — the "
                    "hold left no audit trail",
                )
            )
        if not converged:
            violations.append(
                Violation(
                    "converged",
                    "the wave did not complete after the fault cleared: "
                    + str(
                        {c["name"]: c["phase"] for c in status["cells"]}
                    ),
                )
            )

        # ---- decision vocabulary over the coordinator's stream (the
        # new cell:* / gate:federation reasons must be REGISTERED)
        for d in coord_stream:
            type_ = d.get("type") or ""
            legal = events_mod.EVENT_REASONS.get(type_)
            if type_ not in events_mod.EVENT_REASONS:
                violations.append(
                    Violation(
                        "decision-vocabulary",
                        f"coordinator emitted unknown type {type_!r}",
                    )
                )
            elif legal is not None and (d.get("reason") or "") not in legal:
                violations.append(
                    Violation(
                        "decision-vocabulary",
                        f"coordinator {type_} carries unregistered "
                        f"reason {d.get('reason')!r}",
                    )
                )

        # ---- the standard per-cell rollout invariants (each cell is a
        # normal single-cluster rollout underneath)
        decisions_total = len(coord_stream)
        agg_signals = {name: 0.0 for name in FITNESS_SIGNALS}
        for rig in rigs:
            decisions = rig.log.export_stream()
            decisions_total += len(decisions)
            persisted = events_mod.decisions_from_cluster(rig.store)
            rig_signals = fitness_signals(
                tape=rig.tape,
                decisions=decisions,
                persisted_decisions=persisted,
                store=rig.store,
                policy=rig.policy,
                ds_name=SimFleet.DS_NAME,
                ds_namespace=SimFleet.NAMESPACE,
            )
            for sig_name, value in rig_signals.items():
                agg_signals[sig_name] = max(agg_signals[sig_name], value)
            cell_violations = check_rollout_invariants(
                rig.store,
                managed_nodes=rig.fleet.managed_nodes,
                policy=rig.policy,
                decisions=decisions,
                tape=rig.tape,
                persisted_decisions=persisted,
                ds_name=SimFleet.DS_NAME,
                ds_namespace=SimFleet.NAMESPACE,
                target_revision="rev2",
                # wave-level non-convergence is already reported once
                # above; None skips the per-cell pile-on
                converged=(
                    rig.fleet.converged("rev2", reader=rig.store)
                    if converged
                    else None
                ),
                expect=scenario.expect,
            )
            for v in cell_violations:
                violations.append(
                    Violation(v.invariant, f"[cell {rig.name}] {v.detail}")
                )
        # the coordinator's own breaker opening is the federation
        # analog of a local trip: the margin signal saturates
        if status.get("breaker"):
            agg_signals["breaker-margin"] = 1.0
        # rng is part of the seed contract even though these scenarios
        # are deterministic by construction today
        del rng
        return {
            "scenario": scenario.name,
            "transport": transport,
            "gates": gates,
            "driver": driver,
            "fleet": fleet_size,
            "seed": seed,
            "wakeups": {},
            "passed": not violations,
            "converged": converged,
            "cycles": cycles,
            "wall_s": round(time.monotonic() - started, 2),
            "decisions": decisions_total,
            "transitions": sum(len(r.tape.transitions) for r in rigs),
            "violations": [v.to_dict() for v in violations],
            "fitness": agg_signals,
            "fitness_score": fitness_score(agg_signals, violations),
        }
    finally:
        for rig in rigs:
            rig.close()
        metrics.set_default_registry(prev_registry)
        events_mod.set_default_log(prev_log)
        timeline_mod.set_default_recorder(prev_recorder)


#: the coordinator's "rolling" phase name (imported lazily to keep the
#: module import graph acyclic — federation imports chaos's SimFleet)
PHASE_ROLLING_FED = "rolling"


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="apiserver-brownout",
            description="random request drops with abrupt connection "
            "closes (with_chaos) — the operator's retry/idempotency "
            "paths under a shedding apiserver",
            transports=("http",),
            setup=_setup_brownout,
            evidence=lambda cell: (
                ""
                if cell.facade.fault_counters["chaos_drops"] >= 1
                else "no request was ever chaos-dropped"
            ),
        ),
        Scenario(
            name="brownout-latency",
            description="every request stalls ~2 ms (seeded jitter) — "
            "the slow brownout that throttles, not breaks",
            transports=("http",),
            setup=_setup_latency,
            evidence=lambda cell: (
                ""
                if cell.facade.fault_counters["delayed_requests"] >= 10
                else "latency injection never engaged"
            ),
        ),
        Scenario(
            name="informer-partition",
            description="two partition windows cut Pod/Node traffic "
            "mid-wave (targeted connection resets after routing)",
            transports=("http",),
            setup=_setup_partition,
            tick=_tick_partition,
            evidence=lambda cell: (
                ""
                if cell.facade.fault_counters["partition_drops"] >= 1
                else "partition hook never dropped a request"
            ),
        ),
        Scenario(
            name="held-stream-truncation",
            description="held watch streams abruptly reset every 4 "
            "frames while the informer reseeds through paginated "
            "relists",
            transports=("http",),
            client_mode="held",
            facade_kwargs={"max_list_page": 3},
            setup=_setup_held_truncation,
            tick=_tick_held_truncation,
            evidence=lambda cell: (
                ""
                if cell.facade.fault_counters["held_flaps"] >= 1
                else "no held stream was ever reset"
            ),
        ),
        Scenario(
            name="clock-skew",
            description="every other persisted decision Event's "
            "timestamps rewritten to a far-future clock (a skewed "
            "operator) — offline ordering must survive",
            transports=("http",),
            # per-op writes so Event bodies cross the body hook (the
            # batch envelope would hide them)
            facade_kwargs={"batch_writes": False},
            setup=_setup_clock_skew,
            evidence=lambda cell: (
                ""
                if cell.facade.fault_counters["body_mutations"] >= 1
                else "no Event body was ever skewed"
            ),
        ),
        Scenario(
            name="journal-410-storm",
            description="journal retention pinned tiny + churn bursts "
            "roll it mid-wave: every journal consumer 410s and the "
            "state index's auto full-rebuild path runs repeatedly",
            transports=("inmem",),
            setup=_setup_journal_storm,
            tick=_tick_journal_storm,
            evidence=_evidence_journal_storm,
            manager_kwargs={"use_state_index": True},
            expect={"audit_gaps": True},
        ),
        Scenario(
            name="batch-endpoint-404",
            description="vanilla apiserver (no batch endpoint): the "
            "write pipeline must degrade to per-op writes and still "
            "converge",
            transports=("http",),
            facade_kwargs={"batch_writes": False},
            manager_kwargs={"write_pipeline_workers": 8},
            evidence=_evidence_batch_404,
        ),
        Scenario(
            name="ha-failover",
            description="the operator process is replaced mid-wave "
            "(fresh manager + decision log + sink): label-resident "
            "state and Event adoption must carry the audit trail over",
            tick=_tick_failover,
            evidence=lambda cell: (
                ""
                if cell.notes.get("operator_restarts", 0) >= 1
                else "failover never happened"
            ),
        ),
        Scenario(
            name="operator-crash",
            description="write-budget crashes truncate reconciles at "
            "random points; each crash boots a replacement process",
            transports=("inmem",),
            crashing=True,
            tick=_tick_crash,
            evidence=lambda cell: (
                ""
                if cell.notes.get("crashes", 0) >= 1
                else "no crash ever fired"
            ),
            expect={"stream_gaps": True},
        ),
        Scenario(
            name="policy-edits",
            description="live policy edits mid-rollout (budgets shrink/"
            "grow, pause/resume), settling permissive — in-flight work "
            "finishes, nothing new admitted past the policy in force",
            tick=_tick_policy_edits,
            evidence=lambda cell: (
                ""
                if cell.notes.get("policy_edits", 0) >= 1
                else "no policy edit ever applied"
            ),
        ),
        Scenario(
            name="event-gc-race",
            description="Event TTL pinned tiny with sweeps every cycle "
            "racing the sink's dedup/adoption, plus an operator restart "
            "mid-sweep — no decision lost, none double-counted",
            setup=_setup_gc_race,
            tick=_tick_gc_race,
            evidence=lambda cell: (
                ""
                if cell.notes.get("events_swept", 0) >= 1
                and cell.notes.get("operator_restarts", 0) >= 1
                else "the TTL sweep or the restart never happened"
            ),
        ),
        Scenario(
            name="bad-revision-rollback",
            description="the published revision bricks its pods: the "
            "breaker must trip, roll back to the LKG, and close the "
            "episode with the fleet back at rev1",
            transports=("inmem",),
            gates=("on",),
            setup=_setup_bad_revision,
            target="rev1",
            expect={"rollback": True},
            max_cycles=250,
            evidence=lambda cell: (
                ""
                if any(
                    d.get("type") == events_mod.EVENT_BREAKER_TRIPPED
                    for d in cell.decisions()
                )
                else "breaker never tripped"
            ),
        ),
        Scenario(
            name="federated-cell-failover",
            description="fleet-of-fleets: a cell's apiserver dies "
            "mid-global-wave — the coordinator holds later cells "
            "(no admission while the wave is blind), resumes when the "
            "cell answers again, and the whole wave converges",
            transports=("inmem",),
            gates=("on",),
            drivers=("polling",),
            runner=_run_federated_cell,
            max_cycles=120,
        ),
        Scenario(
            name="federated-cell-brownout",
            description="fleet-of-fleets: one cell's SLO burn breaches "
            "while its rollout is complete — promotion holds on the "
            "advanceOn condition, healthy cells are unaffected, and "
            "the wave resumes when the burn clears",
            transports=("inmem",),
            gates=("on",),
            drivers=("polling",),
            runner=_run_federated_cell,
            max_cycles=120,
        ),
    )
}


# --------------------------------------------------------------------------
# Campaign + cells.
# --------------------------------------------------------------------------
@dataclass
class Campaign:
    """A declarative scenario sweep: scenarios × axes, one seed."""

    name: str = "default"
    seed: int = 0
    fleet_size: int = 8
    scenarios: Tuple[str, ...] = tuple(SCENARIOS)
    transports: Tuple[str, ...] = ("inmem", "http")
    gates: Tuple[str, ...] = ("on", "off")
    #: the event-driven-vs-polling driver axis (ROADMAP item 5
    #: leftover).  "event" cells run the same scenario with reconciles
    #: SCHEDULED by a workqueue + WakeupSource instead of per-cycle
    #: polling, so fault paths exercise the wakeup machinery too.  The
    #: default matrix crosses it for inmem cells only: the event axis
    #: probes scheduling, which is transport-independent — crossing it
    #: with http as well would double campaign wall for no new edge.
    drivers: Tuple[str, ...] = ("polling", "event")
    #: ratcheted regression cells (``chaos search --ratchet``): minimal
    #: reproducer specs (scenario + axes + mutation vector + campaign
    #: seed) appended after the matrix cells and judged by the same
    #: checker.  The matrix only ever GROWS — a searched-out bug stays
    #: in the sweep forever.  The default campaign (CLI/bench) attaches
    #: the shipped file (chaossearch.load_regression_cells); an
    #: explicit empty tuple keeps a hand-built Campaign matrix-only.
    regression_cells: Tuple[dict, ...] = ()

    def cells(self) -> List[Tuple[str, str, str, str]]:
        out = []
        for name in self.scenarios:
            scenario = SCENARIOS.get(name)
            if scenario is None:
                raise ValueError(
                    f"unknown scenario {name!r} (catalog: "
                    f"{', '.join(sorted(SCENARIOS))})"
                )
            for transport in self.transports:
                if transport not in scenario.transports:
                    continue
                for gates in self.gates:
                    if gates not in scenario.gates:
                        continue
                    for driver in self.drivers:
                        if driver not in scenario.drivers:
                            continue
                        if driver != "polling" and transport != "inmem":
                            continue  # see the drivers docstring
                        out.append((name, transport, gates, driver))
        return out


def campaign_from_dict(data: dict) -> Campaign:
    """The campaign FILE format (``chaos --campaign file.json``)::

        {"name": "nightly", "seed": 7, "fleet": 12,
         "scenarios": ["apiserver-brownout", "policy-edits"],
         "axes": {"transport": ["inmem", "http"], "gates": ["on"]},
         "regression_cells": [{"scenario": ..., "mutations": [...]}],
         "regressions_file": "hack/chaos_regressions.json"}

    Every field is optional; omissions take the default campaign's
    values.  Unknown scenario names fail fast.  ``regression_cells``
    inlines ratcheted reproducer specs; ``regressions_file`` points at
    a ratchet file (chaossearch format) — both may be given, inline
    cells first."""
    axes = data.get("axes") or {}
    # explicit-vs-omitted matters: an operator who edits a campaign file
    # down to "scenarios": [] asked for an error, not the full catalog
    scenarios = (
        tuple(data["scenarios"])
        if "scenarios" in data
        else tuple(SCENARIOS)
    )
    if not scenarios:
        raise ValueError("campaign file selects zero scenarios")
    transports = (
        tuple(axes["transport"])
        if "transport" in axes
        else ("inmem", "http")
    )
    gates = tuple(axes["gates"]) if "gates" in axes else ("on", "off")
    drivers = (
        tuple(axes["driver"])
        if "driver" in axes
        else ("polling", "event")
    )
    if not transports or not gates or not drivers:
        raise ValueError("campaign file declares an empty axis")
    fleet = int(data["fleet"]) if "fleet" in data else 8
    if fleet < 1:
        raise ValueError(f"campaign fleet must be >= 1, got {fleet}")
    regressions: List[dict] = []
    for spec in data.get("regression_cells") or ():
        if not isinstance(spec, dict) or "scenario" not in spec:
            raise ValueError(
                "regression_cells entries must be dicts with a "
                f"'scenario' key, got {spec!r}"
            )
        regressions.append(dict(spec))
    if data.get("regressions_file"):
        from . import chaossearch

        regressions.extend(
            chaossearch.load_regression_cells(data["regressions_file"])
        )
    campaign = Campaign(
        name=str(data.get("name") or "custom"),
        seed=int(data.get("seed") or 0),
        fleet_size=fleet,
        scenarios=scenarios,
        transports=transports,
        gates=gates,
        drivers=drivers,
        regression_cells=tuple(regressions),
    )
    for t in campaign.transports:
        if t not in ("inmem", "http"):
            raise ValueError(f"unknown transport axis value {t!r}")
    for g in campaign.gates:
        if g not in ("on", "off"):
            raise ValueError(f"unknown gates axis value {g!r}")
    for d in campaign.drivers:
        if d not in ("polling", "event"):
            raise ValueError(f"unknown driver axis value {d!r}")
    campaign.cells()  # validates scenario names
    return campaign


def mutation_vector_key(mutations) -> str:
    """Canonical serialization of a mutation vector (a list of plain
    ``{"op": name, ...params}`` dicts): sorted keys, no whitespace — the
    exact bytes that key cell_seed, so two DIFFERENT vectors can never
    alias one seed through formatting differences."""
    return json.dumps(list(mutations), sort_keys=True, separators=(",", ":"))


def cell_seed(campaign_seed: int, scenario: str, transport: str, gates: str,
              fleet_size: int, driver: str = "polling",
              mutations=None) -> int:
    """The documented per-cell seed derivation: stable across runs and
    processes (crc32, not hash() — PYTHONHASHSEED must not matter).
    ``polling`` (the pre-axis default) keys exactly as before, and an
    empty mutation vector keys exactly as the pre-search format, so
    every historical cell seed is unchanged.  A non-empty vector is
    folded in through its canonical serialization — two mutated
    variants of one scenario never share a seed unless they are the
    same mutation (collision hardening; the searcher additionally
    asserts uniqueness across each generated campaign)."""
    key = f"{campaign_seed}:{scenario}:{transport}:{gates}:{fleet_size}"
    if driver != "polling":
        key += f":{driver}"
    if mutations:
        key += ":" + mutation_vector_key(mutations)
    return zlib.crc32(key.encode())


def _campaign_policy(gates: str) -> UpgradePolicySpec:
    if gates == "on":
        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=2,
            max_unavailable=IntOrString("50%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            remediation=RemediationSpec(
                failure_threshold=0.5,
                min_attempted=1,
                auto_rollback=True,
                max_node_attempts=6,
                backoff_seconds=0.0,
            ),
        )
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )


class CampaignCell:
    """One (scenario, transport, gates) cell: owns the store/facade/
    client/fleet/manager and the per-cell process defaults (metrics
    registry, decision log, flight recorder), restored on close."""

    def __init__(
        self,
        scenario: Scenario,
        transport: str,
        gates: str,
        fleet_size: int,
        seed: int,
        driver: str = "polling",
    ):
        self.scenario = scenario
        self.transport = transport
        self.gates = gates
        self.fleet_size = fleet_size
        self.seed = seed
        self.driver = driver
        self.rng = random.Random(seed)
        self.notes: Dict[str, object] = {}
        self.logs: List[events_mod.DecisionEventLog] = []
        self.policy = _campaign_policy(gates)
        self.facade = None
        self.manager = None
        self._prev_registry = metrics.set_default_registry(
            metrics.MetricsRegistry()
        )
        self._prev_log = events_mod.set_default_log(
            events_mod.DecisionEventLog()
        )
        self.logs.append(events_mod.default_log())
        self._prev_recorder = timeline_mod.set_default_recorder(
            timeline_mod.FlightRecorder()
        )
        self._held = False
        #: the audit tape (attached by run_cell once the store is seeded)
        self.audit: Optional[AuditTape] = None
        # everything past the global swaps can fail (port bind, HTTP
        # fleet population, scenario setup): restore-and-reraise, or the
        # leaked cell-local registry/log/recorder would swallow every
        # later cell's (and test's) emissions — and a started facade's
        # server thread would outlive the cell
        try:
            self.store = InMemoryCluster()
            # generous retention so the audit tape can replay the whole
            # cell (storm scenarios re-pin it tight in their setup hook)
            self.store._journal_cap = 500_000
            # event driver: a real workqueue + WakeupSource schedule
            # the passes (journal tee below + worker completions via
            # manager.set_wakeup_source); the polling driver runs one
            # pass per cycle unconditionally, exactly as before
            self.queue = None
            self.wakeup = None
            self._watch_cursor = 0
            self._skipped_streak = 0
            self._pending_request = None
            if driver == "event":
                from ..controller.upgrade_reconciler import UPGRADE_REQUEST
                from ..controller.wakeup import WakeupSource
                from ..controller.workqueue import RateLimitedQueue

                def _count_wakeup(_item, trigger: str) -> None:
                    counts = self.notes.setdefault("wakeups", {})
                    counts[trigger] = counts.get(trigger, 0) + 1

                self.queue = RateLimitedQueue(
                    wakeup_listener=_count_wakeup
                )
                self.wakeup = WakeupSource(self.queue, UPGRADE_REQUEST)
            self.client = self.store
            if transport == "http":
                from ..cluster import (
                    ApiServerFacade,
                    KubeApiClient,
                    KubeConfig,
                )

                self.facade = ApiServerFacade(
                    self.store, **(scenario.facade_kwargs or {})
                ).start()
                self.client = KubeApiClient(
                    KubeConfig(server=self.facade.url), timeout=10.0
                )
            if scenario.crashing:
                self.client = CrashingClient(self.client)
            self.fleet = SimFleet(self.client, fleet_size)
            # install the scenario's faults BEFORE the operator (and any
            # held watch streams) come up: a held stream established
            # before the truncation knob lands reads the knob at stream
            # start and would never flap
            if scenario.setup is not None:
                scenario.setup(self)
            self.manager = self._make_manager()
        except BaseException:
            self.close()
            raise

    def _make_manager(self) -> ClusterUpgradeStateManager:
        from ..cluster.cache import InformerCache

        kwargs = dict(self.scenario.manager_kwargs or {})
        sink = events_mod.ClusterDecisionEventSink(
            self.client, namespace="default"
        )
        if self.scenario.client_mode == "held" and self.transport == "http":
            if not self._held:
                self.client.start_held_watches(("Node", "Pod", "DaemonSet"))
                self._held = True
            cache = InformerCache(
                self.client,
                lag_seconds=0.02,
                kinds=("Node", "Pod", "DaemonSet", "ControllerRevision"),
            )
            kwargs.setdefault("reads_from_cache", True)
        else:
            cache = InformerCache(self.client, lag_seconds=0.0)
        manager = ClusterUpgradeStateManager(
            self.client,
            cache=cache,
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=sink,
            **kwargs,
        )
        if self.wakeup is not None:
            # async drain/pod completions wake the queue — restart
            # replacements (ha-failover, operator-crash) re-attach here
            attach = getattr(manager, "set_wakeup_source", None)
            if attach is not None:
                attach(self.wakeup)
        return manager

    def restart_operator(self) -> None:
        """The HA failover / crash replacement: a NEW process — fresh
        manager, fresh informer cache, fresh decision log (sequences
        restart) and a fresh sink that must ADOPT the persisted Events
        the dead process wrote."""
        old = self.manager
        try:
            old.drain_manager.wait_idle(10.0)
            old.pod_manager.wait_idle(10.0)
        finally:
            old.shutdown()
        events_mod.set_default_log(events_mod.DecisionEventLog())
        self.logs.append(events_mod.default_log())
        self.manager = self._make_manager()
        self.notes["operator_restarts"] = (
            self.notes.get("operator_restarts", 0) + 1
        )

    # --------------------------------------------------- event driver
    def begin_cycle(self) -> bool:
        """Whether this cycle runs a reconcile pass.  Polling: always.
        Event: only when a wakeup scheduled one — the journal tee fires
        a ``watch`` wake on any delta since the last cycle (the cell's
        stand-in for the controller's watch loop), worker completions
        arrive through the manager's WakeupSource, and after 3 quiet
        cycles a ``fallback`` wake fires (the demoted safety-net
        cadence), so gate clocks still make progress."""
        if self.driver != "event":
            return True
        seq = self.store.journal_seq()
        if seq > self._watch_cursor:
            self._watch_cursor = seq
            self.wakeup.wake("watch")
        item = self.queue.get(timeout=0)
        if item is None:
            self._skipped_streak += 1
            self.notes["driver_skipped_cycles"] = (
                self.notes.get("driver_skipped_cycles", 0) + 1
            )
            if self._skipped_streak < 4:
                return False
            self.wakeup.wake("fallback")
            item = self.queue.get(timeout=0)
            if item is None:
                return False
        self._skipped_streak = 0
        self._pending_request = item
        return True

    def end_cycle(self) -> None:
        if self._pending_request is not None:
            self.queue.done(self._pending_request)
            self._pending_request = None

    def decisions(self) -> List[dict]:
        """The cell's merged live decision stream across operator
        restarts: per-process sequences re-based so first-occurrence
        order is global."""
        return merge_decision_streams(self.logs)

    def close(self) -> None:
        try:
            if self.manager is not None:
                self.manager.shutdown()
        finally:
            if getattr(self, "queue", None) is not None:
                self.queue.shutdown()  # stops the delay-timer thread
            if self._held:
                try:
                    self.client.stop_held_watches()
                except Exception:  # noqa: BLE001 — teardown
                    pass
            if self.facade is not None:
                self.facade.stop()
            metrics.set_default_registry(self._prev_registry)
            events_mod.set_default_log(self._prev_log)
            timeline_mod.set_default_recorder(self._prev_recorder)


def merge_decision_streams(logs) -> List[dict]:
    """Merge per-process decision logs (operator restarts) into one
    stream whose firstSeq/seq values are globally ordered: each log's
    sequences are re-based past the previous logs' high-water mark.  An
    EMPTY intermediate log (a replacement that died before deciding
    anything) must not reset the base — later processes' decisions
    would collide with and sort before the first process's."""
    merged: List[dict] = []
    base = 0
    for log in logs:
        top = base
        for e in log.export_stream():
            e = dict(e)
            e["firstSeq"] = int(e.get("firstSeq") or 0) + base
            e["seq"] = int(e.get("seq") or 0) + base
            top = max(top, e["seq"])
            merged.append(e)
        base = top
    return merged


def run_cell(
    scenario: Scenario,
    transport: str,
    gates: str,
    fleet_size: int,
    seed: int,
    driver: str = "polling",
) -> dict:
    """Run one campaign cell end-to-end and check every invariant.
    Returns the cell's scorecard row."""
    if scenario.runner is not None:
        return scenario.runner(
            scenario, transport, gates, fleet_size, seed, driver
        )
    started = time.monotonic()
    cell = CampaignCell(
        scenario, transport, gates, fleet_size, seed, driver=driver
    )
    try:
        cell.audit = AuditTape(cell.store, cell.policy)
        # a short healthy era first (faults already live — see
        # CampaignCell) so the LKG tracker observes rev1 as the
        # standing target before the new revision lands
        for _ in range(2):
            _reconcile_once(cell)
        cell.fleet.publish("rev2")
        converged = False
        cycles = 0
        for cycle in range(scenario.max_cycles):
            cycles = cycle + 1
            if scenario.tick is not None:
                scenario.tick(cell, cycle)
            if cell.begin_cycle():
                try:
                    _reconcile_once(cell)
                finally:
                    cell.end_cycle()
            cell.audit.collect()
            if cell.fleet.converged(scenario.target, reader=cell.store):
                converged = True
                break
        decisions = cell.decisions()
        persisted = events_mod.decisions_from_cluster(cell.store)
        violations = check_rollout_invariants(
            cell.store,
            managed_nodes=cell.fleet.managed_nodes,
            policy=cell.policy,
            decisions=decisions,
            tape=cell.audit,
            persisted_decisions=persisted,
            ds_name=SimFleet.DS_NAME,
            ds_namespace=SimFleet.NAMESPACE,
            target_revision=scenario.target,
            converged=converged,
            expect=scenario.expect,
        )
        evidence = ""
        if scenario.evidence is not None:
            evidence = scenario.evidence(cell) or ""
        if evidence:
            violations.append(Violation("evidence", evidence))
        signals = fitness_signals(
            tape=cell.audit,
            decisions=decisions,
            persisted_decisions=persisted,
            store=cell.store,
            policy=cell.policy,
            ds_name=SimFleet.DS_NAME,
            ds_namespace=SimFleet.NAMESPACE,
        )
        return {
            "scenario": scenario.name,
            "transport": transport,
            "gates": gates,
            "driver": driver,
            "fleet": fleet_size,
            "seed": seed,
            "wakeups": dict(cell.notes.get("wakeups") or {}),
            "passed": not violations,
            "converged": converged,
            "cycles": cycles,
            "wall_s": round(time.monotonic() - started, 2),
            "decisions": len(decisions),
            "transitions": len(cell.audit.transitions),
            "violations": [v.to_dict() for v in violations],
            "fitness": signals,
            "fitness_score": fitness_score(signals, violations),
        }
    finally:
        cell.close()


def _reconcile_once(cell: CampaignCell) -> None:
    """One settled reconcile cycle, tolerant of the faults a scenario
    injects (a production controller retries on the next requeue; the
    campaign's next cycle IS that retry)."""
    manager = cell.manager
    crashed = False
    try:
        state = manager.build_state(SimFleet.NAMESPACE, SimFleet.LABELS)
        manager.apply_state(state, cell.policy)
    except SimulatedCrash:
        crashed = True
    except (ApiError, OSError, UpgradeStateError) as err:
        cell.notes["reconcile_errors"] = (
            cell.notes.get("reconcile_errors", 0) + 1
        )
        logger.debug("chaos cell reconcile error (absorbed): %s", err)
    finally:
        if cell.scenario.crashing:
            cell.client.disarm()
    try:
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
    except (ApiError, OSError):
        pass
    if crashed:
        cell.notes["crashes"] = cell.notes.get("crashes", 0) + 1
        cell.restart_operator()
    try:
        cell.fleet.reconcile()
    except (ApiError, OSError) as err:
        cell.notes["ds_errors"] = cell.notes.get("ds_errors", 0) + 1
        logger.debug("chaos cell DS-controller error (absorbed): %s", err)


def run_campaign(campaign: Campaign, progress=None) -> dict:
    """Run every cell of *campaign*; returns the scorecard artifact."""
    started = time.monotonic()
    rows = []
    for scenario_name, transport, gates, driver in campaign.cells():
        scenario = SCENARIOS[scenario_name]
        seed = cell_seed(
            campaign.seed, scenario_name, transport, gates,
            campaign.fleet_size, driver,
        )
        if progress is not None:
            progress(
                f"cell {scenario_name}/{transport}/gates-{gates}"
                f"/{driver} ..."
            )
        rows.append(
            run_cell(
                scenario, transport, gates, campaign.fleet_size, seed,
                driver=driver,
            )
        )
    if campaign.regression_cells:
        # ratcheted reproducers ride after the matrix (lazy import —
        # chaossearch imports this module at its top)
        from . import chaossearch

        for spec in campaign.regression_cells:
            if progress is not None:
                progress(
                    f"regression cell {spec.get('cell') or spec['scenario']}"
                    " ..."
                )
            rows.append(chaossearch.run_regression_cell(spec))
    passed = sum(1 for r in rows if r["passed"])
    return {
        "campaign": campaign.name,
        "seed": campaign.seed,
        "fleet": campaign.fleet_size,
        "scenarios": len(set(r["scenario"] for r in rows)),
        "cells": rows,
        "cells_total": len(rows),
        "cells_passed": passed,
        "cells_failed": len(rows) - passed,
        "violations": sum(len(r["violations"]) for r in rows),
        "invariants": list(INVARIANTS),
        "wall_s": round(time.monotonic() - started, 2),
    }


def deterministic_scorecard(scorecard: dict) -> dict:
    """The seed-stable core of a scorecard: everything except walls and
    cycle counts (thread scheduling moves those; pass/fail, violations
    and evidence must not move).  ``same seed → same scorecard`` is
    asserted over THIS projection."""
    return {
        "campaign": scorecard.get("campaign"),
        "seed": scorecard.get("seed"),
        "fleet": scorecard.get("fleet"),
        "cells": [
            {
                "scenario": r["scenario"],
                "transport": r["transport"],
                "gates": r["gates"],
                "driver": r.get("driver", "polling"),
                "seed": r["seed"],
                "passed": r["passed"],
                "converged": r["converged"],
                "violations": sorted(
                    v["invariant"] for v in r["violations"]
                ),
                # ratcheted regression cells carry their identity (name
                # + mutation vector) into the replay contract
                **({"cell": r["cell"]} if r.get("cell") else {}),
                **(
                    {"mutations": r["mutations"]}
                    if r.get("mutations")
                    else {}
                ),
            }
            for r in scorecard.get("cells") or []
        ],
        "cells_passed": scorecard.get("cells_passed"),
        "cells_failed": scorecard.get("cells_failed"),
    }


def render_scorecard(scorecard: dict) -> str:
    lines = [
        f"chaos campaign {scorecard['campaign']!r} (seed "
        f"{scorecard['seed']}, fleet {scorecard['fleet']}): "
        f"{scorecard['cells_passed']}/{scorecard['cells_total']} cells "
        f"passed across {scorecard['scenarios']} scenarios "
        f"in {scorecard['wall_s']:.1f}s"
    ]
    for row in scorecard["cells"]:
        mark = "PASS" if row["passed"] else "FAIL"
        lines.append(
            f"  [{mark}] {row['scenario']:<24} {row['transport']:<6} "
            f"gates={row['gates']:<4} "
            f"driver={row.get('driver', 'polling'):<8} "
            f"cycles={row['cycles']:<4} "
            f"decisions={row['decisions']:<4} wall={row['wall_s']:.1f}s"
        )
        for v in row["violations"]:
            lines.append(f"         ! {v['invariant']}: {v['detail']}")
    return "\n".join(lines)


def compact_scorecard(scorecard: dict) -> dict:
    """The bench-tail slice: headline numbers only, prose-free."""
    failed = [
        f"{r['scenario']}/{r['transport']}/{r['gates']}"
        f"/{r.get('driver', 'polling')}"
        for r in scorecard.get("cells") or []
        if not r["passed"]
    ]
    out = {
        "chaos_cells_passed": scorecard.get("cells_passed", 0),
        "chaos_cells_total": scorecard.get("cells_total", 0),
        "chaos_scenarios": scorecard.get("scenarios", 0),
        "chaos_violations": scorecard.get("violations", 0),
        "chaos_wall_s": scorecard.get("wall_s", 0.0),
    }
    if failed:
        out["chaos_failed_cells"] = failed[:4]
    return out


# --------------------------------------------------------------------------
# Selftest (the `make verify-chaos` gate).
# --------------------------------------------------------------------------
def selftest() -> str:
    """End-to-end campaign smoke: one real brownout cell over HTTP
    converges and passes every invariant; then the cluster is tampered
    with (a managed node deleted, an illegal edge forged) and the
    checker must DEMONSTRABLY fail — a checker that cannot fail proves
    nothing.  Raises AssertionError on any violated expectation."""
    scenario = SCENARIOS["apiserver-brownout"]
    seed = cell_seed(0, scenario.name, "http", "off", 6)
    row = run_cell(scenario, "http", "off", 6, seed)
    assert row["converged"], f"brownout cell did not converge: {row}"
    assert row["passed"], f"brownout cell failed the checker: {row}"
    assert row["decisions"] > 0, "no decisions in the stream"
    assert row["transitions"] > 0, "no transitions on the audit tape"

    # ---- now a deliberately broken cell state: the checker must catch
    # each injected violation by name.
    prev_registry = metrics.set_default_registry(metrics.MetricsRegistry())
    prev_log = events_mod.set_default_log(events_mod.DecisionEventLog())
    prev_recorder = timeline_mod.set_default_recorder(
        timeline_mod.FlightRecorder()
    )
    store = InMemoryCluster()
    fleet = SimFleet(store, 4)
    policy = _campaign_policy("off")
    tape = AuditTape(store, policy)
    manager = ClusterUpgradeStateManager(
        store,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005,
    )
    try:
        fleet.publish("rev2")
        for _ in range(60):
            state = manager.build_state(SimFleet.NAMESPACE, SimFleet.LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            fleet.reconcile()
            tape.collect()
            if fleet.converged("rev2"):
                break
        assert fleet.converged("rev2"), "tamper-base cell did not converge"
        healthy = check_rollout_invariants(
            store,
            managed_nodes=fleet.managed_nodes,
            policy=policy,
            decisions=events_mod.default_log().export_stream(),
            tape=tape,
            ds_name=SimFleet.DS_NAME,
            ds_namespace=SimFleet.NAMESPACE,
            target_revision="rev2",
            converged=True,
        )
        assert healthy == [], f"healthy cell reported violations: {healthy}"

        # tamper 1: a managed node vanishes (the lost-node hazard)
        lost = sorted(fleet.managed_nodes)[0]
        store.delete("Node", lost)
        # tamper 2: an illegal edge — done jumps straight to
        # drain-required, which no processor ever writes
        key = util.get_upgrade_state_label_key()
        second = sorted(fleet.managed_nodes)[1]
        store.patch(
            "Node",
            second,
            {"metadata": {"labels": {key: consts.UPGRADE_STATE_DRAIN_REQUIRED}}},
        )
        tape.collect()
        broken = check_rollout_invariants(
            store,
            managed_nodes=fleet.managed_nodes,
            policy=policy,
            decisions=events_mod.default_log().export_stream(),
            tape=tape,
            ds_name=SimFleet.DS_NAME,
            ds_namespace=SimFleet.NAMESPACE,
            target_revision="rev2",
            converged=True,
        )
        caught = {v.invariant for v in broken}
        assert "no-lost-nodes" in caught, (
            f"checker missed the deleted node: {broken}"
        )
        assert "transition-legality" in caught, (
            f"checker missed the illegal edge: {broken}"
        )
    finally:
        manager.shutdown()
        metrics.set_default_registry(prev_registry)
        events_mod.set_default_log(prev_log)
        timeline_mod.set_default_recorder(prev_recorder)
    return (
        "chaos selftest OK: brownout cell converged under "
        f"{row['decisions']} decisions/{row['transitions']} transitions "
        "with every invariant green; tampered cluster flagged "
        f"{sorted(caught)}"
    )
