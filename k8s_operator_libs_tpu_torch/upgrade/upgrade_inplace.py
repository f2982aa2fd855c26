"""In-place mode strategy — the library cordons/drains/uncordons itself.

Reference parity: ``pkg/upgrade/upgrade_inplace.go`` (C3) —

* ``process_upgrade_required_nodes`` (:44-112): resolves
  ``maxUnavailable`` (percent → count, round-up) against the managed
  total, computes slots via the common manager, then moves nodes to
  ``cordon-required`` — removing the upgrade-requested annotation,
  honouring the skip label, and letting *already-cordoned* nodes bypass
  the throttle (:87-97);
* ``process_uncordon_required_nodes`` (:124-147): uncordons and
  finishes, skipping nodes under requestor-mode ownership;
* ``process_node_maintenance_required_nodes``: no-op in this mode
  (:116-122).

TPU-native: with ``policy.slice_aware`` the throttle operates in slice
domains and all upgrade-required nodes of a chosen domain are
co-scheduled, so a multi-host slice goes down once instead of
host-by-host (see :mod:`..tpu.topology`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

from ..api.upgrade_spec import UpgradePolicySpec
from ..cluster.inmem import JsonObj
from ..obs import events as events_mod
from ..tpu import topology
from . import consts, schedule, util
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState

logger = logging.getLogger(__name__)

#: Units whose missing done-at stamp has already been warned about —
#: the soak-skip degrade-open is logged once per unit, not per census.
_soak_skip_logged: set = set()

#: Stable deferral messages per reason code — stable on purpose: the
#: decision log dedups on (type, reason, target), and a per-cycle
#: varying message would churn the persisted Event's message patch.
_DEFER_MESSAGES = {
    events_mod.REASON_BUDGET: "upgrade slot budget exhausted "
    "(maxParallelUpgrades/maxUnavailable)",
    events_mod.REASON_WINDOW: "maintenance window closed",
    events_mod.REASON_PACING: "hourly pacing budget exhausted",
    events_mod.REASON_CANARY: "canary stage holding admissions",
    events_mod.REASON_QUARANTINE: "domain quarantined",
    events_mod.REASON_REMEDIATION: "remediation breaker open",
    events_mod.REASON_SKIP: "node carries the skip label",
    events_mod.REASON_SLICE_DOMAIN: "domain larger than maxNodesPerHour "
    "(can never be admitted under this pacing policy)",
    events_mod.REASON_SLO_GATE: "analysis gate holding (SLO-driven "
    "exposure cap or sustained-breach abort)",
}


def _defer(deferrals: dict, node: JsonObj, reason: str) -> None:
    """Note one deferral decision — collected per pass (a dict append
    is all the per-node hot path pays) and bulk-emitted by
    :func:`_flush_deferrals` so a fully-gated fleet costs one lock +
    one metrics update per REASON per reconcile, not per node."""
    deferrals.setdefault(reason, []).append(
        (node.get("metadata") or {}).get("name") or ""
    )


def _flush_deferrals(log, deferrals: dict) -> int:
    """Emit the pass's collected deferrals (repeat-identical
    occurrences aggregate in the log's dedup ring); returns how many
    nodes were deferred."""
    total = 0
    for reason, names in deferrals.items():
        log.emit_many(
            events_mod.EVENT_NODE_DEFERRED,
            reason,
            names,
            _DEFER_MESSAGES.get(reason, ""),
        )
        total += len(names)
    return total


@dataclass
class CanaryCensus:
    """Point-in-time canary accounting (shared by the scheduler and
    RolloutStatus).  A *unit* is a domain when slice_aware, else a node."""

    #: Units that entered version exposure this generation (admitted-at
    #: stamp + active/done bucket).
    stamped: frozenset
    #: Stamped units whose every node is upgrade-done.
    successful: frozenset
    #: Stamped units still mid-flight.
    in_flight: frozenset
    #: In-flight units with at least one node in upgrade-failed — these
    #: are what freezes a canary.
    failed_units: frozenset
    #: Remaining fresh-unit admissions while the stage holds.
    remaining: int
    #: True once enough units succeeded (and, with canarySoakSeconds,
    #: finished baking): the fleet is open.
    passed: bool
    #: Successful units still inside the canarySoakSeconds bake window.
    soaking: frozenset = frozenset()
    #: Wall-clock time the bake window ends (None when not soaking).
    soak_until: Optional[float] = None


def _canary_walk(
    state: ClusterUpgradeState, slice_aware: bool
) -> tuple:
    """The canary census' single O(fleet) annotation walk:
    ``(stamped, not_done, failed_units, done_at)`` in census units.
    Memoized per snapshot via :meth:`~.common_manager
    .ClusterUpgradeState.scan_memo` — within one reconcile the
    scheduler's canary budget, the analysis exposure census and
    rollout_status each recomputed it; the wall-clock-dependent soak
    math stays per call on top of this walk."""
    from ..cluster.objects import get_annotation, name_of

    key = util.get_admitted_at_annotation_key()
    done_key = util.get_done_at_annotation_key()

    def unit_of(node):
        if slice_aware:
            return topology.domain_of(node)
        return "node:" + name_of(node)

    current_gen_buckets = consts.ACTIVE_STATES + (consts.UPGRADE_STATE_DONE,)
    stamped = set()
    not_done = set()
    failed_units = set()
    done_at: dict = {}  # unit -> newest member done-at stamp
    for bucket, node_states in state.node_states.items():
        if bucket not in consts.ALL_STATES:
            continue
        for ns in node_states:
            unit = unit_of(ns.node)
            if bucket in current_gen_buckets and get_annotation(ns.node, key):
                stamped.add(unit)
            if bucket != consts.UPGRADE_STATE_DONE:
                not_done.add(unit)
            else:
                raw = get_annotation(ns.node, done_key)
                try:
                    ts = float(raw) if raw else 0.0
                except ValueError:
                    ts = 0.0
                done_at[unit] = max(done_at.get(unit, 0.0), ts)
            if bucket == consts.UPGRADE_STATE_FAILED:
                failed_units.add(unit)
    return stamped, not_done, failed_units, done_at


def canary_census(
    state: ClusterUpgradeState,
    policy: UpgradePolicySpec,
    now: Optional[float] = None,
) -> CanaryCensus:
    """Compute the canary stage's exposure accounting (see
    :meth:`InplaceNodeStateManager._canary_budget` for the full
    semantics; this is its census, extracted pure so RolloutStatus can
    explain a frozen canary — which unit failed — without a manager).

    With ``policy.canary_soak_seconds`` a successful unit only counts
    toward opening the fleet once its newest member done-at stamp is
    older than the soak window (the bake gate).  Nodes done WITHOUT a
    stamp (upgraded before the stamp existed) count as already soaked —
    degrading open, never wedging the gate forever."""
    import time as _time

    now_ts = _time.time() if now is None else now
    slice_aware = bool(policy.slice_aware)
    stamped, not_done, failed_units, done_at = state.scan_memo(
        ("canary-walk", slice_aware),
        lambda: _canary_walk(state, slice_aware),
    )
    successful = stamped - not_done
    in_flight = stamped - successful
    soak = policy.canary_soak_seconds
    soaking = set()
    soak_until = None
    if soak > 0:
        soaking = {
            u
            for u in successful
            if now_ts - done_at.get(u, 0.0) < soak
        }
        if soaking:
            soak_until = max(done_at[u] for u in soaking) + soak
    baked = successful - soaking
    if soak > 0:
        # Degrade-open visibility: a done unit with a missing/garbled
        # done-at stamp (upgraded before this release, or a corrupted
        # annotation) counts as already soaked.  Intentional — but say
        # so ONCE per unit, so an operator can see the bake window was
        # skipped rather than silently waived.
        for u in baked:
            if done_at.get(u, 0.0) == 0.0 and u not in _soak_skip_logged:
                _soak_skip_logged.add(u)
                logger.warning(
                    "canary unit %s is done without a parsable done-at "
                    "stamp; treating it as already soaked (the "
                    "canarySoakSeconds bake window is skipped for it)",
                    u,
                )
    passed = len(baked) >= policy.canary_domains
    return CanaryCensus(
        stamped=frozenset(stamped),
        successful=frozenset(successful),
        in_flight=frozenset(in_flight),
        failed_units=frozenset(in_flight & failed_units),
        remaining=max(0, policy.canary_domains - len(stamped)),
        passed=passed,
        soaking=frozenset(soaking),
        soak_until=soak_until,
    )


def quarantined_domains(
    state: ClusterUpgradeState, policy: UpgradePolicySpec
):
    """Domains barred from STARTING an upgrade because a member host
    has a degraded TPU (policy.quarantine_degraded; see tpu.health).
    Returns None when the policy is off — no scan, no behavior change.
    Mode-independent (the requestor handoff honors it too — handing a
    degraded slice to the maintenance operator starts exactly the
    disruption the quarantine exists to prevent).

    Sources, unioned: live degradation signals (conditions/labels)
    AND the quarantine annotation SliceHealthManager maintains — so a
    manually stamped quarantine is honored even when no live signal
    is present."""
    if not policy.quarantine_degraded:
        return None
    from ..tpu import health, topology as topo

    quarantine_key = util.get_quarantine_annotation_key()
    nodes = [ns.node for ns in state.all_node_states()]
    out = health.degraded_domains(nodes)
    for node in nodes:
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        if annotations.get(quarantine_key):
            out.add(topo.domain_of(node))
    return out


def canary_budget(
    state: ClusterUpgradeState,
    policy: UpgradePolicySpec,
) -> tuple:
    """(remaining fresh-unit admissions, participating units) while the
    canary stage holds, or ``(None, frozenset())`` once it has passed.

    The mode-independent half of the canary gate (both the in-place
    schedulers and the requestor handoff charge against this): fresh
    units spend *remaining*; *participating* units (already stamped
    into version exposure) keep flowing without re-charging.  Logs the
    freeze exactly when the budget is actually holding work back."""
    census = canary_census(state, policy)
    if census.passed:
        return None, frozenset()
    if census.remaining == 0 and state.nodes_in(
        consts.UPGRADE_STATE_UPGRADE_REQUIRED
    ):
        logger.info(
            "canary stage: %d/%d domains succeeded, %d in flight — "
            "admissions frozen until the canary completes",
            len(census.successful),
            policy.canary_domains,
            len(census.in_flight),
        )
    return census.remaining, census.stamped


class InplaceNodeStateManager:
    def __init__(self, common: CommonUpgradeManager) -> None:
        self._common = common

    # ---------------------------------------------------- upgrade-required
    def process_upgrade_required_nodes(
        self,
        state: ClusterUpgradeState,
        policy: UpgradePolicySpec,
        remediation=None,
        analysis=None,
    ) -> None:
        common = self._common
        slice_aware = policy.slice_aware
        if slice_aware:
            total = topology.count_domains(
                ns.node for ns in state.all_node_states()
            )
        else:
            total = common.get_total_managed_nodes(state)
        max_unavailable = total
        if policy.max_unavailable is not None:
            max_unavailable = policy.max_unavailable.scaled_value(
                total, round_up=True
            )
        available = common.get_upgrades_available(
            state,
            policy.max_parallel_upgrades,
            max_unavailable,
            slice_aware=slice_aware,
        )
        logger.info(
            "upgrade slots: available=%d maxParallel=%d maxUnavailable=%d "
            "total=%d slice_aware=%s",
            available,
            policy.max_parallel_upgrades,
            max_unavailable,
            total,
            slice_aware,
        )

        # Schedule gates (upgrade/schedule.py): a closed maintenance
        # window zeroes the slot budget (bypasses — already-active-domain
        # stragglers, manually cordoned nodes — still finish); pacing caps
        # how many node admissions the trailing hour may add.
        window_closed = False
        if policy.maintenance_window is not None and not schedule.window_open(
            policy.maintenance_window
        ):
            logger.info("outside maintenance window; no new admissions")
            available = 0
            window_closed = True
        pacing = schedule.pacing_budget(
            policy, (ns.node for ns in state.all_node_states()), state=state
        )
        canary = None
        if policy.canary_domains > 0:
            canary = self._canary_budget(state, policy)

        # Remediation gate: a tripped breaker pauses FRESH version
        # exposure (bypass admissions included — a cordoned node still
        # runs the bad revision); stragglers of already-active domains
        # keep flowing (their slice is already disrupted, stranding it
        # half-upgraded is worse).  The retry-budget quarantine routes
        # the wave around chronically failing domains regardless of
        # policy.quarantine_degraded.
        remediation_blocked = remediation is not None and remediation.paused
        if remediation_blocked and state.nodes_in(
            consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ):
            logger.info(
                "remediation breaker open; fresh admissions paused (%s)",
                remediation.reason,
            )
        quarantined = self._quarantined_domains(state, policy)
        if remediation is not None and remediation.quarantined_domains:
            quarantined = (quarantined or set()) | set(
                remediation.quarantined_domains
            )

        # Analysis gate (upgrade/analysis.py): an aborted analysis
        # blocks all fresh version exposure (reason gate:slo) until the
        # target moves off the aborted revision; the AIMD wave scale
        # multiplies the slot budget (never above the declared
        # maxUnavailable — scale <= 1.0); the active step's exposure
        # cap charges fresh units like the canary budget does.
        analysis_blocked = analysis is not None and analysis.aborted
        exposure = (
            analysis.exposure_remaining if analysis is not None else None
        )
        if analysis is not None and analysis.wave_scale < 1.0:
            from .analysis import scaled_slots

            scaled = scaled_slots(available, analysis.wave_scale)
            if scaled != available:
                logger.info(
                    "adaptive pacing: wave scaled %d -> %d slots "
                    "(scale %.2f)",
                    available,
                    scaled,
                    analysis.wave_scale,
                )
                available = scaled
        if analysis_blocked and state.nodes_in(
            consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ):
            logger.info(
                "analysis aborted; fresh admissions paused (%s)",
                analysis.abort_reason,
            )

        log = events_mod.default_log()
        node_states = state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED)
        if slice_aware:
            admitted, deferred = self._schedule_by_domain(
                state,
                node_states,
                available,
                quarantined,
                pacing,
                pacing_limit=policy.max_nodes_per_hour,
                canary=canary,
                remediation_blocked=remediation_blocked,
                window_closed=window_closed,
                log=log,
                analysis_blocked=analysis_blocked,
                exposure=exposure,
            )
        else:
            admitted, deferred = self._schedule_by_node(
                node_states,
                available,
                quarantined,
                pacing,
                canary=canary,
                remediation_blocked=remediation_blocked,
                window_closed=window_closed,
                log=log,
                analysis_blocked=analysis_blocked,
                exposure=exposure,
            )
        if admitted:
            # Admission writes stamped admitted-at annotations on the
            # snapshot's node dicts in place: drop the scan memos so
            # post-apply consumers of the SAME snapshot (explain /
            # rollout_status on the manager's last state) re-derive the
            # pacing/canary censuses from the written values.  (With
            # cascade on, the bucket migration already invalidated.)
            state.invalidate_census()
            # One wave-summary decision per admitting pass (repeats
            # aggregate; the message keeps the latest wave's shape).
            log.emit(
                events_mod.EVENT_WAVE_PLANNED,
                "scheduled",
                events_mod.FLEET_TARGET,
                f"admitted {admitted} node(s), deferred {deferred} "
                f"(slots={available} maxParallel="
                f"{policy.max_parallel_upgrades} "
                f"maxUnavailable={max_unavailable})",
            )

    def _canary_budget(
        self,
        state: ClusterUpgradeState,
        policy: UpgradePolicySpec,
    ) -> Optional[int]:
        """Canary staging (``policy.canary_domains`` > 0): the rollout
        admits at most that many units until every one of them reaches
        upgrade-done; only then does the fleet open up.  A failed canary
        therefore freezes the rollout — exactly the blast-radius contract
        a canary exists to give.

        Returns the remaining canary admissions, or ``None`` once the
        stage has passed (fleet open).  The canary is a cap on exposure
        to the NEW VERSION, so it gates throttle-BYPASS admissions too
        (manually cordoned nodes): those add no new unavailability, but
        they absolutely add version exposure — the schedulers charge
        every fresh unit admission, bypass or not, against this budget.

        Stateless: a unit (domain when slice_aware, node otherwise — the
        census must use the same unit admissions spend) "participates"
        when a member node carries the admitted-at stamp AND sits in an
        active or done bucket; stamps on upgrade-required/unknown nodes
        are leftovers from a PREVIOUS rollout generation (the stamp
        itself is never cleared — pacing's trailing-hour count must
        survive generations) and are ignored.  A participant succeeded
        when all its nodes are upgrade-done."""
        remaining, _participating = canary_budget(state, policy)
        return remaining

    def _quarantined_domains(
        self, state: ClusterUpgradeState, policy: UpgradePolicySpec
    ):
        return quarantined_domains(state, policy)

    def _prepare(self, node_state: NodeUpgradeState) -> bool:
        """Annotation/skip handling; returns False if the node must be
        skipped (reference :72-86)."""
        common = self._common
        node = node_state.node
        if common.is_upgrade_requested(node):
            common.provider.change_node_upgrade_annotation(
                node,
                util.get_upgrade_requested_annotation_key(),
                consts.NULL_STRING,
            )
        if common.skip_node_upgrade(node):
            logger.info(
                "node %s is marked to skip upgrades",
                (node.get("metadata") or {}).get("name", ""),
            )
            return False
        return True

    def _schedule_by_node(
        self,
        node_states: List[NodeUpgradeState],
        available: int,
        quarantined=None,
        pacing=None,
        canary: Optional[int] = None,
        remediation_blocked: bool = False,
        window_closed: bool = False,
        log=None,
        analysis_blocked: bool = False,
        exposure: Optional[int] = None,
    ) -> tuple:
        """Returns ``(admitted, deferred)`` node counts for the wave
        summary; every defer records a reason-coded decision event."""
        log = log if log is not None else events_mod.default_log()
        common = self._common
        admitted = 0
        deferrals: dict = {}
        if analysis_blocked:
            # An aborted analysis blocks ALL fresh version exposure —
            # same stance as the breaker, but with the SLO reason code
            # so explain answers "aborted on slowness, not breakage".
            for node_state in node_states:
                _defer(
                    deferrals, node_state.node, events_mod.REASON_SLO_GATE
                )
            return 0, _flush_deferrals(log, deferrals)
        if remediation_blocked:
            # Node-granular mode has no domain-straggler notion: every
            # admission is fresh version exposure, so a tripped breaker
            # blocks them all.
            for node_state in node_states:
                _defer(
                    deferrals, node_state.node, events_mod.REASON_REMEDIATION
                )
            return 0, _flush_deferrals(log, deferrals)
        for node_state in node_states:
            if not self._prepare(node_state):
                _defer(deferrals, node_state.node, events_mod.REASON_SKIP)
                continue
            node = node_state.node
            if quarantined and topology.domain_of(node) in quarantined:
                logger.info(
                    "node %s is quarantined (degraded domain), not admitting",
                    (node.get("metadata") or {}).get("name", ""),
                )
                _defer(deferrals, node, events_mod.REASON_QUARANTINE)
                continue
            bypass = common.is_node_unschedulable(node)
            if not bypass:
                if available <= 0:
                    # Limit reached; only manually-cordoned nodes may
                    # proceed (reference :87-97).  The reason code says
                    # WHICH budget zeroed the slots.
                    _defer(
                        deferrals,
                        node,
                        events_mod.REASON_WINDOW
                        if window_closed
                        else events_mod.REASON_BUDGET,
                    )
                    continue
                if pacing is not None and pacing <= 0:
                    _defer(deferrals, node, events_mod.REASON_PACING)
                    continue  # hourly pacing budget spent
            # The canary budget caps VERSION exposure, so it gates bypass
            # admissions too — a cordoned node adds no new unavailability
            # but still runs the new version.
            if canary is not None and canary <= 0:
                _defer(deferrals, node, events_mod.REASON_CANARY)
                continue
            # The analysis step's exposure cap is the same contract as
            # the canary budget (version exposure), with the SLO gate's
            # reason code.
            if exposure is not None and exposure <= 0:
                _defer(deferrals, node, events_mod.REASON_SLO_GATE)
                continue
            common.provider.change_node_upgrade_state(
                node, consts.UPGRADE_STATE_CORDON_REQUIRED
            )
            # Every admission is stamped — the canary census must see
            # bypass admissions too, or blast radius could exceed
            # canaryDomains — but bypasses (already cordoned) carry the
            # pacing-exempt marker: they continue an existing disruption
            # and must not starve later hours' budgets.  The SLOT budget
            # still decrements unconditionally (reference behavior,
            # :87-97).
            schedule.stamp_admission(common.provider, node, bypass=bypass)
            admitted += 1
            if not bypass and pacing is not None:
                pacing -= 1
            if canary is not None:
                canary -= 1
            if exposure is not None:
                exposure -= 1
            available -= 1
        return admitted, _flush_deferrals(log, deferrals)

    def _schedule_by_domain(
        self,
        state: ClusterUpgradeState,
        node_states: List[NodeUpgradeState],
        available: int,
        quarantined=None,
        pacing=None,
        pacing_limit: int = 0,
        canary: Optional[int] = None,
        remediation_blocked: bool = False,
        window_closed: bool = False,
        log=None,
        analysis_blocked: bool = False,
        exposure: Optional[int] = None,
    ) -> tuple:
        """Slice-aware scheduling: one slot = one domain; all of a chosen
        domain's upgrade-required nodes advance together.  Returns
        ``(admitted, deferred)`` node counts; every deferred node
        records a reason-coded decision event.

        A domain with peers already in an active upgrade state admits its
        upgrade-required stragglers WITHOUT consuming a slot — the domain
        already holds one, and it is already down as a failure domain, so
        delaying the stragglers only extends the outage.  This is the
        domain-granular analog of the reference's cordoned-node throttle
        bypass (upgrade_inplace.go:87-97), and it is what keeps a
        crash-split domain (one host admitted, the operator died before
        writing the peer) from wedging: with maxParallelUpgrades=1 the
        active half pins the only slot, and in slice-coherent safe-load
        mode it is parked at the barrier waiting for the very peer the
        throttle would otherwise never admit."""
        log = log if log is not None else events_mod.default_log()
        common = self._common
        admitted = 0
        deferrals: dict = {}

        def defer_domain(nodes, reason) -> None:
            for node in nodes:
                _defer(deferrals, node, reason)

        active_domains = {
            topology.domain_of(ns.node)
            for bucket, nss in state.node_states.items()
            if bucket in consts.ACTIVE_STATES
            for ns in nss
        }
        eligible = []
        for ns in node_states:
            if self._prepare(ns):
                eligible.append(ns)
            else:
                _defer(deferrals, ns.node, events_mod.REASON_SKIP)
        domains = topology.group_by_domain([ns.node for ns in eligible])
        for domain, nodes in domains.items():
            bypass = domain in active_domains or any(
                common.is_node_unschedulable(n) for n in nodes
            )
            # A FRESH unit enters version exposure with this admission;
            # active-domain stragglers already did at their domain's
            # original (stamped) admission.
            fresh = domain not in active_domains
            # Quarantine bars STARTING a degraded domain; an already-active
            # domain still finishes (stranding it half-upgraded is worse).
            if quarantined and domain in quarantined and fresh:
                logger.info(
                    "domain %s is quarantined (degraded host), not admitting",
                    domain,
                )
                defer_domain(nodes, events_mod.REASON_QUARANTINE)
                continue
            # Tripped breaker: no FRESH version exposure; active-domain
            # stragglers still finish (same principle as quarantine).
            if remediation_blocked and fresh:
                defer_domain(nodes, events_mod.REASON_REMEDIATION)
                continue
            # Aborted analysis: same contract, SLO reason code.
            if analysis_blocked and fresh:
                defer_domain(nodes, events_mod.REASON_SLO_GATE)
                continue
            if not bypass:
                if available <= 0:
                    defer_domain(
                        nodes,
                        events_mod.REASON_WINDOW
                        if window_closed
                        else events_mod.REASON_BUDGET,
                    )
                    continue
                # pacing counts NODES: the whole domain co-schedules, so
                # it must fit in the remaining hourly budget (stragglers
                # of active domains are exempt — their slice is already
                # down)
                if pacing is not None and len(nodes) > pacing:
                    if pacing_limit and len(nodes) > pacing_limit:
                        # no trailing hour can EVER fit this domain: the
                        # policy is unsatisfiable for it — surface loudly
                        # instead of deferring in silence forever
                        logger.warning(
                            "domain %s has %d nodes but maxNodesPerHour=%d "
                            "— it can never be admitted; raise the limit "
                            "or exempt the domain",
                            domain,
                            len(nodes),
                            pacing_limit,
                        )
                        defer_domain(nodes, events_mod.REASON_SLICE_DOMAIN)
                    else:
                        defer_domain(nodes, events_mod.REASON_PACING)
                    continue
            # The canary budget caps VERSION exposure: every fresh domain
            # — including cordoned-node bypasses — consumes it; active-
            # domain stragglers are already counted via their stamp.
            if canary is not None and fresh and canary <= 0:
                defer_domain(nodes, events_mod.REASON_CANARY)
                continue
            # Analysis exposure cap charges fresh UNITS, like canary.
            if exposure is not None and fresh and exposure <= 0:
                defer_domain(nodes, events_mod.REASON_SLO_GATE)
                continue
            for node in nodes:
                common.provider.change_node_upgrade_state(
                    node, consts.UPGRADE_STATE_CORDON_REQUIRED
                )
                # bypass admissions stamped too (canary census), with the
                # pacing-exempt marker — see _schedule_by_node
                schedule.stamp_admission(common.provider, node, bypass=bypass)
                admitted += 1
            if canary is not None and fresh:
                canary -= 1
            if exposure is not None and fresh:
                exposure -= 1
            if not bypass:
                available -= 1
                if pacing is not None:
                    pacing -= len(nodes)
        return admitted, _flush_deferrals(log, deferrals)

    # ------------------------------------------------- node-maintenance (n/a)
    def process_node_maintenance_required_nodes(
        self, state: ClusterUpgradeState
    ) -> None:
        """No-op for in-place mode (reference :116-122)."""

    # ---------------------------------------------------- uncordon-required
    def process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        common = self._common
        for node_state in state.nodes_in(consts.UPGRADE_STATE_UNCORDON_REQUIRED):
            node = node_state.node
            if util.is_node_in_requestor_mode(node):
                # handled by the requestor flow (reference :131-134)
                continue
            common.cordon_manager.uncordon(node)
            common.provider.change_node_upgrade_state(
                node, consts.UPGRADE_STATE_DONE
            )
