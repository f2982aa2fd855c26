"""SLO-driven analysis gates + adaptive pacing — the observe→decide loop.

Four observability planes (tracing, flight recorder/SLO, decision
events, profiling) made rollouts visible; this module makes the SLO
plane *drive* them, Argo-Rollouts-style.  The policy's ``analysis``
block (:class:`~..api.upgrade_spec.AnalysisSpec`) declares ordered
steps with ``advanceOn``/``abortOn`` conditions over the SLO engine's
report — burn rates, breach counts, stragglers, phase quantiles, the
write-queue depth — and this engine evaluates them each reconcile over
the **metrics-history ring** (:mod:`..obs.history`), so a gate flips on
a *sustained* observation, never one noisy sample:

* while a step is ACTIVE, its ``maxExposure`` caps how many units
  (slice domains / nodes) may be in version exposure — the scheduler
  defers everything beyond it with reason code ``gate:slo``;
* when every ``advanceOn`` condition has held for its declared window,
  the step ADVANCES (``AnalysisStepAdvanced`` decision event) — a
  canary soak that auto-advances on healthy SLOs instead of a fixed
  wall-clock bake;
* when any ``abortOn`` condition holds sustained, the rollout ABORTS:
  the remediation breaker trips with the SLO reason
  (``BreakerTripped[slo]``) and, under ``remediation.autoRollback``,
  the fleet reverts to the last-known-good revision — the rollback
  that previously only hard failures could trigger.  The abort latch
  releases when the observed target moves off the aborted revision
  (rollback landed, or a fixed revision was published), and the
  analysis restarts from its first step for the new revision;
* the :class:`PacingController` runs AIMD (additive-increase,
  multiplicative-decrease) over three congestion signals — worst burn
  rate, straggler count, ``write_queue_depth`` — producing a wave-scale
  in ``(0, 1]`` that multiplies the scheduler's slot budget and the
  write dispatcher's worker concurrency, so a large fleet finds its own
  safe throughput instead of shipping a static ``maxUnavailable``.
  Every change emits ``PacingAdapted[pacing:adapt]``.

While the remediation engine reports ``paused`` or ``rollback_active``
the analysis is SUSPENDED — exposure caps must never gate the rollback
wave that is undoing the damage.  Engine state (step index, abort
latch, pacing scale) is in-memory: after an operator restart the
analysis restarts from its first step and re-advances once its
conditions re-sustain — it can only hold *longer*, never skip ahead,
which is the safe direction for a gate.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..api.upgrade_spec import AnalysisCondition, AnalysisSpec
from ..obs import events as events_mod
from ..obs import history as history_mod
from . import consts, util

logger = logging.getLogger(__name__)


# ------------------------------------------------------- metric resolution
def history_key(metric: str) -> str:
    """Map a condition metric name to its history-ring series name (the
    SLO engine's recording vocabulary)."""
    if metric.startswith("burn:"):
        return "slo_burn_rate:" + metric[len("burn:"):]
    for q in ("p50", "p95", "p99"):
        prefix = f"phase_{q}:"
        if metric.startswith(prefix):
            return f"slo_phase_seconds:{metric[len(prefix):]}:{q}"
    return {
        "breaches": "slo_breaches",
        "stragglers": "rollout_stragglers",
        "eta": "rollout_eta_seconds",
        "queue": "write_queue_depth",
    }.get(metric, metric)


def resolve_metric(
    metric: str, slo_report: Optional[dict], queue_depth: Optional[float] = None
) -> Optional[float]:
    """Instantaneous value of a condition metric from an SLO report
    (the offline CLI path and the condition-value rendering); None when
    the metric is not observable in this report."""
    report = slo_report or {}
    if metric.startswith("burn:"):
        burn = (report.get("slos") or {}).get("burnRates") or {}
        return burn.get(metric[len("burn:"):])
    if metric == "breaches":
        if report.get("slos") is None:
            return None
        return float(len((report.get("slos") or {}).get("breaches") or []))
    if metric == "stragglers":
        if "stragglers" not in report:
            return None
        return float(len(report.get("stragglers") or []))
    if metric == "eta":
        # unknown eta is UNOBSERVED (None), not the -1 gauge sentinel:
        # "eta <= N" must never hold on missing data
        eta = (report.get("eta") or {}).get("seconds")
        return float(eta) if eta is not None else None
    if metric == "queue":
        return queue_depth
    for q in ("p50", "p95", "p99"):
        prefix = f"phase_{q}:"
        if metric.startswith(prefix):
            stat = (report.get("phases") or {}).get(metric[len(prefix):])
            return None if stat is None else float(stat.get(q))
    return None


def worst_burn_rate(slo_report: Optional[dict]) -> Optional[float]:
    burn = ((slo_report or {}).get("slos") or {}).get("burnRates") or {}
    return max(burn.values()) if burn else None


def current_target_hash(state, common) -> str:
    """The primary driver DaemonSet's target revision hash — the abort
    latch's release oracle (same first-DS-by-name convention as the
    remediation engine)."""
    from ..cluster.objects import name_of

    daemon_sets: Dict[str, object] = {}
    for ns in state.managed_node_states():
        ds = ns.driver_daemonset
        if ds is not None:
            daemon_sets.setdefault(name_of(ds), ds)
    for ds_name in sorted(daemon_sets):
        try:
            target = common.pod_manager.get_daemonset_controller_revision_hash(
                daemon_sets[ds_name]
            )
        except Exception:  # noqa: BLE001 — no revisions yet / stub manager
            continue
        if target:
            return target
    return ""


def exposure_census(state, policy) -> Tuple[int, int]:
    """(total_units, exposed_units) for the active step's exposure cap.
    A *unit* is a slice domain when ``sliceAware``, else a node; a unit
    is EXPOSED when a member carries the admitted-at stamp and sits in
    an active or done bucket — the canary census' version-exposure
    rule.  Slice mode reuses :func:`~.upgrade_inplace.canary_census`
    outright (domain grouping must never disagree between the two
    gates); node mode takes a lean direct count — this census runs
    every reconcile under an analysis block, and the full canary
    census' per-node unit strings + soak accounting measurably taxed
    the 1,024-node steady cycle (the ``gate_eval_overhead_pct_1024n``
    gate)."""
    if policy.slice_aware:
        from ..tpu import topology
        from .upgrade_inplace import canary_census

        census = canary_census(state, policy)
        total = topology.count_domains(
            ns.node for ns in state.managed_node_states()
        )
        return total, len(census.stamped)
    key = util.get_admitted_at_annotation_key()
    current_gen = consts.ACTIVE_STATES + (consts.UPGRADE_STATE_DONE,)
    total = 0
    exposed = 0
    for bucket, node_states in state.node_states.items():
        if bucket not in consts.ALL_STATES:
            continue
        total += len(node_states)
        if bucket not in current_gen:
            continue
        for ns in node_states:
            annotations = (
                (ns.node.get("metadata") or {}).get("annotations") or {}
            )
            if annotations.get(key):
                exposed += 1
    return total, exposed


# ---------------------------------------------------------------- pacing
class PacingController:
    """AIMD wave-scale controller (congestion control for admissions).

    One knob — ``scale`` in ``[min_scale, 1.0]`` — moved at most once
    per ``adjust_interval_seconds``: any congestion signal over its
    threshold multiplies the scale by ``decrease``; all signals clear
    adds ``increase``.  The scale NEVER exceeds 1.0, so the policy's
    declared ``maxUnavailable``/``maxParallelUpgrades`` remain the hard
    ceiling (property-tested)."""

    def __init__(self) -> None:
        self._scale = 1.0
        self._last_adjust: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def scale(self) -> float:
        with self._lock:
            return self._scale

    def reset(self) -> None:
        with self._lock:
            self._scale = 1.0
            self._last_adjust = None

    def update(
        self,
        spec,
        burn: Optional[float],
        stragglers: int,
        queue_depth: float,
        now: Optional[float] = None,
    ) -> Tuple[float, List[str]]:
        """One control tick; returns ``(scale, congestion_signals)``.
        Emits ``PacingAdapted[pacing:adapt]`` and counts
        ``pacing_adjustments_total{direction}`` on every change."""
        now = time.time() if now is None else now
        congested: List[str] = []
        if burn is not None and burn > spec.burn_high:
            congested.append(
                f"slo_burn_rate {burn:g} > {spec.burn_high:g}"
            )
        if stragglers > spec.max_stragglers:
            congested.append(
                f"stragglers {stragglers} > {spec.max_stragglers}"
            )
        if queue_depth > spec.queue_high:
            congested.append(
                f"write_queue_depth {queue_depth:g} > {spec.queue_high:g}"
            )
        with self._lock:
            old = self._scale
            if (
                self._last_adjust is not None
                and now - self._last_adjust < spec.adjust_interval_seconds
            ):
                return old, congested
            if congested:
                new = max(spec.min_scale, old * spec.decrease)
                direction = "decrease"
            elif old < 1.0:
                new = min(1.0, old + spec.increase)
                direction = "increase"
            else:
                return old, congested
            if new == old:
                return old, congested
            self._scale = new
            self._last_adjust = now
        metrics.record_pacing_adjustment(direction)
        events_mod.emit(
            events_mod.EVENT_PACING_ADAPTED,
            events_mod.REASON_PACING_ADAPT,
            events_mod.FLEET_TARGET,
            f"wave scale {old:.2f} -> {new:.2f} "
            + (
                f"({'; '.join(congested)})"
                if congested
                else "(pressure cleared)"
            ),
        )
        logger.info(
            "adaptive pacing: wave scale %.2f -> %.2f (%s)",
            old,
            new,
            "; ".join(congested) or "pressure cleared",
        )
        return new, congested


def scaled_slots(available: int, wave_scale: float) -> int:
    """Apply the pacing scale to a slot budget: never above the
    declared budget (scale <= 1.0), never starving a non-empty budget
    to zero (the rollout always retains a trickle)."""
    if available <= 0 or wave_scale >= 1.0:
        return available
    return max(1, int(available * wave_scale))


# ---------------------------------------------------------------- decision
@dataclass
class AnalysisDecision:
    """One reconcile's analysis verdict — what the scheduler consults."""

    #: A sustained abortOn condition latched; fresh admissions defer
    #: with reason ``gate:slo`` until the target moves off the aborted
    #: revision.
    aborted: bool = False
    abort_reason: str = ""
    #: Remaining fresh-unit admissions under the active step's exposure
    #: cap; None = uncapped (no active cap, or analysis suspended).
    exposure_remaining: Optional[int] = None
    #: AIMD wave-scale multiplier in (0, 1].
    wave_scale: float = 1.0
    active_step: Optional[str] = None
    #: Every declared step advanced (exposure uncapped; the last step's
    #: abortOn stays armed).
    passed: bool = False
    #: Analysis suspended while remediation pauses/rolls back the fleet.
    suspended: bool = False
    report: dict = field(default_factory=dict)


# ------------------------------------------------------------------ engine
class AnalysisEngine:
    """Per-manager analysis evaluator: owns the step cursor, the abort
    latch, the pacing controller, and the latest report (the
    ``/debug/analysis`` payload)."""

    def __init__(
        self, history: Optional[history_mod.MetricsHistory] = None
    ) -> None:
        #: Sustained-condition oracle — normally the SLO engine's ring,
        #: so both planes see the same samples.
        self._history = history if history is not None else (
            history_mod.MetricsHistory()
        )
        self._pacing = PacingController()
        self._lock = threading.Lock()
        self._step = 0
        self._aborted = False
        self._abort_target = ""
        self._abort_reason = ""
        #: The SLO engine's rollout-start stamp as of the last evaluate:
        #: a CHANGED stamp means a new rollout began on the healthy path
        #: (the previous one completed), and the analysis must restart
        #: from its first step — a passed analysis is passed for ONE
        #: revision, not for the manager's lifetime.
        self._rollout_stamp: Optional[float] = None
        #: Last observed target revision hash — a change restarts the
        #: analysis (new revisions published MID-rollout included, which
        #: the rollout-start stamp can't see).
        self._last_target = ""
        self._last_report: Optional[dict] = None
        self._published = False

    @property
    def pacing(self) -> PacingController:
        return self._pacing

    def set_history(self, history: history_mod.MetricsHistory) -> None:
        self._history = history

    # ------------------------------------------------------------- status
    def last_report(self) -> Optional[dict]:
        with self._lock:
            return self._last_report

    def disable(self) -> None:
        """The policy lost its ``analysis`` block (or the CR went away):
        retire the gauges, drop the latched state, and restore the wave
        scale to 1.0 so a removed block never keeps throttling (the
        SLO/remediation retirement contract).  Idempotent and cheap
        when already disabled."""
        with self._lock:
            had = self._last_report is not None
            self._last_report = None
            self._step = 0
            self._aborted = False
            self._abort_target = ""
            self._abort_reason = ""
            self._rollout_stamp = None
            self._last_target = ""
        self._pacing.reset()
        if had or self._published:
            self._published = False
            metrics.retire_analysis_gauges()

    # ----------------------------------------------------------- evaluate
    def _holds(self, cond: AnalysisCondition, now: float) -> bool:
        return self._history.holds(
            history_key(cond.metric),
            cond.op,
            cond.value,
            cond.for_seconds,
            now=now,
        )

    def _condition_views(
        self,
        conditions,
        slo_report: Optional[dict],
        queue_depth: float,
        now: float,
    ) -> List[dict]:
        views = []
        for cond in conditions:
            held = self._history.held_seconds(
                history_key(cond.metric), cond.op, cond.value, now=now
            )
            views.append(
                {
                    **cond.to_dict(),
                    "value": resolve_metric(
                        cond.metric, slo_report, queue_depth
                    ),
                    "heldSeconds": (
                        round(held, 3) if held is not None else None
                    ),
                    # derived from the ONE streak walk above (identical
                    # to holds(): same staleness + newest-sample rules)
                    "satisfied": (
                        held is not None and held >= cond.for_seconds
                    ),
                }
            )
        return views

    def evaluate(
        self,
        state,
        policy,
        slo_report: Optional[dict],
        common=None,
        remediation=None,
        now: Optional[float] = None,
    ) -> AnalysisDecision:
        """One reconcile's evaluation.  *slo_report* is the SLO engine's
        fresh report; *remediation* the remediation decision when that
        engine ran this pass (suspension signal); *common* resolves the
        current target revision — the restart detector (a new revision,
        mid-rollout included, re-enters step one) and the abort latch's
        release oracle."""
        spec: AnalysisSpec = policy.analysis
        now = time.time() if now is None else now
        queue_depth = metrics.write_queue_depth_gauge().value()

        # ---- pacing tick (signals are step-independent)
        scale = 1.0
        congested: List[str] = []
        if spec.pacing is not None:
            scale, congested = self._pacing.update(
                spec.pacing,
                worst_burn_rate(slo_report),
                len((slo_report or {}).get("stragglers") or []),
                queue_depth,
                now=now,
            )
        else:
            # The pacing sub-block was removed while the steps stay:
            # the controller's state must not survive into a later
            # re-declared block (a healthy fleet resuming at a stale
            # throttled scale).
            self._pacing.reset()
        # queue/scale samples ride the shared ring (conditions on
        # ``queue`` need history; the scale series is /debug context)
        self._history.record(
            {"write_queue_depth": queue_depth, "pacing_wave_scale": scale},
            now=now,
        )

        # ---- restart / abort-latch bookkeeping.  The target revision
        # hash is THE change detector: a new revision published — idle
        # fleet OR mid-rollout — restarts the analysis from its first
        # step and restarts the observation windows (each revision must
        # earn its own soak; the previous one's samples/passed steps
        # must not wave it through or insta-abort it).  The SLO
        # engine's rollout-start stamp covers the target-less case (a
        # repair wave at the same revision on a fresh manager).
        target = (
            current_target_hash(state, common) if common is not None else ""
        )
        stamp = (slo_report or {}).get("rolloutStartedAt")
        clear_history = False
        with self._lock:
            if not self._aborted:
                if (
                    stamp is not None
                    and self._rollout_stamp is not None
                    and stamp != self._rollout_stamp
                    and self._step
                ):
                    # A NEW rollout began on the healthy path (the SLO
                    # engine re-stamped after completion).
                    logger.info(
                        "analysis restarted for a new rollout "
                        "(start stamp %s -> %s)",
                        self._rollout_stamp,
                        stamp,
                    )
                    self._step = 0
                if (
                    target
                    and self._last_target
                    and target != self._last_target
                ):
                    # The target revision changed — including a new
                    # revision published MID-rollout, which never
                    # re-stamps the rollout start.
                    logger.info(
                        "analysis restarted: target revision moved "
                        "%s -> %s",
                        self._last_target,
                        target,
                    )
                    self._step = 0
                    clear_history = True
            if stamp is not None:
                self._rollout_stamp = stamp
            if target:
                self._last_target = target
            if self._aborted:
                if (
                    target
                    and self._abort_target
                    and target != self._abort_target
                ):
                    logger.info(
                        "analysis abort released: target moved %s -> %s; "
                        "restarting analysis from the first step",
                        self._abort_target,
                        target,
                    )
                    self._aborted = False
                    self._abort_target = ""
                    self._abort_reason = ""
                    self._step = 0
                    clear_history = True
            step_idx = self._step
            aborted = self._aborted
            abort_reason = self._abort_reason
        if clear_history:
            # The windows restart with the revision: conditions resume
            # holding once the NEW era's samples sustain them.
            self._history.clear()

        suspended = remediation is not None and (
            getattr(remediation, "paused", False)
            or getattr(remediation, "rollback_active", False)
        )
        if suspended:
            # The recovery wave must not be throttled by the analysis
            # that triggered it: while remediation pauses/rolls back,
            # the EFFECTIVE scale is 1.0 (the exposure cap is exempted
            # below for the same reason).  The controller keeps its
            # internal state; once the recovery completes and signals
            # clear, it resumes from wherever the pressure left it.
            scale = 1.0
            congested = []
        steps = spec.steps

        if not suspended and steps:
            # ---- abort: the active step's abortOn (the LAST step's
            # stays armed after it advances — a whole-rollout burn
            # abort must work mid-fleet)
            armed = steps[min(step_idx, len(steps) - 1)]
            if aborted and not self._abort_target:
                # The aborted revision could not be pinned at trip time
                # (revision oracle unavailable): the target-change
                # release can never fire, so degrade to condition-
                # follow — release once no armed abort condition still
                # holds, instead of latching forever.
                if not any(
                    self._holds(c, now) for c in armed.parsed_abort()
                ):
                    with self._lock:
                        self._aborted = False
                        self._abort_reason = ""
                        self._step = 0
                    aborted = False
                    abort_reason = ""
                    step_idx = 0
                    armed = steps[0]
                    logger.info(
                        "analysis abort released: no pinned target and "
                        "every abort condition cleared; restarting from "
                        "the first step"
                    )
            if not aborted:
                for cond in armed.parsed_abort():
                    if self._holds(cond, now):
                        aborted = True
                        abort_reason = (
                            f"analysis step {armed.name!r}: "
                            f"{cond.raw} held"
                            + (
                                f" for {cond.for_seconds:g}s"
                                if cond.for_seconds
                                else ""
                            )
                        )
                        with self._lock:
                            self._aborted = True
                            self._abort_target = target
                            self._abort_reason = abort_reason
                        events_mod.emit(
                            events_mod.EVENT_ANALYSIS_ABORTED,
                            events_mod.REASON_SLO_GATE,
                            events_mod.FLEET_TARGET,
                            abort_reason,
                        )
                        logger.warning("analysis ABORT: %s", abort_reason)
                        break
            # ---- advance: cascade while every condition holds (a
            # healthy fleet must not pay one reconcile per step)
            if not aborted:
                while step_idx < len(steps):
                    step = steps[step_idx]
                    conditions = step.parsed_advance()
                    if not conditions or not all(
                        self._holds(c, now) for c in conditions
                    ):
                        break
                    step_idx += 1
                    events_mod.emit(
                        events_mod.EVENT_ANALYSIS_STEP_ADVANCED,
                        events_mod.REASON_SLO_GATE,
                        events_mod.FLEET_TARGET,
                        f"step {step.name!r} advanced "
                        f"({step_idx}/{len(steps)}): every advanceOn "
                        "condition held",
                    )
                    logger.info(
                        "analysis step %r advanced (%d/%d)",
                        step.name,
                        step_idx,
                        len(steps),
                    )
                with self._lock:
                    self._step = step_idx

        decision = AnalysisDecision(
            aborted=aborted,
            abort_reason=abort_reason,
            wave_scale=scale,
            suspended=suspended,
            # a step-less (pacing-only) block is never "passed" — the
            # offline report agrees, and the gate renders "pacing only"
            passed=bool(steps) and step_idx >= len(steps) and not aborted,
        )

        # ---- exposure cap of the active step (never while suspended —
        # the rollback wave must not be gated by the analysis that
        # triggered it)
        exposure: Optional[dict] = None
        if (
            steps
            and not suspended
            and not aborted
            and step_idx < len(steps)
        ):
            step = steps[step_idx]
            decision.active_step = step.name
            if step.max_exposure is not None:
                total_units, exposed = exposure_census(state, policy)
                cap = step.max_exposure.scaled_value(
                    total_units, round_up=True
                )
                decision.exposure_remaining = max(0, cap - exposed)
                exposure = {
                    "cap": cap,
                    "exposed": exposed,
                    "totalUnits": total_units,
                    "remaining": decision.exposure_remaining,
                }

        # ---- gauges: per-step gate state + the pacing scale
        step_states: Dict[str, float] = {}
        for i, step in enumerate(steps):
            if aborted and i == min(step_idx, len(steps) - 1):
                value = metrics.ANALYSIS_STEP_ABORTED
            elif i < step_idx:
                value = metrics.ANALYSIS_STEP_PASSED
            elif i == step_idx and not decision.passed:
                value = metrics.ANALYSIS_STEP_ACTIVE
            else:
                value = metrics.ANALYSIS_STEP_PENDING
            step_states[step.name] = value
        metrics.publish_analysis_gauges(step_states, scale)
        self._published = True

        # ---- report (the /debug/analysis payload + rollout_status)
        step_views = []
        for i, step in enumerate(steps):
            word = {
                metrics.ANALYSIS_STEP_PENDING: "pending",
                metrics.ANALYSIS_STEP_ACTIVE: "active",
                metrics.ANALYSIS_STEP_PASSED: "passed",
                metrics.ANALYSIS_STEP_ABORTED: "aborted",
            }[step_states[step.name]]
            view = {
                "name": step.name,
                "state": word,
                "advance": self._condition_views(
                    step.parsed_advance(), slo_report, queue_depth, now
                ),
                "abort": self._condition_views(
                    step.parsed_abort(), slo_report, queue_depth, now
                ),
            }
            if step.max_exposure is not None:
                view["maxExposure"] = step.max_exposure.to_raw()
            step_views.append(view)
        report = {
            "generatedAt": now,
            "offline": False,
            "steps": step_views,
            "activeStep": decision.active_step,
            "stepIndex": step_idx,
            "passed": decision.passed,
            "aborted": aborted,
            "abortReason": abort_reason,
            "suspended": suspended,
            "exposure": exposure,
            "pacing": (
                {
                    "scale": round(scale, 4),
                    "congested": congested,
                    "queueDepth": queue_depth,
                }
                if spec.pacing is not None
                else None
            ),
        }
        decision.report = report
        with self._lock:
            self._last_report = report
        return decision


# --------------------------------------------------------- offline report
def analysis_report(
    state, policy, slo_report: Optional[dict], now: Optional[float] = None
) -> Optional[dict]:
    """Pure, history-free approximation of the analysis report for
    offline dumps (the ``pacing`` CLI and ``status``'s analysis gate):
    conditions evaluate instantaneously against the reconstructed SLO
    report, and the step cursor is approximated as the first step whose
    ``advanceOn`` conditions do not all hold right now.  Sustain
    windows and the abort latch are live-engine state, so the offline
    verdict marks aborts as ``abortPending`` (condition holding NOW)
    rather than claiming the latch.  None when the policy declares no
    analysis block."""
    spec = getattr(policy, "analysis", None) if policy is not None else None
    if spec is None:
        return None
    now = time.time() if now is None else now

    def satisfied(cond: AnalysisCondition) -> bool:
        value = resolve_metric(cond.metric, slo_report)
        if value is None:
            return False
        return history_mod.OPS[cond.op](value, cond.value)

    steps = spec.steps
    step_idx = 0
    while step_idx < len(steps):
        conditions = steps[step_idx].parsed_advance()
        if not conditions or not all(satisfied(c) for c in conditions):
            break
        step_idx += 1
    passed = bool(steps) and step_idx >= len(steps)
    armed = steps[min(step_idx, len(steps) - 1)] if steps else None
    abort_pending = [
        c.raw for c in (armed.parsed_abort() if armed is not None else ())
        if satisfied(c)
    ]
    exposure = None
    active = None
    if steps and not passed:
        step = steps[step_idx]
        active = step.name
        if step.max_exposure is not None:
            total_units, exposed = exposure_census(state, policy)
            cap = step.max_exposure.scaled_value(total_units, round_up=True)
            exposure = {
                "cap": cap,
                "exposed": exposed,
                "totalUnits": total_units,
                "remaining": max(0, cap - exposed),
            }

    def views(conditions) -> List[dict]:
        return [
            {
                **c.to_dict(),
                "value": resolve_metric(c.metric, slo_report),
                "heldSeconds": None,
                "satisfied": satisfied(c),
            }
            for c in conditions
        ]

    step_views = []
    for i, step in enumerate(steps):
        view = {
            "name": step.name,
            "state": (
                "passed"
                if i < step_idx
                else ("active" if i == step_idx and not passed else "pending")
            ),
            "advance": views(step.parsed_advance()),
            "abort": views(step.parsed_abort()),
        }
        if step.max_exposure is not None:
            view["maxExposure"] = step.max_exposure.to_raw()
        step_views.append(view)
    return {
        "generatedAt": now,
        "offline": True,
        "steps": step_views,
        "activeStep": active,
        "stepIndex": step_idx,
        "passed": passed,
        "aborted": False,
        "abortReason": "",
        "abortPending": abort_pending,
        "suspended": False,
        "exposure": exposure,
        "pacing": (
            {"scale": None, "congested": [], "queueDepth": None}
            if spec.pacing is not None
            else None
        ),
    }


def gate_from_report(report: Optional[dict], pending: int) -> Optional[dict]:
    """Reduce an analysis report to the rollout-status gate verdict:
    ``{"blocking": bool, "reason": str, "detail": {...}}`` (None when
    no report).  Blocking when aborted, or when the active step's
    exposure cap is exhausted while work is pending."""
    if report is None:
        return None
    detail: Dict[str, object] = {
        "activeStep": report.get("activeStep"),
        "stepIndex": report.get("stepIndex"),
        "steps": [
            {"name": s.get("name"), "state": s.get("state")}
            for s in report.get("steps") or []
        ],
    }
    pacing = report.get("pacing") or {}
    if pacing.get("scale") is not None:
        detail["waveScale"] = pacing["scale"]
    exposure = report.get("exposure")
    if exposure:
        detail["exposure"] = dict(exposure)
    if report.get("aborted"):
        return {
            "blocking": True,
            "reason": (
                "analysis ABORTED: "
                + (report.get("abortReason") or "sustained SLO breach")
                + "; fresh admissions defer [gate:slo] until the target "
                "moves off the aborted revision"
            ),
            "detail": detail,
        }
    if report.get("suspended"):
        return {
            "blocking": False,
            "reason": (
                "analysis suspended while remediation recovers the fleet"
            ),
            "detail": detail,
        }
    if (
        exposure is not None
        and exposure.get("remaining", 1) <= 0
        and pending > 0
    ):
        waiting = [
            c.get("raw")
            for s in report.get("steps") or []
            if s.get("state") == "active"
            for c in s.get("advance") or []
            if not c.get("satisfied")
        ]
        return {
            "blocking": True,
            "reason": (
                f"analysis step {report.get('activeStep')!r} holding: "
                f"exposure cap {exposure.get('cap')} reached"
                + (
                    "; advances when " + " AND ".join(waiting)
                    if waiting
                    else ""
                )
            ),
            "detail": detail,
        }
    if report.get("passed"):
        reason = "analysis passed: every step advanced"
    elif report.get("activeStep") is not None:
        reason = (
            f"analysis step {report.get('activeStep')!r} active "
            f"({int(report.get('stepIndex') or 0) + 1}/"
            f"{len(report.get('steps') or [])})"
        )
    else:
        reason = "analysis: pacing only (no steps declared)"
    if pacing.get("scale") is not None and pacing["scale"] < 1.0:
        reason += f"; pacing throttled to {pacing['scale']:.2f}x"
    return {"blocking": False, "reason": reason, "detail": detail}


# ---------------------------------------------------------------- render
def render_report(report: dict) -> str:
    """Human rendering of an analysis report (the ``pacing`` CLI)."""
    lines: List[str] = []
    if report.get("aborted"):
        lines.append(
            "analysis: ABORTED — " + (report.get("abortReason") or "")
        )
    elif report.get("suspended"):
        lines.append("analysis: suspended (remediation recovering)")
    elif report.get("passed"):
        lines.append("analysis: passed (every step advanced)")
    elif report.get("activeStep"):
        lines.append(
            f"analysis: step {report['activeStep']!r} active "
            f"({int(report.get('stepIndex') or 0) + 1}/"
            f"{len(report.get('steps') or [])})"
        )
    else:
        lines.append("analysis: pacing only (no steps declared)")
    exposure = report.get("exposure")
    if exposure:
        lines.append(
            f"  exposure: {exposure.get('exposed')}/{exposure.get('cap')} "
            f"units (of {exposure.get('totalUnits')}; "
            f"{exposure.get('remaining')} admission(s) left this step)"
        )
    pacing = report.get("pacing")
    if pacing is not None:
        scale = pacing.get("scale")
        lines.append(
            "  pacing: "
            + (
                f"wave scale {scale:g}x"
                if scale is not None
                else "declared (live scale unknown offline)"
            )
            + (
                f" — congested: {'; '.join(pacing['congested'])}"
                if pacing.get("congested")
                else ""
            )
        )
    for step in report.get("steps") or []:
        lines.append(f"  step {step['name']!r}: {step['state']}")
        for kind in ("advance", "abort"):
            for cond in step.get(kind) or []:
                value = cond.get("value")
                held = cond.get("heldSeconds")
                bits = [
                    f"    {kind}On: {cond['raw']}",
                    f"now {value:g}" if value is not None else "unobserved",
                ]
                if held is not None:
                    bits.append(f"held {held:g}s")
                if cond.get("satisfied"):
                    bits.append("SATISFIED")
                lines.append("  ".join(bits))
    pending = report.get("abortPending") or []
    if pending:
        lines.append(
            "  abort conditions holding NOW (live latch unknown offline): "
            + "; ".join(pending)
        )
    return "\n".join(lines)


# ------------------------------------------------------------------ selftest
def selftest() -> str:  # noqa: C901 — one linear end-to-end story
    """The closed-loop smoke (the ``make verify-pacing`` gate): a fully
    gated fleet auto-advances a canary soak on healthy SLOs, throttles
    under injected burn-rate pressure (wave scale visibly reduced, with
    ``pacing:adapt`` events), aborts to the last-known-good revision on
    a sustained breach — and every transition is explained by reason
    code through the live manager, a real ``/debug/explain`` GET, and
    the offline path from persisted decision Events.  Raises
    AssertionError on any violated expectation."""
    import json as json_mod
    import urllib.request

    from ..api.upgrade_spec import (
        AdaptivePacingSpec,
        AnalysisSpec,
        AnalysisStepSpec,
        DrainSpec,
        IntOrString,
        RemediationSpec,
        SloSpec,
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
    from ..obs.events import (
        EVENT_ANALYSIS_ABORTED,
        EVENT_ANALYSIS_STEP_ADVANCED,
        EVENT_BREAKER_TRIPPED,
        EVENT_NODE_DEFERRED,
        EVENT_PACING_ADAPTED,
        EVENT_ROLLBACK_STARTED,
        REASON_SLO_GATE,
        ClusterDecisionEventSink,
        DecisionEventLog,
        decisions_from_cluster,
        explain_node,
        set_default_log,
    )
    from ..upgrade import consts, timeline as timeline_mod, util
    from ..upgrade.upgrade_state import ClusterUpgradeStateManager

    namespace, labels = "pacing-selftest", {"app": "selftest-runtime"}
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
        nodes = [f"node-{i}" for i in range(8)]
        seq = iter(range(10_000))

        def spawn_pod(node: str, revision: str) -> None:
            cluster.create(
                make_pod(
                    f"selftest-runtime-{next(seq)}",
                    namespace,
                    node,
                    labels=dict(labels),
                    owner=ds,
                    revision_hash=revision,
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
            return newest["metadata"]["labels"][
                CONTROLLER_REVISION_HASH_LABEL
            ]

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
            max_parallel_upgrades=0,  # unlimited: only the analysis gates
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=5),
            slos=SloSpec(fleet_completion_deadline_seconds=86400.0),
            remediation=RemediationSpec(
                failure_threshold=1.0,
                min_attempted=999,  # the failure budget must never trip
                auto_rollback=True,
                backoff_seconds=0.0,
            ),
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="canary-soak",
                        max_exposure=IntOrString(2),
                        advance_on=("breaches == 0 for 0.6s",),
                    ),
                    AnalysisStepSpec(
                        name="fleet",
                        abort_on=(
                            "burn:fleetCompletionDeadlineSeconds >= 5 "
                            "for 0.3s",
                        ),
                    ),
                ),
                pacing=AdaptivePacingSpec(
                    adjust_interval_seconds=0.0, min_scale=0.25
                ),
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

        def log_types() -> set:
            from ..obs import events as ev

            return {e["type"] for e in ev.default_log().events()}

        # ---- healthy era: the LKG tracker must record "good" as the
        # standing target before the new revision lands.
        for _ in range(2):
            reconcile()

        # ---- phase 1: gated exposure.  Publish a healthy rev2; the
        # canary-soak step caps exposure at 2 units, so the rest of the
        # fleet defers with reason gate:slo.
        cluster.create(make_controller_revision(ds, 2, "next"))
        reconcile()
        reconcile()  # explain answers from the LAST processed snapshot
        gated = None
        for node in nodes:
            answer = manager.explain_node(node) or {}
            if answer.get("reasonCode") == REASON_SLO_GATE:
                gated = (node, answer)
                break
        assert gated is not None, (
            "no node explained as gate:slo: "
            + str({n: (manager.explain_node(n) or {}).get("reasonCode")
                   for n in nodes})
        )
        assert EVENT_NODE_DEFERRED in log_types()
        reconcile()  # the engine's report reflects the PRE-admission
        # census of each pass; one more pass shows the cap fully spent
        report = manager.analysis_status() or {}
        assert report.get("activeStep") == "canary-soak", report
        assert (report.get("exposure") or {}).get("remaining") == 0, report

        # plane 2: a real OpsServer GET — /debug/explain answers
        # gate:slo and /debug/analysis serves the step report.
        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            events_source=manager.events_status,
            explain_source=manager.explain_node,
            analysis_source=manager.analysis_status,
            slo_source=manager.slo_status,
            slo_history_source=manager.slo_history,
        ).start()
        with urllib.request.urlopen(
            ops.url + f"/debug/explain?node={gated[0]}", timeout=5
        ) as rsp:
            served = json_mod.loads(rsp.read())
        assert served["reasonCode"] == REASON_SLO_GATE, served
        with urllib.request.urlopen(
            ops.url + "/debug/analysis", timeout=5
        ) as rsp:
            served_analysis = json_mod.loads(rsp.read())
        assert (
            (served_analysis.get("report") or {}).get("activeStep")
            == "canary-soak"
        ), served_analysis
        with urllib.request.urlopen(
            ops.url + "/debug/slo?history=1", timeout=5
        ) as rsp:
            served_slo = json_mod.loads(rsp.read())
        assert "slo_breaches" in (
            (served_slo.get("history") or {}).get("series") or {}
        ), served_slo

        # plane 3: offline — the persisted decision Events reconstruct
        # the same gate:slo verdict for the deferred node.
        offline = InMemoryCluster.from_dict(cluster.to_dict())
        recorder = timeline_mod.FlightRecorder()
        offline_mgr = ClusterUpgradeStateManager(
            offline, flight_recorder=recorder
        )
        try:
            offline_state = offline_mgr.build_state(namespace, labels)
        finally:
            offline_mgr.shutdown()
        offline_decisions = decisions_from_cluster(offline)
        assert any(
            d["type"] == EVENT_NODE_DEFERRED
            and d["reason"] == REASON_SLO_GATE
            for d in offline_decisions
        ), offline_decisions
        answer = explain_node(
            gated[0],
            offline_state,
            policy=policy,
            recorder=recorder,
            decisions=offline_decisions,
        )
        assert answer is not None and answer["reasonCode"] == REASON_SLO_GATE, (
            answer
        )

        # ---- phase 2: the healthy soak auto-advances (breaches == 0
        # sustained), opening the fleet.
        deadline = time.time() + 30.0
        while EVENT_ANALYSIS_STEP_ADVANCED not in log_types():
            assert time.time() < deadline, "canary-soak step never advanced"
            time.sleep(0.15)
            reconcile()
        reconcile()

        # ---- phase 3: injected burn-rate pressure.  A microscopic
        # fleet deadline makes the burn rate explode mid-rollout: the
        # AIMD controller throttles the wave (pacing:adapt), and the
        # sustained abort condition then trips the breaker and rolls
        # the fleet back to the LKG.
        state_key = util.get_upgrade_state_label_key()

        def all_done_at(revision: str) -> bool:
            if any(
                (n["metadata"].get("labels") or {}).get(state_key)
                != consts.UPGRADE_STATE_DONE
                for n in cluster.list("Node")
            ):
                return False
            return all(
                p["metadata"]["labels"][CONTROLLER_REVISION_HASH_LABEL]
                == revision
                for p in cluster.list("Pod", namespace=namespace)
            )

        assert not all_done_at("next"), (
            "fleet finished before pressure could be injected — "
            "the soak step advanced too late"
        )
        policy.slos.fleet_completion_deadline_seconds = 1e-6
        saw_throttle = False
        deadline = time.time() + 30.0
        while EVENT_ANALYSIS_ABORTED not in log_types():
            assert time.time() < deadline, "analysis never aborted"
            reconcile()
            scale = metrics.default_registry().gauge(
                "pacing_wave_scale",
                "Adaptive (AIMD) wave-scale multiplier applied to the "
                "scheduler's slot budget and the write dispatcher's "
                "concurrency (1.0 = unthrottled).",
            ).value()
            saw_throttle = saw_throttle or scale < 1.0
            time.sleep(0.1)
        assert saw_throttle, "wave scale never dropped under pressure"
        types = log_types()
        assert EVENT_PACING_ADAPTED in types, types
        assert EVENT_BREAKER_TRIPPED in types, types
        status = manager.remediation_status() or {}
        assert (status.get("breaker") or {}).get("reason", "").startswith(
            "analysis step"
        ), status

        # ---- phase 4: the SLO is fixed; the rollback wave converges
        # the fleet on the last-known-good revision.
        policy.slos.fleet_completion_deadline_seconds = 86400.0
        deadline = time.time() + 60.0
        while not all_done_at("good"):
            assert time.time() < deadline, (
                "fleet did not converge back on the LKG: "
                + str(
                    {
                        n["metadata"]["name"]: (
                            n["metadata"].get("labels") or {}
                        ).get(state_key)
                        for n in cluster.list("Node")
                    }
                )
            )
            time.sleep(0.05)
            reconcile()
        assert EVENT_ROLLBACK_STARTED in log_types()
        assert newest_hash() == "good", "DS not reverted to the LKG revision"

        # the AIMD scale recovers once the pressure clears
        deadline = time.time() + 10.0
        while manager.analysis_status() is None or (
            (manager.analysis_status().get("pacing") or {}).get("scale")
            or 0
        ) < 1.0:
            assert time.time() < deadline, "wave scale never recovered"
            time.sleep(0.05)
            reconcile()

        # the metrics plane carries the new reason codes + gauges
        exposition = metrics.default_registry().render()
        assert 'reason="gate:slo"' in exposition, "gate:slo not counted"
        assert 'reason="pacing:adapt"' in exposition, (
            "pacing:adapt not counted"
        )
        assert "analysis_gate_state" in exposition
        assert "pacing_adjustments_total" in exposition
        return (
            "pacing selftest OK: canary-soak auto-advanced on healthy "
            "SLOs, wave throttled under injected burn "
            "(pacing:adapt), sustained breach aborted to the LKG "
            f"({newest_hash()}), and gate:slo explained via the live "
            "manager, /debug/explain over HTTP, and the offline "
            f"persisted-Event path ({len(offline_decisions)} decisions)"
        )
    finally:
        if ops is not None:
            ops.stop()
        if manager is not None:
            manager.shutdown()
        metrics.set_default_registry(prev_registry)
        set_default_log(prev_log)
        timeline_mod.set_default_recorder(prev_recorder)
