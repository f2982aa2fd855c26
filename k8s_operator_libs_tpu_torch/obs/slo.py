"""Rollout analytics + SLO engine over the flight recorder's timelines.

:mod:`..upgrade.timeline` answers "what happened to this node, when";
this module turns the whole fleet's timelines into the numbers an
on-call operator actually asks for mid-rollout, and evaluates them
against **policy-declared SLOs**:

* **fleet analytics** — throughput (nodes/hour), completion **ETA with
  a confidence band** (point estimate from the observed completion
  rate; band from the p50/p95 of completion inter-arrival times),
  per-phase latency quantiles (p50/p95/p99), and **straggler
  detection** (nodes sitting in a phase longer than *k*× that phase's
  p95);
* **SLO evaluation** — an optional ``slos`` block on
  :class:`~..api.upgrade_spec.UpgradePolicySpec` declares targets
  (``maxNodePhaseSeconds``, ``drainP99Seconds``,
  ``fleetCompletionDeadlineSeconds``); each reconcile evaluates them
  into breach + **burn-rate** gauges.  Report-only by design: a
  breached SLO alerts and annotates ``rollout_status`` — it never
  gates admissions (the canary/window/pacing/remediation gates own
  enforcement).

Burn-rate semantics (docs/observability.md shows the math):

* per-phase / per-node targets burn at ``observed / target`` — 1.0 is
  exactly on budget;
* the fleet deadline burns at
  ``(elapsed / deadline) / max(progress, 1%)`` — the classic error-
  budget burn rate: > 1 means wall clock is being spent faster than
  progress is being made, and the deadline will be missed at the
  current pace.

Everything here is a pure function of (timelines, snapshot counts,
now) except :class:`SloEngine`, which owns the two pieces of state the
metrics contract needs: the rollout-start stamp (for the deadline
clock) and the breached-set edge detector (``slo_breaches_total`` must
count breach EVENTS, not reconciles spent in breach).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import metrics
from . import history as history_mod

#: Default straggler multiplier: a node in a phase > k× that phase's p95.
DEFAULT_STRAGGLER_FACTOR = 3.0
#: Minimum completed samples of a phase before straggler/percentile
#: verdicts are meaningful for it.
MIN_PHASE_SAMPLES = 4

_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def quantile(samples: List[float], q: float) -> float:
    """Nearest-rank quantile over a non-empty sample list (rank
    ``ceil(q*n)`` — a round() substitute banker's-rounds q*n at odd
    integers and picks one rank too high)."""
    ordered = sorted(samples)
    if not ordered:
        raise ValueError("quantile of empty sample set")
    idx = max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))
    return ordered[idx]


def _work_phases() -> frozenset:
    from ..upgrade import timeline as timeline_mod

    return timeline_mod.WORK_PHASES


def _terminal_phases() -> set:
    from ..upgrade import consts, timeline as timeline_mod

    return {
        consts.UPGRADE_STATE_DONE,
        timeline_mod.phase_name(consts.UPGRADE_STATE_UNKNOWN),
    }


def _queue_phases() -> set:
    """Phases that measure ADMISSION QUEUE WAIT, not node latency: a
    paced 1000-node rollout legitimately leaves late nodes sitting in
    upgrade-required for hours, so the per-node phase ceiling and the
    straggler rule must not judge them (the wall-clock and throughput
    analytics still count the wait — that is the fleet's real end-to-end
    time)."""
    from ..upgrade import consts

    return {consts.UPGRADE_STATE_UPGRADE_REQUIRED}


def phase_stats(timelines: List[dict]) -> Dict[str, dict]:
    """Per-phase duration quantiles over every CLOSED interval —
    ``{phase: {count, p50, p95, p99}}``.  Terminal phases (done /
    unknown) are excluded: time spent done is not a latency."""
    terminal = _terminal_phases()
    samples: Dict[str, List[float]] = {}
    for tl in timelines:
        for phase, start, end in tl.get("intervals") or []:
            if phase in terminal:
                continue
            samples.setdefault(phase, []).append(max(0.0, end - start))
    out: Dict[str, dict] = {}
    for phase, values in samples.items():
        out[phase] = {
            "count": len(values),
            **{
                name: round(quantile(values, q), 3)
                for name, q in _QUANTILES
            },
        }
    return out


def find_stragglers(
    timelines: List[dict],
    stats: Dict[str, dict],
    now: float,
    factor: float = DEFAULT_STRAGGLER_FACTOR,
    min_samples: int = MIN_PHASE_SAMPLES,
) -> List[dict]:
    """Nodes currently sitting in a phase longer than *factor*× that
    phase's p95 (phases with fewer than *min_samples* completed samples
    are skipped — no baseline, no verdict; queue phases are never
    judged — waiting for an admission slot is pacing, not dragging).
    Sorted worst-first."""
    skip = _terminal_phases() | _queue_phases()
    out: List[dict] = []
    for tl in timelines:
        phase = tl.get("current")
        if not phase or phase in skip:
            continue
        stat = stats.get(phase)
        if stat is None or stat["count"] < min_samples:
            continue
        elapsed = now - float(tl.get("currentSince") or now)
        threshold = factor * stat["p95"]
        if elapsed > threshold > 0:
            out.append(
                {
                    "node": tl.get("node"),
                    "phase": phase,
                    "elapsedSeconds": round(elapsed, 3),
                    "phaseP95Seconds": stat["p95"],
                    "thresholdSeconds": round(threshold, 3),
                }
            )
    out.sort(key=lambda s: -s["elapsedSeconds"])
    return out


def _done_entry_times(
    timelines: List[dict], since: Optional[float] = None
) -> List[float]:
    """When each node ENTERED its (current or historical) done phase.
    *since* scopes to the current rollout — a previous wave's
    completions (retained in the recorder and the checkpoints) would
    otherwise stretch the observed span and wreck the ETA."""
    from ..upgrade import consts

    floor = float("-inf") if since is None else since
    times: List[float] = []
    for tl in timelines:
        for phase, start, _end in tl.get("intervals") or []:
            if phase == consts.UPGRADE_STATE_DONE and start >= floor:
                times.append(start)
        if tl.get("current") == consts.UPGRADE_STATE_DONE:
            entered = float(tl.get("currentSince") or 0.0)
            if entered >= floor:
                times.append(entered)
    times.sort()
    return times


def rollout_started_estimate(timelines: List[dict]) -> Optional[float]:
    """Earliest start of the trailing work run across the fleet — the
    offline approximation of "when did this rollout start" (the live
    engine stamps it exactly; checkpoints bound history, so old
    rollouts age out of this estimate)."""
    work = _work_phases()
    starts: List[float] = []
    for tl in timelines:
        run_start: Optional[float] = None
        for phase, start, _end in tl.get("intervals") or []:
            if phase in work:
                if run_start is None:
                    run_start = start
            else:
                run_start = None
        if tl.get("current") in work:
            if run_start is None:
                run_start = float(tl.get("currentSince") or 0.0)
        else:
            # the trailing closed run ended (node is done/terminal):
            # that was a PREVIOUS wave, not in-flight work
            run_start = None
        if run_start is not None:
            starts.append(run_start)
    return min(starts) if starts else None


def analyze(
    timelines: List[dict],
    counts: Dict[str, int],
    now: Optional[float] = None,
    straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
    since: Optional[float] = None,
) -> dict:
    """Fleet analytics from timelines + snapshot counts: throughput,
    ETA with confidence band, per-phase quantiles, per-node wall-clock
    quantiles, stragglers.  *since* (the rollout-start stamp) scopes
    throughput/ETA to the current wave; phase/wall quantiles keep all
    retained history on purpose — more baseline for the straggler
    rule."""
    from ..upgrade import timeline as timeline_mod

    now = time.time() if now is None else now
    stats = phase_stats(timelines)
    walls = timeline_mod.wall_clock_samples(timelines)
    remaining = int(counts.get("pending", 0)) + int(
        counts.get("inProgress", 0)
    )
    done_times = _done_entry_times(timelines, since)

    throughput = None
    eta: Optional[dict] = None
    if len(done_times) >= 2:
        span = max(now - done_times[0], 1e-9)
        throughput = len(done_times) / (span / 3600.0)
        gaps = [b - a for a, b in zip(done_times, done_times[1:])]
        if remaining > 0:
            point = remaining / (len(done_times) / span)
            eta = {
                "seconds": round(point, 3),
                # confidence band: completions arriving at the observed
                # p50 vs p95 inter-arrival pace
                "p50Seconds": round(remaining * quantile(gaps, 0.50), 3),
                "p95Seconds": round(remaining * quantile(gaps, 0.95), 3),
                "basis": f"{len(done_times)} completions over {span:.1f}s",
            }
    if remaining == 0:
        eta = {"seconds": 0.0, "p50Seconds": 0.0, "p95Seconds": 0.0,
               "basis": "rollout complete"}

    return {
        "counts": dict(counts),
        "remaining": remaining,
        "throughputNodesPerHour": (
            round(throughput, 3) if throughput is not None else None
        ),
        "eta": eta,
        "phases": stats,
        "nodeWall": (
            {
                "count": len(walls),
                **{
                    name: round(quantile(walls, q), 3)
                    for name, q in _QUANTILES
                },
            }
            if walls
            else None
        ),
        "stragglers": find_stragglers(
            timelines, stats, now, factor=straggler_factor
        ),
    }


# --------------------------------------------------------------- SLO checks
def evaluate_slos(
    analytics: dict,
    timelines: List[dict],
    slos,
    now: float,
    rollout_started: Optional[float],
) -> Tuple[List[dict], Dict[str, float]]:
    """(breaches, burn_rates) for the declared targets.  Pure — the
    engine owns the stateful parts (start stamp, edge detection).

    Scoping: CLOSED intervals are only judged when they started at or
    after *rollout_started* (when known) — node-annotation checkpoints
    persist history across rollouts, and a 2-hour drain from LAST
    month's wave must not re-breach (and re-page) THIS one.  A fresh
    engine with no stamp (offline CLI on a finished dump, operator
    restart on an idle fleet) judges all retained history — that is the
    post-hoc report of the most recent rollout.  OPEN phases are always
    judged: a node currently sitting in a phase is a current problem by
    definition."""
    from ..upgrade import consts

    breaches: List[dict] = []
    burn: Dict[str, float] = {}
    # terminal phases are not latencies; queue phases (upgrade-required)
    # measure pacing — a throttled 1000-node wave legitimately queues
    # its tail for hours and must not breach the per-NODE ceiling
    skip = _terminal_phases() | _queue_phases()
    since = rollout_started if rollout_started is not None else float("-inf")

    if slos.max_node_phase_seconds > 0:
        worst = 0.0
        worst_at: Optional[Tuple[str, str]] = None
        for tl in timelines:
            for phase, start, end in tl.get("intervals") or []:
                if phase in skip or start < since:
                    continue
                if end - start > worst:
                    worst = end - start
                    worst_at = (tl.get("node"), phase)
            phase = tl.get("current")
            if phase and phase not in skip:
                elapsed = now - float(tl.get("currentSince") or now)
                if elapsed > worst:
                    worst = elapsed
                    worst_at = (tl.get("node"), phase)
        burn["maxNodePhaseSeconds"] = round(
            worst / slos.max_node_phase_seconds, 3
        )
        if worst > slos.max_node_phase_seconds:
            breaches.append(
                {
                    "slo": "maxNodePhaseSeconds",
                    "target": slos.max_node_phase_seconds,
                    "observed": round(worst, 3),
                    "detail": (
                        f"node {worst_at[0]} spent {worst:.1f}s in "
                        f"{worst_at[1]} (target "
                        f"{slos.max_node_phase_seconds:g}s)"
                        if worst_at
                        else ""
                    ),
                }
            )

    if slos.drain_p99_seconds > 0:
        # scoped like maxNodePhaseSeconds (the analytics' phase stats
        # deliberately keep all history — more straggler baseline —
        # but the BREACH verdict must cover this rollout's drains only)
        drains = [
            end - start
            for tl in timelines
            for phase, start, end in tl.get("intervals") or []
            if phase == consts.UPGRADE_STATE_DRAIN_REQUIRED
            and start >= since
        ]
        if drains:
            observed = round(quantile(drains, 0.99), 3)
            burn["drainP99Seconds"] = round(
                observed / slos.drain_p99_seconds, 3
            )
            if observed > slos.drain_p99_seconds:
                breaches.append(
                    {
                        "slo": "drainP99Seconds",
                        "target": slos.drain_p99_seconds,
                        "observed": observed,
                        "detail": (
                            f"drain p99 {observed:g}s over "
                            f"{len(drains)} drains (target "
                            f"{slos.drain_p99_seconds:g}s)"
                        ),
                    }
                )

    if slos.fleet_completion_deadline_seconds > 0:
        remaining = analytics.get("remaining", 0)
        if remaining > 0 and rollout_started is not None:
            deadline = slos.fleet_completion_deadline_seconds
            elapsed = max(0.0, now - rollout_started)
            counts = analytics.get("counts") or {}
            total = max(1, int(counts.get("total", 0)))
            progress = max(0.01, int(counts.get("done", 0)) / total)
            burn["fleetCompletionDeadlineSeconds"] = round(
                (elapsed / deadline) / progress, 3
            )
            eta = analytics.get("eta") or {}
            projected = elapsed + float(eta.get("seconds") or 0.0)
            if elapsed > deadline or projected > deadline:
                breaches.append(
                    {
                        "slo": "fleetCompletionDeadlineSeconds",
                        "target": deadline,
                        "observed": round(max(elapsed, projected), 3),
                        "detail": (
                            f"{elapsed:.0f}s elapsed, projected "
                            f"completion {projected:.0f}s "
                            f"(deadline {deadline:g}s)"
                        ),
                    }
                )
    return breaches, burn


class SloEngine:
    """Per-manager SLO evaluator: holds the rollout-start stamp, the
    breached-set edge detector, and the latest report (the
    ``/debug/slo`` payload)."""

    def __init__(self, recorder=None) -> None:
        #: Flight recorder supplying timelines; None resolves the
        #: process default per evaluation (test-swap friendly).
        self._recorder = recorder
        self._lock = threading.Lock()
        #: When the CURRENT (or, after completion, the most recent)
        #: rollout started — stamped when remaining work first appears,
        #: re-stamped when a NEW rollout begins, and deliberately
        #: retained through completion so the post-rollout report still
        #: covers the wave that just finished.
        self._rollout_started: Optional[float] = None
        self._rollout_active = False
        self._breached: set = set()
        self._last_report: Optional[dict] = None
        #: Whether the previous evaluation published the SLO gauge
        #: families — an ``slos`` block removed MID-ROLLOUT (analytics
        #: may keep evaluating for an ``analysis`` block) must retire
        #: them exactly like a removed remediation block retires its
        #: gauges, not leave them frozen at the last breach.
        self._published_gauges = False
        #: Windowed samples of the SLO gauges (obs/history.py): the
        #: analysis engine's sustained-condition oracle and the
        #: ``/debug/slo?history=1`` surface.
        self.history = history_mod.MetricsHistory()

    # ------------------------------------------------------------- plumbing
    def _timelines(self) -> List[dict]:
        from ..upgrade import timeline as timeline_mod

        # `is None`, not truthiness: an empty injected recorder is
        # falsy (len() == 0) but still the one the caller chose
        recorder = (
            self._recorder
            if self._recorder is not None
            else timeline_mod.default_recorder()
        )
        return recorder.timelines()

    @staticmethod
    def counts_from_state(state) -> Dict[str, int]:
        """Snapshot census — delegated to the ONE bucket classification
        :func:`~..upgrade.rollout_status.bucket_census` so this report
        can never disagree with the RolloutStatus shown beside it."""
        from ..upgrade.rollout_status import bucket_census

        census = bucket_census(state)
        return {
            key: census[key]
            for key in ("total", "done", "pending", "inProgress", "failed")
        }

    # ------------------------------------------------------------ lifecycle
    def evaluate(self, state, policy, now: Optional[float] = None) -> dict:
        """One reconcile's evaluation: analytics always, SLO checks when
        the policy declares an ``slos`` block; publishes the gauges and
        edge-counts new breaches.  Returns (and retains) the report."""
        now = time.time() if now is None else now
        slos = getattr(policy, "slos", None) if policy is not None else None
        counts = self.counts_from_state(state)
        timelines = self._timelines()
        factor = (
            slos.straggler_factor
            if slos is not None
            else DEFAULT_STRAGGLER_FACTOR
        )
        # Stamp BEFORE the analytics: throughput/ETA must be scoped to
        # this wave's completions, so the stamp has to exist first.
        remaining = int(counts.get("pending", 0)) + int(
            counts.get("inProgress", 0)
        )
        fresh_rollout = False
        with self._lock:
            if remaining > 0 and not self._rollout_active:
                # a NEW rollout: re-stamp, scoping out prior history
                self._rollout_active = True
                fresh_rollout = True
                self._rollout_started = (
                    rollout_started_estimate(timelines) or now
                )
            elif remaining == 0:
                # keep the stamp: the post-completion report covers the
                # wave that just finished until a new one begins
                self._rollout_active = False
            started = self._rollout_started
        if fresh_rollout:
            # The metrics-history ring restarts with the rollout: a
            # sustained-condition streak ("breaches == 0 for 300s")
            # must soak the NEW revision's observations — an hour of
            # pre-rollout idle-healthy samples would satisfy it
            # vacuously on the first reconcile (and a prior rollout's
            # sustained burn could insta-abort a fixed one).
            self.history.clear()
        analytics = analyze(
            timelines, counts, now=now, straggler_factor=factor,
            since=started,
        )
        report = dict(analytics)
        report["generatedAt"] = now
        report["rolloutStartedAt"] = started
        # History samples for the analysis engine's sustained-condition
        # windows (+ /debug/slo?history=1): analytics series always,
        # burn/breach series only under a declared slos block.
        samples: Dict[str, float] = {
            "rollout_stragglers": float(len(analytics["stragglers"])),
        }
        eta_seconds = (analytics.get("eta") or {}).get("seconds")
        if eta_seconds is not None:
            # an UNKNOWN eta records nothing (not the -1 gauge
            # sentinel): "eta <= N" must be unobserved — never
            # vacuously held — while the engine cannot project yet
            samples["rollout_eta_seconds"] = float(eta_seconds)
        for phase, stat in analytics["phases"].items():
            for q, _ in _QUANTILES:
                samples[f"slo_phase_seconds:{phase}:{q}"] = stat[q]
        if slos is None:
            # The slos block is gone but the engine keeps evaluating
            # (an analysis block still wants the analytics): retire the
            # gauge families and the breach edge-detector so dashboards
            # and the breach set don't outlive the block (same
            # retirement contract as remediation).
            with self._lock:
                self._breached = set()
            if self._published_gauges:
                self._published_gauges = False
                metrics.retire_slo_gauges()
            self.history.record(samples, now=now)
        if slos is not None:
            breaches, burn = evaluate_slos(
                analytics, timelines, slos, now, started
            )
            report["slos"] = {
                "declared": slos.to_dict(),
                "breaches": breaches,
                "burnRates": burn,
            }
            with self._lock:
                current = {b["slo"] for b in breaches}
                fresh = sorted(current - self._breached)
                self._breached = current
            detail_by_name = {b["slo"]: b.get("detail", "") for b in breaches}
            for name in fresh:
                metrics.record_slo_breach(name)
                # decision-audit stream: breach EDGES only, like the
                # counter — reconciles spent in breach aggregate via the
                # log's dedup ring, not via fresh emissions
                from . import events as events_mod

                events_mod.emit(
                    events_mod.EVENT_SLO_BREACHED,
                    name,
                    events_mod.FLEET_TARGET,
                    detail_by_name.get(name, ""),
                )
            metrics.publish_slo_gauges(
                phase_quantiles={
                    (phase, q): stat[q]
                    for phase, stat in analytics["phases"].items()
                    for q, _ in _QUANTILES
                },
                eta_seconds=(
                    (analytics.get("eta") or {}).get("seconds")
                ),
                stragglers=len(analytics["stragglers"]),
                burn_rates=burn,
                breached={b["slo"] for b in breaches},
            )
            self._published_gauges = True
            for name, rate in burn.items():
                samples[f"slo_burn_rate:{name}"] = rate
            samples["slo_breaches"] = float(len(breaches))
            self.history.record(samples, now=now)
        with self._lock:
            self._last_report = report
        return report

    def disable(self) -> None:
        """The policy lost its ``slos`` block (or the CR went away):
        retire the gauges and the stale report so dashboards don't keep
        showing the last rollout's numbers forever."""
        with self._lock:
            had = self._last_report is not None
            self._last_report = None
            self._rollout_started = None
            self._rollout_active = False
            self._breached = set()
        self.history.clear()
        if had:
            self._published_gauges = False
            metrics.retire_slo_gauges()

    def last_report(self) -> Optional[dict]:
        with self._lock:
            return self._last_report


# ------------------------------------------------------------------ rendering
def render_report(report: dict) -> str:
    """Human rendering of an SLO report (the CLI's default view)."""
    lines: List[str] = []
    counts = report.get("counts") or {}
    lines.append(
        "rollout: done {done}/{total} inProgress {inProgress} "
        "pending {pending} failed {failed}".format(
            **{
                k: counts.get(k, 0)
                for k in ("done", "total", "inProgress", "pending", "failed")
            }
        )
    )
    throughput = report.get("throughputNodesPerHour")
    if throughput is not None:
        lines.append(f"throughput: {throughput:g} nodes/hour")
    eta = report.get("eta")
    if eta is not None and eta.get("seconds") is not None:
        lines.append(
            f"ETA: {eta['seconds']:.0f}s "
            f"(band p50 {eta['p50Seconds']:.0f}s – "
            f"p95 {eta['p95Seconds']:.0f}s; {eta.get('basis', '')})"
        )
    else:
        lines.append("ETA: unknown (need >= 2 completions)")
    phases = report.get("phases") or {}
    if phases:
        lines.append("")
        lines.append(f"{'PHASE':<26} {'N':>5} {'P50':>9} {'P95':>9} {'P99':>9}")
        for phase in sorted(phases):
            s = phases[phase]
            lines.append(
                f"{phase:<26} {s['count']:>5} {s['p50']:>8.2f}s "
                f"{s['p95']:>8.2f}s {s['p99']:>8.2f}s"
            )
    stragglers = report.get("stragglers") or []
    if stragglers:
        lines.append("")
        lines.append(f"stragglers ({len(stragglers)}):")
        for s in stragglers[:10]:
            lines.append(
                f"  {s['node']}: {s['elapsedSeconds']:.0f}s in {s['phase']} "
                f"(p95 {s['phaseP95Seconds']:g}s, threshold "
                f"{s['thresholdSeconds']:g}s)"
            )
    slo = report.get("slos")
    if slo is not None:
        lines.append("")
        breaches = slo.get("breaches") or []
        if breaches:
            lines.append(f"SLO BREACHES ({len(breaches)}):")
            for b in breaches:
                lines.append(f"  [{b['slo']}] {b['detail']}")
        else:
            lines.append("SLOs: all within target")
        burn = slo.get("burnRates") or {}
        if burn:
            lines.append(
                "burn rates: "
                + ", ".join(
                    f"{name}={rate:g}" for name, rate in sorted(burn.items())
                )
            )
    return "\n".join(lines)


# ------------------------------------------------------------------ selftest
def selftest() -> str:
    """End-to-end smoke on the in-memory apiserver (the ``make
    verify-slo`` gate): a small fleet rolls a new revision with the
    flight recorder on, timelines accumulate phase intervals, the
    analytics produce an ETA mid-rollout, an injected straggler is
    detected, and a declared SLO breach surfaces through all three
    planes — /debug/slo (a real OpsServer GET), rollout_status, and
    /metrics.  Raises AssertionError on any violated expectation."""
    import json as json_mod
    import urllib.request

    from ..api.upgrade_spec import (
        DrainSpec,
        IntOrString,
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
    from ..upgrade import consts, timeline as timeline_mod, util
    from ..upgrade.rollout_status import RolloutStatus
    from ..upgrade.upgrade_state import ClusterUpgradeStateManager

    namespace, labels = "slo-selftest", {"app": "selftest-runtime"}
    prev_registry = metrics.set_default_registry(metrics.MetricsRegistry())
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
        cluster.create(make_controller_revision(ds, 1, "rev1"))
        nodes = [f"node-{i}" for i in range(6)]
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
            spawn_pod(node, "rev1")
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
            max_parallel_upgrades=1,  # sequential: completions arrive one by one
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=5),
            slos=SloSpec(
                # microscopically tight on purpose: every real phase
                # exceeds it, so the breach path is exercised end to end
                max_node_phase_seconds=1e-6,
                drain_p99_seconds=1e-6,
                straggler_factor=3.0,
            ),
        )
        policy.validate()
        manager = ClusterUpgradeStateManager(
            cluster,
            cache=InformerCache(cluster, lag_seconds=0.0),
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
        )
        cluster.create(make_controller_revision(ds, 2, "rev2"))
        saw_eta = False
        state_key = util.get_upgrade_state_label_key()
        for _ in range(120):
            state = manager.build_state(namespace, labels)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            ds_controller()
            report = manager.slo_status() or {}
            eta = report.get("eta") or {}
            if eta.get("seconds") and report.get("remaining", 0) > 0:
                saw_eta = True
            done = all(
                (n["metadata"].get("labels") or {}).get(state_key)
                == consts.UPGRADE_STATE_DONE
                for n in cluster.list("Node")
            )
            if done:
                break
        else:
            raise AssertionError("selftest rollout did not converge")
        assert saw_eta, "no mid-rollout ETA was ever computed"

        recorder = timeline_mod.default_recorder()
        timelines = recorder.timelines()
        assert len(timelines) == len(nodes), "missing node timelines"
        walls = timeline_mod.wall_clock_samples(timelines)
        assert len(walls) == len(nodes), (
            f"cordon→done wall-clock missing: {len(walls)}/{len(nodes)}"
        )
        for tl in timelines:
            ends = [iv[2] for iv in tl["intervals"]]
            starts = [iv[1] for iv in tl["intervals"]]
            assert all(
                e1 <= s2 for e1, s2 in zip(ends, starts[1:])
            ), f"overlapping intervals on {tl['node']}"

        # Inject a straggler: a MANAGED node (driver pod + drain-required
        # state label, so the snapshot carries it and the observation
        # sweep's vanished-node pruning keeps it) that entered drain
        # 1000 s ago and never left; the fleet's real drains are
        # milliseconds, so the k×p95 rule must flag it.
        straggler = cluster.create(
            make_node(
                "straggler-0",
                labels={state_key: consts.UPGRADE_STATE_DRAIN_REQUIRED},
            )
        )
        nodes.append("straggler-0")
        spawn_pod("straggler-0", "rev2")
        fresh = cluster.get("DaemonSet", "selftest-runtime", namespace)
        fresh["status"]["desiredNumberScheduled"] = len(nodes)
        cluster.update(fresh)
        now = time.time()
        for phase, at in (
            (consts.UPGRADE_STATE_UPGRADE_REQUIRED, now - 1003),
            (consts.UPGRADE_STATE_CORDON_REQUIRED, now - 1002),
            (consts.UPGRADE_STATE_DRAIN_REQUIRED, now - 1000),
        ):
            recorder.transition(straggler, phase, now=at)

        state = manager.build_state(namespace, labels)
        report = manager._slo_engine.evaluate(state, policy)
        stragglers = report.get("stragglers") or []
        assert any(
            s["node"] == "straggler-0" for s in stragglers
        ), f"straggler not detected: {stragglers}"
        breaches = (report.get("slos") or {}).get("breaches") or []
        breached_names = {b["slo"] for b in breaches}
        assert "maxNodePhaseSeconds" in breached_names, breaches
        assert "drainP99Seconds" in breached_names, breaches

        # plane 1: metrics
        exposition = metrics.default_registry().render()
        assert "slo_breaches_total" in exposition, "breach counter missing"
        assert "rollout_eta_seconds" in exposition, "eta gauge missing"
        assert "slo_phase_seconds" in exposition, "phase gauge missing"

        # plane 2: rollout_status
        status = RolloutStatus.from_cluster_state(
            state, policy=policy, slo_report=report
        )
        rendered = status.render()
        assert "SLO" in rendered and "straggler" in rendered, rendered

        # plane 3: /debug/slo + /debug/timeline over a real HTTP GET
        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            slo_source=manager.slo_status,
            timeline_source=manager.timeline_status,
        ).start()
        with urllib.request.urlopen(ops.url + "/debug/slo", timeout=5) as rsp:
            payload = json_mod.loads(rsp.read())
        served = (payload.get("report") or {}).get("slos") or {}
        assert {
            b["slo"] for b in served.get("breaches") or []
        } >= {"maxNodePhaseSeconds"}, payload
        with urllib.request.urlopen(
            ops.url + "/debug/timeline?node=straggler-0", timeout=5
        ) as rsp:
            tpayload = json_mod.loads(rsp.read())
        assert [
            t["node"] for t in tpayload.get("timelines") or []
        ] == ["straggler-0"], tpayload
        with urllib.request.urlopen(ops.url + "/debug", timeout=5) as rsp:
            index = json_mod.loads(rsp.read())
        assert "/debug/slo" in (index.get("endpoints") or []), index
        return (
            f"slo selftest OK: {len(nodes)} nodes rolled, "
            f"{len(walls)} wall-clock samples, eta mid-rollout, "
            f"{len(stragglers)} straggler(s) flagged, breaches "
            f"{sorted(breached_names)} exposed via /debug/slo, "
            "rollout_status and /metrics"
        )
    finally:
        if ops is not None:
            ops.stop()
        if manager is not None:
            manager.shutdown()
        metrics.set_default_registry(prev_registry)
        timeline_mod.set_default_recorder(prev_recorder)
