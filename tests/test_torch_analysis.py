"""The port's analysis gates and adaptive pacing
(k8s_operator_libs_tpu_torch/upgrade/analysis.py), its metrics-history
ring (obs/history.py) and the AnalysisSpec API.

The classes of ``tests/test_analysis.py``, as cases of the same names,
run on the port, the rollouts through the port's
``ClusterUpgradeStateManager``; ``analysis_report`` and
``gate_from_report`` over a rollout's snapshot are also held to the JAX
package's in ``tests/test_torch_rollout_parity.py``.  Left in the JAX
file: ``TestGateSloThreePlanes`` (an ``OpsServer`` and the CLI) and the
two CLI tests of ``TestRolloutStatusAnalysis``.
"""

import random
import time

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import (
    AdaptivePacingSpec,
    AnalysisSpec,
    AnalysisStepSpec,
    DrainSpec,
    IntOrString,
    SloSpec,
    UpgradePolicySpec,
    ValidationError,
    parse_analysis_condition,
)
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.obs import history as history_mod
from k8s_operator_libs_tpu_torch.upgrade import analysis as analysis_mod
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def fresh_decision_log(port_globals):  # noqa: F811
    """The port's decision log, fresh for the test (``port_globals``)."""
    return events_mod.default_log()


@pytest.fixture()
def fresh_flight_recorder(port_globals):  # noqa: F811
    """The port's flight recorder, fresh for the test (``port_globals``)."""
    from k8s_operator_libs_tpu_torch.upgrade import timeline

    return timeline.default_recorder()


STATE_KEY = util.get_upgrade_state_label_key()


@pytest.fixture()
def fresh_registry():
    registry = metrics.MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    yield registry
    metrics.set_default_registry(previous)


def rollout_policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def reconcile(manager, fleet, policy):
    state = manager.build_state(NAMESPACE, DRIVER_LABELS)
    manager.apply_state(state, policy)
    manager.drain_manager.wait_idle(10.0)
    manager.pod_manager.wait_idle(10.0)
    fleet.reconcile_daemonset()
    return state


# ------------------------------------------------------- engine behavior
@pytest.fixture()
def gated_fleet():
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="rev1")
    for i in range(6):
        fleet.add_node(f"node-{i}")
    manager = ClusterUpgradeStateManager(cluster)
    yield cluster, fleet, manager
    manager.shutdown()


def analysis_policy(**analysis_kw):
    return rollout_policy(
        slos=SloSpec(fleet_completion_deadline_seconds=86400.0),
        analysis=AnalysisSpec(**analysis_kw),
    )


class TestConditionGrammar:
    def test_parses_full_form(self):
        c = parse_analysis_condition(
            "burn:fleetCompletionDeadlineSeconds <= 1.5 for 90s"
        )
        assert c.metric == "burn:fleetCompletionDeadlineSeconds"
        assert c.op == "<="
        assert c.value == 1.5
        assert c.for_seconds == 90.0

    def test_parses_bare_metric_no_window(self):
        c = parse_analysis_condition("stragglers == 0")
        assert (c.metric, c.op, c.value, c.for_seconds) == (
            "stragglers", "==", 0.0, 0.0,
        )

    def test_parses_phase_quantile_and_decimal_window(self):
        c = parse_analysis_condition("phase_p95:drain-required < 120 for 0.5s")
        assert c.metric == "phase_p95:drain-required"
        assert c.for_seconds == 0.5

    @pytest.mark.parametrize(
        "raw",
        [
            "",
            "burn: < 1",              # empty suffix
            "stragglers ~ 0",         # unknown op
            "stragglers < abc",       # non-numeric value
            "stragglers < 1 for 5m",  # only seconds
            "unknownmetric < 1",      # vocabulary violation
            "burn:x < 1 forever",
        ],
    )
    def test_rejects_bad_grammar(self, raw):
        with pytest.raises(ValidationError):
            parse_analysis_condition(raw)

    def test_history_key_mapping(self):
        assert analysis_mod.history_key("burn:x") == "slo_burn_rate:x"
        assert analysis_mod.history_key("breaches") == "slo_breaches"
        assert analysis_mod.history_key("stragglers") == "rollout_stragglers"
        assert analysis_mod.history_key("eta") == "rollout_eta_seconds"
        assert analysis_mod.history_key("queue") == "write_queue_depth"
        assert (
            analysis_mod.history_key("phase_p99:drain-required")
            == "slo_phase_seconds:drain-required:p99"
        )


class TestAnalysisSpecValidation:
    def test_round_trip(self):
        policy = rollout_policy(
            slos=SloSpec(fleet_completion_deadline_seconds=3600),
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="soak",
                        max_exposure=IntOrString("10%"),
                        advance_on=("breaches == 0 for 60s",),
                        abort_on=("burn:fleetCompletionDeadlineSeconds > 2",),
                    ),
                ),
                pacing=AdaptivePacingSpec(min_scale=0.2),
            ),
        )
        policy.validate()
        d = policy.to_dict()
        again = UpgradePolicySpec.from_dict(d)
        again.validate()
        assert again.to_dict() == d
        assert again.analysis.steps[0].max_exposure.to_raw() == "10%"
        assert again.analysis.pacing.min_scale == 0.2

    def test_duplicate_step_names_rejected(self):
        with pytest.raises(ValidationError):
            AnalysisSpec(
                steps=(
                    AnalysisStepSpec(name="a"),
                    AnalysisStepSpec(name="a"),
                )
            ).validate()

    def test_empty_block_rejected(self):
        with pytest.raises(ValidationError):
            AnalysisSpec().validate()

    def test_slo_metrics_require_slos_block(self):
        policy = rollout_policy(
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="s", advance_on=("breaches == 0",)
                    ),
                )
            )
        )
        with pytest.raises(ValidationError):
            policy.validate()
        # analytics-only metrics are fine without declared targets
        policy = rollout_policy(
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="s", advance_on=("stragglers == 0",)
                    ),
                )
            )
        )
        policy.validate()

    def test_pacing_knob_ranges(self):
        for bad in (
            {"decrease": 1.0},
            {"decrease": 0.0},
            {"increase": 0.0},
            {"min_scale": 0.0},
            {"min_scale": 1.5},
            {"burn_high": 0.0},
        ):
            with pytest.raises(ValidationError):
                AdaptivePacingSpec(**bad).validate()

    def test_string_conditions_rejected(self):
        with pytest.raises(ValidationError):
            AnalysisStepSpec(name="s", advance_on="breaches == 0")

    def test_typod_burn_name_rejected_at_admission(self):
        """burn:<name> must reference a DECLARED slos target — a typo
        would otherwise never hold and wedge the rollout at the step's
        cap with no error anywhere."""
        policy = rollout_policy(
            slos=SloSpec(fleet_completion_deadline_seconds=3600),
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="s",
                        advance_on=("burn:fleetCompletionDeadline < 1",),
                    ),
                )
            ),
        )
        with pytest.raises(ValidationError, match="no such target"):
            policy.validate()

    def test_pacing_dict_input_converts_like_steps(self):
        spec = AnalysisSpec(
            steps=[{"name": "soak"}], pacing={"increase": 0.5}
        )
        spec.validate()
        assert isinstance(spec.pacing, AdaptivePacingSpec)
        assert spec.pacing.increase == 0.5


class TestMetricsHistory:
    def test_holds_requires_sustained_streak(self):
        h = history_mod.MetricsHistory()
        h.record({"m": 0.0}, now=100.0)
        h.record({"m": 0.0}, now=105.0)
        h.record({"m": 0.0}, now=110.0)
        assert h.holds("m", "==", 0.0, for_seconds=0.0, now=110.0)
        assert h.holds("m", "==", 0.0, for_seconds=10.0, now=110.0)
        assert not h.holds("m", "==", 0.0, for_seconds=11.0, now=110.0)
        # a violating sample resets the streak
        h.record({"m": 5.0}, now=112.0)
        h.record({"m": 0.0}, now=114.0)
        assert not h.holds("m", "==", 0.0, for_seconds=5.0, now=114.0)
        assert h.held_seconds("m", "==", 0.0, now=114.0) == 0.0

    def test_unobserved_never_holds(self):
        h = history_mod.MetricsHistory()
        assert not h.holds("missing", "<", 1.0, for_seconds=0.0)
        assert h.held_seconds("missing", "<", 1.0) is None

    def test_retention_ages_out_samples_and_series(self):
        h = history_mod.MetricsHistory(retention_seconds=10.0)
        h.record({"a": 1.0, "b": 1.0}, now=0.0)
        h.record({"a": 1.0}, now=20.0)
        assert h.window("a", 100.0, now=20.0) == [(20.0, 1.0)]
        # b stopped reporting entirely: the series retires wholesale
        h.record({"a": 1.0}, now=31.0)
        assert h.latest("b") is None

    def test_max_samples_bounds_memory(self):
        h = history_mod.MetricsHistory(max_samples=4, retention_seconds=1e9)
        for i in range(10):
            h.record({"m": float(i)}, now=float(i))
        assert len(h.window("m", 1e9, now=10.0)) == 4

    def test_stale_series_never_holds(self):
        """A series whose source stopped recording (e.g. an SLO removed
        from the block mid-rollout) must stop satisfying sustained
        conditions within a few record cycles — not keep answering from
        its frozen newest sample for the whole retention window."""
        h = history_mod.MetricsHistory()
        h.record({"a": 0.0, "b": 0.0}, now=0.0)
        for i in range(1, 7):
            h.record({"a": 0.0}, now=float(i))  # b stops reporting
        assert h.holds("a", "==", 0.0, now=6.0)
        assert not h.holds("b", "==", 0.0, now=6.0)
        assert h.held_seconds("b", "==", 0.0, now=6.0) is None

    def test_snapshot_shape(self):
        h = history_mod.MetricsHistory()
        h.record({"m": 1.5}, now=100.0)
        snap = h.snapshot()
        assert snap["series"]["m"] == [[100.0, 1.5]]
        assert snap["retentionSeconds"] == h.retention_seconds


class TestPacingController:
    def spec(self, **kw):
        return AdaptivePacingSpec(adjust_interval_seconds=0.0, **kw)

    def test_decrease_then_recover(self, fresh_decision_log):
        c = analysis_mod.PacingController()
        spec = self.spec()
        scale, congested = c.update(spec, 5.0, 0, 0.0, now=0.0)
        assert scale == 0.5 and congested
        scale, _ = c.update(spec, 5.0, 0, 0.0, now=1.0)
        assert scale == 0.25
        # clears: additive recovery to exactly 1.0
        for t in range(2, 10):
            scale, _ = c.update(spec, 0.1, 0, 0.0, now=float(t))
        assert scale == 1.0

    def test_interval_gates_adjustments(self, fresh_decision_log):
        c = analysis_mod.PacingController()
        spec = AdaptivePacingSpec(adjust_interval_seconds=30.0)
        s1, _ = c.update(spec, 5.0, 0, 0.0, now=0.0)
        s2, _ = c.update(spec, 5.0, 0, 0.0, now=10.0)
        assert s1 == s2 == 0.5  # second call inside the hold window
        s3, _ = c.update(spec, 5.0, 0, 0.0, now=31.0)
        assert s3 == 0.25

    def test_signals_each_trigger(self, fresh_decision_log):
        spec = self.spec(burn_high=1.0, max_stragglers=2, queue_high=10)
        for kwargs in (
            {"burn": 1.5, "stragglers": 0, "queue_depth": 0.0},
            {"burn": None, "stragglers": 3, "queue_depth": 0.0},
            {"burn": 0.5, "stragglers": 0, "queue_depth": 11.0},
        ):
            c = analysis_mod.PacingController()
            scale, congested = c.update(spec, now=0.0, **kwargs)
            assert scale == 0.5 and congested

    def test_emits_pacing_adapt_decisions_and_counters(
        self, fresh_decision_log, fresh_registry
    ):
        c = analysis_mod.PacingController()
        spec = self.spec()
        c.update(spec, 5.0, 0, 0.0, now=0.0)
        c.update(spec, 0.1, 0, 0.0, now=1.0)
        events = events_mod.default_log().events()
        assert any(
            e["type"] == events_mod.EVENT_PACING_ADAPTED
            and e["reason"] == events_mod.REASON_PACING_ADAPT
            for e in events
        )
        out = fresh_registry.render()
        assert 'pacing_adjustments_total{direction="decrease"} 1' in out
        assert 'pacing_adjustments_total{direction="increase"} 1' in out

    def test_property_bounds_and_recovery(self, fresh_decision_log):
        """The pacing property the issue pins: the scale NEVER exceeds
        1.0 (so scaled slots never exceed the declared maxUnavailable
        budget), never starves below min_scale, and ALWAYS recovers to
        1.0 after the congestion clears — under randomized signal
        sequences."""
        rng = random.Random(0xC0FFEE)
        for _ in range(20):
            spec = AdaptivePacingSpec(
                adjust_interval_seconds=0.0,
                min_scale=rng.choice([0.1, 0.25, 0.5]),
                increase=rng.choice([0.1, 0.25, 0.5]),
                decrease=rng.choice([0.25, 0.5, 0.75]),
            )
            c = analysis_mod.PacingController()
            t = 0.0
            for _ in range(rng.randrange(1, 40)):
                burn = rng.choice([None, 0.0, 0.5, 2.0, 50.0])
                stragglers = rng.randrange(0, 6)
                queue = rng.choice([0.0, 10.0, 1000.0])
                scale, _ = c.update(spec, burn, stragglers, queue, now=t)
                assert spec.min_scale <= scale <= 1.0
                # the slot budget is never exceeded, never zeroed
                for available in (0, 1, 3, 100):
                    scaled = analysis_mod.scaled_slots(available, scale)
                    assert scaled <= available
                    if available > 0:
                        assert scaled >= 1
                t += 1.0
            # congestion clears: recovery within ceil(0.9/increase) ticks
            for _ in range(12):
                scale, _ = c.update(spec, 0.0, 0, 0.0, now=t)
                t += 1.0
            assert scale == 1.0


class TestAnalysisLifetime:
    """Review-hardening regressions: engine state is per-ROLLOUT, not
    per-manager-lifetime."""

    def test_history_restarts_with_the_rollout(self):
        """Pre-rollout idle-healthy samples must not vacuously satisfy
        a soak window on the new rollout's first reconcile."""
        from k8s_operator_libs_tpu_torch.obs import slo as slo_mod
        from k8s_operator_libs_tpu_torch.upgrade import timeline as timeline_mod

        engine = slo_mod.SloEngine(timeline_mod.FlightRecorder())
        policy = rollout_policy(
            slos=SloSpec(fleet_completion_deadline_seconds=86400.0)
        )

        class _State:
            def __init__(self, pending):
                self.node_states = {
                    consts.UPGRADE_STATE_DONE: [None] * (4 - pending),
                    consts.UPGRADE_STATE_UPGRADE_REQUIRED: [None] * pending,
                }

        t0 = time.time()
        for i in range(4):  # an hour of idle-healthy samples
            engine.evaluate(_State(0), policy, now=t0 + i * 900.0)
        assert engine.history.holds(
            "slo_breaches", "==", 0.0, for_seconds=1800.0, now=t0 + 2700.0
        )
        # the rollout begins: the ring restarts with it
        engine.evaluate(_State(2), policy, now=t0 + 2701.0)
        assert not engine.history.holds(
            "slo_breaches", "==", 0.0, for_seconds=1800.0, now=t0 + 2701.0
        )
        assert engine.history.holds(
            "slo_breaches", "==", 0.0, for_seconds=0.0, now=t0 + 2701.0
        )

    def test_pacing_subblock_removal_resets_controller(
        self, fresh_decision_log, fresh_registry,
    ):
        """Removing only the pacing sub-block (steps kept, so the
        engine never fully disables) must reset the controller — a
        later re-declared block starts at full scale, not a stale
        throttle."""
        engine = analysis_mod.AnalysisEngine()
        spec = AdaptivePacingSpec(adjust_interval_seconds=0.0)
        engine.pacing.update(spec, 10.0, 0, 0.0, now=0.0)
        assert engine.pacing.scale < 1.0
        policy = rollout_policy(
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="watch", advance_on=("stragglers == 0",)
                    ),
                ),
                pacing=None,
            )
        )
        decision = engine.evaluate(object(), policy, None, common=None)
        assert decision.wave_scale == 1.0
        assert engine.pacing.scale == 1.0

    def test_unknown_eta_is_unobserved_not_minus_one(self):
        """An unknowable ETA must leave 'eta <= N' UNOBSERVED — the -1
        gauge sentinel would otherwise satisfy it vacuously and advance
        a step on missing data."""
        from k8s_operator_libs_tpu_torch.obs import slo as slo_mod
        from k8s_operator_libs_tpu_torch.upgrade import timeline as timeline_mod

        assert analysis_mod.resolve_metric("eta", {"eta": None}) is None
        assert (
            analysis_mod.resolve_metric("eta", {"eta": {"seconds": 120.0}})
            == 120.0
        )
        engine = slo_mod.SloEngine(timeline_mod.FlightRecorder())
        policy = rollout_policy(
            slos=SloSpec(fleet_completion_deadline_seconds=86400.0)
        )

        class _State:
            node_states = {
                consts.UPGRADE_STATE_UPGRADE_REQUIRED: [None] * 4,
            }

        engine.evaluate(_State, policy)
        assert engine.history.latest("rollout_eta_seconds") is None
        assert not engine.history.holds(
            "rollout_eta_seconds", "<=", 7200.0
        )

    def test_suspended_analysis_never_throttles_the_recovery(
        self, fresh_decision_log, fresh_registry,
    ):
        """While remediation pauses/rolls back, the EFFECTIVE wave
        scale is 1.0 — the rollback wave must not run at min_scale
        because the abort's own burn signal is still high."""
        import types

        engine = analysis_mod.AnalysisEngine()
        spec = AdaptivePacingSpec(adjust_interval_seconds=0.0)
        engine.pacing.update(spec, 10.0, 0, 0.0, now=0.0)
        engine.pacing.update(spec, 10.0, 0, 0.0, now=1.0)
        assert engine.pacing.scale < 0.5
        policy = rollout_policy(
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="watch", advance_on=("stragglers == 0",)
                    ),
                ),
                pacing=spec,
            )
        )
        remediation = types.SimpleNamespace(
            paused=False, rollback_active=True
        )
        decision = engine.evaluate(
            object(), policy, None, common=None, remediation=remediation
        )
        assert decision.suspended
        assert decision.wave_scale == 1.0

    def test_pacing_only_block_is_never_passed(
        self, fresh_decision_log, fresh_registry,
    ):
        """Live and offline agree: a step-less (pacing-only) block
        reports 'pacing only', not 'passed'."""
        engine = analysis_mod.AnalysisEngine()
        policy = rollout_policy(
            analysis=AnalysisSpec(pacing=AdaptivePacingSpec())
        )
        decision = engine.evaluate(object(), policy, None, common=None)
        assert decision.passed is False
        verdict = analysis_mod.gate_from_report(decision.report, pending=3)
        assert not verdict["blocking"]
        assert "pacing only" in verdict["reason"]

    def test_unpinned_abort_latch_releases_when_conditions_clear(
        self, fresh_decision_log, fresh_registry,
    ):
        """An abort latched while the revision oracle was unavailable
        (no pinned target) must release once the abort conditions
        clear, not hold admissions forever."""
        engine = analysis_mod.AnalysisEngine()
        policy = rollout_policy(
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="watch", abort_on=("stragglers > 0",)
                    ),
                ),
            )
        )
        state = object()  # never touched: no cap, no common
        engine._history.record({"rollout_stragglers": 5.0})
        decision = engine.evaluate(state, policy, None, common=None)
        assert decision.aborted
        assert engine._abort_target == ""
        engine._history.record({"rollout_stragglers": 0.0})
        decision = engine.evaluate(state, policy, None, common=None)
        assert not decision.aborted

    def test_new_rollout_restarts_the_steps(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        """A passed analysis is passed for ONE revision: the next
        rollout under the same long-lived manager must re-enter step
        one and re-apply its exposure cap, not wave straight through."""
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0",),
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        for _ in range(60):
            reconcile(manager, fleet, policy)
            if fleet.all_done():
                break
        assert fleet.all_done()
        assert (manager.analysis_status() or {}).get("passed") is True
        # rollout 2: the cursor must reset and the cap re-gate
        events_mod.default_log().clear()
        fleet.publish_new_revision("rev3")
        # never-advancing now, so the re-applied cap is observable
        policy.analysis.steps[0].advance_on = ("breaches == 0 for 3600s",)
        for _ in range(4):
            reconcile(manager, fleet, policy)
        report = manager.analysis_status() or {}
        assert report.get("passed") is False, report
        assert report.get("activeStep") == "soak", report
        exposed = [
            n for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(exposed) == 2, fleet.states()
        assert any(
            e["type"] == events_mod.EVENT_NODE_DEFERRED
            and e["reason"] == events_mod.REASON_SLO_GATE
            for e in events_mod.default_log().events()
        )

    def test_midrollout_revision_publish_restarts_the_steps(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        """A rev3 published while the rev2 rollout is still in flight
        never re-stamps the rollout start — the TARGET change must
        restart the analysis (and its observation windows) anyway."""
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0",),  # instant
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        for _ in range(4):
            reconcile(manager, fleet, policy)
        assert (manager.analysis_status() or {}).get("passed") is True
        assert not fleet.all_done()
        # rev3 lands mid-flight: the cursor must re-enter step one
        fleet.publish_new_revision("rev3")
        policy.analysis.steps[0].advance_on = ("breaches == 0 for 3600s",)
        for _ in range(3):
            reconcile(manager, fleet, policy)
        report = manager.analysis_status() or {}
        assert report.get("passed") is False, report
        assert report.get("activeStep") == "soak", report

    def test_pacing_recovers_while_rollout_is_paused(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        """auto_upgrade=False must not freeze the analysis plane: the
        AIMD scale keeps recovering during the pause (no stale
        UpgradePacingThrottled page, no stuck write-concurrency cap)."""
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="watch", advance_on=("stragglers == 0",)
                ),
            ),
            pacing=AdaptivePacingSpec(
                adjust_interval_seconds=0.0, min_scale=0.25
            ),
        )
        fleet.publish_new_revision("rev2")
        reconcile(manager, fleet, policy)
        policy.slos.fleet_completion_deadline_seconds = 1e-6
        for _ in range(3):
            reconcile(manager, fleet, policy)
        assert (
            (manager.analysis_status() or {}).get("pacing") or {}
        ).get("scale", 1.0) < 1.0
        # pause + clear the pressure: the scale must climb back to 1.0
        policy.auto_upgrade = False
        policy.slos.fleet_completion_deadline_seconds = 86400.0
        for _ in range(8):
            reconcile(manager, fleet, policy)
        assert (
            (manager.analysis_status() or {}).get("pacing") or {}
        ).get("scale") == 1.0


class TestWriteConcurrencyScale:
    def test_dispatcher_claim_cap_scales_and_restores(self):
        from k8s_operator_libs_tpu_torch.cluster.writepipeline import (
            WriteDispatcher,
        )

        store = InMemoryCluster()
        d = WriteDispatcher(store, max_workers=8, use_batch=False)
        try:
            assert d.worker_target == 8
            d.set_worker_scale(0.5)
            assert d.worker_target == 4
            d.set_worker_scale(0.01)
            assert d.worker_target == 1  # never zero
            d.set_worker_scale(5.0)
            assert d.worker_target == 8  # hard ceiling holds
        finally:
            d.close()

    def test_provider_applies_scale_to_future_dispatcher(self):
        from k8s_operator_libs_tpu_torch.cluster.writepipeline import WriteOp
        from k8s_operator_libs_tpu_torch.upgrade.node_upgrade_state_provider import (
            NodeUpgradeStateProvider,
        )
        from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache

        cluster = InMemoryCluster()
        cluster.create(
            {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n0"}}
        )
        provider = NodeUpgradeStateProvider(
            cluster, InformerCache(cluster, lag_seconds=0.0)
        )
        try:
            provider.set_write_concurrency_scale(0.25)
            with provider.pipelined_writes(max_workers=8):
                provider.change_node_upgrade_annotation(
                    cluster.get("Node", "n0"), "k8s.io/test", "1"
                )
            assert provider._write_dispatcher.worker_target == 2
            provider.set_write_concurrency_scale(1.0)
            assert provider._write_dispatcher.worker_target == 8
        finally:
            provider.close()

    def test_throttled_dispatcher_still_drains(self):
        from k8s_operator_libs_tpu_torch.cluster.writepipeline import (
            WriteDispatcher,
            WriteOp,
        )

        store = InMemoryCluster()
        for i in range(16):
            store.create(
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {"name": f"n{i}"},
                }
            )
        d = WriteDispatcher(store, max_workers=8, use_batch=False)
        try:
            d.set_worker_scale(0.1)  # single stream
            for i in range(16):
                d.submit(
                    WriteOp(
                        op="patch",
                        kind="Node",
                        name=f"n{i}",
                        body={"metadata": {"labels": {"x": str(i)}}},
                    )
                )
            d.flush(timeout=10.0)
        finally:
            d.close()
        for i in range(16):
            node = store.get("Node", f"n{i}")
            assert node["metadata"]["labels"]["x"] == str(i)


class TestAnalysisEngine:
    def test_exposure_cap_defers_with_gate_slo(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0 for 3600s",),  # never
                ),
            )
        )
        policy.validate()
        fleet.publish_new_revision("rev2")
        for _ in range(3):
            reconcile(manager, fleet, policy)
        # exactly 2 units exposed, the rest deferred with gate:slo
        exposed = [
            n for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(exposed) == 2, fleet.states()
        deferred = [
            e
            for e in events_mod.default_log().events()
            if e["type"] == events_mod.EVENT_NODE_DEFERRED
            and e["reason"] == events_mod.REASON_SLO_GATE
        ]
        assert len(deferred) == 4, deferred
        report = manager.analysis_status()
        assert report["activeStep"] == "soak"
        assert report["exposure"]["cap"] == 2
        out = fresh_registry.render()
        assert 'analysis_gate_state{step="soak"} 1' in out
        assert 'reason="gate:slo"' in out

    def test_advance_opens_fleet_and_emits_event(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0",),  # instant
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        for _ in range(60):
            reconcile(manager, fleet, policy)
            if fleet.all_done():
                break
        assert fleet.all_done(), fleet.states()
        events = events_mod.default_log().events()
        assert any(
            e["type"] == events_mod.EVENT_ANALYSIS_STEP_ADVANCED
            and e["reason"] == events_mod.REASON_SLO_GATE
            for e in events
        )
        report = manager.analysis_status()
        assert report["passed"] is True
        out = fresh_registry.render()
        assert 'analysis_gate_state{step="soak"} 2' in out

    def test_abort_trips_breaker_and_rolls_back_to_lkg(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        from k8s_operator_libs_tpu_torch.api import RemediationSpec
        from k8s_operator_libs_tpu_torch.cluster.objects import (
            CONTROLLER_REVISION_HASH_LABEL,
        )

        cluster, fleet, manager = gated_fleet
        policy = rollout_policy(
            slos=SloSpec(fleet_completion_deadline_seconds=86400.0),
            remediation=RemediationSpec(
                failure_threshold=1.0,
                min_attempted=999,
                auto_rollback=True,
                backoff_seconds=0.0,
            ),
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="watch",
                        abort_on=(
                            "burn:fleetCompletionDeadlineSeconds >= 5",
                        ),
                    ),
                ),
            ),
        )
        # healthy era records the LKG
        for _ in range(2):
            reconcile(manager, fleet, policy)
        fleet.publish_new_revision("rev2")
        reconcile(manager, fleet, policy)
        assert not fleet.all_done()
        # inject: burn explodes, the abort condition holds instantly
        policy.slos.fleet_completion_deadline_seconds = 1e-6
        for _ in range(5):
            reconcile(manager, fleet, policy)
            if (manager.analysis_status() or {}).get("aborted"):
                break
        assert (manager.analysis_status() or {}).get("aborted"), (
            manager.analysis_status()
        )
        breaker = (manager.remediation_status() or {}).get("breaker") or {}
        assert breaker.get("reason", "").startswith("analysis step")
        types = {e["type"] for e in events_mod.default_log().events()}
        assert events_mod.EVENT_ANALYSIS_ABORTED in types
        assert events_mod.EVENT_BREAKER_TRIPPED in types
        assert events_mod.EVENT_ROLLBACK_STARTED in types
        # fix the SLO; the rollback converges the fleet on the LKG
        policy.slos.fleet_completion_deadline_seconds = 86400.0
        for _ in range(80):
            reconcile(manager, fleet, policy)
            if fleet.all_done():
                break
        assert fleet.all_done(), fleet.states()
        for pod in cluster.list("Pod", namespace=NAMESPACE):
            assert (
                pod["metadata"]["labels"][CONTROLLER_REVISION_HASH_LABEL]
                == "rev1"
            )
        # the abort latch released once the target moved off rev2
        assert not (manager.analysis_status() or {}).get("aborted")

    def test_abort_without_remediation_blocks_with_gate_slo(
        self, gated_fleet, fresh_decision_log, fresh_flight_recorder,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="watch",
                    abort_on=("burn:fleetCompletionDeadlineSeconds >= 5",),
                ),
            )
        )
        fleet.publish_new_revision("rev2")
        reconcile(manager, fleet, policy)
        policy.slos.fleet_completion_deadline_seconds = 1e-6
        before = dict(fleet.states())
        for _ in range(4):
            reconcile(manager, fleet, policy)
        assert (manager.analysis_status() or {}).get("aborted")
        # no remediation block: nothing rolls back, but nothing fresh
        # is admitted either — pending nodes freeze with gate:slo
        pending = [
            n for n, s in fleet.states().items()
            if s == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert pending
        deferred = [
            e
            for e in events_mod.default_log().events()
            if e["type"] == events_mod.EVENT_NODE_DEFERRED
            and e["reason"] == events_mod.REASON_SLO_GATE
        ]
        assert deferred
        assert before  # silence unused warning; states captured above

    def test_removed_analysis_block_retires_cleanly_mid_rollout(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        """The satellite bugfix regression: a removed analysis block
        must retire its gauges, drop the abort latch, restore the wave
        scale, and release the exposure gate — mid-rollout."""
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(1),
                    advance_on=("breaches == 0 for 3600s",),  # never
                ),
            ),
            pacing=AdaptivePacingSpec(adjust_interval_seconds=0.0),
        )
        fleet.publish_new_revision("rev2")
        for _ in range(3):
            reconcile(manager, fleet, policy)
        assert "analysis_gate_state" in fresh_registry.render()
        assert manager.analysis_status() is not None
        # the operator edits the CR: block removed mid-rollout
        policy.analysis = None
        reconcile(manager, fleet, policy)
        assert manager.analysis_status() is None
        out = fresh_registry.render()
        assert 'analysis_gate_state{step=' not in out
        # the scale SERIES is retired (the family header alone remains)
        assert "\nk8s_operator_libs_tpu_pacing_wave_scale " not in out
        # the exposure gate is gone: the fleet converges
        for _ in range(60):
            reconcile(manager, fleet, policy)
            if fleet.all_done():
                break
        assert fleet.all_done(), fleet.states()

    def test_removed_slos_block_retires_gauges_while_analysis_runs(
        self, gated_fleet, fresh_decision_log, fresh_registry,
        fresh_flight_recorder,
    ):
        """Removing only the slos block mid-rollout retires the SLO
        gauge families and the breach edge-set while the analysis block
        keeps evaluating over the analytics series."""
        cluster, fleet, manager = gated_fleet
        policy = rollout_policy(
            slos=SloSpec(
                # microscopic: breaches immediately, so the breach
                # gauges exist before the block is removed
                max_node_phase_seconds=1e-6,
                fleet_completion_deadline_seconds=86400.0,
            ),
            analysis=AnalysisSpec(
                steps=(
                    AnalysisStepSpec(
                        name="soak", advance_on=("stragglers == 0",)
                    ),
                ),
            ),
        )
        fleet.publish_new_revision("rev2")
        for _ in range(4):
            reconcile(manager, fleet, policy)
        out = fresh_registry.render()
        assert "slo_burn_rate" in out
        policy.slos = None
        policy.analysis.steps[0].advance_on = ("stragglers == 0",)
        reconcile(manager, fleet, policy)
        out = fresh_registry.render()
        assert "slo_burn_rate{" not in out
        assert "slo_breached{" not in out
        # the analytics-driven analysis keeps running
        assert manager.analysis_status() is not None
        # /debug/slo report still served (analytics-only)
        assert manager.slo_status() is not None
        assert manager.slo_status().get("slos") is None


class TestRolloutStatusAnalysis:
    def test_status_carries_analysis_gate_and_pacing(
        self, gated_fleet, fresh_decision_log, fresh_flight_recorder,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak",
                    max_exposure=IntOrString(2),
                    advance_on=("breaches == 0 for 3600s",),
                ),
            ),
            pacing=AdaptivePacingSpec(),
        )
        fleet.publish_new_revision("rev2")
        for _ in range(3):
            state = reconcile(manager, fleet, policy)
        status = RolloutStatus.from_cluster_state(
            state,
            policy=policy,
            analysis=manager.analysis_status(),
        )
        gates = {g.gate: g for g in status.gates}
        assert "analysis" in gates
        assert gates["analysis"].blocking
        assert "exposure cap" in gates["analysis"].reason
        rendered = status.render()
        assert "analysis" in rendered
        payload = status.to_dict()
        assert payload["analysis"]["activeStep"] == "soak"

    def test_offline_status_computes_analysis_approximation(
        self, gated_fleet, fresh_decision_log, fresh_flight_recorder,
    ):
        cluster, fleet, manager = gated_fleet
        policy = analysis_policy(
            steps=(
                AnalysisStepSpec(
                    name="soak", advance_on=("stragglers == 0",)
                ),
            ),
        )
        fleet.publish_new_revision("rev2")
        state = reconcile(manager, fleet, policy)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        assert status.analysis is not None
        assert status.analysis["offline"] is True
