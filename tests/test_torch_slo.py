"""The port's SLO engine and its flight-recorder analytics
(k8s_operator_libs_tpu_torch/obs/slo.py).

``TestFlightRecorder``, ``TestAnalytics``, ``TestSloSpec``,
``TestSloEngine``, ``TestRolloutStatusSloSurface`` and
``TestOpsServerSurfaces`` of ``tests/test_slo.py``, as cases of the same
names, run on the port, the rollouts through its
``ClusterUpgradeStateManager``, the surfaces on its ``OpsServer``; the
SLO analytics over a rollout's snapshot are also held to the JAX
package's in ``tests/test_torch_rollout_parity.py``.  ``TestSloCli`` and
``TestHistoryJsonParity`` wait for the CLI.
"""

import json
import random
import time
import urllib.error
import urllib.request

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, SloSpec, UpgradePolicySpec, ValidationError
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import slo as slo_mod
from k8s_operator_libs_tpu_torch.upgrade import consts, timeline as timeline_mod, util
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
from k8s_operator_libs_tpu_torch.upgrade.timeline import FlightRecorder
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


STATE_KEY_OF = util.get_upgrade_state_label_key


@pytest.fixture()
def cluster():
    return InMemoryCluster()


def drive_rollout(cluster, fleet, policy, manager=None, max_cycles=200):
    """Reconcile until every managed node is done; returns the manager
    (caller shuts it down)."""
    manager = manager or ClusterUpgradeStateManager(cluster)
    for _ in range(max_cycles):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
        if fleet.all_done():
            return manager
    raise AssertionError(f"rollout did not converge: {fleet.states()}")


def rollout_policy(**kwargs):
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        **kwargs,
    )


def small_fleet(cluster, n=4):
    fleet = Fleet(cluster)
    for i in range(n):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("rev2")
    return fleet


class TestFlightRecorder:

    def test_intervals_never_overlap_property(self):
        """Randomized transition/observation interleavings (including
        out-of-order clocks and checkpoint round-trips) keep every
        timeline's intervals non-overlapping and time-ordered."""
        rng = random.Random(42)
        states = list(consts.ALL_STATES)
        for _ in range(50):
            recorder = FlightRecorder(max_intervals=16)
            node = {"metadata": {"name": "prop-node", "annotations": {}}}
            now = 1000.0
            for _step in range(rng.randrange(2, 40)):
                # clocks may stall or even step backwards (NTP)
                now += rng.choice([-0.5, 0.0, 0.1, 1.0, 30.0])
                new_state = rng.choice(states)
                if rng.random() < 0.7:
                    ckpt = recorder.transition(node, new_state, now=now)
                    if ckpt is not None:
                        node["metadata"]["annotations"][
                            util.get_timeline_annotation_key()
                        ] = ckpt
                else:
                    node["metadata"].setdefault("labels", {})[
                        STATE_KEY_OF()
                    ] = new_state
                    recorder.observe_node(node, now=now)
                if rng.random() < 0.2:
                    # crash: a fresh recorder restores from the
                    # checkpoint annotation mid-stream
                    recorder = FlightRecorder(max_intervals=16)
                    recorder.observe_node(node, now=now)
            tl = recorder.timeline("prop-node")
            intervals = tl["intervals"]
            for phase, start, end in intervals:
                assert end >= start, intervals
            for (_, _, e1), (_, s2, _) in zip(intervals, intervals[1:]):
                assert e1 <= s2, intervals
            if tl["current"] is not None and intervals:
                assert tl["currentSince"] >= intervals[-1][2] or (
                    abs(tl["currentSince"] - intervals[-1][2]) < 1e-9
                )

    def test_ring_is_bounded(self):
        recorder = FlightRecorder(capacity=4)
        for i in range(10):
            recorder.observe_node(
                {"metadata": {"name": f"n{i}"}}, bucket="", now=float(i)
            )
        assert len(recorder) == 4
        assert recorder.evicted_timelines == 6
        assert recorder.timeline("n0") is None
        assert recorder.timeline("n9") is not None

    def test_max_intervals_bounded_and_counted(self):
        recorder = FlightRecorder(max_intervals=4)
        node = {"metadata": {"name": "busy"}}
        for i in range(12):
            recorder.transition(node, consts.ALL_STATES[i % 5], now=float(i))
        tl = recorder.timeline("busy")
        assert len(tl["intervals"]) == 4
        assert tl["droppedIntervals"] == 7  # 11 closed - 4 kept

    def test_quarantine_episode_tracked(self):
        recorder = FlightRecorder()
        q_key = util.get_quarantine_annotation_key()
        node = {"metadata": {"name": "q0", "annotations": {}, "labels": {}}}
        recorder.observe_node(node, now=10.0)
        node["metadata"]["annotations"][q_key] = "slice-0"
        recorder.observe_node(node, now=20.0)
        tl = recorder.timeline("q0")
        assert tl["quarantines"] == [[20.0, None]]
        del node["metadata"]["annotations"][q_key]
        recorder.observe_node(node, now=50.0)
        tl = recorder.timeline("q0")
        assert tl["quarantines"] == [[20.0, 50.0]]

    def test_rollout_produces_full_phase_timelines(self, cluster):
        """Every lifecycle phase the machine drove appears as a closed
        interval, in order, ending in an open done phase."""
        fleet = small_fleet(cluster)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            recorder = manager.flight_recorder
            tl = recorder.timeline("n0")
            assert tl is not None
            phases = [iv[0] for iv in tl["intervals"]]
            for expected in (
                consts.UPGRADE_STATE_UPGRADE_REQUIRED,
                consts.UPGRADE_STATE_CORDON_REQUIRED,
                consts.UPGRADE_STATE_DRAIN_REQUIRED,
                consts.UPGRADE_STATE_POD_RESTART_REQUIRED,
                consts.UPGRADE_STATE_UNCORDON_REQUIRED,
            ):
                assert expected in phases, (expected, phases)
            # lifecycle order is preserved
            assert phases.index(
                consts.UPGRADE_STATE_CORDON_REQUIRED
            ) < phases.index(consts.UPGRADE_STATE_DRAIN_REQUIRED)
            assert tl["current"] == consts.UPGRADE_STATE_DONE
        finally:
            manager.shutdown()

    def test_cordon_to_done_wall_clock_samples(self, cluster):
        fleet = small_fleet(cluster, n=3)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            walls = timeline_mod.wall_clock_samples(
                manager.flight_recorder.timelines()
            )
            assert len(walls) == 3
            assert all(w >= 0 for w in walls)
        finally:
            manager.shutdown()

    def test_checkpoint_rides_the_state_label_patch(self, cluster):
        fleet = small_fleet(cluster, n=1)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            node = cluster.get("Node", "n0")
            raw = node["metadata"]["annotations"][
                util.get_timeline_annotation_key()
            ]
            payload = json.loads(raw)
            assert payload["s"] == consts.UPGRADE_STATE_DONE
            assert payload["i"], "checkpoint carries closed intervals"
        finally:
            manager.shutdown()

    def test_crash_resume_reloads_checkpoints(self, cluster):
        """A fresh manager (new process, empty recorder) rebuilt from
        the cluster restores the full per-node history the previous
        leader checkpointed into the node annotations."""
        fleet = small_fleet(cluster)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        before = manager.flight_recorder.timeline("n1")
        manager.shutdown()

        fresh = FlightRecorder()
        manager2 = ClusterUpgradeStateManager(
            cluster, flight_recorder=fresh
        )
        try:
            manager2.build_state(NAMESPACE, DRIVER_LABELS)
            after = fresh.timeline("n1")
            assert after is not None
            assert after["current"] == consts.UPGRADE_STATE_DONE
            restored = [tuple(iv) for iv in after["intervals"]]
            # the checkpoint carries the tail of the history (rounded to
            # ms); every restored phase matches the live recorder's
            live = [
                (p, round(s, 3), round(e, 3))
                for p, s, e in before["intervals"]
            ][-len(restored):]
            assert [p for p, _, _ in restored] == [p for p, _, _ in live]
            walls = timeline_mod.wall_clock_samples([after])
            assert len(walls) == 1, "wall clock survives the failover"
        finally:
            manager2.shutdown()

    def test_corrupt_checkpoint_is_ignored(self, cluster):
        fleet = small_fleet(cluster, n=1)
        cluster.patch(
            "Node",
            "n0",
            {
                "metadata": {
                    "annotations": {
                        util.get_timeline_annotation_key(): "{not json"
                    }
                }
            },
        )
        manager = ClusterUpgradeStateManager(cluster)
        try:
            manager.build_state(NAMESPACE, DRIVER_LABELS)
            tl = manager.flight_recorder.timeline("n0")
            assert tl is not None and tl["intervals"] == []
        finally:
            manager.shutdown()

    def test_disabled_recorder_records_nothing(self, cluster):
        fleet = small_fleet(cluster, n=1)
        off = FlightRecorder(enabled=False)
        manager = drive_rollout(
            cluster,
            fleet,
            rollout_policy(),
            manager=ClusterUpgradeStateManager(cluster, flight_recorder=off),
        )
        try:
            assert len(off) == 0
            node = cluster.get("Node", "n0")
            assert util.get_timeline_annotation_key() not in (
                node["metadata"].get("annotations") or {}
            )
        finally:
            manager.shutdown()

    def test_vanished_node_pruned_from_recorder(self, cluster):
        """A node deleted from the cluster (scale-down,
        repair-and-replace) must leave the recorder too — its open
        phase would otherwise grow forever into a phantom straggler
        and a permanent maxNodePhaseSeconds breach."""
        fleet = small_fleet(cluster)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            recorder = manager.flight_recorder
            assert recorder.timeline("n2") is not None
            for pod in cluster.list("Pod", namespace=NAMESPACE):
                if (pod.get("spec") or {}).get("nodeName") == "n2":
                    cluster.delete(
                        "Pod", pod["metadata"]["name"], NAMESPACE
                    )
            cluster.delete("Node", "n2")
            ds = cluster.get("DaemonSet", "gpu-driver", NAMESPACE)
            ds["status"]["desiredNumberScheduled"] -= 1
            cluster.update(ds)
            fleet.managed_nodes.discard("n2")
            manager.build_state(NAMESPACE, DRIVER_LABELS)
            assert recorder.timeline("n2") is None
            assert recorder.timeline("n0") is not None
        finally:
            manager.shutdown()


class TestAnalytics:
    def _synthetic_timelines(self, n=8, base=1000.0, drain_s=5.0):
        recorder = FlightRecorder()
        for i in range(n):
            node = {"metadata": {"name": f"n{i}"}}
            t = base + i * 10.0
            recorder.transition(
                node, consts.UPGRADE_STATE_UPGRADE_REQUIRED, now=t
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_CORDON_REQUIRED, now=t + 1
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_DRAIN_REQUIRED, now=t + 2
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED,
                now=t + 2 + drain_s,
            )
            recorder.transition(node, consts.UPGRADE_STATE_DONE, now=t + 9)
        return recorder

    def test_phase_stats_quantiles(self):
        recorder = self._synthetic_timelines()
        stats = slo_mod.phase_stats(recorder.timelines())
        drain = stats[consts.UPGRADE_STATE_DRAIN_REQUIRED]
        assert drain["count"] == 8
        assert drain["p50"] == pytest.approx(5.0)
        assert drain["p99"] == pytest.approx(5.0)
        # terminal phases are not latencies
        assert consts.UPGRADE_STATE_DONE not in stats

    def test_eta_with_confidence_band(self):
        recorder = self._synthetic_timelines(n=6, base=1000.0)
        counts = {"total": 10, "done": 6, "pending": 4, "inProgress": 0,
                  "failed": 0}
        report = slo_mod.analyze(
            recorder.timelines(), counts, now=1000.0 + 5 * 10 + 9 + 1
        )
        assert report["remaining"] == 4
        eta = report["eta"]
        assert eta is not None
        # completions arrive every 10s: 4 remaining ≈ 40s at p50 pace
        assert eta["p50Seconds"] == pytest.approx(40.0, rel=0.2)
        assert eta["p95Seconds"] >= eta["p50Seconds"]
        assert report["throughputNodesPerHour"] > 0

    def test_eta_unknown_below_two_completions(self):
        recorder = self._synthetic_timelines(n=1)
        counts = {"total": 4, "done": 1, "pending": 3, "inProgress": 0,
                  "failed": 0}
        report = slo_mod.analyze(recorder.timelines(), counts, now=2000.0)
        assert report["eta"] is None
        assert report["throughputNodesPerHour"] is None

    def test_straggler_needs_baseline_samples(self):
        recorder = FlightRecorder()
        node = {"metadata": {"name": "lone"}}
        recorder.transition(
            node, consts.UPGRADE_STATE_DRAIN_REQUIRED, now=100.0
        )
        timelines = recorder.timelines()
        stats = slo_mod.phase_stats(timelines)
        # no completed drain samples at all -> no verdict, no crash
        assert slo_mod.find_stragglers(timelines, stats, 1e9) == []

    def test_straggler_detection_on_injected_slow_drain(self, cluster):
        """A harness fleet rolls normally (millisecond drains); one
        extra node is left sitting in drain for a simulated 500 s — the
        k×p95 rule must flag exactly it."""
        fleet = small_fleet(cluster, n=6)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            recorder = manager.flight_recorder
            slow = {"metadata": {"name": "slow-drainer"}}
            now = time.time()
            recorder.transition(
                slow, consts.UPGRADE_STATE_CORDON_REQUIRED, now=now - 501
            )
            recorder.transition(
                slow, consts.UPGRADE_STATE_DRAIN_REQUIRED, now=now - 500
            )
            timelines = recorder.timelines()
            stats = slo_mod.phase_stats(timelines)
            found = slo_mod.find_stragglers(timelines, stats, now)
            assert [s["node"] for s in found] == ["slow-drainer"]
            assert found[0]["phase"] == consts.UPGRADE_STATE_DRAIN_REQUIRED
            assert found[0]["elapsedSeconds"] >= 499
        finally:
            manager.shutdown()


class TestSloSpec:
    def test_round_trip(self):
        spec = SloSpec(
            max_node_phase_seconds=600,
            drain_p99_seconds=120,
            fleet_completion_deadline_seconds=7200,
            straggler_factor=2.5,
        )
        spec.validate()
        again = SloSpec.from_dict(spec.to_dict())
        assert again == spec
        assert spec.to_dict() == {
            "maxNodePhaseSeconds": 600,
            "drainP99Seconds": 120,
            "fleetCompletionDeadlineSeconds": 7200,
            "stragglerFactor": 2.5,
        }

    def test_policy_round_trip_with_slos(self):
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            slos=SloSpec(drain_p99_seconds=300),
        )
        policy.validate()
        again = UpgradePolicySpec.from_dict(policy.to_dict())
        assert again.slos == policy.slos
        # absent block stays absent
        bare = UpgradePolicySpec.from_dict({"autoUpgrade": True})
        assert bare.slos is None
        assert "slos" not in bare.to_dict()

    def test_validation_rejects_bad_values(self):
        with pytest.raises(ValidationError):
            SloSpec(max_node_phase_seconds=-1).validate()
        with pytest.raises(ValidationError):
            SloSpec(straggler_factor=0).validate()
        with pytest.raises(ValidationError):
            UpgradePolicySpec(
                auto_upgrade=True, slos=SloSpec(drain_p99_seconds=-5)
            ).validate()


class TestSloEngine:

    def test_prior_rollout_history_does_not_rebreach(self):
        """Checkpointed intervals from LAST rollout (a 2-hour drain)
        must not re-breach — and re-page — the NEXT rollout: closed
        intervals are scoped to the current rollout's start."""
        recorder = FlightRecorder()
        now = time.time()
        old = {"metadata": {"name": "old-slow"}}
        recorder.transition(
            old, consts.UPGRADE_STATE_CORDON_REQUIRED, now=now - 20000
        )
        recorder.transition(
            old, consts.UPGRADE_STATE_DRAIN_REQUIRED, now=now - 19000
        )
        recorder.transition(old, consts.UPGRADE_STATE_DONE, now=now - 11800)
        fresh = {"metadata": {"name": "fresh"}}
        recorder.transition(
            fresh, consts.UPGRADE_STATE_UPGRADE_REQUIRED, now=now - 10
        )
        engine = slo_mod.SloEngine(recorder)

        class _State:
            node_states = {
                consts.UPGRADE_STATE_UPGRADE_REQUIRED: [None],
                consts.UPGRADE_STATE_DONE: [None],
            }

        policy = UpgradePolicySpec(
            auto_upgrade=True,
            slos=SloSpec(
                max_node_phase_seconds=1800, drain_p99_seconds=1800
            ),
        )
        report = engine.evaluate(_State, policy, now=now)
        assert report["slos"]["breaches"] == []
        # ...but a fresh engine over a FINISHED fleet (no stamp: the
        # offline post-hoc report) does judge the retained history
        class _DoneState:
            node_states = {consts.UPGRADE_STATE_DONE: [None, None]}

        posthoc = slo_mod.SloEngine(recorder).evaluate(
            _DoneState, policy, now=now
        )
        assert {
            b["slo"] for b in posthoc["slos"]["breaches"]
        } == {"maxNodePhaseSeconds", "drainP99Seconds"}

    def test_queue_wait_never_breaches_node_phase_ceiling(self):
        """A paced rollout's tail sits in upgrade-required for hours —
        that is pacing, not node latency, and must not breach
        maxNodePhaseSeconds (or be judged a straggler)."""
        recorder = FlightRecorder()
        now = time.time()
        queued = {"metadata": {"name": "tail-node"}}
        recorder.transition(
            queued, consts.UPGRADE_STATE_UPGRADE_REQUIRED, now=now - 7200
        )
        engine = slo_mod.SloEngine(recorder)

        class _State:
            node_states = {
                consts.UPGRADE_STATE_UPGRADE_REQUIRED: [None],
            }

        policy = UpgradePolicySpec(
            auto_upgrade=True, slos=SloSpec(max_node_phase_seconds=1800)
        )
        report = engine.evaluate(_State, policy, now=now)
        assert report["slos"]["breaches"] == []
        assert report["stragglers"] == []
        # ...but an ACTIVE phase of the same duration does breach
        recorder.transition(
            queued, consts.UPGRADE_STATE_DRAIN_REQUIRED, now=now - 3600
        )
        report = engine.evaluate(_State, policy, now=now)
        assert [b["slo"] for b in report["slos"]["breaches"]] == [
            "maxNodePhaseSeconds"
        ]

    def test_eta_scoped_to_current_wave(self):
        """Wave 1's completions (hours old, retained in the recorder)
        must not stretch wave 2's observed span and wreck its ETA."""
        recorder = FlightRecorder()
        now = time.time()
        # wave 1: four nodes done ~8h ago, 10s apart
        for i in range(4):
            node = {"metadata": {"name": f"w1-n{i}"}}
            recorder.transition(
                node, consts.UPGRADE_STATE_CORDON_REQUIRED,
                now=now - 30000 + i * 10,
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_DONE, now=now - 29000 + i * 10
            )
        # wave 2, in flight: two completions 10s apart, just now
        for i in range(2):
            node = {"metadata": {"name": f"w2-n{i}"}}
            recorder.transition(
                node, consts.UPGRADE_STATE_CORDON_REQUIRED,
                now=now - 40 + i * 10,
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_DONE, now=now - 20 + i * 10
            )
        pending = {"metadata": {"name": "w2-pending"}}
        recorder.transition(
            pending, consts.UPGRADE_STATE_UPGRADE_REQUIRED, now=now - 40
        )
        engine = slo_mod.SloEngine(recorder)

        class _State:
            node_states = {
                consts.UPGRADE_STATE_UPGRADE_REQUIRED: [None] * 2,
                consts.UPGRADE_STATE_DONE: [None] * 6,
            }

        report = engine.evaluate(
            _State, UpgradePolicySpec(auto_upgrade=True, slos=SloSpec()),
            now=now,
        )
        eta = report["eta"]
        # 2 remaining at a ~10s completion cadence: tens of seconds —
        # NOT the hours an unscoped 8h span would project
        assert eta is not None and eta["seconds"] < 300, eta
        assert eta["p50Seconds"] == pytest.approx(20.0, rel=0.3)

    def test_quantile_nearest_rank(self):
        assert slo_mod.quantile([1, 2], 0.5) == 1
        assert slo_mod.quantile(list(range(1, 11)), 0.5) == 5
        assert slo_mod.quantile(list(range(1, 11)), 0.95) == 10
        assert slo_mod.quantile([7.0], 0.99) == 7.0

    def test_fleet_deadline_breach_on_stalled_rollout(self):
        """A rollout past its declared deadline with work remaining
        breaches; the burn rate exceeds 1."""
        recorder = FlightRecorder()
        now = time.time()
        for i in range(3):
            node = {"metadata": {"name": f"n{i}"}}
            recorder.transition(
                node, consts.UPGRADE_STATE_UPGRADE_REQUIRED, now=now - 900
            )
            recorder.transition(
                node, consts.UPGRADE_STATE_CORDON_REQUIRED, now=now - 890
            )
        engine = slo_mod.SloEngine(recorder)

        class _State:
            node_states = {
                consts.UPGRADE_STATE_CORDON_REQUIRED: [None] * 3,
                consts.UPGRADE_STATE_DONE: [None],
            }

        policy = UpgradePolicySpec(
            auto_upgrade=True,
            slos=SloSpec(fleet_completion_deadline_seconds=600),
        )
        report = engine.evaluate(_State, policy, now=now)
        breaches = {b["slo"] for b in report["slos"]["breaches"]}
        assert "fleetCompletionDeadlineSeconds" in breaches
        assert report["slos"]["burnRates"][
            "fleetCompletionDeadlineSeconds"
        ] > 1

    def _engine_rollout(self, cluster, slos):
        fleet = small_fleet(cluster)
        manager = drive_rollout(cluster, fleet, rollout_policy(slos=slos))
        return fleet, manager

    def test_breach_detected_and_edge_counted(self, cluster):
        registry = metrics.MetricsRegistry()
        prev = metrics.set_default_registry(registry)
        try:
            _, manager = self._engine_rollout(
                cluster, SloSpec(max_node_phase_seconds=1e-6)
            )
            try:
                report = manager.slo_status()
                breaches = report["slos"]["breaches"]
                assert [b["slo"] for b in breaches] == [
                    "maxNodePhaseSeconds"
                ]
                assert report["slos"]["burnRates"][
                    "maxNodePhaseSeconds"
                ] > 1
                counter = registry.counter(
                    "slo_breaches_total", "", ("slo",)
                )
                # edge-triggered: breached on many reconciles, counted once
                assert counter.value("maxNodePhaseSeconds") == 1
                exposition = registry.render()
                assert "rollout_eta_seconds" in exposition
                assert 'slo_breached{slo="maxNodePhaseSeconds"} 1' in (
                    exposition
                )
            finally:
                manager.shutdown()
        finally:
            metrics.set_default_registry(prev)

    def test_no_breach_within_generous_targets(self, cluster):
        _, manager = self._engine_rollout(
            cluster,
            SloSpec(
                max_node_phase_seconds=3600,
                drain_p99_seconds=3600,
                fleet_completion_deadline_seconds=86400,
            ),
        )
        try:
            report = manager.slo_status()
            assert report["slos"]["breaches"] == []
            assert report["slos"]["burnRates"]["maxNodePhaseSeconds"] < 1
        finally:
            manager.shutdown()

    def test_removing_slos_block_retires_gauges_and_report(self, cluster):
        registry = metrics.MetricsRegistry()
        prev = metrics.set_default_registry(registry)
        try:
            fleet = small_fleet(cluster)
            policy = rollout_policy(slos=SloSpec(max_node_phase_seconds=1))
            manager = drive_rollout(cluster, fleet, policy)
            try:
                assert manager.slo_status() is not None
                import re

                sample = re.compile(
                    r"^k8s_operator_libs_tpu_"
                    r"(rollout_eta_seconds|rollout_stragglers|"
                    r"slo_burn_rate|slo_breached|slo_phase_seconds)[ {]",
                    re.M,
                )
                assert sample.search(registry.render())
                # block removed: next pass retires report + REMOVES the
                # gauge series (a retired eta stuck at -1 would keep
                # matching the ETA-stalled alert forever)
                state = manager.build_state(NAMESPACE, DRIVER_LABELS)
                manager.apply_state(state, rollout_policy())
                assert manager.slo_status() is None
                assert not sample.search(registry.render())
            finally:
                manager.shutdown()
        finally:
            metrics.set_default_registry(prev)


class TestRolloutStatusSloSurface:
    def test_summary_and_render_lead_with_slo_lines(self, cluster):
        fleet = small_fleet(cluster)
        manager = drive_rollout(
            cluster,
            fleet,
            rollout_policy(slos=SloSpec(max_node_phase_seconds=1e-6)),
        )
        try:
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            status = RolloutStatus.from_cluster_state(
                state, slo_report=manager.slo_status()
            )
            rendered = status.render()
            assert "rollout SLOs:" in rendered
            assert "SLO BREACH [maxNodePhaseSeconds]" in rendered
            assert "SLO BREACH" in status.summary()
            assert status.to_dict()["slo"]["slos"]["breaches"]
        finally:
            manager.shutdown()

    def test_no_slo_report_renders_unchanged(self, cluster):
        fleet = small_fleet(cluster)
        manager = drive_rollout(cluster, fleet, rollout_policy())
        try:
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            status = RolloutStatus.from_cluster_state(state)
            assert "rollout SLOs:" not in status.render()
            assert "slo" not in status.to_dict()
        finally:
            manager.shutdown()


class TestOpsServerSurfaces:
    def _get(self, url):
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    def _head(self, url):
        req = urllib.request.Request(url, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def test_debug_slo_and_timeline_endpoints(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        recorder = FlightRecorder()
        recorder.observe_node(
            {"metadata": {"name": "n0"}}, bucket="upgrade-done", now=1.0
        )
        report = {"remaining": 0, "eta": {"seconds": 0.0}}
        srv = OpsServer(
            port=0,
            slo_source=lambda: report,
            timeline_source=recorder.snapshot,
        ).start()
        try:
            status, body = self._get(srv.url + "/debug/slo")
            assert status == 200
            payload = json.loads(body)
            assert payload["configured"] and payload["report"] == report
            status, body = self._get(srv.url + "/debug/timeline")
            assert status == 200
            assert [
                t["node"] for t in json.loads(body)["timelines"]
            ] == ["n0"]
            status, body = self._get(
                srv.url + "/debug/timeline?node=n0"
            )
            assert status == 200 and json.loads(body)["nodes"] == 1
            status, _ = self._get(srv.url + "/debug/timeline?node=ghost")
            assert status == 404
        finally:
            srv.stop()

    def test_debug_endpoints_404_when_unconfigured(self):
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        try:
            assert self._get(srv.url + "/debug/slo")[0] == 404
            assert self._get(srv.url + "/debug/timeline")[0] == 404
        finally:
            srv.stop()

    def test_debug_index_lists_registered_endpoints(self):
        """Satellite: GET /debug answers a JSON endpoint index instead
        of 404 — and only lists what is actually wired."""
        from k8s_operator_libs_tpu_torch.controller import OpsServer

        srv = OpsServer(port=0).start()
        try:
            status, body = self._get(srv.url + "/debug")
            assert status == 200
            assert json.loads(body)["endpoints"] == [
                "/debug/traces",
                "/debug/profile",
            ]
        finally:
            srv.stop()
        srv = OpsServer(
            port=0,
            remediation_source=lambda: None,
            slo_source=lambda: None,
            timeline_source=lambda: {},
        ).start()
        try:
            for path in ("/debug", "/debug/"):
                status, body = self._get(srv.url + path)
                assert status == 200
                assert json.loads(body)["endpoints"] == [
                    "/debug/traces",
                    "/debug/profile",
                    "/debug/remediation",
                    "/debug/slo",
                    "/debug/timeline",
                ]
            # HEAD included, alongside the existing HEAD regression suite
            status, body = self._head(srv.url + "/debug")
            assert status == 200 and body == b""
            status, body = self._head(srv.url + "/debug/slo")
            assert status == 200 and body == b""
            status, body = self._head(srv.url + "/debug/timeline?node=x")
            assert status == 404 and body == b""
        finally:
            srv.stop()
