"""The port's maintenance windows and admission pacing
(k8s_operator_libs_tpu_torch/upgrade/schedule.py) against the JAX
package's upgrade/schedule.py.

* every class of ``tests/test_schedule.py``, as cases of the same names,
  runs on the port: the window and next-open math, and the admission
  gates through the port's ``ClusterUpgradeStateManager`` (windows,
  pacing, the canary and its soak, requestor-mode housekeeping);
* differential tests: seeded windows and instants, and seeded fleets of
  admission stamps, go through both modules' functions, which must agree;
  :func:`stamp_admission` must write the same annotations and emit the
  same decision event, after :func:`test_torch_vocab.to_port_vocab`.
"""

import time
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from k8s_operator_libs_tpu.api import MaintenanceWindowSpec as JaxWindow
from k8s_operator_libs_tpu.obs import events as jevents
from k8s_operator_libs_tpu.upgrade import schedule as jschedule
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, MaintenanceWindowSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.api.upgrade_spec import ValidationError
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events
from k8s_operator_libs_tpu_torch.upgrade import consts, schedule, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


def utc(*args):
    return datetime(*args, tzinfo=timezone.utc)


class TestWindowMath:
    def test_inside_and_outside(self):
        spec = MaintenanceWindowSpec(start="22:00", duration_minutes=240)
        assert schedule.window_open(spec, utc(2026, 7, 29, 23, 30))
        assert schedule.window_open(spec, utc(2026, 7, 29, 22, 0))
        assert not schedule.window_open(spec, utc(2026, 7, 29, 21, 59))
        assert not schedule.window_open(spec, utc(2026, 7, 30, 2, 0))

    def test_midnight_crossing(self):
        spec = MaintenanceWindowSpec(start="22:00", duration_minutes=360)
        # 03:00 next day is inside yesterday's window
        assert schedule.window_open(spec, utc(2026, 7, 30, 3, 0))
        assert not schedule.window_open(spec, utc(2026, 7, 30, 4, 0))

    def test_days_filter_applies_to_window_start_day(self):
        # Fri 22:00 + 6h: Sat 03:00 is covered (window STARTED Friday)
        spec = MaintenanceWindowSpec(
            start="22:00", duration_minutes=360, days=("Fri",)
        )
        assert schedule.window_open(spec, utc(2026, 7, 31, 23, 0))  # Fri
        assert schedule.window_open(spec, utc(2026, 8, 1, 3, 0))  # Sat 03:00
        assert not schedule.window_open(spec, utc(2026, 7, 30, 23, 0))  # Thu

    def test_validation(self):
        MaintenanceWindowSpec(start="07:30", duration_minutes=60).validate()
        with pytest.raises(ValidationError):
            MaintenanceWindowSpec(start="25:00").validate()
        with pytest.raises(ValidationError):
            MaintenanceWindowSpec(start="nope").validate()
        with pytest.raises(ValidationError):
            MaintenanceWindowSpec(duration_minutes=0).validate()
        with pytest.raises(ValidationError):
            MaintenanceWindowSpec(days=("Funday",)).validate()

    def test_round_trip(self):
        spec = MaintenanceWindowSpec(
            start="22:00", duration_minutes=240, days=("Sat", "Sun")
        )
        assert MaintenanceWindowSpec.from_dict(spec.to_dict()) == spec
        policy = UpgradePolicySpec(
            auto_upgrade=True, maintenance_window=spec, max_nodes_per_hour=7
        )
        d = policy.to_dict()
        assert d["maintenanceWindow"]["days"] == ["Sat", "Sun"]
        assert d["maxNodesPerHour"] == 7
        back = UpgradePolicySpec.from_dict(d)
        assert back.maintenance_window == spec
        assert back.max_nodes_per_hour == 7


class TestNextOpenMath:
    """Helpers behind RolloutStatus gate explanations."""

    def test_next_window_open_when_already_open_is_now(self):
        spec = MaintenanceWindowSpec(start="22:00", duration_minutes=240)
        now = utc(2026, 7, 29, 23, 0)
        assert schedule.next_window_open(spec, now) == now

    def test_next_window_open_later_today(self):
        spec = MaintenanceWindowSpec(start="22:00", duration_minutes=60)
        assert schedule.next_window_open(spec, utc(2026, 7, 29, 12, 0)) == utc(
            2026, 7, 29, 22, 0
        )

    def test_next_window_open_respects_days(self):
        # Wed 2026-07-29 -> Fri-only window opens Fri 2026-07-31
        spec = MaintenanceWindowSpec(
            start="06:00", duration_minutes=60, days=("Fri",)
        )
        assert schedule.next_window_open(spec, utc(2026, 7, 29, 12, 0)) == utc(
            2026, 7, 31, 6, 0
        )

    def test_next_pacing_slot_math(self, cluster):
        key = util.get_admitted_at_annotation_key()
        now = time.time()
        nodes = []
        for i, age in enumerate((100.0, 900.0, 1800.0)):
            nodes.append(
                {
                    "kind": "Node",
                    "metadata": {
                        "name": f"n{i}",
                        "annotations": {key: repr(now - age)},
                    },
                }
            )
        # limit 2, 3 in-window stamps: slot frees when the 2nd-oldest
        # (age 900) ages out
        at = schedule.next_pacing_slot_at(nodes, 2, now_ts=now)
        assert at is not None and abs(at - (now - 900.0 + 3600.0)) < 1e-6
        # limit 3: a slot frees when the oldest... no: budget==0 exactly;
        # next slot when the 3rd-newest (oldest, age 1800) ages out
        at3 = schedule.next_pacing_slot_at(nodes, 3, now_ts=now)
        assert at3 is not None and abs(at3 - (now - 1800.0 + 3600.0)) < 1e-6
        # limit 4: budget not exhausted -> None
        assert schedule.next_pacing_slot_at(nodes, 4, now_ts=now) is None
        # bypass stamps are pacing-exempt
        for n in nodes:
            n["metadata"]["annotations"][
                util.get_admitted_bypass_annotation_key()
            ] = "true"
        assert schedule.next_pacing_slot_at(nodes, 1, now_ts=now) is None


DAYS = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")


def _reconcile(manager, fleet, policy, cycles=1):
    for _ in range(cycles):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10)
        manager.pod_manager.wait_idle(10)
        fleet.reconcile_daemonset()


def _make_manager(cluster):
    return ClusterUpgradeStateManager(
        cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
    )


class TestWindowGatesAdmission:
    def _fleet(self, cluster, n=2):
        fleet = Fleet(cluster)
        for i in range(n):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        return fleet

    def test_closed_window_blocks_open_window_admits(
        self, cluster, monkeypatch
    ):
        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            maintenance_window=MaintenanceWindowSpec(
                start="22:00", duration_minutes=60
            ),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        monkeypatch.setattr(
            schedule, "_now_utc", lambda: utc(2026, 7, 29, 12, 0)
        )
        _reconcile(manager, fleet, policy, cycles=3)
        assert set(fleet.states().values()) == {
            consts.UPGRADE_STATE_UPGRADE_REQUIRED
        }
        monkeypatch.setattr(
            schedule, "_now_utc", lambda: utc(2026, 7, 29, 22, 30)
        )
        for _ in range(15):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_mid_flight_node_finishes_outside_window(
        self, cluster, monkeypatch
    ):
        fleet = self._fleet(cluster, n=1)
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            maintenance_window=MaintenanceWindowSpec(
                start="22:00", duration_minutes=60
            ),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        # admitted inside the window...
        monkeypatch.setattr(
            schedule, "_now_utc", lambda: utc(2026, 7, 29, 22, 59)
        )
        _reconcile(manager, fleet, policy, cycles=3)
        assert fleet.node_state("n0") not in (
            "",
            consts.UPGRADE_STATE_UPGRADE_REQUIRED,
        )
        # ...window closes mid-flight: the node still runs to done
        monkeypatch.setattr(
            schedule, "_now_utc", lambda: utc(2026, 7, 29, 23, 30)
        )
        for _ in range(15):
            _reconcile(manager, fleet, policy)
            if fleet.node_state("n0") == consts.UPGRADE_STATE_DONE:
                break
        assert fleet.node_state("n0") == consts.UPGRADE_STATE_DONE


class TestPacing:
    def test_hourly_budget_counts_admitted_at_stamps(self, cluster):
        fleet = Fleet(cluster)
        for i in range(4):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            max_nodes_per_hour=2,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        admitted = [
            n
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(admitted) == 2  # budget caps the wave
        # stamps recorded
        key = util.get_admitted_at_annotation_key()
        for name in admitted:
            node = cluster.get("Node", name)
            assert key in node["metadata"]["annotations"]
        # even many cycles later (same hour) nothing more is admitted
        _reconcile(manager, fleet, policy, cycles=10)
        still_pending = [
            n
            for n, s in fleet.states().items()
            if s == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(still_pending) == 2

    def test_budget_frees_after_window_elapses(self, cluster):
        fleet = Fleet(cluster)
        for i in range(2):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            max_nodes_per_hour=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        # one admitted; age its stamp past the trailing hour
        key = util.get_admitted_at_annotation_key()
        for node in cluster.list("Node"):
            raw = node["metadata"]["annotations"].get(key)
            if raw:
                cluster.patch(
                    "Node",
                    node["metadata"]["name"],
                    {
                        "metadata": {
                            "annotations": {key: repr(time.time() - 3700)}
                        }
                    },
                )
        for _ in range(15):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_slice_mode_domain_must_fit_budget(self, cluster):
        SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
        fleet = Fleet(cluster)
        for h in range(4):
            fleet.add_node(
                f"s0-h{h}", pod_hash="rev1", labels={SLICE_KEY: "s0"}
            )
        fleet.add_node("solo", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            max_nodes_per_hour=2,  # the 4-host slice does NOT fit
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        states = fleet.states()
        # the slice is deferred (atomic, larger than the budget); the
        # singleton fits and goes
        assert states["solo"] != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        assert all(
            states[f"s0-h{h}"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED
            for h in range(4)
        )

    def test_multi_day_window_stays_open(self):
        """Regression: a 3-day weekend window starting Saturday must still
        be open on Monday morning."""
        spec = MaintenanceWindowSpec(
            start="00:00", duration_minutes=3 * 1440, days=("Sat",)
        )
        assert schedule.window_open(spec, utc(2026, 8, 3, 10, 0))  # Mon
        assert not schedule.window_open(spec, utc(2026, 8, 4, 10, 0))  # Tue

    def test_unsatisfiable_domain_warns(self, cluster, caplog):
        """A domain bigger than maxNodesPerHour can never be admitted —
        the scheduler must say so instead of deferring silently."""
        import logging

        SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
        fleet = Fleet(cluster)
        for h in range(4):
            fleet.add_node(
                f"s0-h{h}", pod_hash="rev1", labels={SLICE_KEY: "s0"}
            )
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            max_nodes_per_hour=2,
        )
        with caplog.at_level(
            logging.WARNING, logger="k8s_operator_libs_tpu_torch.upgrade.upgrade_inplace"
        ):
            _reconcile(manager, fleet, policy, cycles=2)
        assert any("can never be admitted" in r.message for r in caplog.records)

    def test_bypass_admissions_do_not_burn_pacing_budget(self, cluster):
        """A manually cordoned node admitted via the throttle bypass is
        stamped (so the canary census can see it participating) but
        carries the pacing-exempt marker — it must not starve the next
        hour's budget for regular admissions."""
        from k8s_operator_libs_tpu_torch.upgrade import schedule

        fleet = Fleet(cluster)
        fleet.add_node("cordoned", pod_hash="rev1", unschedulable=True)
        fleet.add_node("regular", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=1,
            max_unavailable=IntOrString(1),
            max_nodes_per_hour=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        key = util.get_admitted_at_annotation_key()
        bypass_key = util.get_admitted_bypass_annotation_key()
        cordoned = cluster.get("Node", "cordoned")
        annotations = cordoned["metadata"].get("annotations") or {}
        # the bypass admission IS stamped (canary census visibility) ...
        assert key in annotations
        assert annotations.get(bypass_key) == "true"
        # ... but pacing does not count it: the full hourly budget remains
        nodes = cluster.list("Node")
        assert (
            schedule.count_recent_admissions(
                n for n in nodes
                if (n["metadata"].get("annotations") or {}).get(bypass_key)
            )
            == 0
        )


class TestCanary:
    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]

    def _fleet(self, cluster, slices=3, hosts=2):
        fleet = Fleet(cluster)
        for s in range(slices):
            for h in range(hosts):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def _policy(self, **kw):
        base = dict(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        base.update(kw)
        return UpgradePolicySpec(**base)

    def test_only_canary_admitted_then_fleet_opens(self, cluster):
        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy()
        _reconcile(manager, fleet, policy, cycles=2)
        started_domains = {
            n.split("-")[0]
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        }
        assert len(started_domains) == 1  # exactly the canary
        # run to completion: once the canary is done the rest follow
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_failed_canary_freezes_rollout(self, cluster):
        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy()
        _reconcile(manager, fleet, policy, cycles=2)
        canary_nodes = [
            n
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        # force the canary domain into upgrade-failed
        for name in canary_nodes:
            cluster.patch(
                "Node",
                name,
                {
                    "metadata": {
                        "labels": {
                            util.get_upgrade_state_label_key(): (
                                consts.UPGRADE_STATE_FAILED
                            )
                        }
                    }
                },
            )
        _reconcile(manager, fleet, policy, cycles=5)
        # nothing else was admitted while the canary is failed
        others = {
            n: s
            for n, s in fleet.states().items()
            if n not in canary_nodes
        }
        assert set(others.values()) == {consts.UPGRADE_STATE_UPGRADE_REQUIRED}

    def test_second_rollout_generation_restages_canary(self, cluster):
        """Regression: admitted-at stamps from a completed rollout must
        not satisfy (or wedge) the NEXT rollout's canary stage."""
        fleet = self._fleet(cluster, slices=2)
        manager = _make_manager(cluster)
        policy = self._policy()
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}
        # next generation
        fleet.publish_new_revision("rev3")
        _reconcile(manager, fleet, policy, cycles=3)
        started_domains = {
            n.split("-")[0]
            for n, s in fleet.states().items()
            if s
            not in (
                consts.UPGRADE_STATE_UPGRADE_REQUIRED,
                consts.UPGRADE_STATE_DONE,
            )
        }
        # canary staging applies afresh: at most one domain in flight
        assert len(started_domains) <= 1
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_node_mode_canary_via_singletons(self, cluster):
        fleet = Fleet(cluster)
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        started = [
            n
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(started) == 1
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_node_mode_canary_on_slice_labeled_nodes(self, cluster):
        """Regression: node-mode canary must count per NODE even when the
        nodes carry slice labels (census unit must match the admission
        unit or the rollout wedges after the first canary node)."""
        fleet = Fleet(cluster)
        for s in range(2):
            for h in range(2):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=False,  # node-granular admissions
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        for _ in range(40):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_pacing_record_survives_generations(self, cluster):
        """Regression: a new rollout generation must NOT erase admitted-at
        stamps — back-to-back generations would otherwise double the
        hourly disruption cap."""
        fleet = Fleet(cluster)
        for i in range(2):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            max_nodes_per_hour=2,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        for _ in range(15):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}
        # generation 2 within the same hour: budget already spent
        fleet.publish_new_revision("rev3")
        _reconcile(manager, fleet, policy, cycles=5)
        assert set(fleet.states().values()) == {
            consts.UPGRADE_STATE_UPGRADE_REQUIRED
        }, "hourly budget must still be exhausted from generation 1"


class TestCanaryBypassExposure:
    """The canary budget caps VERSION exposure, so throttle bypasses
    (manually cordoned nodes) consume and respect it too — blast radius
    can never exceed canaryDomains (ADVICE r1 finding)."""

    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]

    def _fleet(self, cluster, slices=3, hosts=2):
        fleet = Fleet(cluster)
        for s in range(slices):
            for h in range(hosts):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def _policy(self):
        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )

    def test_cordoned_domain_bypass_is_the_canary(self, cluster):
        """A manually cordoned domain admitted via the throttle bypass
        must count as THE canary: no second domain may start until it
        succeeds."""
        fleet = self._fleet(cluster)
        for h in range(2):
            cluster.patch(
                "Node", f"s0-h{h}", {"spec": {"unschedulable": True}}
            )
        manager = _make_manager(cluster)
        policy = self._policy()
        _reconcile(manager, fleet, policy, cycles=2)
        started = {
            n.split("-")[0]
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        }
        assert started == {"s0"}, (
            "bypass admission must consume the canary budget; "
            f"started={started}"
        )
        # and the rollout still completes once the canary succeeds
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_node_mode_cordoned_bypass_consumes_canary(self, cluster):
        """Node-granular variant: two cordoned nodes, canary=1 — only one
        may start."""
        fleet = Fleet(cluster)
        for i in range(3):
            fleet.add_node(f"n{i}", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        for i in range(2):
            cluster.patch("Node", f"n{i}", {"spec": {"unschedulable": True}})
        manager = _make_manager(cluster)
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        _reconcile(manager, fleet, policy, cycles=2)
        started = [
            n
            for n, s in fleet.states().items()
            if s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
        ]
        assert len(started) == 1


class TestRequestorWindowHousekeeping:
    """A closed maintenance window gates only the NodeMaintenance
    handoff; the upgrade-requested annotation cleanup still runs
    (ADVICE r1 finding — reference performs it unconditionally in
    ProcessUpgradeRequiredNodes)."""

    def test_annotation_cleared_while_window_closed(
        self, cluster, monkeypatch
    ):
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_requestor import (
            RequestorNodeStateManager,
            RequestorOptions,
        )

        fleet = Fleet(cluster)
        req_key = util.get_upgrade_requested_annotation_key()
        fleet.add_node("n0", pod_hash="rev1", annotations={req_key: "true"})
        fleet.publish_new_revision("rev2")
        manager = _make_manager(cluster)
        opts = RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="nvidia-operator",
            requestor_namespace="default",
        )
        manager.with_requestor(
            RequestorNodeStateManager(manager.common, opts), enabled=True
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            maintenance_window=MaintenanceWindowSpec(
                start="22:00", duration_minutes=60
            ),
        )
        monkeypatch.setattr(
            schedule, "_now_utc", lambda: utc(2026, 7, 29, 12, 0)
        )
        _reconcile(manager, fleet, policy, cycles=3)
        node = cluster.get("Node", "n0")
        annotations = node["metadata"].get("annotations") or {}
        # annotation housekeeping ran despite the closed window ...
        assert req_key not in annotations
        # ... but the handoff itself is gated: no CR, node still pending
        assert cluster.list("NodeMaintenance", namespace=None) == []
        assert (
            fleet.node_state("n0") == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )


class TestCanarySoak:
    """canarySoakSeconds: after the canary domains reach done, the fleet
    stays closed for a bake window (latent faults surface late); the
    done-at stamp rides the same patch as the done label."""

    SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]

    def _fleet(self, cluster, slices=3, hosts=2):
        fleet = Fleet(cluster)
        for s in range(slices):
            for h in range(hosts):
                fleet.add_node(
                    f"s{s}-h{h}",
                    pod_hash="rev1",
                    labels={self.SLICE_KEY: f"s{s}"},
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def _policy(self, **kw):
        base = dict(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            canary_domains=1,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        base.update(kw)
        return UpgradePolicySpec(**base)

    def _run_canary_to_done(self, cluster, fleet, manager, policy):
        for _ in range(20):
            _reconcile(manager, fleet, policy)
            done_domains = {
                n.split("-")[0]
                for n, s in fleet.states().items()
                if s == consts.UPGRADE_STATE_DONE
            }
            if done_domains:
                return done_domains
        raise AssertionError(f"canary never finished: {fleet.states()}")

    def test_done_at_stamp_written_with_done_label(self, cluster):
        fleet = self._fleet(cluster, slices=1)
        manager = _make_manager(cluster)
        policy = self._policy(canary_domains=0)
        for _ in range(20):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        key = util.get_done_at_annotation_key()
        for node in cluster.list("Node"):
            raw = (node["metadata"].get("annotations") or {}).get(key)
            assert raw, f"missing done-at on {node['metadata']['name']}"
            assert float(raw) > 0

    def test_fleet_held_closed_during_bake_then_opens(
        self, cluster, monkeypatch
    ):
        # A huge soak window avoids real-clock races on slow CI hosts;
        # the "window elapses" half advances the clock by monkeypatching
        # time.time (canary_census reads it), not by sleeping.
        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy(canary_soak_seconds=3600.0)
        self._run_canary_to_done(cluster, fleet, manager, policy)
        # the canary is done — but the fleet must NOT open while baking
        for _ in range(3):
            _reconcile(manager, fleet, policy)
        non_canary_started = {
            n
            for n, s in fleet.states().items()
            if s
            not in (
                consts.UPGRADE_STATE_UPGRADE_REQUIRED,
                consts.UPGRADE_STATE_DONE,
            )
        }
        assert non_canary_started == set(), (
            f"fleet opened during bake: {fleet.states()}"
        )
        real_time = time.time
        monkeypatch.setattr(time, "time", lambda: real_time() + 3601.0)
        for _ in range(30):
            _reconcile(manager, fleet, policy)
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_census_soak_math_with_injected_clock(self, cluster):
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_inplace import canary_census

        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy(canary_soak_seconds=3600.0)
        self._run_canary_to_done(cluster, fleet, manager, policy)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        census_now = canary_census(state, policy)
        assert not census_now.passed
        assert census_now.soaking and census_now.soak_until is not None
        # an hour later the same snapshot passes
        census_later = canary_census(
            state, policy, now=time.time() + 3601.0
        )
        assert census_later.passed
        assert not census_later.soaking

    def test_status_gate_explains_baking(self, cluster):
        from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus

        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy(canary_soak_seconds=3600.0)
        self._run_canary_to_done(cluster, fleet, manager, policy)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        status = RolloutStatus.from_cluster_state(state, policy=policy)
        canary_gate = next(g for g in status.gates if g.gate == "canary")
        assert canary_gate.blocking
        assert "baking" in canary_gate.reason
        assert "opensAt" in canary_gate.detail

    def test_missing_stamp_degrades_open(self, cluster):
        """Nodes done before the stamp existed count as already soaked —
        the gate degrades open instead of wedging forever."""
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_inplace import canary_census

        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy(canary_soak_seconds=3600.0)
        self._run_canary_to_done(cluster, fleet, manager, policy)
        # strip the stamps (simulating an older-version rollout)
        key = util.get_done_at_annotation_key()
        for node in cluster.list("Node"):
            annotations = node["metadata"].get("annotations") or {}
            if key in annotations:
                del annotations[key]
                cluster.update(node)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        census = canary_census(state, policy)
        assert census.passed

    def test_missing_stamp_degrade_open_warns_once(self, cluster, caplog):
        """ADVICE r3: the degrade-open must be VISIBLE — one warning per
        unit the first time an unstamped done unit skips the bake
        window, and silence on repeat censuses."""
        import logging as _logging

        from k8s_operator_libs_tpu_torch.upgrade import upgrade_inplace
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_inplace import canary_census

        fleet = self._fleet(cluster)
        manager = _make_manager(cluster)
        policy = self._policy(canary_soak_seconds=3600.0)
        self._run_canary_to_done(cluster, fleet, manager, policy)
        key = util.get_done_at_annotation_key()
        for node in cluster.list("Node"):
            annotations = node["metadata"].get("annotations") or {}
            if key in annotations:
                del annotations[key]
                cluster.update(node)
        upgrade_inplace._soak_skip_logged.clear()
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        with caplog.at_level(_logging.WARNING, logger=upgrade_inplace.__name__):
            canary_census(state, policy)
            first = [
                r for r in caplog.records if "already soaked" in r.message
            ]
            assert len(first) >= 1
            caplog.clear()
            canary_census(state, policy)  # repeat census: quiet
            assert not [
                r for r in caplog.records if "already soaked" in r.message
            ]

    def test_policy_round_trip_and_validation(self):
        from k8s_operator_libs_tpu_torch.api import ValidationError
        import pytest as _pytest

        p = self._policy(canary_soak_seconds=120.5)
        d = p.to_dict()
        assert d["canarySoakSeconds"] == 120.5
        assert UpgradePolicySpec.from_dict(d).canary_soak_seconds == 120.5
        with _pytest.raises(ValidationError):
            self._policy(canary_soak_seconds=-1).validate()


def _windows(seed: int, n: int = 40):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        start = f"{rng.randint(24):02d}:{(0, 15, 30, 45)[rng.randint(4)]:02d}"
        duration = int((30, 60, 240, 360, 720, 1439)[rng.randint(6)])
        days = tuple(sorted({DAYS[i] for i in rng.randint(7, size=rng.randint(0, 4))}, key=DAYS.index))
        yield dict(start=start, duration_minutes=duration, days=days)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_math_agrees_with_the_jax_module(seed):
    rng = np.random.RandomState(100 + seed)
    base = utc(2026, 7, 27)  # a Monday
    for fields in _windows(seed):
        ours, theirs = MaintenanceWindowSpec(**fields), JaxWindow(**fields)
        assert ours.to_dict() == theirs.to_dict()
        for _ in range(12):
            now = base + timedelta(minutes=int(rng.randint(0, 14 * 24 * 60)))
            assert schedule.window_open(ours, now) == jschedule.window_open(theirs, now), (fields, now)
            assert schedule.next_window_open(ours, now) == jschedule.next_window_open(theirs, now)


class _Provider:
    """Records the annotation writes of stamp_admission, and applies them."""

    def __init__(self):
        self.writes = []

    def change_node_upgrade_annotation(self, node, key, value):
        self.writes.append((node["metadata"]["name"], key, value))
        annotations = node["metadata"].setdefault("annotations", {})
        if value == "null":
            annotations.pop(key, None)
        else:
            annotations[key] = value


class _Policy:
    def __init__(self, limit):
        self.max_nodes_per_hour = limit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pacing_agrees_with_the_jax_module(seed):
    rng = np.random.RandomState(seed)
    now = 1_780_000_000.0
    sides = []
    for mod, ev, ut, tr in ((jschedule, jevents, jutil, lambda o: o), (schedule, events, util, to_port_vocab)):
        sides.append((mod, ev, ut, tr, _Provider(), [
            {"kind": "Node", "metadata": {"name": f"n{i:02d}", "annotations": {}}} for i in range(32)
        ]))
    for step in range(60):
        i = int(rng.randint(32))
        ts = now - float(rng.randint(0, 7200))
        bypass = bool(rng.randint(4) == 0)
        for mod, _ev, _ut, _tr, provider, nodes in sides:
            mod.stamp_admission(provider, nodes[i], now_ts=ts, bypass=bypass)
        (jmod, _, _, _, jprov, jnodes), (mod, _, _, _, prov, nodes) = sides
        assert prov.writes == to_port_vocab(jprov.writes)
        assert nodes == to_port_vocab(jnodes)
        for window in (600.0, 3600.0):
            assert mod.count_recent_admissions(nodes, now, window) == jmod.count_recent_admissions(
                jnodes, now, window
            )
        for limit in (0, 1, 3, 8, 40):
            assert mod.pacing_budget(_Policy(limit), nodes) == jmod.pacing_budget(_Policy(limit), jnodes)
            assert mod.next_pacing_slot_at(nodes, limit, now_ts=now) == jmod.next_pacing_slot_at(
                jnodes, limit, now_ts=now
            )
    # wall-clock fields masked; repeats of one decision fold into a count
    strip = lambda entries: [  # noqa: E731
        {k: v for k, v in e.items() if k != "ts" and not k.endswith("Timestamp")} for e in entries
    ]
    theirs = strip(jevents.default_log().export_stream())
    ours = strip(events.default_log().export_stream())
    assert sum(e["count"] for e in ours) == 60 and ours == to_port_vocab(theirs)


def test_validation_errors_name_the_same_field():
    for fields in (dict(start="25:00"), dict(start="nope"), dict(duration_minutes=0), dict(days=("Funday",))):
        with pytest.raises(ValidationError) as ours:
            MaintenanceWindowSpec(**fields).validate()
        with pytest.raises(Exception) as theirs:
            JaxWindow(**fields).validate()
        assert str(ours.value) == str(theirs.value)
