"""The port's maintenance windows and admission pacing
(k8s_operator_libs_tpu_torch/upgrade/schedule.py) against the JAX
package's upgrade/schedule.py.

* ``TestWindowMath`` and ``TestNextOpenMath`` of ``tests/test_schedule.py``,
  as cases of the same names, run on the port;
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
from k8s_operator_libs_tpu_torch.api import MaintenanceWindowSpec, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.api.upgrade_spec import ValidationError
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events
from k8s_operator_libs_tpu_torch.upgrade import schedule, util

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
