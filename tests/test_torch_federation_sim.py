"""The classes of ``tests/test_federation.py`` that waited for ``upgrade.chaos.SimFleet``, as
cases of the same names on the port (``k8s_operator_libs_tpu_torch``)
in its GPU-fleet vocabulary: ``TestCoordinator``, ``TestOfflineParity``, ``TestFederationRoute``."""

import json
import random
import urllib.error
import urllib.request

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    FederationCellSpec,
    FederationPolicySpec,
    GlobalBreakerSpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache
from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
from k8s_operator_libs_tpu_torch.controller.ops_server import OpsServer
from k8s_operator_libs_tpu_torch.federation import (
    Cell,
    FederationCoordinator,
    explain_cell,
    federation_report_from_clusters,
)
from k8s_operator_libs_tpu_torch.federation.coordinator import (
    cell_target,
    render_cell_explanation,
    render_federation_report,
)
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade.chaos import SimFleet
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import (
    ClusterUpgradeStateManager,
)
from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


# ----------------------------------------------------------- merge property
def _populate_cell(cluster, cell_name: str, rng: random.Random):
    """Simulate 1-3 operator PROCESSES in one cell, each with its own
    log (sequences restart per process) and a sink that must adopt the
    previous process's persisted Events, under a per-process clock skew
    of up to ±5 minutes.  Returns (live_logs, expected decision keys)."""
    types = [
        (events_mod.EVENT_NODE_ADMITTED, "fresh"),
        (events_mod.EVENT_NODE_DEFERRED, "budget"),
        (events_mod.EVENT_NODE_DEFERRED, "pacing"),
        (events_mod.EVENT_NODE_DRAINED, "ok"),
        (events_mod.EVENT_NODE_UPGRADE_FAILED, "attempt-failed"),
        (events_mod.EVENT_BREAKER_TRIPPED, "failure-budget"),
    ]
    base = 1_700_000_000.0 + rng.uniform(0, 60)
    logs = []
    expected = set()
    for process in range(rng.randint(1, 3)):
        log = events_mod.DecisionEventLog()
        sink = events_mod.ClusterDecisionEventSink(cluster)
        skew = rng.uniform(-300, 300)  # this process's clock error
        for i in range(rng.randint(3, 12)):
            type_, reason = rng.choice(types)
            target = f"{cell_name}-n{rng.randint(0, 4)}"
            log.emit(
                type_,
                reason,
                target,
                f"{cell_name} p{process}",
                now=base + skew + process * 30 + i,
            )
            expected.add((cell_name, type_, reason, target))
            if rng.random() < 0.4:
                sink.pump(log)  # duplicate-adoption pressure: partial
                # pumps mean later pumps re-serve advanced counts
        sink.pump(log)
        logs.append(log)
    return logs, expected


# ------------------------------------------------------------- coordinator
def _fed_policy(**overrides) -> UpgradePolicySpec:
    kwargs = dict(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        remediation=RemediationSpec(
            failure_threshold=0.95,
            min_attempted=1000,
            auto_rollback=True,
            backoff_seconds=0.0,
        ),
    )
    kwargs.update(overrides)
    return UpgradePolicySpec(**kwargs)


class _Rig:
    def __init__(self, name: str, n: int = 3):
        self.name = name
        self.store = InMemoryCluster()
        self.fleet = SimFleet(self.store, n)
        self.log = events_mod.DecisionEventLog()
        self.policy = _fed_policy()
        self.manager = ClusterUpgradeStateManager(
            self.store,
            cache=InformerCache(self.store, lag_seconds=0.0),
            cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=events_mod.ClusterDecisionEventSink(
                self.store, namespace="default"
            ),
        )
        self.cell = Cell(
            name=name,
            cluster=self.store,
            namespace=SimFleet.NAMESPACE,
            selector=dict(SimFleet.LABELS),
            manager=self.manager,
            policy=self.policy,
            log=self.log,
        )

    def reconcile(self):
        prev = events_mod.set_default_log(self.log)
        try:
            state = self.manager.build_state(
                SimFleet.NAMESPACE, SimFleet.LABELS
            )
            self.manager.apply_state(state, self.policy)
            self.manager.drain_manager.wait_idle(10.0)
            self.manager.pod_manager.wait_idle(10.0)
        finally:
            events_mod.set_default_log(prev)
        self.fleet.reconcile()

    def close(self):
        self.manager.shutdown()


@pytest.fixture()
def rigs():
    out = [_Rig(n) for n in ("canary", "region", "global")]
    yield out
    for rig in out:
        rig.close()


def _spec(**overrides) -> FederationPolicySpec:
    kwargs = dict(
        name="test",
        target_revision="rev2",
        cells=(
            FederationCellSpec(name="canary"),
            FederationCellSpec(name="region"),
            FederationCellSpec(name="global"),
        ),
    )
    kwargs.update(overrides)
    return FederationPolicySpec(**kwargs)


def _drive(coordinator, rigs, ticks, stop=None):
    status = {}
    for _ in range(ticks):
        status = coordinator.evaluate()
        for rig in rigs:
            rig.reconcile()
        if stop is not None and stop(status):
            break
    return status


class TestCoordinator:
    def test_wave_promotes_strictly_in_order(self, rigs):
        coordinator = FederationCoordinator(
            _spec(), [r.cell for r in rigs]
        )
        status = _drive(
            coordinator,
            rigs,
            40,
            stop=lambda s: s.get("promotedCells") == 3,
        )
        assert status["promotedCells"] == 3
        cells = {c["name"]: c for c in status["cells"]}
        assert (
            cells["canary"]["promotedAt"]
            <= cells["region"]["admittedAt"]
        )
        assert (
            cells["region"]["promotedAt"]
            <= cells["global"]["admittedAt"]
        )
        stream = coordinator.log.export_stream()
        admitted_order = [
            d["target"]
            for d in stream
            if d["type"] == events_mod.EVENT_CELL_ADMITTED
        ]
        assert admitted_order == [
            cell_target("canary"),
            cell_target("region"),
            cell_target("global"),
        ]
        # every held decision carries a registered reason
        for d in stream:
            legal = events_mod.EVENT_REASONS[d["type"]]
            assert legal is None or d["reason"] in legal, d

    def test_unadmitted_cells_hold_with_reason(self, rigs):
        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        coordinator.evaluate()
        status = coordinator.evaluate()
        cells = {c["name"]: c["phase"] for c in status["cells"]}
        # ordinary wave-order waiting is QUEUED (not held — only
        # abnormal holds feed federation_cells_held and its alert)
        assert cells["region"] == "queued"
        assert cells["global"] == "queued"
        assert status["heldCells"] == []
        held = [
            d
            for d in coordinator.log.export_stream()
            if d["type"] == events_mod.EVENT_CELL_HELD
        ]
        assert held and all(
            d["reason"] == events_mod.REASON_CELL_HOLD for d in held
        )

    def test_breach_trips_global_breaker_holds_and_rolls_back(self, rigs):
        region = rigs[1]
        region.fleet.bad_revisions.add("rev2")
        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        status = _drive(
            coordinator,
            rigs,
            40,
            stop=lambda s: (s.get("breaker") or {}).get("state") == "open",
        )
        breaker = status.get("breaker") or {}
        assert breaker.get("state") == "open"
        assert "region" in breaker.get("breachedCells", [])
        assert metrics.default_registry().counter(
            "federation_breaker_trips_total",
            "Global federation breaker trips.",
        ).value() == 1
        # the coordinator's own stream carries the trip + the gate hold
        stream = coordinator.log.export_stream()
        assert any(
            d["type"] == events_mod.EVENT_BREAKER_TRIPPED
            and d["reason"] == events_mod.REASON_FEDERATION
            for d in stream
        )
        # the global cell must never be admitted while open; drive on
        # and confirm the region converges back to the LKG
        for _ in range(40):
            status = coordinator.evaluate()
            assert not [
                c
                for c in status["cells"]
                if c["name"] == "global" and c.get("admittedAt")
            ]
            for rig in rigs:
                rig.reconcile()
            if region.fleet.converged("rev1", reader=region.store):
                break
        assert region.fleet.converged("rev1", reader=region.store)

    def test_breaker_stays_latched_when_evidence_merely_ages_out(
        self, rigs
    ):
        """Review regression: a breached hold-only cell nobody repairs
        must keep the breaker open even after its admitted-at stamps
        fall out of the census window — evidence AGING out is not the
        cell RECOVERING, and releasing would resume publishing the
        same bad revision."""
        region = rigs[1]
        region.fleet.bad_revisions.add("rev2")
        # strip the trip hook: the region can only be held, never
        # rolled back (the hold-only degradation path)
        region.cell.manager = None
        region.cell.policy = None
        spec = _spec(
            global_breaker=GlobalBreakerSpec(window_seconds=0.2)
        )
        coordinator = FederationCoordinator(spec, [r.cell for r in rigs])
        status = _drive(
            coordinator,
            rigs,
            40,
            stop=lambda s: (s.get("breaker") or {}).get("state") == "open",
        )
        assert (status.get("breaker") or {}).get("state") == "open"
        import time as time_mod

        time_mod.sleep(0.3)  # every stamp ages out of the 0.2 s window
        status = coordinator.evaluate()
        region_census = [
            c for c in status["cells"] if c["name"] == "region"
        ][0]
        assert region_census["failed"] == 0  # windowed ratio input aged
        assert (status.get("breaker") or {}).get("state") == "open", (
            "breaker released on aged-out evidence while the region "
            "still has failed nodes"
        )
        cells = {c["name"]: c for c in status["cells"]}
        assert not cells["global"].get("admittedAt")

    def test_stale_failed_labels_outside_window_do_not_trip(self, rigs):
        """Review regression: FAILED labels left over from an old
        incident (no in-window admission stamp) must not count into the
        aggregate ratio and trip a fresh wave's breaker."""
        from k8s_operator_libs_tpu_torch.upgrade import consts, util

        # wreck two never-admitted nodes in the (un-admitted) global
        # cell as leftovers from a previous rollout
        key = util.get_upgrade_state_label_key()
        for name in ("c000", "c001"):
            rigs[2].store.patch(
                "Node",
                name,
                {"metadata": {"labels": {
                    key: consts.UPGRADE_STATE_FAILED
                }}},
            )
        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        status = _drive(
            coordinator,
            rigs[:2],  # only healthy cells reconcile
            12,
        )
        assert status["failures"] == 0, status  # stale wreckage excluded
        assert (status.get("breaker") or {}).get("state") != "open"

    def test_merged_decisions_do_not_duplicate_sinked_coordinator_stream(
        self, rigs
    ):
        """Review regression: with a sink wired into the audit cell,
        the coordinator's own decisions are persisted there — the live
        merged view must keep ONE copy (the live original), not two."""
        coordinator = FederationCoordinator(
            _spec(),
            [r.cell for r in rigs],
            sink=events_mod.ClusterDecisionEventSink(rigs[0].store),
        )
        coordinator.evaluate()
        coordinator.evaluate()
        merged = coordinator.merged_decisions()
        fed_keys = [
            (d["type"], d["reason"], d["target"])
            for d in merged
            if d["type"]
            in (
                events_mod.EVENT_CELL_ADMITTED,
                events_mod.EVENT_CELL_PROMOTED,
                events_mod.EVENT_CELL_HELD,
            )
        ]
        assert len(fed_keys) == len(set(fed_keys)), (
            "coordinator decisions duplicated in the merged trail: "
            + str(fed_keys)
        )

    def test_unreachable_cell_holds_admissions(self, rigs):
        class Dead:
            def __getattr__(self, name):
                def boom(*a, **k):
                    raise OSError("down")

                return boom

        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        # region's apiserver dies BEFORE its turn in the wave (canary
        # still rolling): by the time the canary promotes, the next
        # admission must find the region unreachable and hold
        coordinator.evaluate()
        rigs[1].cell.cluster = Dead()
        status = _drive(
            coordinator,
            [rigs[0], rigs[2]],  # the dead region's operator is down too
            30,
            stop=lambda s: any(
                c["name"] == "canary" and c["phase"] == "promoted"
                for c in s["cells"]
            ),
        )
        for _ in range(3):
            status = coordinator.evaluate()
        cells = {c["name"]: c for c in status["cells"]}
        assert cells["region"]["phase"] == "unreachable"
        assert not cells["region"].get("admittedAt")
        assert not cells["global"].get("admittedAt")
        held = [
            d
            for d in coordinator.log.export_stream()
            if d["type"] == events_mod.EVENT_CELL_HELD
            and d["target"] == cell_target("region")
        ]
        assert any("unreachable" in (d.get("message") or "") for d in held)

    def test_restart_resume_from_persisted_record(self, rigs):
        spec = _spec()
        coordinator = FederationCoordinator(spec, [r.cell for r in rigs])
        _drive(
            coordinator,
            rigs,
            30,
            stop=lambda s: any(
                c["name"] == "region" and c.get("admittedAt")
                for c in s["cells"]
            ),
        )
        before = {
            c["name"]: bool(c.get("admittedAt"))
            for c in coordinator.status()["cells"]
        }
        assert before["canary"] and before["region"]
        # a NEW coordinator (restart) must resume, not re-admit
        resumed = FederationCoordinator(spec, [r.cell for r in rigs])
        status = resumed.evaluate()
        after = {
            c["name"]: bool(c.get("admittedAt")) for c in status["cells"]
        }
        assert after == before
        promoted = {
            c["name"]: bool(c.get("promotedAt")) for c in status["cells"]
        }
        assert promoted["canary"]

    def test_spec_handle_mismatch_rejected(self, rigs):
        with pytest.raises(ValueError):
            FederationCoordinator(_spec(), [rigs[0].cell])

    def test_renderers_cover_key_states(self, rigs):
        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        status = coordinator.evaluate()
        text = render_federation_report(status)
        assert "canary" in text and "cells promoted" in text
        answer = explain_cell(
            "global", status, coordinator.log.events()
        )
        assert answer["verdict"] == "blocked"
        assert answer["reasonCode"] == events_mod.REASON_CELL_HOLD
        rendered = render_cell_explanation(answer)
        assert "cell global" in rendered and "cell:hold" in rendered
        assert explain_cell("nope", status) is None
        assert explain_cell("global", None) is None


# ----------------------------------------------------------- explain parity
class TestOfflineParity:
    def test_offline_report_matches_live_phases(self, rigs):
        spec = _spec()
        coordinator = FederationCoordinator(spec, [r.cell for r in rigs])
        status = _drive(
            coordinator,
            rigs,
            40,
            stop=lambda s: s.get("promotedCells") == 3,
        )
        assert status["promotedCells"] == 3
        dumps = {
            r.name: InMemoryCluster.from_dict(r.store.to_dict())
            for r in rigs
        }
        offline = federation_report_from_clusters(
            spec, dumps, SimFleet.NAMESPACE, dict(SimFleet.LABELS)
        )
        assert offline["promotedCells"] == 3
        assert {c["name"]: c["phase"] for c in offline["cells"]} == {
            c["name"]: c["phase"] for c in status["cells"]
        }
        merged = events_mod.merged_decisions_from_clusters(dumps)
        answer = explain_cell("region", offline, merged)
        assert answer["verdict"] == "complete"
        assert answer["reasonCode"] == events_mod.REASON_CELL_PROMOTE

    def test_offline_missing_dump_is_loud(self, rigs):
        with pytest.raises(ValueError):
            federation_report_from_clusters(
                _spec(),
                {"canary": rigs[0].store},
                SimFleet.NAMESPACE,
                dict(SimFleet.LABELS),
            )


# -------------------------------------------------------------- ops server
class TestFederationRoute:
    def test_route_serves_report_explain_and_events(self, rigs):
        coordinator = FederationCoordinator(_spec(), [r.cell for r in rigs])
        coordinator.evaluate()
        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            federation_source=coordinator.status,
            federation_explain_source=coordinator.explain_cell,
            federation_events_source=coordinator.merged_decisions,
        ).start()
        try:
            with urllib.request.urlopen(
                ops.url + "/debug/federation", timeout=5
            ) as rsp:
                payload = json.loads(rsp.read())
            assert payload["configured"] is True
            assert payload["report"]["cellsTotal"] == 3
            with urllib.request.urlopen(
                ops.url + "/debug/federation?cell=global", timeout=5
            ) as rsp:
                answer = json.loads(rsp.read())
            assert answer["reasonCode"] == events_mod.REASON_CELL_HOLD
            with urllib.request.urlopen(
                ops.url + "/debug/federation?events=1", timeout=5
            ) as rsp:
                payload = json.loads(rsp.read())
            assert isinstance(payload["events"], list)
            with urllib.request.urlopen(ops.url + "/debug", timeout=5) as rsp:
                index = json.loads(rsp.read())
            assert "/debug/federation" in index["endpoints"]
            # unknown cell → 404
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    ops.url + "/debug/federation?cell=nope", timeout=5
                )
            assert err.value.code == 404
        finally:
            ops.stop()

    def test_route_absent_when_not_wired(self):
        ops = OpsServer(port=0, host="127.0.0.1").start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    ops.url + "/debug/federation", timeout=5
                )
            assert err.value.code == 404
        finally:
            ops.stop()
