"""End-to-end federation smoke (the ``make verify-federation`` gate).

Two acts over REAL localhost HTTP (each cell is an in-memory store
behind its own :class:`~..cluster.ApiServerFacade`, reached through
``KubeApiClient`` — the same transport a real fleet would use):

1. **Healthy wave** — a 3-cell canary → region → global rollout
   converges: the canary cell completes and promotes, the region cell
   admits only then and promotes on demonstrably healthy SLOs (its
   ``advanceOn: stragglers == 0`` condition is evaluated over its live
   SLO report), the global cell follows, and the whole wave reads
   promoted through the live coordinator, a real
   ``GET /debug/federation`` (+ ``?cell=``), AND the offline plane
   (per-cell dumps → :func:`~.coordinator
   .federation_report_from_clusters` + the merged persisted decision
   streams).
2. **Breached wave** — a fresh 3-cell fleet where the region cell's
   target revision bricks its pods: the region breach trips the GLOBAL
   breaker, the un-admitted global cell provably never admits a node
   after the trip (its store journal carries no state-label writes),
   the breached cell rolls back to its last-known-good revision via the
   coordinator-driven ``trip_for_slo`` hook, and the federated explain
   cites ``gate:federation`` naming the breaching cell — live and
   offline alike.

Raises AssertionError on any violated expectation; the ``fedstatus``
CLI surfaces it as a nonzero exit.
"""

from __future__ import annotations

import json as json_mod
import urllib.request
from typing import List

from .. import metrics
from ..api.federation_spec import FederationCellSpec, FederationPolicySpec
from ..api.upgrade_spec import (
    DrainSpec,
    RemediationSpec,
    SloSpec,
    UpgradePolicySpec,
)
from ..api.intstr import IntOrString
from ..cluster import ApiServerFacade, KubeApiClient, KubeConfig
from ..cluster.cache import InformerCache
from ..cluster.inmem import InMemoryCluster
from ..obs import events as events_mod
from ..upgrade import consts, timeline as timeline_mod, util
from ..upgrade.chaos import SimFleet
from ..upgrade.upgrade_state import ClusterUpgradeStateManager
from .coordinator import (
    Cell,
    FederationCoordinator,
    cell_target,
    explain_cell,
    federation_report_from_clusters,
)

#: The wave the selftest rolls out / aborts.
TARGET = "rev2"


class _CellRig:
    """One selftest cell: store + HTTP facade + client + fleet sim +
    manager, with its own decision log/sink (per-cluster streams must
    stay per-cluster even though all three cells share this process)."""

    def __init__(self, name: str, fleet_size: int, advance_on=()) -> None:
        self.name = name
        self.store = InMemoryCluster()
        self.facade = ApiServerFacade(self.store).start()
        self.client = KubeApiClient(
            KubeConfig(server=self.facade.url), timeout=10.0
        )
        self.fleet = SimFleet(self.store, fleet_size)
        self.log = events_mod.DecisionEventLog()
        self.sink = events_mod.ClusterDecisionEventSink(
            self.client, namespace="default"
        )
        self.policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            # the cell's OWN breaker is deliberately lax (threshold
            # 0.95, min 1000 attempts): act 2 must exercise the
            # COORDINATOR-driven trip, not the local one — autoRollback
            # stays on so trip_for_slo can revert to the LKG
            remediation=RemediationSpec(
                failure_threshold=0.95,
                min_attempted=1000,
                auto_rollback=True,
                backoff_seconds=0.0,
            ),
            # an slos block so the cell serves a live SLO report (the
            # region cell's advanceOn condition evaluates over it)
            slos=SloSpec(fleet_completion_deadline_seconds=86400),
        )
        self.manager = ClusterUpgradeStateManager(
            self.client,
            cache=InformerCache(self.client, lag_seconds=0.0),
            cache_sync_timeout_seconds=5.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=self.sink,
        )
        self.cell = Cell(
            name=name,
            cluster=self.client,
            namespace=SimFleet.NAMESPACE,
            selector=dict(SimFleet.LABELS),
            manager=self.manager,
            policy=self.policy,
            log=self.log,
        )
        self.spec = FederationCellSpec(name=name, advance_on=advance_on)

    def reconcile(self) -> None:
        """One settled per-cell operator pass, emitting into THIS
        cell's log (the process default is swapped for the pass)."""
        previous = events_mod.set_default_log(self.log)
        try:
            state = self.manager.build_state(
                SimFleet.NAMESPACE, SimFleet.LABELS
            )
            self.manager.apply_state(state, self.policy)
            self.manager.drain_manager.wait_idle(10.0)
            self.manager.pod_manager.wait_idle(10.0)
        finally:
            events_mod.set_default_log(previous)
        self.fleet.reconcile()

    def close(self) -> None:
        try:
            self.manager.shutdown()
        finally:
            self.facade.stop()


def _build_rigs() -> List[_CellRig]:
    return [
        _CellRig("canary", 3),
        # the region promotes on demonstrably healthy SLOs, not wall
        # clock: stragglers must read 0 from its LIVE report
        _CellRig("region", 4, advance_on=("stragglers == 0",)),
        _CellRig("global", 5),
    ]


def _spec(rigs: List[_CellRig]) -> FederationPolicySpec:
    spec = FederationPolicySpec(
        name="selftest",
        target_revision=TARGET,
        cells=tuple(r.spec for r in rigs),
    )
    spec.validate()
    return spec


def _drive(coordinator, rigs, ticks: int, stop=None) -> dict:
    status: dict = {}
    for _ in range(ticks):
        status = coordinator.evaluate()
        for rig in rigs:
            rig.reconcile()
        if stop is not None and stop(status):
            break
    return status


def selftest() -> str:
    prev_registry = metrics.set_default_registry(metrics.MetricsRegistry())
    prev_log = events_mod.set_default_log(events_mod.DecisionEventLog())
    prev_recorder = timeline_mod.set_default_recorder(
        timeline_mod.FlightRecorder()
    )
    rigs: List[_CellRig] = []
    ops = None
    try:
        # ================= act 1: the healthy 3-cell wave ==============
        rigs = _build_rigs()
        spec = _spec(rigs)
        coordinator = FederationCoordinator(
            spec,
            [r.cell for r in rigs],
            sink=events_mod.ClusterDecisionEventSink(
                rigs[0].client, namespace="default"
            ),
        )
        status = _drive(
            coordinator,
            rigs,
            ticks=60,
            stop=lambda s: s.get("promotedCells") == 3,
        )
        assert status.get("promotedCells") == 3, (
            "healthy wave did not converge: "
            + str({c["name"]: c["phase"] for c in status.get("cells") or []})
        )
        order = [
            c["name"]
            for c in sorted(
                status["cells"], key=lambda c: c.get("promotedAt") or 0
            )
        ]
        assert order == ["canary", "region", "global"], order
        stream_types = {
            (d["type"], d["target"]) for d in coordinator.log.events()
        }
        for expected in (
            (events_mod.EVENT_CELL_ADMITTED, cell_target("region")),
            (events_mod.EVENT_CELL_PROMOTED, cell_target("canary")),
            (events_mod.EVENT_CELL_HELD, cell_target("global")),
        ):
            assert expected in stream_types, (expected, stream_types)
        region = [c for c in status["cells"] if c["name"] == "region"][0]
        assert region["conditions"] and region["conditions"][0]["satisfied"], (
            "the region's advanceOn condition never demonstrably held: "
            + str(region["conditions"])
        )

        # ---- live HTTP plane: a real OpsServer serves the report, the
        # per-cell explain, and the merged stream
        from ..controller.ops_server import OpsServer

        ops = OpsServer(
            port=0,
            host="127.0.0.1",
            federation_source=coordinator.status,
            federation_explain_source=coordinator.explain_cell,
            federation_events_source=coordinator.merged_decisions,
        ).start()
        with urllib.request.urlopen(
            ops.url + "/debug/federation", timeout=5
        ) as rsp:
            served = json_mod.loads(rsp.read())
        assert (served.get("report") or {}).get("promotedCells") == 3, served
        with urllib.request.urlopen(
            ops.url + "/debug/federation?cell=global", timeout=5
        ) as rsp:
            served_explain = json_mod.loads(rsp.read())
        assert served_explain["verdict"] == "complete", served_explain
        with urllib.request.urlopen(
            ops.url + "/debug/federation?events=1", timeout=5
        ) as rsp:
            served_events = json_mod.loads(rsp.read())
        merged = served_events.get("events") or []
        cells_seen = {d.get("cell") for d in merged}
        assert {"canary", "region", "global", "federation"} <= cells_seen, (
            cells_seen
        )
        with urllib.request.urlopen(ops.url + "/debug", timeout=5) as rsp:
            index = json_mod.loads(rsp.read())
        assert "/debug/federation" in (index.get("endpoints") or []), index

        # ---- offline plane: dumps alone rebuild the same answers
        dumps = {
            r.name: InMemoryCluster.from_dict(r.store.to_dict())
            for r in rigs
        }
        offline = federation_report_from_clusters(
            spec, dumps, SimFleet.NAMESPACE, dict(SimFleet.LABELS)
        )
        assert offline["promotedCells"] == 3, offline
        offline_merged = events_mod.merged_decisions_from_clusters(dumps)
        offline_types = {(d["type"], d["cell"]) for d in offline_merged}
        assert (events_mod.EVENT_NODE_ADMITTED, "region") in offline_types, (
            "region's persisted node decisions missing from the merged "
            "offline stream"
        )
        offline_explain = explain_cell("global", offline, offline_merged)
        assert offline_explain is not None
        assert offline_explain["verdict"] == "complete", offline_explain
        ops.stop()
        ops = None
        for rig in rigs:
            rig.close()
        rigs = []

        # ================= act 2: the breached wave ====================
        rigs = _build_rigs()
        spec = _spec(rigs)
        coordinator = FederationCoordinator(spec, [r.cell for r in rigs])
        region_rig = rigs[1]
        global_rig = rigs[2]
        region_rig.fleet.bad_revisions.add(TARGET)

        status = _drive(
            coordinator,
            rigs,
            ticks=60,
            stop=lambda s: bool(
                (s.get("breaker") or {}).get("state") == "open"
            ),
        )
        breaker = status.get("breaker") or {}
        assert breaker.get("state") == "open", (
            "global breaker never tripped: " + str(status)
        )
        assert "region" in (breaker.get("breachedCells") or []), breaker

        # while the breaker is open the federated explain must cite
        # gate:federation naming the breaching cell — live...
        live_explain = coordinator.explain_cell("global")
        assert live_explain is not None
        assert (
            live_explain["reasonCode"] == events_mod.REASON_FEDERATION_GATE
        ), live_explain
        assert "region" in live_explain["message"], live_explain

        # ...and offline, FROM DUMPS TAKEN WHILE THE BREAKER STANDS
        # (recovery below closes the episode): the persisted federation
        # record carries the open breaker, so dumps alone reproduce the
        # same verdict
        dumps = {
            r.name: InMemoryCluster.from_dict(r.store.to_dict())
            for r in rigs
        }
        offline = federation_report_from_clusters(
            spec, dumps, SimFleet.NAMESPACE, dict(SimFleet.LABELS)
        )
        offline_breaker = offline.get("breaker") or {}
        assert offline_breaker.get("state") == "open", offline
        offline_explain = explain_cell(
            "global",
            offline,
            events_mod.merged_decisions_from_clusters(dumps),
        )
        assert offline_explain is not None
        assert (
            offline_explain["reasonCode"]
            == events_mod.REASON_FEDERATION_GATE
        ), offline_explain
        assert "region" in offline_explain["message"], offline_explain

        # the trip reached the breached CELL's own audit trail with the
        # federation reason code
        region_decisions = events_mod.decisions_from_cluster(
            region_rig.store
        )
        assert any(
            d["type"] == events_mod.EVENT_BREAKER_TRIPPED
            and d["reason"] == events_mod.REASON_FEDERATION
            for d in region_decisions
        ), [(d["type"], d["reason"]) for d in region_decisions]

        # drive the recovery: the breached cell must converge BACK to
        # its last-known-good revision (the coordinator's trip engaged
        # the cell's own trip_for_slo/LKG machinery)
        for _ in range(40):
            coordinator.evaluate()
            for rig in rigs:
                rig.reconcile()
            if region_rig.fleet.converged("rev1", reader=region_rig.store):
                break
        assert region_rig.fleet.converged("rev1", reader=region_rig.store), (
            "breached region cell did not roll back to the LKG: "
            + str(region_rig.fleet.states())
        )

        # no un-promoted cell admitted a node after the trip: the
        # global cell's store saw NO upgrade-state writes at all
        state_key = util.get_upgrade_state_label_key()
        admitted_key = util.get_admitted_at_annotation_key()
        for node in global_rig.store.list("Node"):
            meta = node.get("metadata") or {}
            state = (meta.get("labels") or {}).get(state_key, "")
            assert state in ("", consts.UPGRADE_STATE_DONE), (
                f"global-cell node left idle state after the trip: {state}"
            )
            assert not (meta.get("annotations") or {}).get(admitted_key), (
                "global-cell node carries an admission stamp — a held "
                "cell admitted work after the global trip"
            )

        merged_count = len(coordinator.merged_decisions())
        return (
            "federation selftest OK: 3-cell canary→region→global wave "
            "converged over real HTTP (region promoted on a live "
            "stragglers==0 condition), served via /debug/federation + "
            "offline dumps; injected region breach tripped the global "
            "breaker, held the global cell (zero admissions after the "
            "trip), rolled the region back to its LKG, and the "
            "federated explain cited gate:federation naming the "
            f"breaching cell live and offline ({merged_count} merged "
            "decisions)"
        )
    finally:
        if ops is not None:
            ops.stop()
        for rig in rigs:
            rig.close()
        metrics.set_default_registry(prev_registry)
        events_mod.set_default_log(prev_log)
        timeline_mod.set_default_recorder(prev_recorder)
