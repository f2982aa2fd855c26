"""Runnable fleet-of-fleets demo: a 3-cell canary → region → global
wave on in-memory clusters (docs/federation.md).

Each cell is a complete single-cluster rollout rig (store + simulated
DaemonSet controller + an UNCHANGED per-cluster manager); the
FederationCoordinator layers the cell wave on top through nothing but
the ClusterClient protocol.  Pass ``--breach`` to brick the region
cell's target revision and watch the global breaker trip, hold the
global cell, and roll the region back to its last-known-good revision.

    python -m k8s_operator_libs_tpu_torch.examples.federation_demo
    python -m k8s_operator_libs_tpu_torch.examples.federation_demo --breach
"""

import argparse
import sys

from ..api import (
    DrainSpec,
    FederationCellSpec,
    FederationPolicySpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from ..cluster.cache import InformerCache
from ..cluster.inmem import InMemoryCluster
from ..federation import Cell, FederationCoordinator
from ..federation.coordinator import (
    render_federation_report,
)
from ..obs import events as events_mod
from ..upgrade.chaos import SimFleet
from ..upgrade.upgrade_state import (
    ClusterUpgradeStateManager,
)

TARGET = "rev2"


class DemoCell:
    def __init__(self, name: str, nodes: int) -> None:
        self.name = name
        self.store = InMemoryCluster()
        self.fleet = SimFleet(self.store, nodes)
        self.log = events_mod.DecisionEventLog()
        self.policy = UpgradePolicySpec(
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

    def reconcile(self) -> None:
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
        self.manager.shutdown()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--breach",
        action="store_true",
        help="brick the region cell's target revision (global breaker demo)",
    )
    parser.add_argument("--ticks", type=int, default=60)
    args = parser.parse_args()

    cells = [
        DemoCell("canary", 3),
        DemoCell("region", 4),
        DemoCell("global", 5),
    ]
    if args.breach:
        cells[1].fleet.bad_revisions.add(TARGET)
    spec = FederationPolicySpec(
        name="demo",
        target_revision=TARGET,
        cells=(
            FederationCellSpec(name="canary"),
            FederationCellSpec(name="region"),
            FederationCellSpec(name="global"),
        ),
    )
    coordinator = FederationCoordinator(spec, [c.cell for c in cells])
    status = {}
    try:
        last_phases = None
        for tick in range(args.ticks):
            status = coordinator.evaluate()
            phases = {c["name"]: c["phase"] for c in status["cells"]}
            if phases != last_phases:
                print(f"[tick {tick:02d}] " + "  ".join(
                    f"{name}={phase}" for name, phase in phases.items()
                ))
                last_phases = phases
            for cell in cells:
                cell.reconcile()
            if status.get("promotedCells") == 3:
                break
            breaker = status.get("breaker") or {}
            if args.breach and breaker.get("state") == "open" and tick > 25:
                break
        print()
        print(render_federation_report(status))
        print()
        print("merged cross-cluster audit trail:")
        for decision in coordinator.merged_decisions():
            print("  " + events_mod.format_decision_line(decision))
        return 0
    finally:
        for cell in cells:
            cell.close()


if __name__ == "__main__":
    sys.exit(main())
