"""Example: requestor mode — maintenance delegated to an external operator.

The reference's flagship documented flow (docs/automatic-ofed-upgrade.md):
instead of cordoning/draining itself, the upgrade library creates a
``NodeMaintenance`` CR per node and waits for a cluster-wide maintenance
operator to cordon, drain, and report Ready; the library then restarts
the driver pod and finishes.  Two operators managing different
components on the same nodes SHARE the CR via the
``additionalRequestors`` optimistic-lock protocol
(upgrade_requestor.go:320-368).

This demo runs the whole round trip in-process: a simulated fleet, the
requestor-mode state machine, and a stand-in maintenance operator
(tests/test_torch_harness.py FakeMaintenanceOperator) that performs the
out-of-band cordon/drain.  Watch the states flow::

    upgrade-required -> node-maintenance-required  (CR created)
        [maintenance operator cordons, drains, sets Ready]
    -> pod-restart-required -> uncordon-required -> upgrade-done
        (CR deleted once no requestors remain)

Run:  python -m k8s_operator_libs_tpu_torch.examples.requestor_mode
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))

from ..api import UpgradePolicySpec
from ..cluster import InMemoryCluster
from ..upgrade import (
    ClusterUpgradeStateManager,
    RequestorNodeStateManager,
    RequestorOptions,
    consts,
    util,
)

from test_torch_harness import DRIVER_LABELS, NAMESPACE, FakeMaintenanceOperator, Fleet


def main() -> int:
    util.set_component_name("gpu-driver")
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for i in range(4):
        fleet.add_node(f"node-{i}")
    fleet.publish_new_revision("v2")

    manager = ClusterUpgradeStateManager(
        cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
    )
    requestor = RequestorNodeStateManager(
        manager.common,
        RequestorOptions(
            use_maintenance_operator=True,
            requestor_id="gpu-driver-operator",
        ),
    )
    manager.with_requestor(requestor, enabled=True)
    maintenance_operator = FakeMaintenanceOperator(cluster)
    # Note: in requestor mode maxParallelUpgrades does NOT gate the
    # handoff — every upgrade-required node gets a NodeMaintenance CR
    # (reference parity: upgrade_requestor.go:277-319 loops all nodes;
    # its doc comment mentions a limit the body never applies).
    # Concurrency control is the external maintenance operator's job;
    # this library's maintenance windows / pacing gates still apply.
    policy = UpgradePolicySpec(auto_upgrade=True)

    started = time.monotonic()
    for cycle in range(40):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.pod_manager.wait_idle(10.0)
        handled = maintenance_operator.reconcile()  # the external operator
        fleet.reconcile_daemonset()

        states = fleet.states()
        crs = cluster.list("NodeMaintenance")
        print(
            f"cycle {cycle:2d}: "
            + " ".join(
                f"{n}={s or 'unknown'}" for n, s in sorted(states.items())
            )
            + f"  [NodeMaintenance CRs: {len(crs)}"
            + (f", maintenance acted on {handled}" if handled else "")
            + "]"
        )
        if set(states.values()) == {consts.UPGRADE_STATE_DONE}:
            maintenance_operator.reconcile()  # release deleted CRs
            break
        time.sleep(0.02)
    else:
        print("rollout did not converge", file=sys.stderr)
        return 1

    leftover = cluster.list("NodeMaintenance")
    print(
        f"\nrollout complete in {time.monotonic() - started:.2f}s; "
        f"NodeMaintenance CRs remaining: {len(leftover)}"
    )
    return 0 if not leftover else 1


if __name__ == "__main__":
    sys.exit(main())
