"""Example: a complete slice-aware rolling upgrade, reconcile by reconcile.

This is the consumer pattern: an operator's reconcile loop calls
``build_state`` + ``apply_state`` each cycle; async drain/eviction results
land in node labels and are picked up next cycle.  Here the "cluster" is
the in-memory apiserver with a simulated fleet (two 4-host GPU NVLink domains +
one standalone node) and a simulated DaemonSet controller, so the whole
flow runs on a laptop:

    python -m k8s_operator_libs_tpu_torch.examples.rolling_upgrade
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))

from ..api import DrainSpec, IntOrString, UpgradePolicySpec
from ..cluster import InMemoryCluster
from ..upgrade import ClusterUpgradeStateManager, consts, util

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet


def main() -> int:
    util.set_component_name("gpu-driver")
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for s in range(2):
        for h in range(4):
            fleet.add_node(
                f"slice{s}-host{h}",
                labels={consts.SLICE_ID_LABEL_KEYS[0]: f"slice-{s}"},
            )
    fleet.add_node("standalone")
    fleet.publish_new_revision("v2")  # the rollout target

    manager = ClusterUpgradeStateManager(
        cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
    )
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=1,
        max_unavailable=IntOrString("34%"),  # 1 of 3 slice domains
        slice_aware=True,
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=60),
    )

    for cycle in range(40):
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
        states = fleet.states()
        done = sum(1 for s in states.values() if s == consts.UPGRADE_STATE_DONE)
        busy = {n: s for n, s in states.items() if s not in ("", "upgrade-done")}
        print(f"cycle {cycle:2d}  done {done}/{len(states)}  {busy or 'idle'}")
        if done == len(states):
            print("rollout complete — all nodes at v2, uncordoned")
            return 0
    print("rollout did not finish in 40 cycles", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
