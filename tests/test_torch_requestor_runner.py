"""Subprocess entry point for the port's two-operator shared-requestor
e2e (``tests/test_torch_shared_requestor_e2e.py``): the port's copy of
``tests/requestor_operator_runner.py``.

Each instance is a COMPLETE assembled operator in its own process —
its own component name (the reference's driver name is process-global,
SetDriverName at util.go:91-99, so distinct operators are distinct
processes there too), its own KubeApiClient over real HTTP, its own
controller runtime — running the requestor-mode state machine against
the shared apiserver until every node's component reaches upgrade-done.

Exit codes: 0 = rollout converged; 1 = timeout; 2 = bad usage.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from k8s_operator_libs_tpu_torch.api import IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import KubeApiClient, KubeConfig
from k8s_operator_libs_tpu_torch.controller import new_upgrade_controller
from k8s_operator_libs_tpu_torch.upgrade import (
    ClusterUpgradeStateManager,
    RequestorNodeStateManager,
    RequestorOptions,
    consts,
    util,
)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--server", required=True)
    parser.add_argument("--component", required=True)
    parser.add_argument("--requestor-id", required=True)
    parser.add_argument("--namespace", required=True)
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args()

    util.set_component_name(args.component)
    client = KubeApiClient(KubeConfig(server=args.server), timeout=10.0)
    manager = ClusterUpgradeStateManager(
        client,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    requestor = RequestorNodeStateManager(
        manager.common,
        RequestorOptions(
            use_maintenance_operator=True,
            requestor_id=args.requestor_id,
        ),
    )
    manager.with_requestor(requestor, enabled=True)
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
    )
    controller = new_upgrade_controller(
        client,
        manager,
        args.namespace,
        {"app": args.component},
        policy=policy,
        extra_kinds=("NodeMaintenance",),
        resync_seconds=0.1,
        active_requeue_seconds=0.02,
        watch_poll_seconds=0.02,
    )
    controller.start(workers=1)
    state_key = util.get_upgrade_state_label_key()
    try:
        states = {}
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            nodes = client.list("Node")
            states = {
                n["metadata"]["name"]: (
                    (n["metadata"].get("labels") or {}).get(state_key, "")
                )
                for n in nodes
            }
            if states and set(states.values()) == {consts.UPGRADE_STATE_DONE}:
                print(f"{args.component}: rollout converged", flush=True)
                return 0
            time.sleep(0.05)
        print(f"{args.component}: TIMEOUT; states={states}", flush=True)
        return 1
    finally:
        controller.stop()
        client.close()


if __name__ == "__main__":
    sys.exit(main())
