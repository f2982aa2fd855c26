"""Example: a standalone upgrade *operator* — no manual reconcile loop.

Where ``rolling_upgrade.py`` calls build_state/apply_state by hand (the
embedded-library pattern), this example assembles the full operator from
the controller runtime: watches on Nodes/Pods/DaemonSets feed a
rate-limited workqueue, worker threads run the reconciler, async drain
results land as node-label events that wake the controller back up.

The port of the JAX package's ``examples/operator.py``, with the same
flags and output lines, on the GPU-fleet vocabulary (``gpu-driver``,
``GpuUpgradePolicy``).  Run the self-contained demo (in-memory apiserver
+ simulated fleet, from a source checkout):

    python -m k8s_operator_libs_tpu_torch.examples.operator

or point the SAME operator at a real cluster (no simulation; the fleet,
DaemonSet controller and kubelets are real):

    python -m k8s_operator_libs_tpu_torch.examples.operator \
        --kubeconfig ~/.kube/config --namespace tpu-ops --run-seconds 0
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))

from .. import metrics
from ..api import (
    DrainSpec,
    IntOrString,
    RemediationSpec,
    UpgradePolicySpec,
)
from ..cluster import InMemoryCluster
from ..controller import new_upgrade_controller
from ..runtime import tune_gc, tune_scheduler
from ..upgrade import consts, util
from ..upgrade.upgrade_state import ClusterUpgradeStateManager

# The in-memory DEMO mode simulates the fleet with the test harness;
# the deployed operator image ships without tests/, so real-cluster
# mode must not require it (run_demo imports Fleet lazily).
try:
    from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet
except ImportError:  # deployed image: real-cluster mode only
    DRIVER_LABELS = {"app": "gpu-driver"}
    NAMESPACE = "tpu-ops"
    Fleet = None


def run_real(args) -> int:
    """Assemble the operator against a live cluster via KubeApiClient.
    No fleet simulation: real controllers recreate driver pods."""
    from ..cluster import KubeApiClient, KubeConfig
    from ..controller import CrPolicySource

    util.set_component_name(args.component)
    if args.in_cluster:
        config = KubeConfig.in_cluster()
    else:
        config = KubeConfig.load(args.kubeconfig or None, context=args.context)
    # client-side throttle: controller-runtime's rest.Config defaults
    config.qps = args.qps
    config.burst = args.burst
    client = KubeApiClient(config)
    recorder = util.ClusterEventRecorder(client, namespace=args.namespace)
    # controller-runtime reading model: snapshot reads ride an informer
    # cache fed by the held watch streams (started by the runnable
    # below) instead of LISTing the apiserver every reconcile
    from ..cluster import InformerCache

    # externally_fed: the watch stream is single-consumer, so the
    # CONTROLLER drains it and tees every batch into this cache
    # (feed_cache below) — one reflector feeding store + workqueue
    cache = InformerCache(
        client,
        lag_seconds=0.05,
        kinds=("Node", "Pod", "DaemonSet", "ControllerRevision"),
        externally_fed=True,
    )
    labels = {}
    for pair in args.selector.split(","):
        if not pair:
            continue
        if "=" not in pair:
            print(
                f"error: --selector expects k=v[,k=v...], got {pair!r}",
                file=sys.stderr,
            )
            return 2
        key, value = pair.split("=", 1)
        labels[key] = value
    # Incremental BuildState: the index rides the same watch tee as the
    # cache (feed_index below), so every reconcile's snapshot assembles
    # O(changed) from resident state instead of relisting the fleet —
    # see docs/performance.md.  externally_fed: the single held stream
    # is pop-once; the controller drains it for everyone.
    from ..upgrade.state_index import ClusterStateIndex

    state_index = ClusterStateIndex(
        client, args.namespace, labels, externally_fed=True
    )
    # Decision-audit persistence: the reason-coded decision stream lands
    # as real core/v1 Events (batched per reconcile; the apiserver
    # TTL-GCs them), so `kubectl get events` / the `events`/`status`
    # CLIs explain the rollout offline too.
    from ..obs import events as events_mod

    manager = ClusterUpgradeStateManager(
        client,
        cache=cache,
        recorder=recorder,
        reads_from_cache=True,
        state_index=state_index,
        decision_event_sink=events_mod.ClusterDecisionEventSink(client),
    )

    def make_controller():
        # Held watch streams start/stop WITH the controller: a hot
        # standby must not stream events nothing drains (the queue
        # would grow to its cap and thrash the 410 recovery path).
        controller = new_upgrade_controller(
            client,
            manager,
            args.namespace,
            labels,
            policy_source=CrPolicySource(client, args.policy, args.namespace),
            resync_seconds=args.resync_seconds,
            feed_cache=cache,
            feed_index=state_index,
        )
        # ControllerRevision/NodeMaintenance ride the held set too: the
        # index watches them, and the controller only uses held streams
        # when EVERY watched kind is held (a partial set degrades all
        # kinds to bounded polling).
        return _HeldWatchRunnable(
            client,
            (
                "Node", "Pod", "DaemonSet", "GpuUpgradePolicy",
                "ControllerRevision", "NodeMaintenance",
            ),
            controller,
        )

    if args.ha:
        # Leader-elected replica (controller-runtime's LeaderElection:
        # true): standbys idle hot until the Lease is theirs.
        from ..controller import HaOperator

        runnable = HaOperator(
            client,
            make_controller,
            identity=args.identity or f"{os.uname().nodename}-{os.getpid()}",
            lease_namespace=args.namespace,
        )
    else:
        runnable = make_controller()
    # Ops endpoints (controller-runtime manager parity: /metrics on the
    # manager's metrics port, /healthz + /readyz on its probe port —
    # here one server carries all three).  Bind BEFORE starting the
    # runnable: a bind failure (port taken) must abort before held
    # watches open or a leader lease is acquired, not leak them.
    ops = None
    if args.ops_port is not None:
        from ..controller import OpsServer
        from ..obs import profiling, tracing

        # every log record carries the current reconcile's trace id (or
        # "-"), correlating log lines with /debug/traces and the
        # histogram exemplars — see docs/observability.md
        tracing.install_trace_logging()
        # continuous profiling plane: the sampler runs for the life of
        # the process (self-measured overhead ~1% of one core, gated
        # <=5% by the bench) and /debug/profile serves its window ring;
        # install() attributes samples to the active reconcile spans
        profiling.default_profiler().install().start()
        ops = OpsServer(
            port=args.ops_port,
            host=args.ops_host,
            # breaker/LKG/quarantine state for operators debugging a
            # paused or rolling-back fleet (decision is null until the
            # first remediation-enabled reconcile publishes one)
            remediation_source=manager.remediation_status,
            # rollout ETA / stragglers / SLO breaches + per-node phase
            # timelines (report is null until the first reconcile under
            # a policy declaring an slos block)
            slo_source=manager.slo_status,
            timeline_source=manager.timeline_status,
            # decision-audit stream + the explain plane ("why is node X
            # not progressing" with a machine-readable reason code)
            events_source=manager.events_status,
            explain_source=manager.explain_node,
            # analysis gates + adaptive pacing (report is null until
            # the first reconcile under a policy declaring an analysis
            # block) and the SLO metrics-history ring behind
            # /debug/slo?history=1
            analysis_source=manager.analysis_status,
            slo_history_source=manager.slo_history,
        ).start()
        ops.add_health_check("controller", runnable.running)
        # A hot HA standby is READY (it serves its purpose: being able
        # to take over); readiness only fails when threads died.
        ops.add_ready_check("replica", runnable.running)
        print(
            f"ops endpoints on {ops.url} "
            "(/metrics /healthz /readyz /debug/traces /debug/profile "
            "/debug/remediation /debug/slo /debug/timeline /debug/events "
            "/debug/explain /debug/analysis)"
        )
    started = False
    try:
        runnable.start()
        started = True
        print(
            f"operator running against {client.config.server} "
            f"(namespace {args.namespace}, selector {args.selector}"
            + (", leader-elected" if args.ha else "")
            + ") — Ctrl-C to stop"
        )
        deadline = (
            time.monotonic() + args.run_seconds if args.run_seconds else None
        )
        while deadline is None or time.monotonic() < deadline:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        if started:
            runnable.stop()
        if ops is not None:
            from ..obs import profiling

            profiling.default_profiler().stop()
            ops.stop()
    return 0


class _HeldWatchRunnable:
    """Controller wrapper pairing held watch streams with its lifecycle
    (streams run only while THIS replica's controller does)."""

    def __init__(self, client, kinds, controller) -> None:
        self._client = client
        self._kinds = tuple(kinds)
        self._controller = controller

    def start(self, workers: int = 1) -> None:
        self._client.start_held_watches(self._kinds)
        self._controller.start(workers=workers)

    def stop(self, timeout: float = 10.0) -> None:
        self._controller.stop(timeout)
        self._client.stop_held_watches()

    def running(self) -> bool:
        return self._controller.running()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kubeconfig",
        nargs="?",
        const="",
        default=None,
        help="run against a real cluster (no value = $KUBECONFIG then "
        "~/.kube/config); default is the in-memory demo",
    )
    parser.add_argument("--context", default=None)
    parser.add_argument("--in-cluster", action="store_true")
    parser.add_argument("--namespace", default=NAMESPACE)
    parser.add_argument(
        "--selector",
        default="app=gpu-driver",
        help="driver DaemonSet pod labels, k=v[,k=v...]",
    )
    parser.add_argument("--component", default="gpu-driver")
    parser.add_argument("--policy", default="fleet-policy")
    parser.add_argument(
        "--ha",
        action="store_true",
        help="leader-elect this replica (coordination.k8s.io Lease); run "
        "several replicas with --ha for hot-standby failover",
    )
    parser.add_argument(
        "--identity",
        default="",
        help="campaign identity for --ha (default: hostname-pid)",
    )
    parser.add_argument("--resync-seconds", type=float, default=30.0)
    parser.add_argument(
        "--qps",
        type=float,
        default=20.0,
        help="client-side request rate cap (controller-runtime's "
        "rest.Config default; 0 disables throttling)",
    )
    parser.add_argument(
        "--burst",
        type=int,
        default=30,
        help="client-side burst size above --qps",
    )
    parser.add_argument(
        "--ops-port",
        type=int,
        default=None,
        help="serve /metrics /healthz /readyz on this port (0 = "
        "ephemeral; omit to disable) — real-cluster mode only",
    )
    parser.add_argument("--ops-host", default="0.0.0.0")
    parser.add_argument(
        "--run-seconds",
        type=float,
        default=0.0,
        help="stop after N seconds (0 = run until interrupted)",
    )
    args = parser.parse_args(argv)
    # RACEWATCH=1: instrument every lock this process creates (the
    # opt-in concurrency sanitizer, docs/concurrency.md) — installed
    # FIRST so the manager/controller locks are born watched, and
    # /debug/profile?locks=1 serves the live hold/contention stats +
    # lock-order graph
    from ..obs import racewatch

    if racewatch.enabled_by_env():
        racewatch.install()
    # control-plane GC profile: the reconcile loop's copy-on-read
    # substrate allocates heavily; default CPython thresholds make GC
    # the dominant super-linear cost at fleet scale (runtime.py)
    tune_gc()
    tune_scheduler()
    if args.kubeconfig is not None or args.in_cluster:
        return run_real(args)
    if args.ha or args.identity:
        print(
            "error: --ha/--identity need a real cluster "
            "(--kubeconfig/--in-cluster); the in-memory demo runs a "
            "single replica",
            file=sys.stderr,
        )
        return 2
    return run_demo()


def run_demo() -> int:
    if Fleet is None:
        print(
            "error: the in-memory demo needs tests/test_torch_harness.py "
            "(run from a source checkout); in the deployed image use --in-cluster "
            "or --kubeconfig",
            file=sys.stderr,
        )
        return 2
    util.set_component_name("gpu-driver")
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for s in range(3):
        for h in range(4):
            fleet.add_node(
                f"slice{s}-host{h}",
                labels={consts.SLICE_ID_LABEL_KEYS[0]: f"slice-{s}"},
            )
    fleet.publish_new_revision("v2")

    recorder = util.ClusterEventRecorder(cluster, namespace=NAMESPACE)
    manager = ClusterUpgradeStateManager(
        cluster,
        recorder=recorder,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
        # self-driven incremental BuildState: the in-mem journal is
        # multi-consumer, so the index advances itself at each build
        use_state_index=True,
    )
    # The full CR-driven story: install the policy CRD (crdutil, the Helm
    # pre-install hook pattern), create a GpuUpgradePolicy CR, and run the
    # operator off it — editing the CR reconfigures the live rollout.
    from ..controller import CrPolicySource
    from ..crdutil import (
        OPERATION_APPLY,
        process_crds_with_config,
        CRDProcessorConfig,
    )

    crd_path = os.path.join(
        os.path.dirname(__file__), "..", "crd",
        "nvidia.com_gpuupgradepolicies.yaml",
    )
    process_crds_with_config(
        cluster, CRDProcessorConfig(operation=OPERATION_APPLY, paths=[crd_path])
    )
    cluster.create(
        {
            "kind": "GpuUpgradePolicy",
            "metadata": {"name": "fleet-policy", "namespace": NAMESPACE},
            "spec": UpgradePolicySpec(
                auto_upgrade=True,
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("34%"),  # 1 of 3 slices at a time
                slice_aware=True,
                drain_spec=DrainSpec(enable=True, force=True, timeout_second=60),
                # detect->decide->recover loop armed: a bad revision that
                # fails half the attempted nodes trips the breaker and
                # rolls the fleet back to the last-known-good revision
                remediation=RemediationSpec(auto_rollback=True),
            ).to_dict(),
        }
    )
    controller = new_upgrade_controller(
        cluster, manager, NAMESPACE, DRIVER_LABELS,
        policy_source=CrPolicySource(cluster, "fleet-policy", NAMESPACE),
        resync_seconds=0.25, active_requeue_seconds=0.02,
    )

    # Simulated DaemonSet controller (envtest has no controllers either).
    stop = threading.Event()

    def ds_loop() -> None:
        while not stop.is_set():
            fleet.reconcile_daemonset()
            time.sleep(0.02)

    ds_thread = threading.Thread(target=ds_loop, daemon=True)
    ds_thread.start()

    controller.start(workers=1)
    started = time.monotonic()
    try:
        while time.monotonic() - started < 60.0:
            states = fleet.states()
            done = sum(1 for s in states.values() if s == consts.UPGRADE_STATE_DONE)
            print(f"t={time.monotonic() - started:5.2f}s  done {done}/{len(states)}")
            if done == len(states):
                print("rollout complete — operator goes quiet")
                break
            time.sleep(0.25)
        else:
            print("rollout did not finish in 60s", file=sys.stderr)
            return 1
    finally:
        controller.stop()
        stop.set()
        ds_thread.join(2.0)

    print("\n--- metrics exposition (excerpt) ---")
    for line in metrics.default_registry().render().splitlines():
        if not line.startswith("#") and (
            "transitions_total" in line or "drains_total" in line
            or "upgrades_done" in line
        ):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
