"""The port's dry-run rollout planning (k8s_operator_libs_tpu_torch/
upgrade/plan.py): the real state machine on a sandbox clone.

``TestPlanCore``, ``TestPlanGates``, ``TestPlanRender`` and the tests of
``TestPlanReviewRegressions`` and ``TestPlanModes`` that do not call the
CLI, from ``tests/test_plan.py``, run here as cases of the same names on
the port in its vocabulary: the no-drift property (plan == what
apply_state does), the no-mutation property (the source is never
touched), gate reporting and multi-cycle projection.  ``TestPlanCli`` and
the other CLI tests drive ``python -m k8s_operator_libs_tpu plan``, which
the port does not hold yet, and stay in the JAX file.
"""

from __future__ import annotations

import copy
import json

import pytest

from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager
from k8s_operator_libs_tpu_torch.upgrade.plan import plan_rollout

from test_torch_harness import DRIVER_LABELS, NAMESPACE, Fleet

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


def _policy(**kwargs) -> UpgradePolicySpec:
    kwargs.setdefault("auto_upgrade", True)
    kwargs.setdefault(
        "drain_spec", DrainSpec(enable=True, force=True, timeout_second=60)
    )
    return UpgradePolicySpec(**kwargs)


def _fleet(n_slices=3, hosts=2) -> tuple:
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for s in range(n_slices):
        for h in range(hosts):
            fleet.add_node(
                f"slice{s}-host{h}",
                labels={consts.SLICE_ID_LABEL_KEYS[0]: f"slice-{s}"},
            )
    fleet.publish_new_revision("v2")
    return cluster, fleet


class TestPlanCore:
    def test_next_admissions_respect_throttle(self):
        cluster, _ = _fleet()
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(max_parallel_upgrades=1, max_unavailable=IntOrString("100%")),
            cycles=2,
        )
        # maxParallel=1, node-granular: exactly one admission predicted
        assert len(plan.next_admissions) == 1
        assert plan.cycles_simulated == 2
        assert not plan.converged

    def test_slice_aware_admits_whole_domain(self):
        cluster, _ = _fleet()
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=1,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
            cycles=2,
        )
        admitted = plan.next_admissions
        assert len(admitted) == 2  # both hosts of one slice co-scheduled
        assert len({n.split("-")[0] for n in admitted}) == 1

    def test_projection_converges_to_done(self):
        cluster, _ = _fleet(n_slices=2)
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
        )
        assert plan.converged, plan.render()
        assert plan.projected_states == {consts.UPGRADE_STATE_DONE: 4}
        # every node passed through the full lifecycle in the projection
        nodes_seen = {t.node for t in plan.transitions}
        assert len(nodes_seen) == 4

    def test_source_is_never_mutated(self):
        cluster, _ = _fleet()
        dump = cluster.to_dict()
        pristine = copy.deepcopy(dump)
        plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(max_parallel_upgrades=0, max_unavailable=IntOrString("100%")),
        )
        assert json.dumps(dump, sort_keys=True) == json.dumps(
            pristine, sort_keys=True
        )
        # and the live source cluster still has every node upgrade-less
        key = util.get_upgrade_state_label_key()
        for node in cluster.list("Node"):
            labels = (node.get("metadata") or {}).get("labels") or {}
            assert key not in labels

    def test_no_drift_plan_cycle_matches_real_apply(self):
        """The fidelity contract: cycle-1 planned transitions equal the
        transitions a REAL manager makes on an identical twin cluster."""
        policy = _policy(
            max_parallel_upgrades=2, max_unavailable=IntOrString("50%")
        )
        cluster, _ = _fleet()
        plan = plan_rollout(
            cluster.to_dict(), NAMESPACE, dict(DRIVER_LABELS), policy, cycles=1
        )

        # replay for real on the twin
        manager = ClusterUpgradeStateManager(cluster)
        state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        key = util.get_upgrade_state_label_key()
        real = {
            (n["metadata"].get("labels") or {}).get(key, "")
            and n["metadata"]["name"]: (n["metadata"].get("labels") or {}).get(
                key, ""
            )
            for n in cluster.list("Node")
        }
        real.pop("", None)
        planned = {
            t.node: t.to_state for t in plan.transitions if t.cycle == 1
        }
        assert planned == {k: v for k, v in real.items() if v}

    def test_blocked_rollout_reaches_steady_state(self):
        cluster, _ = _fleet()
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(max_parallel_upgrades=0, max_unavailable=IntOrString(0)),
        )
        assert plan.steady_state and not plan.converged
        assert plan.next_admissions == []

    def test_auto_upgrade_off_plans_nothing(self):
        cluster, _ = _fleet()
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(auto_upgrade=False),
        )
        assert plan.transitions == []
        assert plan.steady_state


class TestPlanGates:
    def test_frozen_canary_gate_reported(self):
        cluster, fleet = _fleet(n_slices=3)
        policy = _policy(
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            canary_domains=1,
        )
        # run the canary admission for real (cycle 1 classifies, cycle 2
        # admits + stamps the canary domain), then fail its nodes
        manager = ClusterUpgradeStateManager(cluster)
        for _ in range(2):
            state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
        key = util.get_upgrade_state_label_key()
        failed_any = False
        for node in cluster.list("Node"):
            labels = (node.get("metadata") or {}).get("labels") or {}
            if labels.get(key) and labels[key] != consts.UPGRADE_STATE_DONE:
                labels[key] = consts.UPGRADE_STATE_FAILED
                node["metadata"]["labels"] = labels
                cluster.update(node)
                failed_any = True
        assert failed_any

        plan = plan_rollout(
            cluster.to_dict(), NAMESPACE, dict(DRIVER_LABELS), policy, cycles=1
        )
        gates = {g.gate: g for g in plan.gates}
        assert gates["canary"].blocking
        assert plan.next_admissions == []

    def test_closed_window_gate_reported(self):
        cluster, _ = _fleet()
        # a 1-minute window starting 12h from now is closed at planning time
        from datetime import datetime, timedelta, timezone

        from k8s_operator_libs_tpu_torch.api import MaintenanceWindowSpec

        far = datetime.now(timezone.utc) + timedelta(hours=12)
        policy = _policy(
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            maintenance_window=MaintenanceWindowSpec(
                start=far.strftime("%H:%M"), duration_minutes=1
            ),
        )
        plan = plan_rollout(
            cluster.to_dict(), NAMESPACE, dict(DRIVER_LABELS), policy, cycles=1
        )
        gates = {g.gate: g for g in plan.gates}
        assert gates["maintenanceWindow"].blocking
        assert plan.next_admissions == []


class TestPlanRender:
    def test_render_and_dict_shapes(self):
        cluster, _ = _fleet(n_slices=2)
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
        )
        text = plan.render()
        assert "Next admissions" in text
        assert "Cycle 1:" in text
        d = plan.to_dict()
        assert d["converged"] is True
        assert isinstance(d["transitions"], list)
        assert d["nextAdmissions"]
        round_trip = json.dumps(d)
        assert json.loads(round_trip) == d




class TestPlanReviewRegressions:
    """Fixes from review: bystander nodes, explicit-policy failures,
    snapshot-inconsistency exit codes, and sandbox thread cleanup."""

    def test_bystander_nodes_do_not_block_convergence(self):
        """A cluster has nodes that never host driver pods (control
        plane, CPU pools); they must not keep the plan from converging."""
        cluster, _ = _fleet(n_slices=2)
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node

        cluster.create(make_node("control-plane-0"))
        cluster.create(make_node("cpu-pool-7"))
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
        )
        assert plan.converged, plan.render()
        assert plan.projected_states == {consts.UPGRADE_STATE_DONE: 4}
        assert not any("control-plane" in t.node for t in plan.transitions)



    def test_sandbox_threads_are_released(self):
        import threading

        def upgrade_workers() -> int:
            return sum(
                1
                for t in threading.enumerate()
                if t.name.startswith(("upgrade-worker", "pod-check"))
            )

        cluster, _ = _fleet(n_slices=2)
        baseline = upgrade_workers()
        for _ in range(3):
            plan_rollout(
                cluster.to_dict(),
                NAMESPACE,
                dict(DRIVER_LABELS),
                _policy(
                    max_parallel_upgrades=0,
                    max_unavailable=IntOrString("100%"),
                    slice_aware=True,
                ),
            )
        assert upgrade_workers() <= baseline

    def test_mid_restart_wave_snapshot_still_plans(self):
        """A snapshot taken after the operator deleted a drained node's
        pod but before the DS controller recreated it (labeled node, no
        pod, desired > scheduled) must plan to completion, not report
        blocked or error out (review finding: coverage came only from
        snapshot pods)."""
        cluster, fleet = _fleet(n_slices=2)
        policy = _policy(
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
        )
        manager = ClusterUpgradeStateManager(cluster)
        # drive until some driver pod has been deleted (restart wave)
        for _ in range(10):
            state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10.0)
            manager.pod_manager.wait_idle(10.0)
            pods = cluster.list("Pod", NAMESPACE, "app=gpu-driver")
            if len(pods) < 4:
                break  # snapshot HERE: pod(s) deleted, not yet recreated
            fleet.reconcile_daemonset()
        else:
            pytest.fail("never caught the restart-wave window")
        manager.shutdown()

        plan = plan_rollout(
            cluster.to_dict(), NAMESPACE, dict(DRIVER_LABELS), policy
        )
        assert plan.converged, plan.render()
        assert plan.projected_states == {consts.UPGRADE_STATE_DONE: 4}

    def test_shutdown_leaves_injected_managers_alone(self):
        """shutdown() must only release managers IT created (review
        finding: an injected manager shared by two state managers was
        being shut down by the first)."""
        from k8s_operator_libs_tpu_torch.upgrade.drain_manager import DrainManager
        from k8s_operator_libs_tpu_torch.upgrade.node_upgrade_state_provider import NodeUpgradeStateProvider
        from k8s_operator_libs_tpu_torch.upgrade.pod_manager import PodManager
        from k8s_operator_libs_tpu_torch.cluster import InformerCache

        cluster, fleet = _fleet(n_slices=2)
        cache = InformerCache(cluster, lag_seconds=0.0)
        provider = NodeUpgradeStateProvider(
            cluster, cache, cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
        )
        shared_drain = DrainManager(cluster, provider)
        shared_pod = PodManager(cluster, provider)
        m1 = ClusterUpgradeStateManager(
            cluster, cache=cache, provider=provider,
            drain_manager=shared_drain, pod_manager=shared_pod,
        )
        m2 = ClusterUpgradeStateManager(
            cluster, cache=cache, provider=provider,
            drain_manager=shared_drain, pod_manager=shared_pod,
        )
        m1.shutdown()
        # the injected managers' pools must still accept work through m2
        policy = _policy(
            max_parallel_upgrades=0, max_unavailable=IntOrString("100%")
        )
        for _ in range(40):
            state = m2.build_state(NAMESPACE, dict(DRIVER_LABELS))
            m2.apply_state(state, policy)
            m2.drain_manager.wait_idle(10.0)
            m2.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            states = {
                (n["metadata"].get("labels") or {}).get(
                    util.get_upgrade_state_label_key()
                )
                for n in cluster.list("Node")
            }
            if states == {consts.UPGRADE_STATE_DONE}:
                break
        else:
            pytest.fail("rollout through m2 did not converge after m1.shutdown()")
        shared_drain.shutdown()
        shared_pod.shutdown()



class TestPlanModes:
    """Planning with the operator's optional assembly mirrored: requestor
    mode (NodeMaintenance handoff) and the validation builder state."""

    def test_requestor_mode_plans_through_handoff(self):
        from k8s_operator_libs_tpu_torch.upgrade.upgrade_requestor import (
            RequestorOptions,
        )

        cluster, _ = _fleet(n_slices=2)
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
            requestor_opts=RequestorOptions(
                use_maintenance_operator=True,
                requestor_id="plan-preview",
                requestor_namespace="default",
            ),
        )
        assert plan.converged, plan.render()
        # the projection rode the requestor path, not cordon-required
        states_seen = {t.to_state for t in plan.transitions}
        assert consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED in states_seen
        assert consts.UPGRADE_STATE_CORDON_REQUIRED not in states_seen

    def test_validation_state_planned_optimistically(self):
        cluster, _ = _fleet(n_slices=2)
        plan = plan_rollout(
            cluster.to_dict(),
            NAMESPACE,
            dict(DRIVER_LABELS),
            _policy(
                max_parallel_upgrades=0,
                max_unavailable=IntOrString("100%"),
                slice_aware=True,
            ),
            validation_pod_selector="app=validator",
        )
        assert plan.converged, plan.render()
        states_seen = {t.to_state for t in plan.transitions}
        assert consts.UPGRADE_STATE_VALIDATION_REQUIRED in states_seen


    def test_set_based_validation_selector_synthesized(self):
        """The selector grammar serves generation too: '==', 'in (...)'
        and exists terms must all synthesize matching validation pods
        (review finding: a hand-rolled parser rejected 'a==b')."""
        for selector in (
            "app==validator",
            "app in (validator, other)",
            "app=validator,tier!=canary",
            "has-validator",
        ):
            cluster, _ = _fleet(n_slices=2)
            plan = plan_rollout(
                cluster.to_dict(),
                NAMESPACE,
                dict(DRIVER_LABELS),
                _policy(
                    max_parallel_upgrades=0,
                    max_unavailable=IntOrString("100%"),
                    slice_aware=True,
                ),
                validation_pod_selector=selector,
            )
            assert plan.converged, f"{selector!r}: {plan.render()}"

