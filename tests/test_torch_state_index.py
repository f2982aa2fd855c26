"""The port's journal-driven incremental BuildState
(k8s_operator_libs_tpu_torch/upgrade/state_index.py: ClusterStateIndex).

The classes of ``tests/test_state_index.py``, as cases of the same names,
run on the port in its vocabulary, over the port's harness:

* **property-style equivalence**: randomized watch-event sequences
  (adds, updates, deletes, journal-expiry interleavings) and the
  index-built ``ClusterUpgradeState`` identical to a from-scratch
  ``build_state`` after every step, errors included;
* **dirty-node scoping** of ApplyState's done/unknown and failed scans;
* **fallbacks**: journal expiry (410 Gone) rebuilds; a scope-mismatched
  or failing index falls back to the full build and counts it;
* **the list-ops guard**: on a 512-node fleet the indexed BuildState
  issues strictly fewer store list operations than the full rebuild.

``TestControllerWiring`` builds the controller, which the port does not
hold yet, and stays in the JAX file.  Randomness is stdlib ``random``
with fixed seeds.
"""

from __future__ import annotations

import random

import pytest

from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InformerCache, InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import make_pod
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager, UpgradeStateError

from test_torch_harness import (
    DRIVER_LABELS,
    NAMESPACE,
    Fleet,
)

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


ALL_LABEL_STATES = [s for s in consts.ALL_STATES if s]


def canon(state):
    """Comparable snapshot content: bucket → [(node, pod, ds, nm)]."""
    return {
        bucket: [
            (ns.node, ns.driver_pod, ns.driver_daemonset, ns.node_maintenance)
            for ns in entries
        ]
        for bucket, entries in state.node_states.items()
        if entries
    }


def managers(cluster, **kwargs):
    """(full-rebuild manager, index-backed manager) over one cluster."""
    cache = InformerCache(cluster, lag_seconds=0.0)
    m_full = ClusterUpgradeStateManager(
        cluster, cache=cache, cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005, **kwargs,
    )
    m_idx = ClusterUpgradeStateManager(
        cluster, cache=cache, cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.005, use_state_index=True, **kwargs,
    )
    return m_full, m_idx


def build_outcome(manager):
    """(canonical-state, None) or (None, error-string) — error parity is
    part of equivalence (both paths must reject the same inconsistent
    snapshots for the same reason)."""
    try:
        return canon(manager.build_state(NAMESPACE, DRIVER_LABELS)), None
    except UpgradeStateError as err:
        return None, str(err)


def tuned_policy():
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("50%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=30),
    )


class TestEquivalenceProperty:
    """Replay randomized event interleavings; the index must track the
    from-scratch build exactly, step for step."""

    @pytest.mark.parametrize("seed", [7, 23, 1991])
    def test_randomized_event_replay(self, seed):
        rng = random.Random(seed)
        cluster = InMemoryCluster()
        cluster._journal_cap = 300  # provoke organic 410 expiries too
        fleet = Fleet(cluster, revision_hash="rev1")
        node_seq = [0]
        orphan_seq = [0]
        workload_seq = [0]

        def node_names():
            return sorted(fleet.managed_nodes)

        def add_node():
            fleet.add_node(f"n{node_seq[0]:03d}")
            node_seq[0] += 1

        def delete_node():
            names = node_names()
            if not names:
                return
            name = rng.choice(names)
            for pod in cluster.list(
                "Pod", field_selector=f"spec.nodeName={name}"
            ):
                cluster.delete(
                    "Pod", pod["metadata"]["name"],
                    pod["metadata"].get("namespace", ""),
                )
                if pod["metadata"].get("labels", {}).get("app") == "gpu-driver":
                    if pod["metadata"].get("ownerReferences"):
                        fleet._bump_desired(-1)
            cluster.delete("Node", name)
            fleet.managed_nodes.discard(name)

        def patch_state_label():
            names = node_names()
            if not names:
                return
            value = rng.choice(ALL_LABEL_STATES + [None, "bogus-state"])
            cluster.patch(
                "Node", rng.choice(names),
                {"metadata": {"labels": {util.get_upgrade_state_label_key(): value}}},
            )

        def patch_annotation():
            names = node_names()
            if not names:
                return
            key = rng.choice(
                [
                    util.get_upgrade_requested_annotation_key(),
                    util.get_upgrade_initial_state_annotation_key(),
                ]
            )
            cluster.patch(
                "Node", rng.choice(names),
                {"metadata": {"annotations": {key: rng.choice(["true", None])}}},
            )

        def flip_pod_ready():
            pods = cluster.list(
                "Pod", namespace=NAMESPACE, label_selector="app=gpu-driver"
            )
            if not pods:
                return
            pod = rng.choice(pods)
            ready = rng.choice([True, False])
            for s in pod["status"].get("containerStatuses", []):
                s["ready"] = ready
            cluster.update(pod)

        def restart_pod():
            """Delete one driver pod, then let the fake DS controller
            recreate it — a transient desired/found mismatch followed by
            recovery, i.e. the pod-restart wave's event shape."""
            pods = [
                p
                for p in cluster.list(
                    "Pod", namespace=NAMESPACE, label_selector="app=gpu-driver"
                )
                if p["metadata"].get("ownerReferences")
            ]
            if not pods:
                return
            pod = rng.choice(pods)
            cluster.delete("Pod", pod["metadata"]["name"], NAMESPACE)
            fleet.reconcile_daemonset()

        def publish_revision():
            fleet.publish_new_revision(f"rev{rng.randrange(10_000)}")

        def orphan_churn():
            if rng.random() < 0.5 and node_names():
                cluster.create(
                    make_pod(
                        f"orphan-{orphan_seq[0]}",
                        NAMESPACE,
                        rng.choice(node_names()),
                        labels=dict(DRIVER_LABELS),
                        revision_hash="revX",
                    )
                )
                orphan_seq[0] += 1
            else:
                orphans = [
                    p
                    for p in cluster.list(
                        "Pod", namespace=NAMESPACE,
                        label_selector="app=gpu-driver",
                    )
                    if not p["metadata"].get("ownerReferences")
                ]
                if orphans:
                    victim = rng.choice(orphans)
                    cluster.delete("Pod", victim["metadata"]["name"], NAMESPACE)

        def workload_churn():
            """Non-driver pods: invisible to the grouping, but their
            events must still flow (they feed the dirty set)."""
            if node_names():
                cluster.create(
                    make_pod(
                        f"wl-{workload_seq[0]}",
                        "payloads",
                        rng.choice(node_names()),
                        labels={"app": "training"},
                    )
                )
                workload_seq[0] += 1

        def journal_flood():
            """Push the journal past its retention window so the next
            incremental refresh hits 410 Gone and must rebuild."""
            for i in range(cluster._journal_cap + 20):
                cluster.create(
                    {"kind": "Lease", "metadata": {"name": f"burn-{i}"}}
                )
                cluster.delete("Lease", f"burn-{i}")

        ops = [
            (add_node, 3),
            (delete_node, 1),
            (patch_state_label, 6),
            (patch_annotation, 3),
            (flip_pod_ready, 4),
            (restart_pod, 3),
            (publish_revision, 1),
            (orphan_churn, 2),
            (workload_churn, 2),
            (journal_flood, 1),
        ]
        weighted = [op for op, w in ops for _ in range(w)]

        for _ in range(4):
            add_node()
        m_full, m_idx = managers(cluster)
        try:
            assert build_outcome(m_full) == build_outcome(m_idx)
            for step in range(70):
                op = rng.choice(weighted)
                op()
                full, idx = build_outcome(m_full), build_outcome(m_idx)
                assert full == idx, (
                    f"seed {seed} step {step} ({op.__name__}): "
                    f"index diverged from full rebuild"
                )
            index = m_idx.state_index
            # the replay must actually have exercised both refresh paths
            assert index.incremental_refreshes > 0
            assert index.full_rebuilds >= 1
        finally:
            m_full.shutdown()
            m_idx.shutdown()

    def test_requestor_attachment_matches(self, cluster):
        """NodeMaintenance attachment rides materialization and tracks
        CR churn through the dirty set."""
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(3):
            fleet.add_node(f"n{i}")

        class Requestor:
            def __init__(self, cluster):
                self.cluster = cluster

            def attach_node_maintenance(self, node_state):
                from k8s_operator_libs_tpu_torch.cluster.errors import NotFoundError

                name = node_state.node["metadata"]["name"]
                try:
                    node_state.node_maintenance = self.cluster.get(
                        "NodeMaintenance", f"mn-{name}"
                    )
                except NotFoundError:
                    node_state.node_maintenance = None

        m_full, m_idx = managers(cluster, requestor=Requestor(cluster))
        try:
            assert build_outcome(m_full) == build_outcome(m_idx)
            cluster.create(
                {
                    "kind": "NodeMaintenance",
                    "metadata": {"name": "mn-n1"},
                    "spec": {"nodeName": "n1"},
                }
            )
            assert build_outcome(m_full) == build_outcome(m_idx)
            cluster.delete("NodeMaintenance", "mn-n1")
            assert build_outcome(m_full) == build_outcome(m_idx)
        finally:
            m_full.shutdown()
            m_idx.shutdown()


class TestDirtyScoping:
    def _converged_pair(self, cluster, nodes=4):
        fleet = Fleet(cluster, revision_hash="rev1")
        for i in range(nodes):
            fleet.add_node(f"n{i}")
        fleet.publish_new_revision("rev2")
        m_full, m_idx = managers(cluster)
        policy = tuned_policy()
        for _ in range(60):
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            m_idx.apply_state(state, policy)
            m_idx.drain_manager.wait_idle(10.0)
            m_idx.pod_manager.wait_idle(10.0)
            fleet.reconcile_daemonset()
            if fleet.all_done():
                break
        else:
            pytest.fail("indexed rollout did not converge")
        return fleet, m_full, m_idx, policy

    def test_indexed_rollout_converges_and_scopes_done_scan(self, cluster):
        fleet, m_full, m_idx, policy = self._converged_pair(cluster)
        try:
            # settle the post-convergence writes
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            m_idx.apply_state(state, policy)

            # steady state: nothing changed → empty dirty set → the
            # done-bucket scan checks NOBODY (no sync-oracle calls)
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert state.dirty_nodes == set()
            calls = []
            common = m_idx.common
            original = common.pod_in_sync_with_ds
            common.pod_in_sync_with_ds = lambda ns: (
                calls.append(ns.node["metadata"]["name"]) or original(ns)
            )
            try:
                common.process_done_or_unknown_nodes(
                    state, consts.UPGRADE_STATE_DONE
                )
                assert calls == []
                # one node touched → exactly that node is re-checked
                cluster.patch(
                    "Node", "n2",
                    {"metadata": {"annotations": {"touched": "1"}}},
                )
                state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
                assert state.dirty_nodes == {"n2"}
                calls.clear()
                common.process_done_or_unknown_nodes(
                    state, consts.UPGRADE_STATE_DONE
                )
                assert calls == ["n2"]
            finally:
                common.pod_in_sync_with_ds = original
        finally:
            m_full.shutdown()
            m_idx.shutdown()

    def test_unacked_dirty_survives_builds_without_apply(self, cluster):
        fleet, m_full, m_idx, policy = self._converged_pair(cluster)
        try:
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            m_idx.apply_state(state, policy)
            cluster.patch(
                "Node", "n1", {"metadata": {"annotations": {"poke": "1"}}}
            )
            # probe builds (no apply) must not consume the change...
            for _ in range(3):
                state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
                assert state.dirty_nodes == {"n1"}
            # ...a paused pass must not either...
            m_idx.apply_state(state, None)
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert state.dirty_nodes == {"n1"}
            # ...an aborted pass must not either...
            common = m_idx.common
            original = common.process_cordon_required_nodes
            common.process_cordon_required_nodes = lambda s: (_ for _ in ()).throw(
                RuntimeError("injected")
            )
            try:
                with pytest.raises(RuntimeError):
                    m_idx.apply_state(state, policy)
            finally:
                common.process_cordon_required_nodes = original
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert state.dirty_nodes == {"n1"}
            # ...and a completed pass settles the debt.
            m_idx.apply_state(state, policy)
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert state.dirty_nodes == set()
        finally:
            m_full.shutdown()
            m_idx.shutdown()

    def test_full_rebuild_restores_scan_everything(self, cluster):
        fleet, m_full, m_idx, policy = self._converged_pair(cluster)
        try:
            m_idx.state_index.invalidate()
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert state.dirty_nodes is None  # unknown → full scans
            assert state.scan_scope(consts.UPGRADE_STATE_DONE) == state.nodes_in(
                consts.UPGRADE_STATE_DONE
            )
        finally:
            m_full.shutdown()
            m_idx.shutdown()

    def test_journal_expiry_triggers_automatic_rebuild(self, cluster):
        cluster._journal_cap = 100
        fleet, m_full, m_idx, policy = self._converged_pair(cluster)
        try:
            index = m_idx.state_index
            rebuilds = index.full_rebuilds
            for i in range(cluster._journal_cap + 10):
                cluster.create(
                    {"kind": "Lease", "metadata": {"name": f"burn-{i}"}}
                )
                cluster.delete("Lease", f"burn-{i}")
            state = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert index.full_rebuilds == rebuilds + 1
            assert state.dirty_nodes is None
            assert canon(state) == canon(
                m_full.build_state(NAMESPACE, DRIVER_LABELS)
            )
        finally:
            m_full.shutdown()
            m_idx.shutdown()


class TestFallbacks:
    def test_scope_mismatch_serves_full_build(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("n0")
        registry = metrics.set_default_registry(metrics.MetricsRegistry())
        try:
            _, m_idx = managers(cluster)
            m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            other = m_idx.build_state(NAMESPACE, {"app": "other-driver"})
            assert not other.built_from_index
            assert other.dirty_nodes is None
            reg = metrics.default_registry()
            counter = reg.counter(
                "state_index_fallbacks_total", "", ("reason",)
            )
            assert counter.value("scope-mismatch") == 1
            m_idx.shutdown()
        finally:
            metrics.set_default_registry(registry)

    def test_internal_error_falls_back_and_reseeds(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("n0")
        registry = metrics.set_default_registry(metrics.MetricsRegistry())
        try:
            m_full, m_idx = managers(cluster)
            good = canon(m_idx.build_state(NAMESPACE, DRIVER_LABELS))
            index = m_idx.state_index
            original = index.build_state
            index.build_state = lambda: (_ for _ in ()).throw(
                RuntimeError("index corrupted")
            )
            try:
                fallback = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            finally:
                index.build_state = original
            assert canon(fallback) == good
            assert not fallback.built_from_index
            reg = metrics.default_registry()
            counter = reg.counter(
                "state_index_fallbacks_total", "", ("reason",)
            )
            assert counter.value("error") == 1
            # the histogram labels what actually ran: the fallback
            # build is a full rebuild, not an "incremental" sample
            hist = reg.histogram("build_state_seconds", "", ("mode",))
            assert hist.count("full") == 1
            # the index reseeded itself: next build is indexed again
            again = m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            assert again.built_from_index
            assert canon(again) == good
            m_full.shutdown()
            m_idx.shutdown()
        finally:
            metrics.set_default_registry(registry)

    def test_build_state_seconds_carries_mode_label(self, cluster):
        fleet = Fleet(cluster, revision_hash="rev1")
        fleet.add_node("n0")
        registry = metrics.set_default_registry(metrics.MetricsRegistry())
        try:
            m_full, m_idx = managers(cluster)
            m_full.build_state(NAMESPACE, DRIVER_LABELS)
            m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            hist = metrics.default_registry().histogram(
                "build_state_seconds", "", ("mode",)
            )
            assert hist.count("full") == 1
            assert hist.count("incremental") == 1
            rebuilds = metrics.default_registry().counter(
                "state_index_rebuilds_total", "", ("reason",)
            )
            assert rebuilds.value("seed") == 1
            m_full.shutdown()
            m_idx.shutdown()
        finally:
            metrics.set_default_registry(registry)


class TestListOpsGuard:
    """The bench-scale guard, tier-1 sized: incremental BuildState must
    issue strictly fewer store list operations than the full rebuild on
    a 512-node in-mem fleet."""

    def test_incremental_uses_strictly_fewer_list_ops_512n(self):
        cluster = InMemoryCluster()
        fleet = Fleet(cluster, revision_hash="rev1")
        for s in range(128):
            for h in range(4):
                fleet.add_node(f"s{s:03d}-h{h}")
        fleet.publish_new_revision("rev2")
        m_full, m_idx = managers(cluster)
        try:
            # seed both paths (the index pays its one-time relist here)
            m_idx.build_state(NAMESPACE, DRIVER_LABELS)
            m_full.build_state(NAMESPACE, DRIVER_LABELS)
            full_ops = idx_ops = 0
            for i in range(3):
                cluster.patch(
                    "Node", "s000-h0",
                    {"metadata": {"annotations": {"touch": str(i)}}},
                )
                before = cluster.list_ops
                m_idx.build_state(NAMESPACE, DRIVER_LABELS)
                idx_ops += cluster.list_ops - before
                before = cluster.list_ops
                m_full.build_state(NAMESPACE, DRIVER_LABELS)
                full_ops += cluster.list_ops - before
            assert idx_ops < full_ops, (
                f"incremental build used {idx_ops} list ops vs full's "
                f"{full_ops} — the index is not earning its keep"
            )
            # steady state the index does ZERO list-shaped reads: it
            # consumes the journal only
            assert idx_ops == 0
        finally:
            m_full.shutdown()
            m_idx.shutdown()


