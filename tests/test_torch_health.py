"""The port's GPU health (k8s_operator_libs_tpu_torch/tpu/health.py)
against the JAX package's tpu/health.py.

* every class of ``tests/test_health.py``, as cases of the same names,
  runs on the port in its vocabulary (conditions ``GpuDegraded`` /
  ``NVLinkDown``, labels ``nvidia.com/degraded`` /
  ``nvidia.com/gpu.degraded``), the quarantine's admission and status
  through its ``ClusterUpgradeStateManager``;
* a differential test: one seeded fleet, its hosts falling sick and
  recovering round by round, goes to a :class:`SliceHealthManager` over
  each package's in-memory cluster; the degraded domains, the cluster
  and the events must agree after :func:`test_torch_vocab.to_port_vocab`.
"""

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.cluster.objects import set_condition as jax_set_condition
from k8s_operator_libs_tpu.tpu import health as jhealth
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import (
    get_annotation,
    make_node,
    set_condition,
)
from k8s_operator_libs_tpu_torch.tpu import SliceHealthManager, health
from k8s_operator_libs_tpu_torch.upgrade import consts, util
from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_cluster import mask
from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]
QKEY = util.get_quarantine_annotation_key


@pytest.fixture()
def cluster():
    return InMemoryCluster()


@pytest.fixture()
def recorder():
    return util.EventRecorder()


class TestDegradedDetection:
    def test_condition_based(self):
        node = make_node("n1")
        assert not health.node_is_degraded(node)
        set_condition(node, "GpuDegraded", "True")
        assert health.node_is_degraded(node)
        set_condition(node, "GpuDegraded", "False")
        assert not health.node_is_degraded(node)

    def test_label_based(self):
        node = make_node("n1", labels={health.DEGRADED_LABEL_KEYS[0]: "true"})
        assert health.node_is_degraded(node)
        node = make_node("n2", labels={health.DEGRADED_LABEL_KEYS[0]: "false"})
        assert not health.node_is_degraded(node)

    def test_degraded_domains_groups_by_slice(self):
        good = make_node("a", labels={SLICE_KEY: "s0"})
        bad = make_node("b", labels={SLICE_KEY: "s1"})
        set_condition(bad, "NVLinkDown", "True")
        solo = make_node("c")
        assert health.degraded_domains([good, bad, solo]) == {"s1"}


class TestSliceHealthManager:
    def test_quarantine_stamped_on_whole_domain_and_lifted(self, cluster, recorder):
        for h in range(2):
            cluster.create(make_node(f"s0-h{h}", labels={SLICE_KEY: "s0"}))
        cluster.create(make_node("solo"))
        sick = cluster.get("Node", "s0-h0")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)

        mgr = SliceHealthManager(cluster, recorder)
        assert mgr.reconcile() == {"s0"}
        # BOTH hosts of the domain are stamped; the healthy solo is not
        assert get_annotation(cluster.get("Node", "s0-h0"), QKEY()) == "s0"
        assert get_annotation(cluster.get("Node", "s0-h1"), QKEY()) == "s0"
        assert not get_annotation(cluster.get("Node", "solo"), QKEY())
        assert (
            metrics.default_registry()
            .gauge("degraded_domains", "")
            .value()
            == 1
        )
        # recovery lifts the quarantine
        sick = cluster.get("Node", "s0-h0")
        set_condition(sick, "GpuDegraded", "False")
        cluster.update(sick)
        assert mgr.reconcile() == set()
        assert not get_annotation(cluster.get("Node", "s0-h0"), QKEY())
        assert not get_annotation(cluster.get("Node", "s0-h1"), QKEY())

    def test_reconcile_idempotent(self, cluster, recorder):
        cluster.create(make_node("n1", labels={SLICE_KEY: "s0"}))
        sick = cluster.get("Node", "n1")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        mgr = SliceHealthManager(cluster, recorder)
        mgr.reconcile()
        rv = cluster.get("Node", "n1")["metadata"]["resourceVersion"]
        mgr.reconcile()  # no new writes when nothing changed
        assert cluster.get("Node", "n1")["metadata"]["resourceVersion"] == rv


def test_the_vocabulary_is_the_jax_one_rewritten():
    assert health.DEGRADED_CONDITION_TYPES == to_port_vocab(jhealth.DEGRADED_CONDITION_TYPES)
    assert health.DEGRADED_LABEL_KEYS == to_port_vocab(jhealth.DEGRADED_LABEL_KEYS)
    assert len(set(health.DEGRADED_LABEL_KEYS)) == 2


def _round(rng, n):
    """One round of health changes in the JAX vocabulary: (node index,
    what, value)."""
    changes = []
    for _ in range(rng.randint(1, 5)):
        i = int(rng.randint(n))
        what = ("TpuDegraded", "TpuLinkDown", "AcceleratorUnhealthy", "label0", "label1", "remediation")[rng.randint(6)]
        changes.append((i, what, ("True", "False")[rng.randint(2)]))
    return changes


def _apply(cluster, set_cond, labels, annotation_key, prefix, changes, name):
    for i, what, value in changes:
        node = cluster.get("Node", name(i))
        if what.startswith("label"):
            node["metadata"].setdefault("labels", {})[labels[int(what[-1])]] = value.lower()
        elif what == "remediation":
            node["metadata"].setdefault("annotations", {})[annotation_key] = (
                f"{prefix}x" if value == "True" else None
            )
            if value != "True":
                node["metadata"]["annotations"].pop(annotation_key)
        else:
            set_cond(node, what, value)
        cluster.update(node)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_health_manager_acts_as_the_jax_one(seed):
    rng = np.random.RandomState(seed)
    n = 24
    name = lambda i: f"h{i:02d}"  # noqa: E731
    jax_side, port_side = JaxInMemoryCluster(), InMemoryCluster()
    for i in range(n):
        labels = {jconsts.SLICE_ID_LABEL_KEYS[0]: f"s{i // 4}"} if i % 7 else {}
        jax_side.create(jax_make_node(name(i), labels=labels))
        port_side.create(make_node(name(i), labels=to_port_vocab(labels)))
    jrec, rec = jutil.EventRecorder(), util.EventRecorder()
    jmgr, mgr = jhealth.SliceHealthManager(jax_side, jrec), SliceHealthManager(port_side, rec)
    seen = set()
    for _ in range(12):
        changes = _round(rng, n)
        _apply(jax_side, jax_set_condition, jhealth.DEGRADED_LABEL_KEYS,
               jutil.get_quarantine_annotation_key(), jconsts.REMEDIATION_QUARANTINE_PREFIX, changes, name)
        _apply(port_side, set_condition, health.DEGRADED_LABEL_KEYS,
               util.get_quarantine_annotation_key(), consts.REMEDIATION_QUARANTINE_PREFIX,
               to_port_vocab(changes), name)
        theirs, ours = jmgr.reconcile(), mgr.reconcile()
        assert ours == to_port_vocab(theirs)
        seen |= ours
        assert mask(port_side.to_dict()) == mask(to_port_vocab(jax_side.to_dict()))
        assert [tuple(vars(e).values()) for e in rec.events] == to_port_vocab(
            [tuple(vars(e).values()) for e in jrec.events]
        )
    assert seen and rec.events  # the rounds degrade and quarantine


class TestQuarantineAdmission:
    def _fleet(self, cluster):
        fleet = Fleet(cluster)
        for s in range(2):
            for h in range(2):
                fleet.add_node(
                    f"s{s}-h{h}", pod_hash="rev1", labels={SLICE_KEY: f"s{s}"}
                )
        fleet.publish_new_revision("rev2")
        return fleet

    def _policy(self, **kw):
        return UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            quarantine_degraded=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
            **kw,
        )

    def test_degraded_domain_not_admitted(self, cluster, fleet_unused=None):
        fleet = self._fleet(cluster)
        sick = cluster.get("Node", "s1-h0")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = self._policy()
        for _ in range(3):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
        states = fleet.states()
        # healthy s0 progressed; quarantined s1 never started
        assert states["s1-h0"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        assert states["s1-h1"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        assert states["s0-h0"] != consts.UPGRADE_STATE_UPGRADE_REQUIRED

    def test_recovered_domain_gets_admitted_and_converges(self, cluster):
        fleet = self._fleet(cluster)
        sick = cluster.get("Node", "s1-h0")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = self._policy()
        for _ in range(2):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
        # repair the TPU → next reconciles admit s1 and finish
        sick = cluster.get("Node", "s1-h0")
        set_condition(sick, "GpuDegraded", "False")
        cluster.update(sick)
        for _ in range(30):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_mid_upgrade_domain_finishes_despite_degradation(self, cluster):
        """Quarantine bars STARTS only: a domain already mid-upgrade must
        run to completion (half-upgraded + stranded is the worse state)."""
        fleet = self._fleet(cluster)
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        # admit everything first (no degradation yet): cycle 1 classifies
        # into upgrade-required, cycle 2 admits (buckets fix at BuildState)
        policy = self._policy()
        for _ in range(2):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
        assert all(
            s != consts.UPGRADE_STATE_UPGRADE_REQUIRED
            for s in fleet.states().values()
        )
        # now a host degrades mid-flight
        sick = cluster.get("Node", "s0-h0")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        for _ in range(30):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
            if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
                break
        assert set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}

    def test_node_mode_quarantine(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("bad", pod_hash="rev1")
        fleet.add_node("good", pod_hash="rev1")
        fleet.publish_new_revision("rev2")
        sick = cluster.get("Node", "bad")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            quarantine_degraded=True,
            drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
        )
        for _ in range(10):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(10)
            manager.pod_manager.wait_idle(10)
            fleet.reconcile_daemonset()
            if fleet.states()["good"] == consts.UPGRADE_STATE_DONE:
                break
        states = fleet.states()
        assert states["bad"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        assert states["good"] == consts.UPGRADE_STATE_DONE


class TestStatusShowsDegraded:
    def test_domain_degraded_flag(self, cluster):
        fleet = Fleet(cluster)
        fleet.add_node("s0-h0", labels={SLICE_KEY: "s0"})
        sick = cluster.get("Node", "s0-h0")
        set_condition(sick, "GpuDegraded", "True")
        cluster.update(sick)
        manager = ClusterUpgradeStateManager(cluster)
        state = manager.build_state(NAMESPACE, DRIVER_LABELS)
        status = RolloutStatus.from_cluster_state(state)
        assert status.domains[0].degraded
        assert status.to_dict()["domains"][0]["degraded"] is True


class TestAnnotationQuarantineHonored:
    def test_manual_annotation_bars_admission_without_live_signal(
        self, cluster
    ):
        """The scheduler honors a stamped quarantine annotation even when
        no live degradation condition is present (manual quarantine /
        single-source-of-truth with SliceHealthManager)."""
        fleet = Fleet(cluster)
        fleet.add_node("s0-h0", pod_hash="rev1", labels={SLICE_KEY: "s0"})
        fleet.publish_new_revision("rev2")
        cluster.patch(
            "Node",
            "s0-h0",
            {"metadata": {"annotations": {QKEY(): "s0"}}},
        )
        manager = ClusterUpgradeStateManager(
            cluster, cache_sync_timeout_seconds=2.0, cache_sync_poll_seconds=0.01
        )
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=0,
            max_unavailable=IntOrString("100%"),
            slice_aware=True,
            quarantine_degraded=True,
        )
        for _ in range(3):
            state = manager.build_state(NAMESPACE, DRIVER_LABELS)
            manager.apply_state(state, policy)
        assert (
            fleet.states()["s0-h0"] == consts.UPGRADE_STATE_UPGRADE_REQUIRED
        )
