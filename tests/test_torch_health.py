"""The port's GPU health (k8s_operator_libs_tpu_torch/tpu/health.py)
against the JAX package's tpu/health.py.

* ``TestDegradedDetection`` and ``TestSliceHealthManager`` of
  ``tests/test_health.py``, as cases of the same names, run on the port
  in its vocabulary (conditions ``GpuDegraded`` / ``NVLinkDown``, labels
  ``nvidia.com/degraded`` / ``nvidia.com/gpu.degraded``);
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
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import (
    get_annotation,
    make_node,
    set_condition,
)
from k8s_operator_libs_tpu_torch.tpu import SliceHealthManager, health
from k8s_operator_libs_tpu_torch.upgrade import consts, util

from test_torch_cluster import mask
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
