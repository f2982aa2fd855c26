"""The port's history modules against the JAX package's, on the same
seeded inputs: ``obs/history.py`` (:class:`MetricsHistory`),
``upgrade/history.py`` (the node upgrade history read from Events) and
``upgrade/timeline.py``'s :class:`FlightRecorder`.

Each module's functions take seeded inputs directly, with every clock
passed in (``now=``), and must return the same values, the same errors
and the same JSON after :func:`test_torch_vocab.to_port_vocab`.  Then
``tests/test_history.py::TestNodeEventHistory``, as cases of the same
name, reads the history of a rollout through the port's
``ClusterUpgradeStateManager``.
"""

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.obs import history as jhistory
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import history as jupgrade_history
from k8s_operator_libs_tpu.upgrade import timeline as jtimeline
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.api import DrainSpec, IntOrString, UpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster, NotFoundError
from k8s_operator_libs_tpu_torch.cluster.objects import make_node
from k8s_operator_libs_tpu_torch.obs import history
from k8s_operator_libs_tpu_torch.upgrade import consts, history as upgrade_history
from k8s_operator_libs_tpu_torch.upgrade import timeline, util
from k8s_operator_libs_tpu_torch.upgrade.history import node_event_history, render_history
from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

from test_torch_cluster import mask
from test_torch_harness import DRIVER_LABELS, Fleet, NAMESPACE
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

T0 = 1_780_000_000.0


# ------------------------------------------------------------ obs/history


def _rolled_cluster():
    """A fleet rolled to done through a recorder, leaving real Events."""
    cluster = InMemoryCluster()
    fleet = Fleet(cluster, revision_hash="v1")
    for i in range(2):
        fleet.add_node(f"n{i}")
    fleet.publish_new_revision("v2")
    recorder = util.ClusterEventRecorder(cluster, namespace=NAMESPACE)
    manager = ClusterUpgradeStateManager(
        cluster,
        recorder=recorder,
        cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01,
    )
    policy = UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=0,
        max_unavailable=IntOrString("100%"),
        drain_spec=DrainSpec(enable=True, force=True, timeout_second=10),
    )
    for _ in range(40):
        state = manager.build_state(NAMESPACE, dict(DRIVER_LABELS))
        manager.apply_state(state, policy)
        manager.drain_manager.wait_idle(10.0)
        manager.pod_manager.wait_idle(10.0)
        fleet.reconcile_daemonset()
        if set(fleet.states().values()) == {consts.UPGRADE_STATE_DONE}:
            break
    else:
        raise AssertionError(f"rollout did not converge: {fleet.states()}")
    manager.shutdown()
    return cluster


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", [(2048, 3600.0), (16, 60.0)], ids=["default", "tight"])
def test_metrics_history_answers_as_the_jax_one(seed, bounds):
    rng = np.random.RandomState(seed)
    ours, theirs = history.MetricsHistory(*bounds), jhistory.MetricsHistory(*bounds)
    names = ("burn:fleet", "stragglers", "eta", "queue")
    now = T0
    for step in range(200):
        now += float(rng.choice([0.5, 1.0, 5.0, 30.0]))
        present = [n for n in names if rng.randint(5)]  # a series may skip a cycle
        samples = {n: float(rng.randint(0, 6)) for n in present}
        ours.record(samples, now=now)
        theirs.record(samples, now=now)
        if step % 10 == 9:
            for name in names:
                assert ours.latest(name) == theirs.latest(name)
                assert ours.window(name, 45.0, now=now) == theirs.window(name, 45.0, now=now)
                for op, threshold in (("<", 2.0), (">=", 3.0), ("==", 0.0), ("!=", 5.0)):
                    for held in (0.0, 10.0, 60.0):
                        assert ours.holds(name, op, threshold, held, now=now) == theirs.holds(
                            name, op, threshold, held, now=now
                        )
                    assert ours.held_seconds(name, op, threshold, now=now) == theirs.held_seconds(
                        name, op, threshold, now=now
                    )
            assert ours.snapshot() == theirs.snapshot()
            assert ours.snapshot(120.0) == theirs.snapshot(120.0)
            assert len(ours) == len(theirs)
    for bad in (ours, theirs):
        with pytest.raises(ValueError, match="unknown condition op"):
            bad.holds("eta", "~", 1.0)
    assert history.OPS.keys() == jhistory.OPS.keys()


# -------------------------------------------------------- upgrade/history


def _event(i, rng, node, component):
    stamp = f"2026-07-{1 + i // 20:02d}T{i % 24:02d}:00:00Z"
    involved = (
        {"kind": "Node", "name": node} if rng.randint(6) else {"kind": "Pod", "name": f"p{i}"}
    )
    event = {
        "kind": "Event",
        "metadata": {"name": f"ev-{i:03d}", "namespace": ("default", "gpu-operator")[rng.randint(2)]},
        "involvedObject": involved,
        "reason": ("tpu-runtimeUpgrade", "NodeHasSufficientMemory")[rng.randint(2)],
        "message": f"state change {i}",
        "type": ("Normal", "Warning")[rng.randint(2)],
    }
    style = rng.randint(3)
    if style == 0:  # core/v1 with the source block
        event.update(source={"component": component}, count=int(rng.randint(1, 4)),
                     firstTimestamp=stamp, lastTimestamp=stamp)
    elif style == 1:  # events.k8s.io style: eventTime and reportingController
        event.update(reportingController=component, eventTime=stamp)
    else:  # a malformed count
        event.update(source={"component": component}, count="many", lastTimestamp=stamp)
    return event


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_event_history_reads_as_the_jax_one(seed):
    rng = np.random.RandomState(seed)
    jax_store, store = JaxInMemoryCluster(), InMemoryCluster()
    nodes = [f"gpu-node-{i}" for i in range(4)]
    for name in nodes:
        jax_store.create(jax_make_node(name))
        store.create(make_node(name))
    component = jutil.get_event_reason()
    for i in range(60):
        event = _event(i, rng, nodes[rng.randint(len(nodes))], (component, "kubelet")[rng.randint(3) == 0])
        jax_store.create(event)
        store.create(to_port_vocab(event))
    queries = [
        {}, {"node": nodes[1]}, {"namespaces": ["gpu-operator"]},
        {"namespaces": ["default", "absent"], "component": component},
        {"node": nodes[2], "component": "kubelet"},
    ]
    for query in queries:
        theirs = jupgrade_history.node_event_history(jax_store, **query)
        ours = upgrade_history.node_event_history(store, **to_port_vocab(query))
        assert [e.to_dict() for e in ours] == to_port_vocab([e.to_dict() for e in theirs]), query
        # the table's columns fit the widest cell: render the same entries
        assert upgrade_history.render_history(ours) == jupgrade_history.render_history(ours)
    # a typo'd node is an error on both sides, not an empty history
    with pytest.raises(NotFoundError):
        upgrade_history.node_event_history(store, node="gpu-node-9")
    with pytest.raises(Exception) as theirs:
        jupgrade_history.node_event_history(jax_store, node="gpu-node-9")
    assert type(theirs.value).__name__ == "NotFoundError"


@pytest.mark.parametrize("namespaces", [None, ["gpu-operator"]], ids=["all", "one"])
def test_a_failed_events_read_propagates_as_in_jax(namespaces):
    """An apiserver error on the Events read raises (it is never an empty
    history), on both sides: ``TestHistoryReviewRegressions::
    test_live_read_failure_exits_2_not_empty`` without its CLI."""
    from k8s_operator_libs_tpu.cluster.errors import UnauthorizedError as JaxUnauthorized
    from k8s_operator_libs_tpu_torch.cluster.errors import UnauthorizedError

    def denied(error):
        class Denied:
            def list(self, *args, **kwargs):
                raise error("token expired")
        return Denied()

    with pytest.raises(UnauthorizedError, match="token expired"):
        upgrade_history.node_event_history(denied(UnauthorizedError), namespaces=namespaces)
    with pytest.raises(JaxUnauthorized, match="token expired"):
        jupgrade_history.node_event_history(denied(JaxUnauthorized), namespaces=namespaces)


# ------------------------------------------------------- upgrade/timeline


STATES = (
    "", jconsts.UPGRADE_STATE_UPGRADE_REQUIRED, jconsts.UPGRADE_STATE_CORDON_REQUIRED,
    jconsts.UPGRADE_STATE_DRAIN_REQUIRED, jconsts.UPGRADE_STATE_POD_RESTART_REQUIRED,
    jconsts.UPGRADE_STATE_FAILED, jconsts.UPGRADE_STATE_DONE,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [4, 4096])
def test_the_flight_recorder_records_as_the_jax_one(seed, capacity):
    rng = np.random.RandomState(seed)
    ours = timeline.FlightRecorder(capacity=capacity, max_intervals=8, checkpoint_intervals=4)
    theirs = jtimeline.FlightRecorder(capacity=capacity, max_intervals=8, checkpoint_intervals=4)
    jnodes = {f"n{i}": jax_make_node(f"n{i}") for i in range(8)}
    nodes = {name: make_node(name) for name in jnodes}
    state_key, jstate_key = util.get_upgrade_state_label_key(), jutil.get_upgrade_state_label_key()
    qkey, jqkey = util.get_quarantine_annotation_key(), jutil.get_quarantine_annotation_key()
    ckey, jckey = util.get_timeline_annotation_key(), jutil.get_timeline_annotation_key()
    now = T0
    for _ in range(160):
        now += float(rng.choice([0.25, 2.0, 40.0]))
        name = f"n{rng.randint(8)}"
        state = STATES[rng.randint(len(STATES))]
        what = rng.randint(3)
        if what == 0:  # the provider's own transition, with its checkpoint
            value = ours.transition(nodes[name], state, now=now)
            assert value == theirs.transition(jnodes[name], state, now=now)
            nodes[name]["metadata"].setdefault("annotations", {})[ckey] = value
            jnodes[name]["metadata"].setdefault("annotations", {})[jckey] = value
        else:  # an observation, perhaps under quarantine
            quarantined = bool(rng.randint(3) == 0)
            for node, key, skey in ((nodes[name], qkey, state_key), (jnodes[name], jqkey, jstate_key)):
                annotations = node["metadata"].setdefault("annotations", {})
                if quarantined:
                    annotations[key] = "d0"
                else:
                    annotations.pop(key, None)
                node["metadata"].setdefault("labels", {})[skey] = state
            ours.observe_node(nodes[name], now=now)
            theirs.observe_node(jnodes[name], now=now)
        assert ours.timelines() == to_port_vocab(theirs.timelines())
    assert ours.snapshot() == to_port_vocab(theirs.snapshot())
    assert ours.snapshot(node="n3") == to_port_vocab(theirs.snapshot(node="n3"))
    assert ours.evicted_timelines == theirs.evicted_timelines
    assert timeline.wall_clock_samples(ours.timelines()) == jtimeline.wall_clock_samples(theirs.timelines())
    # a new recorder (a restarted operator) restores each node from the
    # checkpoint annotation its predecessor wrote
    fresh, jfresh = timeline.FlightRecorder(), jtimeline.FlightRecorder()
    for name in sorted(nodes):
        fresh.observe_node(nodes[name], now=now + 1)
        jfresh.observe_node(jnodes[name], now=now + 1)
    assert mask(fresh.timelines()) == mask(to_port_vocab(jfresh.timelines()))
    assert [timeline.phase_name(s) for s in STATES] == [jtimeline.phase_name(s) for s in STATES]


class TestNodeEventHistory:
    def test_full_rollout_leaves_a_timeline(self):
        cluster = _rolled_cluster()
        entries = node_event_history(cluster)
        assert entries
        nodes_seen = {e.node for e in entries}
        # per-node milestones plus the aggregate-progress event (keyed by
        # the component name)
        assert {"n0", "n1"} <= nodes_seen
        reasons = {e.reason for e in entries}
        # at least admission and completion milestones appear
        assert any("one" in r.lower() or "done" in r.lower() for r in reasons) or any(
            consts.UPGRADE_STATE_DONE in e.message for e in entries
        )
        # ordered oldest -> newest by lastTimestamp
        stamps = [e.last_timestamp for e in entries]
        assert stamps == sorted(stamps)

    def test_node_filter(self):
        cluster = _rolled_cluster()
        only = node_event_history(cluster, node="n1")
        assert only and all(e.node == "n1" for e in only)

    def test_namespace_scoping(self):
        cluster = _rolled_cluster()
        in_ns = node_event_history(cluster, namespaces=[NAMESPACE])
        assert in_ns
        empty = node_event_history(cluster, namespaces=["elsewhere"])
        assert empty == []

    def test_render_table(self):
        cluster = _rolled_cluster()
        text = render_history(node_event_history(cluster))
        assert "LAST SEEN" in text and "REASON" in text
        assert "n0" in text and "n1" in text
        assert render_history([]) == "No node upgrade events found."
