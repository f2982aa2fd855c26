"""The port's StringSet, KeyedMutex, key builders and event recorders.

The classes of ``tests/test_util.py``, as cases of the same names, run on
the port's ``upgrade.util`` and ``cluster.objects``; the component-name
case sets ``gpu`` where the JAX test sets ``libtpu``, and reads the
``nvidia.com`` key.  Then the parity half: the same seeded event
sequence through the port's and the JAX package's
``ClusterEventRecorder`` writes the same Event objects (after
:func:`test_torch_vocab.to_port_vocab`, with uid, creation time and the
first and last timestamps masked), and ``StringSet`` answers alike.
"""

import threading

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.upgrade import consts, util

from test_torch_cluster import mask
from test_torch_vocab import to_port_vocab


@pytest.fixture(autouse=True)
def port_component_name():
    util.set_component_name("gpu-driver")
    yield
    util.set_component_name("gpu-driver")


@pytest.fixture()
def recorder():
    return util.EventRecorder()


class TestStringSet:
    def test_basic(self):
        s = util.StringSet()
        assert not s.has("a")
        s.add("a")
        assert s.has("a") and len(s) == 1
        s.remove("a")
        assert not s.has("a")
        s.remove("a")  # idempotent

    def test_add_if_absent_atomicity(self):
        s = util.StringSet()
        wins = []

        def worker():
            if s.add_if_absent("node-1"):
                wins.append(1)

        threads = [threading.Thread(target=worker) for _ in range(32)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert len(wins) == 1


class TestKeyedMutex:
    def test_per_key_serialization(self):
        km = util.KeyedMutex()
        counter = {"n": 0}

        def bump():
            with km.lock("node-a"):
                v = counter["n"]
                counter["n"] = v + 1

        threads = [threading.Thread(target=bump) for _ in range(50)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert counter["n"] == 50

    def test_different_keys_independent(self):
        km = util.KeyedMutex()
        order = []
        inner_done = threading.Event()

        def other():
            with km.lock("b"):
                order.append("b")
                inner_done.set()

        with km.lock("a"):
            t = threading.Thread(target=other)
            t.start()
            assert inner_done.wait(timeout=2.0)  # 'b' not blocked by 'a'
            t.join()
        assert order == ["b"]


class TestKeys:
    def test_key_builders_parameterized_by_component(self):
        util.set_component_name("gpu")
        assert util.get_upgrade_state_label_key() == (
            "nvidia.com/gpu-upgrade-state"
        )
        assert util.get_event_reason() == "gpuUpgrade"
        assert "gpu" in util.get_upgrade_requestor_mode_annotation_key()
        assert "gpu" in util.get_pre_drain_checkpoint_annotation_key()

    def test_rejects_empty_name(self):
        import pytest

        with pytest.raises(ValueError):
            util.set_component_name("")

    def test_state_vocabulary_complete(self):
        # 13 states incl. unknown — reference consts.go:48-83.
        assert len(consts.ALL_STATES) == 13
        assert consts.UPGRADE_STATE_UNKNOWN == ""
        assert consts.UPGRADE_STATE_DONE == "upgrade-done"
        assert consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED in consts.ALL_STATES


class TestEvents:
    def test_nil_safe_log_event(self):
        util.log_event(None, "n", "Normal", "r", "m")  # must not raise

    def test_recorder_capacity(self):
        r = util.EventRecorder(capacity=3)
        for i in range(5):
            util.log_event(r, "n", "Normal", "r", f"m{i}")
        assert r.messages() == ["m2", "m3", "m4"]


class TestClusterEventRecorder:
    """Cluster-backed Events (reference: util.go:162-177 — the real
    record.EventRecorder path consumers wire up in production)."""

    def _cluster(self):
        from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster

        return InMemoryCluster()

    def test_event_written_to_cluster(self):
        cluster = self._cluster()
        r = util.ClusterEventRecorder(cluster, namespace="ops")
        util.log_event(r, "node-1", "Normal", "CordonRequired", "cordoning")
        events = cluster.list("Event", namespace="ops")
        assert len(events) == 1
        ev = events[0]
        assert ev["involvedObject"] == {
            "kind": "Node",
            "name": "node-1",
            "namespace": "",
        }
        assert ev["reason"] == "CordonRequired"
        assert ev["type"] == "Normal"
        assert ev["count"] == 1
        assert ev["firstTimestamp"] and ev["lastTimestamp"]
        # in-process record kept too (FakeRecorder contract for tests)
        assert r.messages() == ["cordoning"]

    def test_duplicate_events_dedup_by_count(self):
        cluster = self._cluster()
        r = util.ClusterEventRecorder(cluster)
        for _ in range(4):
            r.event("node-1", "Normal", "Drain", "draining")
        events = cluster.list("Event")
        assert len(events) == 1
        assert events[0]["count"] == 4

    def test_distinct_messages_make_distinct_events(self):
        cluster = self._cluster()
        r = util.ClusterEventRecorder(cluster)
        r.event("node-1", "Normal", "Drain", "draining a")
        r.event("node-1", "Normal", "Drain", "draining b")
        r.event("node-2", "Normal", "Drain", "draining a")
        assert len(cluster.list("Event")) == 3

    def test_restarted_recorder_adopts_prior_event(self):
        """Deterministic names mean an operator restart increments the
        existing Event instead of duplicating it."""
        cluster = self._cluster()
        r1 = util.ClusterEventRecorder(cluster)
        r1.event("node-1", "Warning", "DrainFailed", "timeout")
        r2 = util.ClusterEventRecorder(cluster)  # fresh process, empty cache
        r2.event("node-1", "Warning", "DrainFailed", "timeout")
        events = cluster.list("Event")
        assert len(events) == 1
        assert events[0]["count"] == 2

    def test_cluster_write_failure_does_not_raise(self):
        class ExplodingCluster:
            def create(self, obj):
                raise RuntimeError("apiserver down")

            def patch(self, *a, **k):
                raise RuntimeError("apiserver down")

            def get(self, *a, **k):
                raise RuntimeError("apiserver down")

        r = util.ClusterEventRecorder(ExplodingCluster())
        r.event("node-1", "Normal", "Cordon", "msg")  # must not raise
        assert r.messages() == ["msg"]  # in-process record survives


class TestObjectPredicates:
    """cluster/objects.py predicate helpers (reference:
    validation_manager.go:118-136, common_manager.go:636-648)."""

    def test_pod_is_ready_requires_running_and_ready_condition(self):
        from k8s_operator_libs_tpu_torch.cluster.objects import pod_is_ready

        pod = {"status": {"phase": "Running",
                          "conditions": [{"type": "Ready",
                                          "status": "True"}]}}
        assert pod_is_ready(pod) is True
        pod["status"]["conditions"][0]["status"] = "False"
        assert pod_is_ready(pod) is False
        pod["status"]["phase"] = "Pending"
        assert pod_is_ready(pod) is False
        assert pod_is_ready({"status": {"phase": "Running"}}) is False

    def test_pod_restart_count_is_max_across_containers(self):
        from k8s_operator_libs_tpu_torch.cluster.objects import pod_restart_count

        pod = {"status": {"containerStatuses": [
            {"restartCount": 2}, {"restartCount": 11}, {}]}}
        assert pod_restart_count(pod) == 11
        assert pod_restart_count({}) == 0

    def test_get_condition_lookup(self):
        from k8s_operator_libs_tpu_torch.cluster.objects import get_condition

        obj = {"status": {"conditions": [
            {"type": "Ready", "status": "True"},
            {"type": "Degraded", "status": "False"},
        ]}}
        assert get_condition(obj, "Degraded")["status"] == "False"
        assert get_condition(obj, "Absent") is None
        assert get_condition({}, "Ready") is None


# ------------------------------------------------------------ JAX parity
def _events(cluster):
    out = []
    for ev in cluster.list("Event"):
        ev = mask(ev)
        ev["firstTimestamp"] = ev["lastTimestamp"] = "<t>"
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("source_component", [None, "gpu-operator"])
def test_cluster_event_recorder_writes_what_the_jax_recorder_writes(seed, source_component):
    rng = np.random.RandomState(seed)
    theirs = jutil.ClusterEventRecorder(JaxInMemoryCluster(), namespace="ops",
                                        source_component=source_component, capacity=16)
    ours = util.ClusterEventRecorder(InMemoryCluster(), namespace="ops",
                                     source_component=source_component, capacity=16)
    for _ in range(60):
        args = (
            f"node-{rng.randint(5)}",
            ("Normal", "Warning")[rng.randint(2)],
            ("CordonRequired", "DrainRequired", "UpgradeDone")[rng.randint(3)],
            f"attempt {rng.randint(3)}",
        )
        util.log_event(ours, *args)
        jutil.log_event(theirs, *args)
    assert ours.messages() == theirs.messages()
    assert _events(ours._cluster) == to_port_vocab(_events(theirs._cluster))
    assert max(ev["count"] for ev in _events(ours._cluster)) > 1


@pytest.mark.parametrize("seed", range(3))
def test_string_set_answers_as_the_jax_string_set(seed):
    rng = np.random.RandomState(seed)
    ours, theirs = util.StringSet(), jutil.StringSet()
    for _ in range(200):
        key = "abcdef"[rng.randint(6)]
        verb = ("add", "remove", "has", "add_if_absent")[rng.randint(4)]
        assert getattr(ours, verb)(key) == getattr(theirs, verb)(key)
        assert len(ours) == len(theirs)
