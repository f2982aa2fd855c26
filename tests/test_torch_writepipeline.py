"""The port's batched write pipeline (cluster/writepipeline.py).

The classes of ``tests/test_writepipeline.py``, as cases of the same
names, run on the port's modules: merge-patch composition, the
randomized ordered-per-object property over both transports, KeyedMutex
interop, coalescing, 429 drain-and-retry, per-item errors, fail-fast per
key and the cache's bulk visibility probe.  ``TestSerialPipelinedEquivalence``
is left in the JAX file: with the cascade and the write pipeline, a
drain worker's synchronous ``pod-restart-required`` write can land
before the reconcile thread's still-queued ``drain-required`` patch for
the same node, which then regresses it a pass (a race of the JAX
package's ``node_upgrade_state_provider``, which the port copies
exactly), so the serial and pipelined runs differ in which pass recreates
which driver pod in some runs.

Two changes keep the copy steady: every thread is joined with a timeout,
and the KeyedMutex test waits for the dispatcher to ask for the held
lock instead of sleeping a fixed time before asserting it is blocked.

Then the parity half: :func:`try_compose_merge_patch` and
:func:`apply_write_op` against the JAX package's on the same seeded
inputs, the results equal after :func:`test_torch_vocab.to_port_vocab`
and the masking of ``test_torch_cluster``.
"""

from __future__ import annotations

import random
import threading
import time
from collections import defaultdict

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.cluster import writepipeline as jwp
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.cluster.objects import make_pod as jax_make_pod
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.errors import (
    ApiError,
    NotFoundError,
    TooManyRequestsError,
)
from k8s_operator_libs_tpu_torch.cluster.writepipeline import (
    WriteDispatcher,
    WriteOp,
    apply_write_op,
    try_compose_merge_patch,
)
from k8s_operator_libs_tpu_torch.cluster.objects import make_node, make_pod
from k8s_operator_libs_tpu_torch.upgrade.util import KeyedMutex

from test_torch_cluster import mask
from test_torch_vocab import to_port_vocab


@pytest.fixture(autouse=True)
def fresh_registry():
    registry = metrics.MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    yield registry
    metrics.set_default_registry(previous)


# ---------------------------------------------------------------- composition
class TestMergePatchComposition:
    def test_leaves_overwrite_and_subobjects_merge(self):
        first = {"metadata": {"labels": {"a": "1"}, "annotations": {"x": "1"}}}
        second = {"metadata": {"labels": {"a": "2", "b": "3"}}}
        composed = try_compose_merge_patch(first, second)
        assert composed == {
            "metadata": {
                "labels": {"a": "2", "b": "3"},
                "annotations": {"x": "1"},
            }
        }

    def test_composition_equals_sequential_application(self):
        """The definitional property, checked against a real store: for
        composable pairs, one composed patch must leave the object
        exactly where patch-then-patch would."""
        rng = random.Random(7)
        keys = ("a", "b", "c")

        def rand_patch():
            return {
                "metadata": {
                    "labels": {
                        k: str(rng.randint(0, 3))
                        for k in rng.sample(keys, rng.randint(1, 3))
                    }
                }
            }

        for _ in range(50):
            first, second = rand_patch(), rand_patch()
            composed = try_compose_merge_patch(first, second)
            assert composed is not None
            sequential = InMemoryCluster()
            sequential.create({"kind": "Node", "metadata": {"name": "n"}})
            sequential.patch("Node", "n", first)
            seq_obj = sequential.patch("Node", "n", second)
            oneshot = InMemoryCluster()
            oneshot.create({"kind": "Node", "metadata": {"name": "n"}})
            one_obj = oneshot.patch("Node", "n", composed)
            assert seq_obj["metadata"]["labels"] == one_obj["metadata"]["labels"]

    def test_null_deletion_overwrites(self):
        composed = try_compose_merge_patch(
            {"metadata": {"labels": {"a": "1"}}},
            {"metadata": {"labels": {"a": None}}},
        )
        assert composed == {"metadata": {"labels": {"a": None}}}

    def test_subobject_over_leaf_not_composable(self):
        # sequential application REPLACES the leaf then merges into the
        # replacement; no single merge patch expresses that against an
        # arbitrary target
        assert (
            try_compose_merge_patch({"spec": 1}, {"spec": {"a": 2}}) is None
        )

    def test_resource_version_lock_never_composed(self):
        locked = {"metadata": {"resourceVersion": "5", "labels": {"a": "1"}}}
        free = {"metadata": {"labels": {"b": "2"}}}
        assert try_compose_merge_patch(locked, free) is None
        assert try_compose_merge_patch(free, locked) is None


# ---------------------------------------------------- recording fake cluster
class RecordingCluster:
    """Duck-typed ClusterClient recording per-key application order and
    per-key/global concurrency, with optional per-call delay and
    injected failures."""

    def __init__(self, delays=None, fail=None, batch_fail=None):
        self.lock = threading.Lock()
        self.applied = defaultdict(list)
        self.active_keys = set()
        self.active = 0
        self.max_active = 0
        self.overlapped_keys = []
        self._delays = delays or (lambda op: 0.0)
        self._fail = fail or (lambda op: None)
        #: Raised from batch_write BEFORE any item applies — APF sheds a
        #: whole POST at admission (per-item errors inside a batch are
        #: per-item verdicts, deliberately not transport overload).
        self._batch_fail = batch_fail or (lambda: None)

    def _apply(self, kind, name, namespace, marker, op):
        key = (kind, namespace, name)
        with self.lock:
            if key in self.active_keys:
                self.overlapped_keys.append(key)
            self.active_keys.add(key)
            self.active += 1
            self.max_active = max(self.max_active, self.active)
        try:
            delay = self._delays(op)
            if delay:
                time.sleep(delay)
            err = self._fail(op)
            if err is not None:
                raise err
            with self.lock:
                self.applied[key].append(marker)
            return {
                "kind": kind,
                "metadata": {"name": name, "resourceVersion": "1"},
            }
        finally:
            with self.lock:
                self.active_keys.discard(key)
                self.active -= 1

    def patch(self, kind, name, body, namespace="", patch_type="merge"):
        marker = body.get("marker", body)
        return self._apply(kind, name, namespace, marker, "patch")

    def delete(self, kind, name, namespace="", grace_period_seconds=None):
        self._apply(kind, name, namespace, "delete", "delete")

    def batch_write(self, ops):
        err = self._batch_fail()
        if err is not None:
            raise err
        return [apply_write_op(self, op) for op in ops]


def _non_composable_body(n: int) -> dict:
    # an optimistic-lock rv suppresses coalescing categorically (each
    # write's conflict check must run against the server), so every
    # submission individually ships and the recorded order is a
    # complete transcript
    return {"marker": n, "metadata": {"resourceVersion": str(n)}}


# ------------------------------------------------------- ordered-per-object
class TestOrderedPerObjectProperty:
    """ISSUE-6 acceptance: randomized concurrent writes to overlapping
    objects observe per-object program order and never deadlock, with
    the dispatcher at max concurrency."""

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("transport", ("batch", "per-op"))
    def test_random_concurrent_fanout(self, seed, transport):
        rng = random.Random(seed)
        n_objects = rng.randint(2, 6)
        n_threads = rng.randint(2, 5)
        writes_per_thread = rng.randint(10, 40)
        objects = [f"node-{i}" for i in range(n_objects)]
        delays = {
            name: rng.choice((0.0, 0.0, 0.001, 0.003)) for name in objects
        }
        cluster = RecordingCluster(delays=lambda op: delays.get(op, 0.0))
        dispatcher = WriteDispatcher(
            cluster,
            max_workers=8,
            max_batch=rng.choice((1, 4, 16)),
            use_batch=(transport == "batch"),
        )
        submitted = defaultdict(list)
        submit_lock = threading.Lock()
        counter = iter(range(10**6))

        def submitter(thread_seed):
            local = random.Random(thread_seed)
            for _ in range(writes_per_thread):
                name = local.choice(objects)
                # submit under the bookkeeping lock so the recorded
                # per-key order IS the dispatcher's submit order
                with submit_lock:
                    n = next(counter)
                    body = _non_composable_body(n)
                    submitted[("Node", "", name)].append(n)
                    dispatcher.submit(
                        WriteOp(op="patch", kind="Node", name=name, body=body)
                    )
                if local.random() < 0.2:
                    time.sleep(0.001)

        threads = [
            threading.Thread(target=submitter, args=(seed * 31 + t,))
            for t in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
            assert not t.is_alive(), "a submitter thread hung"
        dispatcher.flush(timeout=30.0)  # raises on deadlock/stall
        dispatcher.close()
        assert cluster.overlapped_keys == [], (
            "a key had two writes in flight at once"
        )
        for key, order in submitted.items():
            assert cluster.applied[key] == order, key

    def test_worker_cap_respected_under_load(self):
        cluster = RecordingCluster(delays=lambda op: 0.002)
        dispatcher = WriteDispatcher(
            cluster, max_workers=3, max_batch=1, use_batch=False
        )
        for i in range(60):
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name=f"n{i}",
                    body=_non_composable_body(i),
                )
            )
        dispatcher.flush(timeout=30.0)
        dispatcher.close()
        assert cluster.max_active <= 3

    def test_keyed_mutex_serializes_against_synchronous_writers(self):
        asked = threading.Event()

        class WatchedMutex(KeyedMutex):
            """Sets *asked* when a thread other than the holder looks up
            a key's lock (``lock`` and ``lock_many`` both do, before
            they acquire it)."""

            def _get(self, key):
                if threading.current_thread() is not t:
                    asked.set()
                return super()._get(key)

        mutex = WatchedMutex()
        cluster = RecordingCluster()
        dispatcher = WriteDispatcher(
            cluster,
            max_workers=4,
            max_batch=8,
            mutex=mutex,
            mutex_key=lambda op: op.name or None,
            use_batch=False,
        )
        entered = threading.Event()
        release = threading.Event()

        def synchronous_writer():
            with mutex.lock("n0"):
                entered.set()
                release.wait(5.0)
                cluster.patch("Node", "n0", {"marker": "sync"})

        t = threading.Thread(target=synchronous_writer)
        t.start()
        assert entered.wait(5.0)
        done = threading.Event()
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name="n0", body={"marker": "d"}),
            lambda obj, err: done.set(),
        )
        # the dispatched write must be stuck behind the held lock
        assert asked.wait(5.0)
        assert cluster.applied[("Node", "", "n0")] == []
        assert not done.is_set()
        release.set()
        t.join(5.0)
        assert not t.is_alive()
        assert done.wait(5.0)
        dispatcher.close()
        assert cluster.applied[("Node", "", "n0")] == ["sync", "d"]


# -------------------------------------------------------------- coalescing
class TestCoalescing:
    def test_same_object_merge_patches_collapse(self):
        gate = threading.Event()
        cluster = RecordingCluster(
            delays=lambda op: 0.0 if gate.wait(5.0) else 0.0
        )
        dispatcher = WriteDispatcher(
            cluster, max_workers=1, max_batch=1, use_batch=False
        )
        results = []
        # first write holds the single worker at the gate; the next two
        # queue behind it and compose with each other
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name="hold", body={"marker": 0})
        )
        for i in (1, 2):
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name="n0",
                    body={"metadata": {"labels": {f"k{i}": str(i)}}},
                ),
                lambda obj, err, i=i: results.append((i, err)),
            )
        gate.set()
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert dispatcher.coalesced == 1
        # ONE application carried both labels; both callbacks fired
        applied = cluster.applied[("Node", "", "n0")]
        assert len(applied) == 1
        assert applied[0] == {
            "metadata": {"labels": {"k1": "1", "k2": "2"}}
        }
        assert sorted(i for i, _ in results) == [1, 2]
        assert all(err is None for _, err in results)

    def test_non_composable_pairs_ship_separately(self):
        gate = threading.Event()
        cluster = RecordingCluster(
            delays=lambda op: 0.0 if gate.wait(5.0) else 0.0
        )
        dispatcher = WriteDispatcher(
            cluster, max_workers=1, max_batch=1, use_batch=False
        )
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name="hold", body={"marker": 0})
        )
        for i in range(2):
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name="n0",
                    body=_non_composable_body(i),
                )
            )
        gate.set()
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert dispatcher.coalesced == 0
        assert cluster.applied[("Node", "", "n0")] == [0, 1]


# ------------------------------------------------------------- backpressure
class TestOverloadDrainAndRetry:
    """A 429 surviving the transport's own Retry-After replays means the
    server is browned out: the dispatcher must back off and re-send —
    the write succeeds late rather than failing or being re-amplified."""

    @pytest.mark.parametrize("transport", ("batch", "per-op"))
    def test_dispatcher_backs_off_then_succeeds(self, transport):
        remaining = {"n": 3}
        lock = threading.Lock()

        def fail(*_):
            with lock:
                if remaining["n"] > 0:
                    remaining["n"] -= 1
                    return TooManyRequestsError("browned out")
            return None

        cluster = RecordingCluster(fail=fail, batch_fail=fail)
        dispatcher = WriteDispatcher(
            cluster,
            max_workers=2,
            max_batch=4,
            use_batch=(transport == "batch"),
            overload_retries=6,
            overload_backoff_s=0.005,
        )
        errors = []
        for i in range(4):
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name=f"n{i}",
                    body=_non_composable_body(i),
                ),
                lambda obj, err: errors.append(err),
            )
        dispatcher.flush(timeout=30.0)
        dispatcher.close()
        assert dispatcher.overload_backoffs >= 3
        assert errors and all(e is None for e in errors)
        total_applied = sum(len(v) for v in cluster.applied.values())
        assert total_applied == 4

    def test_exhausted_retries_fail_only_their_writes(self):
        def fail(op):
            return TooManyRequestsError("browned out forever")

        cluster = RecordingCluster(fail=fail)
        dispatcher = WriteDispatcher(
            cluster,
            max_workers=1,
            max_batch=1,
            use_batch=False,
            overload_retries=1,
            overload_backoff_s=0.001,
        )
        errors = []
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name="n0", body={"marker": 0}),
            lambda obj, err: errors.append(err),
        )
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert len(errors) == 1
        assert isinstance(errors[0], TooManyRequestsError)

    def test_pdb_eviction_429_is_not_replayed_per_op(self):
        """An eviction's PDB 429 is a per-item semantic verdict the
        caller's drain loop owns — the dispatcher must hand it straight
        back, not burn backoff retries on it."""
        calls = {"n": 0}

        class PdbCluster:
            def evict(self, name, namespace, grace_period_seconds=None):
                calls["n"] += 1
                raise TooManyRequestsError("pdb budget exhausted")

        dispatcher = WriteDispatcher(
            PdbCluster(),
            max_workers=1,
            max_batch=1,
            use_batch=False,
            overload_retries=5,
            overload_backoff_s=0.001,
        )
        errors = []
        dispatcher.submit(
            WriteOp(op="evict", kind="Pod", name="p0", namespace="ns"),
            lambda obj, err: errors.append(err),
        )
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert calls["n"] == 1
        assert isinstance(errors[0], TooManyRequestsError)
        assert dispatcher.overload_backoffs == 0


# ----------------------------------------------------------- error fidelity
class TestPerItemErrors:
    def test_ignore_not_found_swallows_delete_of_gone_object(self):
        cluster = InMemoryCluster()
        dispatcher = WriteDispatcher(
            cluster, max_workers=1, max_batch=1, use_batch=False
        )
        errors = []
        dispatcher.submit(
            WriteOp(
                op="delete",
                kind="Pod",
                name="gone",
                namespace="ns",
                ignore_not_found=True,
            ),
            lambda obj, err: errors.append(err),
        )
        dispatcher.submit(
            WriteOp(op="delete", kind="Pod", name="gone2", namespace="ns"),
            lambda obj, err: errors.append(err),
        )
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert errors[0] is None
        assert isinstance(errors[1], NotFoundError)

    def test_one_bad_write_never_fails_its_batchmates(self):
        cluster = InMemoryCluster()
        cluster.create({"kind": "Node", "metadata": {"name": "good"}})
        dispatcher = WriteDispatcher(
            cluster, max_workers=1, max_batch=8, use_batch=True
        )
        outcomes = {}
        for name in ("good", "missing"):
            dispatcher.submit(
                WriteOp(
                    op="patch",
                    kind="Node",
                    name=name,
                    body={"metadata": {"labels": {"a": "1"}}},
                ),
                lambda obj, err, name=name: outcomes.setdefault(name, err),
            )
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert outcomes["good"] is None
        assert isinstance(outcomes["missing"], ApiError)
        assert (
            cluster.get("Node", "good")["metadata"]["labels"]["a"] == "1"
        )


class TestFailFastPerKey:
    def test_failed_write_cancels_queued_same_key_successors(self):
        """The synchronous contract: a raise prevents the next write
        from ever being issued — a cordon patch failing must not let
        the node's queued state-label patch advance it anyway.  The
        successor fails with the predecessor's error, unapplied;
        writes for OTHER keys are untouched."""
        cluster = InMemoryCluster()
        cluster.create({"kind": "Node", "metadata": {"name": "bystander"}})
        gate = threading.Event()

        class GatedCluster:
            def __init__(self, inner):
                self.inner = inner
                self.first = True

            def patch(self, kind, name, body, **kw):
                if self.first:
                    self.first = False
                    gate.wait(5.0)  # hold key in flight until queued
                return self.inner.patch(kind, name, body, **kw)

            def __getattr__(self, attr):
                return getattr(self.inner, attr)

        dispatcher = WriteDispatcher(
            GatedCluster(cluster), max_workers=2, max_batch=1, use_batch=False
        )
        outcomes = {}
        # rv-locked so the successor can never coalesce into it
        dispatcher.submit(
            WriteOp(
                op="patch",
                kind="Node",
                name="missing",
                body={
                    "metadata": {
                        "resourceVersion": "1",
                        "labels": {"a": "1"},
                    }
                },
            ),
            lambda obj, err: outcomes.setdefault("first", err),
        )
        dispatcher.submit(
            WriteOp(
                op="patch",
                kind="Node",
                name="missing",
                body={"metadata": {"labels": {"b": "2"}}},
            ),
            lambda obj, err: outcomes.setdefault("second", err),
        )
        dispatcher.submit(
            WriteOp(
                op="patch",
                kind="Node",
                name="bystander",
                body={"metadata": {"labels": {"c": "3"}}},
            ),
            lambda obj, err: outcomes.setdefault("bystander", err),
        )
        gate.set()
        dispatcher.flush(timeout=10.0)
        dispatcher.close()
        assert isinstance(outcomes["first"], NotFoundError)
        assert outcomes["second"] is outcomes["first"]
        assert outcomes["bystander"] is None
        assert (
            cluster.get("Node", "bystander")["metadata"]["labels"]["c"]
            == "3"
        )


class TestBulkVisibilityProbe:
    """The cache's bulk rv probe (`resource_versions_of`) that the
    post-wave visibility settle rides: one staleness check + one lock
    hold for the whole name set, answer-identical to per-name probes."""

    def test_bulk_matches_per_name(self):
        from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache

        cluster = InMemoryCluster()
        for name in ("n0", "n1"):
            cluster.create({"kind": "Node", "metadata": {"name": name}})
        cache = InformerCache(cluster, lag_seconds=0.001)
        cache.sync()
        names = ["n0", "n1", "ghost"]
        bulk = cache.resource_versions_of("Node", names)
        assert bulk == {
            name: cache.resource_version_of("Node", name) for name in names
        }
        assert bulk["n0"] is not None and bulk["ghost"] is None

    def test_bulk_passthrough_when_always_fresh(self):
        from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache

        cluster = InMemoryCluster()
        cluster.create({"kind": "Node", "metadata": {"name": "n0"}})
        cache = InformerCache(cluster, lag_seconds=0.0)
        bulk = cache.resource_versions_of("Node", ["n0", "ghost"])
        assert bulk["n0"] == cache.resource_version_of("Node", "n0")
        assert bulk["ghost"] is None


# ------------------------------------------------------------ JAX parity
def _random_patch(rng, depth=0):
    """A seeded merge patch over a small key space: leaves, nulls and
    sub-objects, so that compositions hit every rule."""
    out = {}
    for _ in range(rng.randint(1, 4)):
        key = "abcd"[rng.randint(4)]
        roll = rng.randint(6)
        if roll == 0:
            out[key] = None
        elif roll <= 2 and depth < 2:
            out[key] = _random_patch(rng, depth + 1)
        else:
            out[key] = int(rng.randint(10))
    if depth == 0 and rng.randint(8) == 0:
        out["metadata"] = {"resourceVersion": str(rng.randint(5))}
    return out


@pytest.mark.parametrize("seed", range(4))
def test_try_compose_merge_patch_matches_the_jax_function(seed):
    rng = np.random.RandomState(seed)
    composed = 0
    for _ in range(300):
        first, second = _random_patch(rng), _random_patch(rng)
        ours = try_compose_merge_patch(first, second)
        assert ours == jwp.try_compose_merge_patch(first, second), (first, second)
        composed += ours is not None
    assert 0 < composed < 300


def _write_ops(rng, state_key, n=120):
    """Seeded WriteOps (JAX vocabulary) over a few nodes and pods."""
    ops = []
    for _ in range(n):
        verb = ("patch", "patch", "update", "create", "delete", "evict", "bogus")[rng.randint(7)]
        i = int(rng.randint(6))
        node, pod = f"node-{i}", f"pod-{i}"
        if verb == "patch":
            body = {"metadata": {"labels": {state_key: ("upgrade-required", None)[rng.randint(2)]}}}
            if rng.randint(4) == 0:
                body["metadata"]["resourceVersion"] = str(rng.randint(1, 40))
            strategic = rng.randint(3) == 0
            ops.append(WriteOp(op="patch", kind="Pod" if strategic else "Node",
                               name=pod if strategic else node,
                               namespace="default" if strategic else "",
                               body=None if rng.randint(10) == 0 else body,
                               patch_type="strategic" if strategic else "merge"))
        elif verb == "update":
            body = {"kind": "Node", "metadata": {"name": node, "labels": {state_key: "upgrade-done"}}}
            ops.append(WriteOp(op="update", kind="Node", name=node, body=body))
        elif verb == "create":
            ops.append(WriteOp(op="create", body=("node", "pod")[rng.randint(2)] + f":{i}"))
        elif verb == "delete":
            ops.append(WriteOp(op="delete", kind="Node", name=node, grace_period_seconds=0))
        elif verb == "evict":
            ops.append(WriteOp(op="evict", name=pod, namespace="default", grace_period_seconds=0))
        else:
            ops.append(WriteOp(op="bogus", kind="Node", name=node))
    return ops


def _resolve(op, mk_node, mk_pod, translate):
    """A create op's body is named by a string; build it with the side's
    own builders.  Every other op is rewritten by *translate*."""
    if op.op == "create":
        what, i = op.body.split(":")
        body = mk_node(f"node-{i}") if what == "node" else mk_pod(f"pod-{i}", "default", f"node-{i}")
        return WriteOp(op="create", body=translate(body))
    return WriteOp(op=op.op, kind=op.kind, name=op.name, namespace=op.namespace,
                   body=translate(op.body), patch_type=op.patch_type,
                   grace_period_seconds=op.grace_period_seconds)


@pytest.mark.parametrize("seed", range(4))
def test_apply_write_op_matches_the_jax_function(seed):
    rng = np.random.RandomState(seed)
    theirs_cluster, ours_cluster = JaxInMemoryCluster(), InMemoryCluster()
    verdicts = set()
    for op in _write_ops(rng, jutil.get_upgrade_state_label_key()):
        t_obj, t_err = jwp.apply_write_op(theirs_cluster, _resolve(op, jax_make_node, jax_make_pod, lambda o: o))
        o_obj, o_err = apply_write_op(ours_cluster, _resolve(op, make_node, make_pod, to_port_vocab))
        assert mask(o_obj) == mask(to_port_vocab(t_obj)), op
        assert type(o_err).__name__ == type(t_err).__name__, op
        assert getattr(o_err, "code", None) == getattr(t_err, "code", None), op
        assert str(o_err) == to_port_vocab(str(t_err)), op
        verdicts.add(type(t_err).__name__)
    assert {"NoneType", "NotFoundError", "ConflictError", "BadRequestError", "AlreadyExistsError"} <= verdicts
    assert mask(ours_cluster.to_dict()) == mask(to_port_vocab(theirs_cluster.to_dict()))
