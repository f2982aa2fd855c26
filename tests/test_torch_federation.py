"""The port's federation: the fleet-of-fleets spec
(``api/federation_spec.py``), the randomized cross-cluster stream-merge
property (the federated-explain correctness core), the federation CRD's
schema, and the coordinator (``federation/coordinator.py``) against the
JAX package's.

``TestFederationSpec`` and ``TestMergeProperty`` are the classes of
``tests/test_federation.py`` of the same names, on the port (the CRD
test reads the port's federation CRD).  The JAX file's coordinator
classes build their cells on the chaos module's ``SimFleet``, which is
not ported yet; here a coordinator on each side drives three cells
(canary, region, global), each cell a test-harness ``Fleet`` with its
own state machine, and tick by tick the two coordinators' status reports
and every cell's cluster must agree after ``to_port_vocab``: a healthy
wave to every cell promoted, and a canary whose revision is bad, where
both global breakers trip and both hold the wave."""

import random
import time

import pytest

import harness as jharness
import test_torch_harness as pharness
from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu import federation as jfederation
from k8s_operator_libs_tpu import metrics as jmetrics
from k8s_operator_libs_tpu.cluster import InformerCache as JInformerCache
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JInMemoryCluster
from k8s_operator_libs_tpu.obs import events as jevents
from k8s_operator_libs_tpu.upgrade import upgrade_state as jupgrade_state
from k8s_operator_libs_tpu_torch import api as papi
from k8s_operator_libs_tpu_torch import federation as pfederation
from k8s_operator_libs_tpu_torch import metrics
from k8s_operator_libs_tpu_torch.api import (
    FederationCellSpec,
    FederationPolicySpec,
    GlobalBreakerSpec,
    ValidationError,
)
from k8s_operator_libs_tpu_torch.cluster import InformerCache
from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
from k8s_operator_libs_tpu_torch.obs import events as events_mod
from k8s_operator_libs_tpu_torch.upgrade import upgrade_state
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


# --------------------------------------------------------------------- spec
class TestFederationSpec:
    def test_round_trip(self):
        spec = FederationPolicySpec(
            name="prod",
            target_revision="v2hash",
            cells=(
                FederationCellSpec(name="canary", soak_seconds=60),
                FederationCellSpec(
                    name="region",
                    advance_on=("stragglers == 0 for 30s",),
                ),
                FederationCellSpec(name="global"),
            ),
            global_breaker=GlobalBreakerSpec(
                max_breached_cells=2,
                failure_threshold=0.1,
                rollback_promoted=True,
            ),
        )
        spec.validate()
        rebuilt = FederationPolicySpec.from_dict(spec.to_dict())
        rebuilt.validate()
        assert rebuilt == spec
        assert rebuilt.cell_names() == ("canary", "region", "global")

    def test_validation_rejections(self):
        good = dict(
            name="f",
            target_revision="rev2",
            cells=(FederationCellSpec(name="a"),),
        )
        FederationPolicySpec(**good).validate()
        with pytest.raises(ValidationError):
            FederationPolicySpec(**dict(good, cells=())).validate()
        with pytest.raises(ValidationError):
            FederationPolicySpec(**dict(good, target_revision="")).validate()
        with pytest.raises(ValidationError):
            FederationPolicySpec(
                **dict(
                    good,
                    cells=(
                        FederationCellSpec(name="a"),
                        FederationCellSpec(name="a"),
                    ),
                )
            ).validate()
        with pytest.raises(ValidationError):
            # '/' is the merged-stream cell/target separator
            FederationPolicySpec(
                **dict(good, cells=(FederationCellSpec(name="a/b"),))
            ).validate()
        with pytest.raises(ValidationError):
            FederationPolicySpec(
                **dict(
                    good,
                    cells=(
                        FederationCellSpec(
                            name="a", advance_on=("no such grammar!!",)
                        ),
                    ),
                )
            ).validate()
        with pytest.raises(ValidationError):
            # a bare string would iterate per-character
            FederationCellSpec(name="a", advance_on="eta <= 5")
        with pytest.raises(ValidationError):
            # reserved: the coordinator's own merged-stream key
            FederationPolicySpec(
                **dict(good, cells=(FederationCellSpec(name="federation"),))
            ).validate()
        bad_breaker = GlobalBreakerSpec(max_breached_cells=0)
        with pytest.raises(ValidationError):
            FederationPolicySpec(
                **dict(good), global_breaker=bad_breaker
            ).validate()
        with pytest.raises(ValidationError):
            FederationPolicySpec(
                **dict(good),
                global_breaker=GlobalBreakerSpec(failure_threshold=1.5),
            ).validate()

    def test_loose_dict_inputs_convert(self):
        spec = FederationPolicySpec(
            name="f",
            target_revision="rev2",
            cells=({"name": "a", "soakSeconds": 5},),
            global_breaker={"maxBreachedCells": 3},
        )
        spec.validate()
        assert spec.cells[0].soak_seconds == 5
        assert spec.global_breaker.max_breached_cells == 3

    def test_crd_schema_admits_good_and_rejects_bad(self):
        import pathlib

        import yaml

        from k8s_operator_libs_tpu_torch.cluster import schema as schema_mod

        crd = yaml.safe_load(
            (
                pathlib.Path(__file__).resolve().parents[1]
                / "k8s_operator_libs_tpu_torch/crd/nvidia.com_gpufederationpolicies.yaml"
            ).read_text()
        )
        kind, crd_schema = schema_mod.extract_crd_schema(crd)
        assert kind == "GpuFederationPolicy"
        good = {
            "spec": {
                "targetRevision": "rev2",
                "cells": [{"name": "canary", "soakSeconds": 10}],
            }
        }
        assert schema_mod.validate(good, crd_schema) == []
        # the defaults round-trip into the Python spec
        defaulted = schema_mod.apply_defaults(good, crd_schema)
        FederationPolicySpec.from_dict(defaulted["spec"]).validate()
        missing_target = {"spec": {"cells": [{"name": "a"}]}}
        assert schema_mod.validate(missing_target, crd_schema)
        empty_cells = {"spec": {"targetRevision": "r", "cells": []}}
        assert schema_mod.validate(empty_cells, crd_schema)


# ----------------------------------------------------------- merge property
def _populate_cell(cluster, cell_name: str, rng: random.Random):
    """Simulate 1-3 operator PROCESSES in one cell, each with its own
    log (sequences restart per process) and a sink that must adopt the
    previous process's persisted Events, under a per-process clock skew
    of up to ±5 minutes.  Returns (live_logs, expected decision keys)."""
    types = [
        (events_mod.EVENT_NODE_ADMITTED, "fresh"),
        (events_mod.EVENT_NODE_DEFERRED, "budget"),
        (events_mod.EVENT_NODE_DEFERRED, "pacing"),
        (events_mod.EVENT_NODE_DRAINED, "ok"),
        (events_mod.EVENT_NODE_UPGRADE_FAILED, "attempt-failed"),
        (events_mod.EVENT_BREAKER_TRIPPED, "failure-budget"),
    ]
    base = 1_700_000_000.0 + rng.uniform(0, 60)
    logs = []
    expected = set()
    for process in range(rng.randint(1, 3)):
        log = events_mod.DecisionEventLog()
        sink = events_mod.ClusterDecisionEventSink(cluster)
        skew = rng.uniform(-300, 300)  # this process's clock error
        for i in range(rng.randint(3, 12)):
            type_, reason = rng.choice(types)
            target = f"{cell_name}-n{rng.randint(0, 4)}"
            log.emit(
                type_,
                reason,
                target,
                f"{cell_name} p{process}",
                now=base + skew + process * 30 + i,
            )
            expected.add((cell_name, type_, reason, target))
            if rng.random() < 0.4:
                sink.pump(log)  # duplicate-adoption pressure: partial
                # pumps mean later pumps re-serve advanced counts
        sink.pump(log)
        logs.append(log)
    return logs, expected


class TestMergeProperty:
    """The federated-explain correctness core: merging N per-cluster
    persisted Event streams (skewed clocks, process restarts, duplicate
    adoption) is order-stable, loses no decisions, and matches the live
    merged view."""

    @pytest.mark.parametrize("seed", range(6))
    def test_randomized_merge_is_stable_lossless_and_live_consistent(
        self, seed
    ):
        rng = random.Random(seed)
        cells = {}
        live = {}
        expected = set()
        for cell_name in ("alpha", "beta", "gamma", "delta")[
            : rng.randint(2, 4)
        ]:
            cluster = InMemoryCluster()
            logs, keys = _populate_cell(cluster, cell_name, rng)
            cells[cell_name] = cluster
            live[cell_name] = logs
            expected |= keys

        persisted = {
            name: events_mod.decisions_from_cluster(cluster)
            for name, cluster in cells.items()
        }
        merged = events_mod.merge_cell_streams(persisted)

        # ---- lossless: every decision ever made appears, tagged with
        # its source cell
        got = {
            (d["cell"], d["type"], d["reason"], d["target"]) for d in merged
        }
        assert got == expected

        # ---- order-stable: any input stream order produces the same
        # output; re-merging the merge's own groups is idempotent
        pairs = list(persisted.items())
        for _ in range(4):
            rng.shuffle(pairs)
            assert events_mod.merge_cell_streams(list(pairs)) == merged

        # ---- duplicate adoption: the same cell's stream fed twice
        # must not double-count
        assert (
            events_mod.merge_cell_streams(pairs + pairs[:1]) == merged
        )

        # ---- the produced order is the documented one (timestamp
        # first, seq tiebreak) and is internally consistent
        keys = [events_mod._merge_sort_key(d) for d in merged]
        assert keys == sorted(keys)

        # ---- matches the LIVE merged view: same decision identity
        # set, same per-identity total occurrence counts (persistence +
        # adoption must neither lose nor duplicate)
        live_streams = {}
        live_counts = {}
        for name, logs in live.items():
            stream = []
            for log in logs:
                for d in log.events():
                    stream.append(d)
                    key = (name, d["type"], d["reason"], d["target"])
                    live_counts[key] = live_counts.get(key, 0) + int(
                        d["count"]
                    )
            live_streams[name] = stream
        live_merged = events_mod.merge_cell_streams(live_streams)
        assert {
            (d["cell"], d["type"], d["reason"], d["target"])
            for d in live_merged
        } == got
        persisted_counts = {}
        for d in merged:
            key = (d["cell"], d["type"], d["reason"], d["target"])
            persisted_counts[key] = persisted_counts.get(key, 0) + int(
                d["count"]
            )
        assert persisted_counts == live_counts

    def test_merged_decisions_from_clusters_helper(self):
        rng = random.Random(99)
        a, b = InMemoryCluster(), InMemoryCluster()
        _populate_cell(a, "a", rng)
        _populate_cell(b, "b", rng)
        merged = events_mod.merged_decisions_from_clusters({"a": a, "b": b})
        assert {d["cell"] for d in merged} == {"a", "b"}
        # cell-tagged rendering
        line = events_mod.format_decision_line(merged[0])
        assert merged[0]["cell"] + "/" in line

    def test_merge_orders_float_and_iso_timestamps_together(self):
        """A live log's epoch-float stamps and a persisted stream's ISO
        strings must interleave correctly (the live+offline mixed
        merge)."""
        live = [
            {
                "type": "NodeAdmitted",
                "reason": "fresh",
                "target": "n1",
                "seq": 1,
                "count": 1,
                "lastTimestamp": 1_700_000_100.0,
            }
        ]
        persisted = [
            {
                "type": "NodeDrained",
                "reason": "ok",
                "target": "n2",
                "seq": 1,
                "count": 1,
                "lastTimestamp": "2023-11-14T22:13:00Z",
            }
        ]
        merged = events_mod.merge_cell_streams(
            [("x", live), ("y", persisted)]
        )
        # 22:13:00 < 22:15:00 (the float renders to its ISO instant)
        assert [d["target"] for d in merged] == ["n2", "n1"]


# ------------------------------------------------ coordinator, both sides
JAX = dict(api=japi, federation=jfederation, metrics=jmetrics, cluster_cls=JInMemoryCluster,
           cache_cls=JInformerCache, events=jevents, state=jupgrade_state, harness=jharness)
PORT = dict(api=papi, federation=pfederation, metrics=metrics, cluster_cls=InMemoryCluster,
            cache_cls=InformerCache, events=events_mod, state=upgrade_state, harness=pharness)
CELLS = ("canary", "region", "global")
HOSTS = 3
EPOCH = 1_760_000_000.0
TICK_SECONDS = 15.0


def _cell_policy(api):
    """The cells' policy of ``tests/test_federation.py``: every node at
    once, drain forced, remediation armed but its own breaker out of
    reach (the federation's breaker is the one under test)."""
    return api.UpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=0, max_unavailable=api.IntOrString("100%"),
        drain_spec=api.DrainSpec(enable=True, force=True, timeout_second=10),
        remediation=api.RemediationSpec(failure_threshold=0.95, min_attempted=1000, auto_rollback=True,
                                        backoff_seconds=0.0))


class _HarnessCell:
    """One cell: its own cluster, a harness ``Fleet`` of *HOSTS* nodes at
    ``rev1`` (the coordinator publishes ``rev2`` on admission), and its
    own state machine with a persisted decision sink, as the JAX file's
    ``_Rig`` builds it on ``SimFleet``."""

    def __init__(self, pkg, name, bad=False):
        self.pkg, self.name = pkg, name
        self.store = pkg["cluster_cls"]()
        self.fleet = pkg["harness"].Fleet(self.store, revision_hash="rev1")
        for host in range(HOSTS):
            self.fleet.add_node(f"{name}-host{host}")
        if bad:
            self.fleet.bad_revisions.add("rev2")
        self.log = pkg["events"].DecisionEventLog()
        self.policy = _cell_policy(pkg["api"])
        self.manager = pkg["state"].ClusterUpgradeStateManager(
            self.store, cache=pkg["cache_cls"](self.store, lag_seconds=0.0), cache_sync_timeout_seconds=2.0,
            cache_sync_poll_seconds=0.005,
            decision_event_sink=pkg["events"].ClusterDecisionEventSink(self.store, namespace="default"))
        self.cell = pkg["federation"].Cell(
            name=name, cluster=self.store, namespace=pkg["harness"].NAMESPACE,
            selector=dict(pkg["harness"].DRIVER_LABELS), manager=self.manager, policy=self.policy, log=self.log)

    def reconcile(self):
        events = self.pkg["events"]
        previous = events.set_default_log(self.log)
        try:
            harness = self.pkg["harness"]
            self.manager.apply_state(self.manager.build_state(harness.NAMESPACE, harness.DRIVER_LABELS), self.policy)
            assert self.manager.drain_manager.wait_idle(10.0) and self.manager.pod_manager.wait_idle(10.0)
        finally:
            events.set_default_log(previous)
        self.fleet.reconcile_daemonset()


class _Federation:
    """One package's coordinator over its three harness cells."""

    def __init__(self, pkg, bad_cell=""):
        self.pkg = pkg
        self.cells = [_HarnessCell(pkg, name, bad=name == bad_cell) for name in CELLS]
        api = pkg["api"]
        spec = api.FederationPolicySpec(
            name="fleet", target_revision="rev2", cells=tuple(api.FederationCellSpec(name=n) for n in CELLS))
        self.coordinator = pkg["federation"].FederationCoordinator(spec, [c.cell for c in self.cells])

    def tick(self):
        status = self.coordinator.evaluate()
        for cell in self.cells:
            cell.reconcile()
        return status

    def close(self):
        for cell in self.cells:
            cell.manager.shutdown()


@pytest.fixture()
def federations(monkeypatch):
    """Both packages' federations, a fresh metrics registry each, at one
    pinned clock that :func:`_lockstep` advances; yields a function that
    builds the pair with *bad_cell*'s ``rev2`` broken."""
    clock = [EPOCH]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    registries = [m.set_default_registry(m.MetricsRegistry()) for m in (jmetrics, metrics)]
    made = []

    def build(bad_cell=""):
        made.extend((_Federation(JAX, bad_cell), _Federation(PORT, bad_cell)))
        return made[-2], made[-1], clock

    yield build
    for federation in made:
        federation.close()
    for m, registry in zip((jmetrics, metrics), registries):
        m.set_default_registry(registry)


def _objects(store):
    """The store's objects in the port's vocabulary, without uid and
    creation time (each store stamps its own), resourceVersion (the
    drain and eviction workers write in no fixed order) or a decision
    sink's random instance id, name-ordered."""
    out = []
    for obj in to_port_vocab(store.to_dict()["objects"]):
        meta = {k: v for k, v in obj["metadata"].items()
                if k not in ("uid", "creationTimestamp", "resourceVersion", "ownerReferences")}
        if "annotations" in meta:  # a decision sink's random instance id
            meta["annotations"] = {k: ("<src>" if k == events_mod.SRC_ANNOTATION else v)
                                   for k, v in meta["annotations"].items()}
        out.append({**obj, "metadata": meta})
    return sorted(out, key=lambda o: (o["kind"], o["metadata"].get("namespace", ""), o["metadata"]["name"]))


def _lockstep(jfed, pfed, clock, ticks, stop, start=0):
    """*ticks* coordinator ticks on both sides; after each, the status
    reports, the coordinators' own decision streams and every cell's
    cluster must agree.  Stops once *stop* holds for the port's status."""
    statuses = []
    for n in range(ticks):
        clock[0] = EPOCH + (start + n) * TICK_SECONDS
        jstatus, pstatus = jfed.tick(), pfed.tick()
        assert to_port_vocab(jstatus) == pstatus, f"tick {n}: the status reports differ"
        assert to_port_vocab(jfed.coordinator.log.export_stream()) == pfed.coordinator.log.export_stream(), (
            f"tick {n}: the coordinators' decisions differ")
        for jcell, pcell in zip(jfed.cells, pfed.cells):
            assert _objects(jcell.store) == _objects(pcell.store), f"tick {n}: cell {pcell.name} differs"
        statuses.append(pstatus)
        if stop(pstatus):
            break
    return statuses


class TestCoordinatorParity:
    def test_a_healthy_wave_promotes_every_cell_alike(self, federations):
        jfed, pfed, clock = federations()
        statuses = _lockstep(jfed, pfed, clock, 40, lambda s: s.get("promotedCells") == 3)
        final = statuses[-1]
        assert final["promotedCells"] == 3
        cells = {c["name"]: c for c in final["cells"]}
        assert cells["canary"]["promotedAt"] <= cells["region"]["admittedAt"]
        assert cells["region"]["promotedAt"] <= cells["global"]["admittedAt"]
        admitted = [d["target"] for d in pfed.coordinator.log.export_stream()
                    if d["type"] == events_mod.EVENT_CELL_ADMITTED]
        assert admitted == [pfederation.coordinator.cell_target(n) for n in CELLS]
        for cell in pfed.cells:
            assert set(cell.fleet.states().values()) == {"upgrade-done"}

    def test_a_bad_canary_trips_both_global_breakers_and_both_hold(self, federations):
        jfed, pfed, clock = federations(bad_cell="canary")

        def open_(status):
            return (status.get("breaker") or {}).get("state") == "open"

        statuses = _lockstep(jfed, pfed, clock, 40, open_)
        assert open_(statuses[-1]), statuses[-1]
        assert "canary" in statuses[-1]["breaker"]["breachedCells"]
        for m in (jmetrics, metrics):
            assert m.default_registry().counter(
                "federation_breaker_trips_total", "Global federation breaker trips.").value() == 1
        # held: the later cells are never admitted while the breaker is open
        n = len(statuses)
        held = _lockstep(jfed, pfed, clock, 6, lambda s: False, start=n)
        for status in held:
            assert open_(status)
            assert not [c for c in status["cells"] if c["name"] != "canary" and c.get("admittedAt")]
        for fed in (jfed, pfed):
            assert any(d["type"] == fed.pkg["events"].EVENT_BREAKER_TRIPPED
                       and d["reason"] == fed.pkg["events"].REASON_FEDERATION
                       for d in fed.coordinator.log.export_stream())
        for cell in pfed.cells[1:]:  # never published into
            assert set(cell.fleet.states().values()) <= {"", "upgrade-done"}
            pods = cell.store.list("Pod", namespace=pharness.NAMESPACE)
            assert {p["metadata"]["labels"]["controller-revision-hash"] for p in pods} == {"rev1"}
