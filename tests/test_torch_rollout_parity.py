"""The port's rollout analysis and in-place scheduler against the JAX
package's, on the same seeded fleets.

``RolloutStatus``, the SLO analytics, the canary census, the analysis and
remediation reports and one admission pass are pure over a
``ClusterUpgradeState`` snapshot (plus the cluster the admission writes
to).  Each case builds one fleet in the JAX package's
:class:`InMemoryCluster`: 24 or 64 nodes in 4-8 racks, random state labels
over every state (with no label and an unknown one), ``admitted-at`` /
``done-at`` stamps, flight-recorder timeline checkpoints, remediation
attempt and quarantine annotations, degraded hosts, LKG and breaker
records on the driver DaemonSet, and driver pods in and out of sync.  The
same objects go into the port's cluster through
``InMemoryCluster.from_dict(to_port_vocab(...))``.  Both packages then
build their snapshot the same way, under one policy with canary domains,
a maintenance window, an ``slos`` block, an ``analysis`` block and a
``remediation`` block, at one pinned clock, and every result must be
equal after :func:`test_torch_vocab.to_port_vocab`.

One test pins the first admission of the GPU fleet that
``chip_smoke.py`` 10g takes through a wave: 1,024 nodes in racks of 16,
every driver pod out of sync, under the fleet's policy (slice-aware, 16
parallel upgrades, 25 % unavailable).  Slots count racks there, so the
wave is 16 racks, 256 nodes, in both packages.

Then both packages' ``ClusterUpgradeStateManager`` take the same fleets
through the same reconcile passes, and the clusters, decision logs and
recorded events must agree after every pass: the seeded fleets in each
of the manager's modes (in place, through the state index, reading
through the informer cache, with the cascade, and in requestor mode
beside each package's ``SimMaintenanceOperator``), a wave with the
checkpoint gate, and a bad revision that trips the breaker.  Last,
``plan_rollout`` over each package's dump of the seeded fleets, in place
and in requestor mode, must give the same plan.
"""

import dataclasses
import datetime
import json
import random
import time
import types

import pytest

from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu import metrics as jmetrics
from k8s_operator_libs_tpu.api import (
    AnalysisSpec,
    AnalysisStepSpec,
    DrainSpec,
    IntOrString,
    MaintenanceWindowSpec,
    PreDrainCheckpointSpec,
    RemediationSpec,
    SloSpec,
    UpgradePolicySpec,
)
from k8s_operator_libs_tpu.cluster import InformerCache as JInformerCache
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JInMemoryCluster
from k8s_operator_libs_tpu.cluster import objects as jobjects
from k8s_operator_libs_tpu.cluster.selectors import labels_to_selector as jlabels_to_selector
from k8s_operator_libs_tpu.obs import events as jevents
from k8s_operator_libs_tpu.obs import slo as jslo
from k8s_operator_libs_tpu.tpu import health as jhealth
from k8s_operator_libs_tpu.tpu.drain_handshake import CheckpointDrainGate as JCheckpointDrainGate
from k8s_operator_libs_tpu.tpu.drain_handshake import DrainSignalWatcher as JDrainSignalWatcher
from k8s_operator_libs_tpu.upgrade import analysis as janalysis
from k8s_operator_libs_tpu.upgrade import common_manager as jcommon
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import cordon_manager as jcordon
from k8s_operator_libs_tpu.upgrade import drain_manager as jdrain
from k8s_operator_libs_tpu.upgrade import node_upgrade_state_provider as jprovider
from k8s_operator_libs_tpu.upgrade import plan as jplan
from k8s_operator_libs_tpu.upgrade import pod_manager as jpod
from k8s_operator_libs_tpu.upgrade import remediation as jremediation
from k8s_operator_libs_tpu.upgrade import rollout_status as jrollout
from k8s_operator_libs_tpu.upgrade import safe_driver_load_manager as jsafe
from k8s_operator_libs_tpu.upgrade import schedule as jschedule
from k8s_operator_libs_tpu.upgrade import timeline as jtimeline
from k8s_operator_libs_tpu.upgrade import upgrade_inplace as jinplace
from k8s_operator_libs_tpu.upgrade import upgrade_requestor as jrequestor
from k8s_operator_libs_tpu.upgrade import upgrade_state as jupgrade_state
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu.upgrade import validation_manager as jvalidation
from k8s_operator_libs_tpu_torch import api, metrics
from k8s_operator_libs_tpu_torch.api import UpgradePolicySpec as PortUpgradePolicySpec
from k8s_operator_libs_tpu_torch.cluster import InformerCache, InMemoryCluster, objects
from k8s_operator_libs_tpu_torch.cluster.selectors import labels_to_selector
from k8s_operator_libs_tpu_torch.obs import events
from k8s_operator_libs_tpu_torch.obs import slo
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import CheckpointDrainGate, DrainSignalWatcher
from k8s_operator_libs_tpu_torch.upgrade import analysis
from k8s_operator_libs_tpu_torch.upgrade import common_manager
from k8s_operator_libs_tpu_torch.upgrade import consts
from k8s_operator_libs_tpu_torch.upgrade import cordon_manager
from k8s_operator_libs_tpu_torch.upgrade import drain_manager
from k8s_operator_libs_tpu_torch.upgrade import node_upgrade_state_provider
from k8s_operator_libs_tpu_torch.upgrade import plan
from k8s_operator_libs_tpu_torch.upgrade import pod_manager
from k8s_operator_libs_tpu_torch.upgrade import remediation
from k8s_operator_libs_tpu_torch.upgrade import rollout_status
from k8s_operator_libs_tpu_torch.upgrade import safe_driver_load_manager
from k8s_operator_libs_tpu_torch.upgrade import schedule
from k8s_operator_libs_tpu_torch.upgrade import timeline
from k8s_operator_libs_tpu_torch.upgrade import upgrade_inplace
from k8s_operator_libs_tpu_torch.upgrade import upgrade_requestor
from k8s_operator_libs_tpu_torch.upgrade import upgrade_state
from k8s_operator_libs_tpu_torch.upgrade import util
from k8s_operator_libs_tpu_torch.upgrade import validation_manager

import chip_smoke
from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

JAX = types.SimpleNamespace(
    api=japi, objects=jobjects, cluster_cls=JInMemoryCluster, cache_cls=JInformerCache, selector=jlabels_to_selector,
    util=jutil, consts=jconsts, common=jcommon, provider=jprovider, cordon=jcordon, drain=jdrain,
    pod=jpod, validation=jvalidation, safe=jsafe, inplace=jinplace, rollout=jrollout, slo=jslo,
    analysis=janalysis, remediation=jremediation, timeline=jtimeline, events=jevents,
    metrics=jmetrics, schedule=jschedule, state=jupgrade_state, requestor=jrequestor, plan=jplan,
)
PORT = types.SimpleNamespace(
    api=api, objects=objects, cluster_cls=InMemoryCluster, cache_cls=InformerCache, selector=labels_to_selector,
    util=util, consts=consts, common=common_manager, provider=node_upgrade_state_provider,
    cordon=cordon_manager, drain=drain_manager, pod=pod_manager, validation=validation_manager,
    safe=safe_driver_load_manager, inplace=upgrade_inplace, rollout=rollout_status, slo=slo,
    analysis=analysis, remediation=remediation, timeline=timeline, events=events,
    metrics=metrics, schedule=schedule, state=upgrade_state, requestor=upgrade_requestor, plan=plan,
)

NS = "ops"
DRIVER_LABELS = {"app": "driver"}
#: the pinned clock (2025-10-09T08:53Z); each seed moves it by 7 hours,
#: so the maintenance window (06:00-02:00 UTC) is open for seeds 0-2 and
#: closed for seed 3
EPOCH = 1_760_000_000.0
STATES = list(jconsts.ALL_STATES) + [jconsts.UPGRADE_STATE_UNKNOWN, "bogus-state"]
CASES = [(seed, n) for seed in range(4) for n in (24, 64)]


def _ids(case):
    return f"seed{case[0]}-n{case[1]}"


def policy_for(seed: int, racks: int) -> UpgradePolicySpec:
    """One policy with every gate the analysis reads: canary domains
    with a bake window, a maintenance window, pacing, SLO targets, two
    analysis steps and a remediation block, slice-aware.  The canary
    stage and the parallel budget differ by seed: two units, none, more
    units than the fleet holds, one; 3, 1, 2 and unlimited upgrades."""
    return UpgradePolicySpec(
        auto_upgrade=True,
        max_parallel_upgrades=(3, 1, 2, 0)[seed % 4],
        max_unavailable=IntOrString("50%"),
        slice_aware=True,
        quarantine_degraded=True,
        canary_domains=(2, 0, 10, 1)[seed % 4],
        canary_soak_seconds=600.0,
        max_nodes_per_hour=40,
        maintenance_window=MaintenanceWindowSpec(start="06:00", duration_minutes=1200),
        drain_spec=DrainSpec(enable=True, force=True),
        pre_drain_checkpoint=PreDrainCheckpointSpec(enable=True),
        slos=SloSpec(max_node_phase_seconds=1800, drain_p99_seconds=600,
                     fleet_completion_deadline_seconds=7200),
        analysis=AnalysisSpec(steps=(
            AnalysisStepSpec(name="canary-soak", max_exposure=IntOrString(max(1, racks // 2)),
                             advance_on=("breaches == 0 for 0s",)),
            AnalysisStepSpec(name="fleet", abort_on=("burn:fleetCompletionDeadlineSeconds >= 5 for 0s",)),
        )),
        remediation=RemediationSpec(failure_threshold=0.5, min_attempted=3, max_node_attempts=2,
                                    backoff_seconds=0.0),
    )


def _timeline_checkpoint(rng, node, final_state, now):
    """A flight-recorder checkpoint for *node*: a random walk through the
    lifecycle ending in *final_state*, in the JAX package's recorder."""
    recorder = jtimeline.FlightRecorder()
    path = ([jconsts.UPGRADE_STATE_UPGRADE_REQUIRED, jconsts.UPGRADE_STATE_CORDON_REQUIRED,
             jconsts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED, jconsts.UPGRADE_STATE_DRAIN_REQUIRED,
             jconsts.UPGRADE_STATE_POD_RESTART_REQUIRED, jconsts.UPGRADE_STATE_UNCORDON_REQUIRED])
    steps = path[: rng.randrange(1, len(path) + 1)] + [final_state]
    t = now - rng.uniform(600.0, 7200.0)
    ckpt = None
    for state in steps:
        ckpt = recorder.transition(node, state, now=t)
        t = min(now, t + rng.expovariate(1 / 120.0))
    return ckpt


def build_jax_fleet(seed: int, n: int, now: float):
    """The seeded fleet in the JAX package's cluster; returns (cluster, racks)."""
    rng = random.Random(seed * 1000 + n)
    racks = rng.randint(4, 8)
    cluster = JInMemoryCluster()
    ds = jobjects.make_daemonset("driver", NS, DRIVER_LABELS, desired_number_scheduled=n)
    ds["metadata"]["annotations"] = {
        jutil.get_last_known_good_annotation_key(): json.dumps({"lkg": "rev1", "target": "rev2"}),
        jutil.get_breaker_annotation_key(): json.dumps(
            {"state": rng.choice(["closed", "open"]), "target": "rev2", "failures": rng.randrange(4)}),
    }
    ds = cluster.create(ds)
    cluster.create(jobjects.make_controller_revision(ds, 1, "rev1"))
    cluster.create(jobjects.make_controller_revision(ds, 2, "rev2"))
    state_key = jutil.get_upgrade_state_label_key()
    active = set(jconsts.ACTIVE_STATES)
    # each rack is waiting, done, never labelled, or mid-flight, so that
    # fresh domains compete for slots beside active ones
    modes = [rng.choice(("pending", "pending", "done", "fresh", "mixed")) for _ in range(racks)]
    for i in range(n):
        name = f"node-{i:03d}"
        mode = modes[i % racks]
        state = {
            "pending": jconsts.UPGRADE_STATE_UPGRADE_REQUIRED,
            "done": jconsts.UPGRADE_STATE_DONE,
            "fresh": jconsts.UPGRADE_STATE_UNKNOWN,
        }.get(mode) or rng.choice(STATES)
        if i < 2:  # every fleet holds an unknown state label and a node without one
            state = ("bogus-state", jconsts.UPGRADE_STATE_UNKNOWN)[i]
        rack = f"rack-{i % racks}"
        labels = {jconsts.SLICE_ID_LABEL_KEYS[0]: rack}
        if state:
            labels[state_key] = state
        if rng.random() < 0.06:
            labels[jhealth.DEGRADED_LABEL_KEYS[rng.randrange(2)]] = "true"
        annotations = {}
        if (state in active or state == jconsts.UPGRADE_STATE_DONE) and rng.random() < 0.7:
            annotations[jutil.get_admitted_at_annotation_key()] = f"{now - rng.uniform(0, 5400):.3f}"
        elif rng.random() < 0.1:  # a stamp left by an earlier generation
            annotations[jutil.get_admitted_at_annotation_key()] = f"{now - rng.uniform(0, 9000):.3f}"
        if state == jconsts.UPGRADE_STATE_DONE and rng.random() < 0.8:
            annotations[jutil.get_done_at_annotation_key()] = f"{now - rng.uniform(0, 1800):.3f}"
        if rng.random() < 0.2:
            annotations[jutil.get_attempt_count_annotation_key()] = str(rng.randrange(1, 4))
            annotations[jutil.get_last_failure_at_annotation_key()] = f"{now - rng.uniform(0, 900):.3f}"
            annotations[jutil.get_failure_target_annotation_key()] = "rev2"
        if rng.random() < 0.06:
            annotations[jutil.get_quarantine_annotation_key()] = rng.choice(
                [f"{jconsts.REMEDIATION_QUARANTINE_PREFIX}{rack}", rack])
        node = jobjects.make_node(name, labels=labels, annotations=annotations,
                                  unschedulable=state in active and rng.random() < 0.8,
                                  ready=rng.random() > 0.02)
        if rng.random() < 0.7:
            node["metadata"]["annotations"][jutil.get_timeline_annotation_key()] = _timeline_checkpoint(
                rng, node, state if state in jconsts.ALL_STATES else jconsts.UPGRADE_STATE_UPGRADE_REQUIRED,
                now)
        cluster.create(node)
        cluster.create(jobjects.make_pod(
            f"driver-{i:03d}", NS, name, labels=dict(DRIVER_LABELS), owner=ds,
            revision_hash=rng.choice(["rev1", "rev2"]), ready=rng.random() > 0.1,
            restart_count=rng.choice([0, 0, 0, 12]),
        ))
    return cluster, racks


def state_manager(pkg, cluster, gate=None, workers=0, **modes):
    """*pkg*'s ``ClusterUpgradeStateManager`` on *cluster*, with its own
    informer cache, event recorder, flight recorder and pre-drain *gate*,
    *workers* write-pipeline workers, and the manager's own *modes*
    (``use_state_index``, ``reads_from_cache``, ``cascade``)."""
    return pkg.state.ClusterUpgradeStateManager(
        cluster, cache=pkg.cache_cls(cluster, lag_seconds=0.0), recorder=pkg.util.EventRecorder(),
        pre_drain_gate=gate, write_pipeline_workers=workers, cache_sync_timeout_seconds=2.0,
        cache_sync_poll_seconds=0.01, flight_recorder=pkg.timeline.FlightRecorder(), **modes)


def requestor_opts(pkg):
    """Requestor mode's options in *pkg*: the NodeMaintenance handoff,
    its objects in the fleet's namespace."""
    return pkg.requestor.RequestorOptions(use_maintenance_operator=True, requestor_id="parity-operator",
                                          requestor_namespace=NS)


class Side:
    """One package's half of a case: its cluster, policy, state machine and
    the snapshot that machine builds (its BuildState also restores every
    node's timeline into its flight recorder).  With *requestor*, the
    machine hands nodes to its package's ``SimMaintenanceOperator``
    through NodeMaintenance objects, as ``tests/test_upgrade_requestor.py``
    assembles it."""

    def __init__(self, pkg, cluster, policy, now, requestor=False, **manager_kwargs):
        self.pkg, self.cluster, self.policy, self.now = pkg, cluster, policy, now
        self.manager = state_manager(pkg, cluster, **manager_kwargs)
        self.maintenance, self.handed_over = None, set()
        if requestor:
            self.manager.with_requestor(
                pkg.requestor.RequestorNodeStateManager(self.manager.common, requestor_opts(pkg)), enabled=True)
            self.maintenance = pkg.plan.SimMaintenanceOperator(cluster, namespace=NS)
        self.state = self.manager.build_state(NS, DRIVER_LABELS)
        self.recorder = self.manager.flight_recorder


@pytest.fixture()
def pinned_clock(monkeypatch):
    """Pins ``time.time`` and both packages' schedule clocks to one
    instant, which the test sets with the returned function; gives both
    packages a fresh metrics registry and the JAX package a fresh
    decision log (``port_globals`` gives the port its own)."""

    def pin(ts):
        when = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        monkeypatch.setattr(time, "time", lambda: ts)
        for mod in (jschedule, schedule):
            monkeypatch.setattr(mod, "_now_utc", lambda: when)
        return ts

    registries = [pkg.metrics.set_default_registry(pkg.metrics.MetricsRegistry()) for pkg in (JAX, PORT)]
    previous_log = jevents.set_default_log(jevents.DecisionEventLog())
    yield pin
    jevents.set_default_log(previous_log)
    for pkg, registry in zip((JAX, PORT), registries):
        pkg.metrics.set_default_registry(registry)


#: the state machine's modes the pass-by-pass test runs in, each as the
#: keyword arguments of :class:`Side`
MODES = {
    "inplace": {},
    "index": {"use_state_index": True},
    "cache": {"reads_from_cache": True},
    "cascade": {"cascade": True},
    "requestor": {"requestor": True},
}


@pytest.fixture(params=CASES, ids=_ids)
def sides(request, pinned_clock):
    """The seeded case's two sides; a test may parametrise it indirectly
    with (seed, n, mode), *mode* a key of :data:`MODES`."""
    seed, n, mode = (*request.param, "inplace")[:3]
    now = pinned_clock(EPOCH + seed * 7 * 3600.0)
    jcluster, racks = build_jax_fleet(seed, n, now)
    pcluster = InMemoryCluster.from_dict(to_port_vocab(jcluster.to_dict()))
    jpolicy = policy_for(seed, racks)
    jside = Side(JAX, jcluster, jpolicy, now, **MODES[mode])
    pside = Side(PORT, pcluster, port_policy(jpolicy), now, **MODES[mode])
    yield jside, pside
    jside.manager.shutdown()
    pside.manager.shutdown()


def port_policy(jpolicy):
    """*jpolicy*, validated, in the port's vocabulary and classes."""
    jpolicy.validate()
    ppolicy = PortUpgradePolicySpec.from_dict(to_port_vocab(jpolicy.to_dict()))
    assert to_port_vocab(jpolicy.to_dict()) == ppolicy.to_dict()
    return ppolicy


def _plain(obj):
    """A comparable JSON tree: dataclasses to dicts, sets to sorted lists."""
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_plain(v) for v in obj)
    return obj


def agree(jax_value, port_value):
    assert to_port_vocab(_plain(jax_value)) == _plain(port_value)


def test_the_snapshots_hold_the_same_fleet(sides):
    jside, pside = sides
    jbuckets = {k: [ns.node["metadata"]["name"] for ns in v] for k, v in jside.state.node_states.items()}
    pbuckets = {k: [ns.node["metadata"]["name"] for ns in v] for k, v in pside.state.node_states.items()}
    assert jbuckets == pbuckets
    assert {"bogus-state", jconsts.UPGRADE_STATE_UNKNOWN} <= set(jbuckets)


def test_bucket_census_and_rollout_status(sides):
    jside, pside = sides
    census = pside.pkg.rollout.bucket_census(pside.state)
    agree(jside.pkg.rollout.bucket_census(jside.state), census)
    assert census["done"] + census["inProgress"] + census["pending"] + census["unknown"] == census["total"]
    for policy_of in (lambda s: None, lambda s: s.policy):
        jstatus = jside.pkg.rollout.RolloutStatus.from_cluster_state(jside.state, policy_of(jside))
        pstatus = pside.pkg.rollout.RolloutStatus.from_cluster_state(pside.state, policy_of(pside))
        agree(jstatus.to_dict(), pstatus.to_dict())
        assert to_port_vocab(jstatus.render()) == pstatus.render()
        assert pstatus.done + pstatus.in_progress + pstatus.pending + pstatus.unknown == pstatus.total_nodes
    want = {"maintenanceWindow", "remediation", "analysis", "pacing"} | ({"canary"} if pside.policy.canary_domains else set())
    assert {g.gate for g in pstatus.gates} == want


def test_canary_census_budget_and_quarantine(sides):
    jside, pside = sides
    for side in sides:
        side.results = (
            side.pkg.inplace.canary_census(side.state, side.policy),
            side.pkg.inplace.canary_census(side.state, side.policy, now=side.now + 900.0),
            side.pkg.inplace.canary_budget(side.state, side.policy),
            side.pkg.inplace.quarantined_domains(side.state, side.policy),
        )
    agree(jside.results, pside.results)


def test_slo_analytics(sides):
    jside, pside = sides
    for side in sides:
        s, tls = side.pkg.slo, side.recorder.timelines()
        counts = s.SloEngine.counts_from_state(side.state)
        started = s.rollout_started_estimate(tls)
        report = s.analyze(tls, counts, now=side.now, straggler_factor=side.policy.slos.straggler_factor,
                           since=started)
        stats = s.phase_stats(tls)
        side.results = (
            tls, counts, started, report, stats,
            s.find_stragglers(tls, stats, side.now, factor=1.0, min_samples=1),
            s.evaluate_slos(report, tls, side.policy.slos, side.now, started),
            s.SloEngine(side.recorder).evaluate(side.state, side.policy, now=side.now),
        )
    agree(jside.results, pside.results)
    assert to_port_vocab(jside.pkg.slo.render_report(jside.results[-1])) == (
        pside.pkg.slo.render_report(pside.results[-1]))


def test_analysis_report_and_gate(sides):
    jside, pside = sides
    for side in sides:
        slo_report = side.pkg.slo.SloEngine(side.recorder).evaluate(side.state, side.policy, now=side.now)
        report = side.pkg.analysis.analysis_report(side.state, side.policy, slo_report, now=side.now)
        pending = len(side.state.nodes_in(side.pkg.consts.UPGRADE_STATE_UPGRADE_REQUIRED))
        side.results = (
            report, side.pkg.analysis.gate_from_report(report, pending),
            side.pkg.analysis.exposure_census(side.state, side.policy),
            side.pkg.analysis.analysis_report(side.state, side.policy, None, now=side.now),
        )
    agree(jside.results, pside.results)
    assert to_port_vocab(jside.pkg.analysis.render_report(jside.results[0])) == (
        pside.pkg.analysis.render_report(pside.results[0]))


def test_remediation_report(sides):
    jside, pside = sides
    for side in sides:
        side.results = [side.pkg.remediation.remediation_report(side.state, policy)
                        for policy in (None, side.policy)]
    agree(jside.results, pside.results)
    assert to_port_vocab(jside.pkg.remediation.render_report(jside.results[1])) == (
        pside.pkg.remediation.render_report(pside.results[1]))


def _decisions(pkg):
    return [{k: e[k] for k in ("type", "reason", "target", "message", "count")}
            for e in pkg.events.default_log().events()]


def _masked(cluster):
    """The cluster's objects, name-ordered, without the store's uid and
    creation time (each store stamps its own)."""
    objects = []
    for obj in cluster.to_dict()["objects"]:
        meta = dict(obj["metadata"])
        meta.pop("uid", None)
        meta.pop("creationTimestamp", None)
        meta.pop("ownerReferences", None)
        objects.append({**obj, "metadata": meta})
    return sorted(objects, key=lambda o: (o["kind"], o["metadata"].get("namespace", ""), o["metadata"]["name"]))


def admission_pass(side):
    """One pass of the state machine's gates and admission, in its order:
    SLO evaluation, remediation, analysis, then the in-place scheduler's
    ``process_upgrade_required_nodes``.  Returns what each decided."""
    common = side.manager.common
    slo_engine = side.pkg.slo.SloEngine(side.recorder)
    slo_report = slo_engine.evaluate(side.state, side.policy, now=side.now)
    decision = side.pkg.remediation.RemediationManager(side.cluster, side.manager.provider).evaluate(
        side.state, side.policy, common, now=side.now)
    verdict = side.pkg.analysis.AnalysisEngine(history=slo_engine.history).evaluate(
        side.state, side.policy, slo_report, common=common, remediation=decision)
    before = {ns.node["metadata"]["name"] for ns in side.state.nodes_in(
        side.pkg.consts.UPGRADE_STATE_UPGRADE_REQUIRED)}
    slice_total = side.pkg.inplace.topology.count_domains(ns.node for ns in side.state.all_node_states())
    available = common.get_upgrades_available(
        side.state, side.policy.max_parallel_upgrades,
        side.policy.max_unavailable.scaled_value(slice_total, round_up=True), slice_aware=True)
    side.manager.inplace.process_upgrade_required_nodes(side.state, side.policy, decision, verdict)
    key = side.pkg.util.get_upgrade_state_label_key()
    admitted = sorted(n["metadata"]["name"] for n in side.cluster.list("Node")
                      if n["metadata"]["name"] in before
                      and n["metadata"]["labels"].get(key) == side.pkg.consts.UPGRADE_STATE_CORDON_REQUIRED)
    return {
        "available": available, "slo": slo_report, "remediation": decision.to_dict(),
        "analysis": {k: v for k, v in _plain(verdict).items()}, "admitted": admitted,
        "decisions": _decisions(side.pkg), "cluster": _masked(side.cluster),
    }


def test_one_admission_pass(sides):
    jside, pside = sides
    jout, pout = admission_pass(jside), admission_pass(pside)
    for key in jout:
        assert to_port_vocab(_plain(jout[key])) == _plain(pout[key]), key
    # the pass admitted or deferred every pending node with a reason
    types_ = {d["type"] for d in pout["decisions"]}
    assert pout["admitted"] or "NodeDeferred" in types_ or not pside.state.nodes_in(
        consts.UPGRADE_STATE_UPGRADE_REQUIRED)


FLEET_NODES, FLEET_RACK = 1024, 16


def fleet_wave(pkg):
    """The GPU fleet of ``chip_smoke.py`` 10a after one pass has marked
    every out-of-sync node ``upgrade-required``: its first admission under
    the fleet's policy.  Returns (admitted names, decisions)."""
    cluster, make = pkg.cluster_cls(), pkg.objects
    ds = cluster.create(make.make_daemonset("driver", NS, DRIVER_LABELS, desired_number_scheduled=FLEET_NODES))
    cluster.create(make.make_controller_revision(ds, 1, "rev1"))
    cluster.create(make.make_controller_revision(ds, 2, "rev2"))
    key = pkg.util.get_upgrade_state_label_key()
    for i in range(FLEET_NODES):
        cluster.create(make.make_node(f"node-{i:04d}", labels={
            pkg.consts.SLICE_ID_LABEL_KEYS[0]: f"rack-{i // FLEET_RACK:02d}",
            key: pkg.consts.UPGRADE_STATE_UPGRADE_REQUIRED}))
        cluster.create(make.make_pod(f"driver-{i:04d}", NS, f"node-{i:04d}", labels=dict(DRIVER_LABELS),
                                     owner=ds, revision_hash="rev1"))
    api = pkg.api
    policy = api.UpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=FLEET_RACK, max_unavailable=api.IntOrString("25%"),
        drain_spec=api.DrainSpec(enable=True), slice_aware=True,
        pre_drain_checkpoint=api.PreDrainCheckpointSpec(enable=True))
    manager = state_manager(pkg, cluster)
    try:
        manager.inplace.process_upgrade_required_nodes(manager.build_state(NS, DRIVER_LABELS), policy)
    finally:
        manager.shutdown()
    admitted = sorted(n["metadata"]["name"] for n in cluster.list("Node")
                      if n["metadata"]["labels"].get(key) == pkg.consts.UPGRADE_STATE_CORDON_REQUIRED)
    return admitted, _decisions(pkg)


def test_the_gpu_fleet_first_wave_is_sixteen_racks(pinned_clock):
    pinned_clock(EPOCH)
    jadmitted, jdecisions = fleet_wave(JAX)
    padmitted, pdecisions = fleet_wave(PORT)
    assert jadmitted == padmitted
    assert to_port_vocab(jdecisions) == pdecisions
    assert len(padmitted) == FLEET_RACK * FLEET_RACK  # 16 racks of 16
    assert padmitted == [f"node-{i:04d}" for i in range(FLEET_RACK * FLEET_RACK)]
    assert sum(d["count"] for d in pdecisions if d["type"] == "NodeDeferred") == FLEET_NODES - len(padmitted)


# -------------------------------------------------------- pass after pass
#
# The JAX package's ClusterUpgradeStateManager and the port's take the
# same cluster through the same reconcile passes: BuildState, ApplyState, the drains and pod restarts
# in flight awaited, then the DaemonSet controller played on both sides.
# After every pass the two clusters, decision logs and event recorders
# must agree.  The decisions and events are compared as sorted lists:
# the drain and pod-restart workers emit theirs from a pool, in no fixed
# order.

#: a reconcile pass every 5 minutes of the pinned clock, so soak windows,
#: backoffs and pacing budgets run out as they would
PASS_SECONDS = 300.0


def _masked_stable(cluster):
    """:func:`_masked` without the resourceVersion either: writes from
    the worker pools land in no fixed order."""
    objects = _masked(cluster)
    for obj in objects:
        obj["metadata"] = {k: v for k, v in obj["metadata"].items() if k != "resourceVersion"}
    return objects


def ds_controller(pkg, cluster, nodes, bad=None):
    """The DaemonSet controller: a driver pod at the newest revision for
    each of *nodes* that has none (named by node and a counter, so both
    packages name them alike).  A pod at revision *bad* never becomes
    Ready and has restarted 11 times."""
    ds = cluster.get("DaemonSet", "driver", NS)
    newest = max(cluster.list("ControllerRevision", namespace=NS), key=lambda c: c.get("revision", 0))
    revision = newest["metadata"]["labels"][pkg.objects.CONTROLLER_REVISION_HASH_LABEL]
    covered = {p["spec"]["nodeName"] for p in cluster.list("Pod", namespace=NS, label_selector=pkg.selector(DRIVER_LABELS))}
    for node in nodes:
        if node not in covered:
            count = len(cluster.list("Pod", namespace=NS))
            cluster.create(pkg.objects.make_pod(
                f"driver-{node}-{revision}-{count}", NS, node, labels=dict(DRIVER_LABELS), owner=ds,
                revision_hash=revision, ready=revision != bad, restart_count=11 if revision == bad else 0))


def one_pass(side, nodes, bad=None):
    manager = side.manager
    manager.apply_state(manager.build_state(NS, DRIVER_LABELS), side.policy)
    assert manager.drain_manager.wait_idle(30.0) and manager.pod_manager.wait_idle(30.0)
    if side.maintenance is not None:
        side.handed_over |= {nm["spec"]["nodeName"] for nm in side.cluster.list("NodeMaintenance", namespace=NS)}
        side.maintenance.reconcile()
    ds_controller(side.pkg, side.cluster, nodes, bad)


def _recorded(manager):
    return [dataclasses.astuple(e) for e in manager._recorder.events]


def run_passes(pin, jside, pside, max_passes, bad=None, done=None):
    """Passes on both sides until *done* (a predicate on the port's side)
    holds, or the port's cluster is unchanged by two passes running;
    every pass must leave both sides equal.  Returns the passes run."""
    nodes = sorted(n["metadata"]["name"] for n in pside.cluster.list("Node"))
    still = 0
    before = _masked_stable(pside.cluster)
    for n in range(max_passes):
        pin(jside.now + n * PASS_SECONDS)
        for side in (jside, pside):
            one_pass(side, nodes, bad)
        after = _masked_stable(pside.cluster)
        assert to_port_vocab(_masked_stable(jside.cluster)) == after, f"pass {n}: the clusters differ"
        assert sorted(to_port_vocab(_decisions(JAX)), key=json.dumps) == sorted(
            _decisions(PORT), key=json.dumps), f"pass {n}: the decision logs differ"
        assert sorted(to_port_vocab(_recorded(jside.manager))) == sorted(_recorded(pside.manager)), (
            f"pass {n}: the recorded events differ")
        if done is not None and done(pside):
            return n + 1
        still = still + 1 if after == before else 0
        before = after
        if done is None and still == 2:
            return n + 1
    assert done is None, f"not done after {max_passes} passes"
    return max_passes


def _labels(side):
    key = side.pkg.util.get_upgrade_state_label_key()
    return {n["metadata"]["name"]: n["metadata"]["labels"].get(key) for n in side.cluster.list("Node")}


PASS_CASES = [case + (mode,) for mode in MODES for case in CASES]


def _pass_ids(case):
    return _ids(case) + ("" if case[2] == "inplace" else f"-{case[2]}")


@pytest.mark.parametrize("sides", PASS_CASES, indirect=True, ids=_pass_ids)
def test_the_state_machines_agree_pass_by_pass(sides, pinned_clock):
    """The seeded fleets, every state and stamp among them, pass after
    pass until they settle: admission, cordon, drain, pod restarts
    (rev2 published), failures, retries and quarantine alike; in place,
    through the state index, reading through the informer cache, with
    the cascade, and in requestor mode (the NodeMaintenance objects are
    part of the compared cluster)."""
    jside, pside = sides
    passes = run_passes(pinned_clock, jside, pside, max_passes=30)
    assert passes < 30
    assert set(_labels(pside).values()) - {None, "bogus-state"} <= set(consts.ALL_STATES)
    if pside.maintenance is not None:  # every node admitted was handed over
        admitted = any(d["type"] == "NodeAdmitted" for d in _decisions(PORT))
        assert bool(pside.handed_over) == admitted


@pytest.mark.parametrize("mode", ["inplace", "requestor"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_plans_agree(case, mode, pinned_clock):
    """``plan_rollout`` over each package's dump of the seeded fleet, in
    place and in requestor mode: the same plan, transition by
    transition, and the same next admissions."""
    seed, n = case
    now = pinned_clock(EPOCH + seed * 7 * 3600.0)
    jcluster, racks = build_jax_fleet(seed, n, now)
    pcluster = InMemoryCluster.from_dict(to_port_vocab(jcluster.to_dict()))
    jpolicy = policy_for(seed, racks)
    plans = []
    for pkg, cluster, policy in ((JAX, jcluster, jpolicy), (PORT, pcluster, port_policy(jpolicy))):
        opts = requestor_opts(pkg) if mode == "requestor" else None
        plans.append(pkg.plan.plan_rollout(cluster.to_dict(), NS, DRIVER_LABELS, policy, requestor_opts=opts))
    jplan_, pplan = plans
    assert to_port_vocab(jplan_.to_dict()) == pplan.to_dict()
    assert jplan_.next_admissions == pplan.next_admissions
    assert to_port_vocab(jplan_.render()) == pplan.render()
    assert pplan.cycles_simulated >= 1


WAVE_RACKS, WAVE_RACK = 4, 16


def clean_fleet(pkg, revisions=("rev1", "rev2")):
    """The fleet of ``chip_smoke.py`` 10g, cut to *WAVE_RACKS* racks: every
    node fresh, with one pod of a Job (a drain must evict it) and a driver
    pod at the first of *revisions*, every revision published."""
    cluster, make = pkg.cluster_cls(), pkg.objects
    ds = cluster.create(make.make_daemonset("driver", NS, DRIVER_LABELS,
                                            desired_number_scheduled=WAVE_RACKS * WAVE_RACK))
    for i, revision in enumerate(revisions):
        cluster.create(make.make_controller_revision(ds, i + 1, revision))
    for i in range(WAVE_RACKS * WAVE_RACK):
        node = f"node-{i:03d}"
        cluster.create(make.make_node(node, labels={pkg.consts.SLICE_ID_LABEL_KEYS[0]: f"rack-{i // WAVE_RACK}"}))
        cluster.create(make.make_pod(f"driver-{node}", NS, node, labels=dict(DRIVER_LABELS), owner=ds,
                                     revision_hash=revisions[0]))
        job = {"kind": "Job", "metadata": {"name": f"train-{i:03d}", "namespace": "ml"}}
        cluster.create(make.make_pod(f"train-{i:03d}", "ml", node, labels={"job-name": f"train-{i:03d}"},
                                     owner=job))
    return cluster


def wave_policy_for(pkg):
    """``chip_smoke.py``'s wave policy in *pkg*'s vocabulary: slice-aware,
    16 parallel upgrades, 25 % of the racks unavailable, drain with the
    pre-drain checkpoint, and the wave's SLO and remediation blocks."""
    api = pkg.api
    spec = api.UpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=WAVE_RACK, max_unavailable=api.IntOrString("25%"),
        drain_spec=api.DrainSpec(enable=True), slice_aware=True,
        pre_drain_checkpoint=api.PreDrainCheckpointSpec(enable=True, timeout_second=20)).to_dict()
    return api.UpgradePolicySpec.from_dict({**spec, "slos": chip_smoke.WAVE_SLOS,
                                            "remediation": chip_smoke.WAVE_REMEDIATION})


@pytest.mark.parametrize("workers", [0, 16], ids=["sequential", "pipelined"])
def test_a_wave_with_the_checkpoint_gate_agrees_pass_by_pass(workers, pinned_clock):
    """``chip_smoke.py`` 10g's path on a cut fleet: each package's
    ``CheckpointDrainGate`` before each drain, every node's workload
    answering it, rack after rack through cordon, wait-for-jobs, drain with
    eviction, pod restart, validation and uncordon to done."""
    now = pinned_clock(EPOCH)
    sides, workloads = [], []
    for pkg, watcher_cls, gate_cls in ((JAX, JDrainSignalWatcher, JCheckpointDrainGate),
                                       (PORT, DrainSignalWatcher, CheckpointDrainGate)):
        cluster, policy = clean_fleet(pkg), wave_policy_for(pkg)
        policy.validate()
        gate = gate_cls(cluster, policy.pre_drain_checkpoint, poll_seconds=0.005)
        sides.append(Side(pkg, cluster, policy, now, gate=gate, workers=workers))
        workloads.append(chip_smoke._RackWorkloads(cluster, watcher_cls=watcher_cls))
        workloads[-1].watch([n["metadata"]["name"] for n in cluster.list("Node")])
    jside, pside = sides
    assert to_port_vocab(jside.policy.to_dict()) == pside.policy.to_dict()

    def done(side):
        return set(_labels(side).values()) == {consts.UPGRADE_STATE_DONE}

    try:
        passes = run_passes(pinned_clock, jside, pside, max_passes=60, done=done)
    finally:
        for side, workload in zip(sides, workloads):
            workload.close()
            side.manager.shutdown()
    nodes = WAVE_RACKS * WAVE_RACK
    assert [w.acks for w in workloads] == [nodes, nodes]
    assert not pside.cluster.list("Pod", namespace="ml")  # every Job pod evicted
    assert {p["metadata"]["labels"]["controller-revision-hash"] for p in pside.cluster.list("Pod", namespace=NS)} == {
        "rev2"}
    assert not any(n["spec"].get("unschedulable") for n in pside.cluster.list("Node"))
    admitted = [d for d in _decisions(PORT) if d["type"] == "NodeAdmitted"]
    assert sum(d["count"] for d in admitted) == nodes
    assert passes < 60


def test_a_bad_revision_trips_the_breaker_and_rolls_back_alike(pinned_clock):
    """The remediation selftest's story on the fleet: a healthy era on
    ``good``, then ``bad`` published, whose pods never become Ready.  The
    failures fill the budget, the breaker trips, auto-rollback restores
    ``good``, and the retries take every node back to done on it."""
    now = pinned_clock(EPOCH)
    sides = []
    for pkg in (JAX, PORT):
        api = pkg.api
        policy = api.UpgradePolicySpec(
            auto_upgrade=True, max_parallel_upgrades=0, max_unavailable=api.IntOrString("100%"),
            drain_spec=api.DrainSpec(enable=True, force=True, timeout_second=5),
            remediation=api.RemediationSpec(failure_threshold=0.5, min_attempted=2, auto_rollback=True,
                                            max_node_attempts=5, backoff_seconds=0.0))
        policy.validate()
        sides.append(Side(pkg, clean_fleet(pkg, revisions=("good",)), policy, now))
    jside, pside = sides

    def done(side):
        return set(_labels(side).values()) == {consts.UPGRADE_STATE_DONE}

    try:
        run_passes(pinned_clock, jside, pside, max_passes=10, done=done)  # the healthy era
        for side in sides:
            ds = side.cluster.get("DaemonSet", "driver", NS)
            side.cluster.create(side.pkg.objects.make_controller_revision(ds, 2, "bad"))
        jside.now = pside.now = now + 10 * PASS_SECONDS

        breaker_states = set()

        def rolled_back_and_done(side):
            breaker_states.add(((side.manager.remediation.last_status() or {}).get("breaker") or {}).get("state"))
            return "rolled-back" in breaker_states and done(side)

        run_passes(pinned_clock, jside, pside, max_passes=60, bad="bad", done=rolled_back_and_done)
    finally:
        for side in sides:
            side.manager.shutdown()
    assert "rolled-back" in breaker_states  # tripped and rolled back in one pass
    types_ = {d["type"] for d in _decisions(PORT)}
    assert {"BreakerTripped", "NodeUpgradeFailed"} <= types_
    assert {p["metadata"]["labels"]["controller-revision-hash"] for p in pside.cluster.list("Pod", namespace=NS)} == {
        "good"}
