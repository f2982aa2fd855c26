"""Dry-run rollout planning — "what would the operator do next?".

The reference has no preview surface: operators discover what the next
reconcile will do by letting it happen (`kubectl get nodes -L
<state-label> -w`).  For GPU fleets, where one admission takes a whole
NVLink domain down, operators want the blast radius BEFORE the rollout
moves.  This module answers that with **zero duplicated logic**: it
clones the cluster into a sandbox :class:`~..cluster.inmem.InMemoryCluster`
and runs the REAL state machine over the clone —
:meth:`~.upgrade_state.ClusterUpgradeStateManager.build_state` /
``apply_state``, the genuine throttle/canary/window/pacing/quarantine
code paths — while a minimal simulated DaemonSet controller recreates
driver pods at the target revision (the role kubelet+DS controller play
on a live cluster; same contract as the test harness and envtest,
SURVEY.md §4).  What the plan predicts is what ``apply_state`` does,
because it IS ``apply_state`` — on a sandbox.

The projection is the *optimistic trajectory*: drains succeed within
their grace, driver pods come back Ready at the new revision, the
external maintenance operator (requestor mode) grants Ready, and
validation pods come up Ready.  Mirror the operator's own assembly for
full fidelity — pass ``requestor_opts`` / ``pod_deletion_filter`` /
``validation_pod_selector`` to :func:`plan_rollout` exactly as the
consumer configures its manager.  Schedule gates (maintenance windows,
hourly pacing) are evaluated against the wall clock at planning time.

Entry point: :func:`plan_rollout`, over a ``to_dict()`` dump of a
cluster (a live cluster is only READ: the simulation never writes to
the source).
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..api.upgrade_spec import UpgradePolicySpec
from ..cluster.inmem import InMemoryCluster
from ..cluster.objects import make_pod, name_of
from . import consts, util
from .rollout_status import GateStatus, RolloutStatus
from .upgrade_state import ClusterUpgradeStateManager

logger = logging.getLogger(__name__)

#: Hard ceiling on simulated reconcile cycles (a blocked rollout reaches
#: steady state long before; this only bounds pathological loops).
MAX_CYCLES = 100


@dataclass
class PlannedTransition:
    """One node's predicted state change in one simulated cycle."""

    node: str
    from_state: str
    to_state: str
    cycle: int

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "from": self.from_state,
            "to": self.to_state,
            "cycle": self.cycle,
        }


@dataclass
class RolloutPlan:
    """The projected rollout trajectory over the simulated horizon."""

    transitions: List[PlannedTransition]
    cycles_simulated: int
    #: Every managed node projected to reach upgrade-done.
    converged: bool
    #: The simulation stopped moving before convergence — the rollout is
    #: blocked (gates, failed nodes, skip labels) or already complete.
    steady_state: bool
    #: Admission gates evaluated on the INITIAL snapshot (why cycle 1
    #: admits less than the slot budget — frozen canary, closed window,
    #: spent pacing).
    gates: List[GateStatus] = field(default_factory=list)
    #: state label -> node count, before and after the horizon.
    initial_states: Dict[str, int] = field(default_factory=dict)
    projected_states: Dict[str, int] = field(default_factory=dict)

    # ------------------------------------------------------------ queries
    @property
    def next_admissions(self) -> List[str]:
        """Nodes admitted at the plan's FIRST admitting cycle — the next
        blast-radius increment.  An admission is upgrade-required ->
        cordon-required (in-place) or -> node-maintenance-required
        (requestor handoff).  A fresh fleet spends cycle 1 classifying
        nodes into upgrade-required, so the first admissions appear in
        cycle 2; mid-rollout snapshots usually admit in cycle 1."""
        admitted_to = (
            consts.UPGRADE_STATE_CORDON_REQUIRED,
            consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
        )
        for cycle in range(1, self.cycles_simulated + 1):
            batch = [
                t.node
                for t in self.transitions
                if t.cycle == cycle
                and t.from_state == consts.UPGRADE_STATE_UPGRADE_REQUIRED
                and t.to_state in admitted_to
            ]
            if batch:
                return batch
        return []

    @property
    def blocking_gates(self) -> List[GateStatus]:
        return [g for g in self.gates if g.blocking]

    def to_dict(self) -> dict:
        return {
            "transitions": [t.to_dict() for t in self.transitions],
            "cyclesSimulated": self.cycles_simulated,
            "converged": self.converged,
            "steadyState": self.steady_state,
            "nextAdmissions": self.next_admissions,
            "gates": [g.to_dict() for g in self.gates],
            "initialStates": dict(self.initial_states),
            "projectedStates": dict(self.projected_states),
        }

    def render(self) -> str:
        """Human-readable plan (the CLI's table mode)."""
        lines = [
            f"Plan: {self.cycles_simulated} cycle(s) simulated — "
            + (
                "converges"
                if self.converged
                else "blocked (steady state)"
                if self.steady_state
                else "horizon reached before convergence"
            )
        ]
        admits = self.next_admissions
        lines.append(
            f"Next admissions: {len(admits)} node(s)"
            + (": " + ", ".join(sorted(admits)) if admits else "")
        )
        for gate in self.blocking_gates:
            lines.append(f"Gate: {gate.reason}")
        by_cycle: Dict[int, List[PlannedTransition]] = {}
        for t in self.transitions:
            by_cycle.setdefault(t.cycle, []).append(t)
        for cycle in sorted(by_cycle):
            lines.append(f"Cycle {cycle}:")
            for t in sorted(by_cycle[cycle], key=lambda t: t.node):
                lines.append(f"  {t.node}  {t.from_state} -> {t.to_state}")
        done = self.projected_states.get(consts.UPGRADE_STATE_DONE, 0)
        total = sum(self.projected_states.values())
        lines.append(f"Projected: {done}/{total} nodes upgrade-done")
        return "\n".join(lines)


def _node_states(cluster: InMemoryCluster) -> Dict[str, str]:
    key = util.get_upgrade_state_label_key()
    out = {}
    for node in cluster.list("Node"):
        labels = (node.get("metadata") or {}).get("labels") or {}
        out[name_of(node)] = labels.get(key, "")
    return out


def _counts(states: Dict[str, str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for state in states.values():
        label = state or "unknown"
        out[label] = out.get(label, 0) + 1
    return out


class _SimDaemonSetController:
    """Minimal DS controller for the sandbox: recreates a missing driver
    pod at the NEWEST ControllerRevision for every node the DaemonSet
    covered at planning time (covered = had an owned pod in the source
    snapshot — the same node-targeting contract the test harness keeps,
    so desiredNumberScheduled accounting stays intact)."""

    def __init__(
        self,
        sim: InMemoryCluster,
        namespace: str,
        driver_labels: Dict[str, str],
        hash_resolver=None,
        extra_nodes=(),
    ) -> None:
        """*hash_resolver*: ``(ds) -> newest revision hash`` — the plan
        passes the REAL PodManager oracle
        (:meth:`~.pod_manager.PodManager.get_daemonset_controller_revision_hash`)
        so the sandbox recreates pods at exactly the revision the real
        operator would target (owner-less backup revisions included).

        *extra_nodes*: managed nodes with NO pod in the snapshot (taken
        mid-restart-wave, after the delete and before the recreate) —
        still the DaemonSet's responsibility.  Unambiguous only with one
        DaemonSet; with several there is no signal which one owned the
        vanished pod, so they are skipped (and the snapshot's desired-
        count mismatch will surface as an UpgradeStateError instead of a
        silent wrong plan)."""
        self._sim = sim
        self._namespace = namespace
        self._labels = dict(driver_labels)
        self._hash_resolver = hash_resolver
        self._selector = ",".join(
            f"{k}={v}" for k, v in sorted(driver_labels.items())
        )
        self._seq = itertools.count()
        # (ds name -> set of covered node names), from the source snapshot
        self._covered: Dict[str, set] = {}
        self._ds_by_name: Dict[str, dict] = {}
        for ds in sim.list("DaemonSet", namespace, self._selector):
            self._ds_by_name[name_of(ds)] = ds
            self._covered[name_of(ds)] = set()
        for pod in sim.list("Pod", namespace, self._selector):
            ds_name = self._owner_ds(pod)
            if ds_name is not None:
                node = (pod.get("spec") or {}).get("nodeName") or ""
                self._covered.setdefault(ds_name, set()).add(node)
        if extra_nodes and len(self._ds_by_name) == 1:
            # Cap by the snapshot's own accounting: only as many heals as
            # the DS reports missing (desired - scheduled).  A labeled
            # node the DS no longer targets (desired already met) must
            # not get a phantom pod.
            only_ds = next(iter(self._covered))
            ds = self._ds_by_name[only_ds]
            desired = int(
                (ds.get("status") or {}).get("desiredNumberScheduled", 0)
            )
            missing = max(0, desired - len(self._covered[only_ds]))
            self._covered[only_ds].update(sorted(extra_nodes)[:missing])

    def _owner_ds(self, pod: dict) -> Optional[str]:
        for ref in (pod.get("metadata") or {}).get("ownerReferences") or []:
            if ref.get("kind") == "DaemonSet" and ref.get("name") in self._ds_by_name:
                return ref.get("name")
        return None

    def _newest_hash(self, ds_name: str) -> str:
        ds = self._ds_by_name[ds_name]
        if self._hash_resolver is not None:
            from .pod_manager import PodManagerError

            try:
                return self._hash_resolver(ds)
            except PodManagerError:
                return ""  # no revisions exist: recreate hash-less
        # Fallback (no resolver injected): newest owned revision's hash
        # label.  The plan always injects the real oracle; this path only
        # serves direct test construction.
        newest_rev, newest_hash = -1, ""
        for cr in self._sim.list("ControllerRevision", self._namespace):
            refs = (cr.get("metadata") or {}).get("ownerReferences") or []
            if not any(
                r.get("kind") == "DaemonSet" and r.get("name") == ds_name
                for r in refs
            ):
                continue
            rev = int(cr.get("revision") or 0)
            if rev > newest_rev:
                newest_rev = rev
                newest_hash = (
                    (cr.get("metadata") or {}).get("labels") or {}
                ).get("controller-revision-hash", "")
        return newest_hash

    def reconcile(self) -> int:
        created = 0
        for ds_name, covered in self._covered.items():
            have = {
                (p.get("spec") or {}).get("nodeName")
                for p in self._sim.list("Pod", self._namespace, self._selector)
                if self._owner_ds(p) == ds_name
                # a Terminating pod still occupies the node; the DS
                # controller waits for it to go away
            }
            missing = covered - have
            if not missing:
                continue
            hash_ = self._newest_hash(ds_name)
            ds = self._ds_by_name[ds_name]
            for node in sorted(missing):
                self._sim.create(
                    make_pod(
                        f"{ds_name}-plan-{next(self._seq)}",
                        self._namespace,
                        node,
                        labels=dict(self._labels),
                        owner=ds,
                        revision_hash=hash_,
                        ready=True,
                    )
                )
                created += 1
        return created


class SimMaintenanceOperator:
    """A stand-in external maintenance operator: picks up NodeMaintenance
    CRs, cordons + drains the named node out-of-band, then reports the
    Ready condition — the counterpart the requestor mode hands off to
    (reference: Mellanox maintenance-operator; conditions consumed at
    upgrade_requestor.go:416-452).  Used by the plan sandbox to project
    requestor-mode rollouts and by the test suites as the fake external
    operator (one implementation, so tests and plans agree on the
    contract)."""

    def __init__(
        self,
        cluster,
        namespace: str = "default",
        ready_delay_seconds: float = 0.0,
    ) -> None:
        self.cluster = cluster
        self.namespace = namespace
        #: Minimum CR age before Ready is reported — real maintenance
        #: (cordon + drain) takes time; a nonzero delay keeps CRs open
        #: long enough for shared-requestor appends to overlap.
        self.ready_delay_seconds = ready_delay_seconds
        self._first_seen: Dict[str, float] = {}

    FINALIZER = "maintenance.nvidia.com/finalizer"

    def reconcile(self) -> int:
        from ..cluster.errors import NotFoundError

        handled = 0
        crs = self.cluster.list("NodeMaintenance", namespace=self.namespace)
        # Prune first-seen stamps of vanished CRs: a deleted-and-recreated
        # same-name CR must serve a fresh ready_delay window.
        live = {nm["metadata"]["name"] for nm in crs}
        for name in [n for n in self._first_seen if n not in live]:
            del self._first_seen[name]
        for nm in crs:
            # Graceful-deletion arbitration: the requestor's delete is only a
            # *request* (upgrade_requestor.go:241-246 "assuming maintenance OP
            # will handle actual obj deletion"); the CR is released once no
            # additional requestors remain.
            if nm["metadata"].get("deletionTimestamp"):
                if not (nm.get("spec") or {}).get("additionalRequestors"):
                    nm["metadata"]["finalizers"] = []
                    self.cluster.update(nm)
                continue
            conds = (nm.get("status") or {}).get("conditions") or []
            if any(c.get("type") == "Ready" for c in conds):
                continue
            if self.ready_delay_seconds > 0:
                first = self._first_seen.setdefault(
                    nm["metadata"]["name"], time.monotonic()
                )
                if time.monotonic() - first < self.ready_delay_seconds:
                    continue  # maintenance still "in progress"
            if self.FINALIZER not in (nm["metadata"].get("finalizers") or []):
                nm["metadata"].setdefault("finalizers", []).append(self.FINALIZER)
            node_name = (nm.get("spec") or {}).get("nodeName", "")
            try:
                self.cluster.patch(
                    "Node", node_name, {"spec": {"unschedulable": True}}
                )
            except NotFoundError:
                # node gone: still take ownership (finalizer) but no work
                self.cluster.update(nm)
                continue
            # evict non-driver pods (crude out-of-band drain)
            for pod in self.cluster.list("Pod"):
                owners = (pod.get("metadata") or {}).get("ownerReferences") or []
                is_ds = any(o.get("kind") == "DaemonSet" for o in owners)
                if (pod.get("spec") or {}).get("nodeName") == node_name and not is_ds:
                    self.cluster.delete(
                        "Pod",
                        pod["metadata"]["name"],
                        pod["metadata"].get("namespace", ""),
                    )
            nm.setdefault("status", {}).setdefault("conditions", []).append(
                {"type": "Ready", "status": "True", "reason": "Ready"}
            )
            self.cluster.update(nm)
            handled += 1
        return handled


class _SimValidationController:
    """Optimistic validation play: for every node waiting in
    validation-required, ensure a Running+Ready pod matching the
    validation selector exists on it (the consumer's validation
    DaemonSet's role).  Label synthesis uses the one selector grammar
    (:func:`~..cluster.selectors.example_labels`); a selector no label
    set can satisfy leaves validation unsimulated — the plan then shows
    it timing out, which is itself informative."""

    def __init__(self, sim: InMemoryCluster, pod_selector: str) -> None:
        from ..cluster.selectors import example_labels

        self._sim = sim
        self._selector = pod_selector
        self._labels = example_labels(pod_selector)
        self._seq = itertools.count()

    def reconcile(self) -> int:
        if self._labels is None:
            return 0
        key = util.get_upgrade_state_label_key()
        created = 0
        for node in self._sim.list("Node"):
            state = (node["metadata"].get("labels") or {}).get(key, "")
            if state != consts.UPGRADE_STATE_VALIDATION_REQUIRED:
                continue
            name = name_of(node)
            # the membership check uses the ORIGINAL selector, exactly as
            # ValidationManager.validate lists (validation_manager.py)
            have = self._sim.list(
                "Pod",
                label_selector=self._selector,
                field_selector=f"spec.nodeName={name}",
            )
            if have:
                continue
            self._sim.create(
                make_pod(
                    f"validation-plan-{next(self._seq)}",
                    "kube-system",
                    name,
                    labels=dict(self._labels),
                    ready=True,
                )
            )
            created += 1
        return created


def plan_rollout(
    source_dump: dict,
    namespace: str,
    driver_labels: Dict[str, str],
    policy: UpgradePolicySpec,
    *,
    cycles: int = 0,
    play_daemonset: bool = True,
    requestor_opts=None,
    pod_deletion_filter: Optional[Callable] = None,
    validation_pod_selector: str = "",
) -> RolloutPlan:
    """Simulate the rollout on a sandbox clone and return the projected
    trajectory.

    *source_dump* is an :meth:`InMemoryCluster.to_dict` dump (the CLI
    builds one from a state file or a live cluster read).  *cycles* is
    the horizon: 0 = run until convergence or steady state (capped at
    :data:`MAX_CYCLES`).  The source is never mutated.

    Mirror the operator's assembly for full fidelity: *requestor_opts*
    (a :class:`~.upgrade_requestor.RequestorOptions`) plans the
    requestor-mode handoff with a simulated maintenance operator
    granting Ready optimistically; *pod_deletion_filter* /
    *validation_pod_selector* enable the optional builder states the
    consumer enables (validation pods are synthesized Ready on each
    validating node — the optimistic trajectory)."""
    sim = InMemoryCluster.from_dict(source_dump, termination_grace_scale=0.0)
    manager = ClusterUpgradeStateManager(
        sim,
        cache_sync_timeout_seconds=5.0,
        cache_sync_poll_seconds=0.005,
    )
    mop = None
    if requestor_opts is not None:
        from .upgrade_requestor import RequestorNodeStateManager

        manager.with_requestor(
            RequestorNodeStateManager(manager.common, requestor_opts),
            enabled=True,
        )
        mop = SimMaintenanceOperator(
            sim, namespace=requestor_opts.requestor_namespace
        )
    if pod_deletion_filter is not None:
        manager.with_pod_deletion_enabled(pod_deletion_filter)
    validation = None
    if validation_pod_selector:
        manager.with_validation_enabled(validation_pod_selector)
        validation = _SimValidationController(sim, validation_pod_selector)
    horizon = cycles if cycles > 0 else MAX_CYCLES
    horizon = min(horizon, MAX_CYCLES)

    # The rollout only ever labels nodes hosting driver pods; clusters
    # have other nodes too (control plane, CPU pools).  Convergence and
    # the transition diff are scoped to MANAGED nodes — driver-pod hosts
    # plus any node already carrying a state label (mid-rollout hosts
    # whose pod is momentarily gone) — or a bystander node would keep a
    # completed rollout reading "blocked" forever.
    selector = ",".join(f"{k}={v}" for k, v in sorted(driver_labels.items()))
    pod_hosts = {
        (p.get("spec") or {}).get("nodeName") or ""
        for p in sim.list("Pod", namespace, selector)
    } - {""}
    labeled = {n for n, s in _node_states(sim).items() if s}
    managed = pod_hosts | labeled

    ds_controller = (
        _SimDaemonSetController(
            sim,
            namespace,
            driver_labels,
            # the REAL revision oracle, so the sandbox targets exactly
            # the hash the operator would (owner-less backup revisions
            # and all — code-review finding: a reimplementation here
            # would let the plan drift from apply_state)
            hash_resolver=manager.pod_manager.get_daemonset_controller_revision_hash,
            # labeled pod-less nodes: snapshot taken mid-restart-wave
            extra_nodes=labeled - pod_hosts,
        )
        if play_daemonset
        else None
    )
    if ds_controller is not None:
        # Pre-heal BEFORE the first build_state: a mid-wave snapshot has
        # desired > scheduled, which build_state (correctly) rejects; on
        # a live cluster the DS controller closes that gap continuously,
        # so the sandbox plays one catch-up round first.
        ds_controller.reconcile()

    def managed_states() -> Dict[str, str]:
        return {
            n: s for n, s in _node_states(sim).items() if n in managed
        }

    initial = managed_states()
    gates: List[GateStatus] = []
    gates_final = False
    transitions: List[PlannedTransition] = []
    before = initial
    converged = False
    steady = False
    quiet_cycles = 0
    ran = 0
    try:
        for cycle in range(1, horizon + 1):
            ran = cycle
            state = manager.build_state(namespace, driver_labels)
            # Gates are evaluated on the first snapshot with admissible
            # work (a fresh fleet's cycle-1 snapshot is all-unknown —
            # its census would misstate the canary); fall back to cycle 1
            # for fleets with nothing to admit.
            if (cycle == 1 and not gates) or (
                not gates_final
                and state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED)
            ):
                gates = RolloutStatus.from_cluster_state(
                    state, policy=policy
                ).gates
                gates_final = bool(
                    state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED)
                )
            manager.apply_state(state, policy)
            manager.drain_manager.wait_idle(30.0)
            manager.pod_manager.wait_idle(30.0)
            progress = (
                ds_controller.reconcile() if ds_controller is not None else 0
            )
            if mop is not None:
                # the external maintenance operator grants Ready (and
                # completes CR deletions) — progress, like pod recreation
                progress += mop.reconcile()
            if validation is not None:
                progress += validation.reconcile()
            after = managed_states()
            cycle_moves = [
                PlannedTransition(node, before.get(node, ""), after[node], cycle)
                for node in sorted(after)
                if after[node] != before.get(node, "")
            ]
            transitions.extend(cycle_moves)
            before = after
            if after and set(after.values()) == {consts.UPGRADE_STATE_DONE}:
                converged = True
                break
            # Steady state needs TWO consecutive cycles with neither node
            # transitions nor pod recreations: progress can be pod-level
            # only (a restart wave lands one cycle before its nodes move).
            if not cycle_moves and progress == 0:
                quiet_cycles += 1
                if quiet_cycles >= 2:
                    steady = True
                    break
            else:
                quiet_cycles = 0
    finally:
        manager.shutdown()
    return RolloutPlan(
        transitions=transitions,
        cycles_simulated=ran,
        converged=converged,
        steady_state=steady or converged,
        gates=gates,
        initial_states=_counts(initial),
        projected_states=_counts(before),
    )
