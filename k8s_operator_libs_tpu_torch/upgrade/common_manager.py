"""CommonUpgradeManager — the per-state processors shared by both modes.

Reference parity: ``pkg/upgrade/common_manager.go`` (C2) —

* :class:`NodeUpgradeState` / :class:`ClusterUpgradeState` (:56-75);
* done/unknown classification: revision-hash sync + safe-load +
  upgrade-requested annotation (:229-291), initial-unschedulable capture
  (:250-264);
* pod↔DaemonSet revision sync oracle (:299-320);
* cordon / wait-for-jobs / pod-deletion / drain scheduling processors
  (:361-453);
* pod-restart with failure detection — a driver container not-Ready with
  restartCount > 10 fails the node (:457-524, 636-648);
* failed-node self-healing once the pod is back in sync (:528-570);
* validation processor (:573-604);
* uncordon-or-done with the initial-unschedulable skip (:673-708);
* census + upgrade-slot math (:712-776).

TPU-native: when the policy sets ``slice_aware``, the census and slot
math run in **slice domains** (see :mod:`..tpu.topology`) instead of raw
nodes — one multi-host slice counts once toward ``maxUnavailable``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.upgrade_spec import (
    DrainSpec,
    PodDeletionSpec,
    WaitForCompletionSpec,
)
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..cluster.objects import (
    is_owned_by,
    name_of,
    node_is_ready,
    node_is_unschedulable,
    owner_references,
    pod_phase,
)
from ..obs import tracing
from ..tpu import topology
from . import consts, util
from .cordon_manager import CordonManager
from .drain_manager import DrainConfiguration, DrainManager
from .node_upgrade_state_provider import NodeUpgradeStateProvider
from .pod_manager import PodManager, PodManagerConfig
from .safe_driver_load_manager import SafeDriverLoadManager
from .util import EventRecorder, log_event
from .validation_manager import ValidationManager

logger = logging.getLogger(__name__)

#: Reference: a driver container not Ready with > 10 restarts fails the node
#: (common_manager.go:636-648).
POD_RESTART_FAILURE_THRESHOLD = 10


@dataclass
class NodeUpgradeState:
    """One node + its driver pod + owning DaemonSet (reference :56-66);
    requestor mode attaches the node's NodeMaintenance CR, if any."""

    node: JsonObj
    driver_pod: JsonObj
    driver_daemonset: Optional[JsonObj] = None
    node_maintenance: Optional[JsonObj] = None

    def is_orphaned_pod(self) -> bool:
        """Reference: IsOrphanedPod — no owner references (:221-223)."""
        return self.driver_daemonset is None


@dataclass
class ClusterUpgradeState:
    """Point-in-time snapshot: state-label → node states (reference :69-75)."""

    node_states: Dict[str, List[NodeUpgradeState]] = field(default_factory=dict)
    #: Node names whose snapshot inputs changed since the previous pass,
    #: filled by the incremental BuildState
    #: (:class:`~.state_index.ClusterStateIndex`).  ``None`` — the full
    #: rebuild, a fresh index seed, or any caller that does not track
    #: dirtiness — means "unknown: scan everything", which is the
    #: pre-index behavior and the safe fallback.  Excluded from equality
    #: (two snapshots with identical contents are the same snapshot no
    #: matter how they were assembled).
    dirty_nodes: Optional[set] = field(default=None, compare=False)
    #: True when this snapshot was assembled by the ClusterStateIndex —
    #: the manager then ACKs the index's dirty debt once an ApplyState
    #: pass over it completes.  Excluded from equality like dirty_nodes.
    built_from_index: bool = field(default=False, compare=False)
    #: Census memo: the flattened managed-node list, built once per
    #: snapshot and shared by every fleet walk of the pass (slot math,
    #: pacing/canary censuses, remediation, analysis exposure, SLO
    #: evaluation).  Before the memo each of those rebuilt the list —
    #: ~6-8 full O(fleet) comprehensions per reconcile, the dominant
    #: reconcile frames at 65k nodes once event-driven wakeups removed
    #: the idle passes.  Invalidated by cascade bucket migration (the
    #: only within-pass bucket mutation).  Excluded from equality.
    _managed_memo: Optional[List[NodeUpgradeState]] = field(
        default=None, repr=False, compare=False
    )
    #: Same memo for the ALL-buckets flatten (pacing/quarantine scans,
    #: the slice-mode domain total, the cascade bucket index).
    _all_memo: Optional[List[NodeUpgradeState]] = field(
        default=None, repr=False, compare=False
    )
    #: Generic per-snapshot memo table for O(fleet) ANNOTATION scans
    #: (the pacing stamp census, the canary exposure walk — see
    #: :meth:`scan_memo`).  The flatten memos above removed the
    #: repeated list builds; these remove the repeated per-node
    #: annotation parses that sat on top of them: within one pass the
    #: scheduler, the analysis exposure census and rollout_status each
    #: re-walked every node's admitted-at/done-at annotations.
    #: Invalidated together with the flattens (cascade bucket
    #: migration — which is also what admission writes trigger, so a
    #: memo can never serve stamps from before this pass's writes).
    _scan_memos: dict = field(default_factory=dict, repr=False, compare=False)

    def nodes_in(self, state: str) -> List[NodeUpgradeState]:
        return self.node_states.get(state, [])

    def scan_scope(self, state: str) -> List[NodeUpgradeState]:
        """The *dirty-scoped* view of a bucket: only entries whose node
        inputs changed since the last pass, or the whole bucket when
        dirtiness is unknown.  ONLY valid for processors whose verdict
        is a pure function of the node's own event-visible inputs (its
        node object, its pods, the DS revision oracle — all of which
        feed the dirty set).  Processors with wall-clock behavior
        (validation/wait-for-jobs timeouts), cross-node inputs (the
        slice safe-load barrier), or async re-scheduling duties must
        keep scanning their full — O(active), throttle-bounded —
        buckets."""
        entries = self.node_states.get(state, [])
        if self.dirty_nodes is None:
            return entries
        dirty = self.dirty_nodes
        return [
            ns
            for ns in entries
            if ((ns.node.get("metadata") or {}).get("name") or "") in dirty
        ]

    def all_node_states(self) -> List[NodeUpgradeState]:
        """Every bucket flattened — memoized per snapshot like
        :meth:`managed_node_states`; callers iterate, never mutate."""
        memo = self._all_memo
        if memo is None:
            memo = [
                ns for states in self.node_states.values() for ns in states
            ]
            self._all_memo = memo
        return memo

    def managed_node_states(self) -> List[NodeUpgradeState]:
        """Node states in *recognized* buckets only.  A node whose state
        label was corrupted to an unknown value is excluded from census
        math so it cannot permanently consume throttle slots (the
        reference's GetTotalManagedNodes likewise sums only known buckets,
        common_manager.go:712-728; unlike the reference we also count the
        two maintenance states so requestor-delegated nodes hold slots).

        Memoized per snapshot — callers share ONE flattened list and
        must not mutate it (every caller iterates).  Bucket mutation
        (cascade migration) calls :meth:`invalidate_census`."""
        memo = self._managed_memo
        if memo is None:
            memo = [
                ns
                for state, nss in self.node_states.items()
                if state in consts.ALL_STATES
                for ns in nss
            ]
            self._managed_memo = memo
        return memo

    def total_managed_nodes(self) -> int:
        """Managed-node COUNT via per-bucket lengths — O(buckets), no
        list materialization (the pure-census callers' fast path)."""
        return sum(
            len(nss)
            for state, nss in self.node_states.items()
            if state in consts.ALL_STATES
        )

    def scan_memo(self, key, builder):
        """Per-snapshot memo for an O(fleet) derived scan: the first
        caller under *key* pays the walk via *builder()*, every later
        caller in the same pass shares the result.  Keys must encode
        everything the scan depends on besides the snapshot itself
        (e.g. ``("canary-walk", slice_aware)``).  Cleared by
        :meth:`invalidate_census`, which every bucket mutation (and
        thus every admission write) triggers — a stale memo can never
        outlive the state it was derived from."""
        memos = self._scan_memos
        if key in memos:
            return memos[key]
        value = builder()
        memos[key] = value
        return value

    def invalidate_census(self) -> None:
        """Drop the flatten + scan memos after a bucket mutation
        (cascade bucket migration is the one in-pass mutator)."""
        self._managed_memo = None
        self._all_memo = None
        self._scan_memos.clear()


class CommonUpgradeManager:
    """Shared state-processing logic used by both mode strategies."""

    def __init__(
        self,
        cluster: ClusterClient,
        provider: NodeUpgradeStateProvider,
        cordon_manager: CordonManager,
        drain_manager: DrainManager,
        pod_manager: PodManager,
        validation_manager: ValidationManager,
        safe_driver_load_manager: SafeDriverLoadManager,
        recorder: Optional[EventRecorder] = None,
        pod_deletion_enabled: bool = False,
        validation_enabled: bool = False,
        reader=None,
    ) -> None:
        self._cluster = cluster
        #: Snapshot reads (DaemonSet listing) — an informer cache when
        #: the state manager runs cache-backed (controller-runtime
        #: parity), else the cluster itself.
        self._reader = reader if reader is not None else cluster
        self.provider = provider
        self.cordon_manager = cordon_manager
        self.drain_manager = drain_manager
        self.pod_manager = pod_manager
        self.validation_manager = validation_manager
        self.safe_driver_load_manager = safe_driver_load_manager
        self.recorder = recorder
        self._pod_deletion_enabled = pod_deletion_enabled
        self._validation_enabled = validation_enabled

    # ----------------------------------------------------------- feature bits
    def is_pod_deletion_enabled(self) -> bool:
        return self._pod_deletion_enabled

    def is_validation_enabled(self) -> bool:
        return self._validation_enabled

    # ------------------------------------------------------------ predicates
    @staticmethod
    def is_node_unschedulable(node: JsonObj) -> bool:
        return node_is_unschedulable(node)

    @staticmethod
    def is_node_condition_ready(node: JsonObj) -> bool:
        return node_is_ready(node)

    @staticmethod
    def is_upgrade_requested(node: JsonObj) -> bool:
        """Reference: IsUpgradeRequested (:322-325)."""
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        return (
            annotations.get(util.get_upgrade_requested_annotation_key())
            == consts.TRUE_STRING
        )

    @staticmethod
    def skip_node_upgrade(node: JsonObj) -> bool:
        """Reference: SkipNodeUpgrade (:665-668)."""
        labels = (node.get("metadata") or {}).get("labels") or {}
        return labels.get(util.get_upgrade_skip_node_label_key()) == consts.TRUE_STRING

    # ------------------------------------------------------- sync-hash oracle
    def pod_in_sync_with_ds(self, node_state: NodeUpgradeState):
        """Returns (is_pod_synced, is_orphaned).  Reference: podInSyncWithDS
        (:299-320) — orphaned pods are never in sync."""
        if node_state.is_orphaned_pod():
            return False, True
        pod_hash = self.pod_manager.get_pod_controller_revision_hash(
            node_state.driver_pod
        )
        ds_hash = self.pod_manager.get_daemonset_controller_revision_hash(
            node_state.driver_daemonset
        )
        return pod_hash == ds_hash, False

    def is_driver_pod_in_sync(self, node_state: NodeUpgradeState) -> bool:
        """Revision synced + Running + every container Ready (reference:
        isDriverPodInSync, :605-634)."""
        synced, orphaned = self.pod_in_sync_with_ds(node_state)
        if orphaned or not synced:
            return False
        pod = node_state.driver_pod
        if pod_phase(pod) != "Running":
            return False
        statuses = (pod.get("status") or {}).get("containerStatuses") or []
        if not statuses:
            return False
        return all(s.get("ready", False) for s in statuses)

    @staticmethod
    def is_driver_pod_failing(pod: JsonObj) -> bool:
        """Reference: isDriverPodFailing (:636-648) — any init/main container
        not Ready with restartCount > threshold."""
        status = pod.get("status") or {}
        for s in (status.get("initContainerStatuses") or []) + (
            status.get("containerStatuses") or []
        ):
            if not s.get("ready", False) and int(
                s.get("restartCount", 0)
            ) > POD_RESTART_FAILURE_THRESHOLD:
                return True
        return False

    # ----------------------------------------- slice-coherent safe-load barrier
    def get_slice_load_blocked_domains(self, state: ClusterUpgradeState):
        """Domains holding the slice-coherent safe-load barrier closed:
        those with at least one node whose driver pod is not yet at the
        target DaemonSet revision (or is orphaned).  Returns ``None`` when
        slice-coherent mode is off — callers treat that as "no barrier".

        The reference's safe-load release is per-node
        (safe_driver_load_manager.go:57-71); this is the TPU-native
        all-hosts-at-target-revision strengthening of it (see module
        docstring of :mod:`.safe_driver_load_manager`).

        Peers that will never sync under the current flow do NOT hold the
        barrier — waiting on them would wedge their slice forever while
        pinning a throttle slot: skip-labeled nodes (admin explicitly
        exempted them; coherence is unattainable by choice) and nodes in
        upgrade-failed (the slice is already broken; holding its healthy
        hosts hostage cannot fix it — they self-heal through the failed
        processor once repaired out-of-band)."""
        # getattr: consumer-supplied doubles (tests/mocks.py pattern) may
        # not model the flag; absent means off.
        if not getattr(self.safe_driver_load_manager, "slice_coherent", False):
            return None
        # One fleet scan per snapshot, not per processor: pod revisions in
        # the snapshot cannot change mid-pass, so the set is stable for the
        # lifetime of this ClusterUpgradeState.
        cached = getattr(state, "_slice_load_blocked_domains", None)
        if cached is not None:
            return cached
        blocked = set()
        for bucket, node_states in state.node_states.items():
            if bucket not in consts.ALL_STATES:
                continue
            if bucket == consts.UPGRADE_STATE_FAILED:
                continue
            for ns in node_states:
                if self.skip_node_upgrade(ns.node):
                    continue
                synced, orphaned = self.pod_in_sync_with_ds(ns)
                if not synced or orphaned:
                    blocked.add(topology.domain_of(ns.node))
        state._slice_load_blocked_domains = blocked
        return blocked

    def held_at_slice_load_barrier(
        self, node_state: NodeUpgradeState, blocked_domains
    ) -> bool:
        """True when *node* must stay blocked at its safe-load annotation
        because a slice peer has not reached the target revision.  Nodes
        not waiting for safe load are never held (their runtime is already
        up — there is nothing to gate).  Nodes whose OWN pod is unsynced
        are never held either: they put their own domain in the blocked
        set and would hold themselves forever — they must fall through to
        the normal lifecycle (restart/validate) and recover."""
        if not blocked_domains:
            return False
        node = node_state.node
        if not self.safe_driver_load_manager.is_waiting_for_safe_driver_load(node):
            return False
        synced, orphaned = self.pod_in_sync_with_ds(node_state)
        if not synced or orphaned:
            return False
        return topology.domain_of(node) in blocked_domains

    # ------------------------------------------------------------- processors
    @staticmethod
    def _node_span(node: JsonObj, phase: str) -> tracing.Span:
        """Per-node ``ProcessNodeState`` span — child of the enclosing
        ApplyState span, tagged with the node and the phase bucket it was
        processed from (the per-node latency attribution the histograms
        cannot give)."""
        return tracing.start_span(
            "ProcessNodeState",
            attributes={"node": name_of(node), "phase": phase},
        )

    def process_done_or_unknown_nodes(
        self, state: ClusterUpgradeState, state_name: str
    ) -> None:
        """Reference: ProcessDoneOrUnknownNodes (:229-291).

        Tracing note: this is the one processor that scans the WHOLE
        fleet every cycle (the steady-state done bucket), so the
        per-node span opens only around an actual transition — an
        always-on span per read-only check costs ~2× at 4,096 nodes for
        spans nobody will ever look at.

        Scan scope: dirty-node-scoped when the snapshot carries a dirty
        set (incremental BuildState) — a done/unknown node none of whose
        inputs changed cannot flip its verdict (revision sync, safe-load
        wait, and the upgrade-requested annotation are all event-visible
        inputs that feed the dirty set; a DS/ControllerRevision publish
        dirties the whole fleet), so only changed nodes are re-checked.
        Full scan when dirtiness is unknown — the pre-index behavior."""
        for node_state in state.scan_scope(state_name):
            node = node_state.node
            synced, orphaned = self.pod_in_sync_with_ds(node_state)
            requested = self.is_upgrade_requested(node)
            waiting_safe_load = (
                self.safe_driver_load_manager.is_waiting_for_safe_driver_load(node)
            )
            if (not synced and not orphaned) or waiting_safe_load or requested:
                with self._node_span(node, state_name or "unknown"):
                    # Record pre-existing unschedulability so the final
                    # uncordon is skipped for nodes that started out
                    # cordoned (:250-264).
                    if self.is_node_unschedulable(node):
                        self.provider.change_node_upgrade_annotation(
                            node,
                            util.get_upgrade_initial_state_annotation_key(),
                            consts.TRUE_STRING,
                        )
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_UPGRADE_REQUIRED
                    )
                continue
            if state_name == consts.UPGRADE_STATE_UNKNOWN:
                with self._node_span(node, state_name):
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_DONE
                    )

    def process_cordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Reference: ProcessCordonRequiredNodes (:361-380)."""
        for node_state in state.nodes_in(consts.UPGRADE_STATE_CORDON_REQUIRED):
            with self._node_span(
                node_state.node, consts.UPGRADE_STATE_CORDON_REQUIRED
            ):
                self.cordon_manager.cordon(node_state.node)
                self.provider.change_node_upgrade_state(
                    node_state.node, consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED
                )

    def process_wait_for_jobs_required_nodes(
        self,
        state: ClusterUpgradeState,
        wait_for_completion_spec: Optional[WaitForCompletionSpec],
    ) -> None:
        """Reference: ProcessWaitForJobsRequiredNodes (:384-419)."""
        node_states = state.nodes_in(consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED)
        if (
            wait_for_completion_spec is None
            or not wait_for_completion_spec.pod_selector
        ):
            next_state = (
                consts.UPGRADE_STATE_POD_DELETION_REQUIRED
                if self.is_pod_deletion_enabled()
                else consts.UPGRADE_STATE_DRAIN_REQUIRED
            )
            for node_state in node_states:
                self.provider.change_node_upgrade_state(
                    node_state.node, next_state
                )
            return
        if not node_states:
            return
        self.pod_manager.schedule_check_on_pod_completion(
            PodManagerConfig(
                nodes=[ns.node for ns in node_states],
                wait_for_completion_spec=wait_for_completion_spec,
            )
        )

    def process_pod_deletion_required_nodes(
        self,
        state: ClusterUpgradeState,
        pod_deletion_spec: Optional[PodDeletionSpec],
        drain_enabled: bool,
    ) -> None:
        """Reference: ProcessPodDeletionRequiredNodes (:424-453)."""
        node_states = state.nodes_in(consts.UPGRADE_STATE_POD_DELETION_REQUIRED)
        if not self.is_pod_deletion_enabled():
            for node_state in node_states:
                self.provider.change_node_upgrade_state(
                    node_state.node, consts.UPGRADE_STATE_DRAIN_REQUIRED
                )
            return
        if not node_states:
            return
        self.pod_manager.schedule_pod_eviction(
            PodManagerConfig(
                nodes=[ns.node for ns in node_states],
                deletion_spec=pod_deletion_spec or PodDeletionSpec(),
                drain_enabled=drain_enabled,
            )
        )

    def process_drain_nodes(
        self, state: ClusterUpgradeState, drain_spec: Optional[DrainSpec]
    ) -> None:
        """Reference: ProcessDrainNodes (:329-357) — drain disabled moves
        nodes straight to pod-restart-required."""
        node_states = state.nodes_in(consts.UPGRADE_STATE_DRAIN_REQUIRED)
        if drain_spec is None or not drain_spec.enable:
            for node_state in node_states:
                self.provider.change_node_upgrade_state(
                    node_state.node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                )
            return
        if not node_states:
            return
        self.drain_manager.schedule_nodes_drain(
            DrainConfiguration(
                spec=drain_spec, nodes=[ns.node for ns in node_states]
            )
        )

    def process_pod_restart_nodes(self, state: ClusterUpgradeState) -> None:
        """Reference: ProcessPodRestartNodes (:457-524)."""
        pods_to_restart: List[JsonObj] = []
        restart_bucket = state.nodes_in(consts.UPGRADE_STATE_POD_RESTART_REQUIRED)
        blocked_domains = (
            self.get_slice_load_blocked_domains(state) if restart_bucket else None
        )
        for node_state in restart_bucket:
            node = node_state.node
            with self._node_span(node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED):
                synced, orphaned = self.pod_in_sync_with_ds(node_state)
                if not synced or orphaned:
                    # Restart only pods not already terminating (:468-474).
                    if not node_state.driver_pod.get("metadata", {}).get(
                        "deletionTimestamp"
                    ):
                        pods_to_restart.append(node_state.driver_pod)
                    continue
                # Slice-coherent mode: hold this host at the barrier while a
                # slice peer is still on the old revision — deliberately held,
                # so skip the failure check too (a held init container is not
                # a failing driver).
                if self.held_at_slice_load_barrier(node_state, blocked_domains):
                    continue
                # Pod is at the right revision: release a blocked driver init
                # container before checking readiness (:476-481).
                self.safe_driver_load_manager.unblock_loading(node)
                if self.is_driver_pod_in_sync(node_state):
                    if not self.is_validation_enabled():
                        self.update_node_to_uncordon_or_done_state(node_state)
                        continue
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_VALIDATION_REQUIRED
                    )
                elif self.is_driver_pod_failing(node_state.driver_pod):
                    log_event(
                        self.recorder,
                        name_of(node),
                        "Warning",
                        util.get_event_reason(),
                        "Driver pod is failing with repeated restarts",
                    )
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_FAILED
                    )
        self.pod_manager.schedule_pods_restart(pods_to_restart)

    def process_upgrade_failed_nodes(self, state: ClusterUpgradeState) -> None:
        """Self-healing of failed nodes once the pod is back in sync
        (reference: ProcessUpgradeFailedNodes, :528-570).

        Dirty-scoped like the done/unknown scan: the failed bucket can
        grow without bound (it holds nodes awaiting an out-of-band fix)
        and the self-heal verdict is a pure function of the node's own
        pod-vs-revision sync — event-visible inputs all."""
        for node_state in state.scan_scope(consts.UPGRADE_STATE_FAILED):
            if not self.is_driver_pod_in_sync(node_state):
                continue
            node = node_state.node
            with self._node_span(node, consts.UPGRADE_STATE_FAILED):
                annotations = (node.get("metadata") or {}).get("annotations") or {}
                initial_key = util.get_upgrade_initial_state_annotation_key()
                if initial_key in annotations:
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_DONE
                    )
                    self.provider.change_node_upgrade_annotation(
                        node, initial_key, consts.NULL_STRING
                    )
                    new_state = consts.UPGRADE_STATE_DONE
                else:
                    self.provider.change_node_upgrade_state(
                        node, consts.UPGRADE_STATE_UNCORDON_REQUIRED
                    )
                    new_state = consts.UPGRADE_STATE_UNCORDON_REQUIRED
                # A self-heal closes any open remediation failure episode
                # (the retry budget resets on success) and — unlike the
                # reference, whose silent recovery left no trace — is
                # announced on the node's event timeline.
                failure_at_key = util.get_last_failure_at_annotation_key()
                if failure_at_key in annotations:
                    self.provider.change_node_upgrade_annotation(
                        node, failure_at_key, consts.NULL_STRING
                    )
                log_event(
                    self.recorder,
                    name_of(node),
                    "Normal",
                    util.get_event_reason(),
                    "Upgrade failure self-healed: driver pod back in sync "
                    f"at the target revision; node moves to {new_state}",
                )

    def process_validation_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Reference: ProcessValidationRequiredNodes (:573-604)."""
        node_states = state.nodes_in(consts.UPGRADE_STATE_VALIDATION_REQUIRED)
        blocked_domains = (
            self.get_slice_load_blocked_domains(state) if node_states else None
        )
        for node_state in node_states:
            node = node_state.node
            # Slice-coherent hold, as in the restart phase — skipped before
            # validate() so the validation timeout clock does not run while
            # the node is deliberately parked at the barrier.
            if self.held_at_slice_load_barrier(node_state, blocked_domains):
                continue
            with self._node_span(node, consts.UPGRADE_STATE_VALIDATION_REQUIRED):
                # The driver may have restarted after entering validation;
                # make sure it is not blocked on safe load (:576-583).
                self.safe_driver_load_manager.unblock_loading(node)
                if not self.validation_manager.validate(node):
                    continue
                self.update_node_to_uncordon_or_done_state(node_state)

    def update_node_to_uncordon_or_done_state(
        self, node_state: NodeUpgradeState
    ) -> None:
        """Reference: updateNodeToUncordonOrDoneState (:673-708)."""
        node = node_state.node
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        initial_key = util.get_upgrade_initial_state_annotation_key()
        requestor_mode = util.is_node_in_requestor_mode(node)
        new_state = consts.UPGRADE_STATE_UNCORDON_REQUIRED
        if initial_key in annotations and not requestor_mode:
            # Node was already unschedulable before the upgrade: leave it
            # cordoned and finish.
            new_state = consts.UPGRADE_STATE_DONE
        self.provider.change_node_upgrade_state(node, new_state)
        if new_state == consts.UPGRADE_STATE_DONE or requestor_mode:
            if initial_key in annotations:
                self.provider.change_node_upgrade_annotation(
                    node, initial_key, consts.NULL_STRING
                )

    # ------------------------------------------------------------------ census
    def get_total_managed_nodes(self, state: ClusterUpgradeState) -> int:
        """Reference: GetTotalManagedNodes (:712-728) — known buckets
        only.  Counted from per-bucket lengths, not a flattened list —
        this runs several times per pass (slot math, gauges, the
        reconciler's cadence decision)."""
        return state.total_managed_nodes()

    def get_upgrades_in_progress(self, state: ClusterUpgradeState) -> int:
        """Reference: GetUpgradesInProgress (:730-737) — everything not
        unknown/done/upgrade-required."""
        idle = (
            len(state.nodes_in(consts.UPGRADE_STATE_UNKNOWN))
            + len(state.nodes_in(consts.UPGRADE_STATE_DONE))
            + len(state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED))
        )
        return self.get_total_managed_nodes(state) - idle

    def get_upgrades_done(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(consts.UPGRADE_STATE_DONE))

    def get_upgrades_failed(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(consts.UPGRADE_STATE_FAILED))

    def get_upgrades_pending(self, state: ClusterUpgradeState) -> int:
        return len(state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED))

    def get_current_unavailable_nodes(self, state: ClusterUpgradeState) -> int:
        """Cordoned or not-ready nodes (reference: :146-165)."""
        return sum(
            1
            for ns in state.managed_node_states()
            if topology.node_is_unavailable(ns.node)
        )

    def get_upgrades_available(
        self,
        state: ClusterUpgradeState,
        max_parallel_upgrades: int,
        max_unavailable: int,
        slice_aware: bool = False,
    ) -> int:
        """Upgrade-slot computation (reference: GetUpgradesAvailable,
        :748-776).  With ``slice_aware`` every term is counted in slice
        domains instead of nodes; the returned slot count is then in
        domain units."""
        if slice_aware:
            all_nodes = [ns.node for ns in state.managed_node_states()]
            active_domains = {
                topology.domain_of(ns.node)
                for st, nss in state.node_states.items()
                if st in consts.ACTIVE_STATES
                for ns in nss
            }
            upgrades_in_progress = len(active_domains)
            total = topology.count_domains(all_nodes)
            current_unavailable = topology.count_unavailable_domains(all_nodes)
            about_to_cordon = len(
                {
                    topology.domain_of(ns.node)
                    for ns in state.nodes_in(consts.UPGRADE_STATE_CORDON_REQUIRED)
                }
            )
        else:
            upgrades_in_progress = self.get_upgrades_in_progress(state)
            total = self.get_total_managed_nodes(state)
            current_unavailable = self.get_current_unavailable_nodes(state)
            about_to_cordon = len(
                state.nodes_in(consts.UPGRADE_STATE_CORDON_REQUIRED)
            )

        if max_parallel_upgrades == 0:
            # No parallelism limit: every upgrade-required node may start.
            available = self.get_upgrades_pending(state)
        else:
            available = max_parallel_upgrades - upgrades_in_progress

        # Apply the maxUnavailable constraint, counting nodes about to be
        # cordoned as already unavailable (:762-775).
        unavailable_now = current_unavailable + about_to_cordon
        if available > max_unavailable:
            available = max_unavailable
        if unavailable_now >= max_unavailable:
            available = 0
        elif max_unavailable < total and unavailable_now + available > max_unavailable:
            available = max_unavailable - unavailable_now
        return available

    # ------------------------------------------------------- snapshot helpers
    def get_driver_daemon_sets(
        self, namespace: str, labels: Dict[str, str]
    ) -> Dict[str, JsonObj]:
        """uid → DaemonSet map (reference: GetDriverDaemonSets, :168-187)."""
        from ..cluster.selectors import labels_to_selector

        out: Dict[str, JsonObj] = {}
        for ds in self._reader.list(
            "DaemonSet", namespace=namespace,
            label_selector=labels_to_selector(labels),
        ):
            out[ds["metadata"]["uid"]] = ds
        return out

    @staticmethod
    def is_orphaned_pod(pod: JsonObj) -> bool:
        """Reference: IsOrphanedPod (:221-223)."""
        return len(owner_references(pod)) < 1

    def get_pods_owned_by_ds(
        self, ds: JsonObj, pods: List[JsonObj]
    ) -> List[JsonObj]:
        """Reference: GetPodsOwnedbyDs (:190-208)."""
        return [
            p
            for p in pods
            if not self.is_orphaned_pod(p) and is_owned_by(p, ds)
        ]

    def get_orphaned_pods(self, pods: List[JsonObj]) -> List[JsonObj]:
        """Reference: GetOrphanedPods (:211-219)."""
        return [p for p in pods if self.is_orphaned_pod(p)]
