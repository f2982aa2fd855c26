"""ClusterUpgradeStateManager — the L4 state-machine driver.

Reference parity: ``pkg/upgrade/upgrade_state.go`` (C1) —

* ``NewClusterUpgradeStateManager`` (:65-92) constructing the L2 managers;
  builder switches ``WithPodDeletionEnabled`` (:329-337) and
  ``WithValidationEnabled`` (:341-350);
* ``BuildState`` (:99-164): snapshot of driver DaemonSets + pods, per-DS
  ownership filter, hard error on unscheduled pods, orphaned-pod
  collection, skip of pending unassigned pods, bucketing by the
  upgrade-state node label;
* ``ApplyState`` (:171-281): the 11-phase sequential loop over state
  buckets — stateless and idempotent; every decision is derived from the
  snapshot, and async work (drain/eviction) reports through node labels
  picked up by the *next* reconcile;
* mode dispatch wrappers (:287-325): upgrade-required / node-maintenance /
  uncordon processors run through the in-place or requestor strategy —
  with both uncordon processors run so nodes that started in-place finish
  in-place even after requestor mode is enabled (:311-325).
"""

from __future__ import annotations

import logging
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..obs import events as events_mod
from ..obs import slo as slo_mod
from ..obs import tracing
from ..api.upgrade_spec import UpgradePolicySpec
from ..cluster.cache import InformerCache
from ..cluster.errors import NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..cluster.selectors import labels_to_selector
from . import analysis as analysis_mod
from . import consts, timeline as timeline_mod, util
from .common_manager import (
    ClusterUpgradeState,
    CommonUpgradeManager,
    NodeUpgradeState,
)
from .cordon_manager import CordonManager
from .drain_manager import DrainManager, PreDrainGate
from .node_upgrade_state_provider import NodeUpgradeStateProvider
from .pod_manager import PodDeletionFilter, PodManager
from .remediation import RemediationDecision, RemediationManager
from .safe_driver_load_manager import SafeDriverLoadManager
from .state_index import ClusterStateIndex
from .upgrade_inplace import InplaceNodeStateManager
from .util import EventRecorder, log_event
from .validation_manager import ValidationManager

logger = logging.getLogger(__name__)


class UpgradeStateError(Exception):
    pass


class ClusterUpgradeStateManager:
    """Build + apply the cluster upgrade state each reconcile."""

    def __init__(
        self,
        cluster: ClusterClient,
        cache: Optional[InformerCache] = None,
        recorder: Optional[EventRecorder] = None,
        requestor: Optional[object] = None,
        use_maintenance_operator: bool = False,
        pre_drain_gate: Optional[PreDrainGate] = None,
        cascade: bool = False,
        deferred_visibility: bool = True,
        write_pipeline_workers: int = 0,
        cache_sync_timeout_seconds: float = 10.0,
        cache_sync_poll_seconds: float = 1.0,
        use_state_index: bool = False,
        state_index: Optional[ClusterStateIndex] = None,
        flight_recorder: Optional[timeline_mod.FlightRecorder] = None,
        decision_event_sink: Optional[
            "events_mod.ClusterDecisionEventSink"
        ] = None,
        # test injection points (the reference wires mocks the same way,
        # upgrade_suit_test.go:114-182)
        provider: Optional[NodeUpgradeStateProvider] = None,
        cordon_manager: Optional[CordonManager] = None,
        drain_manager: Optional[DrainManager] = None,
        pod_manager: Optional[PodManager] = None,
        validation_manager: Optional[ValidationManager] = None,
        safe_driver_load_manager: Optional[SafeDriverLoadManager] = None,
        reads_from_cache: bool = False,
    ) -> None:
        self._cluster = cluster
        self._cache = cache or InformerCache(cluster, lag_seconds=0.0)
        #: controller-runtime parity: the manager's SNAPSHOT reads (the
        #: BuildState Pod/DaemonSet lists and the DS-revision oracle)
        #: can ride the informer cache instead of hitting the apiserver
        #: every cycle — with held watch streams that turns per-cycle
        #: LISTs into local snapshot reads.  Opt-in: writes and the
        #: visibility waits keep their semantics either way, but
        #: cache-lagged snapshots are the reference's real behavior.
        self._reader = self._cache if reads_from_cache else cluster
        self._reads_from_cache = reads_from_cache
        self._recorder = recorder
        #: Synchronous state transitions performed by the most recent
        #: apply_state pass (see that method's docstring).
        self.last_apply_transitions = 0
        #: Flight recorder (upgrade/timeline.py): per-node phase
        #: timelines derived from the transitions the machine makes.
        #: None resolves the process default per use (test-swap
        #: friendly, like the tracer/registry); inject a disabled
        #: recorder to A/B the overhead (bench does).
        self._flight = flight_recorder
        #: SLO engine (obs/slo.py): evaluates the policy's optional
        #: ``slos`` block each reconcile — entirely inert without one.
        self._slo_engine = slo_mod.SloEngine(flight_recorder)
        #: Analysis engine (upgrade/analysis.py): SLO-driven gates +
        #: adaptive pacing under the policy's optional ``analysis``
        #: block; shares the SLO engine's metrics-history ring so both
        #: planes judge the same samples.  Inert without the block.
        self._analysis_engine = analysis_mod.AnalysisEngine(
            history=self._slo_engine.history
        )
        self._owned_provider = provider is None
        self._provider = provider or NodeUpgradeStateProvider(
            cluster,
            self._cache,
            recorder,
            cache_sync_timeout_seconds=cache_sync_timeout_seconds,
            cache_sync_poll_seconds=cache_sync_poll_seconds,
            flight_recorder=flight_recorder,
            # Pipelined manager: worker-thread writes defer their
            # visibility waits to the pre-BuildState flush instead of
            # each paying the informer lag (the sequential-baseline
            # manager keeps the reference's per-write wait).
            async_visibility=write_pipeline_workers > 0,
        )
        self._cordon_manager = cordon_manager or CordonManager(
            cluster, recorder, provider=self._provider
        )
        # One bounded worker pool per operator, shared by the drain and pod
        # managers (the reference's per-node goroutines, capped — see
        # DEFAULT_WORKER_POOL_SIZE in drain_manager.py).
        shared_pool = None
        if drain_manager is None or pod_manager is None:
            from concurrent.futures import ThreadPoolExecutor

            from .drain_manager import default_worker_pool_size

            shared_pool = ThreadPoolExecutor(
                max_workers=default_worker_pool_size(),
                thread_name_prefix="upgrade-worker",
            )
        self._owned_pool = shared_pool
        self._owned_managers: list = []
        self._drain_manager = drain_manager or DrainManager(
            cluster,
            self._provider,
            recorder,
            pre_drain_gate=pre_drain_gate,
            pool=shared_pool,
            reader=self._reader if reads_from_cache else None,
        )
        if drain_manager is None:
            self._owned_managers.append(self._drain_manager)
        self._pod_manager = pod_manager or PodManager(
            cluster,
            self._provider,
            recorder,
            pool=shared_pool,
            revision_reader=self._reader if reads_from_cache else None,
        )
        if pod_manager is None:
            self._owned_managers.append(self._pod_manager)
        self._validation_manager = validation_manager or ValidationManager(
            cluster, self._provider, recorder
        )
        self._safe_load_manager = safe_driver_load_manager or SafeDriverLoadManager(
            self._provider
        )
        self._cascade = cascade
        #: Bench A/B toggle: False pays the cache-visibility wait per
        #: write (the reference's per-write pattern,
        #: node_upgrade_state_provider.go:100-117) instead of one
        #: amortized barrier per reconcile.
        self._deferred_visibility = deferred_visibility
        #: >0: phase processors overlap their node patches over a pool
        #: this wide, joined at a per-phase barrier (provider
        #: .pipelined_writes) — per-node round trips stop bounding a
        #: wave's wall clock over real HTTP.  0 = sequential writes,
        #: the reference's behavior.
        self._write_pipeline_workers = write_pipeline_workers
        self._pod_deletion_enabled = False
        self._validation_enabled = False
        #: Builder-configured validation settings, snapshotted before the
        #: first policy push so a removed CR validation block restores them.
        self._validation_baseline: Optional[tuple] = None
        self._common: Optional[CommonUpgradeManager] = None
        self._inplace: Optional[InplaceNodeStateManager] = None
        self._requestor = requestor
        self._use_maintenance_operator = use_maintenance_operator
        #: Incremental BuildState (see :mod:`.state_index`): keep the
        #: node→{node, driver-pod, DaemonSet} grouping resident and
        #: advance it by the watch journal, so snapshot cost is
        #: O(changed) instead of O(fleet).  Off by default — the full
        #: rebuild is the reference behavior and the fallback; pass
        #: ``use_state_index=True`` (the index is created lazily, bound
        #: to the first build's namespace/labels scope) or inject a
        #: pre-built/externally-fed *state_index*.
        self._use_state_index = use_state_index or state_index is not None
        self._state_index = state_index
        #: Remediation engine (upgrade/remediation.py): LKG rollback,
        #: failure-budget breaker, per-node retry budgets.  Constructed
        #: eagerly (cheap) but entirely inert until a policy carries a
        #: ``remediation`` block.
        self._remediation = RemediationManager(
            cluster, self._provider, recorder
        )
        #: Optional persistence of the decision-event stream as real
        #: core/v1 Events (obs/events.py); pumped once per ApplyState
        #: pass — O(changed) — when wired.  None = in-memory log only.
        self._decision_event_sink = decision_event_sink
        #: Freshest (snapshot, policy) the explain plane answers from;
        #: set by every apply_state pass.  Reads from the ops-server
        #: thread may observe a mid-pass snapshot — explain is a
        #: diagnostic read, staleness of one pass is acceptable by
        #: contract (same stance as /debug/slo).
        self._last_state: Optional[ClusterUpgradeState] = None
        self._last_policy: Optional[UpgradePolicySpec] = None
        #: Event-driven reconcile hook (controller/wakeup.py): when the
        #: assembly attaches a WakeupSource, async worker completions
        #: (drain/eviction) wake the reconcile loop at completion time
        #: instead of waiting for the next requeue tick.
        self._wakeup = None

    def set_wakeup_source(self, wakeup) -> None:
        """Attach the controller's :class:`~..controller.WakeupSource`
        so async drain/eviction worker completions schedule the next
        reconcile the moment their state writes land (their journal
        events wake the watch too — this skips even the watch loop's
        drain latency, and covers watch-less assemblies)."""
        self._wakeup = wakeup

        def _wake() -> None:
            # no guard here: each manager's _signal_wakeup already
            # wraps the call in its worker-boundary envelope
            wakeup.wake("worker")

        for mgr in (self._drain_manager, self._pod_manager):
            setter = getattr(mgr, "set_wakeup", None)
            if setter is not None:
                setter(_wake)

    def shutdown(self, wait: bool = True) -> None:
        """Release the worker-pool threads this manager owns.  Long-lived
        operators never need this (pools live as long as the process);
        short-lived managers — the plan sandbox, consumers embedding a
        manager per request — call it to avoid accumulating idle
        threads.  Injected managers/pools belong to their creators and
        are left alone."""
        for mgr in self._owned_managers:
            fn = getattr(mgr, "shutdown", None)
            if callable(fn):
                fn(wait)
        if self._owned_pool is not None:
            self._owned_pool.shutdown(wait=wait)
        if self._owned_provider:
            self._provider.close()

    # ------------------------------------------------------------- builders
    def with_pod_deletion_enabled(
        self, pod_deletion_filter: PodDeletionFilter
    ) -> "ClusterUpgradeStateManager":
        """Enable the optional pod-deletion state (reference :329-337)."""
        self._pod_manager.set_pod_deletion_filter(pod_deletion_filter)
        self._pod_deletion_enabled = True
        self._common = None
        return self

    def with_validation_enabled(self, pod_selector: str) -> "ClusterUpgradeStateManager":
        """Enable the optional validation state (reference :341-350)."""
        if not pod_selector:
            raise UpgradeStateError("validation pod selector must be non-empty")
        self._validation_manager.pod_selector = pod_selector
        self._validation_enabled = True
        self._common = None
        self._validation_baseline = None  # re-snapshot the builder config
        return self

    def with_requestor(self, requestor, enabled: bool = True) -> "ClusterUpgradeStateManager":
        """Attach the requestor-mode strategy (maintenance-operator handoff)."""
        self._requestor = requestor
        self._use_maintenance_operator = enabled
        return self

    def with_slice_coherent_safe_load(
        self, enabled: bool = True
    ) -> "ClusterUpgradeStateManager":
        """TPU-native: release a slice's safe-load barriers only once every
        host of the slice has its driver pod at the target revision, so the
        runtime never initializes the ICI fabric against old-revision
        peers (see :mod:`.safe_driver_load_manager`).  REQUIRES a
        ``slice_aware`` policy (enforced in :meth:`apply_state`): only
        domain co-scheduling guarantees a barrier-held host's peers are
        admitted in the same wave — under node-granular throttling the
        held host would pin the very slot its peer needs, wedging the
        rollout."""
        self._safe_load_manager.slice_coherent = enabled
        return self

    # ------------------------------------------------------------ accessors
    @property
    def common(self) -> CommonUpgradeManager:
        if self._common is None:
            self._common = CommonUpgradeManager(
                self._cluster,
                self._provider,
                self._cordon_manager,
                self._drain_manager,
                self._pod_manager,
                self._validation_manager,
                self._safe_load_manager,
                self._recorder,
                pod_deletion_enabled=self._pod_deletion_enabled,
                validation_enabled=self._validation_enabled,
                reader=self._reader if self._reads_from_cache else None,
            )
            self._inplace = InplaceNodeStateManager(self._common)
        return self._common

    @property
    def inplace(self) -> InplaceNodeStateManager:
        _ = self.common
        assert self._inplace is not None
        return self._inplace

    @property
    def provider(self) -> NodeUpgradeStateProvider:
        return self._provider

    @property
    def drain_manager(self) -> DrainManager:
        return self._drain_manager

    @property
    def pod_manager(self) -> PodManager:
        return self._pod_manager

    def get_requestor(self):
        """Reference: GetRequestor (upgrade_state.go:283-285)."""
        return self._requestor

    @property
    def remediation(self) -> RemediationManager:
        return self._remediation

    def remediation_status(self) -> Optional[dict]:
        """The most recent remediation decision as a JSON-able dict —
        the ``OpsServer GET /debug/remediation`` payload.  None before
        the first reconcile under a remediation-enabled policy."""
        return self._remediation.last_status()

    # -------------------------------------------------- flight recorder / SLO
    @property
    def flight_recorder(self) -> timeline_mod.FlightRecorder:
        """The recorder feeding timelines/SLO analytics (the injected
        one, else the process default).  `is None`, not truthiness: an
        empty injected recorder is falsy (len() == 0) but still chosen."""
        if self._flight is not None:
            return self._flight
        return timeline_mod.default_recorder()

    def slo_status(self) -> Optional[dict]:
        """The most recent SLO report as a JSON-able dict — the
        ``OpsServer GET /debug/slo`` payload.  None before the first
        reconcile under a policy declaring an ``slos`` block."""
        return self._slo_engine.last_report()

    def timeline_status(self, node: Optional[str] = None) -> dict:
        """The flight recorder's snapshot — the ``OpsServer GET
        /debug/timeline`` payload (*node* filters at the source)."""
        return self.flight_recorder.snapshot(node)

    def slo_history(self) -> dict:
        """The SLO metrics-history ring's snapshot — served at
        ``OpsServer GET /debug/slo?history=1`` (the windows the
        analysis engine's sustained conditions evaluate over)."""
        return self._slo_engine.history.snapshot()

    def analysis_status(self) -> Optional[dict]:
        """The analysis engine's latest report (steps, conditions with
        held-for windows, exposure, pacing scale) — the ``OpsServer GET
        /debug/analysis`` payload.  None before the first reconcile
        under a policy declaring an ``analysis`` block."""
        return self._analysis_engine.last_report()

    # -------------------------------------------------- decision-audit plane
    def events_status(self) -> dict:
        """The decision-event log's snapshot — the ``OpsServer GET
        /debug/events`` payload (the server applies ?node=/?type=/
        ?limit= filters)."""
        return events_mod.default_log().snapshot()

    def explain_node(self, node: str) -> Optional[dict]:
        """"Why is node X not progressing" — the ``OpsServer GET
        /debug/explain?node=`` payload and the live half of the
        ``explain`` CLI.  None before the first apply_state pass or for
        a node the last snapshot does not manage (the server 404s)."""
        state = self._last_state
        if state is None or not node:
            return None
        return events_mod.explain_node(
            node,
            state,
            policy=self._last_policy,
            recorder=self.flight_recorder,
            slo_report=self.slo_status(),
            decisions=events_mod.default_log().events(),
            analysis=self.analysis_status(),
        )

    # ------------------------------------------------------------ BuildState
    @property
    def state_index(self) -> Optional[ClusterStateIndex]:
        """The incremental-BuildState index, when enabled (None in full
        mode).  Created lazily on the first indexed build."""
        return self._state_index

    def build_state(
        self, namespace: str, driver_labels: Dict[str, str]
    ) -> ClusterUpgradeState:
        """Snapshot construction (reference: BuildState, :99-164) —
        from-scratch, or assembled O(changed) from the journal-driven
        :class:`~.state_index.ClusterStateIndex` when enabled."""
        started = time.monotonic()
        # Settle async-visibility debt FIRST: drain/pod worker writes
        # defer their cache-visibility waits (one amortized flush here
        # instead of one informer-lag wait per worker write), and the
        # flush-before-snapshot is exactly the contract those per-write
        # waits existed to uphold — this reconcile must not read state
        # older than the workers' own transitions.
        flush_async = getattr(self._provider, "flush_async_visibility", None)
        if flush_async is not None:
            flush_async()
        index = self._index_for(namespace, driver_labels)
        # mutable: the indexed path downgrades to "full" when its
        # internal-error fallback ends up serving a full rebuild — the
        # histogram must label what actually ran, or a persistently
        # failing index would fill the incremental series with
        # full-rebuild latencies and flatten the A/B it exists to show
        mode = {"v": "full" if index is None else "incremental"}
        with tracing.start_span(
            "BuildState", attributes={"namespace": namespace, "mode": mode["v"]}
        ) as span:
            try:
                if index is not None:
                    state = self._build_state_indexed(index)
                    if not state.built_from_index:
                        mode["v"] = "full"
                        span.set_attribute("mode", "full")
                else:
                    state = self._build_state(namespace, driver_labels)
                # Flight-recorder sweep: reconcile timelines against the
                # fresh snapshot (crash-resume checkpoint reload, other
                # writers' transitions, quarantine episodes).  Scoped by
                # the snapshot's dirty-node set, so the indexed path
                # pays O(changed) — see upgrade/timeline.py.
                self.flight_recorder.observe(state)
                return state
            finally:
                # finally: failed snapshots are exactly the slow outliers
                # the latency histogram exists to surface
                elapsed = time.monotonic() - started
                metrics.observe_reconcile(
                    "build", elapsed, trace_id=span.trace_id
                )
                metrics.observe_build_state(
                    mode["v"], elapsed, trace_id=span.trace_id
                )

    def _index_for(
        self, namespace: str, driver_labels: Dict[str, str]
    ) -> Optional[ClusterStateIndex]:
        """The index serving this build, or None for the full path.
        The index is scope-bound: a build for a different namespace /
        label set (multi-scope embedders) falls back to the full
        rebuild rather than serving a wrong-scope snapshot."""
        if not self._use_state_index:
            return None
        if self._state_index is None:
            self._state_index = ClusterStateIndex(
                self._cluster, namespace, dict(driver_labels)
            )
        index = self._state_index
        if (
            index.namespace != namespace
            or index.driver_labels != dict(driver_labels)
        ):
            metrics.record_state_index_fallback("scope-mismatch")
            return None
        return index

    def _build_state_indexed(
        self, index: ClusterStateIndex
    ) -> ClusterUpgradeState:
        _ = self.common  # managers assembled (parity with the full path)
        self._reset_revision_memo()
        index.set_requestor(self._requestor)
        try:
            state, dirty = index.build_state()
        except UpgradeStateError:
            raise  # parity errors (unscheduled pods, missing node)
        except Exception as err:  # noqa: BLE001 — availability over purity
            # An index-internal failure must never take BuildState down:
            # serve this cycle from the full rebuild, force the index
            # through a reseed, and count the fallback so steady growth
            # is visible on /metrics.
            logger.error(
                "state index build failed (%s); falling back to full "
                "rebuild", err,
            )
            metrics.record_state_index_fallback("error")
            index.invalidate()
            return self._build_state(index.namespace, index.driver_labels)
        state.dirty_nodes = dirty
        state.built_from_index = True
        return state

    def _reset_revision_memo(self) -> None:
        # fresh cycle: the DS-revision oracle re-reads ControllerRevisions
        # once, then every per-node sync check this cycle hits the memo.
        # Clearing it is load-bearing on the real manager (a stale entry
        # would judge sync against an outdated revision hash after a DS
        # template edit — pod_manager.py:108-112), so the real PodManager
        # is called directly and a rename breaks loudly; only injected
        # duck-typed stubs predating the memo surface get the getattr
        # escape (r4 advisor finding)
        if isinstance(self.pod_manager, PodManager):
            self.pod_manager.reset_revision_memo()
        else:
            getattr(self.pod_manager, "reset_revision_memo", lambda: None)()

    def _build_state(
        self, namespace: str, driver_labels: Dict[str, str]
    ) -> ClusterUpgradeState:
        common = self.common
        self._reset_revision_memo()
        state = ClusterUpgradeState()
        daemon_sets = common.get_driver_daemon_sets(namespace, driver_labels)
        pods = self._reader.list(
            "Pod",
            namespace=namespace,
            label_selector=labels_to_selector(driver_labels),
        )

        filtered: List[JsonObj] = []
        for ds in daemon_sets.values():
            ds_pods = common.get_pods_owned_by_ds(ds, pods)
            desired = (ds.get("status") or {}).get("desiredNumberScheduled", 0)
            if int(desired) != len(ds_pods):
                raise UpgradeStateError(
                    f"driver DaemonSet {ds['metadata']['name']} should not "
                    f"have unscheduled pods (desired {desired}, found "
                    f"{len(ds_pods)})"
                )
            filtered.extend(ds_pods)
        filtered.extend(common.get_orphaned_pods(pods))

        state_label = util.get_upgrade_state_label_key()
        # one snapshot Node list instead of a per-pod cache get: at 4k
        # nodes that is one store-lock acquisition per cycle, not 4k.
        # Listed from the CACHE — the exact source provider.get_node
        # reads — so a lagged cache still governs the node view even
        # when reads_from_cache is off (the reference's 'node read
        # through the informer cache' contract).
        nodes_by_name = {
            (n.get("metadata") or {}).get("name", ""): n
            for n in self._cache.list("Node")
        }
        for pod in filtered:
            owner_ds = None
            if not common.is_orphaned_pod(pod):
                owner_uid = (pod["metadata"]["ownerReferences"][0]).get("uid")
                owner_ds = daemon_sets.get(owner_uid)
            node_name = (pod.get("spec") or {}).get("nodeName", "")
            if not node_name and (pod.get("status") or {}).get("phase") == "Pending":
                logger.info(
                    "driver pod %s has no node assigned, skipping",
                    pod["metadata"]["name"],
                )
                continue
            node_state = self._build_node_upgrade_state(
                pod, owner_ds, nodes_by_name
            )
            bucket = ((node_state.node.get("metadata") or {}).get("labels") or {}).get(
                state_label, consts.UPGRADE_STATE_UNKNOWN
            )
            state.node_states.setdefault(bucket, []).append(node_state)
        return state

    def _build_node_upgrade_state(
        self, pod: JsonObj, ds: Optional[JsonObj], nodes_by_name=None
    ) -> NodeUpgradeState:
        """Reference: buildNodeUpgradeState (:354-378) — node read through
        the informer cache (or the cycle's prefetched Node snapshot)."""
        node_name = (pod.get("spec") or {}).get("nodeName", "")
        node = (nodes_by_name or {}).get(node_name)
        if node is None:
            try:
                node = self._provider.get_node(node_name)
            except NotFoundError as err:
                raise UpgradeStateError(
                    f"node {node_name} for driver pod "
                    f"{pod['metadata']['name']} not found"
                ) from err
        node_state = NodeUpgradeState(node=node, driver_pod=pod, driver_daemonset=ds)
        if self._requestor is not None and hasattr(
            self._requestor, "attach_node_maintenance"
        ):
            self._requestor.attach_node_maintenance(node_state)
        return node_state

    # ------------------------------------------------------------ ApplyState
    def apply_state(
        self, state: Optional[ClusterUpgradeState], policy: Optional[UpgradePolicySpec]
    ) -> None:
        """The 11-phase hot loop (reference: ApplyState, :171-281).

        Sets :attr:`last_apply_transitions` — how many synchronous state
        transitions this pass performed (admissions, cordons, ...); the
        reconciler uses it to stay on the active cadence right after an
        admission wave instead of sleeping the gated interval."""
        self.last_apply_transitions = 0
        if state is None:
            raise UpgradeStateError("currentState should not be empty")
        # The explain plane answers from the freshest processed snapshot.
        self._last_state = state
        self._last_policy = policy
        if policy is None or policy.remediation is None:
            # Engine off (block removed / CR deleted): retire the stale
            # decision so gauges and /debug/remediation don't keep
            # reporting the last breaker position forever.
            self._remediation.disable()
        if policy is None or (
            policy.slos is None and policy.analysis is None
        ):
            # Same retirement contract for the SLO engine: a removed
            # ``slos`` block clears the breach/burn/eta gauges and the
            # /debug/slo report.
            self._slo_engine.disable()
        else:
            # Evaluation runs under EITHER block — analysis conditions
            # need the analytics (stragglers/ETA/phase quantiles) even
            # without declared slos targets; evaluate() itself retires
            # the SLO gauge families + breach set when only the slos
            # block was removed mid-rollout.  Runs even while the
            # rollout is paused (auto_upgrade off), because a
            # paused-but-unfinished rollout is exactly when the
            # deadline burn rate matters.
            self._slo_engine.evaluate(state, policy)
        if policy is None or policy.analysis is None:
            # Removed ``analysis`` block: retire the gate/pacing gauges,
            # drop the step cursor and abort latch, and restore the
            # write pipeline's full concurrency — a removed block must
            # never keep throttling the fleet.
            self._analysis_engine.disable()
            self._set_write_concurrency_scale(1.0)
        if policy is not None:
            self._configure_from_policy(policy)
        else:
            # Policy CR deleted: none of its pushed overrides may
            # outlive it.
            self._restore_policy_defaults()
        common = self.common
        if policy is None or not policy.auto_upgrade:
            # Still re-publish the rollout gauges from the fresh snapshot:
            # a paused rollout must not leave upgrades_in_progress frozen
            # at its last active value (alerts would fire forever).
            self._publish_gauges(common, state)
            # The analysis plane stays live while paused too (the same
            # contract as the SLO engine above): the AIMD scale keeps
            # recovering once pressure clears — a pause must not freeze
            # pacing_wave_scale at its last throttle (paging
            # UpgradePacingThrottled forever) or leave the write
            # dispatcher's claim cap stuck down.  No trip/scheduling
            # happens here; a sustained abort latches and acts on
            # resume.
            if policy is not None and policy.analysis is not None:
                decision = self._analysis_engine.evaluate(
                    state,
                    policy,
                    self._slo_engine.last_report(),
                    common=common,
                )
                self._set_write_concurrency_scale(decision.wave_scale)
            # No ack_dirty: a paused pass never processed the snapshot's
            # dirty view, so the index keeps it as scan debt and the
            # scoped scans revisit those nodes once the rollout resumes.
            logger.info("auto upgrade is disabled, skipping")
            self._pump_decision_events()
            return
        if getattr(self._safe_load_manager, "slice_coherent", False):
            # Not a preference: the coherence barrier is only deadlock-free
            # when this library's own scheduler admits all hosts of a
            # domain in the same wave.  Without slice_aware, a barrier-held
            # host pins the throttle slot (and maxUnavailable budget) its
            # unsynced slice peer needs to be admitted; in requestor mode
            # admission is delegated to the external maintenance operator,
            # which grants maintenance node-by-node under its own budget —
            # the same wedge, outside our control.  Fail fast on both.
            if not policy.slice_aware:
                raise UpgradeStateError(
                    "slice-coherent safe-load requires a slice_aware "
                    "policy: a barrier-held host would otherwise pin the "
                    "throttle slot its slice peer needs, deadlocking the "
                    "rollout"
                )
            if self._use_maintenance_operator:
                raise UpgradeStateError(
                    "slice-coherent safe-load is not supported in requestor "
                    "mode: admission is delegated to the external "
                    "maintenance operator, whose node-by-node budget can "
                    "strand a barrier-held host waiting on a peer that is "
                    "never granted maintenance"
                )
        started = time.monotonic()
        with tracing.start_span(
            "ApplyState",
            attributes={"nodes": sum(len(v) for v in state.node_states.values())},
        ) as span:
            try:
                self._apply_state(common, state, policy)
                # Pass completed: the dirty view this snapshot carried
                # has been processed — settle the index's scan debt.
                # An aborted pass (cache-sync timeout, processor error)
                # skips this, so the next builds keep re-scoping the
                # unprocessed names and no input change is dropped.
                if state.built_from_index and self._state_index is not None:
                    self._state_index.ack_dirty()
            finally:
                # finally: an aborted reconcile (e.g. cache-sync timeout) is
                # the latency outlier the histogram must not silently drop
                metrics.observe_reconcile(
                    "apply", time.monotonic() - started,
                    trace_id=span.trace_id,
                )
                # finally too: the decisions an ABORTED pass already made
                # (admissions, a breaker trip) are exactly what the audit
                # stream must not lose.  One pump per pass = O(changed).
                self._pump_decision_events()

    def _pump_decision_events(self) -> None:
        """Flush this pass's decision events to the cluster sink (when
        wired).  The sink's own error envelope already guarantees a
        persistence failure never breaks a rollout."""
        if self._decision_event_sink is not None:
            self._decision_event_sink.pump()

    def _restore_policy_defaults(self) -> None:
        """Undo every policy-pushed override (topology keys, cache-sync
        timeout, validation config) when the policy CR disappears — the
        builder/constructor configuration is authoritative again."""
        from ..tpu import topology

        topology.set_label_keys()
        self._provider.set_cache_sync_timeout(0)
        self._restore_validation_baseline()

    def _restore_validation_baseline(self) -> None:
        if self._validation_baseline is None:
            return
        vm = self._validation_manager
        selector, timeout, on_missing, enabled = self._validation_baseline
        vm.pod_selector = selector
        vm.timeout_seconds = timeout
        vm.on_missing_pods = on_missing
        if enabled != self._validation_enabled:
            self._validation_enabled = enabled
            self._common = None

    def _configure_from_policy(self, policy: UpgradePolicySpec) -> None:
        """Push per-policy knobs into the managers (VERDICT r2 weak #4):
        validation selector/timeout/missing-pod behavior, slice label
        keys, cache-sync timeout.  Runs every reconcile so a live CR edit
        (CrPolicySource) reconfigures the operator without a restart.
        Builder calls (with_validation_enabled) remain authoritative when
        the policy leaves the corresponding field unset: an absent
        ``validation.podSelector`` keeps the builder's selector and
        enablement (only timeout/onMissingPods are pushed), and removing
        the ``validation`` block entirely restores the builder baseline."""
        from ..tpu import topology

        vm = self._validation_manager
        if self._validation_baseline is None:
            self._validation_baseline = (
                vm.pod_selector,
                vm.timeout_seconds,
                vm.on_missing_pods,
                self._validation_enabled,
            )
        if policy.validation is not None:
            vm.timeout_seconds = policy.validation.timeout_second
            vm.on_missing_pods = policy.validation.on_missing_pods
            if policy.validation.pod_selector is not None:
                # Explicitly set: "" disables, non-empty enables.  The
                # selector is cleared on disable too — in-flight
                # validation-required nodes then validate trivially
                # instead of running the stale selector's timeout clock
                # to upgrade-failed (the baseline still restores the
                # builder selector if the block is later removed).
                enable = bool(policy.validation.pod_selector)
                vm.pod_selector = policy.validation.pod_selector
                if enable != self._validation_enabled:
                    self._validation_enabled = enable
                    self._common = None  # rebuilt with the new phase switch
        else:
            # Validation block removed from the CR: builder wins again.
            self._restore_validation_baseline()
        topology.set_label_keys(
            policy.slice_label_keys, policy.multislice_label_keys
        )
        self._provider.set_cache_sync_timeout(policy.cache_sync_timeout_second)

    @staticmethod
    def _publish_gauges(
        common: CommonUpgradeManager, state: ClusterUpgradeState
    ) -> Tuple[int, int, int]:
        in_progress = common.get_upgrades_in_progress(state)
        pending = common.get_upgrades_pending(state)
        failed = common.get_upgrades_failed(state)
        metrics.publish_rollout_gauges(
            {k: len(v) for k, v in state.node_states.items()},
            common.get_total_managed_nodes(state),
            in_progress,
            pending,
            failed,
            common.get_upgrades_done(state),
        )
        return in_progress, pending, failed

    def _apply_state(
        self,
        common: CommonUpgradeManager,
        state: ClusterUpgradeState,
        policy: UpgradePolicySpec,
    ) -> None:
        logger.info(
            "node states: %s",
            {k or "unknown": len(v) for k, v in state.node_states.items()},
        )
        # Aggregate-progress event — the reference sketches this but leaves
        # it commented out (upgrade_state.go:199-202); here it is live,
        # gated on an active rollout so a steady-state fleet doesn't spam
        # identical events into a real sink every reconcile.
        in_progress, pending, failed = self._publish_gauges(common, state)
        if in_progress or pending or failed:
            log_event(
                self._recorder,
                util.get_component_name(),
                "Normal",
                util.get_event_reason(),
                "Upgrade progress: done {}/{} inProgress {} pending {} failed {}".format(
                    common.get_upgrades_done(state),
                    common.get_total_managed_nodes(state),
                    in_progress,
                    pending,
                    failed,
                ),
            )

        # Remediation engine (breaker/LKG/rollback census + bookkeeping):
        # runs before the phases so the admission phase sees this pass's
        # verdict; its retry processor rides the phase list below.  None
        # when the policy carries no remediation block — every downstream
        # consumer treats that as "engine off" (reference behavior).
        remediation: Optional[RemediationDecision] = None
        if policy.remediation is not None:
            remediation = self._remediation.evaluate(state, policy, common)

        # Analysis engine (SLO-driven gates + adaptive pacing): consumes
        # the SLO report evaluated above, AFTER remediation so a paused/
        # rolling-back fleet suspends the exposure gating (the rollback
        # wave must not be capped by the analysis that triggered it).
        # A fresh abort trips the breaker with the SLO reason — the
        # rollout aborts on slowness through the same LKG machinery
        # hard failures use.
        analysis: Optional[analysis_mod.AnalysisDecision] = None
        if policy.analysis is not None:
            analysis = self._analysis_engine.evaluate(
                state,
                policy,
                self._slo_engine.last_report(),
                common=common,
                remediation=remediation,
            )
            if (
                analysis.aborted
                and policy.remediation is not None
                and not (remediation is not None and remediation.paused)
            ):
                updated = self._remediation.trip_for_slo(
                    state, policy, common, analysis.abort_reason
                )
                if updated is not None:
                    remediation = updated
            # Adaptive write concurrency: the same AIMD scale that
            # modulates wave size throttles the dispatcher's worker
            # fan-out, so backpressure reaches the transport too.
            self._set_write_concurrency_scale(analysis.wave_scale)

        # All phases run under one deferred-visibility barrier: node writes
        # land immediately, and their informer-cache visibility is awaited
        # once at the end — the next reconcile still never reads stale
        # state, but N writes cost one cache-lag wait instead of N (the
        # reference pays the wait per write).
        drain_enabled = policy.drain_spec is not None and policy.drain_spec.enable
        phases = [
            # 1-2. classify unknown + done nodes
            lambda: common.process_done_or_unknown_nodes(
                state, consts.UPGRADE_STATE_UNKNOWN
            ),
            lambda: common.process_done_or_unknown_nodes(
                state, consts.UPGRADE_STATE_DONE
            ),
            # 2b. remediation recovery: release repaired nodes' retry
            #     bookkeeping/quarantine (runs even with the engine off —
            #     leftover quarantines must not outlive a removed block)
            #     and un-admit pending nodes a rollback overtook (pod
            #     already in sync — a wave pass would drain real
            #     workloads for a no-op); BEFORE admission so the
            #     scheduler never charges slots for them
            lambda: self._remediation.process_recovered_nodes(
                state, policy, common
            ),
            # 3. start upgrades up to the throttle (mode dispatch)
            lambda: self._process_upgrade_required_nodes_wrapper(
                state, policy, remediation, analysis
            ),
            # 4. cordon
            lambda: common.process_cordon_required_nodes(state),
            # 5. wait for jobs
            lambda: common.process_wait_for_jobs_required_nodes(
                state, policy.wait_for_completion
            ),
            # 6. pod deletion
            lambda: common.process_pod_deletion_required_nodes(
                state, policy.pod_deletion, drain_enabled
            ),
            # 7. drain
            lambda: common.process_drain_nodes(state, policy.drain_spec),
            # 8. node-maintenance, then the post-maintenance gate
            #    (requestor mode only; the reference declares the state but
            #    never routes through it — noted at upgrade_state.go:249-250)
            lambda: self._process_node_maintenance_required_nodes_wrapper(state),
            lambda: self._process_post_maintenance_required_nodes_wrapper(state),
            # 9. pod restart (+ failure detection)
            lambda: common.process_pod_restart_nodes(state),
            # 10. failed-node self-healing, then the remediation retry
            #     budget (backoff'd failed->upgrade-required retries,
            #     quarantine on exhaustion; no-op without a remediation
            #     policy), then validation
            lambda: common.process_upgrade_failed_nodes(state),
            lambda: self._remediation.process_failed_nodes(
                state, policy, common
            ),
            lambda: common.process_validation_required_nodes(state),
            # 11. uncordon (both modes' processors run — reference :311-325)
            lambda: self._process_uncordon_required_nodes_wrapper(state),
        ]
        # Count this pass's synchronous state transitions (thread-local
        # listener — async drain/eviction workers excluded).  The
        # reconciler reads last_apply_transitions to pick its requeue
        # cadence: a pass that just ADMITTED a wave still snapshots as
        # pending-with-nothing-in-flight (the snapshot predates the
        # transitions), and without this signal a watch-less assembly
        # pays the gated 5 s cadence per admission wave.
        transitions = {"n": 0}

        def _count(node, new_state, _t=transitions):
            _t["n"] += 1

        barrier = (
            self._provider.deferred_visibility()
            if self._deferred_visibility
            else nullcontext()
        )
        # Phase patches overlap over the write pipeline when configured.
        # ONE barrier per pass (the pipelined_writes context exit), not
        # one per phase: per-node cross-phase write order is already the
        # dispatcher's per-key FIFO contract, and a node's still-queued
        # phase-N patch composing with its phase-N+1 patch is the
        # coalescing idiom itself (composition soundness is checked per
        # pair; non-composable follow-ups ship separately, in order).
        # Errors surface at the pass barrier — the pipeline's documented
        # "deliberately late" failure envelope.  Gated on the flag so an
        # injected duck-typed provider without the pipeline surface
        # keeps working at the default (sequential) setting.
        pipelining = self._write_pipeline_workers > 0
        pipeline = (
            self._provider.pipelined_writes(self._write_pipeline_workers)
            if pipelining
            else nullcontext()
        )
        with barrier, pipeline:
            if not self._cascade:
                with self._provider.transition_listener(_count):
                    for phase in phases:
                        phase()
            else:
                # Pipelined reconcile: a state write migrates the node into
                # its new bucket *between* phases, so one pass carries a
                # node through every synchronous transition of the
                # lifecycle (admission → cordon → jobs → drain-scheduled in
                # a single reconcile instead of four).  Transitions written
                # by async drain/eviction workers are excluded (the
                # listener is thread-local) — those surface at the next
                # BuildState exactly as in the reference.  Phase order is
                # unchanged, admission throttling still happens once per
                # pass against the freshest counts, and each phase sees a
                # settled bucket (migration never mutates a list mid-
                # iteration).
                index = {
                    ns.node["metadata"]["name"]: ns
                    for ns in state.all_node_states()
                    if ns.node is not None
                }
                moves: list = []

                def _record(node, new_state):
                    _count(node, new_state)
                    moves.append((node, new_state))

                with self._provider.transition_listener(_record):
                    for phase in phases:
                        phase()
                        # moves are recorded at SUBMIT time (the
                        # listener fires with the optimistic node
                        # mutation), so bucket migration needs no
                        # write-completion barrier
                        self._migrate_buckets(state, moves, index)
        self.last_apply_transitions = transitions["n"]

    @staticmethod
    def _migrate_buckets(
        state: ClusterUpgradeState, moves: list, index: dict
    ) -> None:
        """Move nodes whose state label just changed into their new snapshot
        bucket (cascade mode only).  Batched: one filter pass over the
        affected buckets per phase instead of a scan per transition, so a
        pass stays O(fleet) however many nodes cascade."""
        if not moves:
            return
        dest: dict = {}
        for node, new_state in moves:
            name = (node.get("metadata") or {}).get("name")
            if name in index:
                dest[name] = new_state
        moves.clear()
        removed = set()
        for bucket, node_states in list(state.node_states.items()):
            kept = []
            for ns in node_states:
                name = None if ns.node is None else ns.node["metadata"].get("name")
                if name is not None and dest.get(name, bucket) != bucket:
                    removed.add(name)
                else:
                    kept.append(ns)
            if len(kept) != len(node_states):
                state.node_states[bucket] = kept
        for name in removed:
            state.node_states.setdefault(dest[name], []).append(index[name])
        # bucket membership moved: the managed-node census memo is stale
        state.invalidate_census()

    def _set_write_concurrency_scale(self, scale: float) -> None:
        """Push the AIMD wave scale into the provider's write
        dispatcher (adaptive write concurrency).  getattr-guarded for
        injected duck-typed providers predating the surface."""
        setter = getattr(self._provider, "set_write_concurrency_scale", None)
        if setter is not None:
            setter(scale)

    # ---------------------------------------------------- mode dispatchers
    def _process_upgrade_required_nodes_wrapper(
        self,
        state: ClusterUpgradeState,
        policy: UpgradePolicySpec,
        remediation: Optional[RemediationDecision] = None,
        analysis: Optional["analysis_mod.AnalysisDecision"] = None,
    ) -> None:
        """Reference: ProcessUpgradeRequiredNodesWrapper (:287-297)."""
        if self._use_maintenance_operator and self._requestor is not None:
            if analysis is not None and analysis.aborted:
                # Aborted analysis: no new NodeMaintenance handoffs —
                # the slow revision must not spread through the
                # external operator either (the breaker's stance, with
                # the SLO reason code).
                logger.info(
                    "analysis aborted; no new requestor handoffs (%s)",
                    analysis.abort_reason,
                )
                events_mod.default_log().emit_many(
                    events_mod.EVENT_NODE_DEFERRED,
                    events_mod.REASON_SLO_GATE,
                    [
                        (ns.node.get("metadata") or {}).get("name") or ""
                        for ns in state.nodes_in(
                            consts.UPGRADE_STATE_UPGRADE_REQUIRED
                        )
                    ],
                    "analysis aborted (requestor handoff paused)",
                )
                return
            if remediation is not None and remediation.paused:
                # Breaker open: no new NodeMaintenance handoffs — the bad
                # revision must not spread through the external operator
                # either.  Mid-maintenance nodes finish via the other
                # requestor processors, which keep running.
                logger.info(
                    "remediation breaker open; no new requestor handoffs"
                )
                events_mod.default_log().emit_many(
                    events_mod.EVENT_NODE_DEFERRED,
                    events_mod.REASON_REMEDIATION,
                    [
                        (ns.node.get("metadata") or {}).get("name") or ""
                        for ns in state.nodes_in(
                            consts.UPGRADE_STATE_UPGRADE_REQUIRED
                        )
                    ],
                    "remediation breaker open (requestor handoff paused)",
                )
                return
            self._requestor.process_upgrade_required_nodes(state, policy)
        else:
            self.inplace.process_upgrade_required_nodes(
                state, policy, remediation=remediation, analysis=analysis
            )

    def _process_node_maintenance_required_nodes_wrapper(
        self, state: ClusterUpgradeState
    ) -> None:
        """Reference: ProcessNodeMaintenanceRequiredNodesWrapper (:299-309)."""
        if self._use_maintenance_operator and self._requestor is not None:
            self._requestor.process_node_maintenance_required_nodes(state)

    def _process_post_maintenance_required_nodes_wrapper(
        self, state: ClusterUpgradeState
    ) -> None:
        """Post-maintenance gate before the driver-pod restart (requestor
        mode only; no-op in in-place mode, whose lifecycle never enters
        the state)."""
        if self._use_maintenance_operator and self._requestor is not None:
            self._requestor.process_post_maintenance_required_nodes(state)

    def _process_uncordon_required_nodes_wrapper(
        self, state: ClusterUpgradeState
    ) -> None:
        """Both processors run so nodes that started in-place finish
        in-place after requestor mode is enabled (reference :311-325).
        Order matters: in-place runs FIRST — it skips nodes carrying the
        requestor-mode annotation, and the requestor then strips that
        annotation; reversed, the in-place pass would see the annotation
        already gone and uncordon a node the maintenance operator (or a
        remaining shared requestor) still holds."""
        self.inplace.process_uncordon_required_nodes(state)
        if self._use_maintenance_operator and self._requestor is not None:
            self._requestor.process_uncordon_required_nodes(state)
