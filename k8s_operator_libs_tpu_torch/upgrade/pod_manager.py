"""PodManager — workload-pod eviction, driver-pod restart, completion wait.

Reference parity: ``pkg/upgrade/pod_manager.go`` (C5) —

* ``schedule_pod_eviction`` (:122-229): per-node background worker deletes
  workload pods matching the consumer-supplied ``PodDeletionFilter``
  through the drain helper; success → ``pod-restart-required``; failure →
  drain-or-failed fallback (:393-403);
* ``schedule_pods_restart`` (:233-251): deletes driver pods so the
  DaemonSet recreates them at the new revision (skips already-terminating
  pods upstream);
* ``schedule_check_on_pod_completion`` (:256-317): waits for workload
  pods to finish; timeout tracked via a start-time node annotation
  (:331-368);
* revision-hash oracle (:84-118): pod's ``controller-revision-hash``
  label vs the DaemonSet's newest ControllerRevision.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait as futures_wait
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..api.upgrade_spec import PodDeletionSpec, WaitForCompletionSpec
from ..cluster.errors import NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..cluster.objects import (
    CONTROLLER_REVISION_HASH_LABEL,
    is_owned_by,
    name_of,
    namespace_of,
    pod_phase,
)
from ..cluster.writepipeline import WriteOp, transport_batch_fn
from ..obs import tracing
from . import consts, util
from .drain_manager import (
    CompletionWakeupMixin,
    DrainHelper,
    DrainHelperConfig,
)
from .node_upgrade_state_provider import NodeUpgradeStateProvider
from .util import EventRecorder, StringSet, log_event

logger = logging.getLogger(__name__)

#: Consumer-supplied predicate choosing which workload pods the upgrade
#: flow may delete (reference: PodDeletionFilter, pod_manager.go:76).
PodDeletionFilter = Callable[[JsonObj], bool]


class PodManagerError(Exception):
    pass


@dataclass
class PodManagerConfig:
    """Reference: PodManagerConfig (pod_manager.go:63-68)."""

    nodes: List[JsonObj] = field(default_factory=list)
    deletion_spec: Optional[PodDeletionSpec] = None
    wait_for_completion_spec: Optional[WaitForCompletionSpec] = None
    drain_enabled: bool = False


class PodManager(CompletionWakeupMixin):
    def __init__(
        self,
        cluster: ClusterClient,
        provider: NodeUpgradeStateProvider,
        recorder: Optional[EventRecorder] = None,
        pod_deletion_filter: Optional[PodDeletionFilter] = None,
        pool: Optional[ThreadPoolExecutor] = None,
        revision_reader=None,
    ) -> None:
        from .drain_manager import default_worker_pool_size

        self._cluster = cluster
        #: ControllerRevision reads for the revision-hash oracle — an
        #: informer cache when the state manager runs cache-backed
        #: (controller-runtime parity), else the cluster itself.
        self._revision_reader = (
            revision_reader if revision_reader is not None else cluster
        )
        self._provider = provider
        self._recorder = recorder
        self._filter = pod_deletion_filter
        self._nodes_in_progress = StringSet()
        # Shared with DrainManager when assembled by the state manager —
        # one bounded pool per operator.  The reference spawns a goroutine
        # per node (pod_manager.go:164-223, 275-312); a 1,000-node
        # pod-deletion wave here queues on a few dozen threads instead.
        self._owns_pool = pool is None
        self._pool = pool or ThreadPoolExecutor(
            max_workers=default_worker_pool_size(),
            thread_name_prefix="pod-worker",
        )
        # Completion checks are short API reads gathered synchronously by
        # the reconcile loop; they get their own small pool so they never
        # queue behind minutes-long drain/eviction workers sharing _pool
        # (threads spawn lazily — an idle pool costs nothing).
        self._check_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="pod-check"
        )
        # DS-revision oracle memo, keyed (uid, resourceVersion), cleared
        # by the state manager at the top of every reconcile cycle
        # (reset_revision_memo).  Without it the loop re-lists
        # ControllerRevisions once per NODE per cycle — the dominant
        # read at fleet scale.  Per-cycle clearing (not trust in the rv
        # key alone) is load-bearing: between a DS template edit and the
        # controller cutting the new ControllerRevision, a lookup would
        # otherwise cache the OLD newest revision against the NEW rv and
        # never heal.
        self._ds_hash_memo: dict = {}
        self._ds_hash_lock = threading.Lock()

    def shutdown(self, wait: bool = True) -> None:
        """Release worker threads.  Embedders running short-lived managers
        (the plan sandbox, tests) call this; a pool injected by the
        assembler is the assembler's to shut down."""
        self._check_pool.shutdown(wait=wait)
        if self._owns_pool:
            self._pool.shutdown(wait=wait)

    def set_pod_deletion_filter(self, pod_deletion_filter: PodDeletionFilter) -> None:
        """Install the consumer's eviction predicate (reference passes it to
        NewPodManager, pod_manager.go:407-422; the builder pattern on the
        state manager sets it post-construction)."""
        self._filter = pod_deletion_filter

    # ---------------------------------------------------- revision-hash oracle
    def get_pod_controller_revision_hash(self, pod: JsonObj) -> str:
        """Reference: GetPodControllerRevisionHash (pod_manager.go:84-89)."""
        labels = (pod.get("metadata") or {}).get("labels") or {}
        hash_ = labels.get(CONTROLLER_REVISION_HASH_LABEL)
        if not hash_:
            raise PodManagerError(
                f"controller-revision-hash label not present for pod "
                f"{name_of(pod)}"
            )
        return hash_

    def reset_revision_memo(self) -> None:
        """Drop the per-cycle DS-revision memo (called by the state
        manager before each BuildState so every cycle observes fresh
        ControllerRevisions exactly once)."""
        with self._ds_hash_lock:
            self._ds_hash_memo.clear()

    def get_daemonset_controller_revision_hash(self, daemonset: JsonObj) -> str:
        """Newest ControllerRevision owned by the DaemonSet (reference:
        GetDaemonsetControllerRevisionHash, pod_manager.go:92-119 — sorts by
        .revision, takes the highest, strips the name prefix).  Memoized
        per (uid, resourceVersion) within a reconcile cycle — see
        ``reset_revision_memo``."""
        meta = daemonset.get("metadata") or {}
        memo_key = (meta.get("uid", ""), meta.get("resourceVersion", ""))
        if all(memo_key):
            with self._ds_hash_lock:
                hit = self._ds_hash_memo.get(memo_key)
            if hit is not None:
                return hit
        ds_name = name_of(daemonset)
        # Ownership is the authoritative filter; the name-prefix fallback is
        # only for revisions that carry no ownerReferences at all (e.g.
        # restored from a backup).  A bare prefix match alone would also
        # capture another DaemonSet's revisions when names overlap
        # ("tpu-runtime" vs "tpu-runtime-v2") — the reference avoids this by
        # filtering with the DS's label selector first (pod_manager.go:95).
        revisions = [
            cr
            for cr in self._revision_reader.list(
                "ControllerRevision", namespace=namespace_of(daemonset)
            )
            if is_owned_by(cr, daemonset)
            or (
                not (cr.get("metadata") or {}).get("ownerReferences")
                and name_of(cr).startswith(f"{ds_name}-")
            )
        ]
        if not revisions:
            raise PodManagerError(f"no revision found for daemonset {ds_name}")
        newest = max(revisions, key=lambda cr: cr.get("revision", 0))
        cr_name = name_of(newest)
        prefix = f"{ds_name}-"
        result = cr_name[len(prefix):] if cr_name.startswith(prefix) else cr_name
        if all(memo_key):
            with self._ds_hash_lock:
                if len(self._ds_hash_memo) > 256:  # unreset-embedder bound
                    self._ds_hash_memo.clear()
                self._ds_hash_memo[memo_key] = result
        return result

    # -------------------------------------------------------------- eviction
    def schedule_pod_eviction(self, config: PodManagerConfig) -> None:
        """Reference: SchedulePodEviction (pod_manager.go:122-229)."""
        if config.deletion_spec is None:
            raise PodManagerError("pod deletion spec should not be empty")
        if self._filter is None:
            # The reference makes the filter a mandatory constructor argument
            # (NewPodManager, pod_manager.go:407-422); without one, eviction
            # would silently delete nothing and advance nodes over live
            # workloads.
            raise PodManagerError(
                "pod_deletion_filter is required to schedule pod eviction"
            )
        # Carried explicitly: the worker thread cannot see the scheduling
        # reconcile's span context (same pattern as DrainManager).
        traceparent = tracing.current_traceparent()
        for node in config.nodes:
            name = name_of(node)
            if not self._nodes_in_progress.add_if_absent(name):
                logger.debug("pods already being deleted on node %s", name)
                continue
            self._pool.submit(
                self._evict_one, node, config.deletion_spec,
                config.drain_enabled, traceparent,
            )

    def _evict_one(
        self,
        node: JsonObj,
        spec: PodDeletionSpec,
        drain_enabled: bool,
        traceparent: Optional[str] = None,
    ) -> None:
        with tracing.start_span(
            "pod-eviction",
            attributes={"node": name_of(node)},
            traceparent=traceparent,
        ):
            self._evict_one_traced(node, spec, drain_enabled)

    def _evict_one_traced(
        self, node: JsonObj, spec: PodDeletionSpec, drain_enabled: bool
    ) -> None:
        name = name_of(node)
        try:
            try:
                pods_on_node = self._cluster.list(
                    "Pod", field_selector=f"spec.nodeName={name}"
                )
                to_delete = [
                    p for p in pods_on_node if self._filter and self._filter(p)
                ]
                if not to_delete:
                    self._change_state(
                        node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                    )
                    return
                # Run the deletion through the drain-helper plan so force/
                # emptyDir gating applies (reference wires the filter in as
                # an AdditionalFilter, pod_manager.go:139-158).
                filt = self._filter

                def additional(pod: JsonObj):
                    return (bool(filt and filt(pod)), None)

                helper = DrainHelper(
                    self._cluster,
                    DrainHelperConfig(
                        force=spec.force,
                        delete_empty_dir=spec.delete_empty_dir,
                        ignore_all_daemon_sets=True,
                        timeout_seconds=spec.timeout_second,
                        additional_filters=[additional],
                    ),
                )
                plan, errors = helper.get_pods_for_deletion(name)
                if len(plan) != len(
                    [p for p in to_delete if not p["metadata"].get("deletionTimestamp")]
                ):
                    raise PodManagerError(
                        "cannot delete all required pods: " + "; ".join(errors)
                    )
                helper.delete_or_evict_pods(plan)
            except Exception as err:  # noqa: BLE001 — worker boundary
                logger.error("pod deletion failed on node %s: %s", name, err)
                log_event(
                    self._recorder,
                    name,
                    "Warning",
                    util.get_event_reason(),
                    f"Failed to delete workload pods on the node: {err}",
                )
                self._update_node_to_drain_or_failed(node, drain_enabled)
                return
            log_event(
                self._recorder,
                name,
                "Normal",
                util.get_event_reason(),
                "Deleted workload pods on the node for the upgrade",
            )
            self._change_state(node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED)
        finally:
            self._nodes_in_progress.remove(name)
            # async worker completion: wake the reconcile loop so the
            # result is picked up now, not at the next fallback tick
            self._signal_wakeup()

    def _update_node_to_drain_or_failed(
        self, node: JsonObj, drain_enabled: bool
    ) -> None:
        """Reference: updateNodeToDrainOrFailed (pod_manager.go:393-403)."""
        next_state = consts.UPGRADE_STATE_FAILED
        if drain_enabled:
            log_event(
                self._recorder,
                name_of(node),
                "Warning",
                util.get_event_reason(),
                "Pod deletion failed but drain is enabled in spec. "
                "Will attempt a node drain",
            )
            next_state = consts.UPGRADE_STATE_DRAIN_REQUIRED
        self._change_state(node, next_state)

    # --------------------------------------------------------------- restart
    def schedule_pods_restart(self, pods: List[JsonObj]) -> None:
        """Delete driver pods so their DaemonSet recreates them at the new
        revision (reference: SchedulePodsRestart, pod_manager.go:233-251 —
        synchronous; an individual failure aborts with an error)."""
        if not pods:
            return
        with tracing.start_span(
            "pod-restart", attributes={"pods": len(pods)}
        ):
            batch_fn = transport_batch_fn(self._cluster)
            if batch_fn is not None and len(pods) > 1:
                # One round trip deletes the whole wave's driver pods
                # (per-item status; the DaemonSet controller recreates
                # them) — same contract as the loop below: already-gone
                # pods are fine, the first real failure aborts.
                ops = [
                    WriteOp(
                        op="delete",
                        kind="Pod",
                        name=name_of(pod),
                        namespace=namespace_of(pod),
                    )
                    for pod in pods
                ]
                for pod, (_, err) in zip(pods, batch_fn(ops)):
                    if err is None or isinstance(err, NotFoundError):
                        continue
                    log_event(
                        self._recorder,
                        name_of(pod),
                        "Warning",
                        util.get_event_reason(),
                        f"Failed to restart driver pod {err}",
                    )
                    raise err
                return
            for pod in pods:
                try:
                    self._cluster.delete(
                        "Pod", name_of(pod), namespace_of(pod)
                    )
                except NotFoundError:
                    pass
                except Exception as err:  # noqa: BLE001
                    log_event(
                        self._recorder,
                        name_of(pod),
                        "Warning",
                        util.get_event_reason(),
                        f"Failed to restart driver pod {err}",
                    )
                    raise

    # -------------------------------------------------------- completion wait
    def is_pod_running_or_pending(self, pod: JsonObj) -> bool:
        """Reference: IsPodRunningOrPending (pod_manager.go:371-391)."""
        return pod_phase(pod) in ("Running", "Pending")

    def schedule_check_on_pod_completion(self, config: PodManagerConfig) -> None:
        """Check workload pods matching the wait-for-completion selector on
        every node; nodes whose pods are all finished move to
        ``pod-deletion-required``.  Unlike eviction/drain this runs
        synchronously (the reference waits on its WaitGroup before
        returning, pod_manager.go:256-317)."""
        spec = config.wait_for_completion_spec
        if spec is None:
            raise PodManagerError("wait-for-completion spec required")
        # One check per node, fanned out on the bounded pool and gathered
        # before returning (the reference's per-node goroutines + WaitGroup,
        # pod_manager.go:275-312) — the per-node API round trips overlap.
        futures = [
            self._check_pool.submit(self._check_one_node_completion, node, spec)
            for node in config.nodes
        ]
        futures_wait(futures)
        for f in futures:
            if f.exception() is not None:
                raise f.exception()

    def _check_one_node_completion(
        self, node: JsonObj, spec: WaitForCompletionSpec
    ) -> None:
        name = name_of(node)
        pods = self._cluster.list(
            "Pod",
            label_selector=spec.pod_selector,
            field_selector=f"spec.nodeName={name}",
        )
        running = any(self.is_pod_running_or_pending(p) for p in pods)
        if running:
            if spec.timeout_second != 0:
                self._handle_timeout_on_pod_completions(
                    node, spec.timeout_second
                )
            return
        # All finished: clear the start-time annotation and advance.
        key = util.get_wait_for_pod_completion_start_time_annotation_key()
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        if key in annotations:
            self._provider.change_node_upgrade_annotation(
                node, key, consts.NULL_STRING
            )
        self._change_state(node, consts.UPGRADE_STATE_POD_DELETION_REQUIRED)

    def _handle_timeout_on_pod_completions(
        self, node: JsonObj, timeout_seconds: int
    ) -> None:
        """Reference: HandleTimeoutOnPodCompletions (pod_manager.go:331-368)."""
        key = util.get_wait_for_pod_completion_start_time_annotation_key()
        now = time.time()
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        if key not in annotations:
            self._provider.change_node_upgrade_annotation(
                node, key, str(int(now))
            )
            return
        try:
            start = float(annotations[key])
        except ValueError:
            # Malformed start-time (external writer): self-heal by restarting
            # the clock instead of crashing the reconcile loop.
            logger.error(
                "malformed completion-wait start time %r on node %s; resetting",
                annotations[key],
                name_of(node),
            )
            self._provider.change_node_upgrade_annotation(
                node, key, str(int(now))
            )
            return
        if now > start + timeout_seconds:
            self._change_state(
                node, consts.UPGRADE_STATE_POD_DELETION_REQUIRED
            )
            self._provider.change_node_upgrade_annotation(
                node, key, consts.NULL_STRING
            )

    # ------------------------------------------------------------- internals
    @property
    def nodes_in_progress(self) -> StringSet:
        return self._nodes_in_progress

    def wait_idle(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while len(self._nodes_in_progress) > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def _change_state(self, node: JsonObj, state: str) -> None:
        try:
            self._provider.change_node_upgrade_state(node, state)
        except Exception as err:  # noqa: BLE001
            logger.error(
                "failed to change state of node %s: %s", name_of(node), err
            )
