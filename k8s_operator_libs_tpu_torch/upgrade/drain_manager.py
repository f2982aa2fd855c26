"""DrainManager + kubectl-drain-semantics helper.

Reference parity:

* ``pkg/upgrade/drain_manager.go`` (C7) — schedules full node drains
  concurrently; per-node worker cordons then drains; success →
  ``pod-restart-required``, error → ``upgrade-failed``; in-flight nodes
  deduplicated via ``StringSet`` (:98-137); drain options built from
  ``DrainSpec`` with ``IgnoreAllDaemonSets: true`` because the managed
  component itself runs as a DaemonSet pod (:76-96).
* ``k8s.io/kubectl/pkg/drain`` Helper semantics (SURVEY.md hard part #4):
  DaemonSet pods are ignored; pods without a controller are an error
  unless ``force``; pods with emptyDir volumes are an error unless
  ``delete_empty_dir``; finished (Succeeded/Failed) pods always pass;
  grace period ``-1`` means "pod's own value"; a drain timeout bounds the
  wait for pods to actually terminate.

TPU-native extension: an optional pre-drain checkpoint gate
(:class:`~..tpu.drain_handshake.PreDrainCheckpointGate`) lets the JAX
workload on the node save an orbax checkpoint before eviction begins.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol, Tuple

from .. import metrics
from ..obs import events as events_mod, tracing
from ..api.upgrade_spec import DrainSpec
from ..cluster.errors import NotFoundError, TooManyRequestsError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..cluster.objects import (
    name_of,
    namespace_of,
    pod_has_controller,
    pod_is_daemonset_managed,
    pod_phase,
    pod_uses_empty_dir,
    uid_of,
)
from ..cluster.selectors import parse_selector
from ..cluster.writepipeline import WriteOp, transport_batch_fn
from . import consts, util
from .node_upgrade_state_provider import NodeUpgradeStateProvider
from .util import EventRecorder, StringSet, log_event

logger = logging.getLogger(__name__)


class DrainError(Exception):
    pass


# A filter returns (deletable, skip_reason_or_error). None error = pod is
# deletable or skippable; a non-None error aborts the drain plan.
PodFilter = Callable[[JsonObj], Tuple[bool, Optional[str]]]


@dataclass
class DrainHelperConfig:
    """Mirror of the kubectl ``drain.Helper`` options the reference sets
    (drain_manager.go:76-96, pod_manager.go:147-158)."""

    force: bool = False
    delete_empty_dir: bool = False
    ignore_all_daemon_sets: bool = True
    grace_period_seconds: int = -1
    timeout_seconds: int = 300
    pod_selector: str = ""
    additional_filters: List[PodFilter] = field(default_factory=list)
    #: kubectl's --disable-eviction: bypass the Eviction API (and thus
    #: PodDisruptionBudgets) and delete directly.  Default False — like
    #: kubectl, drains evict, and a PDB-blocked eviction (429) is retried
    #: until the drain timeout.
    disable_eviction: bool = False


class DrainHelper:
    """In-process reimplementation of kubectl's drain plan/execute split:
    ``get_pods_for_deletion`` builds the plan (collecting per-pod errors),
    ``delete_or_evict_pods`` executes it and waits for termination."""

    def __init__(
        self,
        cluster: ClusterClient,
        config: DrainHelperConfig,
        reader: Optional[object] = None,
    ) -> None:
        self._cluster = cluster
        self._config = config
        #: Snapshot-read source for the drain PLAN (the per-node pod
        #: list).  The informer cache when the operator runs
        #: reads_from_cache — controller-runtime parity, and over HTTP
        #: it turns one LIST round trip per drained node into a local
        #: indexed read.  Writes and the deletion wait stay on the live
        #: client either way (the wait is the correctness backstop).
        self._reader = reader if reader is not None else cluster

    def _await_cordon_visible(self, node_name: str) -> None:
        """Causal barrier for a VIEW-based drain plan: wait (bounded)
        until the informer view shows this node cordoned.  The view
        applies the journal in order, so a view that contains the
        cordon write contains every pod bound to the node BEFORE it —
        and after it the node is unschedulable, so no new pod can bind.
        Together that makes the lagged view's pod list complete for the
        plan; without the barrier a pod scheduled inside the staleness
        window could be silently skipped (never evicted, never
        checkpointed).  No-op for live readers; falls through after the
        bound for callers draining an uncordoned node (tests, force
        paths), whose exposure is unchanged from a live LIST."""
        reader = self._reader
        if reader is self._cluster or not (
            getattr(reader, "lag_seconds", 0) > 0
        ):
            return
        wait_update = getattr(reader, "wait_for_update", None)
        token = getattr(reader, "update_token", None)
        deadline = time.monotonic() + max(
            1.0, 10.0 * getattr(reader, "lag_seconds", 0)
        )
        while True:
            try:
                node = reader.get("Node", node_name)
            except NotFoundError:
                node = None
            if node is not None and (node.get("spec") or {}).get(
                "unschedulable"
            ):
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            if wait_update is not None:
                seen = token() if callable(token) else None
                wait_update(timeout=min(0.05, remaining), seen=seen)
            else:
                time.sleep(min(0.01, remaining))

    # ------------------------------------------------------------------ plan
    def get_pods_for_deletion(
        self, node_name: str
    ) -> Tuple[List[JsonObj], List[str]]:
        """Returns (pods_to_delete, errors).  Any error means the drain
        cannot proceed (kubectl aborts unless the gating flag is set)."""
        cfg = self._config
        selector = parse_selector(cfg.pod_selector)
        pods: List[JsonObj] = []
        errors: List[str] = []
        self._await_cordon_visible(node_name)
        # the apiserver-side spec.nodeName fieldSelector a real drain uses,
        # served from the store's pods-by-node index (or the informer
        # cache's local view when the operator reads from cache)
        node_pods = self._reader.list(
            "Pod", field_selector=f"spec.nodeName={node_name}"
        )
        for pod in node_pods:
            labels = (pod.get("metadata") or {}).get("labels") or {}
            if not selector(labels):
                continue
            if pod.get("metadata", {}).get("deletionTimestamp"):
                continue  # already terminating
            include = True
            for filt in cfg.additional_filters:
                deletable, err = filt(pod)
                if err is not None:
                    errors.append(err)
                    include = False
                    break
                if not deletable:
                    include = False
                    break
            if not include:
                continue
            if pod_is_daemonset_managed(pod):
                if cfg.ignore_all_daemon_sets:
                    continue
                errors.append(
                    f"cannot delete DaemonSet-managed pod {name_of(pod)}"
                )
                continue
            finished = pod_phase(pod) in ("Succeeded", "Failed")
            if not finished and not pod_has_controller(pod) and not cfg.force:
                errors.append(
                    f"cannot delete pod not managed by a controller without "
                    f"force: {name_of(pod)}"
                )
                continue
            if pod_uses_empty_dir(pod) and not cfg.delete_empty_dir:
                errors.append(
                    f"cannot delete pod with emptyDir volume without "
                    f"delete_empty_dir: {name_of(pod)}"
                )
                continue
            pods.append(pod)
        return pods, errors

    # --------------------------------------------------------------- execute
    def delete_or_evict_pods(self, pods: List[JsonObj]) -> None:
        """Evict (or, with ``disable_eviction``, delete) every pod and wait
        (≤ timeout) until each is gone.  Eviction honors
        PodDisruptionBudgets: a 429 is retried until the drain timeout,
        mirroring kubectl's ``DeleteOrEvictPods`` wait loop.  A pod
        replaced by a new instance with the same name (different uid)
        counts as gone."""
        deadline = (
            time.monotonic() + self._config.timeout_seconds
            if self._config.timeout_seconds > 0
            else None
        )
        to_evict = list(pods)
        while to_evict:
            blocked: List[JsonObj] = []
            batch_fn = transport_batch_fn(self._cluster)
            if batch_fn is not None and len(to_evict) > 1:
                # One round trip for the whole wave of evictions/deletes
                # (per-item status) instead of one per pod — drain-path
                # half of the write-pipeline fix.  Semantics per item
                # are identical to the loop below: gone already = fine,
                # PDB 429 = retry, anything else = the drain fails.
                verb = "delete" if self._config.disable_eviction else "evict"
                ops = [
                    WriteOp(
                        op=verb,
                        kind="Pod",
                        name=name_of(pod),
                        namespace=namespace_of(pod),
                        # kubectl semantics: grace -1 = pod's own
                        # terminationGracePeriodSeconds (store resolves)
                        grace_period_seconds=self._config.grace_period_seconds,
                    )
                    for pod in to_evict
                ]
                try:
                    results = batch_fn(ops)
                except TooManyRequestsError:
                    # whole POST shed (APF, after the client's own
                    # Retry-After replays): nothing applied — back off
                    # via the normal PDB retry cadence, never spray
                    results = [(None, TooManyRequestsError("shed"))] * len(ops)
                for pod, (_, err) in zip(to_evict, results):
                    if err is None or isinstance(err, NotFoundError):
                        continue
                    if isinstance(err, TooManyRequestsError):
                        blocked.append(pod)  # PDB budget exhausted — retry
                    else:
                        raise err
                to_evict = []
            for pod in to_evict:
                try:
                    # kubectl semantics: grace -1 = pod's own
                    # terminationGracePeriodSeconds (the store resolves it)
                    if self._config.disable_eviction:
                        self._cluster.delete(
                            "Pod",
                            name_of(pod),
                            namespace_of(pod),
                            grace_period_seconds=self._config.grace_period_seconds,
                        )
                    else:
                        self._cluster.evict(
                            name_of(pod),
                            namespace_of(pod),
                            grace_period_seconds=self._config.grace_period_seconds,
                        )
                except NotFoundError:
                    pass
                except TooManyRequestsError:
                    blocked.append(pod)  # PDB budget exhausted — retry
            if not blocked:
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise DrainError(
                    "drain timed out waiting for disruption budget: "
                    + ", ".join(
                        f"{namespace_of(p)}/{name_of(p)}" for p in blocked
                    )
                )
            to_evict = blocked
            # kubectl waits 5 s between eviction attempts; scaled down for
            # the in-process substrate, but long enough that a PDB-wedged
            # drain doesn't hammer the store lock every 10 ms
            time.sleep(0.25)
        pending = {(namespace_of(p), name_of(p)): uid_of(p) for p in pods}
        # Termination-wait read source: the informer cache when the
        # operator reads from cache (a deletion can only become visible
        # there because the STORE deleted the pod — the journal never
        # invents frames — so waiting on the view is safe: staleness
        # waits longer, never shorter).  This is the held-stream half of
        # the write-pipeline fix: one worker per pending pod per wake
        # previously paid a live GET round trip, plus a journal head
        # probe + long-poll each — the per-wave HTTP storm the informer
        # exists to absorb.  Live-client fallback otherwise.
        reader = self._reader
        # Only a lag-modeling cache can be AWAITED (its wait_for_update
        # blocks until the view advances); an always-fresh cache's wait
        # returns immediately by contract — using it here would turn
        # this loop into a hot spin for the whole grace period.  Fall
        # through to the journal wait / sleep for those readers.
        cache_wait = (
            getattr(reader, "wait_for_update", None)
            if getattr(reader, "lag_seconds", 0) > 0
            else None
        )
        token = getattr(reader, "update_token", None) if cache_wait else None
        waiter = getattr(self._cluster, "wait_for_seq", None)
        while pending:
            seen = token() if callable(token) else None
            for (ns, name), uid in list(pending.items()):
                try:
                    current = reader.get("Pod", name, ns)
                    if uid_of(current) != uid:
                        del pending[(ns, name)]
                except NotFoundError:
                    del pending[(ns, name)]
            if not pending:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise DrainError(
                    "drain timed out waiting for pods to terminate: "
                    + ", ".join(f"{ns}/{n}" for ns, n in pending)
                )
            remaining = (
                max(0.0, deadline - time.monotonic())
                if deadline is not None
                else 1.0
            )
            if cache_wait is not None:
                # event-driven on the informer view (zero HTTP under
                # held coverage); spurious wakeups re-check above
                cache_wait(timeout=min(0.05, remaining), seen=seen)
            elif waiter is not None:
                # event-driven: wakes the moment ANY write lands.  Head
                # is probed only when a wait is actually needed (pods
                # already gone → zero probes); a deletion landing
                # between the check above and this probe advances the
                # journal first, so the wait degrades to one bounded
                # timeout tick, never a missed event.
                head = self._cluster.journal_seq()
                waiter(head, timeout=min(1.0, remaining))
            else:
                time.sleep(0.05)


class PreDrainGate(Protocol):
    """Hook run after cordon, before eviction (TPU checkpoint handshake)."""

    def wait_for_checkpoint(self, node: JsonObj) -> None: ...


@dataclass
class DrainConfiguration:
    """Reference: DrainConfiguration (drain_manager.go:33-36)."""

    spec: DrainSpec
    nodes: List[JsonObj] = field(default_factory=list)


#: Ceiling on concurrent drain/eviction workers.  The reference spawns
#: one goroutine per node (drain_manager.go:109-133) — free in Go, not
#: in Python: a 4096-host wave must not mean 4096 threads.  Workers
#: above the bound queue inside the executor; the StringSet dedup is
#: unchanged.
DEFAULT_WORKER_POOL_SIZE = 32


class CompletionWakeupMixin:
    """Event-driven reconcile hook shared by the async node-worker
    managers (drain, pod eviction): the assembly attaches a zero-arg
    callback (``WakeupSource.wake``) via :meth:`set_wakeup`, and each
    worker calls :meth:`_signal_wakeup` after its terminal state write
    lands — the reconcile that picks the result up is then scheduled at
    completion time, not at the next fallback tick."""

    _wakeup = None

    def set_wakeup(self, wakeup) -> None:
        """Attach a zero-arg completion callback (WakeupSource.wake)."""
        self._wakeup = wakeup

    def _signal_wakeup(self) -> None:
        wakeup = self._wakeup
        if wakeup is None:
            return
        try:
            wakeup()
        except Exception as err:  # noqa: BLE001 — worker boundary
            logger.debug("worker completion wakeup failed: %s", err)


def default_worker_pool_size() -> int:
    """Drain/pod worker pool width: scales with the MACHINE, not the
    fleet.  Every Python worker thread is GIL/scheduler pressure, and
    the per-node work is a couple of short (often batched) round trips —
    on a 2-core operator pod, 32 workers spend more time convoying
    through the interpreter than overlapping I/O.  4× cores, clamped to
    [4, DEFAULT_WORKER_POOL_SIZE]."""
    return max(4, min(DEFAULT_WORKER_POOL_SIZE, 4 * (os.cpu_count() or 4)))


class DrainManager(CompletionWakeupMixin):
    """Schedules node drains on a BOUNDED worker pool (the reference's
    goroutines, with a cap); results are written via the state provider
    and picked up by the *next* reconcile (scheduled at completion time
    when a wakeup hook is attached — CompletionWakeupMixin)."""

    def __init__(
        self,
        cluster: ClusterClient,
        provider: NodeUpgradeStateProvider,
        recorder: Optional[EventRecorder] = None,
        pre_drain_gate: Optional[PreDrainGate] = None,
        cordon_manager: Optional["CordonManager"] = None,
        pool: Optional[ThreadPoolExecutor] = None,
        reader: Optional[object] = None,
    ) -> None:
        from .cordon_manager import CordonManager  # local: avoid import cycle

        self._cluster = cluster
        self._reader = reader
        self._provider = provider
        self._recorder = recorder
        self._gate = pre_drain_gate
        # provider-linked: a drain worker's cordon call stays synchronous
        # (the pipeline is thread-local and never active on workers), but
        # a reconcile-thread cordon rides the write pipeline when open.
        self._cordon_manager = cordon_manager or CordonManager(
            cluster, recorder, provider=provider
        )
        self._in_flight = StringSet()
        # Shared with PodManager when assembled by ClusterUpgradeStateManager
        # (one pool per operator, not per manager).  Threads spawn lazily,
        # so idle managers cost nothing.
        self._owns_pool = pool is None
        self._pool = pool or ThreadPoolExecutor(
            max_workers=default_worker_pool_size(),
            thread_name_prefix="drain-worker",
        )

    def shutdown(self, wait: bool = True) -> None:
        """Release worker threads (short-lived managers: plan sandboxes,
        tests).  An injected pool belongs to the assembler."""
        if self._owns_pool:
            self._pool.shutdown(wait=wait)

    @property
    def in_flight(self) -> StringSet:
        return self._in_flight

    def schedule_nodes_drain(self, config: DrainConfiguration) -> None:
        """Reference: ScheduleNodesDrain (drain_manager.go:98-137)."""
        if not config.spec or not config.spec.enable:
            raise DrainError("drain spec must be enabled to schedule drains")
        # The worker runs on a pool thread where the reconcile's context
        # is invisible; the traceparent string is the explicit carrier
        # that keeps its span inside the scheduling reconcile's trace.
        traceparent = tracing.current_traceparent()
        for node in config.nodes:
            name = name_of(node)
            if not self._in_flight.add_if_absent(name):
                logger.debug("drain already in flight for node %s", name)
                continue
            self._pool.submit(self._drain_one, node, config.spec, traceparent)

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Test/simulation helper: wait until no drains are in flight."""
        deadline = time.monotonic() + timeout
        while len(self._in_flight) > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    # ------------------------------------------------------------- internals
    def _drain_one(
        self,
        node: JsonObj,
        spec: DrainSpec,
        traceparent: Optional[str] = None,
    ) -> None:
        name = name_of(node)
        started = time.monotonic()
        with tracing.start_span(
            "drain", attributes={"node": name}, traceparent=traceparent
        ) as span:
            try:
                # Cordon first (kubectl drain always cordons).
                self._cordon_manager.cordon(node)
                if self._gate is not None:
                    self._gate.wait_for_checkpoint(node)
                helper = DrainHelper(
                    self._cluster,
                    reader=self._reader,
                    config=DrainHelperConfig(
                        force=spec.force,
                        delete_empty_dir=spec.delete_empty_dir,
                        ignore_all_daemon_sets=True,
                        grace_period_seconds=spec.grace_period_seconds,
                        timeout_seconds=spec.timeout_second,
                        pod_selector=spec.pod_selector,
                        disable_eviction=spec.disable_eviction,
                    ),
                )
                pods, errors = helper.get_pods_for_deletion(name)
                span.set_attribute("pods_evicted", len(pods))
                if errors:
                    raise DrainError("; ".join(errors))
                helper.delete_or_evict_pods(pods)
            except Exception as err:  # noqa: BLE001 — worker boundary
                logger.error("drain failed for node %s: %s", name, err)
                log_event(
                    self._recorder,
                    name,
                    "Warning",
                    util.get_event_reason(),
                    f"Failed to drain node: {err}",
                )
                span.set_status("error", str(err))
                events_mod.emit(
                    events_mod.EVENT_NODE_DRAIN_FAILED,
                    "drain-error",
                    name,
                    str(err),
                )
                metrics.record_drain(
                    "failed", time.monotonic() - started,
                    trace_id=span.trace_id,
                )
                self._finish(node, consts.UPGRADE_STATE_FAILED)
                return
            metrics.record_drain(
                "ok", time.monotonic() - started, trace_id=span.trace_id
            )
            events_mod.emit(
                events_mod.EVENT_NODE_DRAINED, "ok", name,
                "node drained successfully",
            )
            log_event(
                self._recorder,
                name,
                "Normal",
                util.get_event_reason(),
                "Node drained successfully",
            )
            self._finish(node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED)

    def _finish(self, node: JsonObj, state: str) -> None:
        name = name_of(node)

        def _on_done(err) -> None:
            if err is not None:
                logger.error(
                    "failed to update state for node %s: %s", name, err
                )
            self._in_flight.remove(name)
            self._signal_wakeup()

        # Async when the provider can (pipelined manager over a
        # batching transport): the worker thread is released to the
        # next node immediately and a wave's finish writes batch into a
        # few round trips; in_flight holds the node until the write
        # lands (released by _on_done) so wait_idle keeps its meaning.
        # Sync fallback preserves the reference behavior exactly.
        async_change = getattr(
            self._provider, "change_node_upgrade_state_async", None
        )
        try:
            if async_change is not None and async_change(
                node, state, _on_done
            ):
                return  # in_flight released by _on_done at completion
        except Exception as err:  # noqa: BLE001
            logger.error(
                "failed to update state for node %s: %s", name, err
            )
            self._in_flight.remove(name)
            self._signal_wakeup()
            return
        try:
            self._provider.change_node_upgrade_state(node, state)
        except Exception as err:  # noqa: BLE001
            logger.error(
                "failed to update state for node %s: %s", name, err
            )
        finally:
            self._in_flight.remove(name)
            self._signal_wakeup()
