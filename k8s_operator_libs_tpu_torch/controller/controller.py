"""Watch-driven reconcile loop — the controller-runtime analog.

The reference is a *library linked into* controllers built on
``sigs.k8s.io/controller-runtime`` (SURVEY.md L5/L1): something else
watches the apiserver, maps events onto a rate-limited workqueue, and
calls a ``Reconcile(request)`` function with retry/backoff.  This module
supplies that missing runtime over the in-memory apiserver so the
library is standalone:

* :class:`Controller` runs one watch thread per instance consuming the
  cluster's journal (``events_since``), recovering from journal expiry
  (the 410 Gone analog) with a **relist** — exactly the informer
  list/watch contract;
* events pass through optional per-watch **predicates** (e.g. the
  requestor mode's ``ConditionChangedPredicate``) and a **mapper** from
  object to request keys (the ``handler.EnqueueRequestsFromMapFunc``
  analog);
* worker threads pull requests off a :class:`~.workqueue.RateLimitedQueue`
  and call the :class:`Reconciler`; an exception or ``Result(requeue=True)``
  re-enqueues with per-item exponential backoff, ``requeue_after`` sets
  an exact delay, success forgets the item's failure history;
* a **periodic resync** re-enqueues every mapped object so state drift
  with no triggering event (e.g. an async drain worker label write whose
  event raced a relist) is still reconciled — this is the operator
  "requeue cycle" the reference's async managers rely on
  (SURVEY.md §3.2).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Hashable, Iterable, List, Optional, Protocol

from .. import metrics
from ..cluster.errors import ExpiredError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj, WatchEvent
from ..obs import tracing
from .workqueue import RateLimitedQueue, ShutDown

logger = logging.getLogger(__name__)

#: Maps a changed object to the request keys it should enqueue.
RequestMapper = Callable[[JsonObj], Iterable[Hashable]]
#: Event filter; False drops the event before mapping.
Predicate = Callable[[WatchEvent], bool]


@dataclass(frozen=True)
class Request:
    """Default request key: one object (controller-runtime's
    reconcile.Request carries namespace/name; kind is added here because
    this substrate is not typed per-controller)."""

    kind: str
    name: str
    namespace: str = ""


@dataclass
class Result:
    """Reconciler verdict (controller-runtime's reconcile.Result)."""

    requeue: bool = False
    requeue_after: float = 0.0
    #: wakeup-attribution label for the armed requeue_after delay:
    #: ``fallback`` (a lost-event safety net, the default) or
    #: ``deadline`` (the reconciler computed WHEN the next pass is due
    #: — e.g. a maintenance-window opening).  Feeds
    #: ``reconcile_wakeups_total{trigger}`` when the delay fires.
    requeue_trigger: str = "fallback"


class Reconciler(Protocol):
    def reconcile(self, request: Hashable) -> Optional[Result]: ...


def _default_mapper(obj: JsonObj) -> Iterable[Hashable]:
    meta = obj.get("metadata") or {}
    return [
        Request(
            kind=obj.get("kind", ""),
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
        )
    ]


@dataclass
class _Watch:
    kind: str
    predicate: Optional[Predicate] = None
    mapper: RequestMapper = field(default=_default_mapper)


def _as_sinks(sink) -> tuple:
    """Normalize a sink argument: None, one callable, or an iterable of
    callables (the informer tee may feed several consumers — an
    InformerCache AND a ClusterStateIndex — off the single watch
    stream)."""
    if sink is None:
        return ()
    if callable(sink):
        return (sink,)
    return tuple(sink)


class Controller:
    """One reconciler + its watches + the queue + worker threads."""

    def __init__(
        self,
        cluster: ClusterClient,
        reconciler: Reconciler,
        *,
        name: str = "controller",
        watch_poll_seconds: float = 0.005,
        resync_seconds: float = 0.0,
        max_retries: Optional[int] = None,
        queue: Optional[RateLimitedQueue] = None,
        event_sink=None,
        relist_sink=None,
        idle_wait_seconds: Optional[float] = None,
    ) -> None:
        self._cluster = cluster
        self._reconciler = reconciler
        self.name = name
        self._poll = watch_poll_seconds
        #: How long an IDLE watch loop blocks inside the cluster's
        #: zero-latency journal wait (``wait_for_seq`` — a condition
        #: variable in-mem, the server-held ``journalwait`` long-poll
        #: over HTTP) before re-checking the stop flag.  A journal
        #: write wakes the loop immediately regardless; this only
        #: bounds shutdown latency and, on long-poll transports, the
        #: idle request rate.  None = max(watch_poll_seconds, 0.05)
        #: in-process, 0.5 s on remote transports (journalwait holds
        #: the request server-side — short holds would re-issue it at
        #: poll rate and defeat the long-poll).
        if idle_wait_seconds is not None:
            self._idle_wait = idle_wait_seconds
        elif getattr(cluster, "transport_batching", False):
            self._idle_wait = max(watch_poll_seconds, 0.5)
        else:
            self._idle_wait = max(watch_poll_seconds, 0.05)
        self._resync = resync_seconds
        self._max_retries = max_retries
        self._queue = queue or RateLimitedQueue()
        # Wakeup attribution: every ACCEPTED enqueue of a reconcile
        # request lands in reconcile_wakeups_total{trigger} — watch
        # deltas, worker completions, deadline/fallback timers, resync.
        # Only when the (possibly injected) queue has no listener of
        # its own — an embedder's observer must not be clobbered.
        if not getattr(self._queue, "has_wakeup_listener", False):
            self._queue.set_wakeup_listener(
                lambda _item, trigger: metrics.record_reconcile_wakeup(
                    trigger
                )
            )
        #: Informer tee (single-reflector rule): on HTTP backends the
        #: watch stream is pop-once, so an InformerCache sharing this
        #: client must NOT consume it too.  *event_sink* receives every
        #: drained event batch BEFORE fan-out (reconciles woken by an
        #: event then read a cache that already reflects it) —
        #: typically ``cache.ingest``, and/or the incremental-BuildState
        #: index's ``ingest`` (which feeds its dirty-node set);
        #: *relist_sink* runs on the 410 recovery path — typically
        #: ``cache.sync`` / ``index.rebuild``.  Both accept a single
        #: callable or an iterable of callables.
        self._event_sinks = _as_sinks(event_sink)
        self._relist_sinks = _as_sinks(relist_sink)
        self._watches: List[_Watch] = []
        self._threads: List[threading.Thread] = []
        #: exposed for WakeupSource assembly (upgrade_reconciler wires
        #: async worker completions into the same queue the watch
        #: feeds) — see controller/wakeup.py
        self.queue = self._queue
        self._stop = threading.Event()
        self._started = False
        #: requests whose retry budget ran out (observable for tests/ops)
        self.dropped: List[Hashable] = []

    # -------------------------------------------------------------- assembly
    def watches(
        self,
        kind: str,
        predicate: Optional[Predicate] = None,
        mapper: Optional[RequestMapper] = None,
    ) -> "Controller":
        """Register interest in a kind (controller-runtime ``Watches``)."""
        if self._started:
            raise RuntimeError("add watches before start()")
        self._watches.append(
            _Watch(kind=kind, predicate=predicate, mapper=mapper or _default_mapper)
        )
        return self

    # ------------------------------------------------------------- lifecycle
    def start(self, workers: int = 1) -> None:
        if self._started:
            raise RuntimeError("controller already started")
        if not self._watches:
            raise RuntimeError("controller has no watches")
        self._started = True
        for sink in self._relist_sinks:
            # an externally-fed cache/index may have missed frames while
            # NO controller drained the stream (HA failover gap,
            # restart): a full resync before the watch threads start
            # closes it — frames queued meanwhile re-apply under the
            # consumer's monotonic guard
            try:
                sink()
            except Exception as err:  # noqa: BLE001 — thread boundary
                logger.error(
                    "%s: startup relist sink failed: %s", self.name, err
                )
        self._enqueue_initial_list()
        watcher = threading.Thread(
            target=self._watch_loop, name=f"{self.name}-watch", daemon=True
        )
        watcher.start()
        self._threads.append(watcher)
        if self._resync > 0:
            resyncer = threading.Thread(
                target=self._resync_loop, name=f"{self.name}-resync", daemon=True
            )
            resyncer.start()
            self._threads.append(resyncer)
        for i in range(workers):
            w = threading.Thread(
                target=self._worker_loop, name=f"{self.name}-worker-{i}", daemon=True
            )
            w.start()
            self._threads.append(w)

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful: stop watching, drain workers, join threads."""
        self._stop.set()
        self._queue.shutdown()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def running(self) -> bool:
        """True while every controller thread (watcher, resyncer,
        workers) is alive — the liveness probe the assembled operator's
        /healthz serves (a dead watch loop means events stop flowing even
        though the process is up)."""
        if self._stop.is_set() or not self._threads:
            return False
        return all(t.is_alive() for t in self._threads)

    def wait_quiet(self, timeout: float = 10.0, settle: float = 0.05) -> bool:
        """Test helper: wait until there is no work at all — queued, being
        processed, or sitting in the delay heap — for *settle* seconds."""
        deadline = time.monotonic() + timeout
        quiet_since: Optional[float] = None
        while time.monotonic() < deadline:
            if self._queue.pending_work() == 0:
                if quiet_since is None:
                    quiet_since = time.monotonic()
                elif time.monotonic() - quiet_since >= settle:
                    return True
            else:
                quiet_since = None
            # the CONFIGURED poll interval, not a hardcoded 5 ms — a
            # coarse-grained assembly (big watch_poll_seconds) must not
            # busy-poll its own quiet check faster than its watch loop
            # (floored so a poll of 0 cannot spin a core)
            time.sleep(max(self._poll, 0.001))
        return False

    # ------------------------------------------------------------- internals
    def _enqueue_initial_list(self) -> int:
        """List every watched kind and enqueue (the informer's initial
        list; also the relist path after journal expiry)."""
        seq = self._cluster.journal_seq()
        for watch in self._watches:
            for obj in self._cluster.list(watch.kind):
                for request in watch.mapper(obj):
                    self._queue.add(request, "list")
        self._last_seq = seq
        return seq

    def _watch_loop(self) -> None:
        # The loop must outlive ANY exception: a dead watch thread is a
        # controller that silently never reconciles again.  Journal expiry
        # relists; a user predicate/mapper raising on one event drops that
        # event (logged — the periodic resync covers the drift; retrying a
        # deterministic mapper bug forever would hot-loop the same error);
        # transient store errors retry next poll without losing position.
        watched_kinds = tuple(sorted({w.kind for w in self._watches}))
        while not self._stop.is_set():
            try:
                # Held-stream coverage (KubeApiClient.start_held_watches):
                # events arrive pushed and pop-once — no journal head to
                # take (the drain ignores the cursor) and no HTTP per
                # poll; block on the stream's condition instead.
                held = getattr(self._cluster, "held_watch_kinds", None)
                use_held = bool(held) and set(watched_kinds) <= held
                if use_held:
                    head = self._last_seq
                    self._cluster.wait_for_held_event(
                        timeout=self._idle_wait
                    )
                else:
                    # Take the journal head BEFORE scanning: kind-filtered
                    # polls that return nothing must still advance the
                    # bookmark, else unwatched-kind churn (Lease renewals,
                    # pod writes) slides the retention window past a frozen
                    # _last_seq and every poll becomes a spurious 410
                    # relist.  Head-first ordering keeps this loss-free —
                    # events recorded after the head read are found by the
                    # next scan.
                    head = self._cluster.journal_seq()
                # Pass the watched-kind set so HTTP backends issue one
                # bounded watch per WATCHED kind, not per registered kind.
                events = self._cluster.events_since(
                    self._last_seq, kind=watched_kinds
                )
            except ExpiredError:
                # 410 Gone: the journal no longer holds our position —
                # relist everything rather than silently missing events.
                logger.info("%s: watch expired, relisting", self.name)
                self._safe_relist()
                self._stop.wait(self._poll)
                continue
            except Exception as err:  # noqa: BLE001 — thread boundary
                logger.error("%s: watch poll failed: %s", self.name, err)
                self._stop.wait(self._poll)
                continue
            if events:
                for sink in self._event_sinks:
                    try:
                        sink(events)
                    except Exception as err:  # noqa: BLE001 — thread boundary
                        logger.error(
                            "%s: event sink failed (cache may lag until "
                            "resync): %s",
                            self.name, err,
                        )
            for event in events:
                try:
                    self._fan_out(event)
                except Exception as err:  # noqa: BLE001 — thread boundary
                    logger.error(
                        "%s: dropping event seq=%d after handler error: %s",
                        self.name, event.seq, err,
                    )
                self._last_seq = max(self._last_seq, event.seq)
            self._last_seq = max(self._last_seq, head)
            if events or use_held:
                # a short coalescing window after a burst (and between
                # held-stream drains, whose blocking wait sits at the
                # loop top)
                self._stop.wait(self._poll)
            else:
                # Idle, non-held: block on the journal itself instead
                # of sleeping a fixed poll — in-mem this is a condition
                # wait (zero-latency wake on the next write, ~0 idle
                # cost); over HTTP it is the server-held `journalwait`
                # long-poll (one held request instead of an
                # events_since LIST per poll tick).  Bounded by
                # idle_wait so stop() stays responsive.
                self._idle_journal_wait()

    def _idle_journal_wait(self) -> None:
        waiter = getattr(self._cluster, "wait_for_seq", None)
        if waiter is None:
            self._stop.wait(self._poll)
            return
        try:
            waiter(self._last_seq, timeout=self._idle_wait)
        except Exception as err:  # noqa: BLE001 — thread boundary
            logger.debug("%s: journal wait failed: %s", self.name, err)
            self._stop.wait(self._poll)

    def _fan_out(self, event: WatchEvent) -> None:
        obj = event.new or event.old
        if obj is None:
            return
        kind = obj.get("kind")
        for watch in self._watches:
            if watch.kind != kind:
                continue
            if watch.predicate is not None and not watch.predicate(event):
                continue
            for request in watch.mapper(obj):
                self._queue.add(request, "watch")

    def _safe_relist(self) -> None:
        for sink in self._relist_sinks:
            try:
                sink()
            except Exception as err:  # noqa: BLE001 — thread boundary
                logger.error("%s: relist sink failed: %s", self.name, err)
        try:
            self._enqueue_initial_list()
        except Exception as err:  # noqa: BLE001 — thread boundary
            logger.error("%s: relist failed: %s", self.name, err)

    def _resync_loop(self) -> None:
        while not self._stop.wait(self._resync):
            try:
                for watch in self._watches:
                    for obj in self._cluster.list(watch.kind):
                        for request in watch.mapper(obj):
                            self._queue.add(request, "resync")
            except Exception as err:  # noqa: BLE001 — thread boundary
                logger.error("%s: resync failed: %s", self.name, err)

    def _worker_loop(self) -> None:
        while True:
            try:
                request = self._queue.get(timeout=0.5)
            except ShutDown:
                return
            if request is None:
                continue
            # The per-request root span: everything the reconciler does —
            # BuildState, ApplyState, the per-node processors, and (via
            # traceparent handoff) the async drain/eviction workers —
            # nests under it, answering "where did this reconcile go?".
            with tracing.start_span(
                "Reconcile",
                attributes={"controller": self.name, "request": str(request)},
            ) as span:
                wait = self._queue.queue_wait(request)
                if wait is not None:
                    span.set_attribute("queue_wait_s", round(wait, 6))
                    # the wait PRECEDED this span; record it as an
                    # already-elapsed child so the trace shows dequeue
                    # latency next to the work it delayed
                    tracing.record_span("queue-wait", wait, parent=span)
                try:
                    result = self._reconciler.reconcile(request)
                except Exception as err:  # noqa: BLE001 — worker boundary
                    span.set_status("error", str(err))
                    retries = self._queue.num_requeues(request)
                    if self._max_retries is not None and retries >= self._max_retries:
                        logger.error(
                            "%s: giving up on %r after %d retries: %s",
                            self.name, request, retries, err,
                        )
                        self._queue.forget(request)
                        self.dropped.append(request)
                    else:
                        logger.warning(
                            "%s: reconcile of %r failed (retry %d): %s",
                            self.name, request, retries + 1, err,
                        )
                        self._queue.add_rate_limited(request)
                    self._queue.done(request)
                    continue
                if result is not None and result.requeue_after > 0:
                    self._queue.forget(request)
                    # the queue keeps only the earliest armed delay per
                    # request, and any real event (watch / worker wake)
                    # disarms it; the trigger says whether this was a
                    # computed deadline or a lost-event safety net
                    self._queue.add_after(
                        request,
                        result.requeue_after,
                        getattr(result, "requeue_trigger", None)
                        or "fallback",
                    )
                elif result is not None and result.requeue:
                    self._queue.add_rate_limited(request)
                else:
                    self._queue.forget(request)
                self._queue.done(request)
