"""Rate-limited work queues — the scheduling heart of the controller
runtime.

The reference library never ships an event loop: it is embedded in an
operator built on controller-runtime, whose controller feeds a client-go
``workqueue`` (SURVEY.md L5 — "calls BuildState/ApplyState each
reconcile").  To make this library standalone-usable the runtime has to
exist somewhere, so this module reimplements the client-go queue
contract the ecosystem has converged on:

* **dedup while queued** — adding an item already waiting is a no-op, so
  a burst of watch events costs one reconcile;
* **coalesce while processing** — adding an item currently being worked
  marks it dirty; ``done()`` re-queues it exactly once, so a change that
  raced the running reconcile is never lost and never duplicated;
* **delayed add** — ``add_after`` for requeue-after semantics, now
  **deadline-aware**: at most one outstanding deadline per item (the
  earliest wins; later arms while one is pending are no-ops, and a
  superseded later entry never fires), and an immediate ``add``
  disarms any pending deadline — the requeue timers the reconciler
  arms are *safety nets*, demoted the moment a real event schedules
  the pass they were covering for;
* **per-item exponential backoff** — failures retry at
  ``base * 2**retries`` capped at ``max_delay``; ``forget()`` resets on
  success.

Every accepted add carries a **trigger** string (``watch``,
``worker``, ``deadline``, ``fallback``, ...) reported to an optional
``wakeup_listener`` — the feed for ``reconcile_wakeups_total{trigger}``
— counted only when the add introduced new work (a fresh enqueue or a
coalescing dirty-mark), never for dedup'd no-ops.

Everything is condition-variable based; no busy polling.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from collections import deque
from typing import (
    Callable,
    Deque,
    Dict,
    Hashable,
    List,
    Optional,
    Set,
    Tuple,
)

logger = logging.getLogger(__name__)

#: Reported to the wakeup listener when the caller gave no trigger.
DEFAULT_TRIGGER = "direct"


class ShutDown(Exception):
    """Raised by :meth:`WorkQueue.get` after :meth:`WorkQueue.shutdown`."""


class WorkQueue:
    """Deduplicating FIFO with processing/dirty semantics (client-go's
    Type): an item is in at most one of {queued, processing}; re-adds
    during processing coalesce into a single re-queue at ``done()``."""

    def __init__(
        self,
        wakeup_listener: Optional[Callable[[Hashable, str], None]] = None,
    ) -> None:
        self._cond = threading.Condition()
        # deque, not list: get() pops from the head, and list.pop(0)
        # is O(n) — under a fleet-sized burst the queue alone would
        # cost O(n²).
        self._queue: Deque[Hashable] = deque()  #: guarded-by: _cond
        self._queued: Set[Hashable] = set()  #: guarded-by: _cond
        self._processing: Set[Hashable] = set()  #: guarded-by: _cond
        self._dirty: Set[Hashable] = set()  #: guarded-by: _cond
        self._shutting_down = False  #: guarded-by: _cond
        # queue-wait attribution (observability): when each queued item
        # was enqueued, and — while an item is being processed — how long
        # it sat queued before get() handed it out (the "queue-wait" span
        # on the reconcile trace).
        self._enqueued_at: Dict[Hashable, float] = {}  #: guarded-by: _cond
        self._last_wait: Dict[Hashable, float] = {}  #: guarded-by: _cond
        #: (item, trigger) observer fired for every ACCEPTED add — the
        #: feed for ``reconcile_wakeups_total{trigger}``.  Called
        #: outside the queue lock.
        self._wakeup_listener = wakeup_listener

    def set_wakeup_listener(
        self, listener: Optional[Callable[[Hashable, str], None]]
    ) -> None:
        """Attach (or replace) the accepted-add observer."""
        self._wakeup_listener = listener

    @property
    def has_wakeup_listener(self) -> bool:
        """True when an accepted-add observer is installed — the
        Controller's don't-clobber guard for injected queues."""
        return self._wakeup_listener is not None

    def _notify_wakeup(self, item: Hashable, trigger: str) -> None:
        listener = self._wakeup_listener
        if listener is None:
            return
        try:
            listener(item, trigger)
        except Exception as err:  # noqa: BLE001 — observer boundary
            logger.error("workqueue wakeup listener failed: %s", err)

    def add(self, item: Hashable, trigger: str = DEFAULT_TRIGGER) -> bool:
        """Enqueue *item*; returns True when the add introduced new
        work — a fresh enqueue, or a coalescing dirty-mark on an item
        currently being processed (it will run exactly one more pass).
        A dedup'd no-op (already queued) and a post-shutdown add
        return False and are not reported to the wakeup listener."""
        with self._cond:
            if self._shutting_down:
                return False
            if item in self._processing:
                accepted = item not in self._dirty
                self._dirty.add(item)
            elif item in self._queued:
                accepted = False
            else:
                accepted = True
                self._queued.add(item)
                self._queue.append(item)
                self._enqueued_at[item] = time.monotonic()
                self._cond.notify()
        if accepted:
            self._notify_wakeup(item, trigger)
        return accepted

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        """Next item, blocking up to *timeout* (None = forever).  Returns
        None on timeout; raises :class:`ShutDown` once the queue is both
        shut down and drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue:
                if self._shutting_down:
                    raise ShutDown()
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            item = self._queue.popleft()
            self._queued.discard(item)
            self._processing.add(item)
            enqueued = self._enqueued_at.pop(item, None)
            if enqueued is not None:
                self._last_wait[item] = time.monotonic() - enqueued
            return item

    def queue_wait(self, item: Hashable) -> Optional[float]:
        """Seconds *item* sat queued before the get() that handed it to
        the current processor; None when unknown.  Valid between get()
        and done() — the window the worker's reconcile span is open."""
        with self._cond:
            return self._last_wait.get(item)

    def done(self, item: Hashable) -> None:
        """Mark processing finished; a dirty item goes straight back in."""
        with self._cond:
            self._processing.discard(item)
            self._last_wait.pop(item, None)
            if item in self._dirty:
                self._dirty.discard(item)
                if not self._shutting_down and item not in self._queued:
                    self._queued.add(item)
                    self._queue.append(item)
                    self._enqueued_at[item] = time.monotonic()
                    self._cond.notify()
            elif self._shutting_down and not self._processing:
                self._cond.notify_all()

    def shutdown(self) -> None:
        with self._cond:
            self._shutting_down = True
            # Queued items stay drainable (client-go: Get keeps handing
            # out until empty after ShutDown), but per-item bookkeeping
            # that only serves FUTURE adds/attribution is dropped now —
            # a queue shut down with items still waiting must not pin
            # their enqueue stamps (or dirty marks) for the rest of the
            # process lifetime.
            self._enqueued_at.clear()
            self._dirty.clear()
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._cond:
            return self._shutting_down

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    def pending_work(self) -> int:
        """Items queued + items currently being processed (dirty items are
        a subset of processing).  Subclasses add their delayed items."""
        with self._cond:
            return len(self._queue) + len(self._processing)


class ExponentialBackoffRateLimiter:
    """Per-item ``base * 2**failures`` delay, capped (client-go's
    ItemExponentialFailureRateLimiter)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 60.0) -> None:
        self._base = base_delay
        self._max = max_delay
        self._lock = threading.Lock()
        self._failures: Dict[Hashable, int] = {}

    def when(self, item: Hashable) -> float:
        with self._lock:
            failures = self._failures.get(item, 0)
            self._failures[item] = failures + 1
        return min(self._base * (2 ** failures), self._max)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def clear(self) -> None:
        """Drop all failure history (queue shutdown)."""
        with self._lock:
            self._failures.clear()


class RateLimitedQueue(WorkQueue):
    """WorkQueue + deadline-aware delayed adds + per-item backoff.  One
    background timer thread moves due items from the delay heap into
    the queue.

    Deadline semantics: at most ONE live deadline per item — the
    earliest armed one.  Re-arming with a later due time while one is
    pending is a no-op; an earlier due time supersedes (the stale later
    heap entry is skipped when it surfaces).  An immediate :meth:`add`
    disarms any pending deadline: the requeue timers the reconciler
    arms are safety nets, and the event that just scheduled the pass
    makes them obsolete — without this, every event-driven pass would
    be chased by its own demoted fallback firing a no-op pass later."""

    def __init__(
        self,
        rate_limiter: Optional[ExponentialBackoffRateLimiter] = None,
        wakeup_listener: Optional[Callable[[Hashable, str], None]] = None,
    ) -> None:
        super().__init__(wakeup_listener=wakeup_listener)
        self._limiter = rate_limiter or ExponentialBackoffRateLimiter()
        self._delay_cond = threading.Condition()
        self._heap: List[Tuple[float, int, Hashable, str]] = []  #: guarded-by: _delay_cond
        #: earliest live deadline per item (monotonic due time) — heap
        #: entries not matching it are stale and skipped on pop
        self._armed: Dict[Hashable, float] = {}  #: guarded-by: _delay_cond
        # items popped from the heap but not yet add()ed — bridges the
        # cross-lock handoff so pending_work() never under-counts
        self._handoff = 0  #: guarded-by: _delay_cond
        self._seq = itertools.count()
        self._timer = threading.Thread(target=self._timer_loop, daemon=True)
        self._timer.start()

    def add(self, item: Hashable, trigger: str = DEFAULT_TRIGGER) -> bool:
        accepted = super().add(item, trigger)
        if accepted:
            # The item is scheduled NOW — a pending safety-net deadline
            # is obsolete (its stale heap entry is skipped on surfacing).
            with self._delay_cond:
                self._armed.pop(item, None)
        return accepted

    def add_after(
        self, item: Hashable, delay: float, trigger: str = "deadline"
    ) -> None:
        if delay <= 0:
            self.add(item, trigger)
            return
        due = time.monotonic() + delay
        with self._delay_cond:
            current = self._armed.get(item)
            if current is not None and current <= due:
                return  # an earlier-or-equal wakeup is already armed
            self._armed[item] = due
            heapq.heappush(
                self._heap, (due, next(self._seq), item, trigger)
            )
            self._delay_cond.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        self.add_after(item, self._limiter.when(item), trigger="retry")

    def forget(self, item: Hashable) -> None:
        self._limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self._limiter.num_requeues(item)

    def shutdown(self) -> None:
        super().shutdown()
        with self._delay_cond:
            # Delayed items can never fire after shutdown (the timer
            # thread exits and add() no-ops) — holding them, or the
            # limiter's per-item failure history, would leak forever on
            # a queue that outlives its controller.
            self._heap.clear()
            self._armed.clear()
            self._delay_cond.notify_all()
        self._limiter.clear()

    def pending_work(self) -> int:
        with self._delay_cond:
            # the LIVE deadlines, not the heap: superseded/disarmed
            # entries still sit in the heap but will never fire
            delayed = len(self._armed) + self._handoff
        return super().pending_work() + delayed

    # ------------------------------------------------------------- internals
    def _timer_loop(self) -> None:
        while True:
            with self._delay_cond:
                if self.shutting_down:
                    return
                if not self._heap:
                    self._delay_cond.wait(0.5)
                    continue
                due, _, item, trigger = self._heap[0]
                now = time.monotonic()
                if due > now and self._armed.get(item) == due:
                    self._delay_cond.wait(min(due - now, 0.5))
                    continue
                heapq.heappop(self._heap)
                if self._armed.get(item) != due:
                    # superseded by an earlier arm, or disarmed by an
                    # immediate add — a dead entry, never delivered
                    # (stale heads are discarded without waiting out
                    # their due time)
                    continue
                del self._armed[item]
                self._handoff += 1
            try:
                self.add(item, trigger)
            finally:
                with self._delay_cond:
                    self._handoff -= 1
