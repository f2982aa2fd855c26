"""Async batched write pipeline — the client-side half of the write path.

Over a real transport each node transition costs several serialized
round trips, where the in-memory store applies the same write in
microseconds.  This module removes the serialization without weakening
any write-ordering contract:

* :class:`WriteOp` — one cluster write (patch / update / create /
  delete / evict) as data, so writes can be queued, coalesced, batched
  and shipped instead of being a closure around a blocking call;
* :func:`try_compose_merge_patch` — RFC 7386 patch composition, used to
  coalesce consecutive merge patches to the same object into ONE round
  trip (the "timeline checkpoint rides the state-label patch" idiom
  from the flight recorder, generalized to every same-object pair whose
  composition is sound);
* :func:`apply_write_op` — apply one op through any
  :class:`~.client.ClusterClient`; shared by the in-memory parity path,
  the apiserver facade's batch endpoint, and the HTTP client's
  degraded (no-batch-endpoint) fallback so all four agree byte-for-byte;
* :class:`WriteDispatcher` — the concurrent dispatcher: bounded worker
  fan-out, **ordered-per-object** delivery (per-key FIFO; a key never
  has two writes in flight), KeyedMutex interop with the synchronous
  write paths (drain/eviction workers), opportunistic same-key
  coalescing, one `batch_write` round trip per claimed batch, and
  drain-and-retry behavior under apiserver 429 backpressure (the
  dispatcher backs off; it never amplifies a brownout by spraying
  more requests).

Ordering contract (the ``KeyedMutex`` contract from ``upgrade/util.py``
lifted to the transport): for any single object, writes are applied in
submit order — queued writes for a key form a FIFO, at most one of them
is ever in flight, and while a batch holding the key is on the wire the
dispatcher holds that key's mutex so synchronous writers (drain
workers) serialize against it exactly as they do against each other.
A FAILED write fails its still-queued same-key successors with the
same error (the synchronous contract: a raise prevents the next write
from ever being issued); writes submitted after the failure start a
fresh per-key program.  Cross-object order is deliberately
unspecified, as it always was.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import ExitStack
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from .client import JsonObj
from .errors import ApiError, BadRequestError, NotFoundError, TooManyRequestsError

logger = logging.getLogger(__name__)

#: REST path of the facade's opt-in batch endpoint.  Deliberately outside
#: every registered kind's route so a vanilla apiserver 404s it and the
#: client degrades to per-op writes transparently.
BATCH_WRITE_PATH = "/apis/ops.nvidia.com/v1/batchwrites"
BATCH_WRITE_API_VERSION = "ops.nvidia.com/v1"
#: Opt-in journal long-poll (same degrade rule as the batch endpoint):
#: GET ?seq=N&timeoutSeconds=T blocks server-side until the journal
#: advances past N, replacing the client's 50 ms journal_seq poll loop
#: (one round trip per wait instead of up to 20/s per waiting drain
#: worker).  A vanilla apiserver 404s it and the client falls back.
JOURNAL_WAIT_PATH = "/apis/ops.nvidia.com/v1/journalwait"
#: Server-side ceiling on one long-poll hold.
MAX_JOURNAL_WAIT_SECONDS = 30.0
#: Server-side cap on items per batch request (a real apiserver bounds
#: request bodies the same way; the dispatcher never sends more than its
#: own ``max_batch`` anyway).
MAX_BATCH_ITEMS = 512

#: One write's outcome: (returned object or None, error or None).  The
#: error is an ApiError on every server-originated failure; per-op mode
#: additionally preserves non-ApiError faults raised by injected/faked
#: clients so a caller's error contract survives pipelining unchanged.
WriteResult = Tuple[Optional[JsonObj], Optional[Exception]]


@dataclass(frozen=True)
class WriteOp:
    """One cluster write as data (see module docstring)."""

    op: str  # "patch" | "update" | "create" | "delete" | "evict"
    kind: str = ""
    name: str = ""
    namespace: str = ""
    body: Optional[JsonObj] = None
    patch_type: str = "merge"
    grace_period_seconds: Optional[int] = None
    #: delete/evict of an already-gone object is success for every
    #: caller in this library (kubectl semantics); set per-op so the
    #: dispatcher can swallow the NotFound instead of failing the pass.
    ignore_not_found: bool = False

    def key(self) -> Tuple[str, str, str]:
        return (self.kind, self.namespace, self.name)


def try_compose_merge_patch(
    first: Optional[JsonObj], second: Optional[JsonObj]
) -> Optional[JsonObj]:
    """The single merge patch equivalent to applying *first* then
    *second* (RFC 7386), or ``None`` when no such patch exists.

    Composition rules: *second*'s leaves (scalars and nulls) overwrite;
    overlapping sub-objects compose recursively; a *second* sub-object
    landing on a *first* LEAF is not composable — sequential application
    replaces the leaf then merges into the replacement, which a single
    merge patch cannot express against an arbitrary target — so the
    caller must keep the writes separate.  Patches carrying a
    ``metadata.resourceVersion`` optimistic lock are never composed
    (each write's conflict check must run against the server)."""
    if first is None or second is None:
        return None
    for p in (first, second):
        if ((p.get("metadata") or {}).get("resourceVersion")) is not None:
            return None
    return _compose(first, second)


def _compose(first: JsonObj, second: JsonObj) -> Optional[JsonObj]:
    out = dict(first)
    for k, v in second.items():
        if isinstance(v, dict) and k in out:
            prev = out[k]
            if not isinstance(prev, dict):
                return None  # sub-object over leaf: not composable
            sub = _compose(prev, v)
            if sub is None:
                return None
            out[k] = sub
        else:
            out[k] = v
    return out


def transport_batch_fn(cluster) -> Optional[Callable]:
    """*cluster*'s ``batch_write`` when batching there saves real round
    trips (the cluster declares ``transport_batching``), else ``None``.
    Write sites use this to fold N sequential round trips into one
    batch over HTTP while keeping the per-op loop — and its per-verb
    test-fake interception — everywhere else."""
    if getattr(cluster, "transport_batching", False):
        return getattr(cluster, "batch_write", None)
    return None


def apply_write_op(cluster, op: WriteOp) -> WriteResult:
    """Apply one op through *cluster* (any ClusterClient), mapping
    ApiErrors into the per-item result instead of raising — the shared
    executor behind the in-mem parity path, the facade's batch endpoint
    and the HTTP client's degraded fallback."""
    try:
        if op.op == "patch":
            if op.body is None:
                return None, BadRequestError("patch requires a body")
            # optional args ride as keywords, defaults omitted — the
            # call shape stays what hand-written callers (and their
            # duck-typed test fakes) already use
            kwargs: dict = {}
            if op.namespace:
                kwargs["namespace"] = op.namespace
            if op.patch_type != "merge":
                kwargs["patch_type"] = op.patch_type
            return cluster.patch(op.kind, op.name, op.body, **kwargs), None
        if op.op == "update":
            if op.body is None:
                return None, BadRequestError("update requires a body")
            return cluster.update(op.body), None
        if op.op == "create":
            if op.body is None:
                return None, BadRequestError("create requires a body")
            return cluster.create(op.body), None
        if op.op == "delete":
            kwargs = {}
            if op.namespace:
                kwargs["namespace"] = op.namespace
            if op.grace_period_seconds is not None:
                kwargs["grace_period_seconds"] = op.grace_period_seconds
            cluster.delete(op.kind, op.name, **kwargs)
            return None, None
        if op.op == "evict":
            kwargs = {}
            if op.grace_period_seconds is not None:
                kwargs["grace_period_seconds"] = op.grace_period_seconds
            cluster.evict(op.name, op.namespace, **kwargs)
            return None, None
        return None, BadRequestError(f"unknown batch op {op.op!r}")
    except ApiError as err:
        return None, err


# ----------------------------------------------------------- wire encoding
def encode_write_op(op: WriteOp) -> JsonObj:
    item: JsonObj = {"op": op.op}
    if op.kind:
        item["kind"] = op.kind
    if op.name:
        item["name"] = op.name
    if op.namespace:
        item["namespace"] = op.namespace
    if op.body is not None:
        item["body"] = op.body
    if op.op == "patch" and op.patch_type != "merge":
        item["patchType"] = op.patch_type
    if op.grace_period_seconds is not None:
        item["gracePeriodSeconds"] = op.grace_period_seconds
    return item


def decode_write_op(raw: JsonObj) -> Tuple[Optional[WriteOp], Optional[ApiError]]:
    if not isinstance(raw, dict):
        return None, BadRequestError("batch item must be an object")
    verb = raw.get("op")
    if verb not in ("patch", "update", "create", "delete", "evict"):
        return None, BadRequestError(f"unknown batch op {verb!r}")
    body = raw.get("body")
    if body is not None and not isinstance(body, dict):
        return None, BadRequestError("batch item body must be an object")
    grace = raw.get("gracePeriodSeconds")
    if grace is not None and not isinstance(grace, int):
        return None, BadRequestError("gracePeriodSeconds must be an integer")
    return (
        WriteOp(
            op=verb,
            kind=str(raw.get("kind") or ""),
            name=str(raw.get("name") or ""),
            namespace=str(raw.get("namespace") or ""),
            body=body,
            patch_type=str(raw.get("patchType") or "merge"),
            grace_period_seconds=grace,
        ),
        None,
    )


# -------------------------------------------------------------- dispatcher
#: Callback fired with each write's outcome on a worker thread.
WriteCallback = Callable[[Optional[JsonObj], Optional[Exception]], None]


class _Entry:
    __slots__ = ("op", "callbacks", "stamp", "claimed", "lazy")

    def __init__(
        self,
        op: WriteOp,
        callback: Optional[WriteCallback],
        lazy: bool = False,
    ) -> None:
        self.op = op
        self.callbacks: List[WriteCallback] = [callback] if callback else []
        self.stamp = time.monotonic()
        self.claimed = False
        #: Lazy entries (async worker finishes — nobody is blocked on
        #: them) linger coalesce_window_s before becoming claimable so
        #: a wave trickling in one write per worker ships as ONE batch
        #: round trip.  Eager entries (phase-pipeline bursts, blocking
        #: writers) are claimable immediately.
        self.lazy = lazy


class WriteDispatcher:
    """Concurrent, ordered-per-object write fan-out (module docstring).

    Knobs (the docs/performance.md table):

    * *max_workers* — concurrent write streams (pool size);
    * *max_batch* — writes per claimed batch → per batch round trip;
    * *coalesce_window_s* — a queued write younger than this is left in
      the queue so a same-object follow-up can still coalesce into it
      (0 = opportunistic only: coalesce when the queue happens to back
      up, never delay);
    * *overload_retries* / *overload_backoff_s* — 429 drain-and-retry
      pacing after the client's own Retry-After replays are exhausted.

    *mutex* is the caller's KeyedMutex (duck-typed: ``lock(key)`` context
    manager, optional ``lock_many(keys)``); *mutex_key* maps an op to its
    lock key so the dispatcher serializes against the caller's
    synchronous writers in the caller's own key namespace."""

    def __init__(
        self,
        cluster,
        max_workers: int = 8,
        max_batch: int = 64,
        mutex=None,
        mutex_key: Optional[Callable[[WriteOp], Optional[str]]] = None,
        coalesce_window_s: float = 0.0,
        overload_retries: int = 6,
        overload_backoff_s: float = 0.05,
        use_batch: bool = True,
    ) -> None:
        self._cluster = cluster
        # use_batch=False forces per-op application even when the
        # cluster exposes batch_write — callers disable it when the
        # batch call would NOT save a round trip (in-memory store) so
        # per-op error fidelity is preserved (a wrapped/faked cluster's
        # patch override still intercepts every write).
        self._batch_fn = (
            getattr(cluster, "batch_write", None) if use_batch else None
        )
        self._max_workers = max(1, max_workers)
        #: Soft concurrency cap (adaptive pacing): claims park while
        #: this many batches are in flight.  ``set_worker_scale`` moves
        #: it inside [1, max_workers]; max_workers stays the hard pool
        #: bound (threads are held, never killed, so throttling is a
        #: claim gate, not a pool resize).
        self._target_claims = self._max_workers
        self._max_batch = max(1, max_batch)
        self._mutex = mutex
        self._mutex_key = mutex_key or (
            lambda op: "/".join(op.key()) if op.name else None
        )
        self._coalesce_window = coalesce_window_s
        self._overload_retries = overload_retries
        self._overload_backoff = overload_backoff_s
        self._cond = threading.Condition()
        self._order: deque = deque()  #: guarded-by: _cond (unclaimed entries, submit order)
        self._key_queues: Dict[Tuple[str, str, str], deque] = {}  #: guarded-by: _cond
        self._inflight_keys: set = set()  #: guarded-by: _cond
        self._inflight = 0  #: guarded-by: _cond (claimed entries not yet completed)
        #: claimed BATCHES not yet completed — the adaptive throttle's
        #: unit (comparing entry counts against the worker-unit target
        #: would serialize batching mode: one 64-write batch already
        #: exceeds any worker count)
        self._inflight_batches = 0  #: guarded-by: _cond
        self._flushing = 0  #: guarded-by: _cond (>0 disables the coalesce-window hold)
        self._closed = False  #: guarded-by: _cond
        self._threads: List[threading.Thread] = []  #: guarded-by: _cond
        # metric handles bound ONCE: funneling every worker's update
        # through the registry's create-or-get lock convoyed the submit
        # path at fleet scale (profiled ~300 µs/call under 16 workers)
        self._m_queue_depth = metrics.write_queue_depth_gauge()
        self._m_inflight = metrics.http_inflight_writes_gauge()
        self._m_batch_size = metrics.write_batch_size_histogram()
        self._m_coalesced = metrics.writes_coalesced_counter()
        #: Observability for tests: writes absorbed into an earlier
        #: queued write (each one is a round trip that never happened).
        self.coalesced = 0
        #: 429-backoff retries performed by workers (drain-and-retry).
        self.overload_backoffs = 0

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Drain the queue, then stop the workers."""
        self.flush()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            # snapshot under the lock (racing _spawn_locked appends);
            # join OUTSIDE it — workers need the lock to exit
            threads = list(self._threads)
            self._threads = []
        for t in threads:
            t.join(timeout=5.0)

    def _spawn_locked(self) -> None:
        # one worker per queued batch's worth of work, up to the cap;
        # threads are cheap to hold but spawn lazily so an idle
        # dispatcher (sequential-mode provider) costs nothing
        wanted = min(self._max_workers, len(self._order) + self._inflight)
        while len(self._threads) < wanted:
            t = threading.Thread(
                target=self._run,
                name=f"write-dispatch-{len(self._threads)}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    # -------------------------------------------------------------- submit
    def submit(
        self,
        op: WriteOp,
        callback: Optional[WriteCallback] = None,
        lazy: bool = False,
    ) -> None:
        """Queue one write.  Per-key FIFO order is preserved; a merge
        patch may coalesce into the newest still-queued merge patch for
        the same key (both callbacks then fire with the merged write's
        single result).  *lazy* writes (no blocked caller) linger up to
        the coalesce window so trickle-in waves batch — see _Entry."""
        # the counter fires OUTSIDE the lock (monotonic — no staleness
        # race), but the DEPTH gauge sets inside it: two racing
        # unordered set()s can leave a stale non-zero depth on an empty
        # queue, which the sustained-backlog alert pages on
        coalesced = False
        with self._cond:
            if self._closed:
                raise RuntimeError("dispatcher is closed")
            key = op.key()
            kq = self._key_queues.setdefault(key, deque())
            tail = kq[-1] if kq else None
            composed = None
            if (
                tail is not None
                and not tail.claimed
                and op.op == "patch"
                and tail.op.op == "patch"
                and op.patch_type == "merge"
                and tail.op.patch_type == "merge"
            ):
                composed = try_compose_merge_patch(tail.op.body, op.body)
            if composed is not None:
                tail.op = replace(tail.op, body=composed)
                if callback is not None:
                    tail.callbacks.append(callback)
                self.coalesced += 1
                coalesced = True
            else:
                entry = _Entry(op, callback, lazy=lazy)
                kq.append(entry)
                self._order.append(entry)
                self._m_queue_depth.set(len(self._order))
                self._spawn_locked()
                self._cond.notify()
        if coalesced:
            self._m_coalesced.inc()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted write has completed (its callbacks
        fired).  Errors are reported through the callbacks, never raised
        here — the provider's pipeline barrier owns error propagation."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._flushing += 1
            self._cond.notify_all()
            try:
                while self._order or self._inflight:
                    remaining = 0.1
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"write dispatcher flush timed out with "
                                f"{len(self._order)} queued / "
                                f"{self._inflight} in flight"
                            )
                    self._cond.wait(min(0.1, remaining))
            finally:
                self._flushing -= 1

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._order)

    def set_worker_scale(self, scale: float) -> None:
        """Adaptive pacing hook: scale the concurrent-claim cap to
        ``max(1, round(max_workers * scale))``.  Scale is clamped to
        (0, 1] semantics — the configured ``max_workers`` remains the
        hard ceiling; 1 write stream always survives so the pipeline
        can never be throttled to a standstill."""
        with self._cond:
            target = max(
                1,
                min(
                    self._max_workers,
                    int(round(self._max_workers * float(scale))),
                ),
            )
            if target != self._target_claims:
                self._target_claims = target
                self._cond.notify_all()

    @property
    def worker_target(self) -> int:
        with self._cond:
            return self._target_claims

    # ------------------------------------------------------------- workers
    def _claim_locked(self) -> List[_Entry]:
        if self._inflight_batches >= self._target_claims:
            # adaptive throttle: enough batches on the wire already —
            # park until a completion frees a claim slot
            return []
        batch: List[_Entry] = []
        keys: set = set()
        now = time.monotonic()
        for entry in self._order:
            key = entry.op.key()
            if key in self._inflight_keys or key in keys:
                continue  # ordered-per-object: one write in flight per key
            if self._key_queues[key][0] is not entry:
                continue  # only the key's oldest queued write may ship
            if (
                entry.lazy
                and self._coalesce_window > 0
                and not self._flushing
                and now - entry.stamp < self._coalesce_window
            ):
                continue  # leave young LAZY writes coalescible
            entry.claimed = True
            batch.append(entry)
            keys.add(key)
            if len(batch) >= self._max_batch:
                break
        if batch:
            for key in keys:
                kq = self._key_queues[key]
                kq.popleft()
                if not kq:
                    del self._key_queues[key]
                self._inflight_keys.add(key)
            self._order = deque(e for e in self._order if not e.claimed)
            self._inflight += len(batch)
            self._inflight_batches += 1
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                batch = self._claim_locked()
                while not batch:
                    if self._closed:
                        return
                    # A timed wake is needed ONLY for immature lazy
                    # entries aging toward claimability — sleep exactly
                    # until the oldest matures.  Everything else that
                    # can unblock a claim (a submit, a completed batch
                    # releasing its keys, a flush) notifies the
                    # condition; timing those cases turned this loop
                    # into a sub-ms poll for the whole in-flight RTT
                    # whenever a mature entry sat key-blocked.
                    wake = None
                    if self._coalesce_window > 0 and not self._flushing:
                        now = time.monotonic()
                        future = [
                            e.stamp + self._coalesce_window - now
                            for e in self._order
                            if e.lazy
                            and e.stamp + self._coalesce_window > now
                        ]
                        if future:
                            wake = min(future)
                    self._cond.wait(wake)
                    batch = self._claim_locked()
                self._m_queue_depth.set(len(self._order))
            try:
                self._execute(batch)
            finally:
                with self._cond:
                    for entry in batch:
                        self._inflight_keys.discard(entry.op.key())
                    self._inflight -= len(batch)
                    self._inflight_batches -= 1
                    self._cond.notify_all()

    def _locks_for(self, batch: List[_Entry]) -> List[str]:
        # SORTED acquisition: multi-lock holders ordered identically can
        # never cycle with each other, and single-lock holders (the
        # synchronous drain-worker writes) can never close a cycle.
        keys = {
            mk
            for entry in batch
            if (mk := self._mutex_key(entry.op)) is not None
        }
        return sorted(keys)

    def _execute(self, batch: List[_Entry]) -> None:
        ops = [entry.op for entry in batch]
        results: List[WriteResult]
        with ExitStack() as stack:
            if self._mutex is not None:
                lock_keys = self._locks_for(batch)
                lock_many = getattr(self._mutex, "lock_many", None)
                if lock_many is not None:
                    stack.enter_context(lock_many(lock_keys))
                else:
                    for k in lock_keys:
                        stack.enter_context(self._mutex.lock(k))
            self._m_inflight.inc(amount=len(batch))
            try:
                results = self._apply(ops)
            except Exception as err:  # noqa: BLE001 — worker boundary
                # a whole-batch transport failure fails every write in
                # it; callers' barriers surface it and the next
                # reconcile re-derives (same envelope as one failed
                # synchronous write today)
                api_err = (
                    err
                    if isinstance(err, ApiError)
                    else ApiError(f"batch write failed: {err}")
                )
                results = [(None, api_err)] * len(ops)
            finally:
                self._m_inflight.inc(amount=-len(batch))
        self._m_batch_size.observe(len(batch))
        outcomes: List[Tuple[_Entry, Optional[JsonObj], Optional[Exception]]] = []
        for entry, (obj, err) in zip(batch, results):
            if (
                err is not None
                and entry.op.ignore_not_found
                and isinstance(err, NotFoundError)
            ):
                err = None
            outcomes.append((entry, obj, err))
        # Fail-fast per key: a failed write fails its still-QUEUED
        # same-key successors with the same error — the synchronous
        # contract, where a raise prevents the next write from ever
        # being issued (a cordon patch failing must not let the node's
        # queued state-label patch advance it anyway).  Writes submitted
        # AFTER the failure start a fresh per-key program (the next
        # reconcile's retry).
        failed_keys = {
            e.op.key(): err for e, _, err in outcomes if err is not None
        }
        if failed_keys:
            with self._cond:
                for key, err in failed_keys.items():
                    kq = self._key_queues.pop(key, None)
                    if not kq:
                        continue
                    for victim in kq:
                        victim.claimed = True  # drops it from _order below
                        outcomes.append((victim, None, err))
                self._order = deque(
                    e for e in self._order if not e.claimed
                )
                self._m_queue_depth.set(len(self._order))
        for entry, obj, err in outcomes:
            for cb in entry.callbacks:
                try:
                    cb(obj, err)
                except Exception:  # noqa: BLE001 — callback boundary
                    logger.exception("write callback failed")

    def _apply(self, ops: List[WriteOp]) -> List[WriteResult]:
        """One claimed batch → results, draining-and-retrying under 429
        backpressure (retry.retry_on_overload: the client has already
        replayed APF 429s after Retry-After; a surviving
        TooManyRequestsError means the server is genuinely browned out,
        so back off — queue depth grows, the request rate does not).

        Batch mode retries the whole POST: a 429 is shed at admission,
        before any item applies, so the re-send replays nothing.
        Per-op mode retries each op individually, and ONLY the overload
        flavor of 429 — an eviction's PDB 429 is a semantic per-item
        verdict the caller's drain loop owns, never replayed here.
        Per-op application errors (including non-ApiError faults from
        injected/faked clusters) stay per-item: one bad write never
        fails its batchmates."""
        from .retry import retry_on_overload

        def count(attempt: int, delay: float) -> None:
            self.overload_backoffs += 1

        if self._batch_fn is not None:
            return retry_on_overload(
                lambda: self._batch_fn(ops),
                retries=self._overload_retries,
                base_seconds=self._overload_backoff,
                on_backoff=count,
            )

        def apply_one(op: WriteOp) -> WriteResult:
            def once() -> WriteResult:
                obj, err = apply_write_op(self._cluster, op)
                if (
                    err is not None
                    and op.op != "evict"
                    and isinstance(err, TooManyRequestsError)
                ):
                    raise err
                return obj, err

            try:
                return retry_on_overload(
                    once,
                    retries=self._overload_retries,
                    base_seconds=self._overload_backoff,
                    on_backoff=count,
                )
            except ApiError as err:
                return None, err
            except Exception as err:  # noqa: BLE001 — injected faults
                return None, err

        return [apply_one(op) for op in ops]
