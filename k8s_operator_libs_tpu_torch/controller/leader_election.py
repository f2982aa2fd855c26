"""Lease-based leader election for HA operator pairs.

The reference expects its host operator to run under controller-runtime's
manager, whose leader election (client-go ``leaderelection`` over a
coordination.k8s.io/v1 Lease) guarantees one active reconciler per
deployment.  The chaos suite proves this library's state machine survives
split-brain by idempotency (tests/test_resilience.py), but production
HA still wants the standard single-writer mechanism — so this module
reimplements the client-go contract over the in-memory apiserver:

* the lock is a **Lease object** (``spec.holderIdentity``,
  ``leaseDurationSeconds``, ``acquireTime``, ``renewTime``,
  ``leaseTransitions``) mutated only through resourceVersion-checked
  updates, so two candidates racing for an expired lease conflict at the
  store and exactly one wins;
* a candidate acquires when the lease is unheld, expired (holder failed
  to renew within ``lease_duration``), or already its own; the holder
  renews every ``retry_period``;
* a holder that cannot renew within ``renew_deadline`` **demotes itself**
  (calls ``on_stopped_leading``) before the lease even expires — the
  fencing gap that keeps a partitioned ex-leader from acting while the
  new leader works;
* ``release()`` on clean shutdown zeroes the holder so the successor
  acquires immediately instead of waiting out the TTL.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .. import metrics
from ..cluster.errors import AlreadyExistsError, ConflictError, NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj

logger = logging.getLogger(__name__)


class LeaderElector:
    """One candidate's campaign for a named Lease lock."""

    def __init__(
        self,
        cluster: ClusterClient,
        lock_name: str,
        identity: str,
        *,
        namespace: str = "kube-system",
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        if renew_deadline >= lease_duration:
            raise ValueError("renew_deadline must be < lease_duration")
        if retry_period >= renew_deadline:
            raise ValueError("retry_period must be < renew_deadline")
        self._cluster = cluster
        self._lock_name = lock_name
        self._namespace = namespace
        self.identity = identity
        self._lease_duration = lease_duration
        self._renew_deadline = renew_deadline
        self._retry = retry_period
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._stop = threading.Event()
        self._is_leader = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- queries
    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._is_leader

    def leader_identity(self) -> Optional[str]:
        """Current holder per the apiserver, or None if unheld/expired."""
        try:
            lease = self._cluster.get("Lease", self._lock_name, self._namespace)
        except NotFoundError:
            return None
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if not holder or self._expired(spec):
            return None
        return holder

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("elector already started")
        self._thread = threading.Thread(
            target=self._run, name=f"leader-elector-{self.identity}", daemon=True
        )
        self._thread.start()

    def running(self) -> bool:
        """True while the campaign thread is alive (liveness probe — a
        dead elector on a standby means it would never take over)."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop campaigning; a leader steps down, then releases the lease
        for fast failover.  Order matters: ``on_stopped_leading`` (stop
        doing leader work) runs BEFORE the release — released first, a
        successor could acquire within one retry period and briefly run
        alongside our still-stopping controller, the exact double-writer
        window the lease exists to exclude."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self.is_leader:
            self._demote(event="released")
        # Release unconditionally (it no-ops unless we hold the lease on
        # the server): a deadline-demoted leader has is_leader False but
        # may still be the nominal holder after a healed partition — the
        # successor should not have to wait out the TTL.
        self.release()

    def release(self) -> None:
        """Zero the holder if we own the lease (clean handoff)."""
        try:
            lease = self._cluster.get("Lease", self._lock_name, self._namespace)
        except NotFoundError:
            return
        spec = lease.get("spec") or {}
        if spec.get("holderIdentity") != self.identity:
            return
        spec["holderIdentity"] = ""
        lease["spec"] = spec
        try:
            self._cluster.update(lease)
        except (ConflictError, NotFoundError):
            pass  # someone else already took or removed it

    # ------------------------------------------------------------- internals
    def _expired(self, spec: JsonObj) -> bool:
        renew = spec.get("renewTime")
        duration = spec.get("leaseDurationSeconds", self._lease_duration)
        if renew is None:
            return True
        return time.time() > renew + duration

    def _run(self) -> None:
        last_renew = time.monotonic()
        while not self._stop.is_set():
            try:
                renewed = self._try_acquire_or_renew()
            except Exception as err:  # noqa: BLE001 — thread boundary
                # a partition/store error is a failed renewal, not a dead
                # campaign: keep looping so the renew deadline can demote
                # us (and re-acquire once the store heals)
                logger.warning("%s: acquire/renew errored: %s", self.identity, err)
                renewed = False
            with self._lock:
                am_leader = self._is_leader
            if renewed:
                last_renew = time.monotonic()
                if not am_leader:
                    self._promote()
            elif am_leader:
                # renewal failed; demote once the deadline passes — before
                # the lease TTL, so we stop acting while still nominally
                # the holder on the server
                if time.monotonic() - last_renew > self._renew_deadline:
                    logger.warning(
                        "%s: lost leadership (renew deadline)", self.identity
                    )
                    self._demote()
            if self._stop.wait(self._retry):
                return

    def _promote(self) -> None:
        with self._lock:
            self._is_leader = True
        metrics.record_leader_transition("acquired")
        logger.info("%s: became leader of %s", self.identity, self._lock_name)
        if self._on_started is not None:
            try:
                self._on_started()
            except Exception:  # noqa: BLE001 — thread boundary
                # Leader work failed to start: an exception escaping here
                # would kill the campaign thread with is_leader stuck True
                # (a silent split-brain once a standby takes over).  Step
                # down and hand off instead.
                logger.exception(
                    "%s: on_started_leading raised; stepping down", self.identity
                )
                self._demote()
                try:
                    self.release()
                except Exception as err:  # noqa: BLE001 — thread boundary
                    # release() only swallows Conflict/NotFound; a store
                    # outage here must not kill the campaign thread (the
                    # lease then simply expires on its own).
                    logger.warning(
                        "%s: release after failed promotion errored: %s",
                        self.identity,
                        err,
                    )

    def _demote(self, event: str = "lost") -> None:
        """*event* labels the transition metric: "lost" for involuntary
        demotions (renew deadline, failed promotion), "released" for a
        voluntary stop() — alerts on involuntary loss must not fire on
        routine rolling restarts."""
        with self._lock:
            was = self._is_leader
            self._is_leader = False
        if was:
            metrics.record_leader_transition(event)
        if was and self._on_stopped is not None:
            try:
                self._on_stopped()
            except Exception:  # noqa: BLE001 — thread boundary
                # Already demoted flag-wise; a raising stop callback must
                # not kill the campaign thread (it may re-acquire later).
                logger.exception(
                    "%s: on_stopped_leading raised", self.identity
                )

    def _try_acquire_or_renew(self) -> bool:
        now = time.time()
        try:
            lease = self._cluster.get("Lease", self._lock_name, self._namespace)
        except NotFoundError:
            return self._create_lease(now)
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            spec["renewTime"] = now
        elif not holder or self._expired(spec):
            spec.update(
                {
                    "holderIdentity": self.identity,
                    "leaseDurationSeconds": self._lease_duration,
                    "acquireTime": now,
                    "renewTime": now,
                    "leaseTransitions": spec.get("leaseTransitions", 0) + 1,
                }
            )
        else:
            return False  # healthily held by someone else
        lease["spec"] = spec
        try:
            # resourceVersion from the read rides along: a racing acquirer
            # hits ConflictError and loses this round
            self._cluster.update(lease)
            return True
        except (ConflictError, NotFoundError):
            return False

    def _create_lease(self, now: float) -> bool:
        try:
            self._cluster.create(
                {
                    "kind": "Lease",
                    "metadata": {
                        "name": self._lock_name,
                        "namespace": self._namespace,
                    },
                    "spec": {
                        "holderIdentity": self.identity,
                        "leaseDurationSeconds": self._lease_duration,
                        "acquireTime": now,
                        "renewTime": now,
                        "leaseTransitions": 0,
                    },
                }
            )
            return True
        except AlreadyExistsError:
            return False
