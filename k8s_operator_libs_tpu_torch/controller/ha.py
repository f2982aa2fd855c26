"""HA operator assembly — the controller runs only while leading.

The reference's host operators get this from controller-runtime's
manager: ``LeaderElection: true`` wraps every controller in a client-go
lease campaign so one replica reconciles while standbys idle hot
(SURVEY.md §1 L5 — the consumer layer above the library).  This module
finishes that assembly for this runtime: a :class:`LeaderElector`
drives a controller *factory*
— a fresh :class:`~.controller.Controller` is built and started on every
promotion and stopped on demotion, because a stopped controller's
workqueue is shut down and cannot be restarted (same reason
controller-runtime builds runnables per leadership term).

Ordering guarantees inherited from :class:`LeaderElector`:

* promotion (controller start) happens only after the lease is held;
* a leader that cannot renew demotes — stopping the controller —
  BEFORE the lease expires server-side (the fencing gap), so the
  successor's controller never runs alongside a partitioned ex-leader's;
* clean ``stop()`` releases the lease for immediate failover.

Split-brain windows that slip through anyway (e.g. a paused-then-resumed
process) are tolerated by the state machine's idempotency — proven
separately in tests/test_resilience.py — but the lease keeps them
exceptional instead of routine.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from ..cluster.client import ClusterClient
from .controller import Controller
from .leader_election import LeaderElector

logger = logging.getLogger(__name__)

#: Default Lease name shared by all replicas of the upgrade operator.
DEFAULT_LOCK_NAME = "tpu-upgrade-operator"


class HaOperator:
    """One replica of a leader-elected operator deployment.

    *controller_factory* builds a ready-to-start controller; it is
    invoked on every promotion (a controller cannot be restarted once
    stopped).  All replicas campaign for the same *lock_name* Lease;
    exactly one runs its controller at a time.
    """

    def __init__(
        self,
        cluster: ClusterClient,
        controller_factory: Callable[[], Controller],
        *,
        identity: str,
        lock_name: str = DEFAULT_LOCK_NAME,
        lease_namespace: str = "kube-system",
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        workers: int = 1,
    ) -> None:
        self._factory = controller_factory
        self._workers = workers
        self._controller: Optional[Controller] = None
        self._lock = threading.Lock()
        self.elector = LeaderElector(
            cluster,
            lock_name,
            identity,
            namespace=lease_namespace,
            lease_duration=lease_duration,
            renew_deadline=renew_deadline,
            retry_period=retry_period,
            on_started_leading=self._start_controller,
            on_stopped_leading=self._stop_controller,
        )

    # ------------------------------------------------------------- queries
    @property
    def is_leader(self) -> bool:
        return self.elector.is_leader

    @property
    def controller(self) -> Optional[Controller]:
        """The running controller while leading, else None."""
        with self._lock:
            return self._controller

    def running(self) -> bool:
        """Liveness of this replica: the campaign thread must be alive,
        and — while leading — so must the controller it promoted (a hot
        standby with no controller is healthy; a leader whose controller
        died is not)."""
        if not self.elector.running():
            return False
        with self._lock:
            controller = self._controller
        if controller is None:
            return True  # standby: alive and campaigning
        return controller.running()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Join the campaign; the controller starts if/when we lead."""
        self.elector.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Step down (controller stops first), release the lease."""
        self.elector.stop(timeout)

    # ------------------------------------------------------------ internals
    def _start_controller(self) -> None:
        with self._lock:
            if self._controller is not None:
                return  # already running (re-promotion without demotion)
            controller = self._factory()
            controller.start(workers=self._workers)
            self._controller = controller
        logger.info(
            "%s: leading — controller started", self.elector.identity
        )

    def _stop_controller(self) -> None:
        with self._lock:
            controller = self._controller
            self._controller = None
        if controller is not None:
            controller.stop()
            logger.info(
                "%s: stepped down — controller stopped", self.elector.identity
            )
