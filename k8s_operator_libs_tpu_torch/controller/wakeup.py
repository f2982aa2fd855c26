"""WakeupSource — the one funnel through which reconciles get scheduled.

The reference's consumers poll: controller-runtime requeues the request
on a fixed cadence and each pass discovers what changed.  This runtime
inverts that — everything that *learns* the world changed pushes the
reconcile key through a :class:`WakeupSource` bound to the controller's
workqueue:

* the **watch tee** enqueues the key the moment a relevant journal
  delta arrives (the Controller does this natively, trigger ``watch``);
* **async worker completions** — drain/eviction workers, the write
  pipeline's completion callbacks — call :meth:`wake` so the pass that
  picks up their label writes is scheduled at completion time, not at
  the next poll tick (trigger ``worker``);
* **gate deadlines** (maintenance-window opening, pacing slot freeing,
  canary soak expiry) are armed via :meth:`arm` — the workqueue keeps
  only the earliest deadline per key and an immediate wake disarms it,
  so the timers are pure safety nets (triggers ``deadline`` /
  ``fallback``).

Every accepted wakeup is counted in
``reconcile_wakeups_total{trigger}`` (via the workqueue's listener);
dedup'd no-ops are not, so the series reads as "passes scheduled, and
why".
"""

from __future__ import annotations

from typing import Hashable

from .workqueue import WorkQueue


class WakeupSource:
    """Schedules one reconcile key onto one workqueue.

    Thread-safe and loss-free by construction: the queue's
    dedup-while-queued / coalesce-while-processing semantics guarantee
    a wake during an in-flight pass yields exactly one follow-up pass,
    and a burst of wakes collapses into one."""

    def __init__(self, queue: WorkQueue, request: Hashable) -> None:
        self._queue = queue
        self._request = request

    @property
    def request(self) -> Hashable:
        return self._request

    def wake(self, trigger: str = "worker") -> bool:
        """Schedule the reconcile now; returns True when the wake
        introduced new work (False = coalesced into an already-queued
        pass).  Any armed safety-net deadline is disarmed."""
        return self._queue.add(self._request, trigger)

    def arm(self, delay_seconds: float, trigger: str = "deadline") -> None:
        """Arm a safety-net wakeup *delay_seconds* out.  The queue keeps
        only the earliest armed deadline per key; a later arm while an
        earlier one is pending is a no-op, and an intervening
        :meth:`wake` disarms it entirely."""
        add_after = getattr(self._queue, "add_after", None)
        if add_after is not None:
            add_after(self._request, delay_seconds, trigger)
        else:  # plain WorkQueue (tests): degrade to an immediate add
            self._queue.add(self._request, trigger)
