"""Multi-process drain-aware training loop.

The port of ``k8s_operator_libs_tpu/tpu/multihost_trainer.py``.  A
:class:`MultihostDrainLoop` runs a per-step training function on every
rank of a ``torch.distributed`` job while cooperating with the upgrade
operator's checkpoint-on-drain handshake (:mod:`.drain_handshake`):

* ONE rank (the coordinator) watches the node annotation over the
  cluster client;
* the stop decision crosses the job through
  :func:`~.distributed.host_allreduce_max` (host control flow may not
  diverge across ranks, or their next collective deadlocks), so every
  rank stops at the SAME step;
* every rank saves, non-coordinators to a throwaway shadow directory
  when the state is replicated (:func:`shadow_dir`): no rank enters the
  closing barrier while another is still saving;
* the drain is acknowledged only AFTER that barrier: the operator reacts
  to the ack by evicting pods, and a peer still between its save and the
  barrier must not be killed under the coordinator.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

from .distributed import host_allreduce_max, sync_global_devices


class MultihostDrainLoop:
    """Drive ``step_fn(state, step) -> (state, loss)`` until the drain
    signal (or a runaway bound) stops the job.

    *watcher* is the coordinator's
    :class:`~.drain_handshake.DrainSignalWatcher` (None on every other
    rank); *save_fn(state, step)* checkpoints and is called on EVERY rank
    (see the module docstring).  Callers close over their own rank for
    the target directory (:func:`shadow_dir`)."""

    def __init__(
        self,
        step_fn: Callable[[Any, int], Tuple[Any, Any]],
        save_fn: Callable[[Any, int], None],
        watcher=None,
        max_steps: int = 1_000_000,
        max_seconds: float = float("inf"),
        poll_every: int = 1,
    ) -> None:
        self._step_fn = step_fn
        self._save_fn = save_fn
        self._watcher = watcher
        self._max_steps = max_steps
        self._max_seconds = max_seconds
        #: poll the drain signal every N steps: each poll is one cheap
        #: collective, but an HTTP read on the coordinator; raise it when
        #: steps are sub-millisecond
        self._poll_every = max(1, poll_every)

    def run(self, state) -> Tuple[Any, int, bool]:
        """Returns ``(state, steps_done, drained)``.

        ``max_steps`` is lockstep (every rank counts the same steps), so
        it may sit in the loop condition; the WALL-CLOCK bound must not:
        clocks differ across ranks, and a bare time check would let one
        rank leave the loop while a peer issues another collective
        (deadlock).  Both signals ride ONE polled max-all-reduce with the
        drain bit encoded ABOVE the deadline bit (requested=2,
        expired=1), so a drain request wins even when it lands in the
        same poll as a peer's expired bound: the checkpoint is saved and
        acknowledged before exiting."""
        sync_global_devices("multihost-loop-start")
        t0 = time.monotonic()
        step = 0
        drained = False
        while step < self._max_steps:
            state, _loss = self._step_fn(state, step)
            step += 1
            if step % self._poll_every:
                continue
            requested = (
                self._watcher is not None
                and self._watcher.checkpoint_requested()
            )
            expired = time.monotonic() - t0 >= self._max_seconds
            flag = host_allreduce_max(
                2.0 if requested else (1.0 if expired else 0.0)
            )
            if flag >= 2.0:
                drained = True  # some rank saw a drain request
                break
            if flag >= 1.0:
                break  # some rank's runaway deadline: stop, no drain
        if drained:
            self._save_fn(state, step)
        sync_global_devices("multihost-loop-done")
        if drained and self._watcher is not None:
            self._watcher.acknowledge()
        return state, step, drained


def shadow_dir(base: str, rank: int) -> str:
    """The save target of a non-coordinator: with replicated state the
    coordinator's copy is the real checkpoint, but every rank still saves
    (module docstring)."""
    return base if rank == 0 else f"{base}-shadow-{rank}"
