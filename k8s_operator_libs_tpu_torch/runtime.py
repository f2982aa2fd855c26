"""Process-level runtime tuning for control-plane workloads.

Why this exists: the cluster substrate's copy-on-read/copy-on-write
discipline (``cluster/inmem.py`` ``json_copy``/``_copy_out``) allocates
millions of short-lived dict/list nodes per reconcile at fleet scale.
CPython's cyclic GC triggers a generation-0 pass every ~700 net
container allocations, and periodic full collections walk the ENTIRE
live heap — store objects, watch journal, informer caches — so
collection *frequency* grows with churn while collection *cost* grows
with fleet size.  The product is a super-linear term in the per-node
reconcile cost as the fleet grows past a thousand nodes.

The JSON trees this library churns are acyclic by construction —
reference counting alone reclaims every one of them; the cyclic
collector only re-walks them for nothing.  But a long-running operator
process must NOT simply ``gc.disable()``: the surrounding runtime
(HTTP machinery, exception tracebacks, torch internals) can and does
form real reference cycles, and a disabled collector leaks them
forever.  The safe shape is:

* **raise the gen-0 threshold** (default here: 100,000) so scans are
  amortized ~140x while cycle collection still happens;
* optionally **freeze the baseline** (``gc.freeze()``) after startup
  sync, moving the long-lived substrate (compiled modules, stores,
  caches built during initialization) into the permanent generation
  that full collections never re-walk.

Embedders call :func:`tune_gc` once at process start (the operator
CLI and example operator do); :func:`tuned_gc` is the context-manager
form benchmarks use for honest A/B measurement.  The library itself
never tunes implicitly — mutating process-global GC state is an
application decision.
"""

from __future__ import annotations

import gc
import sys
from contextlib import contextmanager
from typing import Iterator, Tuple

#: Gen-0 threshold raised ~140x over CPython's default 700: one young
#: scan per 100k net container allocations (~a reconcile cycle of a
#: 1k-node fleet) instead of ~140 of them.
DEFAULT_GEN0 = 100_000
#: Gen-1/2 multipliers kept near CPython defaults (10/10): full
#: collections still happen, just against the amortized base rate.
DEFAULT_GEN1 = 25
DEFAULT_GEN2 = 25


def tune_gc(
    gen0: int = DEFAULT_GEN0,
    gen1: int = DEFAULT_GEN1,
    gen2: int = DEFAULT_GEN2,
    freeze_baseline: bool = False,
) -> Tuple[int, int, int]:
    """Apply the control-plane GC profile; returns the PREVIOUS
    thresholds so a caller can restore them.

    *freeze_baseline* first runs a full collection, then moves every
    currently-live object to the permanent generation (``gc.freeze``)
    — call it AFTER initial informer sync so the steady-state working
    set is what gets excluded from future full scans.  Frozen objects
    are still freed by reference counting; they are only exempt from
    cyclic scanning, which is exactly right for acyclic JSON trees."""
    prev = gc.get_threshold()
    gc.set_threshold(gen0, gen1, gen2)
    if freeze_baseline:
        gc.collect()
        gc.freeze()
    return prev


def restore_gc(thresholds: Tuple[int, int, int], unfreeze: bool = False) -> None:
    """Undo :func:`tune_gc` (tests / benchmark A-B harnesses).

    Caveat: ``gc.unfreeze`` drains the WHOLE permanent generation —
    CPython keeps no record of who froze what, so objects frozen by
    other components return to gen-2 scanning too.
    Long-running operators simply never unfreeze; only A/B harnesses
    that must restore the default regime pass ``unfreeze=True``."""
    gc.set_threshold(*thresholds)
    if unfreeze:
        gc.unfreeze()


@contextmanager
def tuned_gc(
    gen0: int = DEFAULT_GEN0,
    gen1: int = DEFAULT_GEN1,
    gen2: int = DEFAULT_GEN2,
    freeze_baseline: bool = False,
) -> Iterator[None]:
    """Context-manager form: tune on entry, restore (and unfreeze, if
    the baseline was frozen) on exit.  Benchmarks use this so the
    tuned and untuned sides of an A/B run under their exact declared
    GC regimes."""
    prev = tune_gc(gen0, gen1, gen2, freeze_baseline=freeze_baseline)
    try:
        yield
    finally:
        restore_gc(prev, unfreeze=freeze_baseline)


#: Interpreter thread switch interval for thread-heavy control planes.
#: CPython's default 5 ms quantum is tuned for throughput of a few
#: CPU-bound threads; an operator process runs DOZENS of mostly-I/O
#: threads (held watch streams, drain/pod workers, write-dispatcher
#: workers, an in-process test apiserver in the harnesses), and under
#: that population a thread woken by a socket or condition variable
#: waits out other threads' full quanta before it runs — measured on
#: the 2-core bench container, a ~2 ms HTTP batch round trip stretched
#: to p50 ≈ 37 ms of scheduler queueing.  1 ms cuts that ~3x; going
#: much lower starts paying measurable context-switch overhead.
DEFAULT_SWITCH_INTERVAL = 0.001


def tune_scheduler(
    switch_interval: float = DEFAULT_SWITCH_INTERVAL,
) -> float:
    """Apply the control-plane thread-scheduling profile; returns the
    PREVIOUS switch interval so a caller can restore it.  Process-global
    (like :func:`tune_gc`) — an application decision, never implicit."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(switch_interval)
    return prev


@contextmanager
def tuned_scheduler(
    switch_interval: float = DEFAULT_SWITCH_INTERVAL,
) -> Iterator[None]:
    """Context-manager form of :func:`tune_scheduler` (benchmarks wrap
    BOTH sides of an A/B in it so the interpreter regime is identical)."""
    prev = tune_scheduler(switch_interval)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)
