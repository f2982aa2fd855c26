"""RetryOnConflict — optimistic-concurrency retry loop.

Reference parity: ``retry.RetryOnConflict(retry.DefaultRetry, ...)`` used by
crdutil's update path (crdutil.go:230-249) and the requestor-mode
shared-requestor patch (upgrade_requestor.go:344-357).  client-go's
DefaultRetry is 5 steps, 10 ms base, factor 1.0, jitter 0.1.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

from .errors import ConflictError

T = TypeVar("T")

DEFAULT_RETRY_STEPS = 5
DEFAULT_RETRY_BASE_SECONDS = 0.01
DEFAULT_RETRY_JITTER = 0.1


def retry_on_conflict(
    fn: Callable[[], T],
    steps: int = DEFAULT_RETRY_STEPS,
    base_seconds: float = DEFAULT_RETRY_BASE_SECONDS,
    jitter: float = DEFAULT_RETRY_JITTER,
) -> T:
    """Run *fn*, retrying up to *steps* times while it raises ConflictError.

    The callable must re-read the object inside itself (get → mutate →
    update), exactly like the Go closure contract.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    for attempt in range(steps):
        try:
            return fn()
        except ConflictError:
            if attempt == steps - 1:
                raise
            time.sleep(base_seconds * (1.0 + jitter * random.random()))
    raise AssertionError("unreachable")


DEFAULT_OVERLOAD_RETRIES = 6
DEFAULT_OVERLOAD_BASE_SECONDS = 0.05
DEFAULT_OVERLOAD_MAX_SECONDS = 1.0


def retry_on_overload(
    fn: Callable[[], T],
    retries: int = DEFAULT_OVERLOAD_RETRIES,
    base_seconds: float = DEFAULT_OVERLOAD_BASE_SECONDS,
    max_seconds: float = DEFAULT_OVERLOAD_MAX_SECONDS,
    on_backoff: Callable[[int, float], None] | None = None,
) -> T:
    """Run *fn*, draining-and-retrying on :class:`TooManyRequestsError`
    with capped exponential backoff — the write pipeline's answer to
    apiserver overload (the transport has already replayed APF 429s
    after Retry-After; a 429 surviving to this layer means the server is
    genuinely browned out, so the caller WAITS instead of amplifying the
    brownout with more traffic).  *on_backoff(attempt, delay)* observes
    each backoff (metrics/test counters).  The final attempt's error
    propagates."""
    from .errors import TooManyRequestsError

    attempt = 0
    while True:
        try:
            return fn()
        except TooManyRequestsError:
            if attempt >= retries:
                raise
            delay = min(max_seconds, base_seconds * (2**attempt))
            if on_backoff is not None:
                on_backoff(attempt, delay)
            attempt += 1
            time.sleep(delay)
