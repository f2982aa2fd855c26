"""Maintenance windows + admission pacing — WHEN upgrades may start.

The reference throttle bounds *how many* nodes upgrade concurrently
(maxParallelUpgrades / maxUnavailable); fleet operations also need to
bound *when* and *how fast*:

* **maintenance window** — new upgrades start only inside a recurring
  UTC window (e.g. 22:00 + 240 minutes on weekdays).  Nodes already
  mid-upgrade finish outside the window (stranding a half-upgraded
  slice is worse than overrunning the window — same principle as the
  degraded-domain quarantine).
* **pacing** — at most N node admissions per trailing hour, recorded
  via an ``…upgrade.admitted-at`` timestamp annotation stamped at
  admission.  Because the record lives on the node (like all state in
  this library), pacing survives operator restarts and HA failovers.

Both are pure schedule *gates* composed with the existing slot math:
a closed window zeroes the slot budget; pacing caps how many of the
available slots may be spent this pass.  Throttle bypasses (the
already-active-domain straggler rule, manually cordoned nodes) are
unaffected — those nodes' domains are already disrupted.
"""

from __future__ import annotations

import math
import time as _time
from datetime import datetime, time as dtime, timedelta, timezone
from typing import Iterable, Optional

from ..api.upgrade_spec import MaintenanceWindowSpec
from ..cluster.inmem import JsonObj
from ..obs import events as events_mod
from . import consts, util

#: Trailing window for admission pacing (seconds).
PACING_WINDOW_SECONDS = 3600.0

#: Single source of truth for day names (validation in the spec and
#: evaluation here must never diverge).
_DAY_NAMES = MaintenanceWindowSpec._DAY_NAMES


def _now_utc() -> datetime:
    """Module hook so tests can pin the clock."""
    return datetime.now(timezone.utc)


def window_open(spec, now: Optional[datetime] = None) -> bool:
    """True when *now* (UTC) falls inside the recurring window.

    The window may cross midnight; the ``days`` filter applies to the
    day the window *started* (a Friday 22:00 + 6h window still covers
    Saturday 03:00)."""
    if now is None:
        now = _now_utc()
    hour, minute = spec.parsed_start()
    # A window lasting D days can have started up to D days ago — check
    # every candidate start day, not just today/yesterday (a 3-day
    # weekend window is still open on Monday).
    max_back = math.ceil(spec.duration_minutes / 1440)
    for day_offset in range(0, -(max_back + 1), -1):
        day = now.date() + timedelta(days=day_offset)
        start = datetime.combine(
            day, dtime(hour, minute), tzinfo=timezone.utc
        )
        end = start + timedelta(minutes=spec.duration_minutes)
        if start <= now < end:
            if not spec.days or _DAY_NAMES[day.weekday()] in spec.days:
                return True
    return False


def next_window_open(
    spec, now: Optional[datetime] = None
) -> Optional[datetime]:
    """Earliest moment at/after *now* the window is (still) open, or None
    when the spec can never open (defensive; a validated spec always
    opens within a week).  Used by RolloutStatus to answer "when will
    admissions resume?"."""
    if now is None:
        now = _now_utc()
    if window_open(spec, now):
        return now
    hour, minute = spec.parsed_start()
    # The next opening is some day's start time within the coming week.
    for day_offset in range(0, 8):
        day = now.date() + timedelta(days=day_offset)
        if spec.days and _DAY_NAMES[day.weekday()] not in spec.days:
            continue
        start = datetime.combine(
            day, dtime(hour, minute), tzinfo=timezone.utc
        )
        if start >= now:
            return start
    return None


def _all_stamps(nodes: Iterable[JsonObj]) -> tuple:
    """EVERY parsed (non-bypass-exempt) admitted-at timestamp for the
    given nodes, window-independent — the one O(fleet) annotation walk
    the per-snapshot memo caches (:meth:`~.common_manager
    .ClusterUpgradeState.scan_memo`); the trailing-window filter is the
    cheap per-call part."""
    key = util.get_admitted_at_annotation_key()
    bypass_key = util.get_admitted_bypass_annotation_key()
    stamps = []
    for node in nodes:
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        raw = annotations.get(key)
        if not raw:
            continue
        if annotations.get(bypass_key):
            continue  # pacing-exempt bypass admission
        try:
            stamps.append(float(raw))
        except ValueError:
            continue
    return tuple(stamps)


def _recent_stamps(
    nodes: Iterable[JsonObj],
    now_ts: float,
    window_seconds: float,
    state=None,
) -> list:
    """Admitted-at timestamps inside the trailing window, bypass-exempt
    admissions excluded — the single source of the pacing census (both
    the budget and the next-slot time derive from it, so they can never
    disagree on boundary/exemption semantics).

    With *state* (a :class:`~.common_manager.ClusterUpgradeState`) the
    underlying annotation walk rides the snapshot's scan memo: within
    one reconcile the scheduler, rollout_status and the requestor each
    asked for this census, and each paid the full O(fleet) parse.
    *nodes* is ignored in that case
    (the memo walks the snapshot's own all-bucket flatten, which is
    exactly what every caller passed)."""
    if state is not None:
        stamps = state.scan_memo(
            ("pacing-stamps",),
            lambda: _all_stamps(
                ns.node for ns in state.all_node_states()
            ),
        )
    else:
        stamps = _all_stamps(nodes)
    return [ts for ts in stamps if now_ts - ts < window_seconds]


def count_recent_admissions(
    nodes: Iterable[JsonObj],
    now_ts: Optional[float] = None,
    window_seconds: float = PACING_WINDOW_SECONDS,
    state=None,
) -> int:
    """Nodes whose admitted-at stamp lies inside the trailing window.

    Bypass admissions (see :func:`stamp_admission`) are excluded: their
    domain was already disrupted, so counting them would let a burst of
    bypasses starve the next hour's planned-admission budget."""
    if now_ts is None:
        now_ts = _time.time()
    return len(_recent_stamps(nodes, now_ts, window_seconds, state=state))


def stamp_admission(
    provider,
    node: JsonObj,
    now_ts: Optional[float] = None,
    bypass: bool = False,
) -> None:
    """Record the admission time on the node (pacing survives restarts).

    *bypass* marks a throttle-bypass admission (manually cordoned node,
    active-domain straggler): the admitted-at stamp is still written so
    the canary census sees the unit participating, but a companion
    marker annotation exempts it from pacing.  A later NORMAL admission
    of the same node clears the marker."""
    if now_ts is None:
        now_ts = _time.time()
    # The decision-audit event rides the stamp itself — every admission
    # (in-place schedulers AND the requestor handoff) passes through
    # here, so the stream can never miss one.
    name = (node.get("metadata") or {}).get("name") or ""
    events_mod.emit(
        events_mod.EVENT_NODE_ADMITTED,
        events_mod.REASON_BYPASS if bypass else events_mod.REASON_FRESH,
        name,
        "admitted to cordon-required"
        + (" (throttle bypass: domain already disrupted)" if bypass else ""),
    )
    provider.change_node_upgrade_annotation(
        node, util.get_admitted_at_annotation_key(), repr(now_ts)
    )
    bypass_key = util.get_admitted_bypass_annotation_key()
    annotations = (node.get("metadata") or {}).get("annotations") or {}
    if bypass:
        provider.change_node_upgrade_annotation(node, bypass_key, "true")
    elif annotations.get(bypass_key):
        provider.change_node_upgrade_annotation(
            node, bypass_key, consts.NULL_STRING
        )


def pacing_budget(
    policy, state_nodes: Iterable[JsonObj], state=None
) -> Optional[int]:
    """Remaining node admissions this trailing hour, or None when pacing
    is off.  Pass *state* so the stamp walk rides the snapshot's scan
    memo (see :func:`_recent_stamps`)."""
    limit = getattr(policy, "max_nodes_per_hour", 0) or 0
    if limit <= 0:
        return None
    return max(0, limit - count_recent_admissions(state_nodes, state=state))


def next_pacing_slot_at(
    nodes: Iterable[JsonObj],
    limit: int,
    now_ts: Optional[float] = None,
    window_seconds: float = PACING_WINDOW_SECONDS,
    state=None,
) -> Optional[float]:
    """When the trailing-hour budget next frees a slot (unix seconds), or
    None if a slot is already free / pacing is off.  A counted admission
    stops counting *window_seconds* after its stamp; with ``count``
    in-window admissions and a budget of ``limit``, the next slot opens
    when the ``count - limit + 1``-th oldest stamp ages out."""
    if limit <= 0:
        return None
    if now_ts is None:
        now_ts = _time.time()
    stamps = _recent_stamps(nodes, now_ts, window_seconds, state=state)
    if len(stamps) < limit:
        return None  # budget not exhausted
    stamps.sort()
    return stamps[len(stamps) - limit] + window_seconds
