"""Runtime lock-order / contention watcher — the dynamic half of the
concurrency sanitizer (the static half is ``hack/lockcheck.py``).

``go test -race`` has no Python analog, but the failure modes it guards
against do: this repo runs a dozen distinct locks and seven Condition
objects across drain workers, write-pipeline workers, watch pumps, the
sampling profiler and the reconcile thread.  This module instruments
every ``threading.Lock`` / ``RLock`` / ``Condition`` **created after
install()** to record, at near-zero cost per acquire:

* the **per-thread held-lock set**, keyed by each lock's creation site
  (``cluster/cache.py:71``) — so every nested acquisition contributes a
  directed edge to one global **lock-order graph**;
* a **witness stack** the first time each edge is observed (the
  acquiring thread's stack shows both the held and the acquired site);
* per-site **hold-time / contention stats** (acquires, total/max hold,
  total wait, contended count) — exported through the profiling plane
  (``GET /debug/profile?locks=1``, the ``profile`` CLI's lock section)
  so the longest-held locks arrive as named frames.

A **cycle** in the lock-order graph (site A acquired under site B
somewhere, B under A somewhere else) is a potential deadlock even if
the run never interleaved fatally — :func:`lock_order_cycles` returns
each one with both witness stacks, and the test suite's opt-in mode
(``RACEWATCH=1``, installed by ``tests/conftest.py``) fails the run on
any.  Edges between two locks from the SAME creation site are excluded
from cycle detection (many-instance sites — the KeyedMutex pool —
acquire in sorted-key order by construction; the graph cannot tell
instances apart), and are reported separately as ``same_site_nesting``.

Identity is the creation site, not the instance: all locks born at
``cache.py:71`` are "the cache lock".  That is what makes the graph
finite, the stats nameable, and the report diffable run-to-run.

Opt-in only (never installed in production paths); measured overhead is
documented in docs/concurrency.md.  State is stashed on the
``threading`` module so an early file-path import (conftest, before the
package's own module-level locks are created) and the normal package
import share one watch.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "install",
    "uninstall",
    "installed",
    "reset",
    "report",
    "lock_order_cycles",
    "top_lock_holds",
    "enabled_by_env",
]

#: wait longer than this on an acquire counts as a contended acquire.
CONTENTION_FLOOR_S = 1e-4
#: frames kept per witness stack (innermost last).
WITNESS_FRAMES = 10


def enabled_by_env() -> bool:
    """True when the opt-in env switch (``RACEWATCH=1``) is set."""
    return os.environ.get("RACEWATCH", "") == "1"


class _SiteStats:
    __slots__ = (
        "site",
        "kind",
        "instances",
        "acquires",
        "contended",
        "wait_s",
        "hold_s",
        "hold_max_s",
    )

    def __init__(self, site: str, kind: str) -> None:
        self.site = site
        self.kind = kind
        self.instances = 0
        self.acquires = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.hold_max_s = 0.0

    def to_dict(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "instances": self.instances,
            "acquires": self.acquires,
            "contended": self.contended,
            "wait_ms": round(self.wait_s * 1000, 3),
            "hold_ms": round(self.hold_s * 1000, 3),
            "hold_max_ms": round(self.hold_max_s * 1000, 3),
        }


class _WatchState:
    """The one process-wide watch (see module docstring on the stash)."""

    def __init__(self) -> None:
        # a REAL lock (created before install can ever patch anything)
        self.mu = _REAL_LOCK()
        self.installed = False
        self.stats: Dict[str, _SiteStats] = {}
        #: (held_site, acquired_site) -> {count, witness stack lines}
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.same_site_nesting: Dict[str, int] = {}
        self.local = threading.local()

    # ------------------------------------------------------- per-thread
    def held_stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack  # entries: [site, lock_id, depth, t_acquired]

    # ---------------------------------------------------------- events
    def on_created(self, site: str, kind: str) -> None:
        with self.mu:
            st = self.stats.get(site)
            if st is None:
                st = self.stats[site] = _SiteStats(site, kind)
            st.instances += 1

    def on_acquired(self, site: str, lock_id: int, wait_s: float) -> None:
        stack = self.held_stack()
        for entry in stack:
            if entry[1] == lock_id:
                entry[2] += 1  # re-entrant (RLock): no new hold level
                return
        new_edges: List[Tuple[str, str]] = []
        same_site = False
        for entry in stack:
            if entry[0] == site:
                same_site = True
            else:
                new_edges.append((entry[0], site))
        stack.append([site, lock_id, 1, time.perf_counter()])
        with self.mu:
            st = self.stats.get(site)
            if st is None:
                st = self.stats[site] = _SiteStats(site, "Lock")
            st.acquires += 1
            st.wait_s += wait_s
            if wait_s > CONTENTION_FLOOR_S:
                st.contended += 1
            if same_site:
                self.same_site_nesting[site] = (
                    self.same_site_nesting.get(site, 0) + 1
                )
            for pair in new_edges:
                edge = self.edges.get(pair)
                if edge is None:
                    # first observation: capture the witness (this
                    # thread holds pair[0] somewhere up this stack)
                    self.edges[pair] = {
                        "count": 1,
                        "witness": traceback.format_stack(
                            limit=WITNESS_FRAMES
                        ),
                    }
                else:
                    edge["count"] += 1

    def on_released(self, site: str, lock_id: int) -> None:
        stack = self.held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][1] == lock_id:
                stack[i][2] -= 1
                if stack[i][2] <= 0:
                    held = time.perf_counter() - stack[i][3]
                    del stack[i]
                    with self.mu:
                        st = self.stats.get(site)
                        if st is not None:
                            st.hold_s += held
                            if held > st.hold_max_s:
                                st.hold_max_s = held
                return
        # release of a lock acquired before install/reset: ignore

    def snapshot(self) -> Tuple[dict, dict, dict]:
        with self.mu:
            stats = {s: st.to_dict() for s, st in self.stats.items()}
            edges = {
                pair: dict(edge) for pair, edge in self.edges.items()
            }
            nesting = dict(self.same_site_nesting)
        return stats, edges, nesting

    def reset(self) -> None:
        with self.mu:
            self.stats.clear()
            self.edges.clear()
            self.same_site_nesting.clear()


# Real constructors — stashed on the threading module by the FIRST
# import (necessarily pre-install), so a second module instance (the
# early conftest file-path import + the normal package import coexist)
# imported while patched still resolves the genuine primitives.
_real_stash = getattr(threading, "_racewatch_real", None)
if _real_stash is None:
    _real_stash = (threading.Lock, threading.RLock, threading.Condition)
    threading._racewatch_real = _real_stash
_REAL_LOCK, _REAL_RLOCK, _REAL_CONDITION = _real_stash


def _state() -> _WatchState:
    st = getattr(threading, "_racewatch_state", None)
    if st is None:
        st = _WatchState()
        threading._racewatch_state = st
    return st


def _call_site(depth: int = 2) -> str:
    """``relative/path.py:lineno`` of the frame creating the lock."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return "<unknown>"
    path = frame.f_code.co_filename
    for marker in ("k8s_operator_libs_tpu", "tests", "site-packages"):
        idx = path.find(marker)
        if idx >= 0:
            path = path[idx:]
            break
    else:
        path = os.path.basename(path)
    return f"{path}:{frame.f_lineno}"


# --------------------------------------------------------------------------
# Wrappers.
# --------------------------------------------------------------------------
class _WatchedLock:
    """Instrumented Lock/RLock.  Delegates everything it does not
    measure (``_at_fork_reinit``, ...) to the real primitive."""

    _KIND = "Lock"

    def __init__(self, real, site: str) -> None:
        self._real = real
        self._site = site
        _state().on_created(site, self._KIND)

    # the two-clock acquire path is the whole per-acquire cost
    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        ok = self._real.acquire(blocking, timeout)
        if ok:
            _state().on_acquired(
                self._site, id(self), time.perf_counter() - t0
            )
        return ok

    def release(self) -> None:
        _state().on_released(self._site, id(self))
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *_exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<racewatch {self._KIND} {self._site} {self._real!r}>"

    def __getattr__(self, name: str):
        return getattr(self._real, name)


class _WatchedRLock(_WatchedLock):
    _KIND = "RLock"


class _WatchedCondition:
    """Instrumented Condition.  Built over the REAL lock (never the
    wrapper) so the stdlib's ``_release_save``/``_is_owned`` machinery
    sees primitives it understands; all recording happens here.  A
    Condition sharing a watched lock (``Condition(self._lock)``) shares
    that lock's watch identity — acquiring either is one hold."""

    def __init__(self, lock=None, *, _site: Optional[str] = None) -> None:
        site = _site or _call_site(2)
        if lock is None:
            real_lock = _REAL_RLOCK()
            kind = "Condition"
            ident_site, ident_id = site, id(self)
        elif isinstance(lock, _WatchedLock):
            real_lock = lock._real
            kind = "Condition"
            # shared identity: the cond IS the lock for held purposes
            ident_site, ident_id = lock._site, id(lock)
        else:
            real_lock = lock
            kind = "Condition"
            ident_site, ident_id = site, id(self)
        self._site = ident_site
        self._ident = ident_id
        self._real = _REAL_CONDITION(real_lock)
        if lock is None or not isinstance(lock, _WatchedLock):
            _state().on_created(self._site, kind)

    # ------------------------------------------------------------ lock api
    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        ok = self._real.acquire(blocking, timeout)
        if ok:
            _state().on_acquired(
                self._site, self._ident, time.perf_counter() - t0
            )
        return ok

    def release(self) -> None:
        _state().on_released(self._site, self._ident)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *_exc) -> None:
        self.release()

    # ------------------------------------------------------- condition api
    def wait(self, timeout: Optional[float] = None):
        # the real wait releases/reacquires the real lock internally;
        # bracket it so held-sets and hold times stay truthful (the
        # lock is NOT held while waiting)
        state = _state()
        state.on_released(self._site, self._ident)
        try:
            return self._real.wait(timeout)
        finally:
            state.on_acquired(self._site, self._ident, 0.0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # stdlib algorithm over OUR wait() so every park is bracketed
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._real.notify(n)

    def notify_all(self) -> None:
        self._real.notify_all()

    def __repr__(self) -> str:
        return f"<racewatch Condition {self._site} {self._real!r}>"

    def __getattr__(self, name: str):
        return getattr(self._real, name)


# --------------------------------------------------------------------------
# Factories + install.
# --------------------------------------------------------------------------
def _lock_factory():
    return _WatchedLock(_REAL_LOCK(), _call_site(2))


def _rlock_factory():
    return _WatchedRLock(_REAL_RLOCK(), _call_site(2))


def _condition_factory(lock=None):
    return _WatchedCondition(lock, _site=_call_site(2))


def install() -> None:
    """Patch ``threading.Lock``/``RLock``/``Condition`` so every lock
    created from now on is watched.  Idempotent."""
    state = _state()
    with state.mu:
        if state.installed:
            return
        state.installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory


def uninstall() -> None:
    """Restore the real constructors.  Locks created while installed
    stay watched for their lifetime (they keep recording)."""
    state = _state()
    with state.mu:
        if not state.installed:
            return
        state.installed = False
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION


def installed() -> bool:
    return _state().installed


def reset() -> None:
    """Drop collected stats/edges (test isolation); wrappers live on."""
    _state().reset()


def swap_state(state: Optional[_WatchState] = None) -> _WatchState:
    """Swap in a watch state (a fresh one when *state* is None) and
    return the previous one — the test-isolation seam: a suite running
    under ``RACEWATCH=1`` must be able to run the watcher's OWN tests
    against a clean slate without wiping the session-wide graph or
    disarming the session gate (wrappers resolve the state dynamically,
    so recording redirects instantly; releases of locks acquired under
    the other state are ignored, never mis-counted)."""
    prev = _state()
    threading._racewatch_state = state if state is not None else _WatchState()
    return prev


# --------------------------------------------------------------------------
# Reporting.
# --------------------------------------------------------------------------
def lock_order_cycles() -> List[dict]:
    """Cycles in the site-level lock-order graph, each with its edge
    list and both witness stacks.  Empty list = no potential deadlock
    observed."""
    _stats, edges, _nesting = _state().snapshot()
    graph: Dict[str, set] = {}
    for (src, dst) in edges:
        graph.setdefault(src, set()).add(dst)
    cycles: List[dict] = []
    seen_cycles = set()
    for start in sorted(graph):
        cyc = _dfs_cycle(graph, start)
        if not cyc:
            continue
        key = frozenset(cyc)
        if key in seen_cycles:
            continue
        seen_cycles.add(key)
        edge_list = []
        for i in range(len(cyc)):
            pair = (cyc[i], cyc[(i + 1) % len(cyc)])
            edge = edges.get(pair)
            if edge is not None:
                edge_list.append(
                    {
                        "from": pair[0],
                        "to": pair[1],
                        "count": edge["count"],
                        "witness": edge["witness"],
                    }
                )
        cycles.append({"sites": cyc, "edges": edge_list})
    return cycles


def _dfs_cycle(graph: Dict[str, set], start: str) -> Optional[List[str]]:
    path: List[str] = []
    on_path = set()
    visited = set()

    def dfs(node: str) -> Optional[List[str]]:
        path.append(node)
        on_path.add(node)
        for nbr in sorted(graph.get(node, ())):
            if nbr in on_path:
                return path[path.index(nbr):]
            if nbr not in visited:
                found = dfs(nbr)
                if found:
                    return found
        on_path.discard(node)
        visited.add(node)
        path.pop()
        return None

    return dfs(start)


def top_lock_holds(n: int = 5) -> List[dict]:
    """The *n* sites with the largest cumulative hold time — the
    "longest-held locks as named frames" view."""
    stats, _edges, _nesting = _state().snapshot()
    ranked = sorted(
        stats.values(), key=lambda s: s["hold_ms"], reverse=True
    )
    return ranked[:n]


def report() -> dict:
    """The full watch report (the ``/debug/profile?locks=1`` payload)."""
    stats, edges, nesting = _state().snapshot()
    cycles = lock_order_cycles()
    return {
        "installed": installed(),
        "sites": len(stats),
        "locks": sorted(
            stats.values(), key=lambda s: s["hold_ms"], reverse=True
        ),
        "edges": [
            {"from": a, "to": b, "count": e["count"]}
            for (a, b), e in sorted(edges.items())
        ],
        "same_site_nesting": nesting,
        "cycles": cycles,
        "cycle_count": len(cycles),
    }


def render_report(payload: Optional[dict] = None, top: int = 10) -> str:
    """Human-readable lock section for the ``profile`` CLI."""
    data = payload if payload is not None else report()
    if not data.get("installed") and not data.get("locks"):
        return "racewatch: not installed (set RACEWATCH=1)"
    lines = [
        f"racewatch: {data.get('sites', 0)} lock sites, "
        f"{len(data.get('edges', []))} order edges, "
        f"{data.get('cycle_count', 0)} cycle(s)"
    ]
    for row in (data.get("locks") or [])[:top]:
        lines.append(
            f"  {row['site']:<44} {row['kind']:<10} "
            f"acq={row['acquires']:<8} contended={row['contended']:<6} "
            f"hold={row['hold_ms']:.1f}ms max={row['hold_max_ms']:.2f}ms "
            f"wait={row['wait_ms']:.1f}ms"
        )
    for cyc in data.get("cycles") or []:
        lines.append(f"  CYCLE: {' -> '.join(cyc['sites'])}")
        for edge in cyc["edges"]:
            lines.append(
                f"    {edge['from']} -> {edge['to']} "
                f"(seen {edge['count']}x); witness:"
            )
            for frame in edge["witness"][-4:]:
                for part in frame.rstrip().splitlines():
                    lines.append(f"      {part.strip()}")
    return "\n".join(lines)
