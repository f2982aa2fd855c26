"""Prometheus-style metrics for the upgrade state machine.

The reference has **no metrics** — its prometheus deps are indirect only
and the one aggregate-progress event is commented out
(upgrade_state.go:199-202).  Operators running accelerator fleets
need more than Events to alert on a stuck rollout, so this module
supplies the standard trio (counter / gauge / histogram) with label
support and text exposition in the Prometheus format, wired into:

* :class:`~.upgrade.node_upgrade_state_provider.NodeUpgradeStateProvider`
  — ``upgrade_state_transitions_total{to_state=...}``;
* :class:`~.upgrade.upgrade_state.ClusterUpgradeStateManager` —
  ``reconcile_seconds{phase=build|apply}`` and the rollout gauges
  ``nodes_in_state{state=...}``, ``upgrades_{in_progress,pending,failed,done}``,
  ``managed_nodes``;
* :class:`~.upgrade.drain_manager.DrainManager` —
  ``drains_total{result=...}`` and ``drain_seconds``.

Everything records into a process-default :class:`MetricsRegistry`
(swappable for tests via :func:`set_default_registry`); recording is a
dict update under a lock, cheap enough to stay always-on.  Serving the
text over HTTP is the consumer's choice (any WSGI one-liner around
:meth:`MetricsRegistry.render`); this library stays transport-free the
same way the reference stays logr-only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_PREFIX = "k8s_operator_libs_tpu_"

#: Default histogram buckets — seconds, tuned for control-plane latencies
#: (cache-visibility waits are ~1 s scale, drains minutes scale).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

LabelValues = Tuple[str, ...]


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(names: Sequence[str], values: LabelValues,
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared labeled-series bookkeeping for all three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _check(self, labels: LabelValues) -> LabelValues:
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {labels}"
            )
        return tuple(str(v) for v in labels)

    def render(self, openmetrics: bool = False) -> List[str]:  # pragma: no cover — overridden
        raise NotImplementedError

    def _header(self, family: Optional[str] = None) -> List[str]:
        name = family or self.name
        return [
            f"# HELP {name} {self.help}",
            f"# TYPE {name} {self.kind}",
        ]


class Counter(_Metric):
    """Monotonically increasing count, optionally labeled."""

    kind = "counter"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help_, labelnames)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, *labels: str, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._check(tuple(labels))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *labels: str) -> float:
        key = self._check(tuple(labels))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self, openmetrics: bool = False) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if openmetrics:
            # OpenMetrics counter contract: the FAMILY name carries no
            # _total (HELP/TYPE lines), every sample carries it.  A
            # family named *_total with *_total samples is a "clashing
            # name" to strict parsers, which then reject the whole
            # scrape — not just this metric.
            family = (
                self.name[: -len("_total")]
                if self.name.endswith("_total")
                else self.name
            )
            sample = family + "_total"
        else:
            family = sample = self.name
        lines = self._header(family)
        for labels, v in items:
            lines.append(
                f"{sample}{_format_labels(self.labelnames, labels)} "
                f"{_format_value(v)}"
            )
        return lines


class Gauge(_Metric):
    """Point-in-time value, optionally labeled."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()) -> None:
        super().__init__(name, help_, labelnames)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float, *labels: str) -> None:
        key = self._check(tuple(labels))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, *labels: str, amount: float = 1.0) -> None:
        key = self._check(tuple(labels))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, *labels: str, amount: float = 1.0) -> None:
        self.inc(*labels, amount=-amount)

    def value(self, *labels: str) -> float:
        key = self._check(tuple(labels))
        with self._lock:
            return self._values.get(key, 0.0)

    def clear(self) -> None:
        """Drop every labeled series."""
        with self._lock:
            self._values.clear()

    def replace(self, values: Dict[LabelValues, float]) -> None:
        """Atomically swap the whole family (re-published each reconcile so
        emptied states disappear without a concurrent scrape ever seeing a
        half-cleared family)."""
        checked = {
            self._check(k): float(v) for k, v in values.items()
        }
        with self._lock:
            self._values = checked

    def render(self, openmetrics: bool = False) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        lines = self._header()
        for labels, v in items:
            lines.append(
                f"{self.name}{_format_labels(self.labelnames, labels)} "
                f"{_format_value(v)}"
            )
        return lines


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ≤ its upper bound; ``+Inf`` mirrors ``_count``)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help_, labelnames)
        # +Inf is implicit (rendered from _count); a user-supplied inf
        # bound would emit a duplicate le="+Inf" series, so drop it.
        self.buckets = tuple(
            sorted(float(b) for b in buckets if float(b) != float("inf"))
        )
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        # per-labelset: (bucket counts, total count, sum)
        self._series: Dict[LabelValues, Tuple[List[int], int, float]] = {}
        # per-labelset: last exemplar (labels dict, observed value, unix ts)
        # — the OpenMetrics trace-correlation hook (a Prometheus exemplar
        # keeps the LAST observation per series the same way)
        self._exemplars: Dict[LabelValues, Tuple[Dict[str, str], float, float]] = {}

    def observe(
        self,
        value: float,
        *labels: str,
        exemplar: Optional[Dict[str, str]] = None,
    ) -> None:
        key = self._check(tuple(labels))
        with self._lock:
            counts, count, total = self._series.get(
                key, ([0] * len(self.buckets), 0, 0.0)
            )
            counts = list(counts)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._series[key] = (counts, count + 1, total + float(value))
            if exemplar:
                self._exemplars[key] = (
                    {str(k): str(v) for k, v in exemplar.items()},
                    float(value),
                    time.time(),
                )

    def exemplar(
        self, *labels: str
    ) -> Optional[Tuple[Dict[str, str], float, float]]:
        """The series' most recent exemplar as ``(labels, value, unix_ts)``
        — e.g. ``({"trace_id": ...}, 38.2, 1767...)`` — or None."""
        key = self._check(tuple(labels))
        with self._lock:
            return self._exemplars.get(key)

    def count(self, *labels: str) -> int:
        key = self._check(tuple(labels))
        with self._lock:
            return self._series.get(key, ([], 0, 0.0))[1]

    def sum(self, *labels: str) -> float:
        key = self._check(tuple(labels))
        with self._lock:
            return self._series.get(key, ([], 0, 0.0))[2]

    def render(self, openmetrics: bool = False) -> List[str]:
        with self._lock:
            items = sorted(
                (k, (list(c), n, s)) for k, (c, n, s) in self._series.items()
            )
            exemplars = dict(self._exemplars) if openmetrics else {}
        lines = self._header()
        for labels, (counts, count, total) in items:
            # Exemplars are OpenMetrics-only syntax — the 0.0.4 exposition
            # this registry serves by default must stay parseable by strict
            # scrapers, so they ride the +Inf bucket line only when the
            # consumer asked for the OpenMetrics rendering.
            exemplar_suffix = ""
            hit = exemplars.get(labels)
            if hit is not None:
                ex_labels, ex_value, ex_ts = hit
                pairs = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in sorted(ex_labels.items())
                )
                exemplar_suffix = (
                    f" # {{{pairs}}} {_format_value(ex_value)} {ex_ts:.3f}"
                )
            for bound, c in zip(self.buckets, counts):
                le = _format_value(bound)
                lines.append(
                    f"{self.name}_bucket"
                    f"{_format_labels(self.labelnames, labels, ('le', le))} {c}"
                )
            lines.append(
                f"{self.name}_bucket"
                f"{_format_labels(self.labelnames, labels, ('le', '+Inf'))} "
                f"{count}{exemplar_suffix}"
            )
            lines.append(
                f"{self.name}_sum{_format_labels(self.labelnames, labels)} "
                f"{_format_value(total)}"
            )
            lines.append(
                f"{self.name}_count{_format_labels(self.labelnames, labels)} {count}"
            )
        return lines


class MetricsRegistry:
    """Create-or-get metric families and render them as Prometheus text."""

    def __init__(self, prefix: str = _PREFIX) -> None:
        self._prefix = prefix
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        full = self._prefix + name
        with self._lock:
            existing = self._metrics.get(full)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {full} re-registered with a different "
                        f"type/labels"
                    )
                wanted_buckets = kwargs.get("buckets")
                if wanted_buckets is not None and isinstance(existing, Histogram):
                    normalized = tuple(
                        sorted(
                            float(b)
                            for b in wanted_buckets
                            if float(b) != float("inf")
                        )
                    )
                    if normalized != existing.buckets:
                        raise ValueError(
                            f"metric {full} re-registered with different "
                            f"buckets"
                        )
                return existing
            metric = cls(full, help_, labelnames, **kwargs)
            self._metrics[full] = metric
            return metric

    def counter(self, name: str, help_: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str, labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_, labelnames, buckets=buckets
        )

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render(self, openmetrics: bool = False) -> str:
        """The full registry in Prometheus text exposition format 0.0.4 —
        or, with *openmetrics*, the OpenMetrics rendering that carries
        histogram exemplars (trace-ID correlation) and the ``# EOF``
        terminator."""
        lines: List[str] = []
        for metric in sorted(self.collect(), key=lambda m: m.name):
            lines.extend(metric.render(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every component records into."""
    with _default_lock:
        return _default_registry


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry (tests); returns the previous."""
    global _default_registry
    with _default_lock:
        previous = _default_registry
        _default_registry = registry
        return previous


# --------------------------------------------------------------- wiring API
# Components call these helpers rather than holding metric objects, so the
# registry can be swapped at any time and the callsites stay one-liners.

def record_state_transition(to_state: str) -> None:
    default_registry().counter(
        "upgrade_state_transitions_total",
        "Node upgrade-state label transitions, by destination state.",
        ("to_state",),
    ).inc(to_state or "unknown")


def observe_reconcile(
    phase: str, seconds: float, trace_id: Optional[str] = None
) -> None:
    default_registry().histogram(
        "reconcile_seconds",
        "Duration of state-machine phases (build_state / apply_state).",
        ("phase",),
    ).observe(
        seconds,
        phase,
        exemplar={"trace_id": trace_id} if trace_id else None,
    )


def observe_build_state(
    mode: str, seconds: float, trace_id: Optional[str] = None
) -> None:
    """BuildState latency, split by assembly mode: ``full`` (from-scratch
    relist) vs ``incremental`` (journal-driven ClusterStateIndex) — the
    A/B the index exists to win."""
    default_registry().histogram(
        "build_state_seconds",
        "BuildState duration by assembly mode (full relist vs "
        "incremental state index).",
        ("mode",),
    ).observe(
        seconds,
        mode,
        exemplar={"trace_id": trace_id} if trace_id else None,
    )


def record_state_index_rebuild(reason: str) -> None:
    """The ClusterStateIndex performed a FULL resync: initial seed,
    journal expiry (the 410 Gone path), or an explicit relist."""
    default_registry().counter(
        "state_index_rebuilds_total",
        "Full ClusterStateIndex resyncs, by reason "
        "(seed | journal-expired | relist).",
        ("reason",),
    ).inc(reason)


def record_state_index_fallback(reason: str) -> None:
    """An indexed BuildState fell back to the from-scratch path
    (scope mismatch, internal error) — steady growth means the index is
    not earning its keep and should be investigated or disabled."""
    default_registry().counter(
        "state_index_fallbacks_total",
        "Indexed BuildState calls served by the full-rebuild fallback, "
        "by reason.",
        ("reason",),
    ).inc(reason)


def record_drain(
    result: str, seconds: float, trace_id: Optional[str] = None
) -> None:
    reg = default_registry()
    reg.counter(
        "drains_total", "Completed node drains, by result.", ("result",)
    ).inc(result)
    reg.histogram(
        "drain_seconds", "Wall-clock duration of node drains."
    ).observe(
        seconds, exemplar={"trace_id": trace_id} if trace_id else None
    )


def publish_rollout_gauges(
    per_state: Dict[str, int],
    total: int,
    in_progress: int,
    pending: int,
    failed: int,
    done: int,
) -> None:
    reg = default_registry()
    reg.gauge(
        "nodes_in_state", "Managed nodes per upgrade state.", ("state",)
    ).replace({(state or "unknown",): count for state, count in per_state.items()})
    reg.gauge("managed_nodes", "Total nodes managed by the rollout.").set(total)
    reg.gauge("upgrades_in_progress", "Nodes in an active upgrade state.").set(
        in_progress
    )
    reg.gauge("upgrades_pending", "Nodes waiting for an upgrade slot.").set(
        pending
    )
    reg.gauge("upgrades_failed", "Nodes in upgrade-failed.").set(failed)
    reg.gauge("upgrades_done", "Nodes at the target revision.").set(done)


def record_reconcile_wakeup(trigger: str) -> None:
    """A reconcile request was ACCEPTED onto the workqueue (fresh
    enqueue or a coalescing dirty-mark on an in-flight request), by
    wakeup trigger: ``watch`` (journal delta), ``worker`` (async
    drain/eviction/write completion), ``deadline`` (a computed gate
    deadline fired), ``fallback`` (safety-net requeue timer),
    ``retry`` (backoff after a failed reconcile), ``resync``
    (periodic list), ``list`` (initial/relist enqueue).  Dedup'd adds
    (the request is already queued) are NOT counted — the series
    measures scheduled passes, so an idle event-driven fleet holds it
    flat and a storm with no cluster changes is alertable
    (UpgradeReconcileStorm)."""
    default_registry().counter(
        "reconcile_wakeups_total",
        "Reconcile requests accepted onto the workqueue, by wakeup "
        "trigger (watch | worker | deadline | fallback | retry | "
        "resync | list | direct).",
        ("trigger",),
    ).inc(trigger)


def record_watch_reconnect(kind: str) -> None:
    """A held watch stream reconnected (hold expiry or transport error)."""
    default_registry().counter(
        "watch_stream_reconnects_total",
        "Held watch stream reconnects, by kind.",
        ("kind",),
    ).inc(kind)


def record_client_throttle_wait(seconds: float) -> None:
    """A request blocked in the client-side token bucket (KubeConfig
    qps/burst) — cumulative seconds, the client-go "Waited for Xs due
    to client-side throttling" observable as a metric."""
    default_registry().counter(
        "client_throttle_wait_seconds_total",
        "Seconds requests spent blocked in the client-side rate limiter.",
    ).inc(amount=seconds)


def record_overload_retry() -> None:
    """The apiserver shed this request with an APF 429 and the client
    replayed it after Retry-After."""
    default_registry().counter(
        "client_overload_retries_total",
        "APF load-shed 429s transparently replayed by the client.",
    ).inc()


def record_watch_expired(kind: str) -> None:
    """A watch position fell out of the server's retention window (410)."""
    default_registry().counter(
        "watch_expirations_total",
        "Watch 410 Gone resets (full relist triggered), by kind.",
        ("kind",),
    ).inc(kind)


def record_atomic_list_patch(kind: str, path: str) -> None:
    """A strategic-merge patch touched a list field with no registered
    merge key, so it merged ATOMICALLY (whole-list replace).  A real
    apiserver keyed-merges any list its struct tags cover — if the
    patched field is one of those, register the key with
    :func:`~.cluster.strategicmerge.register_merge_key`."""
    default_registry().counter(
        "strategic_merge_atomic_list_patches_total",
        "Strategic-merge patches that replaced an unregistered list "
        "field atomically, by kind and field path.",
        ("kind", "path"),
    ).inc(kind or "*", path)


def record_list_pagination_restart() -> None:
    """A chunked LIST's continue token expired mid-pagination (410) and
    the pager restarted the list from scratch."""
    default_registry().counter(
        "list_pagination_restarts_total",
        "Chunked-LIST restarts after a continue token expired (410).",
    ).inc()


def record_held_queue_overflow() -> None:
    """The held-watch queue hit its cap (stalled CONSUMER, not a server
    410 — a distinct counter so the two failure modes alert separately)."""
    default_registry().counter(
        "held_watch_queue_overflows_total",
        "Held-watch queue overflows (consumer stopped draining; queue "
        "cleared and a relist forced).",
    ).inc()


def set_held_queue_depth(depth: int) -> None:
    default_registry().gauge(
        "held_watch_queue_depth",
        "Events buffered in the held-watch queue awaiting drain.",
    ).set(depth)


def publish_remediation_gauges(
    breaker_open: bool, quarantined_nodes: int
) -> None:
    """Remediation-engine state: breaker position (1 = open/tripped,
    0 = closed) and how many nodes the retry budget has quarantined."""
    reg = default_registry()
    reg.gauge(
        "remediation_breaker_state",
        "Failure-budget circuit breaker position (0 closed, 1 open).",
    ).set(1 if breaker_open else 0)
    reg.gauge(
        "quarantined_nodes",
        "Nodes quarantined by the remediation retry budget.",
    ).set(quarantined_nodes)


def record_breaker_trip() -> None:
    """The failure-budget breaker tripped (admissions paused)."""
    default_registry().counter(
        "remediation_breaker_trips_total",
        "Failure-budget circuit breaker trips.",
    ).inc()


def record_rollback() -> None:
    """An automatic last-known-good rollback was initiated."""
    default_registry().counter(
        "rollbacks_total",
        "Automatic last-known-good DaemonSet rollbacks initiated.",
    ).inc()


def record_node_quarantine() -> None:
    """A node exhausted its retry budget and was quarantined."""
    default_registry().counter(
        "node_quarantines_total",
        "Nodes quarantined after exhausting the upgrade retry budget.",
    ).inc()


# ---- federation (fleet-of-fleets) ----------------------------------------
#: Cell phase encoding for the federation_cell_phase gauge (documented
#: in docs/federation.md; the coordinator and dashboards share it).
FEDERATION_PHASE_CODES = {
    "pending": 0,
    "rolling": 1,
    "soaking": 2,
    "promoted": 3,
    "held": 4,
    "breached": 5,
    "unreachable": 6,
    # ordinary wave-order waiting — NOT counted into
    # federation_cells_held (a healthy multi-hour wave always has
    # queued cells; only abnormal holds should page)
    "queued": 7,
}


def publish_federation_gauges(
    cells_total: int,
    cells_held: int,
    breaker_open: bool,
    eta_seconds: float,
    phases,
) -> None:
    """Federation-coordinator state: cell count, cells currently held
    (admission blocked by order/conditions or the global breaker), the
    global breaker position, the fleet-of-fleets ETA rollup (-1 =
    unknown), and each cell's phase (see
    :data:`FEDERATION_PHASE_CODES`)."""
    reg = default_registry()
    reg.gauge(
        "federation_cells_total",
        "Cells (clusters) declared by the federation policy.",
    ).set(cells_total)
    reg.gauge(
        "federation_cells_held",
        "Cells abnormally held (global breaker / breached / "
        "unreachable) — ordinary wave-order queueing not counted.",
    ).set(cells_held)
    reg.gauge(
        "federation_breaker_state",
        "Global federation breaker position (0 closed, 1 open).",
    ).set(1 if breaker_open else 0)
    reg.gauge(
        "federation_global_eta_seconds",
        "Projected seconds until the whole cell wave completes "
        "(-1 = unknown).",
    ).set(eta_seconds)
    reg.gauge(
        "federation_cell_phase",
        "Per-cell wave phase (0 pending, 1 rolling, 2 soaking, "
        "3 promoted, 4 held, 5 breached, 6 unreachable, 7 queued).",
        ("cell",),
    ).replace(
        {
            (cell,): float(FEDERATION_PHASE_CODES.get(phase, 0))
            for cell, phase in (phases or {}).items()
        }
    )


def record_federation_trip() -> None:
    """The global federation breaker tripped (cell admissions paused)."""
    default_registry().counter(
        "federation_breaker_trips_total",
        "Global federation breaker trips.",
    ).inc()


def record_cell_promotion() -> None:
    """A cell completed, soaked, and promoted (next cell may admit)."""
    default_registry().counter(
        "federation_promotions_total",
        "Federation cell promotions.",
    ).inc()


def _slo_gauge_families() -> tuple:
    """The five SLO gauge families, shared by publish and retire so
    their definitions exist exactly once: (phase_seconds, eta,
    stragglers, burn_rate, breached)."""
    reg = default_registry()
    return (
        reg.gauge(
            "slo_phase_seconds",
            "Observed per-phase latency quantiles from the flight recorder.",
            ("phase", "quantile"),
        ),
        reg.gauge(
            "rollout_eta_seconds",
            "Projected seconds until the rollout completes (0 when "
            "complete; -1 while unknown, i.e. fewer than 2 completions "
            "observed).",
        ),
        reg.gauge(
            "rollout_stragglers",
            "Nodes currently exceeding k x their phase's p95 wall clock.",
        ),
        reg.gauge(
            "slo_burn_rate",
            "Per-SLO budget burn rate (1.0 = exactly on target).",
            ("slo",),
        ),
        reg.gauge(
            "slo_breached",
            "Per-SLO breach position (1 = currently breached).",
            ("slo",),
        ),
    )


def publish_slo_gauges(
    phase_quantiles: Dict[Tuple[str, str], float],
    eta_seconds: Optional[float],
    stragglers: int,
    burn_rates: Dict[str, float],
    breached,
) -> None:
    """Rollout SLO engine state, re-published each reconcile (see
    obs/slo.py): per-phase latency quantiles, the completion ETA,
    straggler count, and the per-SLO burn-rate / breach position.
    Families are atomically replaced so a phase that emptied (or an SLO
    removed from the policy) disappears from the exposition instead of
    freezing at its last value."""
    phase_g, eta_g, straggler_g, burn_g, breached_g = _slo_gauge_families()
    phase_g.replace(
        {
            (phase, q): seconds
            for (phase, q), seconds in phase_quantiles.items()
        }
    )
    eta_g.set(-1 if eta_seconds is None else eta_seconds)
    straggler_g.set(stragglers)
    burn_g.replace({(name,): rate for name, rate in burn_rates.items()})
    breached_g.replace(
        {
            (name,): (1.0 if name in breached else 0.0)
            for name in set(burn_rates) | set(breached)
        }
    )


def record_slo_breach(slo: str) -> None:
    """A declared rollout SLO newly entered breach (edge-triggered by
    the engine — reconciles SPENT in breach do not re-count)."""
    default_registry().counter(
        "slo_breaches_total",
        "Declared rollout SLOs newly entering breach, by SLO.",
        ("slo",),
    ).inc(slo)


def retire_slo_gauges() -> None:
    """The policy lost its ``slos`` block: REMOVE every SLO series from
    the exposition (the breach counter, being a counter, is left
    alone).  Removal, not zeroing: a retired ``rollout_eta_seconds``
    stuck at -1 would keep matching the ETA-stalled alert for the rest
    of a rollout whose SLO tracking was intentionally turned off —
    which is also why this clears directly instead of publishing
    empties first (a scrape must never land between a -1 write and its
    removal)."""
    for gauge in _slo_gauge_families():
        gauge.clear()


# ------------------------------------------------- analysis gates / pacing
#: analysis_gate_state encoding (documented in docs/observability.md).
ANALYSIS_STEP_PENDING = 0.0
ANALYSIS_STEP_ACTIVE = 1.0
ANALYSIS_STEP_PASSED = 2.0
ANALYSIS_STEP_ABORTED = 3.0


def _analysis_gauge_families() -> tuple:
    """The analysis-plane gauge families, shared by publish and retire
    (the SLO-gauge pattern): (gate_state, wave_scale)."""
    reg = default_registry()
    return (
        reg.gauge(
            "analysis_gate_state",
            "Per-analysis-step gate state (0 pending, 1 active, "
            "2 passed, 3 aborted).",
            ("step",),
        ),
        reg.gauge(
            "pacing_wave_scale",
            "Adaptive (AIMD) wave-scale multiplier applied to the "
            "scheduler's slot budget and the write dispatcher's "
            "concurrency (1.0 = unthrottled).",
        ),
    )


def publish_analysis_gauges(
    step_states: Dict[str, float], wave_scale: float
) -> None:
    """Analysis-engine state, re-published each reconcile: every
    declared step's gate position and the current pacing scale.
    Atomic family replace, like the SLO gauges — a step removed from
    the block disappears instead of freezing."""
    state_g, scale_g = _analysis_gauge_families()
    state_g.replace({(step,): value for step, value in step_states.items()})
    scale_g.set(wave_scale)


def retire_analysis_gauges() -> None:
    """The policy lost its ``analysis`` block: REMOVE the analysis
    series from the exposition (removal, not zeroing — the SLO-gauge
    retirement contract; a retired gate stuck at 'aborted' would page
    UpgradeRolloutAbortedOnSlo forever on a fleet whose analysis was
    intentionally turned off)."""
    for gauge in _analysis_gauge_families():
        gauge.clear()


def record_pacing_adjustment(direction: str) -> None:
    """The AIMD pacing controller moved the wave scale
    (direction = increase | decrease)."""
    default_registry().counter(
        "pacing_adjustments_total",
        "Adaptive pacing wave-scale adjustments, by direction.",
        ("direction",),
    ).inc(direction or "unknown")


# ------------------------------------------------------ write pipeline
#: Batch-size buckets: powers of two up to the dispatcher's max_batch
#: scale — latency buckets would be meaningless for a count metric.
WRITE_BATCH_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256,
)


def write_queue_depth_gauge() -> Gauge:
    """Writes queued in the async dispatcher awaiting a worker/batch.

    Returns the metric OBJECT: the dispatcher binds handles once at
    construction and updates through them — 16 worker threads funneling
    every update through the registry's create-or-get lock measurably
    convoyed the submit path at fleet scale."""
    return default_registry().gauge(
        "write_queue_depth",
        "Writes queued in the async write dispatcher awaiting dispatch.",
    )


def http_inflight_writes_gauge() -> Gauge:
    """Writes currently on the wire (claimed by a dispatcher worker,
    response not yet read) — delta-adjusted from worker threads."""
    return default_registry().gauge(
        "http_inflight_writes",
        "Writes currently in flight on the HTTP write pipeline.",
    )


def write_batch_size_histogram() -> Histogram:
    """Writes carried per dispatched batch (1 = a lone write; >1 = one
    round trip carried that many writes)."""
    return default_registry().histogram(
        "write_batch_size",
        "Writes carried per dispatched batch round trip.",
        buckets=WRITE_BATCH_BUCKETS,
    )


def writes_coalesced_counter() -> Counter:
    """Same-object merge patches absorbed into an earlier queued write —
    each one a round trip that never happened."""
    return default_registry().counter(
        "writes_coalesced_total",
        "Same-object merge patches coalesced into one round trip.",
    )


def record_batch_endpoint_fallback() -> None:
    """The server does not serve the batch endpoint (vanilla apiserver);
    the client degraded to per-op writes for this process."""
    default_registry().counter(
        "batch_endpoint_fallbacks_total",
        "Batch write endpoint probes that found no endpoint (client "
        "degraded to per-op writes).",
    ).inc()


def upgrade_events_counter() -> Counter:
    """The decision-event counter family (obs/events.py) — counted per
    OCCURRENCE, so a node deferred every reconcile keeps counting even
    while the log's dedup ring aggregates it into one entry (rate()
    over this family is the deferral pressure signal the
    UpgradeNodesDeferredSustained alert pages on).

    Returns the metric OBJECT (the write-pipeline pattern): the
    decision log caches the handle per registry — re-resolving through
    the create-or-get lock per emission sat on the fully-gated fleet's
    hot path."""
    return default_registry().counter(
        "upgrade_events_total",
        "Reason-coded rollout decision events, by type and reason.",
        ("type", "reason"),
    )


def record_upgrade_event(type_: str, reason: str) -> None:
    """One-off form of :func:`upgrade_events_counter` for callers off
    the hot path."""
    upgrade_events_counter().inc(type_ or "unknown", reason or "unknown")


# ------------------------------------------------------ profiling plane
def profiler_samples_counter() -> Counter:
    """Stack samples taken by the continuous sampling profiler
    (obs/profiling.py) — one per sampled thread per tick.  A rate()
    of ~0 while the operator is up means the profiling plane stalled
    (the UpgradeProfilerStalled alert pages on it).

    Returns the metric OBJECT (the write-pipeline pattern): the
    sampler tick is the hottest always-on loop in the process and must
    not re-resolve through the registry's create-or-get lock."""
    return default_registry().counter(
        "profiler_samples_total",
        "Wall-clock stack samples taken by the sampling profiler.",
    )


def profile_overhead_gauge() -> Gauge:
    """The profiler's own cost as a fraction of one core's wall clock
    (sampling_seconds / elapsed) — self-measured each tick and alerted
    on by UpgradeProfilerOverheadHigh."""
    return default_registry().gauge(
        "profile_overhead",
        "Sampling-profiler self-cost as a fraction of one core "
        "(sampler seconds per wall second).",
    )


def record_leader_transition(event: str) -> None:
    """Leader-election lifecycle: acquired | lost | released."""
    default_registry().counter(
        "leader_transitions_total",
        "Leader-election transitions of this replica, by event.",
        ("event",),
    ).inc(event)
