"""Operational HTTP endpoints: /metrics, /healthz, /readyz, /debug/traces.

The reference's host operators inherit these from the controller-runtime
manager, which serves Prometheus metrics on ``:8080/metrics`` and
health/readiness probes on ``:8081/healthz`` + ``/readyz`` out of the box
(SURVEY.md §1 L5 — the consumer layer the reference links into; the
library itself stays transport-free, as does :mod:`..metrics`).  This
module is that manager surface for this runtime: a tiny stdlib HTTP
server exposing

* ``GET /metrics``  — the process-default (or injected) registry in
  Prometheus text exposition format 0.0.4;
* ``GET /healthz``  — liveness: every registered health check must pass
  (kubelet restarts the pod on failure);
* ``GET /readyz``   — readiness: every registered ready check must pass
  (the Service stops routing on failure; a hot HA standby is LIVE but
  whether it reports READY is the consumer's choice of check);
* ``GET /debug/traces`` — recent completed reconcile traces from the
  process tracer (:mod:`..obs.tracing`), OTLP-flavoured JSON by default;
  ``?fmt=chrome`` renders ``chrome://tracing`` JSON, ``?fmt=native`` the
  raw span dicts, ``?trace_id=...`` filters to one trace;
* ``GET /debug/profile`` — the continuous sampling profiler's window
  ring (:mod:`..obs.profiling`), native JSON by default;
  ``?fmt=collapsed`` serves flamegraph.pl/speedscope-importable
  collapsed stacks as text, ``?fmt=speedscope`` the speedscope.app
  JSON; ``?seconds=N`` blocks for an on-demand capture window (capped
  at 60 s) instead of the ring; ``?windows=N`` keeps the newest N;
  ``?heap=1`` adds the tracemalloc allocation snapshot (native only);
* ``GET /debug/remediation`` — the remediation engine's latest decision
  (breaker state, LKG records, quarantines) when a *remediation_source*
  was wired (usually ``manager.remediation_status``); 404 otherwise;
* ``GET /debug/slo`` — the SLO engine's latest report (ETA, stragglers,
  breaches, burn rates) when an *slo_source* was wired (usually
  ``manager.slo_status``); 404 otherwise; ``?history=1`` inlines the
  metrics-history ring's windowed samples (the observations the
  analysis engine's sustained conditions evaluate over) when an
  *slo_history_source* was wired;
* ``GET /debug/analysis`` — the analysis engine's latest report (step
  states, condition values with held-for windows, exposure cap, AIMD
  pacing scale) when an *analysis_source* was wired (usually
  ``manager.analysis_status``); 404 otherwise;
* ``GET /debug/federation`` — the fleet-of-fleets coordinator's latest
  status (cell phases, the global breaker, the ETA rollup) when a
  *federation_source* was wired (usually ``coordinator.status``); 404
  otherwise; ``?cell=<name>`` answers "why is cell Y not promoting"
  (the federated explain), ``?events=1`` inlines the merged
  cross-cluster decision stream;
* ``GET /debug/timeline`` — the flight recorder's per-node phase
  timelines when a *timeline_source* was wired (usually
  ``manager.timeline_status``); ``?node=<name>`` filters to one node
  (404 when the node has no timeline);
* ``GET /debug/events`` — the reason-coded decision-event stream
  (:mod:`..obs.events`) when an *events_source* was wired (usually
  ``manager.events_status``); ``?node=`` / ``?type=`` / ``?limit=``
  filter;
* ``GET /debug/explain`` — "why is node X not progressing" when an
  *explain_source* was wired (usually ``manager.explain_node``);
  ``?node=<name>`` is required (400 without it, 404 for an unknown
  node);
* ``GET /debug`` — JSON index of the debug endpoints registered on THIS
  server (so an operator can discover what is wired without guessing
  paths).  The index is derived from the route REGISTRY — a registered
  endpoint cannot be missing from it (regression-tested).

``/metrics`` also honors ``Accept: application/openmetrics-text`` with
the OpenMetrics rendering, whose histogram ``+Inf`` bucket lines carry
trace-ID exemplars — the metrics↔traces correlation hook.  ``HEAD`` is
answered for every endpoint (status + headers, no body — some probe
fleets use it).

Checks are ``name -> callable`` returning True/None on success; a check
that returns False or raises fails the probe, and the response body
names each check's outcome (controller-runtime's verbose healthz
format).  Failures answer 500 so kubelet/Service probes act on them.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs

from .. import metrics as metrics_mod
from ..obs import profiling as profiling_mod
from ..obs import racewatch as racewatch_mod
from ..obs import tracing as tracing_mod

logger = logging.getLogger(__name__)

Check = Callable[[], object]


class OpsServer:
    """Serve /metrics, /healthz and /readyz for one operator process.

    ``port=0`` binds an ephemeral port (tests); read :attr:`port` after
    :meth:`start`.  The server runs daemon threads and never blocks the
    operator; :meth:`stop` shuts it down and joins.

    **Exposure**: the default bind is all-interfaces and UNAUTHENTICATED
    (matching controller-runtime's metrics/probe listeners — kubelet
    probes and Prometheus scrapes arrive on the pod IP, so a loopback
    default would fail every probe).  ``/metrics`` reveals operator
    internals (rollout counts, watch health) to any pod-network peer;
    in-cluster deployments should restrict the port with a
    NetworkPolicy — ``deploy/operator.yaml`` ships one limiting ingress
    to the monitoring namespace — or pass ``host="127.0.0.1"`` when
    probes/scrapes are not needed (see docs/real-cluster.md).
    """

    def __init__(
        self,
        port: int = 8080,
        host: str = "0.0.0.0",
        registry: Optional[metrics_mod.MetricsRegistry] = None,
        tracer: Optional[tracing_mod.Tracer] = None,
        profiler: Optional[profiling_mod.SamplingProfiler] = None,
        remediation_source: Optional[Callable[[], Optional[dict]]] = None,
        slo_source: Optional[Callable[[], Optional[dict]]] = None,
        timeline_source: Optional[Callable[..., dict]] = None,
        events_source: Optional[Callable[[], Optional[dict]]] = None,
        explain_source: Optional[Callable[[str], Optional[dict]]] = None,
        analysis_source: Optional[Callable[[], Optional[dict]]] = None,
        slo_history_source: Optional[Callable[[], Optional[dict]]] = None,
        federation_source: Optional[Callable[[], Optional[dict]]] = None,
        federation_explain_source: Optional[
            Callable[[str], Optional[dict]]
        ] = None,
        federation_events_source: Optional[Callable[[], list]] = None,
    ) -> None:
        # All-interfaces default, like controller-runtime's metrics/probe
        # listeners: kubelet probes and Prometheus scrapes arrive on the
        # pod IP, so a loopback bind would fail every probe.
        self._host = host
        self._requested_port = port
        self._registry = registry
        self._tracer = tracer
        #: Profiler served at /debug/profile (None = the process
        #: default, like the tracer — the route is always registered;
        #: a stopped profiler just serves an empty ring with
        #: running=false, which is itself the diagnostic).
        self._profiler = profiler
        #: Callable returning the remediation engine's latest decision
        #: dict (None = no pass yet); absent means the endpoint 404s.
        self._remediation_source = remediation_source
        #: Callable returning the SLO engine's latest report dict
        #: (None = no evaluation yet); absent means /debug/slo 404s.
        self._slo_source = slo_source
        #: Callable returning the flight recorder's snapshot dict;
        #: absent means /debug/timeline 404s.  Arity is resolved ONCE
        #: here (not with a per-request ``except TypeError``, which
        #: would misread a TypeError raised INSIDE the source as "no-arg
        #: source" and silently serve the slow whole-fleet path): a
        #: source accepting an argument gets the ?node= filter pushed
        #: down (``FlightRecorder.snapshot(node)`` — no fleet-wide
        #: serialization per single-node query).
        self._timeline_source = timeline_source
        self._timeline_takes_node = False
        if timeline_source is not None:
            import inspect

            try:
                params = inspect.signature(timeline_source).parameters
                self._timeline_takes_node = any(
                    p.kind
                    in (
                        inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD,
                        inspect.Parameter.VAR_POSITIONAL,
                    )
                    for p in params.values()
                )
            except (TypeError, ValueError):  # uninspectable callable
                self._timeline_takes_node = False
        #: Callable returning the decision-event log snapshot; absent
        #: means /debug/events 404s.
        self._events_source = events_source
        #: Callable answering explain_node(name); absent means
        #: /debug/explain 404s.
        self._explain_source = explain_source
        #: Callable returning the analysis engine's latest report
        #: (steps, conditions, exposure, pacing); absent means
        #: /debug/analysis 404s.
        self._analysis_source = analysis_source
        #: Callable returning the SLO metrics-history ring's snapshot;
        #: served inline by /debug/slo?history=1 when wired.
        self._slo_history_source = slo_history_source
        #: Federation plane (federation/coordinator.py): the fleet-of-
        #: fleets status report (usually ``coordinator.status``), the
        #: per-cell explain (``coordinator.explain_cell`` — served for
        #: ``?cell=<name>``), and the merged cross-cluster decision
        #: stream (``coordinator.merged_decisions`` — ``?events=1``).
        #: Absent means /debug/federation 404s.
        self._federation_source = federation_source
        self._federation_explain_source = federation_explain_source
        self._federation_events_source = federation_events_source
        # THE debug route registry: path -> handler(query).  The /debug
        # index is DERIVED from this dict, so a wired endpoint can never
        # be missing from it (the index used to be maintained by hand —
        # regression-tested in tests/test_events.py).  Insertion order
        # is the index order.
        self._debug_routes: Dict[
            str, Callable[[Dict[str, list]], Tuple[int, str, bytes]]
        ] = {}
        self._debug_routes["/debug/traces"] = self._render_traces
        self._debug_routes["/debug/profile"] = self._render_profile
        if remediation_source is not None:
            self._debug_routes["/debug/remediation"] = (
                self._render_remediation
            )
        if slo_source is not None:
            self._debug_routes["/debug/slo"] = self._render_slo
        if timeline_source is not None:
            self._debug_routes["/debug/timeline"] = self._render_timeline
        if events_source is not None:
            self._debug_routes["/debug/events"] = self._render_events
        if explain_source is not None:
            self._debug_routes["/debug/explain"] = self._render_explain
        if analysis_source is not None:
            self._debug_routes["/debug/analysis"] = self._render_analysis
        if federation_source is not None:
            self._debug_routes["/debug/federation"] = self._render_federation
        self._health_checks: Dict[str, Check] = {}
        self._ready_checks: Dict[str, Check] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- checks
    def add_health_check(self, name: str, check: Check) -> None:
        """Register a liveness check (all must pass for /healthz 200)."""
        with self._lock:
            self._health_checks[name] = check

    def add_ready_check(self, name: str, check: Check) -> None:
        """Register a readiness check (all must pass for /readyz 200)."""
        with self._lock:
            self._ready_checks[name] = check

    def _run_checks(self, which: str) -> tuple:
        """(all_passed, report_lines) for the named probe."""
        with self._lock:
            checks = dict(
                self._health_checks if which == "healthz" else self._ready_checks
            )
        ok = True
        lines = []
        for name in sorted(checks):
            try:
                passed = checks[name]() is not False
            except Exception as err:  # noqa: BLE001 — a probe must not crash
                passed = False
                lines.append(f"[-] {name}: {err}")
            else:
                lines.append(("[+] " if passed else "[-] ") + name)
            ok = ok and passed
        lines.append("ok" if ok else "failed")
        return ok, lines

    # ----------------------------------------------------------- lifecycle
    @property
    def port(self) -> int:
        """The bound port (resolves 0 after start)."""
        if self._server is not None:
            return self._server.server_address[1]
        return self._requested_port

    @property
    def url(self) -> str:
        """Base URL reachable from THIS host (an all-interfaces bind is
        addressed via loopback for local probes/tests)."""
        host = "127.0.0.1" if self._host in ("0.0.0.0", "::") else self._host
        return f"http://{host}:{self.port}"

    # ----------------------------------------------------------- dispatch
    def _render_traces(self, query: Dict[str, list]) -> Tuple[int, str, bytes]:
        tracer = self._tracer or tracing_mod.default_tracer()
        trace_id = (query.get("trace_id") or [""])[0]
        if trace_id:
            trace = tracer.get_trace(trace_id)
            traces = [] if trace is None else [trace]
        else:
            traces = tracer.traces()
        fmt = (query.get("fmt") or ["otlp"])[0]
        if fmt == "chrome":
            payload = tracing_mod.to_chrome(traces)
        elif fmt == "native":
            payload = {"traces": traces}
        elif fmt == "otlp":
            payload = tracing_mod.to_otlp(traces)
        else:
            return (
                400,
                "text/plain; charset=utf-8",
                f"unknown fmt {fmt!r} (want otlp | chrome | native)\n".encode(),
            )
        return 200, "application/json", (json.dumps(payload) + "\n").encode()

    def _render_profile(
        self, query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        profiler = self._profiler or profiling_mod.default_profiler()
        raw_seconds = (query.get("seconds") or [""])[0]
        if raw_seconds:
            try:
                seconds = float(raw_seconds)
            except ValueError:
                seconds = -1.0
            if not 0 < seconds <= 60:
                return (
                    400,
                    "text/plain; charset=utf-8",
                    f"seconds must be in (0, 60], got {raw_seconds!r}\n"
                    .encode(),
                )
            # on-demand window: blocks THIS request thread only (the
            # server is threading), bounded by the 60 s cap above
            snapshot = profiler.capture(seconds)
        else:
            raw_windows = (query.get("windows") or [""])[0]
            try:
                windows = int(raw_windows) if raw_windows else None
            except ValueError:
                windows = None
            snapshot = profiler.snapshot(windows=windows)
        fmt = (query.get("fmt") or ["native"])[0]
        if fmt == "collapsed":
            return (
                200,
                "text/plain; charset=utf-8",
                profiling_mod.to_collapsed(snapshot).encode(),
            )
        if fmt == "speedscope":
            payload = profiling_mod.to_speedscope(snapshot)
        elif fmt == "native":
            payload = snapshot
            if (query.get("heap") or [""])[0] in ("1", "true"):
                payload = dict(snapshot, heap=profiling_mod.heap_snapshot())
            if (query.get("locks") or [""])[0] in ("1", "true"):
                # racewatch lock stats (installed: per-site hold/
                # contention + the lock-order graph; else a stub that
                # says how to turn it on) — the longest-held locks as
                # named frames beside the sampled ones
                payload = dict(payload, locks=racewatch_mod.report())
        else:
            return (
                400,
                "text/plain; charset=utf-8",
                f"unknown fmt {fmt!r} (want native | collapsed | "
                f"speedscope)\n".encode(),
            )
        return 200, "application/json", (json.dumps(payload) + "\n").encode()

    def _render_remediation(
        self, _query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        status = self._remediation_source()
        payload = {"configured": True, "decision": status}
        return (
            200,
            "application/json",
            (json.dumps(payload) + "\n").encode(),
        )

    def _render_slo(self, query: Dict[str, list]) -> Tuple[int, str, bytes]:
        payload = {"configured": True, "report": self._slo_source()}
        if (query.get("history") or [""])[0] in ("1", "true"):
            # windowed samples of the SLO gauges (obs/history.py) — the
            # observations the analysis engine's sustained conditions
            # evaluate over; null when no history source is wired
            payload["history"] = (
                self._slo_history_source()
                if self._slo_history_source is not None
                else None
            )
        return (
            200,
            "application/json",
            (json.dumps(payload) + "\n").encode(),
        )

    def _render_analysis(
        self, _query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        payload = {"configured": True, "report": self._analysis_source()}
        return (
            200,
            "application/json",
            (json.dumps(payload) + "\n").encode(),
        )

    def _render_federation(
        self, query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        cell = (query.get("cell") or [""])[0]
        if cell:
            if self._federation_explain_source is None:
                return (
                    404,
                    "text/plain; charset=utf-8",
                    b"no federation explain source wired\n",
                )
            answer = self._federation_explain_source(cell)
            if answer is None:
                return (
                    404,
                    "text/plain; charset=utf-8",
                    f"no explanation for cell {cell} (unknown cell, or no "
                    f"coordinator tick yet)\n".encode(),
                )
            return (
                200,
                "application/json",
                (json.dumps(answer) + "\n").encode(),
            )
        payload: dict = {
            "configured": True,
            "report": self._federation_source(),
        }
        if (query.get("events") or [""])[0] in ("1", "true"):
            # the merged cross-cluster audit trail (timestamp-first/
            # seq-tiebreak over every cell's persisted decision stream
            # plus the coordinator's own)
            payload["events"] = (
                self._federation_events_source()
                if self._federation_events_source is not None
                else None
            )
        return (
            200,
            "application/json",
            (json.dumps(payload) + "\n").encode(),
        )

    def _render_timeline(
        self, query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        node = (query.get("node") or [""])[0]
        if node:
            # filter at the SOURCE when it supports it (the flight
            # recorder does): a single-node query must not
            # serialize the whole fleet's timelines per hit
            if self._timeline_takes_node:
                snapshot = self._timeline_source(node) or {}
            else:
                snapshot = self._timeline_source() or {}
            hits = [
                t
                for t in snapshot.get("timelines") or []
                if t.get("node") == node
            ]
            if not hits:
                return (
                    404,
                    "text/plain; charset=utf-8",
                    f"no timeline for node {node}\n".encode(),
                )
            snapshot = dict(snapshot, nodes=len(hits), timelines=hits)
        else:
            snapshot = self._timeline_source() or {}
        return (
            200,
            "application/json",
            (json.dumps(snapshot) + "\n").encode(),
        )

    def _render_events(
        self, query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        payload = dict(self._events_source() or {})
        events = payload.get("events") or []
        node = (query.get("node") or [""])[0]
        type_ = (query.get("type") or [""])[0]
        if node:
            events = [e for e in events if e.get("target") == node]
        if type_:
            events = [e for e in events if e.get("type") == type_]
        raw_limit = (query.get("limit") or [""])[0]
        if raw_limit:
            # LIST-limit convention: 0 = unlimited (like a Kubernetes
            # LIST), negatives rejected — a silent -0 slice would have
            # returned everything for limit=0 AND limit=-5 alike
            try:
                limit = int(raw_limit)
            except ValueError:
                limit = -1
            if limit < 0:
                return (
                    400,
                    "text/plain; charset=utf-8",
                    f"limit must be a non-negative integer, got "
                    f"{raw_limit!r}\n".encode(),
                )
            if limit > 0:
                events = events[-limit:]
        payload["events"] = events
        payload["returned"] = len(events)
        payload["configured"] = True
        return (
            200,
            "application/json",
            (json.dumps(payload) + "\n").encode(),
        )

    def _render_explain(
        self, query: Dict[str, list]
    ) -> Tuple[int, str, bytes]:
        node = (query.get("node") or [""])[0]
        if not node:
            return (
                400,
                "text/plain; charset=utf-8",
                b"explain needs ?node=<name>\n",
            )
        answer = self._explain_source(node)
        if answer is None:
            return (
                404,
                "text/plain; charset=utf-8",
                f"no explanation for node {node} (unknown node, or no "
                f"reconcile yet)\n".encode(),
            )
        return (
            200,
            "application/json",
            (json.dumps(answer) + "\n").encode(),
        )

    def _respond(
        self, raw_path: str, accept: str = ""
    ) -> Tuple[int, str, bytes]:
        """(status, content_type, body) for one request — shared by GET
        and HEAD so both always agree on status/headers."""
        path, _, raw_query = raw_path.partition("?")
        if path == "/metrics":
            reg = self._registry or metrics_mod.default_registry()
            # Content negotiation like a real Prometheus endpoint: the
            # OpenMetrics rendering (carrying exemplars) only when asked.
            openmetrics = "application/openmetrics-text" in (accept or "")
            content_type = (
                "application/openmetrics-text; version=1.0.0; charset=utf-8"
                if openmetrics
                else "text/plain; version=0.0.4; charset=utf-8"
            )
            return 200, content_type, reg.render(openmetrics=openmetrics).encode()
        if path in ("/healthz", "/readyz"):
            ok, lines = self._run_checks(path.lstrip("/"))
            return (
                200 if ok else 500,
                "text/plain; charset=utf-8",
                ("\n".join(lines) + "\n").encode(),
            )
        handler = self._debug_routes.get(path)
        if handler is not None:
            return handler(parse_qs(raw_query))
        if path in ("/debug", "/debug/"):
            # Discovery index instead of a 404, derived from the route
            # registry: a registered endpoint cannot be missing here.
            return (
                200,
                "application/json",
                (
                    json.dumps({"endpoints": list(self._debug_routes)})
                    + "\n"
                ).encode(),
            )
        return 404, "text/plain; charset=utf-8", b"404 not found\n"

    def start(self) -> "OpsServer":
        if self._server is not None:
            raise RuntimeError("ops server already started")
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 — quiet
                logger.debug("ops: " + fmt, *args)

            def _serve(self, include_body: bool) -> None:
                try:
                    status, ctype, body = ops._respond(
                        self.path, self.headers.get("Accept", "")
                    )
                except Exception as err:  # noqa: BLE001 — handler boundary
                    logger.error("ops: %s failed: %s", self.path, err)
                    status, ctype, body = (
                        500,
                        "text/plain; charset=utf-8",
                        b"internal error\n",
                    )
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if include_body:
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                self._serve(include_body=True)

            def do_HEAD(self):  # noqa: N802 — probes that HEAD first must
                # get real status + headers, not a 501 (and no body)
                self._serve(include_body=False)

        self._server = ThreadingHTTPServer((self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="ops-server",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self._server = None
        self._thread = None
