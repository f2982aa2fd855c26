"""ApiServerFacade — the in-memory cluster served over real HTTP.

The reference's test substrate is **envtest**: a real kube-apiserver
binary + etcd that tests talk to over HTTPS
(upgrade_suit_test.go:87-93).  This module is the equivalent seam for
this library: it serves :class:`~.inmem.InMemoryCluster` through an
actual HTTP server speaking the Kubernetes REST dialect, so the
production :class:`~.kubeclient.KubeApiClient` adapter can be exercised
over a genuine network round trip — URL routing, JSON serialization,
patch content types, Status error objects, watch streaming and all —
without a kubelet or etcd.

Surface (the subset this library's client uses, which is also the
subset the reference uses):

* ``GET /api/v1/...`` & ``/apis/<group>/<version>/...`` — get/list with
  ``labelSelector`` / ``fieldSelector`` query params;
* ``GET ...?watch=true&resourceVersion=N`` — **bounded watch**: streams
  the journal events after N as newline-delimited JSON
  ``{"type": ..., "object": ...}`` frames, then closes (a real
  apiserver holds the stream open; bounded semantics keep the facade
  synchronous — the client's journal shim re-polls);
* ``POST`` collection — create (201; 409 AlreadyExists);
* ``PUT`` object / ``.../status`` — update / update_status (409
  Conflict on resourceVersion mismatch);
* ``PATCH`` object — RFC 7386 merge patch (strategic-merge requests are
  accepted: for the map-typed fields this library patches the two
  coincide — PARITY.md);
* ``DELETE`` object — optional DeleteOptions body/query
  ``gracePeriodSeconds``;
* ``POST .../pods/<name>/eviction`` — the Eviction subresource (429 +
  Status reason when a PodDisruptionBudget blocks).

Errors are real Kubernetes ``Status`` objects with ``reason`` set to
NotFound / AlreadyExists / Conflict / Gone / TooManyRequests /
BadRequest, which the client maps back onto the :mod:`~.errors`
hierarchy.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, parse_qsl, urlparse

from .client import KindInfo, route_for_path
from .errors import (
    AlreadyExistsError,
    ApiError,
    BadRequestError,
    ConflictError,
    ExpiredError,
    InvalidError,
    NotFoundError,
    TooManyRequestsError,
    UnauthorizedError,
)
from .inmem import InMemoryCluster, JsonObj
from .selectors import parse_selector
from .writepipeline import (
    BATCH_WRITE_API_VERSION,
    BATCH_WRITE_PATH,
    JOURNAL_WAIT_PATH,
    MAX_BATCH_ITEMS,
    MAX_JOURNAL_WAIT_SECONDS,
    apply_write_op,
    decode_write_op,
)

logger = logging.getLogger(__name__)

#: with_faults sentinel: distinguishes "leave this knob as it is" from an
#: explicit reset, so fault kinds COMPOSE — a campaign cell can layer a
#: latency brownout under a targeted partition hook with two chained
#: calls instead of one call that knows every knob.
_UNSET = object()

#: the retractable fault kinds (ApiServerFacade.clear_fault_kind /
#: FaultSpec.cleared): each names the knob group that makes one fault
#: fire and the fault_counters key that proves it fired.
FAULT_KINDS = ("chaos", "latency", "held-stream")


@dataclass
class FaultSpec:
    """A serializable slice of the seeded fault stack: the knobs that
    are plain data (ratios, frame caps, latencies, seeds) — the hook
    knobs (request/partition/body) stay code and compose through
    :meth:`ApiServerFacade.with_faults` directly.

    ``apply`` LAYERS the spec onto the live stack with the same
    partial-update semantics as with_faults: a default-valued (off)
    knob is left untouched, so two specs targeting different kinds
    compose across two apply calls.  Retraction is by KIND —
    ``facade.clear_fault_kind(kind)`` (or ``spec.cleared(kind)`` for
    the data) turns exactly one fault off mid-scenario while sibling
    kinds keep firing AND keep counting: fault_counters is never
    touched by a clear, so evidence probes on composed stacks cannot
    under-count."""

    chaos_drop_ratio: float = 0.0
    chaos_seed: int = 0
    request_latency_seconds: float = 0.0
    latency_seed: Optional[int] = None
    held_stream_max_frames: int = 0

    def to_dict(self) -> dict:
        return {
            "chaos_drop_ratio": self.chaos_drop_ratio,
            "chaos_seed": self.chaos_seed,
            "request_latency_seconds": self.request_latency_seconds,
            "latency_seed": self.latency_seed,
            "held_stream_max_frames": self.held_stream_max_frames,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "FaultSpec":
        spec = cls()
        unknown = set(data) - set(spec.to_dict())
        if unknown:
            raise ValueError(
                f"unknown FaultSpec field(s) {sorted(unknown)} "
                f"(known: {sorted(spec.to_dict())})"
            )
        return cls(**data)

    def cleared(self, kind: str) -> "FaultSpec":
        """A copy with *kind*'s knobs back at their defaults."""
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (kinds: {FAULT_KINDS})"
            )
        out = FaultSpec(**self.to_dict())
        if kind == "chaos":
            out.chaos_drop_ratio = 0.0
            out.chaos_seed = 0
        elif kind == "latency":
            out.request_latency_seconds = 0.0
            out.latency_seed = None
        elif kind == "held-stream":
            out.held_stream_max_frames = 0
        return out

    def apply(self, facade: "ApiServerFacade") -> "ApiServerFacade":
        if self.chaos_drop_ratio:
            facade.with_chaos(self.chaos_drop_ratio, seed=self.chaos_seed)
        if self.request_latency_seconds:
            facade.with_faults(
                request_latency_seconds=self.request_latency_seconds,
                latency_seed=self.latency_seed,
            )
        if self.held_stream_max_frames:
            facade.with_faults(
                held_stream_max_frames=self.held_stream_max_frames
            )
        return facade

_REASONS = {
    UnauthorizedError: "Unauthorized",
    NotFoundError: "NotFound",
    AlreadyExistsError: "AlreadyExists",
    ConflictError: "Conflict",
    BadRequestError: "BadRequest",
    ExpiredError: "Gone",
    InvalidError: "Invalid",
    TooManyRequestsError: "TooManyRequests",
}


def _status_body(err: ApiError) -> JsonObj:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "message": str(err),
        "reason": _REASONS.get(type(err), "InternalError"),
        "code": err.code,
    }


def _with_gvk(obj: JsonObj, info: KindInfo) -> JsonObj:
    """Stamp apiVersion like a real apiserver response."""
    if "apiVersion" not in obj:
        obj["apiVersion"] = (
            f"{info.group}/{info.version}" if info.group else info.version
        )
    return obj


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "ApiServerFacade/1.0"
    # The status line/headers and the body leave in separate small
    # writes; with Nagle on, each response stalls ~40 ms against the
    # peer's delayed ACK — per request.  Real apiservers disable Nagle
    # on accepted connections (Go's net/http does by default).
    disable_nagle_algorithm = True

    # Set by ApiServerFacade
    cluster: InMemoryCluster
    #: When non-None, requests must carry ``Authorization: Bearer <t>``
    #: with t in this set (tests rotate it to exercise the client's exec
    #: credential refresh-on-401 path).  Shared mutable set — the facade
    #: owns it.
    accepted_tokens: Optional[set] = None
    #: >0 = server-enforced LIST page cap (see ApiServerFacade).
    max_list_page: int = 0
    #: >0 = priority-and-fairness max-in-flight: requests beyond this
    #: many concurrent non-watch requests are rejected 429 with
    #: Retry-After and the APF flow-schema header (see ApiServerFacade).
    apf_max_inflight: int = 0
    apf_state: Optional[dict] = None
    #: Serve the opt-in batch write endpoint (writepipeline.
    #: BATCH_WRITE_PATH).  False = vanilla-apiserver parity: the path
    #: 404s and the client transparently degrades to per-op writes.
    serve_batch_writes: bool = True
    #: Fault-injection knobs (set per-facade via with_chaos/with_faults
    #: on the bound handler subclass; class defaults = everything off).
    chaos_drop_ratio: float = 0.0
    chaos_rng = None
    request_hook = None
    held_stream_max_frames: int = 0
    #: >0: every request stalls this long (×0.5-1.5 jitter from
    #: latency_rng when seeded) before processing — the apiserver
    #: brownout that slows, rather than drops, the control plane.
    request_latency_seconds: float = 0.0
    latency_rng = None
    #: Targeted partition: predicate(method, info, namespace, name,
    #: query) -> bool; True resets the connection abruptly AFTER routing
    #: (the client sees ConnectionError), so a test can cut one kind's
    #: traffic — an informer partition — while the rest flows.
    partition_hook = None
    #: Write-body mutation: hook(method, path, body) -> body|None; runs
    #: after JSON parse, before handling.  The clock-skew seam: rewrite
    #: an Event's timestamps as a skewed operator clock would have.
    body_hook = None

    def _check_auth(self) -> None:
        if self.accepted_tokens is None:
            return
        auth = self.headers.get("Authorization", "")
        token = auth[len("Bearer "):] if auth.startswith("Bearer ") else ""
        if token not in self.accepted_tokens:
            raise UnauthorizedError("Unauthorized")

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        logger.debug("facade: " + fmt, *args)

    def _drain_body(self) -> None:
        """Consume the request body BEFORE any dispatch decision.  On a
        keep-alive connection every unread body byte is parsed as the
        NEXT request line — an early rejection (APF 429, 401, bad
        route) that skipped the body desynchronized the whole
        connection ('Bad request syntax' on the following request;
        found by the overload soak)."""
        length = int(self.headers.get("Content-Length") or 0)
        self._raw_body = self.rfile.read(length) if length else b""

    def _read_body(self) -> Optional[JsonObj]:
        raw = getattr(self, "_raw_body", b"")
        if not raw:
            return None
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as err:
            raise BadRequestError(f"invalid JSON body: {err}") from err
        hook = self.body_hook
        if hook is not None and isinstance(body, dict):
            mutated = hook(
                getattr(self, "_fault_method", ""),
                urlparse(self.path).path,
                body,
            )
            if mutated is not None:
                self._count_fault("body_mutations")
                body = mutated
        return body

    def _count_fault(self, key: str) -> None:
        counters = getattr(self, "fault_counters", None)
        if counters is not None:
            counters[key] = counters.get(key, 0) + 1

    def _send_json(self, code: int, body: JsonObj) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error_status(self, err: ApiError) -> None:
        self._send_json(err.code, _status_body(err))

    def _route(self):
        parsed = urlparse(self.path)
        route = route_for_path(parsed.path)
        if route is None:
            raise NotFoundError(f"no route for {parsed.path}")
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return route, query

    def _dispatch(self, method: str) -> None:
        # Chaos injection (ApiServerFacade.with_chaos): a fraction of
        # requests is dropped with an abrupt connection close BEFORE
        # processing — the client sees ConnectionError/IncompleteRead,
        # the operation was never applied, and the operator's retry /
        # next-reconcile idempotency must absorb it.  (Rate is seeded;
        # the PATTERN is thread-scheduling dependent — see with_chaos.)
        ratio = getattr(self, "chaos_drop_ratio", 0.0)
        rng = getattr(self, "chaos_rng", None)
        if ratio and rng is not None and rng.random() < ratio:
            self._count_fault("chaos_drops")
            self.close_connection = True
            try:
                import socket as _socket

                self.connection.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            return
        self._fault_method = method
        try:
            self._drain_body()
            # Latency brownout (with_faults): stall AFTER the body is
            # consumed (the connection stays synchronized) and before
            # any processing — every request pays it, like an apiserver
            # drowning in etcd latency.
            latency = self.request_latency_seconds
            if latency > 0:
                jitter_rng = self.latency_rng
                jitter = (
                    0.5 + jitter_rng.random() if jitter_rng is not None else 1.0
                )
                self._count_fault("delayed_requests")
                time.sleep(latency * jitter)
            self._check_auth()
            # Batch write endpoint (writepipeline.BATCH_WRITE_PATH):
            # outside every kind route, so a vanilla apiserver 404s it
            # and the client degrades.  Handled before routing but
            # INSIDE the APF gate below via the shared admission block —
            # one batch holds one seat, which is the endpoint's whole
            # point under overload.
            if (
                method == "post"
                and self.serve_batch_writes
                and urlparse(self.path).path == BATCH_WRITE_PATH
            ):
                self._admit_and_run({}, self._handle_batch_write)
                return
            # Journal long-poll (writepipeline.JOURNAL_WAIT_PATH): a
            # held wait, so — like a watch — it is APF-exempt (it holds
            # a thread, not a seat; seating it would let idle waiters
            # starve real traffic under max_inflight).
            if (
                method == "get"
                and self.serve_batch_writes
                and urlparse(self.path).path == JOURNAL_WAIT_PATH
            ):
                self._admit_and_run(
                    {"watch": "true"},
                    lambda: self._handle_journal_wait(
                        dict(parse_qsl(urlparse(self.path).query))
                    ),
                )
                return
            (info, namespace, name, subresource), query = self._route()
            # Targeted partition (with_faults): routed requests the
            # predicate selects die with an abrupt connection reset —
            # the network partition between ONE consumer (an informer's
            # kind, a drain worker's evictions) and the apiserver, while
            # everything else flows.
            partition = self.partition_hook
            if partition is not None and partition(
                method, info, namespace, name, query
            ):
                self._count_fault("partition_drops")
                self.close_connection = True
                try:
                    import socket as _socket

                    self.connection.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            # Fault-injection seam (ApiServerFacade.with_faults): runs
            # AFTER routing/auth and BEFORE handling, so a test can
            # mutate the store between two pages of one paginated LIST
            # (forcing a 410 on the continue token) or fail specific
            # requests.  An ApiError raised here is served as a normal
            # error Status — exactly what a real apiserver interposes.
            hook = getattr(self, "request_hook", None)
            if hook is not None:
                hook(method, info, namespace, name, query)
            self._admit_and_run(
                query,
                lambda: getattr(self, f"_handle_{method}")(
                    info, namespace, name, subresource, query
                ),
            )
        except ApiError as err:
            self._send_error_status(err)
        except Exception as err:  # noqa: BLE001 — server boundary
            logger.exception("facade: internal error")
            internal = ApiError(str(err))
            self._send_error_status(internal)

    def _admit_and_run(self, query, fn) -> None:
        """Priority-and-fairness max-in-flight: a real apiserver sheds
        load with 429 + Retry-After + the flow-schema header BEFORE
        processing.  Long-held watch streams are exempt (APF seats them
        once at admission, not for their whole hold)."""
        apf = self.apf_state
        gated = (
            apf is not None
            and self.apf_max_inflight > 0
            and query.get("watch") != "true"
        )
        if gated:
            with apf["lock"]:
                if apf["active"] >= self.apf_max_inflight:
                    apf["rejected"] += 1
                    self._send_overload()
                    return
                apf["active"] += 1
        try:
            # served = authenticated AND admitted (past the APF
            # gate) — shed/unauthorized requests must not inflate a
            # requests/sec numerator built on this counter
            if self.apf_state is not None:
                with self.apf_state["lock"]:
                    self.apf_state["served"] += 1
            fn()
        finally:
            if gated:
                with apf["lock"]:
                    apf["active"] -= 1

    def _handle_batch_write(self) -> None:
        """The opt-in batch endpoint: apply a list of writes in order,
        atomically PER OBJECT (each item rides the store's own object
        lock exactly as its standalone verb would), returning per-item
        status — one HTTP round trip where the client would have paid
        one per write.  A failed item never blocks later items; the
        response is always 200 with the item-level verdicts inside,
        like a real apiserver's Status-in-body subresources."""
        body = self._read_body()
        items = (body or {}).get("items")
        if not isinstance(items, list) or not items:
            raise BadRequestError(
                "batch write requires a non-empty items list"
            )
        if len(items) > MAX_BATCH_ITEMS:
            raise BadRequestError(
                f"batch of {len(items)} exceeds the {MAX_BATCH_ITEMS}-item cap"
            )
        decoded = [decode_write_op(raw) for raw in items]
        # one store-lock hold for the whole batch (InMemoryCluster.
        # batch_write): per-item acquisition paid a lock handoff + a
        # scheduler round trip per write under concurrent watch
        # pushers — ~100x the write itself at fleet scale
        batch = getattr(self.cluster, "batch_write", None)
        if batch is not None:
            applied = iter(batch([op for op, err in decoded if err is None]))
        else:
            applied = iter(
                apply_write_op(self.cluster, op)
                for op, err in decoded
                if err is None
            )
        results = []
        for op, err in decoded:
            obj = None
            if err is None:
                obj, err = next(applied)
            if err is not None:
                results.append(
                    {"status": err.code, "error": _status_body(err)}
                )
            elif obj is not None:
                results.append({"status": 200, "object": obj})
            else:
                results.append({"status": 200})
        self._send_json(
            200,
            {
                "kind": "BatchWriteResult",
                "apiVersion": BATCH_WRITE_API_VERSION,
                "items": results,
            },
        )

    def _handle_journal_wait(self, params: Dict[str, str]) -> None:
        """Opt-in journal long-poll (writepipeline.JOURNAL_WAIT_PATH):
        hold the request server-side until the store's journal advances
        past ``seq`` (or ``timeoutSeconds`` elapses), then answer with
        the current head — ONE round trip per wait where the vanilla
        fallback pays a 50 ms GET poll loop per waiting drain worker.
        Rides the store's condition variable, so the wakeup is
        zero-latency like the in-mem path."""
        try:
            seq = int(params.get("seq", "0"))
        except ValueError:
            raise BadRequestError("seq must be an integer") from None
        try:
            timeout_s = float(params.get("timeoutSeconds", "1"))
        except ValueError:
            raise BadRequestError("timeoutSeconds must be a number") from None
        timeout_s = max(0.0, min(timeout_s, MAX_JOURNAL_WAIT_SECONDS))
        head = self.cluster.wait_for_seq(seq, timeout=timeout_s)
        self._send_json(
            200,
            {
                "kind": "JournalHead",
                "apiVersion": BATCH_WRITE_API_VERSION,
                "seq": head,
            },
        )

    def _send_overload(self) -> None:
        err = TooManyRequestsError(
            "too many requests, please try again later"
        )
        data = json.dumps(_status_body(err)).encode()
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", "1")
        # what marks this 429 as APF load shedding (vs an Eviction's
        # PDB-driven 429, which carries no such header)
        self.send_header(
            "X-Kubernetes-PF-FlowSchema-UID", "facade-max-inflight"
        )
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("get")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("post")

    def do_PUT(self) -> None:  # noqa: N802
        self._dispatch("put")

    def do_PATCH(self) -> None:  # noqa: N802
        self._dispatch("patch")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("delete")

    # ------------------------------------------------------------- handlers
    def _handle_get(self, info, namespace, name, subresource, query) -> None:
        if name and not subresource:
            obj = self.cluster.get(info.kind, name, namespace)
            self._send_json(200, _with_gvk(obj, info))
            return
        if name:
            raise BadRequestError(f"unsupported subresource {subresource!r}")
        if query.get("watch") in ("true", "1"):
            self._serve_watch(info, query)
            return
        # Chunked LIST: client limit capped by the server-side max page
        # size (when the facade enforces one, EVERY response paginates —
        # the contract tests run rollouts with max_list_page=500 so the
        # client's pager is on the hot path, not an optional nicety).
        try:
            limit = int(query.get("limit") or 0)
        except ValueError as err:
            raise BadRequestError("limit must be an integer") from err
        max_page = getattr(self, "max_list_page", 0)
        if max_page:
            limit = min(limit, max_page) if limit else max_page
        page = self.cluster.list_page(
            info.kind,
            namespace=namespace if info.namespaced and namespace else None,
            label_selector=query.get("labelSelector", ""),
            field_selector=query.get("fieldSelector", ""),
            limit=limit,
            continue_token=query.get("continue", ""),
            resource_version=query.get("resourceVersion", ""),
            resource_version_match=query.get("resourceVersionMatch", ""),
        )
        meta: JsonObj = {"resourceVersion": page.resource_version}
        if page.continue_token:
            meta["continue"] = page.continue_token
        if page.remaining_item_count is not None:
            meta["remainingItemCount"] = page.remaining_item_count
        body = {
            "kind": f"{info.kind}List",
            "apiVersion": (
                f"{info.group}/{info.version}" if info.group else info.version
            ),
            "metadata": meta,
            "items": [_with_gvk(o, info) for o in page.items],
        }
        self._send_json(200, body)

    #: Watches asking for more than this many seconds are HELD: the
    #: response streams frames as journal events land, like a real
    #: apiserver.  Shorter timeouts close after the initial batch — the
    #: bounded-poll shim's synchronous contract.
    HELD_WATCH_MIN_TIMEOUT = 2.0

    @staticmethod
    def _selector_transition(ev, match) -> Optional[str]:
        """Watch-cache selector semantics: the frame TYPE depends on the
        selector-match transition, not just the store operation —
        an object that STOPS matching emits DELETED (the watcher must
        drop it from its view), one that STARTS matching emits ADDED."""
        labels_of = lambda o: (  # noqa: E731
            ((o or {}).get("metadata") or {}).get("labels") or {}
        )
        old_m = ev.old is not None and match(labels_of(ev.old))
        new_m = ev.new is not None and match(labels_of(ev.new))
        if ev.type == "Added":
            return "ADDED" if new_m else None
        if ev.type == "Deleted":
            return "DELETED" if old_m else None
        # Modified
        if old_m and new_m:
            return "MODIFIED"
        if old_m and not new_m:
            return "DELETED"
        if new_m and not old_m:
            return "ADDED"
        return None

    def _encode_watch_frames(self, info: KindInfo, events, match=None) -> list:
        frames = []
        for ev in events:
            obj = ev.new if ev.new is not None else ev.old
            if obj is None:
                continue
            if match is not None:
                type_ = self._selector_transition(ev, match)
                if type_ is None:
                    continue
            else:
                type_ = {
                    "Added": "ADDED",
                    "Modified": "MODIFIED",
                    "Deleted": "DELETED",
                }[ev.type]
            # DELETED frames carry the last object state, with the journal
            # seq as its resourceVersion so the watcher can advance.
            obj = dict(obj)
            obj.setdefault("metadata", {})
            obj["metadata"] = dict(obj["metadata"])
            obj["metadata"]["resourceVersion"] = str(ev.seq)
            frames.append(
                json.dumps({"type": type_, "object": _with_gvk(obj, info)})
            )
        return frames

    def _bookmark_frame(self, info: KindInfo, position: int) -> str:
        return json.dumps(
            {
                "type": "BOOKMARK",
                "object": {
                    "kind": info.kind,
                    "metadata": {"resourceVersion": str(position)},
                },
            }
        )

    def _serve_watch(self, info: KindInfo, query) -> None:
        """Watch: emit journal events after resourceVersion as
        newline-delimited JSON frames.  Short timeouts close after the
        initial batch (bounded poll); long ones HOLD the stream and push
        frames as they land until the timeout expires."""
        try:
            seq = int(query.get("resourceVersion") or 0)
        except ValueError as err:
            raise BadRequestError("resourceVersion must be an integer") from err
        try:
            timeout_s = float(query.get("timeoutSeconds") or 0)
        except ValueError:
            timeout_s = 0.0
        bookmarks = query.get("allowWatchBookmarks") in ("true", "1")
        # server-side filtered watch (client-go ListOptions.LabelSelector
        # on watches): non-matching frames never cross the wire, and
        # selector transitions rewrite the frame type (see
        # _selector_transition)
        selector = query.get("labelSelector", "")
        match = parse_selector(selector) if selector else None
        # Head BEFORE the scan (the Controller._watch_loop ordering): a
        # write landing between the two reads is then past the bookmark
        # and redelivered next poll — bookmarking a post-scan head would
        # let the client skip it forever.
        head = self.cluster.journal_seq()
        events = self.cluster.events_since(seq, kind=info.kind)
        frames = self._encode_watch_frames(info, events, match)
        position = max([head] + [ev.seq for ev in events])
        if timeout_s > self.HELD_WATCH_MIN_TIMEOUT:
            self._serve_held_watch(
                info, frames, position, timeout_s, bookmarks, match
            )
            return
        if bookmarks:
            # Closing BOOKMARK (real apiservers send one when a timed-out
            # watch closes): the stream position at close, so quiet kinds
            # stay fresh without borrowing another kind's RV.
            frames.append(self._bookmark_frame(info, position))
        data = ("\n".join(frames) + ("\n" if frames else "")).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _serve_held_watch(
        self,
        info: KindInfo,
        initial_frames: list,
        position: int,
        timeout_s: float,
        bookmarks: bool,
        match=None,
    ) -> None:
        """Stream frames as they land until *timeout_s* expires — the
        held-stream contract real apiservers provide.  Termination is
        connection-close delimited (no Content-Length), so the client
        reads line by line as events arrive."""
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Connection", "close")
        self.end_headers()
        deadline = time.monotonic() + timeout_s
        # The scan cursor is the GLOBAL journal position consumed so far —
        # it advances on every wakeup regardless of whether the appended
        # events matched our kind (waiting on `position`, which only moves
        # on matching events, would busy-spin through foreign-kind churn).
        cursor = position
        # Fault injection (ApiServerFacade.with_faults): abruptly reset
        # the connection after this many event frames — the LB-idle-cut
        # / network-flap a production informer must absorb mid-hold.
        max_frames = getattr(self, "held_stream_max_frames", 0)
        frames_written = 0
        try:
            if initial_frames:
                self.wfile.write(("\n".join(initial_frames) + "\n").encode())
                self.wfile.flush()
                frames_written += len(initial_frames)
                if max_frames and frames_written >= max_frames:
                    self._flap_held_stream()
                    return
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # Event-driven on the store's condition variable: wakes on
                # the next journal append or the chunk boundary.
                head = self.cluster.wait_for_seq(
                    cursor, timeout=min(remaining, 1.0)
                )
                if head <= cursor:
                    continue  # timed out with no new journal entries
                try:
                    events = self.cluster.events_since(cursor, kind=info.kind)
                except ExpiredError:
                    # Journal rolled past us mid-hold: close WITHOUT a
                    # closing bookmark — events of this kind may have been
                    # lost in the rolled window, so the client must come
                    # back with its stale position, get the 410, and
                    # relist.  A head bookmark here would skip them for
                    # good.
                    return
                cursor = max(cursor, head)
                if events:
                    frames = self._encode_watch_frames(info, events, match)
                    position = max(position, max(ev.seq for ev in events))
                    cursor = max(cursor, position)
                    if frames:
                        self.wfile.write(("\n".join(frames) + "\n").encode())
                        self.wfile.flush()
                        frames_written += len(frames)
                        if max_frames and frames_written >= max_frames:
                            self._flap_held_stream()
                            return
            if bookmarks:
                self.wfile.write(
                    (
                        self._bookmark_frame(info, max(position, cursor))
                        + "\n"
                    ).encode()
                )
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away mid-stream

    def _flap_held_stream(self) -> None:
        """Abruptly reset a held watch connection (with_faults): no
        closing bookmark, no clean FIN — the client's next read fails
        and its reconnect logic must resume from its own position."""
        counters = getattr(self, "fault_counters", None)
        if counters is not None:
            counters["held_flaps"] = counters.get("held_flaps", 0) + 1
        try:
            import socket as _socket

            self.connection.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass

    def _handle_post(self, info, namespace, name, subresource, query) -> None:
        body = self._read_body()
        if body is None:
            raise BadRequestError("POST requires a body")
        if name and subresource == "eviction" and info.kind == "Pod":
            delete_opts = body.get("deleteOptions") or {}
            self.cluster.evict(
                name,
                namespace,
                grace_period_seconds=delete_opts.get("gracePeriodSeconds"),
            )
            self._send_json(
                201,
                {
                    "kind": "Status",
                    "apiVersion": "v1",
                    "status": "Success",
                    "code": 201,
                },
            )
            return
        if name:
            raise BadRequestError(f"cannot POST to object path {self.path}")
        body.setdefault("kind", info.kind)
        if info.namespaced and namespace:
            body.setdefault("metadata", {}).setdefault("namespace", namespace)
        created = self.cluster.create(body)
        self._send_json(201, _with_gvk(created, info))

    def _handle_put(self, info, namespace, name, subresource, query) -> None:
        body = self._read_body()
        if body is None or not name:
            raise BadRequestError("PUT requires an object path and a body")
        body.setdefault("kind", info.kind)
        body.setdefault("metadata", {})["name"] = name
        if info.namespaced and namespace:
            body["metadata"].setdefault("namespace", namespace)
        if subresource == "status":
            updated = self.cluster.update_status(body)
        elif subresource:
            raise BadRequestError(f"unsupported subresource {subresource!r}")
        else:
            updated = self.cluster.update(body)
        self._send_json(200, _with_gvk(updated, info))

    def _handle_patch(self, info, namespace, name, subresource, query) -> None:
        body = self._read_body()
        if body is None or not name:
            raise BadRequestError("PATCH requires an object path and a body")
        content_type = (self.headers.get("Content-Type") or "").split(";")[0]
        if content_type == "application/strategic-merge-patch+json":
            patch_type = "strategic"
        elif content_type in ("application/merge-patch+json", "", "application/json"):
            patch_type = "merge"
        else:
            raise BadRequestError(
                f"unsupported patch content type {content_type!r}"
            )
        patched = self.cluster.patch(
            info.kind, name, body, namespace, patch_type=patch_type
        )
        self._send_json(200, _with_gvk(patched, info))

    def _handle_delete(self, info, namespace, name, subresource, query) -> None:
        if not name:
            raise BadRequestError("collection DELETE is not supported")
        grace: Optional[int] = None
        if "gracePeriodSeconds" in query:
            grace = int(query["gracePeriodSeconds"])
        body = self._read_body()
        if body and body.get("gracePeriodSeconds") is not None:
            grace = int(body["gracePeriodSeconds"])
        self.cluster.delete(info.kind, name, namespace, grace_period_seconds=grace)
        self._send_json(
            200,
            {"kind": "Status", "apiVersion": "v1", "status": "Success", "code": 200},
        )


class _TlsThreadingHTTPServer(ThreadingHTTPServer):
    """HTTPS serving with the handshake OFF the accept thread.

    Wrapping the *listening* socket would run each TLS handshake inside
    ``accept()`` on the single serve_forever thread — one peer that
    connects and never sends a ClientHello wedges the whole facade, and
    concurrent handshakes serialize.  Instead each accepted connection
    is wrapped in ITS OWN handler thread (``process_request_thread``
    runs there, per ThreadingMixIn), under a handshake deadline; a
    stalled or failed handshake costs that one thread, nothing else —
    which is also how a real apiserver's per-connection TLS behaves."""

    #: set by ApiServerFacade after construction
    ssl_context = None

    HANDSHAKE_TIMEOUT_S = 10.0

    def process_request_thread(self, request, client_address):
        try:
            request.settimeout(self.HANDSHAKE_TIMEOUT_S)
            request = self.ssl_context.wrap_socket(
                request, server_side=True
            )
            request.settimeout(None)
        except (OSError, ConnectionError):
            # handshake failure/timeout: drop this connection only
            try:
                request.close()
            except OSError:
                pass
            return
        super().process_request_thread(request, client_address)


class ApiServerFacade:
    """Lifecycle wrapper: serve an InMemoryCluster on 127.0.0.1:<port>."""

    def __init__(
        self,
        cluster: InMemoryCluster,
        port: int = 0,
        accepted_tokens: Optional[set] = None,
        max_list_page: int = 0,
        max_inflight: int = 0,
        ssl_context=None,
        batch_writes: bool = True,
        event_ttl_seconds: Optional[float] = None,
    ) -> None:
        """*ssl_context*: an ``ssl.SSLContext`` (``PROTOCOL_TLS_SERVER``)
        to serve HTTPS — envtest parity (the reference's test apiserver
        speaks TLS, upgrade_suit_test.go:87-93).  Set
        ``verify_mode=CERT_REQUIRED`` + ``load_verify_locations`` on it
        for mTLS client-certificate auth."""
        self.cluster = cluster
        # Event retention override (kube-apiserver --event-ttl): the
        # store owns the GC; this just configures it per facade.
        if event_ttl_seconds is not None:
            cluster.event_ttl_seconds = event_ttl_seconds
        #: Mutable: tests rotate the accepted set mid-run to force 401s
        #: (exec-plugin refresh path).  None = no auth required.
        self.accepted_tokens = accepted_tokens
        #: Shared handler-thread counters: ``rejected`` counts APF
        #: load-shed 429s (the tests' observable); ``served`` counts
        #: requests that were authenticated, routed, AND admitted past
        #: the APF gate — chaos-dropped, 401, unroutable, and shed
        #: requests are all excluded, so it is a clean requests/sec
        #: numerator for the bench.
        self.apf_state = {
            "lock": threading.Lock(),
            "active": 0,
            "rejected": 0,
            "served": 0,
        }
        #: Shared fault-injection counters (with_faults/with_chaos
        #: observability — a chaos scenario that cannot show the chaos
        #: happened proves nothing): ``held_flaps`` counts abrupt
        #: held-stream resets, ``chaos_drops`` random request drops,
        #: ``partition_drops`` targeted partition resets,
        #: ``delayed_requests`` latency-stalled requests and
        #: ``body_mutations`` write bodies rewritten by the body hook.
        self.fault_counters: Dict[str, int] = {
            "held_flaps": 0,
            "chaos_drops": 0,
            "partition_drops": 0,
            "delayed_requests": 0,
            "body_mutations": 0,
        }
        self._handler_cls = type(
            "BoundHandler",
            (_Handler,),
            {
                "cluster": cluster,
                "accepted_tokens": accepted_tokens,
                "fault_counters": self.fault_counters,
                # >0: server-enforced page cap — every LIST paginates at
                # most this many items per response, client limit or not
                # (how the contract tests force the pager onto every
                # code path).
                "max_list_page": max_list_page,
                # >0: APF max-in-flight load shedding (429 + Retry-After
                # + flow-schema header on concurrent non-watch overflow).
                "apf_max_inflight": max_inflight,
                "apf_state": self.apf_state,
                # False: vanilla-apiserver parity — no batch endpoint,
                # the client's degrade path (contract-tested).
                "serve_batch_writes": batch_writes,
            },
        )
        server_cls = (
            _TlsThreadingHTTPServer
            if ssl_context is not None
            else ThreadingHTTPServer
        )
        self._server = server_cls(("127.0.0.1", port), self._handler_cls)
        self._server.daemon_threads = True
        self._tls = ssl_context is not None
        if ssl_context is not None:
            self._server.ssl_context = ssl_context
        self._thread: Optional[threading.Thread] = None

    def with_chaos(self, drop_ratio: float, seed: int = 0) -> "ApiServerFacade":
        """Drop a fraction of requests with an abrupt connection close
        before they are processed (fault injection for the
        client/operator retry paths).  Chainable — composes with
        :meth:`with_faults`, so a campaign cell can layer drop-ratio
        chaos UNDER a targeted request/partition hook (the chaos draw
        runs first; survivors then meet the deterministic faults).
        Ratio 0 disables; drops count into ``fault_counters
        ["chaos_drops"]``.

        The seed pins the statistical RATE, not the drop pattern: the
        RNG is shared across handler threads, so thread scheduling
        decides which request consumes which draw.  Chaos consumers must
        assert properties that hold for any drop pattern (convergence,
        legal transitions), never a specific sequence.  The chaos
        campaign engine (:mod:`..upgrade.chaos`) derives this seed
        deterministically per cell from (campaign seed, scenario, axis
        values) so a cell replays with the same statistical profile."""
        import random as _random

        self._handler_cls.chaos_drop_ratio = drop_ratio
        self._handler_cls.chaos_rng = _random.Random(seed)
        return self

    def with_faults(
        self,
        request_hook=_UNSET,
        held_stream_max_frames=_UNSET,
        request_latency_seconds=_UNSET,
        latency_seed=_UNSET,
        partition_hook=_UNSET,
        body_hook=_UNSET,
    ) -> "ApiServerFacade":
        """Deterministic fault injection (beyond with_chaos's random
        drops).  Only the knobs explicitly passed change — omitted ones
        keep their current setting, so fault kinds COMPOSE across
        chained calls (``facade.with_chaos(0.05, seed).with_faults(
        request_hook=h).with_faults(request_latency_seconds=0.002)``);
        :meth:`clear_faults` resets everything at once.

        * *request_hook(method, info, namespace, name, query)* — runs
          after routing/auth and before handling on every request:
          mutate the store between two pages of one paginated LIST to
          expire a continue token, or raise an ApiError to fail chosen
          requests.  None disables.
        * *held_stream_max_frames* > 0 — abruptly resets every held
          watch stream after that many event frames (counted in
          :data:`fault_counters` as ``held_flaps``) — the mid-hold
          network flap.  0 disables.
        * *request_latency_seconds* > 0 — every request stalls this
          long before processing (the slow brownout); with
          *latency_seed* set, each stall jitters ×0.5–1.5 from a seeded
          shared RNG (rate deterministic, per-request draw scheduling-
          dependent — same seed contract as with_chaos).  0 disables.
        * *partition_hook(method, info, namespace, name, query)* →
          bool — True resets that connection abruptly after routing
          (counted as ``partition_drops``): a targeted partition
          between one traffic class and the apiserver.  None disables.
        * *body_hook(method, path, body)* → body|None — rewrite write
          bodies after JSON parse (counted as ``body_mutations`` when a
          non-None replacement is returned): the clock-skew seam.  None
          disables."""
        cls = self._handler_cls
        if request_hook is not _UNSET:
            cls.request_hook = (
                staticmethod(request_hook) if request_hook is not None else None
            )
        if held_stream_max_frames is not _UNSET:
            cls.held_stream_max_frames = int(held_stream_max_frames)
        if request_latency_seconds is not _UNSET:
            cls.request_latency_seconds = float(request_latency_seconds)
        if latency_seed is not _UNSET:
            import random as _random

            cls.latency_rng = (
                _random.Random(latency_seed) if latency_seed is not None else None
            )
        if partition_hook is not _UNSET:
            cls.partition_hook = (
                staticmethod(partition_hook)
                if partition_hook is not None
                else None
            )
        if body_hook is not _UNSET:
            cls.body_hook = (
                staticmethod(body_hook) if body_hook is not None else None
            )
        return self

    def clear_faults(self) -> "ApiServerFacade":
        """Reset every with_faults/with_chaos knob to off (counters are
        left standing — they are the evidence of what already fired)."""
        cls = self._handler_cls
        cls.request_hook = None
        cls.held_stream_max_frames = 0
        cls.request_latency_seconds = 0.0
        cls.latency_rng = None
        cls.partition_hook = None
        cls.body_hook = None
        cls.chaos_drop_ratio = 0.0
        cls.chaos_rng = None
        return self

    def clear_fault_kind(self, kind: str) -> "ApiServerFacade":
        """Retract exactly ONE fault kind (:data:`FAULT_KINDS`)
        mid-scenario, leaving sibling kinds firing.  The counters in
        :data:`fault_counters` are deliberately untouched — including
        the cleared kind's own tally (it is the evidence of what
        already fired) and, critically, the SIBLINGS' tallies, which
        keep incrementing: a composed stack that sheds its latency
        layer must not stop proving its chaos drops."""
        cls = self._handler_cls
        if kind == "chaos":
            cls.chaos_drop_ratio = 0.0
            cls.chaos_rng = None
        elif kind == "latency":
            cls.request_latency_seconds = 0.0
            cls.latency_rng = None
        elif kind == "held-stream":
            cls.held_stream_max_frames = 0
        else:
            raise ValueError(
                f"unknown fault kind {kind!r} (kinds: {FAULT_KINDS})"
            )
        return self

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    @property
    def requests_served(self) -> int:
        """Requests authenticated, routed, and APF-admitted since start
        (watch establishments count once; chaos-dropped, 401, and
        load-shed requests never count)."""
        with self.apf_state["lock"]:
            return self.apf_state["served"]

    def start(self) -> "ApiServerFacade":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="apiserver-facade", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "ApiServerFacade":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
