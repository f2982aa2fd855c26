"""Rollout history from cluster-visible Events — `kubectl rollout
history` for node upgrades.

The reference's consumers inspect upgrade history with
``kubectl describe node`` / ``kubectl get events`` over the Events that
controller-runtime's recorder emitted (util.go:162-177).  This module is
that view as a first-class surface: it reads the deduplicated core/v1
Events :class:`~.util.ClusterEventRecorder` writes (count /
firstTimestamp / lastTimestamp — the client-go correlator contract) and
renders a per-node upgrade timeline, offline from a dump or live
through a :class:`~..cluster.kubeclient.KubeApiClient`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..cluster.errors import BadRequestError, NotFoundError


@dataclass
class HistoryEntry:
    """One deduplicated Event about a managed node."""

    node: str
    type: str
    reason: str
    message: str
    count: int
    first_timestamp: str
    last_timestamp: str
    component: str = ""

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "count": self.count,
            "firstTimestamp": self.first_timestamp,
            "lastTimestamp": self.last_timestamp,
            "component": self.component,
        }


def _int_or(value, default: int) -> int:
    """Malformed-dump guard (same convention as cmd_plan's RV parsing):
    a hand-edited Event with count \"2x\" must not traceback the CLI."""
    try:
        return int(value or default)
    except (ValueError, TypeError):
        return default


def _list_events(cluster, namespace, node):
    """List Events, server-side filtered to Nodes when the backend
    supports the involvedObject fieldSelector (real apiservers do; a
    busy cluster's Events are mostly about Pods, so the filter saves the
    bulk of the transfer).  The in-memory backend only indexes Pod
    spec.nodeName and answers 400 — fall back to a plain list."""
    selector = "involvedObject.kind=Node"
    if node:
        selector += f",involvedObject.name={node}"
    try:
        return cluster.list(
            "Event", namespace=namespace, field_selector=selector
        )
    except BadRequestError:
        return cluster.list("Event", namespace=namespace)


def node_event_history(
    cluster,
    node: Optional[str] = None,
    namespaces: Optional[List[str]] = None,
    component: Optional[str] = None,
) -> List[HistoryEntry]:
    """Collect Events about Nodes, newest last.

    *namespaces*: where to look for Event objects (node Events land in
    the recorder's namespace — ``"default"`` unless the operator chose
    otherwise); None lists across all namespaces, which is what
    ``kubectl get events -A`` does and is the robust default when the
    recorder's namespace is not known.

    *component*: keep only Events whose ``source.component`` matches —
    on a real cluster Node events are mostly kubelet / node-controller
    noise (NodeHasSufficientMemory, RegisteredNode, ...); pass the
    operator's recorder component (``"<name>Upgrade"`` by default, see
    :func:`~.util.get_event_reason`) to get the pure upgrade timeline.
    None keeps everything (``kubectl get events`` behavior)."""
    events: List[dict] = []
    if namespaces:
        for ns in namespaces:
            try:
                events.extend(_list_events(cluster, ns, node))
            except NotFoundError:
                # Events kind not served in this namespace source.  Real
                # read failures (401/5xx ApiError, transport) PROPAGATE —
                # "no events" and "could not read events" must not
                # collapse into the same empty answer.
                continue
    else:
        events = _list_events(cluster, None, node)
    seen: Dict[str, HistoryEntry] = {}
    for ev in events:
        involved = ev.get("involvedObject") or {}
        if involved.get("kind") != "Node":
            continue
        name = involved.get("name") or ""
        if node is not None and name != node:
            continue
        # events.k8s.io-style writers set reportingController and leave
        # the deprecated source block empty — same writer class the
        # timestamp fallback below handles
        source_component = (
            ((ev.get("source") or {}).get("component"))
            or ev.get("reportingComponent")
            or ev.get("reportingController")
            or ""
        )
        if component is not None and source_component != component:
            continue
        key = f"{(ev.get('metadata') or {}).get('namespace', '')}/" + (
            (ev.get("metadata") or {}).get("name", "")
        )
        # events.k8s.io-style writers fill eventTime and leave the legacy
        # timestamps null — fall back so they sort and render correctly
        seen[key] = HistoryEntry(
            node=name,
            type=ev.get("type") or "",
            reason=ev.get("reason") or "",
            message=ev.get("message") or "",
            count=_int_or(ev.get("count"), 1),
            first_timestamp=ev.get("firstTimestamp")
            or ev.get("eventTime")
            or "",
            last_timestamp=ev.get("lastTimestamp")
            or ev.get("eventTime")
            or "",
            component=source_component,
        )
    out = list(seen.values())
    if node is not None and not out:
        # Empty could mean "no events yet" OR "no such node" — different
        # answers (a typo'd --node must not read as a clean history).
        # Disambiguate against the Node object itself when the source can
        # serve one; NotFoundError propagates to the caller.
        getter = getattr(cluster, "get", None)
        if callable(getter):
            getter("Node", node)
    # ISO-8601 UTC strings order lexicographically; ties break on node
    out.sort(key=lambda e: (e.last_timestamp, e.node, e.reason))
    return out


def render_history(entries: List[HistoryEntry]) -> str:
    """kubectl-get-events-style table, oldest first."""
    if not entries:
        return "No node upgrade events found."
    headers = ("LAST SEEN", "TYPE", "REASON", "NODE", "COUNT", "MESSAGE")
    rows = [
        (
            e.last_timestamp,
            e.type,
            e.reason,
            e.node,
            str(e.count),
            e.message,
        )
        for e in entries
    ]
    widths = [
        max(len(headers[i]), max(len(r[i]) for r in rows))
        for i in range(len(headers) - 1)
    ]
    lines = [
        "  ".join(h.ljust(widths[i]) for i, h in enumerate(headers[:-1]))
        + "  "
        + headers[-1]
    ]
    for r in rows:
        lines.append(
            "  ".join(r[i].ljust(widths[i]) for i in range(len(headers) - 1))
            + "  "
            + r[-1]
        )
    return "\n".join(lines)
