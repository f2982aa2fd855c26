"""ClusterStateIndex — journal-driven incremental BuildState.

Every reconcile used to rebuild :class:`~.common_manager.ClusterUpgradeState`
from scratch: ``build_state`` relists all Nodes and all driver Pods even
when a single node changed, so snapshot cost is O(fleet) per cycle and
the bench's nodes/min retention falls off at 4k+ nodes.  This module
keeps the node→{node, driver-pod, owning-DaemonSet} grouping *resident*
and advances it by the same watch-event journal the
:class:`~..cluster.cache.InformerCache` consumes — the informer
list/watch contract, applied to the state machine's own snapshot:

* **seed / recovery** is a full relist (:meth:`rebuild`), exactly the
  informer's initial list and the 410 Gone path — journal expiry
  (:class:`~..cluster.errors.ExpiredError`) falls back to it
  automatically, with a counter so expiry churn is observable;
* **steady state** consumes ``events_since`` deltas (:meth:`refresh`),
  guarded per object by resourceVersion so replayed/duplicated frames
  (held-stream reconnects, sync overlap) never regress the view — the
  same monotonic-apply rule as the informer cache;
* every delta also feeds a **dirty-node set**: the names whose snapshot
  inputs (node, any pod on the node, the DaemonSet/ControllerRevision
  revision oracle, the node's NodeMaintenance CR) changed since the last
  :meth:`build_state`.  ApplyState's fleet-wide scans (done/unknown
  classification, failed-node self-healing) visit only those — O(changed)
  instead of O(fleet) — while the full scan stays the fallback whenever
  the set is unknown (fresh rebuild, index disabled).

Assembly hands out a **materialized view**: per-pod
:class:`~.common_manager.NodeUpgradeState` objects cached across builds
and re-copied from the pristine store only when their node went dirty.
That is safe precisely because the state machine's in-place node
mutations (``NodeUpgradeStateProvider`` updates the caller's dict after
every successful patch) always correspond to a cluster write, and every
cluster write lands in the journal and dirties the node — a clean node's
cached view is byte-identical to a fresh copy.  The property test in
``tests/test_torch_state_index.py`` replays randomized event interleavings to
hold the index to exact equivalence with the from-scratch build.

The pristine store itself is never handed out; processors may mutate
view objects freely without corrupting the index.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Set, Tuple

from .. import metrics
from ..cluster.client import ClusterClient, JsonObj
from ..cluster.errors import ExpiredError
from ..cluster.inmem import json_copy
from ..cluster.objects import is_owned_by, owner_references
from ..cluster.selectors import labels_to_selector, parse_selector
from . import consts, util
from .common_manager import ClusterUpgradeState, NodeUpgradeState

logger = logging.getLogger(__name__)

#: Pod key inside the index: (namespace, name).
PodKey = Tuple[str, str]


def _remediation_annotations_only(
    old: Optional[JsonObj], new: Optional[JsonObj]
) -> bool:
    """True when *old* → *new* differs only in the remediation
    bookkeeping annotations (plus resourceVersion) — the one DaemonSet
    write class that cannot affect the snapshot grouping or the
    revision oracle, and therefore must not dirty the whole fleet."""
    if old is None or new is None:
        return False
    bookkeeping = {
        util.get_last_known_good_annotation_key(),
        util.get_breaker_annotation_key(),
    }

    def normalized(ds: JsonObj) -> JsonObj:
        out = dict(ds)
        meta = dict(out.get("metadata") or {})
        meta.pop("resourceVersion", None)
        annotations = {
            k: v
            for k, v in (meta.get("annotations") or {}).items()
            if k not in bookkeeping
        }
        meta["annotations"] = annotations
        out["metadata"] = meta
        return out

    if (old.get("metadata") or {}).get("annotations") == (
        new.get("metadata") or {}
    ).get("annotations"):
        return False  # annotations did not move: not this write class
    return normalized(old) == normalized(new)


class ClusterStateIndex:
    """Incrementally maintained cluster-state snapshot for one
    (namespace, driver-labels) scope.

    * ``externally_fed=False`` (default): :meth:`build_state` advances
      the index itself via ``events_since`` — right for the in-memory
      journal (multi-consumer) and for any client with its own watch
      position.
    * ``externally_fed=True``: the owner pushes drained watch batches
      via :meth:`ingest` (the Controller's ``event_sink`` tee — the
      single-reflector rule on pop-once HTTP streams, same contract as
      :class:`~..cluster.cache.InformerCache`); builds never touch the
      journal beyond the one-time seeding rebuild.
    """

    #: Kinds whose events move the snapshot or the dirty set.  Node /
    #: Pod / DaemonSet are the grouping; ControllerRevision is the
    #: revision-sync oracle (a publish makes every pod "out of sync"
    #: without touching any grouped object); NodeMaintenance feeds the
    #: requestor-mode attachment.
    WATCH_KINDS = (
        "ControllerRevision",
        "DaemonSet",
        "Node",
        "NodeMaintenance",
        "Pod",
    )

    def __init__(
        self,
        cluster: ClusterClient,
        namespace: str,
        driver_labels: Dict[str, str],
        externally_fed: bool = False,
    ) -> None:
        self._cluster = cluster
        self.namespace = namespace
        self.driver_labels = dict(driver_labels)
        self._selector = labels_to_selector(driver_labels)
        self._match = parse_selector(self._selector)
        self.externally_fed = externally_fed
        self._lock = threading.RLock()
        # Pristine store — advanced by the journal, never handed out.
        self._nodes: Dict[str, JsonObj] = {}  #: guarded-by: _lock
        self._daemon_sets: Dict[str, JsonObj] = {}  #: guarded-by: _lock (uid -> DS)
        self._pods: Dict[PodKey, JsonObj] = {}  #: guarded-by: _lock
        self._pods_by_node: Dict[str, Set[PodKey]] = {}  #: guarded-by: _lock
        # Materialized view — the objects handed to ApplyState, reused
        # across builds until their inputs go dirty.
        self._view_nodes: Dict[str, JsonObj] = {}
        self._view_ds: Dict[str, JsonObj] = {}
        self._view_states: Dict[PodKey, NodeUpgradeState] = {}
        # Assembly-order cache: the deterministic (DS-grouped,
        # name-sorted) pod-key sequence plus per-DS owned counts.  Only
        # pod set/ownership membership and DaemonSet changes can move it
        # — pure content updates (pod status, node labels: the steady
        # state) reuse it, so a quiet build does no sorting and no
        # per-pod ownership scan.
        self._order: Optional[List[PodKey]] = None
        self._order_counts: Dict[str, int] = {}
        self._dirty: Set[str] = set()  #: guarded-by: _lock
        self._all_dirty = True
        # Un-ACKed scan debt: the dirty information handed to the most
        # recent build_state.  It stays owed — merged into every
        # subsequent build's dirty view — until :meth:`ack_dirty`
        # confirms an ApplyState pass actually processed it.  Without
        # this, a build whose apply never ran (paused policy, abort,
        # equivalence probes, the plan sandbox) would silently consume
        # change information and strand nodes outside the scoped scans.
        self._pending: Set[str] = set()  #: guarded-by: _lock
        self._pending_all = False
        self._seeded = False
        self._last_seq = 0
        #: requestor-mode hook: when set, materialization attaches the
        #: node's NodeMaintenance CR exactly like the full build's
        #: ``_build_node_upgrade_state`` (set via :meth:`set_requestor`).
        self.requestor = None
        #: observability (tests assert refreshes stay incremental; ops
        #: spot journal-expiry churn)
        self.full_rebuilds = 0
        self.incremental_refreshes = 0
        self.events_applied = 0

    # ------------------------------------------------------------ feeding
    def rebuild(self, reason: str = "relist") -> None:
        """Full resync from the backend — the informer's initial list
        and the 410 Gone recovery path.  Also the Controller's
        ``relist_sink`` hook when the index rides the watch tee."""
        with self._lock:
            # Head first: events recorded between the head read and the
            # lists re-apply idempotently under the rv guard (the same
            # loss-free ordering as InformerCache.sync).
            seq = self._cluster.journal_seq()
            nodes = self._cluster.list("Node")
            daemon_sets = self._cluster.list(
                "DaemonSet",
                namespace=self.namespace,
                label_selector=self._selector,
            )
            pods = self._cluster.list(
                "Pod",
                namespace=self.namespace,
                label_selector=self._selector,
            )
            self._nodes = {
                (n.get("metadata") or {}).get("name", ""): n for n in nodes
            }
            self._daemon_sets = {
                ds["metadata"]["uid"]: ds for ds in daemon_sets
            }
            self._pods = {}
            self._pods_by_node = {}
            for pod in pods:
                self._store_pod(pod)
            self._last_seq = seq
            self._seeded = True
            self._all_dirty = True
            self._dirty.clear()
            self._order = None
            self._clear_view()
            self.full_rebuilds += 1
            metrics.record_state_index_rebuild(reason)

    def refresh(self) -> None:
        """Advance by journal deltas; fall back to :meth:`rebuild` on
        journal expiry (410 Gone)."""
        with self._lock:
            if not self._seeded:
                self.rebuild("seed")
                return
            try:
                head = self._cluster.journal_seq()
                events = self._cluster.events_since(
                    self._last_seq, kind=self.WATCH_KINDS
                )
            except ExpiredError:
                logger.info(
                    "state index journal position expired, rebuilding"
                )
                self.rebuild("journal-expired")
                return
            self._apply_events(events, head)
            self.incremental_refreshes += 1

    def ingest(self, events) -> None:
        """Apply watch deltas pushed by an external consumer (the
        Controller's ``event_sink``).  Safe on any index — application
        is rv-guarded and idempotent — but only an ``externally_fed``
        one depends on it."""
        if not events:
            return
        with self._lock:
            if not self._seeded:
                # Deltas atop an unseeded store would silently miss
                # every pre-existing object; seed first (same rule as
                # the externally-fed InformerCache).
                self.rebuild("seed")
            self._apply_events(events, head=None)

    def invalidate(self) -> None:
        """Force the next build through a full rebuild (error recovery)."""
        with self._lock:
            self._seeded = False
            self._all_dirty = True

    def mark_dirty(self, names) -> None:
        """Explicitly queue node names for the next pass's scoped scans
        (tests, embedders with out-of-band knowledge)."""
        with self._lock:
            self._dirty.update(names)

    def ack_dirty(self) -> None:
        """Confirm the most recent build's dirty view was fully
        processed (an ApplyState pass ran to completion over it) —
        clears the scan debt.  The manager calls this; anyone else
        almost certainly should not."""
        with self._lock:
            self._pending.clear()
            self._pending_all = False

    def set_requestor(self, requestor) -> None:
        """Attach (or swap) the requestor-mode strategy.  A change
        invalidates the materialized view: cached states were built
        without (or with another) NodeMaintenance attachment."""
        with self._lock:
            if requestor is not self.requestor:
                self.requestor = requestor
                self._all_dirty = True

    # --------------------------------------------------- event application
    def _apply_events(self, events, head: Optional[int]) -> None:
        for ev in events:
            self._apply_event(ev)
            self._last_seq = max(self._last_seq, ev.seq)
        if head is not None:
            self._last_seq = max(self._last_seq, head)

    def _apply_event(self, ev) -> None:
        # Route on the event's own kind slot BEFORE touching new/old:
        # those properties materialize blob-backed trees, and the
        # controller tee delivers frames for kinds this index never
        # tracks (policy CRs, future sink kinds) — they must stay
        # un-materialized (the WatchEvent.kind contract, inmem.py).
        kind = ev.kind
        if kind not in self.WATCH_KINDS:
            return
        obj = ev.new if ev.new is not None else ev.old
        if obj is None:
            return
        if kind == "Node":
            self._apply_node(ev, obj)
        elif kind == "Pod":
            self._apply_pod(ev, obj)
        elif kind == "DaemonSet":
            self._apply_daemon_set(ev, obj)
        elif kind == "ControllerRevision":
            # The revision-sync oracle moved: every pod's in-sync verdict
            # may flip without any grouped object changing.
            if (obj.get("metadata") or {}).get("namespace", "") == self.namespace:
                self._all_dirty = True
        elif kind == "NodeMaintenance":
            node = (obj.get("spec") or {}).get("nodeName") or ""
            if node:
                self._dirty.add(node)
            else:
                self._all_dirty = True
        self.events_applied += 1

    @staticmethod
    def _stale(current: Optional[JsonObj], seq: int) -> bool:
        """Monotonic apply guard (same rule as the informer cache): the
        store already holds this object at a revision >= the frame's."""
        if current is None:
            return False
        try:
            return int(
                (current.get("metadata") or {}).get("resourceVersion") or 0
            ) >= seq
        except ValueError:
            return False

    # Pristine-store entries ALIAS the journal's materialized event
    # trees instead of deep-copying them: every consumer of the journal
    # treats event objects as immutable (the informer contract — the
    # cache deep-copies on hand-out for the same reason), and this index
    # only ever copies them at materialization.  At fleet scale a wave
    # is tens of thousands of events per cycle; one avoided deep copy
    # per event is a double-digit percentage of the reconcile.

    def _apply_node(self, ev, obj: JsonObj) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        # Dirty regardless of staleness — over-dirtying costs one extra
        # per-node check; under-dirtying strands a node.
        self._dirty.add(name)
        if self._stale(self._nodes.get(name), ev.seq):
            return
        if ev.type == "Deleted":
            self._nodes.pop(name, None)
        else:
            self._nodes[name] = obj

    def _pod_qualifies(self, obj: JsonObj) -> bool:
        meta = obj.get("metadata") or {}
        if (meta.get("namespace") or "") != self.namespace:
            return False
        return self._match(meta.get("labels") or {})

    def _apply_pod(self, ev, obj: JsonObj) -> None:
        meta = obj.get("metadata") or {}
        key: PodKey = (meta.get("namespace", ""), meta.get("name", ""))
        node = (obj.get("spec") or {}).get("nodeName") or ""
        # ANY pod event dirties its node — workload pods (other labels,
        # other namespaces) are inputs too: wait-for-jobs re-checks and
        # drain verdicts hinge on them even though only driver pods are
        # grouped in the snapshot.
        self._dirty.add(node)
        current = self._pods.get(key)
        if current is not None:
            # a pod that moved (or lost) its node assignment dirties
            # both sides of the move
            self._dirty.add((current.get("spec") or {}).get("nodeName") or "")
        if self._stale(current, ev.seq):
            return
        if ev.type == "Deleted" or not self._pod_qualifies(obj):
            if current is not None:
                self._order = None  # membership changed
            self._drop_pod(key)
        else:
            if current is None or owner_references(current) != owner_references(
                obj
            ):
                self._order = None  # membership or ownership changed
            self._drop_pod(key)
            self._store_pod(obj)

    def _apply_daemon_set(self, ev, obj: JsonObj) -> None:
        meta = obj.get("metadata") or {}
        uid = meta.get("uid", "")
        in_scope = (meta.get("namespace") or "") == self.namespace and self._match(
            meta.get("labels") or {}
        )
        tracked = uid in self._daemon_sets
        if not in_scope and not tracked:
            return
        current = self._daemon_sets.get(uid)
        if (
            ev.type == "Modified"
            and in_scope
            and tracked
            and not self._stale(current, ev.seq)
            and _remediation_annotations_only(current, obj)
        ):
            # Remediation bookkeeping (the LKG/breaker annotations the
            # RemediationManager re-writes as rollouts progress) cannot
            # move the revision oracle or the ownership grouping — a
            # fleet-wide dirty per bookkeeping write would make every
            # remediation-enabled reconcile O(fleet) and defeat the
            # incremental build.  Absorb it in place, views included
            # (handed-out snapshots share the view DS dict).
            self._daemon_sets[uid] = obj
            view = self._view_ds.get(uid)
            if view is not None:
                view_meta = view.setdefault("metadata", {})
                view_meta["annotations"] = dict(meta.get("annotations") or {})
                view_meta["resourceVersion"] = meta.get("resourceVersion")
            self.events_applied += 1
            return
        # A driver DaemonSet changed (template edit, desired count,
        # scope entry/exit): ownership grouping and the revision oracle
        # are both suspect — everything is dirty.
        self._all_dirty = True
        self._order = None
        if self._stale(current, ev.seq):
            return
        if ev.type == "Deleted" or not in_scope:
            self._daemon_sets.pop(uid, None)
        else:
            self._daemon_sets[uid] = obj

    def _store_pod(self, pod: JsonObj) -> None:
        meta = pod.get("metadata") or {}
        key: PodKey = (meta.get("namespace", ""), meta.get("name", ""))
        self._pods[key] = pod
        node = (pod.get("spec") or {}).get("nodeName") or ""
        self._pods_by_node.setdefault(node, set()).add(key)

    def _drop_pod(self, key: PodKey) -> None:
        pod = self._pods.pop(key, None)
        self._view_states.pop(key, None)
        if pod is not None:
            node = (pod.get("spec") or {}).get("nodeName") or ""
            bucket = self._pods_by_node.get(node)
            if bucket is not None:
                bucket.discard(key)

    # ------------------------------------------------------------ assembly
    def _clear_view(self) -> None:
        self._view_nodes.clear()
        self._view_ds.clear()
        self._view_states.clear()

    def build_state(self) -> Tuple[ClusterUpgradeState, Optional[Set[str]]]:
        """Assemble the ClusterUpgradeState from the index.

        Returns ``(state, dirty_nodes)`` where *dirty_nodes* is the set
        of node names whose inputs changed since the previous build —
        or ``None`` after a full rebuild / seed, meaning "unknown, scan
        everything" (the safe fallback ApplyState already implements).

        Bucket contents and ordering replicate the from-scratch
        ``build_state`` exactly: DaemonSets in (namespace, name) order,
        each DS's owned pods name-sorted, orphaned pods last; pending
        pods with no node assignment are skipped; a desired/found
        mismatch or a missing node raises the same
        :class:`~.upgrade_state.UpgradeStateError` the full build does.
        """
        from .upgrade_state import UpgradeStateError  # late: avoids cycle

        with self._lock:
            if not self.externally_fed:
                self.refresh()
            elif not self._seeded:
                self.rebuild("seed")
            fresh_all, self._all_dirty = self._all_dirty, False
            fresh, self._dirty = self._dirty, set()
            # View invalidation follows actual CONTENT changes only (the
            # un-acked debt below re-scopes the scans, but its objects
            # are already materialized correctly).
            if fresh_all:
                self._clear_view()
            else:
                for name in fresh:
                    self._view_nodes.pop(name, None)
                    for key in self._pods_by_node.get(name, ()):
                        self._view_states.pop(key, None)
            # The scan view = fresh changes + everything still owed from
            # builds whose apply never completed; it becomes the new
            # debt until ack_dirty.
            all_dirty = fresh_all or self._pending_all
            dirty = fresh | self._pending
            self._pending_all = all_dirty
            self._pending = set() if all_dirty else set(dirty)

            state = ClusterUpgradeState()
            state_label = util.get_upgrade_state_label_key()
            if self._order is None:
                self._compute_order()
            # The desired-vs-found parity check runs EVERY build (the
            # full rebuild raises every cycle while a DS has unscheduled
            # pods); counts ride the order cache — they only move when
            # it does.
            for _, ds in self._sorted_daemon_sets():
                desired = (ds.get("status") or {}).get(
                    "desiredNumberScheduled", 0
                )
                found = self._order_counts.get(ds["metadata"]["uid"], 0)
                if int(desired) != found:
                    raise UpgradeStateError(
                        f"driver DaemonSet {ds['metadata']['name']} should "
                        f"not have unscheduled pods (desired {desired}, "
                        f"found {found})"
                    )

            for key in self._order:
                pod = self._pods[key]
                node_name = (pod.get("spec") or {}).get("nodeName", "")
                if (
                    not node_name
                    and (pod.get("status") or {}).get("phase") == "Pending"
                ):
                    logger.info(
                        "driver pod %s has no node assigned, skipping",
                        pod["metadata"]["name"],
                    )
                    continue
                node_state = self._view_states.get(key)
                if node_state is None:
                    node_state = self._materialize(key, pod, node_name)
                bucket = (
                    (node_state.node.get("metadata") or {}).get("labels")
                    or {}
                ).get(state_label, consts.UPGRADE_STATE_UNKNOWN)
                state.node_states.setdefault(bucket, []).append(node_state)
            return state, (None if all_dirty else dirty)

    def _sorted_daemon_sets(self):
        """(uid, DS) pairs in (namespace, name) order — the iteration
        order of the full build's name-sorted DaemonSet list."""
        return sorted(
            self._daemon_sets.items(),
            key=lambda kv: (
                (kv[1].get("metadata") or {}).get("namespace", ""),
                (kv[1].get("metadata") or {}).get("name", ""),
            ),
        )

    def _compute_order(self) -> None:
        """Rebuild the deterministic assembly order: each DaemonSet's
        owned pods name-sorted (DSs themselves name-sorted), orphaned
        pods last — exactly the full build's ``filtered`` sequence."""
        pod_keys = sorted(self._pods)
        order: List[PodKey] = []
        counts: Dict[str, int] = {}
        for uid, ds in self._sorted_daemon_sets():
            owned = [k for k in pod_keys if is_owned_by(self._pods[k], ds)]
            counts[uid] = len(owned)
            order.extend(owned)
        order.extend(
            k for k in pod_keys if not owner_references(self._pods[k])
        )
        self._order = order
        self._order_counts = counts

    def _materialize(
        self, key: PodKey, pod: JsonObj, node_name: str
    ) -> NodeUpgradeState:
        """Copy a pod's NodeUpgradeState out of the pristine store.
        Pods of one node share ONE node dict and pods of one DaemonSet
        share ONE DS dict, exactly like the full build's snapshot — the
        provider's in-place mutations must stay coherent across a
        node's entries within a pass."""
        from .upgrade_state import UpgradeStateError  # late: avoids cycle

        node = self._view_nodes.get(node_name)
        if node is None:
            pristine = self._nodes.get(node_name)
            if pristine is None:
                raise UpgradeStateError(
                    f"node {node_name} for driver pod "
                    f"{pod['metadata']['name']} not found"
                )
            node = json_copy(pristine)
            self._view_nodes[node_name] = node
        owner_ds = None
        refs = owner_references(pod)
        if refs:
            uid = refs[0].get("uid")
            owner_ds = self._view_ds.get(uid)
            if owner_ds is None and uid in self._daemon_sets:
                owner_ds = json_copy(self._daemon_sets[uid])
                self._view_ds[uid] = owner_ds
        node_state = NodeUpgradeState(
            node=node, driver_pod=json_copy(pod), driver_daemonset=owner_ds
        )
        if self.requestor is not None and hasattr(
            self.requestor, "attach_node_maintenance"
        ):
            self.requestor.attach_node_maintenance(node_state)
        self._view_states[key] = node_state
        return node_state
