"""The consumer glue: an operator reconciler around the upgrade state
machine.

This is the L5 layer the reference leaves to NVIDIA's GPU/Network
Operators (SURVEY.md §1: "calls BuildState/ApplyState each reconcile").
Every watched event collapses onto a **single cluster-scoped request** —
the state machine is already a whole-fleet snapshot/apply, so per-node
requests would only serialize redundant full passes; the workqueue's
dedup-while-processing semantics then guarantee a change arriving
mid-reconcile triggers exactly one follow-up pass.

The reconciler requeues itself while a rollout is active (the "operator
requeue cycle" that picks up async drain/eviction results —
SURVEY.md §3.2) and goes quiet when the fleet is steady.
"""

from __future__ import annotations

import datetime
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Hashable, Iterable, List, Optional

from ..api.upgrade_spec import UpgradePolicySpec, ValidationError
from ..cluster.errors import NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..obs import tracing
from ..upgrade import schedule
from ..upgrade.upgrade_state import ClusterUpgradeStateManager
from .controller import Controller, Result
from .wakeup import WakeupSource

logger = logging.getLogger(__name__)

#: The one request every event maps to.
UPGRADE_REQUEST = "upgrade-cycle"

#: Kind of the policy custom resource (CRD at
#: crd/nvidia.com_gpuupgradepolicies.yaml).
POLICY_KIND = "GpuUpgradePolicy"


def _singleton_mapper(_obj: JsonObj) -> Iterable[Hashable]:
    return [UPGRADE_REQUEST]


@dataclass
class CrPolicySource:
    """Live upgrade policy read from a GpuUpgradePolicy custom resource.

    The reference ships its policy as a CRD *fragment* consumers embed in
    their own CRDs (DriverUpgradePolicySpec, upgrade_spec.go:27-49) and
    re-read every reconcile; this is the standalone equivalent — edit the
    CR and the running operator picks the change up on its next pass (the
    controller also watches the kind, so an edit wakes it immediately).

    Failure behavior: a missing CR **pauses** the rollout (``current()``
    returns None and the reconciler treats it as auto_upgrade=False —
    deleting the policy is the emergency stop); an *invalid* CR keeps the
    **last good** policy and logs, so a bad edit cannot yank throttling
    mid-rollout."""

    cluster: ClusterClient
    name: str
    namespace: str = ""
    _last_good: Optional[UpgradePolicySpec] = field(
        default=None, init=False, repr=False
    )

    def current(self) -> Optional[UpgradePolicySpec]:
        try:
            obj = self.cluster.get(POLICY_KIND, self.name, self.namespace)
        except NotFoundError:
            self._last_good = None
            return None
        try:
            policy = UpgradePolicySpec.from_dict(obj.get("spec") or {})
            policy.validate()
        except (ValidationError, ValueError, TypeError) as err:
            logger.warning(
                "GpuUpgradePolicy %s/%s invalid (%s); keeping last good "
                "policy",
                self.namespace,
                self.name,
                err,
            )
            return self._last_good
        self._last_good = policy
        return policy


@dataclass
class UpgradeReconciler:
    """Runs one BuildState/ApplyState pass per request.

    The policy is either a fixed :class:`UpgradePolicySpec` (``policy``)
    or a live source (``policy_source``, e.g. :class:`CrPolicySource`) —
    the source is re-read every pass, so policy edits apply mid-rollout."""

    manager: ClusterUpgradeStateManager
    namespace: str
    driver_labels: Dict[str, str]
    policy: Optional[UpgradePolicySpec] = None
    policy_source: Optional[object] = None
    #: requeue delay while a rollout is in flight (async workers report
    #: through node labels; this is the pickup latency)
    active_requeue_seconds: float = 0.05
    #: requeue delay when only failed nodes remain — their self-heal waits
    #: on an external fix (new DS revision, manual intervention), so
    #: polling at the active cadence would hot-loop full fleet snapshots
    #: forever; a watch event on the fix wakes us sooner anyway
    failed_requeue_seconds: float = 5.0
    #: requeue delay when work is PENDING but nothing is in flight — the
    #: admissions are gated (canary bake window, closed maintenance
    #: window, exhausted pacing, frozen canary), and nothing the cluster
    #: does will change that before the gate's clock ticks; the active
    #: cadence would burn ~72k full-fleet snapshots through one hour of
    #: canarySoakSeconds doing no work
    gated_requeue_seconds: float = 5.0
    #: Event-driven mode: journal deltas and async worker completions
    #: SCHEDULE reconciles (the controller's watch tee + WakeupSource),
    #: so the requeue delays above stop being the pickup mechanism and
    #: become safety nets — the *_fallback_seconds cadences replace
    #: them, and the gated branch computes the actual gate deadline
    #: (window opening, pacing slot, canary soak expiry) instead of
    #: polling.  Off (the default) preserves the poll-driven cadences
    #: exactly — the reference consumers' behavior.
    event_driven: bool = False
    #: safety-net cadence while work is in flight: async completions
    #: arrive as watch/worker wakeups, this only covers a lost event
    active_fallback_seconds: float = 1.0
    #: safety-net ceiling for the gated branch when no gate deadline is
    #: computable (and the clamp for computed ones — clock-skew guard)
    gated_fallback_seconds: float = 60.0
    #: failed-only fleets wait on an external fix (watch-visible) or a
    #: remediation backoff expiry; this bounds the pickup of the latter
    failed_fallback_seconds: float = 60.0

    def _current_policy(self) -> Optional[UpgradePolicySpec]:
        if self.policy_source is not None:
            return self.policy_source.current()
        return self.policy

    def _cadence(self, fallback: float, requeue: float) -> float:
        """The event-driven demotion rule in one place: fallbacks are
        the safety net when events schedule the passes, the poll
        cadences otherwise."""
        return fallback if self.event_driven else requeue

    #: ceiling for a COMPUTED gate deadline (clock-skew guard: beyond
    #: this we re-check rather than trust a far-future arithmetic)
    MAX_GATE_DEADLINE_SECONDS = 3600.0

    def _gate_deadline_seconds(self, state, policy) -> Optional[float]:
        """Seconds until the earliest KNOWN gate re-opens, or None when
        no gate deadline is computable (unknown gate — e.g. a frozen
        canary waits on node events, not a clock).  Only consulted on
        gated passes in event-driven mode, so the O(fleet) censuses
        below run once per gate transition, not per poll tick."""
        deadlines: List[float] = []
        now = time.time()
        mw = policy.maintenance_window
        if mw is not None and not schedule.window_open(mw):
            nxt = schedule.next_window_open(mw)
            if nxt is not None:
                deadlines.append(
                    (
                        nxt
                        - datetime.datetime.now(datetime.timezone.utc)
                    ).total_seconds()
                )
        limit = policy.max_nodes_per_hour or 0
        if limit > 0:
            slot_at = schedule.next_pacing_slot_at(
                (ns.node for ns in state.all_node_states()),
                limit,
                state=state,
            )
            if slot_at is not None:
                deadlines.append(slot_at - now)
        if policy.canary_domains > 0:
            from ..upgrade.upgrade_inplace import canary_census

            census = canary_census(state, policy)
            if census.soak_until is not None:
                deadlines.append(census.soak_until - now)
        if not deadlines:
            return None
        return min(deadlines)

    def _gated_result(self, state, policy) -> Result:
        deadline = self._gate_deadline_seconds(state, policy)
        if deadline is None:
            return Result(requeue_after=self.gated_fallback_seconds)
        # +50 ms so the gate is actually open when the pass runs;
        # clamped into [0.05, MAX_GATE_DEADLINE] — a far-future window
        # re-checks hourly rather than trusting one clock reading.
        # trigger=deadline: this wakeup is a COMPUTED due time, not the
        # lost-event safety net — the metric must tell them apart.
        return Result(
            requeue_after=max(
                0.05, min(deadline + 0.05, self.MAX_GATE_DEADLINE_SECONDS)
            ),
            requeue_trigger="deadline",
        )

    def reconcile(self, request: Hashable) -> Optional[Result]:
        state = self.manager.build_state(self.namespace, self.driver_labels)
        policy = self._current_policy()
        if policy is None:
            # no (or deleted) policy CR: the rollout is paused — publish
            # gauges from the fresh snapshot and go quiet until a policy
            # event wakes us
            self.manager.apply_state(state, None)
            return None
        self.manager.apply_state(state, policy)
        common = self.manager.common
        # Census onto the controller's Reconcile root span (when one is
        # open): /debug/traces then shows WHY each cycle chose its
        # requeue cadence without cross-referencing the gauges.
        span = tracing.current_span()
        if span is not None:
            span.set_attribute(
                "in_progress", common.get_upgrades_in_progress(state)
            )
            span.set_attribute("pending", common.get_upgrades_pending(state))
            span.set_attribute(
                "transitions", self.manager.last_apply_transitions
            )
        # Failed nodes sit in an active-state bucket (they pin throttle
        # slots — common_manager.go:730-737) but they are NOT in-flight
        # work: nothing completes for them until an external fix or the
        # remediation engine's backoff expires.  Counting them as active
        # made the failed-only branch below unreachable and hot-looped a
        # failed-only fleet at the active cadence — with the remediation
        # retry budget (whose backoffs are minutes) that poll would do
        # ~20 no-op fleet snapshots per second for the whole wait.
        in_flight = common.get_upgrades_in_progress(
            state
        ) - common.get_upgrades_failed(state)
        # Event-driven mode: every requeue below is a SAFETY NET — the
        # watch tee and worker-completion wakeups schedule the real
        # passes, the workqueue keeps only the earliest armed deadline
        # per request, and any real wakeup disarms it.
        if in_flight > 0:
            return Result(
                requeue_after=self._cadence(
                    self.active_fallback_seconds, self.active_requeue_seconds
                )
            )
        if self.manager.last_apply_transitions:
            # The pass just MOVED nodes (e.g. admitted a wave): the
            # pre-transition snapshot still classifies them as pending-
            # with-nothing-in-flight, but work is now in flight — stay on
            # the active cadence.  Watch events usually mask this; a
            # watch-less/poll-only assembly would otherwise pay the gated
            # interval per admission wave.
            return Result(
                requeue_after=self._cadence(
                    self.active_fallback_seconds, self.active_requeue_seconds
                )
            )
        if common.get_upgrades_pending(state):
            # Pending with nothing in flight AND no transitions this
            # pass = gated admissions (canary bake, closed window,
            # exhausted pacing).  Event-driven: requeue AT the computed
            # gate deadline (window opening / pacing slot / soak
            # expiry) instead of polling the gated cadence — a
            # canary-soaking fleet costs zero passes until the bake
            # window ends.
            if self.event_driven:
                return self._gated_result(state, policy)
            return Result(requeue_after=self.gated_requeue_seconds)
        if common.get_upgrades_failed(state):
            return Result(
                requeue_after=self._cadence(
                    self.failed_fallback_seconds, self.failed_requeue_seconds
                )
            )
        return None


def new_upgrade_controller(
    cluster: ClusterClient,
    manager: ClusterUpgradeStateManager,
    namespace: str,
    driver_labels: Dict[str, str],
    policy: Optional[UpgradePolicySpec] = None,
    *,
    policy_source: Optional[object] = None,
    extra_kinds: Iterable[str] = (),
    resync_seconds: float = 1.0,
    active_requeue_seconds: float = 0.05,
    failed_requeue_seconds: float = 5.0,
    gated_requeue_seconds: float = 5.0,
    watch_poll_seconds: float = 0.005,
    feed_cache=None,
    feed_index=None,
    event_driven: bool = True,
    active_fallback_seconds: float = 1.0,
    gated_fallback_seconds: float = 60.0,
    failed_fallback_seconds: float = 60.0,
    idle_wait_seconds: Optional[float] = None,
) -> Controller:
    """Assemble the standard operator: watches on Nodes, driver Pods,
    DaemonSets (and NodeMaintenance when requestor mode needs it via
    *extra_kinds*), all funneled into the singleton upgrade request.

    Pass either a fixed *policy* or a live *policy_source* (e.g.
    :class:`CrPolicySource`); with a source, the policy kind is watched
    too, so CR edits wake the operator immediately.

    *feed_cache*: an ``externally_fed`` :class:`~..cluster.InformerCache`
    to tee every drained watch event into (the single-reflector rule —
    one consumer feeds both cache and workqueue); its kinds are added to
    the controller's watches so their frames flow.

    *feed_index*: a :class:`~..upgrade.ClusterStateIndex` to ride the
    same tee — every drained event batch feeds its snapshot AND its
    dirty-node set (so the next reconcile's BuildState is O(changed)),
    and the 410 relist path triggers its full rebuild.  Its watch kinds
    (ControllerRevision, NodeMaintenance, ...) are added with a
    no-request mapper when not already watched.  Usually this is
    ``manager.state_index`` from a manager built with
    ``use_state_index=True``.

    *event_driven* (default True): journal deltas and async worker
    completions SCHEDULE the reconciles — a :class:`WakeupSource`
    bound to the controller's queue is handed to the manager so
    drain/eviction workers wake the loop the moment they finish, and
    the requeue cadences above are demoted to safety-net fallbacks
    (``*_fallback_seconds``; the gated branch requeues at the computed
    gate deadline).  An idle or fully-gated fleet then performs ~zero
    reconcile passes, at any size.  Pass False to restore the pure
    poll-driven cadences (the reference consumers' behavior)."""
    if (policy is None) == (policy_source is None):
        raise ValueError("pass exactly one of policy / policy_source")
    if policy_source is not None and not callable(
        getattr(policy_source, "current", None)
    ):
        # fail at assembly, not as an AttributeError hot-loop inside the
        # worker thread's per-item retry
        raise TypeError(
            "policy_source must provide current() -> Optional[UpgradePolicySpec]"
        )
    reconciler = UpgradeReconciler(
        manager=manager,
        namespace=namespace,
        driver_labels=driver_labels,
        policy=policy,
        policy_source=policy_source,
        active_requeue_seconds=active_requeue_seconds,
        failed_requeue_seconds=failed_requeue_seconds,
        gated_requeue_seconds=gated_requeue_seconds,
        event_driven=event_driven,
        active_fallback_seconds=active_fallback_seconds,
        gated_fallback_seconds=gated_fallback_seconds,
        failed_fallback_seconds=failed_fallback_seconds,
    )
    event_sinks = []
    relist_sinks = []
    if feed_cache is not None:
        event_sinks.append(feed_cache.ingest)
        relist_sinks.append(feed_cache.sync)
    if feed_index is not None:
        event_sinks.append(feed_index.ingest)
        relist_sinks.append(feed_index.rebuild)
    controller = Controller(
        cluster,
        reconciler,
        name="upgrade-controller",
        resync_seconds=resync_seconds,
        watch_poll_seconds=watch_poll_seconds,
        event_sink=event_sinks or None,
        relist_sink=relist_sinks or None,
        idle_wait_seconds=idle_wait_seconds,
    )
    if event_driven:
        # Async worker completions (drain/eviction label writes, the
        # write pipeline's completion callbacks) signal the SAME queue
        # the watch tee feeds — the pass that picks their results up is
        # scheduled at completion time, not at the next poll tick.
        wakeup = WakeupSource(controller.queue, UPGRADE_REQUEST)
        attach = getattr(manager, "set_wakeup_source", None)
        if attach is not None:
            attach(wakeup)
    kinds = ["Node", "Pod", "DaemonSet", *extra_kinds]
    if policy_source is not None:
        kinds.append(POLICY_KIND)
    # tee'd consumers' kinds must ride the SAME stream: watch them with
    # a no-request mapper so their frames reach the sinks (a kind both
    # reconcile-mapped and sink-consumed is watched once — the sinks see
    # every drained batch regardless of mapper)
    sink_kinds = list((feed_cache.kinds or ()) if feed_cache else ())
    if feed_index is not None:
        sink_kinds.extend(feed_index.WATCH_KINDS)
    null_mapped = [k for k in dict.fromkeys(sink_kinds) if k not in kinds]
    for kind in null_mapped:
        controller.watches(kind, mapper=_null_mapper)
    for kind in kinds:
        controller.watches(kind, mapper=_singleton_mapper)
    return controller


def _null_mapper(_obj) -> tuple:
    """Watch a kind only to feed the cache tee — no reconcile request."""
    return ()
