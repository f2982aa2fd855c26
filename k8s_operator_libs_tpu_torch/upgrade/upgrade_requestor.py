"""Requestor mode — delegate node maintenance to an external operator.

Reference parity: ``pkg/upgrade/upgrade_requestor.go`` (C4, C16) — instead
of cordoning/draining itself, the library creates a ``NodeMaintenance`` CR
and lets a cluster-wide maintenance operator do the work:

* ``process_upgrade_required_nodes`` (:277-319): create-or-update the CR,
  annotate the node requestor-mode, → ``node-maintenance-required``;
* the **shared-requestor** protocol (:320-368): when another operator
  already owns the CR (and the default name prefix is in use), append this
  requestor's ID to ``spec.additionalRequestors`` with an
  optimistic-locked merge patch (resourceVersion-guarded) so concurrent
  operators never clobber each other's membership — a Conflict surfaces
  and the next reconcile retries against fresh state;
* ``process_node_maintenance_required_nodes`` (:416-452): a missing CR
  sends the node back to ``upgrade-required``; the CR's Ready condition
  advances it to ``pod-restart-required``;
* ``process_uncordon_required_nodes`` (:454-488): finish requestor-mode
  nodes — → ``upgrade-done``, drop the mode annotation, then delete the
  owned CR or remove self from ``additionalRequestors`` (:370-410);
* watch predicates for consumers (:93-159): requestor-ID membership and
  sorted-conditions change / finalizer-removal deletion;
* env-var configuration (:527-546) and policy → maintenance-spec
  conversion (:497-524) — extended with the TPU pre-drain checkpoint
  gate so the external operator also honours checkpoint-before-drain.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..api.upgrade_spec import UpgradePolicySpec
from ..cluster.errors import AlreadyExistsError, NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj, WatchEvent
from ..cluster.objects import name_of
from ..tpu import topology
from . import consts, schedule, util
from .common_manager import ClusterUpgradeState, CommonUpgradeManager, NodeUpgradeState
from .upgrade_inplace import canary_budget, quarantined_domains

logger = logging.getLogger(__name__)

NODE_MAINTENANCE_KIND = "NodeMaintenance"

#: Reference: DefaultNodeMaintenanceNamePrefix = "nvidia-operator" (:51-52).
DEFAULT_NODE_MAINTENANCE_NAME_PREFIX = "nvidia-operator"

#: Reference: maintenancev1alpha1.ConditionReasonReady.
CONDITION_READY = "Ready"


class NodeMaintenanceUpgradeDisabledError(Exception):
    """Reference: ErrNodeMaintenanceUpgradeDisabled (:56)."""


@dataclass
class RequestorOptions:
    """Reference: RequestorOptions (:68-82)."""

    use_maintenance_operator: bool = False
    requestor_id: str = ""
    #: Namespace in which NodeMaintenance objects are created.
    requestor_namespace: str = "default"
    #: Name prefix: "<prefix>-<node-name>"; the shared-requestor protocol
    #: only engages when every operator uses the default prefix.
    node_maintenance_name_prefix: str = DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
    #: Pod eviction filters forwarded to the maintenance operator when pod
    #: deletion is enabled in the policy.
    pod_eviction_filters: List[JsonObj] = field(default_factory=list)


def get_requestor_opts_from_envs() -> RequestorOptions:
    """Reference: GetRequestorOptsFromEnvs (:527-546)."""
    opts = RequestorOptions()
    if os.environ.get("MAINTENANCE_OPERATOR_ENABLED") == consts.TRUE_STRING:
        opts.use_maintenance_operator = True
    opts.requestor_namespace = (
        os.environ.get("MAINTENANCE_OPERATOR_REQUESTOR_NAMESPACE") or "default"
    )
    opts.requestor_id = os.environ.get("MAINTENANCE_OPERATOR_REQUESTOR_ID", "")
    opts.node_maintenance_name_prefix = (
        os.environ.get("MAINTENANCE_OPERATOR_NODE_MAINTENANCE_PREFIX")
        or DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
    )
    return opts


def convert_policy_to_maintenance_spec(
    policy: Optional[UpgradePolicySpec], opts: RequestorOptions
) -> JsonObj:
    """Policy → NodeMaintenance spec fragment (reference:
    convertV1Alpha1ToMaintenance, :497-524), with the TPU-native
    pre-drain-checkpoint passthrough."""
    if policy is None:
        return {}
    spec: JsonObj = {}
    drain: JsonObj = {}
    if policy.drain_spec is not None:
        drain = {
            "force": policy.drain_spec.force,
            "podSelector": policy.drain_spec.pod_selector,
            "timeoutSeconds": policy.drain_spec.timeout_second,
            "deleteEmptyDir": policy.drain_spec.delete_empty_dir,
        }
    if policy.pod_deletion is not None:
        drain["podEvictionFilters"] = list(opts.pod_eviction_filters)
    if drain:
        spec["drainSpec"] = drain
    if policy.wait_for_completion is not None:
        spec["waitForPodCompletion"] = {
            "podSelector": policy.wait_for_completion.pod_selector,
            "timeoutSeconds": policy.wait_for_completion.timeout_second,
        }
    if policy.pre_drain_checkpoint is not None:
        spec["preDrainCheckpoint"] = policy.pre_drain_checkpoint.to_dict()
    return spec


class RequestorNodeStateManager:
    """The maintenance-operator handoff strategy (ProcessNodeStateManager)."""

    def __init__(
        self,
        common: CommonUpgradeManager,
        opts: RequestorOptions,
        post_maintenance_hook=None,
    ) -> None:
        if not opts.use_maintenance_operator:
            raise NodeMaintenanceUpgradeDisabledError(
                "node maintenance upgrade mode is disabled"
            )
        self._common = common
        self._cluster: ClusterClient = common._cluster
        self.opts = opts
        self._default_spec: JsonObj = {}
        #: Optional ``hook(node) -> bool`` run in the post-maintenance
        #: state.  The reference *declares* post-maintenance-required
        #: (consts.go:70) but never enters it — the requestor jumps
        #: straight to pod-restart-required with a tracked intent to route through
        #: it (upgrade_state.go:249-250, upgrade_requestor.go:437-448).
        #: Here that intent is finished: with a hook installed, maintenance
        #: completion transitions to post-maintenance-required, and the
        #: hook gates the driver-pod restart — the TPU use case being
        #: slice re-admission checks (ICI links healthy, workload
        #: checkpoint gate released) before the runtime restarts.  Returns
        #: True to advance; False — or an exception — parks the node to
        #: retry next reconcile (failing it pre-restart would wedge).
        self.post_maintenance_hook = post_maintenance_hook

    # ------------------------------------------------------------- naming
    def get_node_maintenance_name(self, node_name: str) -> str:
        """Reference: getNodeMaintenanceName (:491-494)."""
        return f"{self.opts.node_maintenance_name_prefix}-{node_name}"

    def set_default_node_maintenance(
        self, policy: Optional[UpgradePolicySpec]
    ) -> None:
        """Reference: SetDefaultNodeMaintenance (:161-174)."""
        self._default_spec = convert_policy_to_maintenance_spec(policy, self.opts)

    def new_node_maintenance(self, node_name: str) -> JsonObj:
        """Reference: NewNodeMaintenance (:176-182).  TPU-native: the node's
        **atomic domain** rides along in ``spec.sliceId`` so a slice-aware
        maintenance operator can co-schedule every host that must go down
        together.  This is ``topology.domain_of`` — a multislice job group
        when labeled (all DCN-coupled slices in one wave; batching per
        individual slice would disrupt the job once per slice), else the
        slice id."""
        from ..cluster.objects import make_node_maintenance
        from ..tpu import topology

        spec_extra = dict(self._default_spec)
        try:
            node = self._cluster.get("Node", node_name)
            domain = topology.domain_of(node)
            if not topology.is_singleton_domain(domain):
                spec_extra["sliceId"] = domain
        except NotFoundError:
            pass
        return make_node_maintenance(
            self.get_node_maintenance_name(node_name),
            self.opts.requestor_namespace,
            self.opts.requestor_id,
            node_name,
            spec_extra=spec_extra,
        )

    # ------------------------------------------------------- CR CRUD helpers
    def get_node_maintenance_obj(self, node_name: str) -> Optional[JsonObj]:
        """Reference: GetNodeMaintenanceObj (:203-218) — None when absent."""
        try:
            return self._cluster.get(
                NODE_MAINTENANCE_KIND,
                self.get_node_maintenance_name(node_name),
                self.opts.requestor_namespace,
            )
        except NotFoundError:
            return None

    def attach_node_maintenance(self, node_state: NodeUpgradeState) -> None:
        """BuildState hook: attach the node's CR to its snapshot entry
        (reference: buildNodeUpgradeState requestor branch)."""
        node_state.node_maintenance = self.get_node_maintenance_obj(
            name_of(node_state.node)
        )

    def create_node_maintenance(self, node_state: NodeUpgradeState) -> None:
        """Reference: createNodeMaintenance (:184-200) — AlreadyExists is
        tolerated."""
        nm = self.new_node_maintenance(name_of(node_state.node))
        try:
            node_state.node_maintenance = self._cluster.create(nm)
        except AlreadyExistsError:
            logger.warning(
                "nodeMaintenance %s already exists", nm["metadata"]["name"]
            )
            node_state.node_maintenance = self.get_node_maintenance_obj(
                name_of(node_state.node)
            )

    def create_or_update_node_maintenance(
        self, node_state: NodeUpgradeState
    ) -> None:
        """Create the CR, or join an existing one via the shared-requestor
        optimistic-lock patch (reference: createOrUpdateNodeMaintenance,
        :320-368).  A ConflictError propagates; the caller's next reconcile
        retries with fresh state."""
        nm = node_state.node_maintenance
        shared_prefix = (
            self.opts.node_maintenance_name_prefix
            == DEFAULT_NODE_MAINTENANCE_NAME_PREFIX
        )
        if nm is None:
            self.create_node_maintenance(node_state)
            nm = node_state.node_maintenance
            if nm is None:
                return
            if (nm.get("spec") or {}).get("requestorID") == self.opts.requestor_id:
                return  # we created (or already owned) it
            if not shared_prefix:
                return  # custom prefix: no membership protocol
            # Lost the create race: another operator's CR appeared between
            # our snapshot and the create.  Fall through and JOIN it —
            # adopting without membership would let the owner delete the
            # CR out from under us mid-flow (recoverable via the
            # missing-CR path, but a needless restart of the admission).
        elif not shared_prefix:
            self.create_node_maintenance(node_state)
            return
        spec = nm.get("spec") or {}
        if spec.get("requestorID") == self.opts.requestor_id:
            return  # already owned by us
        additional = list(spec.get("additionalRequestors") or [])
        if self.opts.requestor_id in additional:
            return  # already a member
        additional.append(self.opts.requestor_id)
        # Optimistic lock: the patch carries the resourceVersion we read;
        # a concurrent writer makes this raise ConflictError (:344-357).
        self._cluster.patch(
            NODE_MAINTENANCE_KIND,
            nm["metadata"]["name"],
            {
                "metadata": {"resourceVersion": nm["metadata"]["resourceVersion"]},
                "spec": {"additionalRequestors": additional},
            },
            nm["metadata"].get("namespace", ""),
        )

    def delete_node_maintenance(self, node_state: NodeUpgradeState) -> None:
        """Reference: deleteNodeMaintenance (:221-247) — skip when already
        terminating; NotFound tolerated."""
        if node_state.node_maintenance is None:
            raise ValueError(
                f"missing nodeMaintenance for node {name_of(node_state.node)}"
            )
        name = self.get_node_maintenance_name(name_of(node_state.node))
        try:
            nm = self._cluster.get(
                NODE_MAINTENANCE_KIND, name, self.opts.requestor_namespace
            )
        except NotFoundError:
            return
        if nm["metadata"].get("deletionTimestamp"):
            return
        self._cluster.delete(
            NODE_MAINTENANCE_KIND, name, self.opts.requestor_namespace
        )

    def delete_or_update_node_maintenance(
        self, node_state: NodeUpgradeState
    ) -> None:
        """Delete the owned CR, or remove self from additionalRequestors
        with the optimistic-lock patch (reference:
        deleteOrUpdateNodeMaintenance, :370-410)."""
        nm = node_state.node_maintenance
        if nm is None:
            return
        # Re-fetch for a fresh resourceVersion — the snapshot copy may be
        # stale if the maintenance operator touched the CR mid-reconcile,
        # which would make the rv-guarded patch below conflict spuriously.
        fresh = self.get_node_maintenance_obj(name_of(node_state.node))
        if fresh is None:
            # CR vanished since the snapshot — no membership left to clean.
            node_state.node_maintenance = None
            return
        nm = node_state.node_maintenance = fresh
        spec = nm.get("spec") or {}
        if spec.get("requestorID") == self.opts.requestor_id:
            self.delete_node_maintenance(node_state)
            return
        additional = list(spec.get("additionalRequestors") or [])
        if self.opts.requestor_id not in additional:
            return
        additional.remove(self.opts.requestor_id)
        self._cluster.patch(
            NODE_MAINTENANCE_KIND,
            nm["metadata"]["name"],
            {
                "metadata": {"resourceVersion": nm["metadata"]["resourceVersion"]},
                "spec": {"additionalRequestors": additional},
            },
            nm["metadata"].get("namespace", ""),
        )

    # ---------------------------------------------------------- processors
    def process_upgrade_required_nodes(
        self, state: ClusterUpgradeState, policy: UpgradePolicySpec
    ) -> None:
        """Reference: ProcessUpgradeRequiredNodes (:277-319).

        Schedule gates apply before the maintenance handoff too: outside
        the maintenance window no NEW NodeMaintenance CRs are created
        (nodes already handed off continue), hourly pacing caps how
        many nodes may be handed off per pass (upgrade/schedule.py),
        and ``canaryDomains`` caps fresh-UNIT handoffs until the canary
        units all reach done (+soak) — the same blast-radius contract
        as in-place mode; a consumer switching modes must not silently
        lose canary protection.  Units already participating (stamped,
        in flight) keep handing off their remaining member nodes
        without re-charging the budget."""
        common = self._common
        self.set_default_node_maintenance(policy)
        # Canary accounting is mode-independent (admitted-at/done-at
        # stamps + state buckets): ride the same budget as in-place.
        canary_remaining: Optional[int] = None
        participating: set = set()
        if policy.canary_domains > 0:
            canary_remaining, stamped = canary_budget(state, policy)
            participating = set(stamped)
        quarantined = quarantined_domains(state, policy)
        # Quarantine bars STARTING a degraded domain; a domain already
        # mid-handoff still finishes (stranding it half-upgraded is
        # worse) — the in-place `fresh` exemption, same contract.
        active_domains: set = set()
        if quarantined:
            active_domains = {
                topology.domain_of(ns.node)
                for bucket, nss in state.node_states.items()
                if bucket in consts.ACTIVE_STATES
                for ns in nss
            }
        # The window gates only the NodeMaintenance HANDOFF — the
        # upgrade-requested annotation housekeeping the reference performs
        # in ProcessUpgradeRequiredNodes (:283-296) runs regardless, so a
        # closed window cannot leave the annotation stale until it next
        # opens.
        window_closed = (
            policy.maintenance_window is not None
            and not schedule.window_open(policy.maintenance_window)
        )
        if window_closed:
            logger.info("outside maintenance window; no new maintenance handoffs")
        pacing = schedule.pacing_budget(
            policy, (ns.node for ns in state.all_node_states()), state=state
        )
        for node_state in state.nodes_in(consts.UPGRADE_STATE_UPGRADE_REQUIRED):
            node = node_state.node
            if common.is_upgrade_requested(node):
                common.provider.change_node_upgrade_annotation(
                    node,
                    util.get_upgrade_requested_annotation_key(),
                    consts.NULL_STRING,
                )
            if common.skip_node_upgrade(node):
                logger.info("node %s is marked to skip upgrades", name_of(node))
                continue
            if window_closed:
                continue  # housekeeping done; handoff gated by the window
            # Gate checks first, budgets charged only at ADMISSION
            # (in-place parity: a node another gate denies must not
            # spend a budget it never used).
            if quarantined:
                domain = topology.domain_of(node)
                if domain in quarantined and domain not in active_domains:
                    logger.info(
                        "node %s: domain quarantined (degraded GPU) — "
                        "maintenance handoff withheld",
                        name_of(node),
                    )
                    continue
            fresh_unit = None
            if canary_remaining is not None:
                unit = (
                    topology.domain_of(node)
                    if policy.slice_aware
                    else "node:" + name_of(node)
                )
                if unit not in participating:
                    if canary_remaining <= 0:
                        continue  # canary frozen or budget spent
                    fresh_unit = unit
            if pacing is not None:
                if pacing <= 0:
                    continue  # hourly pacing budget spent
                pacing -= 1
            if fresh_unit is not None:
                canary_remaining -= 1
                participating.add(fresh_unit)
            self.create_or_update_node_maintenance(node_state)
            # stamp only after the handoff succeeded: a failed create must
            # not burn an hour of pacing budget for a node never admitted
            schedule.stamp_admission(common.provider, node)
            common.provider.change_node_upgrade_annotation(
                node,
                util.get_upgrade_requestor_mode_annotation_key(),
                consts.TRUE_STRING,
            )
            common.provider.change_node_upgrade_state(
                node, consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
            )
            # the stamp mutated the snapshot's node dict in place: drop
            # the scan memos so later same-snapshot censuses (status /
            # explain) re-derive from the written values
            state.invalidate_census()

    def process_node_maintenance_required_nodes(
        self, state: ClusterUpgradeState
    ) -> None:
        """Reference: ProcessNodeMaintenanceRequiredNodes (:416-452)."""
        common = self._common
        for node_state in state.nodes_in(
            consts.UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED
        ):
            node = node_state.node
            if node_state.node_maintenance is None:
                if not util.is_node_in_requestor_mode(node):
                    logger.warning(
                        "node %s in node-maintenance-required without "
                        "requestor-mode annotation",
                        name_of(node),
                    )
                # CR vanished: restart the upgrade admission for this node.
                common.provider.change_node_upgrade_state(
                    node, consts.UPGRADE_STATE_UPGRADE_REQUIRED
                )
                continue
            conditions = (
                (node_state.node_maintenance.get("status") or {}).get("conditions")
                or []
            )
            # Only Reason == Ready signals completion (reference :439-441);
            # status True with an in-progress/failed reason must not advance.
            ready = any(
                c.get("type") == CONDITION_READY
                and c.get("reason") == CONDITION_READY
                for c in conditions
            )
            if ready:
                next_state = (
                    consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
                    if self.post_maintenance_hook is not None
                    else consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                )
                common.provider.change_node_upgrade_state(node, next_state)

    def process_post_maintenance_required_nodes(
        self, state: ClusterUpgradeState
    ) -> None:
        """Gate the driver-pod restart on the post-maintenance hook.

        Completes the reference's declared-but-unreached state (consts.go:70;
        intent noted at upgrade_state.go:249-250).  Hook semantics: True advances to
        pod-restart-required; False — or an exception — leaves the node
        parked for the next reconcile.  An exception must NOT fail the node:
        at this point the driver pod is still at the old revision, so the
        upgrade-failed self-heal (which waits for the pod to come back in
        sync) could never fire and the node would wedge; transient probe
        errors retry instead, surfaced via log + event.  Without a hook this
        state is passed through immediately, so resumed fleets whose labels
        already carry it never wedge."""
        common = self._common
        for node_state in state.nodes_in(
            consts.UPGRADE_STATE_POST_MAINTENANCE_REQUIRED
        ):
            node = node_state.node
            if self.post_maintenance_hook is None:
                common.provider.change_node_upgrade_state(
                    node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                )
                continue
            try:
                done = bool(self.post_maintenance_hook(node))
            except Exception as exc:
                logger.exception(
                    "post-maintenance hook failed for node %s (will retry)",
                    name_of(node),
                )
                util.log_event(
                    common.recorder,
                    name_of(node),
                    "Warning",
                    util.get_event_reason(),
                    f"Post-maintenance hook error (will retry): {exc}",
                )
                continue
            if done:
                common.provider.change_node_upgrade_state(
                    node, consts.UPGRADE_STATE_POD_RESTART_REQUIRED
                )

    def process_uncordon_required_nodes(self, state: ClusterUpgradeState) -> None:
        """Reference: ProcessUncordonRequiredNodes (:454-488)."""
        common = self._common
        for node_state in state.nodes_in(consts.UPGRADE_STATE_UNCORDON_REQUIRED):
            node = node_state.node
            if not util.is_node_in_requestor_mode(node):
                continue  # in-place flow finishes this node
            # CR cleanup runs FIRST (deviation from the reference's order,
            # :462-485): if the rv-guarded membership patch conflicts, the
            # node stays in uncordon-required and the next reconcile
            # retries — finalizing the node first would leak this
            # requestor's additionalRequestors membership forever, since no
            # later state revisits it.
            self.delete_or_update_node_maintenance(node_state)
            common.provider.change_node_upgrade_state(
                node, consts.UPGRADE_STATE_DONE
            )
            common.provider.change_node_upgrade_annotation(
                node,
                util.get_upgrade_requestor_mode_annotation_key(),
                consts.NULL_STRING,
            )


# ------------------------------------------------------------- predicates


def new_requestor_id_predicate(
    requestor_id: str,
) -> Callable[[JsonObj], bool]:
    """Object-level filter: is this NodeMaintenance owned by or shared with
    *requestor_id*?  (Reference: NewRequestorIDPredicate, :93-103.)"""

    def pred(obj: JsonObj) -> bool:
        if obj.get("kind") != NODE_MAINTENANCE_KIND:
            return False
        spec = obj.get("spec") or {}
        return requestor_id == spec.get("requestorID") or requestor_id in (
            spec.get("additionalRequestors") or []
        )

    return pred


def _sorted_conditions(obj: Optional[JsonObj]) -> List[JsonObj]:
    conds = ((obj or {}).get("status") or {}).get("conditions") or []
    return sorted(conds, key=lambda c: c.get("type", ""))


def condition_changed_predicate(event: WatchEvent) -> bool:
    """Update-event filter: enqueue only when the sorted conditions differ
    or the object lost its finalizers while terminating (reference:
    ConditionChangedPredicate.Update, :115-159)."""
    if event.type != "Modified":
        return False
    old, new = event.old, event.new
    if old is None or new is None:
        return False
    if (new.get("kind") or (old or {}).get("kind")) != NODE_MAINTENANCE_KIND:
        return False
    cond_changed = _sorted_conditions(old) != _sorted_conditions(new)
    old_fin = (old.get("metadata") or {}).get("finalizers") or []
    new_fin = (new.get("metadata") or {}).get("finalizers") or []
    deleting = (
        bool(old_fin)
        and not new_fin
        and bool((new.get("metadata") or {}).get("deletionTimestamp"))
    )
    return cond_changed or deleting
