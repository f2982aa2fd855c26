"""State, label and annotation vocabulary for the upgrade state machine.

Reference parity: ``pkg/upgrade/consts.go:20-93`` — 13 node upgrade states and
8 label/annotation key formats parameterized by the managed component name
(the reference parameterizes by driver name, e.g.
``nvidia.com/gpu-driver-upgrade-state``).  This is the GPU-fleet
vocabulary: the ``nvidia.com`` domain, parameterized by *component*
(default ``gpu-driver``, so the state label is the reference's
``nvidia.com/gpu-driver-upgrade-state``).

Two additions on top of the reference vocabulary:

* ``PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT`` — the checkpoint-on-drain
  handshake key (inverse of the reference's safe-driver-load handshake,
  ``pkg/upgrade/safe_driver_load_manager.go:51-71``).
* ``SLICE_ID_LABEL_KEYS`` — node labels from which the slice/failure-domain
  identity (on a GPU fleet, the NVLink domain) is derived for the
  slice-aware throttle.
"""

from __future__ import annotations

# --------------------------------------------------------------------------
# Node upgrade states — reference: pkg/upgrade/consts.go:48-83.
# Processed by ApplyState in the order listed below.
# --------------------------------------------------------------------------

#: Node has no state label yet (never seen by the state machine).
UPGRADE_STATE_UNKNOWN = ""
#: Driver/runtime pod on the node is in sync with the latest DaemonSet revision.
UPGRADE_STATE_DONE = "upgrade-done"
#: Node needs an upgrade (pod out of sync, or upgrade requested explicitly).
UPGRADE_STATE_UPGRADE_REQUIRED = "upgrade-required"
#: Node was granted an upgrade slot; it must be cordoned next.
UPGRADE_STATE_CORDON_REQUIRED = "cordon-required"
#: Node is cordoned; waiting for user jobs to finish (WaitForCompletionSpec).
UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
#: Workload pods matching the consumer's filter must be deleted.
UPGRADE_STATE_POD_DELETION_REQUIRED = "pod-deletion-required"
#: Node must be drained (full kubectl-drain semantics).
UPGRADE_STATE_DRAIN_REQUIRED = "drain-required"
#: Driver/runtime pod must be restarted to pick up the new revision.
UPGRADE_STATE_POD_RESTART_REQUIRED = "pod-restart-required"
#: Post-upgrade validation pods must become Running+Ready.
UPGRADE_STATE_VALIDATION_REQUIRED = "validation-required"
#: Node must be uncordoned to finish the upgrade.
UPGRADE_STATE_UNCORDON_REQUIRED = "uncordon-required"
#: Upgrade failed (drain error, restart storm, validation timeout).
UPGRADE_STATE_FAILED = "upgrade-failed"
#: (requestor mode) NodeMaintenance CR created; external operator is working.
UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED = "node-maintenance-required"
#: (requestor mode) declared but not yet wired in the reference either —
#: requestor transitions straight node-maintenance-required →
#: pod-restart-required (reference notes the future rename at
#: upgrade_state.go:249-250; consts.go:70).
UPGRADE_STATE_POST_MAINTENANCE_REQUIRED = "post-maintenance-required"

#: Every known state value (including the empty "unknown" state).
ALL_STATES = (
    UPGRADE_STATE_UNKNOWN,
    UPGRADE_STATE_DONE,
    UPGRADE_STATE_UPGRADE_REQUIRED,
    UPGRADE_STATE_CORDON_REQUIRED,
    UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
    UPGRADE_STATE_POD_DELETION_REQUIRED,
    UPGRADE_STATE_DRAIN_REQUIRED,
    UPGRADE_STATE_POD_RESTART_REQUIRED,
    UPGRADE_STATE_VALIDATION_REQUIRED,
    UPGRADE_STATE_UNCORDON_REQUIRED,
    UPGRADE_STATE_FAILED,
    UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
    UPGRADE_STATE_POST_MAINTENANCE_REQUIRED,
)

#: States that count as "upgrade in progress" for the throttle census.
#: Reference: pkg/upgrade/common_manager.go (GetUpgradesInProgress counts nodes
#: in any active state bucket).
ACTIVE_STATES = (
    UPGRADE_STATE_CORDON_REQUIRED,
    UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
    UPGRADE_STATE_POD_DELETION_REQUIRED,
    UPGRADE_STATE_DRAIN_REQUIRED,
    UPGRADE_STATE_POD_RESTART_REQUIRED,
    UPGRADE_STATE_VALIDATION_REQUIRED,
    UPGRADE_STATE_UNCORDON_REQUIRED,
    UPGRADE_STATE_FAILED,
    UPGRADE_STATE_NODE_MAINTENANCE_REQUIRED,
    UPGRADE_STATE_POST_MAINTENANCE_REQUIRED,
)

# --------------------------------------------------------------------------
# Label / annotation key formats — reference: pkg/upgrade/consts.go:20-47.
# All are parameterized by the managed component name via util.key builders.
# --------------------------------------------------------------------------

DOMAIN = "nvidia.com"

#: Node label carrying the state-machine state.
#: Reference fmt: "nvidia.com/%s-driver-upgrade-state" (consts.go:21).
UPGRADE_STATE_LABEL_KEY_FMT = DOMAIN + "/%s-upgrade-state"

#: Node label that opts a node out of managed upgrades entirely.
UPGRADE_SKIP_NODE_LABEL_KEY_FMT = DOMAIN + "/%s-upgrade.skip"

#: Node annotation set by the driver pod's init container to request the
#: safe-load handshake (block runtime start until node is quiesced).
#: Reference: "nvidia.com/%s-driver-upgrade.driver-wait-for-safe-load".
UPGRADE_WAIT_FOR_SAFE_LOAD_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.wait-for-safe-load"
)

#: Node annotation through which a user forces an upgrade cycle.
UPGRADE_REQUESTED_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.requested"

#: Node annotation recording that the node was already unschedulable before
#: the upgrade began — such nodes skip the final uncordon
#: (reference: common_manager.go:250-264, 540-565).
UPGRADE_INITIAL_STATE_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.node-initial-state.unschedulable"
)

#: Node annotation holding the wall-clock start of the wait-for-completion
#: phase, for timeout tracking (reference: pod_manager.go:331-368).
UPGRADE_WAIT_FOR_POD_COMPLETION_START_TIME_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.wait-for-pod-completion-start-time"
)

#: Node annotation holding the wall-clock start of the validation phase,
#: for timeout tracking (reference: validation_manager.go:139-175).
UPGRADE_VALIDATION_START_TIME_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.validation-start-time"
)

#: Node annotation stamping when the node was admitted to upgrade
#: (drives the max-nodes-per-hour pacing gate; see upgrade/schedule.py).
UPGRADE_ADMITTED_AT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.admitted-at"

#: Node annotation stamping when the node last reached upgrade-done
#: (drives the canarySoakSeconds bake gate; written by the state
#: provider in the SAME patch as the done label so the stamp can never
#: be lost between two writes).  Never cleared — like admitted-at, a
#: stale stamp from a previous rollout generation is harmless because
#: the canary census only reads stamps of nodes currently in the done
#: bucket.
UPGRADE_DONE_AT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.done-at"

#: Node annotation marking the admission as a throttle BYPASS (manually
#: cordoned node, or straggler of an already-active domain).  Bypass
#: admissions carry the admitted-at stamp — the canary census must see
#: them, or the blast radius could exceed canaryDomains — but are exempt
#: from hourly pacing (their domain is already disrupted), which this
#: marker records.  Cleared when the node is later admitted normally.
UPGRADE_ADMITTED_BYPASS_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.admitted-bypass"
)

#: Node annotation marking the host's slice domain as quarantined
#: because a domain member has a degraded accelerator (value = the
#: domain id); maintained by the health manager.
UPGRADE_QUARANTINE_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.quarantine"

#: Node annotation marking that this node's upgrade is being handled in
#: requestor (maintenance-operator) mode (reference: util.go:134-138).
UPGRADE_REQUESTOR_MODE_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.requestor-mode"

# ---- remediation engine (upgrade/remediation.py) --------------------------

#: DaemonSet annotation recording the last-known-good ControllerRevision
#: hash plus the currently observed target hash (JSON).  Written by the
#: RemediationManager the first time a new target revision is observed;
#: the recorded pre-rollout hash is what autoRollback reverts to.
UPGRADE_LAST_KNOWN_GOOD_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.last-known-good"
)

#: DaemonSet annotation holding the failure-budget breaker record
#: (JSON: state, target, trippedAt, failures/attempted, reason).
#: Present = the breaker tripped for the recorded target; it stops
#: blocking as soon as the observed target hash moves off that revision
#: (rollback landed, or a fixed revision was published).
UPGRADE_BREAKER_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.remediation-breaker"
)

#: Node annotation counting upgrade attempts that ended in
#: upgrade-failed — the substrate of the per-node retry budget.
#: Cleared when the node completes an upgrade (or self-heals).
UPGRADE_ATTEMPT_COUNT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.attempt-count"

#: Node annotation stamping when the current failure episode was first
#: observed (unix seconds).  Present = episode open; drives the
#: exponential retry backoff.  Cleared on self-heal and on retry.
UPGRADE_LAST_FAILURE_AT_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.last-failure-at"
)

#: Node annotation recording the DS target revision hash the failure
#: episode happened against — the breaker census only charges failures
#: to the CURRENT target, so a rolled-back revision's wreckage cannot
#: re-trip the breaker against the fixed one.
UPGRADE_FAILURE_TARGET_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.failure-target"
)

#: Node taint applied when the retry budget quarantines a node
#: (effect NoSchedule); removed when the quarantine is released.
UPGRADE_QUARANTINE_TAINT_KEY_FMT = DOMAIN + "/%s-upgrade.quarantined"

#: Node annotation carrying the flight recorder's timeline CHECKPOINT
#: (compact JSON: current phase + recent closed intervals).  Written by
#: the state provider in the SAME patch as every state-label change, so
#: per-node phase timelines survive operator crash / HA failover the
#: way remediation state does — the next leader reloads them from the
#: node objects already in its snapshot (see upgrade/timeline.py).
UPGRADE_TIMELINE_ANNOTATION_KEY_FMT = DOMAIN + "/%s-upgrade.timeline"

#: DaemonSet annotation (on the AUDIT cell's driver DaemonSet) holding
#: the federation coordinator's record (JSON: per-cell phase +
#: admitted/completed/promoted stamps + the global-breaker record) —
#: cell-wave progress survives coordinator restarts exactly like the
#: per-cluster breaker record survives operator restarts (see
#: federation/coordinator.py).
UPGRADE_FEDERATION_RECORD_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-upgrade.federation-record"
)

#: Value prefix marking a quarantine annotation as REMEDIATION-owned
#: (retry budget exhausted) rather than health-owned; the
#: SliceHealthManager only lifts health-owned quarantines.
REMEDIATION_QUARANTINE_PREFIX = "remediation:"

# ---- additions to the reference vocabulary --------------------------------

#: Node annotation used for the checkpoint-on-drain handshake.  The
#: orchestrator sets it to "requested" before draining; the training
#: workload on the node saves a checkpoint and sets it to "done"; the drain
#: manager proceeds once it reads "done" (or after a timeout).
PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-pre-drain-checkpoint"

#: Values of the pre-drain-checkpoint annotation.
PRE_DRAIN_CHECKPOINT_REQUESTED = "requested"
PRE_DRAIN_CHECKPOINT_DONE = "done"

#: Sibling annotation carrying the orchestrator's W3C ``traceparent``
#: across the handshake, so the workload's checkpoint save appears as a
#: child span of the drain that requested it (set/cleared together with
#: the checkpoint annotation; a separate key keeps the request/ack
#: token protocol untouched).
PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT = (
    DOMAIN + "/%s-pre-drain-traceparent"
)

#: Node labels (checked in order) from which the slice identity is derived.
#: Hosts sharing a value form one atomic unavailability domain.  The second
#: is GPU Feature Discovery's NVLink-domain label (one clique = one NVLink
#: fabric).  There is no counterpart of a topology-label fallback: GPU
#: Feature Discovery publishes no label that names a multi-host domain
#: by its shape.
SLICE_ID_LABEL_KEYS = (
    DOMAIN + "/slice-id",
    DOMAIN + "/gpu.clique",
)

#: Node labels (checked in order) identifying a **multislice job group** —
#: several NVLink domains coupled over the data-center network into one
#: SPMD job.  Disrupting any member domain kills the whole job, so a group
#: label outranks the slice label as the atomic unavailability domain.
MULTISLICE_GROUP_LABEL_KEYS = (DOMAIN + "/multislice-group",)

#: Annotation value for "true" booleans (reference uses "true" strings).
TRUE_STRING = "true"

#: Value that deletes an annotation via ChangeNodeUpgradeAnnotation —
#: reference uses a literal "null" sentinel turned into a JSON merge-patch
#: null (node_upgrade_state_provider.go:147-151).
NULL_STRING = "null"
