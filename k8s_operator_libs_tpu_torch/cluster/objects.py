"""Accessor/constructor helpers for the JSON-dict object model.

These are the library-side counterparts of the reference's typed corev1
structs; tests additionally have builder fixtures (the analog of
``upgrade_suit_test.go:216-428``).  All helpers are nil-safe on missing
``metadata``/``labels``/``annotations`` maps.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

JsonObj = Dict[str, Any]

# ----------------------------------------------------------------- accessors


def name_of(obj: JsonObj) -> str:
    return (obj.get("metadata") or {}).get("name", "")


def namespace_of(obj: JsonObj) -> str:
    return (obj.get("metadata") or {}).get("namespace", "")


def uid_of(obj: JsonObj) -> str:
    return (obj.get("metadata") or {}).get("uid", "")


def labels_of(obj: JsonObj) -> Dict[str, str]:
    return (obj.get("metadata") or {}).get("labels") or {}


def annotations_of(obj: JsonObj) -> Dict[str, str]:
    return (obj.get("metadata") or {}).get("annotations") or {}


def get_label(obj: JsonObj, key: str, default: str = "") -> str:
    return labels_of(obj).get(key, default)


def get_annotation(obj: JsonObj, key: str, default: str = "") -> str:
    return annotations_of(obj).get(key, default)


def set_label(obj: JsonObj, key: str, value: str) -> None:
    obj.setdefault("metadata", {}).setdefault("labels", {})[key] = value


def set_annotation(obj: JsonObj, key: str, value: str) -> None:
    obj.setdefault("metadata", {}).setdefault("annotations", {})[key] = value


def owner_references(obj: JsonObj) -> List[JsonObj]:
    return (obj.get("metadata") or {}).get("ownerReferences") or []


def is_owned_by(obj: JsonObj, owner: JsonObj) -> bool:
    """Ownership check by uid (reference: pod→DaemonSet filter,
    upgrade_state.go:126-133)."""
    ouid = uid_of(owner)
    return any(ref.get("uid") == ouid for ref in owner_references(obj))


# -------------------------------------------------------------------- nodes


def node_is_unschedulable(node: JsonObj) -> bool:
    return bool((node.get("spec") or {}).get("unschedulable", False))


def node_is_ready(node: JsonObj) -> bool:
    """Ready condition check (reference unavailability census,
    common_manager.go:146-165)."""
    for cond in (node.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


# --------------------------------------------------------------------- pods


def pod_phase(pod: JsonObj) -> str:
    return (pod.get("status") or {}).get("phase", "")


def pod_node_name(pod: JsonObj) -> str:
    return (pod.get("spec") or {}).get("nodeName", "")


def pod_is_ready(pod: JsonObj) -> bool:
    """Running phase + Ready condition True (reference:
    validation_manager.go:118-136)."""
    if pod_phase(pod) != "Running":
        return False
    for cond in (pod.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def pod_restart_count(pod: JsonObj) -> int:
    """Max container restart count (reference failure detection:
    common_manager.go:636-648 sums/inspects container statuses)."""
    statuses = (pod.get("status") or {}).get("containerStatuses") or []
    return max((int(s.get("restartCount", 0)) for s in statuses), default=0)


def pod_uses_empty_dir(pod: JsonObj) -> bool:
    for vol in (pod.get("spec") or {}).get("volumes") or []:
        if "emptyDir" in vol:
            return True
    return False


def pod_has_controller(pod: JsonObj) -> bool:
    """True if any ownerReference has controller=true (kubectl drain's
    standalone-pod check)."""
    return any(ref.get("controller") for ref in owner_references(pod))


def pod_is_daemonset_managed(pod: JsonObj) -> bool:
    return any(ref.get("kind") == "DaemonSet" for ref in owner_references(pod))


CONTROLLER_REVISION_HASH_LABEL = "controller-revision-hash"


def pod_revision_hash(pod: JsonObj) -> str:
    """The DaemonSet revision the pod was created from (reference:
    pod_manager.go:84-118 reads the pod's controller-revision-hash label)."""
    return get_label(pod, CONTROLLER_REVISION_HASH_LABEL)


# ------------------------------------------------------------- constructors


def make_owner_reference(owner: JsonObj, controller: bool = True) -> JsonObj:
    # An owner without a uid gets one assigned *in place* so that every
    # dependent built from the same owner object shares the same identity
    # and is_owned_by() round-trips.
    uid = owner.setdefault("metadata", {}).setdefault("uid", str(uuid.uuid4()))
    return {
        "kind": owner.get("kind"),
        "name": name_of(owner),
        "uid": uid,
        "controller": controller,
    }


def make_node(
    name: str,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    unschedulable: bool = False,
    ready: bool = True,
) -> JsonObj:
    return {
        "kind": "Node",
        "metadata": {
            "name": name,
            "labels": dict(labels or {}),
            "annotations": dict(annotations or {}),
        },
        "spec": {"unschedulable": unschedulable},
        "status": {
            "conditions": [
                {"type": "Ready", "status": "True" if ready else "False"}
            ]
        },
    }


def make_daemonset(
    name: str,
    namespace: str,
    labels: Optional[Dict[str, str]] = None,
    desired_number_scheduled: int = 0,
) -> JsonObj:
    return {
        "kind": "DaemonSet",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": dict(labels or {}),
            "uid": str(uuid.uuid4()),
        },
        "status": {"desiredNumberScheduled": desired_number_scheduled},
    }


def make_controller_revision(
    ds: JsonObj, revision: int, hash_: str
) -> JsonObj:
    """A DaemonSet ControllerRevision; the newest one's hash is the oracle
    the reference compares pod labels against (pod_manager.go:84-118)."""
    return {
        "kind": "ControllerRevision",
        "metadata": {
            "name": f"{name_of(ds)}-{hash_}",
            "namespace": namespace_of(ds),
            "labels": {CONTROLLER_REVISION_HASH_LABEL: hash_},
            "ownerReferences": [make_owner_reference(ds)],
        },
        "revision": revision,
    }


def make_pod(
    name: str,
    namespace: str,
    node_name: str,
    labels: Optional[Dict[str, str]] = None,
    owner: Optional[JsonObj] = None,
    phase: str = "Running",
    ready: bool = True,
    restart_count: int = 0,
    empty_dir: bool = False,
    revision_hash: str = "",
) -> JsonObj:
    labels = dict(labels or {})
    if revision_hash:
        labels[CONTROLLER_REVISION_HASH_LABEL] = revision_hash
    pod: JsonObj = {
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": labels,
            "annotations": {},
        },
        "spec": {"nodeName": node_name, "volumes": []},
        "status": {
            "phase": phase,
            "conditions": [
                {"type": "Ready", "status": "True" if ready else "False"}
            ],
            "containerStatuses": [
                {"name": "main", "restartCount": restart_count, "ready": ready}
            ],
        },
    }
    if owner is not None:
        pod["metadata"]["ownerReferences"] = [make_owner_reference(owner)]
    if empty_dir:
        pod["spec"]["volumes"].append({"name": "scratch", "emptyDir": {}})
    return pod


def make_node_maintenance(
    name: str,
    namespace: str,
    requestor_id: str,
    node_name: str,
    spec_extra: Optional[JsonObj] = None,
) -> JsonObj:
    """A NodeMaintenance CR (reference: Mellanox maintenance-operator API,
    consumed by upgrade_requestor.go)."""
    spec: JsonObj = {"requestorID": requestor_id, "nodeName": node_name}
    if spec_extra:
        spec.update(spec_extra)
    return {
        "apiVersion": "maintenance.nvidia.com/v1alpha1",
        "kind": "NodeMaintenance",
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
        "status": {"conditions": []},
    }


def get_condition(obj: JsonObj, cond_type: str) -> Optional[JsonObj]:
    for cond in (obj.get("status") or {}).get("conditions") or []:
        if cond.get("type") == cond_type:
            return cond
    return None


def set_condition(
    obj: JsonObj, cond_type: str, status: str, reason: str = ""
) -> None:
    conds = obj.setdefault("status", {}).setdefault("conditions", [])
    for cond in conds:
        if cond.get("type") == cond_type:
            cond["status"] = status
            cond["reason"] = reason
            cond["lastTransitionTime"] = time.time()
            return
    conds.append(
        {
            "type": cond_type,
            "status": status,
            "reason": reason,
            "lastTransitionTime": time.time(),
        }
    )
