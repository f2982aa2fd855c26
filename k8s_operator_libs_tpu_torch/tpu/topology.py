"""NVLink-domain topology — atomic unavailability domains for GPU fleets.

The reference throttle counts *nodes*: ``maxUnavailable`` caps how many
nodes may be cordoned/not-ready at once (common_manager.go:748-776).  In
a rack-scale NVLink domain that unit is wrong: the hosts of one domain
(an NVL72 rack, or the nodes GPU Feature Discovery labels with one
``nvidia.com/gpu.clique``) run one SPMD job over NVLink — draining *one*
host kills the workload on *every* host of the domain.  This module
supplies the domain-level accounting the domain-aware throttle uses
instead:

* a node's **domain** is, in precedence order: its **multislice group**
  (from ``MULTISLICE_GROUP_LABEL_KEYS`` — several NVLink domains coupled
  over the data-center network into one job, where draining any member
  domain kills the whole job), else its domain id (from
  ``SLICE_ID_LABEL_KEYS``: ``nvidia.com/slice-id`` or
  ``nvidia.com/gpu.clique``), else a singleton domain for nodes without
  either label;
* a domain is *unavailable* if **any** of its nodes is cordoned or
  not-ready (the domain can't run SPMD work at partial strength);
* a domain is *in progress* if any of its nodes is in an active upgrade
  state;
* the throttle resolves ``maxUnavailable`` percentages against the domain
  count and spends one slot per **domain**, and the in-place scheduler
  co-schedules all of a domain's nodes together — the slice is down once,
  not N times.

Everything here is pure functions over node dicts; the policy switch is
:attr:`~..api.upgrade_spec.UpgradePolicySpec.slice_aware`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..cluster.inmem import JsonObj
from ..cluster.objects import (
    name_of,
    node_is_ready,
    node_is_unschedulable,
)
from ..upgrade import consts

#: Prefix for the singleton domain of a node with no slice label.
_SINGLETON_PREFIX = "node:"
#: Prefix namespacing multislice-group domains away from slice ids (a
#: group named "a" and an unrelated slice named "a" must not merge).
_GROUP_PREFIX = "msgroup:"


#: Per-policy label-key overrides (managed and bare-metal fleets label
#: domains differently).  Process-global like the component
#: name (util.set_component_name); set by apply_state from the policy's
#: sliceLabelKeys/multisliceLabelKeys each reconcile, empty = built-in
#: defaults.  Tuple assignment is atomic, so concurrent readers always
#: see a consistent key list.
_slice_keys_override: tuple = ()
_multislice_keys_override: tuple = ()


def set_label_keys(
    slice_keys: Iterable[str] = (), multislice_keys: Iterable[str] = ()
) -> None:
    """Override the slice/multislice label keys; empty restores defaults."""
    # A bare string would tuple() into per-character "keys" that match no
    # label, silently collapsing every slice into a singleton domain.
    for name, value in (
        ("slice_keys", slice_keys),
        ("multislice_keys", multislice_keys),
    ):
        if isinstance(value, str):
            raise ValueError(
                f"{name} must be an iterable of label keys, got the "
                f"string {value!r}"
            )
    global _slice_keys_override, _multislice_keys_override
    _slice_keys_override = tuple(slice_keys or ())
    _multislice_keys_override = tuple(multislice_keys or ())


def effective_slice_keys() -> tuple:
    return _slice_keys_override or consts.SLICE_ID_LABEL_KEYS


def effective_multislice_keys() -> tuple:
    return _multislice_keys_override or consts.MULTISLICE_GROUP_LABEL_KEYS


def _first_label(node: JsonObj, keys: Iterable[str]) -> Optional[str]:
    """First truthy label value among *keys*, in precedence order."""
    labels = (node.get("metadata") or {}).get("labels") or {}
    for key in keys:
        value = labels.get(key)
        if value:
            return value
    return None


def slice_id_of(node: JsonObj) -> Optional[str]:
    """The node's slice identity, or None if it carries no slice label."""
    return _first_label(node, effective_slice_keys())


def multislice_group_of(node: JsonObj) -> Optional[str]:
    """The node's multislice job group, or None if it is not part of a
    DCN-coupled multislice job."""
    return _first_label(node, effective_multislice_keys())


def domain_of(node: JsonObj) -> str:
    """The node's atomic unavailability domain: multislice group if
    labeled (the whole DCN-coupled job is one failure domain), else slice
    id, else the node itself."""
    group = multislice_group_of(node)
    if group is not None:
        return _GROUP_PREFIX + group
    sid = slice_id_of(node)
    if sid is not None:
        return sid
    return _SINGLETON_PREFIX + name_of(node)


def is_singleton_domain(domain: str) -> bool:
    return domain.startswith(_SINGLETON_PREFIX)


def group_by_domain(nodes: Iterable[JsonObj]) -> Dict[str, List[JsonObj]]:
    """Bucket nodes into their domains (stable within input order)."""
    out: Dict[str, List[JsonObj]] = {}
    for node in nodes:
        out.setdefault(domain_of(node), []).append(node)
    return out


def node_is_unavailable(node: JsonObj) -> bool:
    """Reference unavailability test: cordoned or not-ready
    (common_manager.go:146-165)."""
    return node_is_unschedulable(node) or not node_is_ready(node)


def count_unavailable_domains(nodes: Iterable[JsonObj]) -> int:
    """Domains with at least one unavailable node."""
    unavailable = set()
    for node in nodes:
        if node_is_unavailable(node):
            unavailable.add(domain_of(node))
    return len(unavailable)


def count_domains(nodes: Iterable[JsonObj]) -> int:
    return len({domain_of(n) for n in nodes})
