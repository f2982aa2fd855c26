"""Slice health — degraded-domain detection and upgrade quarantine.

The reference's only health signal is binary node readiness feeding the
unavailability census (common_manager.go:146-165): a sick node consumes
maxUnavailable budget and new admissions pause.  GPU fleets have a
richer failure mode the census can't express: a host whose kubelet is
Ready but whose **GPU is degraded** (NVLink flapping, uncorrectable ECC
errors, thermal throttling) — surfaced by node-problem-detector or a
health exporter as node conditions or labels.  Starting a rolling upgrade on such a slice adds
churn to a domain that needs repair, and the post-upgrade validation
will fail anyway.

This module supplies:

* :func:`node_is_degraded` — condition/label based health predicate
  (condition types and label keys configurable via module constants,
  matching how :mod:`.topology` exposes its slice label keys);
* :func:`degraded_domains` — the slice domains with ≥1 degraded host;
* :class:`SliceHealthManager` — an operator-embeddable reconciler that
  stamps a quarantine annotation on every host of a degraded domain
  (and clears it on recovery), emits transition events, and publishes a
  ``degraded_domains`` gauge;
* admission integration — with
  :attr:`~..api.upgrade_spec.UpgradePolicySpec.quarantine_degraded` set,
  the in-place scheduler refuses to START upgrading a degraded domain
  (domains already mid-upgrade finish: blocking them mid-flight would
  strand them half-upgraded, the worse outcome).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Set

from .. import metrics
from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..upgrade import util
from ..upgrade.util import EventRecorder, log_event
from . import topology

logger = logging.getLogger(__name__)

#: Node condition types that mark the host's GPU as degraded when their
#: status is "True" (node-problem-detector style).
DEGRADED_CONDITION_TYPES = (
    "GpuDegraded",
    "NVLinkDown",
    "AcceleratorUnhealthy",
)

#: Node labels that mark degradation when their value is "true".
DEGRADED_LABEL_KEYS = (
    "nvidia.com/degraded",
    "nvidia.com/gpu.degraded",
)


def node_is_degraded(node: JsonObj) -> bool:
    """True when any degraded condition is "True" or a degraded label is
    set — independent of kubelet readiness (a degraded GPU host usually
    still reports Ready)."""
    for cond in ((node.get("status") or {}).get("conditions") or []):
        if (
            cond.get("type") in DEGRADED_CONDITION_TYPES
            and cond.get("status") == "True"
        ):
            return True
    labels = (node.get("metadata") or {}).get("labels") or {}
    return any(labels.get(k) == "true" for k in DEGRADED_LABEL_KEYS)


def degraded_domains(nodes: Iterable[JsonObj]) -> Set[str]:
    """Domains with at least one degraded host.  One bad host degrades
    the whole NVLink domain — SPMD work on it is already broken."""
    out: Set[str] = set()
    for node in nodes:
        if node_is_degraded(node):
            out.add(topology.domain_of(node))
    return out


class SliceHealthManager:
    """Watches fleet health and maintains the quarantine annotation.

    ``reconcile()`` is idempotent and cheap (one node list); call it from
    the operator's reconcile loop or a periodic resync.  The annotation
    (:func:`~..upgrade.util.get_quarantine_annotation_key`) marks every
    host of a degraded domain so external tooling — and this library's
    own admission path — can see the quarantine without re-deriving it.
    """

    def __init__(
        self,
        cluster: ClusterClient,
        recorder: Optional[EventRecorder] = None,
    ) -> None:
        self._cluster = cluster
        self._recorder = recorder

    def reconcile(self) -> Set[str]:
        """Returns the currently degraded domains after stamping/clearing
        quarantine annotations."""
        key = util.get_quarantine_annotation_key()
        nodes = self._cluster.list("Node")
        bad_domains = degraded_domains(nodes)
        by_domain: Dict[str, List[JsonObj]] = topology.group_by_domain(nodes)
        from ..upgrade import consts as upgrade_consts

        for domain, members in by_domain.items():
            quarantined = domain in bad_domains
            for node in members:
                annotations = (node.get("metadata") or {}).get("annotations") or {}
                # Health-owned quarantines carry a bare domain id;
                # remediation-owned ones (retry budget exhausted, see
                # upgrade/remediation.py) are prefixed and must survive a
                # clean health probe — the node fails UPGRADES, not
                # health, and only the remediation release path may lift
                # them.  A health-owned value is managed regardless of
                # WHICH domain it names: after a re-slicing the stale
                # value must still be lifted/re-stamped, not orphaned.
                value = annotations.get(key)
                remediation_owned = (value or "").startswith(
                    upgrade_consts.REMEDIATION_QUARANTINE_PREFIX
                )
                if remediation_owned:
                    continue
                if quarantined and value != domain:
                    self._cluster.patch(
                        "Node",
                        node["metadata"]["name"],
                        {"metadata": {"annotations": {key: domain}}},
                    )
                    log_event(
                        self._recorder,
                        node["metadata"]["name"],
                        "Warning",
                        util.get_event_reason(),
                        f"Quarantined: domain {domain} has a degraded GPU host",
                    )
                elif not quarantined and value is not None:
                    self._cluster.patch(
                        "Node",
                        node["metadata"]["name"],
                        {"metadata": {"annotations": {key: None}}},
                    )
                    log_event(
                        self._recorder,
                        node["metadata"]["name"],
                        "Normal",
                        util.get_event_reason(),
                        f"Quarantine lifted: domain {domain} is healthy",
                    )
        metrics.default_registry().gauge(
            "degraded_domains",
            "Slice domains with at least one degraded GPU host.",
        ).set(len(bad_domains))
        return bad_domains
