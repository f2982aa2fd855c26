"""CordonManager — set/unset ``node.spec.unschedulable``.

Reference parity: ``pkg/upgrade/cordon_manager.go:33-56`` — a thin wrapper
over ``drain.RunCordonOrUncordon``; no-ops when the node is already in the
desired schedulability state.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..cluster.client import ClusterClient
from ..cluster.inmem import JsonObj
from ..cluster.objects import name_of, node_is_unschedulable
from ..obs import tracing
from . import util
from .util import EventRecorder, log_event

logger = logging.getLogger(__name__)


class CordonManager:
    def __init__(
        self,
        cluster: ClusterClient,
        recorder: Optional[EventRecorder] = None,
        provider=None,
    ) -> None:
        self._cluster = cluster
        self._recorder = recorder
        #: Optional NodeUpgradeStateProvider: when its write pipeline is
        #: active on this thread, cordon patches ride it and coalesce
        #: with the node's state-label patch into one round trip
        #: (provider.submit_node_patch).  Absent/inactive → the
        #: reference's synchronous patch below.
        self._provider = provider

    def cordon(self, node: JsonObj) -> None:
        self._set_unschedulable(node, True)

    def uncordon(self, node: JsonObj) -> None:
        self._set_unschedulable(node, False)

    def _set_unschedulable(self, node: JsonObj, desired: bool) -> None:
        if node_is_unschedulable(node) == desired:
            return
        name = name_of(node)
        patch = {"spec": {"unschedulable": desired}}
        with tracing.start_span(
            "cordon" if desired else "uncordon", attributes={"node": name}
        ):
            submit = getattr(self._provider, "submit_node_patch", None)
            if submit is None or not submit(name, patch):
                self._cluster.patch("Node", name, patch)
        node.setdefault("spec", {})["unschedulable"] = desired
        log_event(
            self._recorder,
            name,
            "Normal",
            util.get_event_reason(),
            "Node cordoned" if desired else "Node uncordoned",
        )
