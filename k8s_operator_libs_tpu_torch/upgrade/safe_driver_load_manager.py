"""SafeDriverLoadManager — boot-time safety handshake.

Reference parity: ``pkg/upgrade/safe_driver_load_manager.go`` (C9) and the
two-step protocol documented at ``docs/automatic-ofed-upgrade.md:43-66``:
the driver pod's init container sets a "wait for safe load" annotation on
its Node and blocks; the state machine detects the annotation (:51-53),
forces the node through the full cordon/drain flow, then unblocks loading
by deleting the annotation (:57-71).

On TPU fleets the same handshake covers runtime/libtpu restarts: the new
runtime must not grab the TPU chips until every SPMD workload process on
the slice has been drained.

TPU-native extension — **slice-coherent mode** (``slice_coherent=True``,
enabled via
:meth:`..upgrade_state.ClusterUpgradeStateManager.with_slice_coherent_safe_load`):
the reference unblocks each node independently, which on a multi-host
slice lets host A initialize its runtime (and the ICI fabric) while host
B is still running the *old* revision — a torn slice that SPMD workloads
experience as a mixed-version fabric.  In slice-coherent mode the state
machine holds every waiting host of a slice domain at the barrier until
**all** of the domain's driver pods are at the target DaemonSet revision,
then releases them together (see
:meth:`..common_manager.CommonUpgradeManager.get_slice_load_blocked_domains`).
Coherent mode REQUIRES ``slice_aware`` throttling (``apply_state``
rejects the combination otherwise): domain co-scheduling admits all
hosts of a slice in the same wave, so the barrier resolves within the
wave; under node-granular throttling a barrier-held host would pin the
throttle slot its unsynced peer needs, deadlocking the rollout.
"""

from __future__ import annotations

from ..cluster.inmem import JsonObj
from . import consts, util
from .node_upgrade_state_provider import NodeUpgradeStateProvider


class SafeDriverLoadManager:
    def __init__(
        self,
        provider: NodeUpgradeStateProvider,
        slice_coherent: bool = False,
    ) -> None:
        self._provider = provider
        #: When True, release a slice's safe-load barriers only once every
        #: host of the slice has its driver pod at the target revision.
        self.slice_coherent = slice_coherent

    def is_waiting_for_safe_driver_load(self, node: JsonObj) -> bool:
        """True when the safe-load annotation is present and non-empty
        (reference: IsWaitingForSafeDriverLoad, :51-53)."""
        annotations = (node.get("metadata") or {}).get("annotations") or {}
        return bool(annotations.get(util.get_wait_for_safe_load_annotation_key()))

    def unblock_loading(self, node: JsonObj) -> None:
        """Remove the safe-load annotation, releasing the blocked init
        container (reference: UnblockLoading, :57-71).  No-op when the
        annotation is absent."""
        if not self.is_waiting_for_safe_driver_load(node):
            return
        self._provider.change_node_upgrade_annotation(
            node,
            util.get_wait_for_safe_load_annotation_key(),
            consts.NULL_STRING,
        )
