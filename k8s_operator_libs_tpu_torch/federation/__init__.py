"""Multi-cluster federation: fleet-of-fleets waves.

One coordinator, N unchanged per-cluster managers.  The
:class:`FederationCoordinator` treats whole clusters as admission
domains — cell-based rollout order (canary cluster → region → global)
reusing the canary/soak/analysis machinery at cluster granularity, a
cross-cluster failure-budget rollup feeding a **global breaker**, and a
merged audit plane (per-cluster persisted decision Events merged by the
timestamp-first/seq-tiebreak rule into one global trail).

Everything speaks the backend-agnostic ``ClusterClient`` protocol: a
cell may be an in-memory store, a real apiserver behind
``KubeApiClient``, or anything else that serves the protocol.
"""

from .coordinator import (
    Cell,
    FederationCoordinator,
    cell_census,
    explain_cell,
    federation_report_from_clusters,
    render_federation_report,
)

__all__ = [
    "Cell",
    "FederationCoordinator",
    "cell_census",
    "explain_cell",
    "federation_report_from_clusters",
    "render_federation_report",
]
