"""ClusterClient — the client surface every manager types against.

The reference's managers take a ``client.Client`` interface from
controller-runtime and never know whether it is backed by a live
apiserver, an envtest apiserver, or a fake (go.mod:11-16;
upgrade_state.go:65-92 injects it).  This module makes the same seam
explicit for this library:

* :class:`ClusterClient` — a :class:`~typing.Protocol` capturing the
  exact call surface the upgrade managers, crdutil, informer cache and
  controller runtime use.  :class:`~.inmem.InMemoryCluster` satisfies it
  natively (the envtest analog); :class:`~.kubeclient.KubeApiClient`
  satisfies it over real apiserver HTTP (the production path).
* :class:`KindInfo` + :data:`KIND_REGISTRY` — the kind → REST route
  mapping (group/version/plural/namespaced) shared by the HTTP client
  and the test apiserver facade, covering every kind this library
  touches plus :func:`register_kind` for consumer CRDs.

Errors: implementations raise the :mod:`~.errors` hierarchy
(NotFoundError, ConflictError, AlreadyExistsError, TooManyRequestsError,
ExpiredError, BadRequestError) so manager retry logic is backend-
agnostic — the HTTP client maps apiserver Status reasons onto the same
classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

JsonObj = Dict[str, Any]
Key = Tuple[str, str, str]  # (kind, namespace, name)


@runtime_checkable
class ClusterClient(Protocol):
    """Everything a manager may ask of a cluster backend.

    Read calls return deep copies (mutating a result never mutates
    backend state — client-go's cache-copy discipline); write calls
    enforce optimistic concurrency on ``metadata.resourceVersion`` when
    the caller sends one.
    """

    # ------------------------------------------------------------- writes
    def create(self, obj: JsonObj) -> JsonObj: ...

    def update(self, obj: JsonObj) -> JsonObj: ...

    def update_status(self, obj: JsonObj) -> JsonObj: ...

    def patch(
        self,
        kind: str,
        name: str,
        patch_body: JsonObj,
        namespace: str = "",
        patch_type: str = "merge",
    ) -> JsonObj: ...

    def delete(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        grace_period_seconds: Optional[int] = None,
    ) -> None: ...

    def evict(
        self,
        name: str,
        namespace: str = "",
        grace_period_seconds: Optional[int] = None,
    ) -> None: ...

    # -------------------------------------------------------------- reads
    def get(self, kind: str, name: str, namespace: str = "") -> JsonObj: ...

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: str = "",
        field_filter: Optional[Callable[[JsonObj], bool]] = None,
        field_selector: str = "",
    ) -> List[JsonObj]: ...

    def exists(self, kind: str, name: str, namespace: str = "") -> bool: ...

    # -------------------------------------------------------------- watch
    def journal_seq(self) -> int: ...

    def events_since(
        self, seq: int, kind: "Optional[str | Tuple[str, ...]]" = None
    ) -> list: ...

    # ------------------------------------------------------------ informer
    def snapshot(
        self, kinds: "Optional[Tuple[str, ...]]" = None
    ) -> Dict[Key, JsonObj]:
        """Point-in-time deep copy of (a registered-kind view of) the
        cluster, keyed (kind, namespace, name) — the InformerCache seed.
        *kinds* restricts the dump (None = every registered kind)."""
        ...

    def wait_for_seq(self, seq: int, timeout: float = 1.0) -> int:
        """Block (≤ *timeout*) until the version sequence advances past
        *seq*; returns the current head.  Event-driven on the in-mem
        backend (condition variable), coarse polling over HTTP — waiters
        in the drain/eviction paths use it instead of busy loops."""
        ...


@dataclass(frozen=True)
class KindInfo:
    """REST routing data for one kind (the discovery-API analog)."""

    kind: str
    group: str  # "" = the core group
    version: str
    plural: str
    namespaced: bool

    @property
    def api_prefix(self) -> str:
        if self.group:
            return f"/apis/{self.group}/{self.version}"
        return f"/api/{self.version}"

    def path(self, namespace: str = "", name: str = "") -> str:
        """Collection or object path for this kind."""
        parts = [self.api_prefix]
        if self.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(self.plural)
        if name:
            parts.append(name)
        return "/".join(parts)


#: Every kind this library touches.  Consumers add their own CRs via
#: :func:`register_kind` (the reference gets this from the typed
#: clientset / scheme registration).
KIND_REGISTRY: Dict[str, KindInfo] = {}


def register_kind(
    kind: str, group: str, version: str, plural: str, namespaced: bool
) -> KindInfo:
    info = KindInfo(kind, group, version, plural, namespaced)
    KIND_REGISTRY[kind] = info
    return info


register_kind("Node", "", "v1", "nodes", namespaced=False)
register_kind("Pod", "", "v1", "pods", namespaced=True)
register_kind("Event", "", "v1", "events", namespaced=True)
register_kind("Namespace", "", "v1", "namespaces", namespaced=False)
register_kind("DaemonSet", "apps", "v1", "daemonsets", namespaced=True)
register_kind(
    "ControllerRevision", "apps", "v1", "controllerrevisions", namespaced=True
)
register_kind(
    "PodDisruptionBudget", "policy", "v1", "poddisruptionbudgets", namespaced=True
)
register_kind("Lease", "coordination.k8s.io", "v1", "leases", namespaced=True)
register_kind(
    "CustomResourceDefinition",
    "apiextensions.k8s.io",
    "v1",
    "customresourcedefinitions",
    namespaced=False,
)
register_kind(
    "NodeMaintenance",
    "maintenance.nvidia.com",
    "v1alpha1",
    "nodemaintenances",
    namespaced=True,
)
register_kind(
    "GpuUpgradePolicy",
    "nvidia.com",
    "v1alpha1",
    "gpuupgradepolicies",
    namespaced=True,
)


def kind_info(kind: str) -> KindInfo:
    try:
        return KIND_REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"kind {kind!r} is not registered; call "
            f"cluster.client.register_kind(...) for consumer CRDs"
        ) from None


def route_for_path(path: str) -> Optional[Tuple[KindInfo, str, str, str]]:
    """Resolve an apiserver URL path to (kind_info, namespace, name,
    subresource).  Returns None for paths outside the registry — shared
    by the test apiserver facade."""
    parts = [p for p in path.split("/") if p]
    # /api/v1/... or /apis/<group>/<version>/...
    if not parts:
        return None
    if parts[0] == "api" and len(parts) >= 2:
        group, version, rest = "", parts[1], parts[2:]
    elif parts[0] == "apis" and len(parts) >= 3:
        group, version, rest = parts[1], parts[2], parts[3:]
    else:
        return None
    if not rest:
        return None  # version root (/api/v1, /apis/<g>/<v>) — discovery
    namespace = ""
    # "namespaces/<ns>" is a namespace PREFIX only when a resource
    # follows; /api/v1/namespaces[/<name>] is the Namespace resource
    # itself.
    if rest[0] == "namespaces" and len(rest) >= 3:
        namespace, rest = rest[1], rest[2:]
    plural, rest = rest[0], rest[1:]
    name = rest[0] if rest else ""
    subresource = rest[1] if len(rest) > 1 else ""
    for info in KIND_REGISTRY.values():
        if (
            info.plural == plural
            and info.group == group
            and info.version == version
        ):
            return (info, namespace, name, subresource)
    return None
