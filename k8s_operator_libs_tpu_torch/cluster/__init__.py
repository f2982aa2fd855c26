"""Client plumbing: the in-memory apiserver and its HTTP facade, the
Kubernetes client, the informer cache, selectors, retry and the batched
write pipeline (the analog of controller-runtime's client, client-go and
envtest in the reference).
"""

from .apiserver import FAULT_KINDS, ApiServerFacade, FaultSpec
from .cache import InformerCache
from .client import KIND_REGISTRY, ClusterClient, KindInfo, kind_info, register_kind
from .errors import (
    AlreadyExistsError,
    ApiError,
    BadRequestError,
    ConflictError,
    ExpiredError,
    InvalidError,
    NotFoundError,
    TooManyRequestsError,
    UnauthorizedError,
    is_already_exists,
    is_conflict,
    is_not_found,
    is_too_many_requests,
)
from .execauth import (
    ExecCredential,
    ExecCredentialError,
    ExecCredentialPlugin,
    ExecPluginSpec,
)
from .inmem import InMemoryCluster, ListPage, WatchEvent, merge_patch
from .strategicmerge import register_merge_key, strategic_merge
from .kubeclient import KubeApiClient, KubeConfig, KubeConfigError
from .retry import retry_on_conflict
from .selectors import labels_to_selector, match_label_selector, matches, parse_selector

__all__ = [
    "ApiServerFacade",
    "FAULT_KINDS",
    "FaultSpec",
    "ClusterClient",
    "KindInfo",
    "KIND_REGISTRY",
    "kind_info",
    "register_kind",
    "KubeApiClient",
    "KubeConfig",
    "KubeConfigError",
    "InformerCache",
    "InMemoryCluster",
    "ListPage",
    "WatchEvent",
    "merge_patch",
    "register_merge_key",
    "strategic_merge",
    "retry_on_conflict",
    "parse_selector",
    "match_label_selector",
    "matches",
    "labels_to_selector",
    "ApiError",
    "ExpiredError",
    "InvalidError",
    "NotFoundError",
    "ConflictError",
    "AlreadyExistsError",
    "BadRequestError",
    "is_not_found",
    "is_conflict",
    "is_already_exists",
    "TooManyRequestsError",
    "is_too_many_requests",
    "UnauthorizedError",
    "ExecCredential",
    "ExecCredentialError",
    "ExecCredentialPlugin",
    "ExecPluginSpec",
]
