"""Client plumbing: the in-memory apiserver, the informer cache,
selectors, retry and the batched write pipeline (the analog of
controller-runtime's client, client-go and envtest in the reference).

The HTTP side (an apiserver facade and a full Kubernetes client) is not
here; :mod:`.kubeclient` is a minimal Node client for the drain workers
of a multi-process job.
"""

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
from .inmem import InMemoryCluster, ListPage, WatchEvent, merge_patch
from .strategicmerge import register_merge_key, strategic_merge
from .retry import retry_on_conflict
from .selectors import labels_to_selector, match_label_selector, matches, parse_selector

__all__ = [
    "ClusterClient",
    "KindInfo",
    "KIND_REGISTRY",
    "kind_info",
    "register_kind",
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
]
