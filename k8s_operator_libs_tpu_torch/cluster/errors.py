"""API error taxonomy mirroring the subset of k8s.io/apimachinery errors
the reference handles: NotFound (checked before create/delete —
crdutil.go:214-272, upgrade_requestor.go:420-432), AlreadyExists, and
Conflict (optimistic-lock retry — crdutil.go:230-249,
upgrade_requestor.go:344-357)."""

from __future__ import annotations


class ApiError(Exception):
    """Base class for apiserver-style errors."""

    code = 500

    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.__class__.__name__)


class NotFoundError(ApiError):
    code = 404


class AlreadyExistsError(ApiError):
    code = 409


class ConflictError(ApiError):
    """ResourceVersion mismatch on update/patch (optimistic concurrency)."""

    code = 409


class BadRequestError(ApiError):
    code = 400


class UnauthorizedError(ApiError):
    """401 from the apiserver.  With an exec credential plugin configured
    the client forces one refresh + retry before surfacing this (the
    client-go exec authenticator's 401 path)."""

    code = 401


class ExpiredError(ApiError):
    """Watch window expired (the 410 Gone / ResourceExpired analog) — the
    caller must relist instead of resuming from its old sequence number."""

    code = 410


class InvalidError(ApiError):
    """422 Unprocessable Entity — the object failed the CRD's OpenAPI
    structural-schema validation at admission (apimachinery reason
    ``Invalid``).  The envtest substrate the reference tests against
    produces these for free (upgrade_suit_test.go:87-93); the in-mem
    apiserver raises them once the relevant CRD is applied."""

    code = 422


class TooManyRequestsError(ApiError):
    """Eviction blocked by a PodDisruptionBudget (the 429 the Eviction
    subresource returns when disruptionsAllowed is 0) — the caller
    retries, as kubectl drain does."""

    code = 429


def is_not_found(err: Exception) -> bool:
    """Reference: apierrors.IsNotFound."""
    return isinstance(err, NotFoundError)


def is_conflict(err: Exception) -> bool:
    """Reference: apierrors.IsConflict (used by RetryOnConflict loops)."""
    return isinstance(err, ConflictError)


def is_already_exists(err: Exception) -> bool:
    return isinstance(err, AlreadyExistsError)


def is_too_many_requests(err: Exception) -> bool:
    """The kubectl drain retry predicate for PDB-blocked evictions."""
    return isinstance(err, TooManyRequestsError)
