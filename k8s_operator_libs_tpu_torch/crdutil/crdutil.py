"""CRD lifecycle helper — apply/delete CustomResourceDefinitions from YAML.

Reference parity: ``pkg/crdutil/crdutil.go`` —

* recursive directory walk picking up ``.yaml``/``.yml`` only
  (crdutil.go:126-154);
* multi-document YAML parsing that skips non-CRD documents
  (crdutil.go:172-211);
* apply = create-or-update with ResourceVersion copy under a
  RetryOnConflict loop (crdutil.go:214-249);
* idempotent delete (NotFound tolerated, crdutil.go:252-272);
* post-apply readiness wait polling the discovery surface until every
  group/version/plural is served — 100 ms poll, 10 s timeout
  (crdutil.go:275-319).

Motivation carried over from the reference (pkg/crdutil/README.md:8-15):
Helm does not upgrade or delete CRDs after initial install, so operators
ship a hook binary that drives this module instead.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Tuple

from ..cluster.errors import NotFoundError
from ..cluster.client import ClusterClient
from ..cluster.retry import retry_on_conflict

CRD_KIND = "CustomResourceDefinition"

#: Operations accepted by process_crds (reference CRDOperation, crdutil.go:44-51).
OPERATION_APPLY = "apply"
OPERATION_DELETE = "delete"

DEFAULT_READY_TIMEOUT_SECONDS = 10.0
DEFAULT_READY_POLL_SECONDS = 0.1


class CRDProcessingError(Exception):
    pass


@dataclass
class CRDProcessorConfig:
    """Knobs for :func:`process_crds_with_config` (reference
    ProcessCRDsWithConfig, crdutil.go:72-121)."""

    paths: List[str] = field(default_factory=list)
    operation: str = OPERATION_APPLY
    ready_timeout_seconds: float = DEFAULT_READY_TIMEOUT_SECONDS
    ready_poll_seconds: float = DEFAULT_READY_POLL_SECONDS
    #: Skip the post-apply readiness wait.
    skip_ready_wait: bool = False


# ---------------------------------------------------------------- file walk


def walk_crd_paths(paths: Iterable[str]) -> List[str]:
    """Expand files/dirs into a sorted list of YAML file paths.

    Reference: walkCRDPaths (crdutil.go:126-154) — directories are walked
    recursively; only ``.yaml``/``.yml`` files are considered; a path that
    does not exist is an error.
    """
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
        elif os.path.isdir(path):
            # Deterministic within a directory tree, but caller-supplied
            # path order is preserved (a later argument's files never jump
            # ahead of an earlier one's).
            for root, dirs, files in os.walk(path):
                dirs.sort()
                for fname in sorted(files):
                    if fname.endswith((".yaml", ".yml")):
                        out.append(os.path.join(root, fname))
        else:
            raise CRDProcessingError(f"path does not exist: {path}")
    return out


def parse_crds_from_file(path: str) -> List[Dict[str, Any]]:
    """Parse all CRD documents out of one (possibly multi-doc) YAML file.

    Reference: parseCRDsFromFile (crdutil.go:172-211) — non-CRD documents
    and empty documents are skipped, not errors.  PyYAML is imported
    here, not with the module, so the package imports without it.
    """
    import yaml

    with open(path, "r", encoding="utf-8") as fh:
        try:
            docs = list(yaml.safe_load_all(fh))
        except yaml.YAMLError as err:
            raise CRDProcessingError(f"{path}: invalid YAML: {err}") from err
    crds = []
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        if doc.get("kind") != CRD_KIND:
            continue
        if not ((doc.get("metadata") or {}).get("name")):
            raise CRDProcessingError(f"{path}: CRD document missing metadata.name")
        crds.append(doc)
    return crds


def parse_crds_from_paths(paths: Iterable[str]) -> List[Dict[str, Any]]:
    crds: List[Dict[str, Any]] = []
    for f in walk_crd_paths(paths):
        crds.extend(parse_crds_from_file(f))
    return crds


# ----------------------------------------------------------------- apply path


def apply_crd(cluster: ClusterClient, crd: Dict[str, Any]) -> Dict[str, Any]:
    """Create the CRD, or update it in place copying the live
    ResourceVersion, retrying on conflict.

    Reference: applyCRDs (crdutil.go:214-249).
    """
    name = crd["metadata"]["name"]

    def attempt() -> Dict[str, Any]:
        try:
            existing = cluster.get(CRD_KIND, name)
        except NotFoundError:
            return cluster.create(crd)
        desired = dict(crd)
        desired_meta = dict(desired.get("metadata") or {})
        desired_meta["resourceVersion"] = existing["metadata"]["resourceVersion"]
        desired["metadata"] = desired_meta
        # status is server-managed: drop any client-supplied status (e.g. a
        # YAML exported with `kubectl get -o yaml`) and keep the live one, so
        # an update never un-establishes a served CRD.
        desired.pop("status", None)
        if "status" in existing:
            desired["status"] = existing["status"]
        return cluster.update(desired)

    return retry_on_conflict(attempt)


def delete_crd(cluster: ClusterClient, crd: Dict[str, Any]) -> bool:
    """Idempotent delete; returns True if the CRD existed.

    Reference: deleteCRDs (crdutil.go:252-272).
    """
    try:
        cluster.delete(CRD_KIND, crd["metadata"]["name"])
        return True
    except NotFoundError:
        return False


# -------------------------------------------------------------- ready wait


def crd_served_tuples(crd: Dict[str, Any]) -> List[Tuple[str, str, str]]:
    """(group, version, plural) tuples a CRD is expected to serve."""
    spec = crd.get("spec") or {}
    group = spec.get("group", "")
    plural = (spec.get("names") or {}).get("plural", "")
    return [
        (group, v.get("name", ""), plural)
        for v in spec.get("versions") or []
        if v.get("served", True)
    ]


def discovery(cluster: ClusterClient) -> List[Tuple[str, str, str]]:
    """The discovery surface: every (group, version, plural) currently
    served, i.e. belonging to an Established CRD.

    The in-memory apiserver establishes CRDs asynchronously (see
    ``ClusterClient`` creation hooks in tests) just like a real
    apiserver, which is what makes this wait meaningful.
    """
    served: List[Tuple[str, str, str]] = []
    for crd in cluster.list(CRD_KIND):
        conds = (crd.get("status") or {}).get("conditions") or []
        established = any(
            c.get("type") == "Established" and c.get("status") == "True"
            for c in conds
        )
        if established:
            served.extend(crd_served_tuples(crd))
    return served


def wait_for_crds(
    cluster: ClusterClient,
    crds: List[Dict[str, Any]],
    timeout_seconds: float = DEFAULT_READY_TIMEOUT_SECONDS,
    poll_seconds: float = DEFAULT_READY_POLL_SECONDS,
) -> None:
    """Poll discovery until every applied CRD is served (reference:
    waitForCRDs, crdutil.go:275-319 — 100 ms poll, 10 s timeout)."""
    want = {t for crd in crds for t in crd_served_tuples(crd)}
    deadline = time.monotonic() + timeout_seconds
    while True:
        have = set(discovery(cluster))
        missing = want - have
        if not missing:
            return
        if time.monotonic() >= deadline:
            raise CRDProcessingError(
                f"timed out waiting for CRDs to be served; missing: {sorted(missing)}"
            )
        time.sleep(poll_seconds)


# -------------------------------------------------------------- entrypoints


def process_crds_with_config(
    cluster: ClusterClient, config: CRDProcessorConfig
) -> List[Dict[str, Any]]:
    """Apply or delete every CRD found under ``config.paths``.

    Returns the parsed CRDs that were processed.  Reference:
    ProcessCRDsWithConfig (crdutil.go:72-121).
    """
    if config.operation not in (OPERATION_APPLY, OPERATION_DELETE):
        raise CRDProcessingError(f"unknown operation {config.operation!r}")
    crds = parse_crds_from_paths(config.paths)
    if config.operation == OPERATION_APPLY:
        for crd in crds:
            apply_crd(cluster, crd)
        if not config.skip_ready_wait:
            wait_for_crds(
                cluster,
                crds,
                timeout_seconds=config.ready_timeout_seconds,
                poll_seconds=config.ready_poll_seconds,
            )
    else:
        for crd in crds:
            delete_crd(cluster, crd)
    return crds


def process_crds(
    cluster: ClusterClient, operation: str, *paths: str
) -> List[Dict[str, Any]]:
    """Convenience wrapper (reference: ProcessCRDs, crdutil.go:56-67)."""
    return process_crds_with_config(
        cluster, CRDProcessorConfig(paths=list(paths), operation=operation)
    )
