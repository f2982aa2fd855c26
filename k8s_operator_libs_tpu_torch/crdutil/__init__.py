"""CRD lifecycle utilities (reference: pkg/crdutil)."""

from .crdutil import (
    CRD_KIND,
    CRDProcessingError,
    CRDProcessorConfig,
    OPERATION_APPLY,
    OPERATION_DELETE,
    apply_crd,
    crd_served_tuples,
    delete_crd,
    discovery,
    parse_crds_from_file,
    parse_crds_from_paths,
    process_crds,
    process_crds_with_config,
    wait_for_crds,
    walk_crd_paths,
)

__all__ = [
    "CRD_KIND",
    "CRDProcessingError",
    "CRDProcessorConfig",
    "OPERATION_APPLY",
    "OPERATION_DELETE",
    "apply_crd",
    "crd_served_tuples",
    "delete_crd",
    "discovery",
    "parse_crds_from_file",
    "parse_crds_from_paths",
    "process_crds",
    "process_crds_with_config",
    "wait_for_crds",
    "walk_crd_paths",
]
