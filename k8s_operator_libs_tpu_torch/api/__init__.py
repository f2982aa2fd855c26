"""API types — the CRD-schema fragment (reference: api/upgrade/v1alpha1)."""

from .federation_spec import (
    FederationCellSpec,
    FederationPolicySpec,
    GlobalBreakerSpec,
)
from .intstr import IntOrString
from .upgrade_spec import (
    AdaptivePacingSpec,
    AnalysisCondition,
    AnalysisSpec,
    AnalysisStepSpec,
    MaintenanceWindowSpec,
    DrainSpec,
    PodDeletionSpec,
    PreDrainCheckpointSpec,
    RemediationSpec,
    SloSpec,
    UpgradePolicySpec,
    ValidationError,
    ValidationSpec,
    WaitForCompletionSpec,
    parse_analysis_condition,
)

__all__ = [
    "AdaptivePacingSpec",
    "AnalysisCondition",
    "AnalysisSpec",
    "AnalysisStepSpec",
    "parse_analysis_condition",
    "FederationCellSpec",
    "FederationPolicySpec",
    "GlobalBreakerSpec",
    "MaintenanceWindowSpec",
    "IntOrString",
    "DrainSpec",
    "PodDeletionSpec",
    "PreDrainCheckpointSpec",
    "RemediationSpec",
    "SloSpec",
    "UpgradePolicySpec",
    "ValidationError",
    "ValidationSpec",
    "WaitForCompletionSpec",
]
