"""The rolling-upgrade state machine (reference: pkg/upgrade)."""

from . import consts, util
from .common_manager import (
    ClusterUpgradeState,
    CommonUpgradeManager,
    NodeUpgradeState,
)
from .cordon_manager import CordonManager
from .drain_manager import (
    DrainConfiguration,
    DrainError,
    DrainHelper,
    DrainHelperConfig,
    DrainManager,
)
from .node_upgrade_state_provider import (
    CacheSyncTimeoutError,
    NodeUpgradeStateProvider,
)
from .pod_manager import (
    PodDeletionFilter,
    PodManager,
    PodManagerConfig,
    PodManagerError,
)
from .remediation import (
    RemediationDecision,
    RemediationManager,
    remediation_report,
    render_report,
)
from .safe_driver_load_manager import SafeDriverLoadManager
from .state_index import ClusterStateIndex
from .timeline import (
    FlightRecorder,
    default_recorder,
    set_default_recorder,
)
from .upgrade_inplace import InplaceNodeStateManager
from .upgrade_requestor import (
    DEFAULT_NODE_MAINTENANCE_NAME_PREFIX,
    NodeMaintenanceUpgradeDisabledError,
    RequestorNodeStateManager,
    RequestorOptions,
    condition_changed_predicate,
    convert_policy_to_maintenance_spec,
    get_requestor_opts_from_envs,
    new_requestor_id_predicate,
)
from .history import HistoryEntry, node_event_history, render_history
from .plan import PlannedTransition, RolloutPlan, plan_rollout
from .rollout_status import DomainStatus, GateStatus, RolloutStatus
from .upgrade_state import ClusterUpgradeStateManager, UpgradeStateError
from .util import ClusterEventRecorder, EventRecorder, log_event
from .validation_manager import ValidationManager

# after upgrade_state: the chaos campaign engine drives the manager, so
# it must import last to stay cycle-free
from . import chaos  # noqa: E402

__all__ = [
    "consts",
    "util",
    "chaos",
    "ClusterUpgradeState",
    "CommonUpgradeManager",
    "NodeUpgradeState",
    "CordonManager",
    "DrainConfiguration",
    "DrainError",
    "DrainHelper",
    "DrainHelperConfig",
    "DrainManager",
    "CacheSyncTimeoutError",
    "NodeUpgradeStateProvider",
    "PodDeletionFilter",
    "PodManager",
    "PodManagerConfig",
    "PodManagerError",
    "RemediationDecision",
    "RemediationManager",
    "remediation_report",
    "render_report",
    "SafeDriverLoadManager",
    "ClusterStateIndex",
    "FlightRecorder",
    "default_recorder",
    "set_default_recorder",
    "InplaceNodeStateManager",
    "DEFAULT_NODE_MAINTENANCE_NAME_PREFIX",
    "NodeMaintenanceUpgradeDisabledError",
    "RequestorNodeStateManager",
    "RequestorOptions",
    "condition_changed_predicate",
    "convert_policy_to_maintenance_spec",
    "get_requestor_opts_from_envs",
    "new_requestor_id_predicate",
    "ClusterUpgradeStateManager",
    "UpgradeStateError",
    "ClusterEventRecorder",
    "EventRecorder",
    "log_event",
    "ValidationManager",
    "DomainStatus",
    "GateStatus",
    "RolloutStatus",
    "PlannedTransition",
    "RolloutPlan",
    "plan_rollout",
    "HistoryEntry",
    "node_event_history",
    "render_history",
]
