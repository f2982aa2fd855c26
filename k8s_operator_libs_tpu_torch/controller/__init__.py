"""Controller runtime: rate-limited workqueue + watch-driven reconcile
loop (the controller-runtime analog the reference assumes upstream)."""

from .controller import (
    Controller,
    Reconciler,
    Request,
    Result,
)
from .ha import DEFAULT_LOCK_NAME, HaOperator
from .leader_election import LeaderElector
from .ops_server import OpsServer
from .upgrade_reconciler import (
    POLICY_KIND,
    UPGRADE_REQUEST,
    CrPolicySource,
    UpgradeReconciler,
    new_upgrade_controller,
)
from .wakeup import WakeupSource
from .workqueue import (
    ExponentialBackoffRateLimiter,
    RateLimitedQueue,
    ShutDown,
    WorkQueue,
)

__all__ = [
    "Controller",
    "DEFAULT_LOCK_NAME",
    "HaOperator",
    "LeaderElector",
    "OpsServer",
    "Reconciler",
    "Request",
    "Result",
    "UPGRADE_REQUEST",
    "POLICY_KIND",
    "CrPolicySource",
    "UpgradeReconciler",
    "new_upgrade_controller",
    "ExponentialBackoffRateLimiter",
    "RateLimitedQueue",
    "ShutDown",
    "WakeupSource",
    "WorkQueue",
]
