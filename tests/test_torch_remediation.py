"""The port's RemediationSpec (k8s_operator_libs_tpu_torch/api/
upgrade_spec.py), which its remediation engine (upgrade/remediation.py)
reads.

``tests/test_remediation.py::TestRemediationSpec``, as cases of the same
name, runs on the port.  The file's other classes reconcile through
``ClusterUpgradeStateManager`` and wait for its port;
``remediation_report`` over a rollout's snapshot, with retry and
quarantine annotations, is held to the JAX package's in
``tests/test_torch_rollout_parity.py``.
"""

import pytest

from k8s_operator_libs_tpu_torch.api import RemediationSpec, UpgradePolicySpec, ValidationError

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")


class TestRemediationSpec:
    def test_round_trip_camel_case(self):
        spec = RemediationSpec(
            failure_threshold=0.1,
            min_attempted=5,
            window_seconds=600.0,
            auto_rollback=True,
            max_node_attempts=2,
            backoff_seconds=30.0,
            backoff_max_seconds=900.0,
        )
        d = spec.to_dict()
        assert d["failureThreshold"] == 0.1
        assert d["autoRollback"] is True
        assert d["maxNodeAttempts"] == 2
        assert RemediationSpec.from_dict(d) == spec

    def test_policy_round_trip_carries_remediation(self):
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            remediation=RemediationSpec(auto_rollback=True),
        )
        policy.validate()
        back = UpgradePolicySpec.from_dict(policy.to_dict())
        assert back.remediation == policy.remediation
        assert UpgradePolicySpec.from_dict({}).remediation is None

    @pytest.mark.parametrize(
        "bad",
        [
            {"failure_threshold": 0.0},
            {"failure_threshold": 1.5},
            {"window_seconds": 0},
            {"min_attempted": -1},
            {"max_node_attempts": -2},
            {"backoff_seconds": -1.0},
            {"auto_rollback": "true"},
        ],
    )
    def test_validation_rejects(self, bad):
        spec = RemediationSpec(**bad)
        with pytest.raises(ValidationError):
            spec.validate()

    def test_policy_validates_embedded_spec(self):
        policy = UpgradePolicySpec(
            auto_upgrade=True,
            remediation=RemediationSpec(failure_threshold=2.0),
        )
        with pytest.raises(ValidationError):
            policy.validate()
