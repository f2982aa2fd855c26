"""The port's structural-schema admission and the algebraic laws of its
patches.

* ``TestStructuralValidation``, ``TestDefaulting``, ``TestSchemaHelpers``
  and ``TestSchemaHelperEdges`` of ``tests/test_schema_admission.py``, as
  cases of the same names, on the port's :class:`InMemoryCluster`.  They
  read the repo's CRD files through :func:`test_torch_vocab.to_port_vocab`,
  so the policy kind is ``GpuUpgradePolicy`` in group ``nvidia.com``.
  ``TestAdmissionLifecycle`` of the same file, which needs the
  controller's policy source, applies the port's own CRD files
  (``k8s_operator_libs_tpu_torch/crd/``, JSON read with ``json.load``).
* The hypothesis laws of ``tests/test_properties.py`` for merge patch,
  ``IntOrString``, strategic merge, copy-out and journal
  reconstruction, on the port's functions.  Each call of a law to
  ``merge_patch``, ``strategic_merge`` or ``IntOrString`` goes through
  :func:`held_to_jax`, which also runs the JAX function on the drawn
  input and asserts the same result or the same error.
* A parity test of admission itself: seeded policy CRs, admitted by the
  port's cluster and by the JAX cluster, give the same stored object or
  the same 422.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

hypothesis = pytest.importorskip(
    "hypothesis", reason="hypothesis not installed in this environment"
)
from hypothesis import given, settings, strategies as st  # noqa: E402

from k8s_operator_libs_tpu.api import IntOrString as JaxIntOrString  # noqa: E402
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster  # noqa: E402
from k8s_operator_libs_tpu.cluster.inmem import merge_patch as jax_merge_patch  # noqa: E402
from k8s_operator_libs_tpu.cluster.strategicmerge import (  # noqa: E402
    strategic_merge as jax_strategic_merge,
)
from k8s_operator_libs_tpu_torch.api import IntOrString as PortIntOrString  # noqa: E402
from k8s_operator_libs_tpu_torch.cluster import (  # noqa: E402
    ApiServerFacade,
    InMemoryCluster,
    InvalidError,
    KubeApiClient,
    KubeConfig,
)
from k8s_operator_libs_tpu_torch.cluster.inmem import (  # noqa: E402
    json_copy,
    merge_patch as port_merge_patch,
)
from k8s_operator_libs_tpu_torch.cluster.strategicmerge import (  # noqa: E402
    strategic_merge as port_strategic_merge,
)
from k8s_operator_libs_tpu_torch.cluster.schema import (
    apply_defaults,
    extract_crd_schema,
    validate,
)

from test_torch_cluster import mask  # noqa: E402
from test_torch_vocab import close_every_client, to_port_vocab  # noqa: E402, F401

ROOT = Path(__file__).resolve().parent.parent

POLICY_CRD = ROOT / "hack/crd/bases/tpu.google.com_tpuupgradepolicies.yaml"
NM_CRD = ROOT / "hack/crd/bases/maintenance.tpu.google.com_nodemaintenances.yaml"


def load_jax_crd(path):
    with open(path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh)


def load_crd(path):
    """The repo's CRD file in the port's vocabulary."""
    return to_port_vocab(load_jax_crd(path))


@pytest.fixture
def store():
    cluster = InMemoryCluster()
    cluster.create(load_crd(POLICY_CRD))
    cluster.create(load_crd(NM_CRD))
    return cluster


def policy_cr(spec, name="p", namespace="d"):
    return {
        "kind": "GpuUpgradePolicy",
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
    }


class TestStructuralValidation:
    def test_wrong_scalar_type_is_422(self, store):
        with pytest.raises(InvalidError) as err:
            store.create(policy_cr({"maxParallelUpgrades": "three"}))
        assert "spec.maxParallelUpgrades" in str(err.value)

    def test_bool_is_not_an_integer(self, store):
        with pytest.raises(InvalidError):
            store.create(policy_cr({"maxParallelUpgrades": True}))

    def test_minimum_violation_is_422(self, store):
        with pytest.raises(InvalidError) as err:
            store.create(policy_cr({"maxNodesPerHour": -5}))
        assert "below minimum" in str(err.value)

    def test_enum_violation_is_422(self, store):
        with pytest.raises(InvalidError) as err:
            store.create(
                policy_cr({"validation": {"onMissingPods": "explode"}})
            )
        assert "not in" in str(err.value)

    def test_pattern_violation_is_422(self, store):
        with pytest.raises(InvalidError):
            store.create(
                policy_cr({"maintenanceWindow": {"start": "9am"}})
            )

    def test_required_fields_enforced(self, store):
        with pytest.raises(InvalidError) as err:
            store.create(
                {
                    "kind": "NodeMaintenance",
                    "metadata": {"name": "m", "namespace": "d"},
                    "spec": {"nodeName": "n1"},
                }
            )
        assert "requestorID" in str(err.value)

    def test_int_or_string_accepts_both(self, store):
        store.create(policy_cr({"maxUnavailable": 3}, name="int"))
        store.create(policy_cr({"maxUnavailable": "25%"}, name="str"))
        with pytest.raises(InvalidError):
            store.create(policy_cr({"maxUnavailable": [1]}, name="list"))

    def test_array_items_validated(self, store):
        with pytest.raises(InvalidError) as err:
            store.create(
                policy_cr({"maintenanceWindow": {"days": ["Mon", "Funday"]}})
            )
        assert "days[1]" in str(err.value)

    def test_update_and_patch_also_admit(self, store):
        store.create(policy_cr({"autoUpgrade": True}))
        obj = store.get("GpuUpgradePolicy", "p", "d")
        bad = copy.deepcopy(obj)
        bad["spec"]["maxParallelUpgrades"] = "nope"
        with pytest.raises(InvalidError):
            store.update(bad)
        with pytest.raises(InvalidError):
            store.patch(
                "GpuUpgradePolicy",
                "p",
                {"spec": {"maxNodesPerHour": -1}},
                "d",
            )
        # the stored object is untouched by the rejected writes
        assert store.get("GpuUpgradePolicy", "p", "d")["spec"].get(
            "maxNodesPerHour"
        ) == 0


class TestDefaulting:
    def test_defaults_applied_at_admission(self, store):
        out = store.create(policy_cr({"autoUpgrade": True}))
        assert out["spec"]["maxParallelUpgrades"] == 1
        assert out["spec"]["maxUnavailable"] == "25%"
        assert out["spec"]["autoUpgrade"] is True

    def test_nested_defaults_only_when_parent_present(self, store):
        out = store.create(policy_cr({"drain": {"enable": True}}))
        assert out["spec"]["drain"]["timeoutSeconds"] == 300
        # parent absent → nested defaults not invented
        assert "validation" not in out["spec"]

    def test_explicit_values_win_over_defaults(self, store):
        out = store.create(
            policy_cr({"maxParallelUpgrades": 7, "autoUpgrade": False})
        )
        assert out["spec"]["maxParallelUpgrades"] == 7


PORT_CRDS = ROOT / "k8s_operator_libs_tpu_torch" / "crd"


@pytest.fixture
def own_store():
    """A port cluster with the port's own policy and NodeMaintenance CRDs."""
    cluster = InMemoryCluster()
    for name in ("nvidia.com_gpuupgradepolicies.yaml", "maintenance.nvidia.com_nodemaintenances.yaml"):
        cluster.create(json.loads((PORT_CRDS / name).read_text()))
    return cluster


@pytest.mark.usefixtures("close_every_client")
class TestAdmissionLifecycle:
    def test_no_crd_means_schemaless(self):
        bare = InMemoryCluster()
        # no CRD applied, anything goes
        bare.create(policy_cr({"maxParallelUpgrades": "three"}))

    def test_crd_delete_unregisters_schema(self, own_store):
        own_store.delete(
            "CustomResourceDefinition",
            "gpuupgradepolicies.nvidia.com",
        )
        own_store.create(policy_cr({"maxParallelUpgrades": "three"}))

    def test_schema_survives_persistence_roundtrip(self, own_store):
        restored = InMemoryCluster.from_dict(own_store.to_dict())
        with pytest.raises(InvalidError):
            restored.create(policy_cr({"maxParallelUpgrades": "three"}))

    def test_422_on_both_backends(self, own_store):
        """An invalid policy CR is a 422 on the in-mem backend AND over
        HTTP."""
        bad = policy_cr({"maxParallelUpgrades": "three"}, name="http-bad")
        with pytest.raises(InvalidError):
            own_store.create(dict(bad))
        with ApiServerFacade(own_store) as facade:
            client = KubeApiClient(KubeConfig(server=facade.url), timeout=5.0)
            with pytest.raises(InvalidError):
                client.create(bad)

    def test_invalid_cr_never_reaches_policy_source(self, own_store):
        """With the CRD applied, the invalid-edit path moves from
        CrPolicySource's last-good fallback to admission: the write
        itself is refused, so the source only ever sees valid specs."""
        from k8s_operator_libs_tpu_torch.controller import CrPolicySource

        own_store.create(
            policy_cr({"autoUpgrade": True, "maxParallelUpgrades": 2},
                      name="fleet-policy")
        )
        source = CrPolicySource(own_store, "fleet-policy", "d")
        good = source.current()
        assert good.max_parallel_upgrades == 2
        with pytest.raises(InvalidError):
            own_store.patch(
                "GpuUpgradePolicy",
                "fleet-policy",
                {"spec": {"maxParallelUpgrades": "garbage"}},
                "d",
            )
        assert source.current().max_parallel_upgrades == 2


class TestSchemaHelpers:
    def test_extract_prefers_storage_version(self):
        crd = load_crd(POLICY_CRD)
        kind, schema = extract_crd_schema(crd)
        assert kind == "GpuUpgradePolicy"
        assert schema["type"] == "object"

    def test_crd_without_schema_is_schemaless(self):
        crd = load_crd(POLICY_CRD)
        del crd["spec"]["versions"][0]["schema"]
        assert extract_crd_schema(crd) is None

    def test_validate_and_defaults_pure_helpers(self):
        schema = {
            "type": "object",
            "required": ["a"],
            "properties": {
                "a": {"type": "integer", "minimum": 1},
                "b": {"type": "string", "default": "x"},
            },
        }
        obj = {"a": 3}
        apply_defaults(obj, schema)
        assert obj["b"] == "x"
        assert validate(obj, schema) == []
        assert validate({"a": 0}, schema) != []
        assert validate({}, schema) != []

    def test_schema_removed_by_update_stops_validating(self, store):
        """A real apiserver stops validating the moment the structural
        schema is dropped from the CRD — updating to a schemaless
        version must unregister, not leave the stale schema enforcing."""
        crd = store.get(
            "CustomResourceDefinition", "gpuupgradepolicies.nvidia.com"
        )
        del crd["spec"]["versions"][0]["schema"]
        store.update(crd)
        store.create(policy_cr({"maxParallelUpgrades": "three"}))


class TestSchemaHelperEdges:
    """Branch coverage for the pure helpers: version selection in
    extract_crd_schema and the numeric/string/array bound validators
    (the envtest-parity admission rules consumers rely on)."""

    def test_extract_prefers_storage_version(self):
        crd = {
            "spec": {
                "names": {"kind": "Widget"},
                "versions": [
                    {"name": "v1alpha1", "served": True, "storage": False,
                     "schema": {"openAPIV3Schema": {"type": "object"}}},
                    {"name": "v1", "served": True, "storage": True,
                     "schema": {"openAPIV3Schema": {
                         "type": "object",
                         "properties": {"spec": {"type": "object"}}}}},
                ],
            }
        }
        out = extract_crd_schema(crd)
        assert out is not None
        kind, schema = out[0], out[1]
        assert kind == "Widget"
        assert "properties" in schema

    def test_extract_falls_back_to_served(self):
        crd = {
            "spec": {
                "names": {"kind": "Widget"},
                "versions": [
                    {"name": "v1beta1", "served": True,
                     "schema": {"openAPIV3Schema": {"type": "object"}}},
                ],
            }
        }
        assert extract_crd_schema(crd) is not None

    def test_extract_rejects_kindless_and_versionless(self):
        assert extract_crd_schema({"spec": {}}) is None
        assert extract_crd_schema(
            {"spec": {"names": {"kind": "W"}, "versions": []}}
        ) is None

    def test_numeric_bounds(self):
        schema = {"type": "integer", "minimum": 1, "maximum": 5}
        assert validate(3, schema) == []
        assert any("below minimum" in e for e in validate(0, schema))
        assert any("above maximum" in e for e in validate(9, schema))

    def test_string_bounds_and_pattern(self):
        schema = {
            "type": "string", "minLength": 2, "maxLength": 4,
            "pattern": "^ab",
        }
        assert validate("abc", schema) == []
        assert any("minLength" in e for e in validate("a", schema))
        assert any("maxLength" in e for e in validate("abcde", schema))
        assert any("pattern" in e for e in validate("zz", schema))

    def test_array_min_items(self):
        schema = {
            "type": "array", "minItems": 2,
            "items": {"type": "integer"},
        }
        assert validate([1, 2], schema) == []
        assert any("minItems" in e for e in validate([1], schema))


# ------------------------------------------------------------ the laws
def held_to_jax(ours_fn, theirs_fn):
    """*ours_fn*, each call of which also runs *theirs_fn* on a copy of
    the same arguments and asserts the same result or the same error
    (class name and message)."""

    def call(*args, **kwargs):
        t_args, t_kwargs = copy.deepcopy((args, kwargs))
        try:
            expect, t_err = theirs_fn(*t_args, **t_kwargs), None
        except Exception as err:  # compared below, then re-raised by ours
            expect, t_err = None, err
        try:
            got = ours_fn(*args, **kwargs)
        except Exception as err:
            assert t_err is not None, f"only the port raised {err!r}"
            assert (type(err).__name__, str(err)) == (type(t_err).__name__, str(t_err))
            raise
        assert t_err is None, f"only the JAX function raised {t_err!r}"
        assert got == expect
        return got

    return call


merge_patch = held_to_jax(port_merge_patch, jax_merge_patch)
STRATEGIC_MERGE = held_to_jax(port_strategic_merge, jax_strategic_merge)


class IntOrString:
    """The port's IntOrString; construction and ``scaled_value`` are held
    to the JAX type's."""

    def __init__(self, raw):
        try:
            self._theirs, t_err = JaxIntOrString(raw), None
        except Exception as err:  # compared below, then re-raised by ours
            t_err = err
        try:
            self._ours = PortIntOrString(raw)
        except Exception as err:
            assert t_err is not None
            assert (type(err).__name__, str(err)) == (type(t_err).__name__, str(t_err))
            raise
        assert t_err is None, f"only the JAX type raised {t_err!r}"

    def scaled_value(self, total, round_up=True):
        return held_to_jax(
            lambda: self._ours.scaled_value(total, round_up=round_up),
            lambda: self._theirs.scaled_value(total, round_up=round_up),
        )()


# JSON-tree strategy: bounded depth/width so each case stays microsecond
_scalars = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(-1000, 1000),
    st.text(max_size=8),
)
_json = st.recursive(
    _scalars,
    lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.dictionaries(st.text(max_size=6), children, max_size=4),
    ),
    max_leaves=12,
)
_objs = st.dictionaries(st.text(max_size=6), _json, max_size=5)
# RFC 7386 patches: like objects, but None (JSON null) means "delete"
_patches = _objs


class TestMergePatchLaws:
    @settings(max_examples=150, deadline=None)
    @given(target=_objs, patch=_patches)
    def test_idempotent(self, target, patch):
        """Applying the same merge patch twice equals applying it once
        (RFC 7386 patches are absolute, not incremental)."""
        once = merge_patch(target, patch)
        twice = merge_patch(once, patch)
        assert once == twice

    @settings(max_examples=150, deadline=None)
    @given(target=_objs, patch=_patches)
    def test_result_never_contains_null_values_from_patch(
        self, target, patch
    ):
        """null in a patch DELETES — it must never appear as a stored
        value at any level the patch touched."""
        out = merge_patch(target, patch)

        def check(node, pat):
            if not isinstance(node, dict) or not isinstance(pat, dict):
                return
            for k, v in pat.items():
                if v is None:
                    assert k not in node
                elif isinstance(v, dict):
                    check(node.get(k), v)

        check(out, patch)

    @settings(max_examples=150, deadline=None)
    @given(target=_objs, patch=_patches)
    def test_target_not_mutated(self, target, patch):
        before = json.dumps(target, sort_keys=True, default=str)
        merge_patch(target, patch)
        assert json.dumps(target, sort_keys=True, default=str) == before

    @settings(max_examples=150, deadline=None)
    @given(target=_objs)
    def test_empty_patch_is_identity(self, target):
        assert merge_patch(target, {}) == target


class TestIntOrStringProperties:
    @settings(max_examples=200, deadline=None)
    @given(pct=st.integers(0, 100), total=st.integers(0, 10_000))
    def test_percent_bounds_and_monotonicity(self, pct, total):
        v = IntOrString(f"{pct}%")
        up = v.scaled_value(total, round_up=True)
        down = v.scaled_value(total, round_up=False)
        assert 0 <= down <= up <= total
        # exact endpoints
        if pct == 0:
            assert up == 0
        if pct == 100:
            assert down == total

    @settings(max_examples=100, deadline=None)
    @given(n=st.integers(-1000, 1000), total=st.integers(0, 10_000))
    def test_int_passthrough(self, n, total):
        assert IntOrString(n).scaled_value(total) == n

    @settings(max_examples=50, deadline=None)
    @given(s=st.text(max_size=6))
    def test_garbage_strings_rejected(self, s):
        import re

        if re.fullmatch(r"\d+%", s):
            return  # IntOrString accepts any digit-run percent
        with pytest.raises((ValueError, TypeError)):
            IntOrString(s)


class TestCopyOutFidelity:
    @settings(max_examples=80, deadline=None)
    @given(obj=_objs)
    def test_store_returns_equal_but_independent_objects(self, obj):
        """get() hands out a deep copy equal to what was stored —
        whether it travelled the marshal-blob fast path or the
        json_copy fallback — and mutating it never touches the store."""
        from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster

        cluster = InMemoryCluster()
        body = {
            "kind": "ConfigMap",
            "metadata": {"name": "x", "namespace": "d"},
            "data": obj,
        }
        cluster.create(json_copy(body))
        got = cluster.get("ConfigMap", "x", "d")
        assert got["data"] == obj
        got2 = cluster.get("ConfigMap", "x", "d")  # blob-cache hit path
        assert got2["data"] == obj
        got2["data"] = {"mutated": True}
        assert cluster.get("ConfigMap", "x", "d")["data"] == obj


class TestStrategicMergeLaws:
    _containers = st.lists(
        st.builds(
            lambda n, img, port: {"name": f"c{n}", "image": img, "port": port},
            st.integers(0, 4),
            st.text(max_size=5),
            st.integers(0, 100),
        ),
        max_size=4,
        unique_by=lambda c: c["name"],
    )

    @settings(max_examples=120, deadline=None)
    @given(tgt=_containers, pat=_containers)
    def test_keyed_list_merge_idempotent(self, tgt, pat):
        """Merging the same keyed-list patch twice equals once, and the
        merge key stays unique in the result."""
        strategic_merge = STRATEGIC_MERGE

        target = {"spec": {"containers": tgt}}
        patch = {"spec": {"containers": pat}}
        once = strategic_merge(json_copy(target), patch, kind="Pod")
        twice = strategic_merge(json_copy(once), patch, kind="Pod")
        assert once == twice
        names = [c["name"] for c in once["spec"]["containers"]]
        assert len(names) == len(set(names))

    @settings(max_examples=120, deadline=None)
    @given(tgt=_containers, pat=_containers)
    def test_keyed_merge_applies_patch_fields(self, tgt, pat):
        """Every patched element ends up present with the patch's
        fields winning; unpatched elements survive untouched."""
        strategic_merge = STRATEGIC_MERGE

        target = {"spec": {"containers": tgt}}
        patch = {"spec": {"containers": pat}}
        out = strategic_merge(json_copy(target), patch, kind="Pod")
        by_name = {c["name"]: c for c in out["spec"]["containers"]}
        for p in pat:
            got = by_name[p["name"]]
            for k, v in p.items():
                assert got[k] == v
        patched = {p["name"] for p in pat}
        tgt_by_name = {c["name"]: c for c in tgt}
        for name, c in tgt_by_name.items():
            if name not in patched:
                assert by_name[name] == c

    @settings(max_examples=80, deadline=None)
    @given(tgt=st.lists(st.integers(0, 9), max_size=5),
           pat=st.lists(st.integers(0, 9), max_size=5))
    def test_unregistered_list_is_atomic_replace(self, tgt, pat):
        strategic_merge = STRATEGIC_MERGE

        out = strategic_merge(
            {"x": {"unregistered": tgt}},
            {"x": {"unregistered": pat}},
            kind="Pod",
        )
        assert out["x"]["unregistered"] == pat

    @settings(max_examples=80, deadline=None)
    @given(tgt=_containers, pat=_containers)
    def test_target_not_mutated(self, tgt, pat):
        strategic_merge = STRATEGIC_MERGE

        target = {"spec": {"containers": tgt}}
        before = json.dumps(target, sort_keys=True)
        strategic_merge(target, {"spec": {"containers": pat}}, kind="Pod")
        assert json.dumps(target, sort_keys=True) == before


class TestJournalReconstruction:
    """The informer contract as a law: for ANY interleaving of
    creates/patches/deletes, a snapshot taken at floor F plus the
    journal events after F reconstructs the store's final state
    exactly.  Every cache in the system (InformerCache, the HTTP
    client's last-seen view, the controller tee) leans on this."""

    _ops = st.lists(
        st.tuples(
            st.sampled_from(["create", "patch", "delete"]),
            st.sampled_from(["ConfigMap", "Node"]),
            st.integers(0, 3),  # object ordinal
            st.integers(0, 99),  # payload
        ),
        min_size=1,
        max_size=40,
    )

    @settings(max_examples=100, deadline=None)
    @given(ops=_ops, floor_frac=st.floats(0.0, 1.0))
    def test_snapshot_plus_events_reconstructs_store(
        self, ops, floor_frac
    ):
        from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node

        cluster = InMemoryCluster()

        def mk(kind, i, payload):
            if kind == "Node":
                node = make_node(f"n{i}")
                node["metadata"].setdefault("labels", {})["p"] = str(
                    payload
                )
                return node
            return {
                "kind": "ConfigMap",
                "metadata": {"name": f"cm{i}", "namespace": "d"},
                "data": {"v": payload},
            }

        def ns(kind):
            return "" if kind == "Node" else "d"

        # apply a prefix, snapshot, then the rest
        cut = int(len(ops) * floor_frac)
        snap = {}
        floor = 0

        def apply(op, kind, i, payload):
            name = f"n{i}" if kind == "Node" else f"cm{i}"
            try:
                if op == "create":
                    cluster.create(mk(kind, i, payload))
                elif op == "patch":
                    cluster.patch(
                        kind, name,
                        {"metadata": {"labels": {"p": str(payload)}}},
                        namespace=ns(kind),
                    )
                else:
                    cluster.delete(kind, name, namespace=ns(kind))
            except Exception:  # noqa: BLE001 — missing/exists: legal no-ops
                pass

        for op, kind, i, payload in ops[:cut]:
            apply(op, kind, i, payload)
        floor = cluster.journal_seq()
        snap = {
            (o["kind"], (o["metadata"].get("namespace") or ""),
             o["metadata"]["name"]): o
            for kind in ("ConfigMap", "Node")
            for o in cluster.list(kind)
        }
        for op, kind, i, payload in ops[cut:]:
            apply(op, kind, i, payload)

        # replay: snapshot at floor + events after floor == final state
        view = dict(snap)
        for ev in cluster.events_since(floor):
            obj = ev.new if ev.new is not None else ev.old
            if obj is None or obj["kind"] not in ("ConfigMap", "Node"):
                continue
            key = (
                obj["kind"],
                obj["metadata"].get("namespace") or "",
                obj["metadata"]["name"],
            )
            if ev.type == "Deleted":
                view.pop(key, None)
            else:
                view[key] = obj

        final = {
            (o["kind"], (o["metadata"].get("namespace") or ""),
             o["metadata"]["name"]): o
            for kind in ("ConfigMap", "Node")
            for o in cluster.list(kind)
        }
        assert view.keys() == final.keys()
        for key in final:
            a, b = view[key], final[key]
            assert a["metadata"].get("labels") == b["metadata"].get(
                "labels"
            ), key
            assert a.get("data") == b.get("data"), key


class TestStrategicMergeDirectiveEdges:
    """The $patch directive branches the rollout suites never hit:
    replace-at-map, explicit merge, root-level misuse, malformed
    delete, and every keyed/atomic list rejection path.  Each is the
    apiserver's strategic-merge contract (kubectl sends these)."""

    @staticmethod
    def _sm():
        return STRATEGIC_MERGE

    def test_replace_directive_replaces_map_wholesale(self):
        sm = self._sm()
        out = sm(
            {"labels": {"a": "1", "b": "2"}},
            {"labels": {"$patch": "replace", "c": "3"}},
            kind="Node",
        )
        assert out["labels"] == {"c": "3"}

    def test_explicit_merge_directive_is_default_strategy(self):
        sm = self._sm()
        out = sm(
            {"labels": {"a": "1"}},
            {"labels": {"$patch": "merge", "b": "2"}},
            kind="Node",
        )
        assert out["labels"] == {"a": "1", "b": "2"}

    def test_root_level_delete_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        with pytest.raises(BadRequestError, match="patch root"):
            sm({"a": 1}, {"$patch": "delete"}, kind="Node")

    def test_unknown_directive_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        with pytest.raises(BadRequestError, match="not valid here"):
            sm({}, {"x": {"$patch": "upsert"}}, kind="Node")

    def test_delete_with_extra_keys_rejected(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        with pytest.raises(BadRequestError, match="must not carry"):
            sm(
                {"m": {"a": 1}},
                {"m": {"$patch": "delete", "stray": 1}},
                kind="Node",
            )

    def test_atomic_list_rejects_directives(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        # Node has no merge key registered for this path -> atomic
        with pytest.raises(BadRequestError, match="atomic"):
            sm(
                {"spec": {"things": [1]}},
                {"spec": {"things": [{"$patch": "delete"}]}},
                kind="Node",
            )

    def test_keyed_list_replace_directive(self):
        sm = self._sm()
        # Pod spec.containers merges on name; a leading $patch: replace
        # element swaps the whole list for the remainder
        out = sm(
            {"spec": {"containers": [{"name": "a", "image": "x"}]}},
            {"spec": {"containers": [
                {"$patch": "replace"},
                {"name": "b", "image": "y"},
            ]}},
            kind="Pod",
        )
        assert out["spec"]["containers"] == [{"name": "b", "image": "y"}]

    def test_keyed_list_rejects_non_object_and_unknown_directive(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        with pytest.raises(BadRequestError, match="must be"):
            sm(
                {"spec": {"containers": []}},
                {"spec": {"containers": ["not-an-object"]}},
                kind="Pod",
            )
        with pytest.raises(BadRequestError, match="unknown \\$patch"):
            sm(
                {"spec": {"containers": []}},
                {"spec": {"containers": [
                    {"name": "a", "$patch": "upsert"}]}},
                kind="Pod",
            )

    def test_keyed_list_requires_merge_key(self):
        from k8s_operator_libs_tpu_torch.cluster.errors import BadRequestError

        sm = self._sm()
        with pytest.raises(BadRequestError, match="missing merge key"):
            sm(
                {"spec": {"containers": []}},
                {"spec": {"containers": [{"image": "x"}]}},
                kind="Pod",
            )


# ------------------------------------------------------- admission parity
SPEC_VALUES = (-5, 0, 3, "three", True, "25%", "abc", None, 1.5, {"enable": True},
               {"enable": "yes"}, [1], "02:00")
SPEC_FIELDS = ("autoUpgrade", "maxParallelUpgrades", "maxUnavailable", "maxNodesPerHour",
               "drain", "podDeletion", "preDrainCheckpoint", "sliceAware")


def _admit(cluster, body):
    try:
        return "ok", mask(cluster.create(copy.deepcopy(body)))
    except Exception as err:  # an ApiError of either package, compared
        return type(err).__name__, str(err)


@pytest.mark.parametrize("seed", range(3))
def test_admission_matches_the_jax_cluster(seed):
    rng = np.random.RandomState(seed)
    theirs, ours = JaxInMemoryCluster(), InMemoryCluster()
    for path in (POLICY_CRD, NM_CRD):
        theirs.create(load_jax_crd(path))
        ours.create(load_crd(path))
    verdicts = set()
    for i in range(80):
        spec = {
            SPEC_FIELDS[rng.randint(len(SPEC_FIELDS))]: copy.deepcopy(SPEC_VALUES[rng.randint(len(SPEC_VALUES))])
            for _ in range(rng.randint(1, 4))
        }
        cr = {"kind": "TpuUpgradePolicy", "metadata": {"name": f"p{i}", "namespace": "d"}, "spec": spec}
        expect = _admit(theirs, cr)
        assert _admit(ours, to_port_vocab(cr)) == to_port_vocab(expect), cr
        verdicts.add(expect[0])
    assert verdicts == {"ok", "InvalidError"}
    assert mask(ours.to_dict()) == mask(to_port_vocab(theirs.to_dict()))
