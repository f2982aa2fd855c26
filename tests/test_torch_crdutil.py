"""The port's crdutil (k8s_operator_libs_tpu_torch/crdutil/):
walk/parse/apply/update/delete/idempotency/ready-wait.

Every class of ``tests/test_crdutil.py``, as cases of the same names, on
the port, over its fixtures in the port's vocabulary
(``tests/test-files`` rewritten by ``to_port_vocab``) and its own CRDs
(``k8s_operator_libs_tpu_torch/crd/``); ``TestExampleCli`` runs the
port's ``examples/apply_crds.py``.  Beyond them: each port CRD file is
JSON, reads the same through PyYAML, and is the JAX package's CRD in the
port's vocabulary; and the same CRDs applied and deleted through both
packages leave the same stores.

Reference spec coverage: pkg/crdutil/crdutil_test.go (264 LoC) —
apply/update/delete/idempotency/recursive-walk/multi-path against the
test-files fixtures — plus the async-establishment readiness wait that
envtest gives the reference for free.
"""

import json
import os
from pathlib import Path

import pytest
import yaml

from k8s_operator_libs_tpu import crdutil as jcrdutil
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxCluster
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.crdutil import (
    CRD_KIND,
    CRDProcessingError,
    CRDProcessorConfig,
    OPERATION_APPLY,
    OPERATION_DELETE,
    discovery,
    parse_crds_from_file,
    process_crds,
    process_crds_with_config,
    walk_crd_paths,
)

from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

HERE = os.path.dirname(__file__)
ROOT = Path(HERE).resolve().parent
JAX_FIXTURES = ROOT / "tests" / "test-files"
JAX_CRDS = ROOT / "hack" / "crd" / "bases"
PORT_CRDS = ROOT / "k8s_operator_libs_tpu_torch" / "crd"
#: set by :func:`port_fixtures`: tests/test-files in the port's vocabulary
FIXTURES = CRDS_YAML = UPDATED_YAML = ""
NM_CRD = str(PORT_CRDS / "maintenance.nvidia.com_nodemaintenances.yaml")


@pytest.fixture(scope="module", autouse=True)
def port_fixtures(tmp_path_factory):
    global FIXTURES, CRDS_YAML, UPDATED_YAML
    root = tmp_path_factory.mktemp("test-files")
    for src in JAX_FIXTURES.rglob("*"):
        dst = root / src.relative_to(JAX_FIXTURES)
        if src.is_dir():
            dst.mkdir(parents=True, exist_ok=True)
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(to_port_vocab(src.read_text()))
    FIXTURES = str(root)
    CRDS_YAML = str(root / "crds.yaml")
    UPDATED_YAML = str(root / "updated-crds.yaml")


@pytest.fixture()
def cluster():
    return InMemoryCluster()


class TestWalkAndParse:
    def test_recursive_walk_yaml_only(self, tmp_path):
        (tmp_path / "a.yaml").write_text("kind: CustomResourceDefinition\nmetadata: {name: a.x}\nspec: {}\n")
        (tmp_path / "b.yml").write_text("kind: ConfigMap\n")
        (tmp_path / "c.txt").write_text("not yaml")
        sub = tmp_path / "deep" / "deeper"
        sub.mkdir(parents=True)
        (sub / "d.yaml").write_text("kind: ConfigMap\n")
        files = walk_crd_paths([str(tmp_path)])
        assert [os.path.basename(f) for f in files] == ["a.yaml", "b.yml", "d.yaml"]

    def test_missing_path_errors(self):
        with pytest.raises(CRDProcessingError):
            walk_crd_paths(["/does/not/exist"])

    def test_multi_doc_skips_non_crds(self):
        crds = parse_crds_from_file(CRDS_YAML)
        assert [c["metadata"]["name"] for c in crds] == [
            "widgets.example.nvidia.com",
            "gadgets.example.nvidia.com",
        ]

    def test_invalid_yaml_is_error(self, tmp_path):
        bad = tmp_path / "bad.yaml"
        bad.write_text("kind: [unclosed\n")
        with pytest.raises(CRDProcessingError):
            parse_crds_from_file(str(bad))

    def test_nameless_crd_is_error(self, tmp_path):
        bad = tmp_path / "nameless.yaml"
        bad.write_text("kind: CustomResourceDefinition\nmetadata: {}\n")
        with pytest.raises(CRDProcessingError):
            parse_crds_from_file(str(bad))


class TestApplyDelete:
    def test_apply_creates_and_serves(self, cluster):
        crds = process_crds(cluster, OPERATION_APPLY, CRDS_YAML)
        assert len(crds) == 2
        assert cluster.exists(CRD_KIND, "widgets.example.nvidia.com")
        assert ("example.nvidia.com", "v1", "widgets") in discovery(cluster)

    def test_apply_is_idempotent(self, cluster):
        process_crds(cluster, OPERATION_APPLY, CRDS_YAML)
        process_crds(cluster, OPERATION_APPLY, CRDS_YAML)
        assert len(cluster.list(CRD_KIND)) == 2

    def test_apply_updates_existing(self, cluster):
        process_crds(cluster, OPERATION_APPLY, CRDS_YAML)
        process_crds(cluster, OPERATION_APPLY, UPDATED_YAML)
        crd = cluster.get(CRD_KIND, "widgets.example.nvidia.com")
        versions = [v["name"] for v in crd["spec"]["versions"]]
        assert versions == ["v1", "v2"]
        # update must not clobber server-managed status
        assert any(
            c["type"] == "Established" and c["status"] == "True"
            for c in crd["status"]["conditions"]
        )
        assert ("example.nvidia.com", "v2", "widgets") in discovery(cluster)

    def test_delete_and_idempotent_delete(self, cluster):
        process_crds(cluster, OPERATION_APPLY, CRDS_YAML)
        process_crds(cluster, OPERATION_DELETE, CRDS_YAML)
        assert cluster.list(CRD_KIND) == []
        process_crds(cluster, OPERATION_DELETE, CRDS_YAML)  # no error

    def test_multiple_paths_incl_nested_dir(self, cluster):
        process_crds(cluster, OPERATION_APPLY, CRDS_YAML, FIXTURES)
        names = {c["metadata"]["name"] for c in cluster.list(CRD_KIND)}
        assert "sprockets.example.nvidia.com" in names

    def test_unknown_operation(self, cluster):
        with pytest.raises(CRDProcessingError):
            process_crds(cluster, "upsert", CRDS_YAML)

    def test_nodemaintenance_fixture_applies(self, cluster):
        process_crds(cluster, OPERATION_APPLY, NM_CRD)
        assert (
            "maintenance.nvidia.com",
            "v1alpha1",
            "nodemaintenances",
        ) in discovery(cluster)


class TestReadyWait:
    def test_waits_for_async_establishment(self):
        cluster = InMemoryCluster(crd_establish_delay_seconds=0.15)
        config = CRDProcessorConfig(
            paths=[CRDS_YAML],
            operation=OPERATION_APPLY,
            ready_timeout_seconds=3.0,
            ready_poll_seconds=0.02,
        )
        process_crds_with_config(cluster, config)  # must not time out
        assert len(discovery(cluster)) == 2

    def test_timeout_when_never_established(self):
        cluster = InMemoryCluster(crd_establish_delay_seconds=60.0)
        config = CRDProcessorConfig(
            paths=[CRDS_YAML],
            operation=OPERATION_APPLY,
            ready_timeout_seconds=0.2,
            ready_poll_seconds=0.02,
        )
        with pytest.raises(CRDProcessingError, match="timed out"):
            process_crds_with_config(cluster, config)

    def test_skip_ready_wait(self):
        cluster = InMemoryCluster(crd_establish_delay_seconds=60.0)
        config = CRDProcessorConfig(
            paths=[CRDS_YAML], operation=OPERATION_APPLY, skip_ready_wait=True
        )
        process_crds_with_config(cluster, config)  # returns immediately


class TestExampleCli:
    def test_apply_then_delete_via_state_file(self, tmp_path):
        from k8s_operator_libs_tpu_torch.examples import apply_crds as mod

        state = str(tmp_path / "state.json")
        assert mod.main(["--crds-path", CRDS_YAML, "--state-file", state]) == 0
        assert mod.main(
            ["--crds-path", CRDS_YAML, "--operation", "delete", "--state-file", state]
        ) == 0
        cluster = mod.load_cluster(state)
        assert cluster.list("CustomResourceDefinition") == []

    def test_bad_path_exits_nonzero(self, capsys):
        from k8s_operator_libs_tpu_torch.examples import apply_crds as mod

        assert mod.main(["--crds-path", "/nope"]) == 1
        assert "error:" in capsys.readouterr().err

    def test_applies_the_ports_own_crds(self, capsys):
        from k8s_operator_libs_tpu_torch.examples import apply_crds as mod

        assert mod.main(["--crds-path", str(PORT_CRDS)]) == 0
        out = capsys.readouterr().out
        assert "processed 3 CRD(s)" in out
        assert "nvidia.com/v1alpha1/gpuupgradepolicies" in out
        assert "nvidia.com/v1alpha1/gpufederationpolicies" in out


def _jax_crd_files():
    return sorted(JAX_CRDS.glob("*.yaml"))


class TestPortCrds:
    @pytest.mark.parametrize("jax_file", _jax_crd_files(), ids=lambda p: p.name)
    def test_each_crd_is_json_and_the_jax_crd_in_port_vocabulary(self, jax_file):
        port_file = PORT_CRDS / to_port_vocab(jax_file.name)
        text = port_file.read_text()
        assert text == json.dumps(json.loads(text), indent=2) + "\n"
        assert json.loads(text) == yaml.safe_load(text) == to_port_vocab(yaml.safe_load(jax_file.read_text()))

    def test_the_port_ships_exactly_the_jax_crds(self):
        assert sorted(p.name for p in PORT_CRDS.glob("*.yaml")) == sorted(
            to_port_vocab(p.name) for p in _jax_crd_files()
        )

    def test_chip_smoke_reads_the_port_crds_as_json(self):
        """``chip_smoke.py`` 10j reads the same three files with
        ``json.load``, no PyYAML on the card's machine."""
        import chip_smoke

        assert sorted(chip_smoke.load_port_crds(), key=lambda c: c["metadata"]["name"]) == sorted(
            (crd for path in walk_crd_paths([str(PORT_CRDS)]) for crd in parse_crds_from_file(path)),
            key=lambda c: c["metadata"]["name"],
        )

    def test_parse_reads_each_port_crd(self):
        kinds = sorted(
            crd["spec"]["names"]["kind"]
            for path in walk_crd_paths([str(PORT_CRDS)])
            for crd in parse_crds_from_file(path)
        )
        assert kinds == ["GpuFederationPolicy", "GpuUpgradePolicy", "NodeMaintenance"]


class TestDifferential:
    """The same CRDs through both packages' crdutil: JAX's files into a
    JAX store, the port's into a port store; after apply, after an update
    and after delete the stores agree after ``to_port_vocab``."""

    @staticmethod
    def _crds(store):
        return sorted(
            (to_port_vocab(c) if isinstance(store, JaxCluster) else c for c in store.list(CRD_KIND)),
            key=lambda c: c["metadata"]["name"],
        )

    @staticmethod
    def _mask(crds):
        out = []
        for crd in crds:
            crd = json.loads(json.dumps(crd))
            for key in ("uid", "creationTimestamp"):  # random and clock
                crd["metadata"].pop(key)
            out.append(crd)
        return out

    def test_apply_update_delete_leave_the_same_stores(self):
        jax, port = JaxCluster(), InMemoryCluster()
        jax_paths = [str(JAX_CRDS), str(JAX_FIXTURES / "crds.yaml")]
        port_paths = [str(PORT_CRDS), CRDS_YAML]
        applied = (
            jcrdutil.process_crds(jax, jcrdutil.OPERATION_APPLY, *jax_paths),
            process_crds(port, OPERATION_APPLY, *port_paths),
        )
        assert [c["metadata"]["name"] for c in applied[1]] == [
            to_port_vocab(c["metadata"]["name"]) for c in applied[0]
        ]
        assert self._mask(self._crds(jax)) == self._mask(self._crds(port))
        assert sorted(to_port_vocab(list(t)) for t in jcrdutil.discovery(jax)) == sorted(
            list(t) for t in discovery(port)
        )
        jcrdutil.process_crds(jax, jcrdutil.OPERATION_APPLY, str(JAX_FIXTURES / "updated-crds.yaml"))
        process_crds(port, OPERATION_APPLY, UPDATED_YAML)
        assert self._mask(self._crds(jax)) == self._mask(self._crds(port))
        jcrdutil.process_crds(jax, jcrdutil.OPERATION_DELETE, *jax_paths)
        process_crds(port, OPERATION_DELETE, *port_paths)
        assert self._crds(jax) == self._crds(port) == []
        assert jcrdutil.discovery(jax) == discovery(port) == []
