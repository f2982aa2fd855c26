"""The port's GPU-fleet vocabulary against the JAX package's.

The port binds the control plane to NVIDIA fleets: the ``nvidia.com``
domain, the default component ``gpu-driver`` (so the state label is the
reference's ``nvidia.com/gpu-driver-upgrade-state``), GPU Feature
Discovery's NVLink-domain label in place of the GKE slice labels, and the
``GpuUpgradePolicy`` kind.  The semantics do not change, so every key the
port builds is the JAX package's key rewritten by one table,
:data:`PORT_VOCAB`.  :func:`to_port_vocab` applies it to any JSON tree;
the other control-plane parity files import it from here.
"""

import ast
import inspect
from pathlib import Path

import pytest

from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.upgrade import consts, util

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_operator_libs_tpu_torch"

#: (JAX string, port string), applied in order to every substring.  The
#: GKE topology label and the GKE multislice label have no GPU-fleet
#: counterpart and are left as they are.  The table is injective: the two
#: degraded labels map to two strings.
PORT_VOCAB = (
    ("cloud.google.com/gke-tpu-slice", "nvidia.com/gpu.clique"),
    ("cloud.google.com/gke-tpu-degraded", "nvidia.com/gpu.degraded"),
    ("TpuDegraded", "GpuDegraded"),
    ("TpuLinkDown", "NVLinkDown"),
    ("degraded TPU host", "degraded GPU host"),
    ("tpu.google.com", "nvidia.com"),
    ("tpu-runtime", "gpu-driver"),
    ("TpuUpgradePolic", "GpuUpgradePolic"),
    ("tpuupgradepolic", "gpuupgradepolic"),
    ("tpu-operator", "nvidia-operator"),
    ("degraded TPU)", "degraded GPU)"),
    ("TpuFederationPolic", "GpuFederationPolic"),
    ("tpufederationpolic", "gpufederationpolic"),
    ("k8s_operator_libs_tpu.obs.profiling", "k8s_operator_libs_tpu_torch.obs.profiling"),
)

#: Substrings no string of the port may hold.
TPU_MARKERS = ("tpu.google.com", "gke-tpu")


def _rewrite(text: str) -> str:
    for old, new in PORT_VOCAB:
        text = text.replace(old, new)
    return text


def _rewrite_back(text: str) -> str:
    for old, new in PORT_VOCAB:
        text = text.replace(new, old)
    return text


def from_port_vocab(obj):
    """The inverse of :func:`to_port_vocab` on the strings it produces."""
    if isinstance(obj, str):
        return _rewrite_back(obj)
    if isinstance(obj, dict):
        return {from_port_vocab(k): from_port_vocab(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_port_vocab(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(from_port_vocab(v) for v in obj)
    return obj


def to_port_vocab(obj):
    """*obj* (a string or a JSON tree of dicts, lists and tuples) with
    every key and string value rewritten by :data:`PORT_VOCAB`."""
    if isinstance(obj, str):
        return _rewrite(obj)
    if isinstance(obj, dict):
        return {to_port_vocab(k): to_port_vocab(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_port_vocab(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_port_vocab(v) for v in obj)
    return obj


@pytest.fixture(autouse=True)
def default_component_names():
    util.set_component_name("gpu-driver")
    jutil.set_component_name("tpu-runtime")
    yield
    util.set_component_name("gpu-driver")
    jutil.set_component_name("tpu-runtime")


def test_to_port_vocab_rewrites_keys_values_and_nests():
    tree = {
        "tpu.google.com/tpu-runtime-upgrade-state": ["tpu.google.com/x", ("TpuUpgradePolicy",)],
        "n": 3,
        "nested": {"cloud.google.com/gke-tpu-slice": "tpuupgradepolicies.tpu.google.com"},
    }
    assert to_port_vocab(tree) == {
        "nvidia.com/gpu-driver-upgrade-state": ["nvidia.com/x", ("GpuUpgradePolicy",)],
        "n": 3,
        "nested": {"nvidia.com/gpu.clique": "gpuupgradepolicies.nvidia.com"},
    }


def test_from_port_vocab_inverts_it():
    tree = {
        "tpu.google.com/tpu-runtime-pre-drain-checkpoint": "requested:t",
        "labels": ["cloud.google.com/gke-tpu-slice", "tpu.google.com/slice-id"],
        "kind": "TpuUpgradePolicy",
    }
    assert from_port_vocab(to_port_vocab(tree)) == tree


def test_the_table_is_injective():
    olds = [old for old, _ in PORT_VOCAB]
    news = [new for _, new in PORT_VOCAB]
    assert len(set(olds)) == len(olds) and len(set(news)) == len(news)
    for old in olds:
        assert from_port_vocab(to_port_vocab(old)) == old
    health_labels = ("tpu.google.com/degraded", "cloud.google.com/gke-tpu-degraded")
    assert len({to_port_vocab(k) for k in health_labels}) == 2
    for key in health_labels + ("tpu.google.com/decision-seq", "TpuLinkDown"):
        assert from_port_vocab(to_port_vocab(key)) == key
    # the requestor's name prefix and its quarantine log line
    assert to_port_vocab("tpu-operator") == "nvidia-operator"
    assert to_port_vocab("domain quarantined (degraded TPU) — ") == "domain quarantined (degraded GPU) — "
    degraded = ("(degraded TPU) —", "degraded TPU host")
    assert len({to_port_vocab(s) for s in degraded}) == 2
    for key in degraded + ("tpu-operator-n1", "maintenance.tpu.google.com/finalizer"):
        assert from_port_vocab(to_port_vocab(key)) == key
    # the federation CRD's kind, list kind, plural and name; its short
    # name "tfp" has no row
    federation = (
        "TpuFederationPolicy", "TpuFederationPolicyList", "tpufederationpolicies",
        "tpufederationpolicies.tpu.google.com",
    )
    assert [to_port_vocab(s) for s in federation] == [
        "GpuFederationPolicy", "GpuFederationPolicyList", "gpufederationpolicies",
        "gpufederationpolicies.nvidia.com",
    ]
    assert to_port_vocab("tfp") == "tfp"
    # the profiler's exporter names its own module; the bare package name
    # (racewatch's path marker) is no row and stays
    exporter = "k8s_operator_libs_tpu.obs.profiling"
    assert to_port_vocab(exporter) == "k8s_operator_libs_tpu_torch.obs.profiling"
    assert to_port_vocab("k8s_operator_libs_tpu") == "k8s_operator_libs_tpu"
    for key in federation + (exporter, "tfp"):
        assert from_port_vocab(to_port_vocab(key)) == key
    # the port's strings are fixed points: a second pass changes nothing
    for key in federation + (exporter,):
        assert to_port_vocab(to_port_vocab(key)) == to_port_vocab(key)


def test_the_defaults_are_the_nvidia_references():
    assert consts.DOMAIN == "nvidia.com"
    assert util.get_component_name() == "gpu-driver"
    assert util.get_upgrade_state_label_key() == "nvidia.com/gpu-driver-upgrade-state"
    assert util.get_pre_drain_checkpoint_annotation_key() == (
        "nvidia.com/gpu-driver-pre-drain-checkpoint"
    )


def _key_builders():
    return sorted(
        name
        for name, fn in inspect.getmembers(jutil, inspect.isfunction)
        if name.startswith("get_") and name != "get_component_name"
        and fn.__module__ == jutil.__name__
    )


def test_the_port_has_every_key_builder():
    assert _key_builders() == sorted(
        name for name, fn in inspect.getmembers(util, inspect.isfunction)
        if name.startswith("get_") and name != "get_component_name"
        and fn.__module__ == util.__name__
    )


@pytest.mark.parametrize("component", [None, "gpu"])
@pytest.mark.parametrize("builder", _key_builders())
def test_each_key_builder_is_the_jax_key_in_port_vocabulary(builder, component):
    if component is not None:
        util.set_component_name(component)
        jutil.set_component_name(component)
    assert getattr(util, builder)() == to_port_vocab(getattr(jutil, builder)())


def _constant_names(module):
    return sorted(n for n in vars(module) if n.isupper() and not n.startswith("_"))


def test_the_port_has_every_constant():
    assert _constant_names(consts) == _constant_names(jconsts)


@pytest.mark.parametrize("name", _constant_names(jconsts))
def test_each_constant_is_the_jax_constant_in_port_vocabulary(name):
    ours, theirs = getattr(consts, name), getattr(jconsts, name)
    if name == "SLICE_ID_LABEL_KEYS":
        # no counterpart of GKE's topology-label fallback
        assert theirs[2] == "cloud.google.com/gke-tpu-topology"
        theirs = theirs[:2]
    elif name == "MULTISLICE_GROUP_LABEL_KEYS":
        # no counterpart of GKE's multislice label
        assert theirs[1] == "cloud.google.com/gke-tpu-multislice-group"
        theirs = theirs[:1]
    assert ours == to_port_vocab(theirs)


def test_every_state_is_the_jax_state():
    assert consts.ALL_STATES == jconsts.ALL_STATES
    assert consts.ACTIVE_STATES == jconsts.ACTIVE_STATES


def test_the_event_reason_follows_the_component():
    assert util.get_event_reason() == "gpu-driverUpgrade"
    assert util.get_event_reason() == to_port_vocab(jutil.get_event_reason())


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def _tpu_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n) for n in _docstring_nodes(tree)}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in docs
            and any(m in node.value for m in TPU_MARKERS)
        ):
            yield node.lineno, node.value


def test_the_scan_finds_a_tpu_string(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text('"""tpu.google.com in a docstring is prose."""\nKEY = "tpu.google.com/x"\n')
    assert list(_tpu_strings(sample)) == [(2, "tpu.google.com/x")]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_constant_of_the_port_names_the_tpu_fleet(path):
    assert list(_tpu_strings(path)) == []


@pytest.fixture()
def port_globals():
    """The port's process-global state, fresh for each test, as
    tests/conftest.py keeps the JAX package's: the component name, the
    default tracer, flight recorder and decision log, the span observer
    and default profiler, and the topology label keys.  Other files use
    it as ``pytestmark = pytest.mark.usefixtures("port_globals")`` after
    importing it."""
    from k8s_operator_libs_tpu_torch.obs import events, profiling, tracing
    from k8s_operator_libs_tpu_torch.tpu import topology
    from k8s_operator_libs_tpu_torch.upgrade import timeline

    util.set_component_name("gpu-driver")
    previous = (
        tracing.set_default_tracer(tracing.Tracer()),
        timeline.set_default_recorder(timeline.FlightRecorder()),
        events.set_default_log(events.DecisionEventLog()),
    )
    observer = tracing.span_observer()
    profiler = profiling.set_default_profiler(profiling.SamplingProfiler())
    yield
    profiling.set_default_profiler(profiler).stop()
    tracing.set_span_observer(observer)
    tracing.set_default_tracer(previous[0])
    timeline.set_default_recorder(previous[1])
    events.set_default_log(previous[2])
    topology.set_label_keys()
    util.set_component_name("gpu-driver")


@pytest.fixture()
def close_every_client(monkeypatch):
    """Close each port ``KubeApiClient`` a test makes when it ends, and
    check that its held watch threads stopped: no socket or thread
    outlives its test.  Used like :func:`port_globals`."""
    from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeApiClient

    made = []
    init = KubeApiClient.__init__

    def tracking(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(KubeApiClient, "__init__", tracking)
    yield made
    for client in made:
        watchers = list(client._held_watchers)
        client.close()
        assert not [w.name for w in watchers if w.is_alive()]
