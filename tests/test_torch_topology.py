"""The port's NVLink-domain topology (k8s_operator_libs_tpu_torch/tpu/
topology.py) against the JAX package's tpu/topology.py.

* the classes of ``tests/test_topology.py``, as cases of the same names,
  run on the port in its vocabulary;
* a differential test: seeded fleets, labelled in the JAX package's
  vocabulary and rewritten by :func:`test_torch_vocab.to_port_vocab`, go
  through every function of both modules, which must agree.
"""

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.tpu import topology as jtopology
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu_torch.cluster.objects import make_node, set_condition
from k8s_operator_libs_tpu_torch.tpu import topology
from k8s_operator_libs_tpu_torch.upgrade import consts

from test_torch_vocab import port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

from k8s_operator_libs_tpu_torch.cluster.objects import make_node


from k8s_operator_libs_tpu_torch.tpu import topology


from k8s_operator_libs_tpu_torch.upgrade import consts


SLICE_KEY = consts.SLICE_ID_LABEL_KEYS[0]


GKE_KEY = consts.SLICE_ID_LABEL_KEYS[1]


GROUP_KEY = consts.MULTISLICE_GROUP_LABEL_KEYS[0]


class TestDomains:
    def test_slice_label_priority_order(self):
        node = make_node("n1", labels={SLICE_KEY: "a", GKE_KEY: "b"})
        assert topology.slice_id_of(node) == "a"  # first key wins

    def test_gke_label_fallback(self):
        node = make_node("n1", labels={GKE_KEY: "b"})
        assert topology.slice_id_of(node) == "b"

    def test_unlabeled_node_is_singleton_domain(self):
        node = make_node("solo")
        assert topology.slice_id_of(node) is None
        assert topology.domain_of(node) == "node:solo"
        assert topology.is_singleton_domain(topology.domain_of(node))

    def test_group_by_domain(self):
        nodes = [
            make_node("a1", labels={SLICE_KEY: "s-a"}),
            make_node("a2", labels={SLICE_KEY: "s-a"}),
            make_node("b1", labels={SLICE_KEY: "s-b"}),
            make_node("solo"),
        ]
        groups = topology.group_by_domain(nodes)
        assert {k: len(v) for k, v in groups.items()} == {
            "s-a": 2,
            "s-b": 1,
            "node:solo": 1,
        }


class TestMultisliceGroups:
    """A DCN-coupled multislice job is one atomic domain: draining any
    member slice kills the whole job, so the group label outranks the
    slice label."""

    def test_group_label_outranks_slice_label(self):
        node = make_node("n1", labels={SLICE_KEY: "s-a", GROUP_KEY: "job-7"})
        assert topology.multislice_group_of(node) == "job-7"
        assert topology.domain_of(node) == "msgroup:job-7"

    def test_two_slices_of_one_job_share_a_domain(self):
        nodes = [
            make_node("a1", labels={SLICE_KEY: "s-a", GROUP_KEY: "job-7"}),
            make_node("a2", labels={SLICE_KEY: "s-a", GROUP_KEY: "job-7"}),
            make_node("b1", labels={SLICE_KEY: "s-b", GROUP_KEY: "job-7"}),
            make_node("c1", labels={SLICE_KEY: "s-c"}),  # independent slice
        ]
        groups = topology.group_by_domain(nodes)
        assert {k: len(v) for k, v in groups.items()} == {
            "msgroup:job-7": 3,
            "s-c": 1,
        }
        assert topology.count_domains(nodes) == 2

    def test_group_name_never_collides_with_slice_name(self):
        grouped = make_node("g", labels={GROUP_KEY: "alpha"})
        sliced = make_node("s", labels={SLICE_KEY: "alpha"})
        assert topology.domain_of(grouped) != topology.domain_of(sliced)

    def test_one_sick_host_poisons_whole_job_group(self):
        nodes = [
            make_node("a1", labels={SLICE_KEY: "s-a", GROUP_KEY: "job-7"},
                      ready=False),
            make_node("b1", labels={SLICE_KEY: "s-b", GROUP_KEY: "job-7"}),
            make_node("c1", labels={SLICE_KEY: "s-c"}),
        ]
        # the sick host takes down job-7's entire domain; slice s-c is fine
        assert topology.count_unavailable_domains(nodes) == 1

    def test_gke_group_label_fallback(self):
        # the port has no GKE multislice label: the fallback a GPU fleet
        # has is a policy's own group key
        assert len(consts.MULTISLICE_GROUP_LABEL_KEYS) == 1
        topology.set_label_keys(multislice_keys=["team.example/job"])
        node = make_node("n1", labels={"team.example/job": "ms-2"})
        assert topology.multislice_group_of(node) == "ms-2"


class TestUnavailability:
    def test_cordoned_or_not_ready_is_unavailable(self):
        assert topology.node_is_unavailable(make_node("n", unschedulable=True))
        assert topology.node_is_unavailable(make_node("n", ready=False))
        assert not topology.node_is_unavailable(make_node("n"))

    def test_one_sick_host_poisons_whole_domain(self):
        nodes = [
            make_node("a1", labels={SLICE_KEY: "s-a"}, ready=False),
            make_node("a2", labels={SLICE_KEY: "s-a"}),
            make_node("b1", labels={SLICE_KEY: "s-b"}),
        ]
        assert topology.count_unavailable_domains(nodes) == 1
        assert topology.count_domains(nodes) == 2


def _fleet(seed: int, n: int = 48):
    """Seeded nodes in the JAX vocabulary: slice labels from either key,
    multislice groups, cordons and NotReady conditions."""
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n):
        labels = {}
        r = rng.randint(4)
        if r:
            labels[jconsts.SLICE_ID_LABEL_KEYS[rng.randint(2)]] = f"s{rng.randint(6)}"
        if rng.randint(4) == 0:
            labels[jconsts.MULTISLICE_GROUP_LABEL_KEYS[0]] = f"g{rng.randint(2)}"
        node = jax_make_node(f"n{i:02d}", labels=labels, unschedulable=bool(rng.randint(5) == 0),
                             ready=bool(rng.randint(6)))
        nodes.append(node)
    return nodes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("override", [False, True])
def test_every_function_agrees_with_the_jax_module(seed, override):
    nodes = _fleet(seed)
    ported = to_port_vocab(nodes)
    if override:
        jtopology.set_label_keys(["team.example/rack"], ["team.example/job"])
        topology.set_label_keys(["team.example/rack"], ["team.example/job"])
        for theirs, ours in zip(nodes, ported):
            for side in (theirs, ours):
                side["metadata"].setdefault("labels", {})["team.example/rack"] = "r" + side["metadata"]["name"][-1]
    try:
        # the GKE-only fallbacks (topology and multislice labels) have no
        # GPU-fleet counterpart; the fleet above uses neither
        gke_only = ("cloud.google.com/gke-tpu-topology", "cloud.google.com/gke-tpu-multislice-group")
        for ours, theirs in (
            (topology.effective_slice_keys(), jtopology.effective_slice_keys()),
            (topology.effective_multislice_keys(), jtopology.effective_multislice_keys()),
        ):
            assert ours == to_port_vocab(tuple(k for k in theirs if k not in gke_only))
        for theirs, ours in zip(nodes, ported):
            assert topology.slice_id_of(ours) == jtopology.slice_id_of(theirs)
            assert topology.multislice_group_of(ours) == jtopology.multislice_group_of(theirs)
            assert topology.domain_of(ours) == jtopology.domain_of(theirs)
            assert topology.node_is_unavailable(ours) == jtopology.node_is_unavailable(theirs)
        assert to_port_vocab(jtopology.group_by_domain(nodes)) == topology.group_by_domain(ported)
        assert topology.count_domains(ported) == jtopology.count_domains(nodes)
        assert topology.count_unavailable_domains(ported) == jtopology.count_unavailable_domains(nodes)
    finally:
        jtopology.set_label_keys()


def test_the_gpu_clique_label_names_a_domain():
    node = make_node("h0", labels={"nvidia.com/gpu.clique": "rack-7"})
    assert topology.domain_of(node) == "rack-7"
    sick = make_node("h1", labels={"nvidia.com/gpu.clique": "rack-7"})
    set_condition(sick, "Ready", "False")
    assert topology.count_unavailable_domains([node, sick]) == 1
