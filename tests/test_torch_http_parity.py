"""The port's HTTP stack against the JAX package's, on the same inputs.

The numpy-seeded operation sequence of ``tests/test_torch_cluster.py``
goes, over localhost HTTP, from the JAX package's :class:`KubeApiClient`
to its :class:`ApiServerFacade` and from the port's client to the port's
facade.  After every operation the returned object, the raised error
(class name and status code) and the journal head must agree, as must
the final stores.  Every 40 operations a batch of merge patches goes
through each side's ``batch_write`` (one POST to the batch endpoint),
with per-item results compared.  Agreement is exact after the JAX side
is rewritten into the port's vocabulary and the wall-clock and random
fields are masked (``test_torch_cluster.mask``).

Then the two packages' wires meet: the port's client against the JAX
facade and the JAX client against the port's.  The plain verbs agree;
the batch endpoints live under each package's own API group, so a client
facing the other package's facade degrades to per-op writes, with the
same results.
"""

import numpy as np
import pytest

from k8s_operator_libs_tpu.cluster import ApiServerFacade as JaxFacade
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.cluster import KubeApiClient as JaxClient
from k8s_operator_libs_tpu.cluster import KubeConfig as JaxConfig
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.cluster.objects import make_pod as jax_make_pod
from k8s_operator_libs_tpu.cluster.writepipeline import WriteOp as JaxWriteOp
from k8s_operator_libs_tpu_torch.cluster import ApiServerFacade, InMemoryCluster, KubeApiClient, KubeConfig
from k8s_operator_libs_tpu_torch.cluster.objects import make_node, make_pod
from k8s_operator_libs_tpu_torch.cluster.writepipeline import WriteOp

from test_torch_cluster import N_NODES, N_OPS, _Side, _node_name, make_ops, mask
from test_torch_vocab import close_every_client, port_globals, to_port_vocab  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals", "close_every_client")

WATCHED = ("Node", "Pod")


class _HttpSide(_Side):
    """The op sequence through a client; resourceVersions are read from
    the store behind the facade."""

    def __init__(self, client, store, make_node_, make_pod_, translate, write_op):
        super().__init__(client, make_node_, make_pod_, translate)
        self.store = store
        self.write_op = write_op

    def _rv(self, kind, name, ns, mode):
        current = self.store.resource_version_of(kind, name, ns)
        if mode == "none" or current is None:
            return None
        return current if mode == "fresh" else str(int(current) - 1)

    def apply(self, op):
        c = self.cluster
        if op[0] == "list_page":  # the client pages under list()
            _, kind, selector, limit = op
            c.list_page_size = limit
            try:
                return c.list(kind, None, selector)
            finally:
                c.list_page_size = 0
        if op[0] == "events_since":
            back = min(op[1], len(self.seqs))
            since = self.seqs[-back] if back else c.journal_seq()
            return [(e.type, e.kind, (e.new or e.old)["metadata"]["name"], e.seq)
                    for e in c.events_since(since, kind=WATCHED)]
        return super().apply(op)

    def batch(self, patches):
        ops = [self.write_op("patch", "Node", name, body=self.tr(body)) for name, body in patches]
        return [(obj, None if err is None else (type(err).__name__, getattr(err, "code", None)))
                for obj, err in self.cluster.batch_write(ops)]


def _patches(rng, step):
    return [
        (_node_name(int(rng.randint(N_NODES))),
         {"metadata": {"labels": {"batch": f"b{step}", "rack": None if rng.randint(3) == 0 else "r9"}}})
        for _ in range(int(rng.randint(3, 9)))
    ]


@pytest.fixture()
def sides():
    jax_store, port_store = JaxInMemoryCluster(), InMemoryCluster()
    facades = [JaxFacade(jax_store).start(), ApiServerFacade(port_store).start()]
    jclient = JaxClient(JaxConfig(server=facades[0].url), timeout=10.0)
    client = KubeApiClient(KubeConfig(server=facades[1].url), timeout=10.0)
    try:
        yield (
            _HttpSide(jclient, jax_store, jax_make_node, jax_make_pod, lambda o: o, JaxWriteOp),
            _HttpSide(client, port_store, make_node, make_pod, to_port_vocab, WriteOp),
        )
    finally:
        for facade in facades:
            facade.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_the_port_http_stack_answers_every_op_as_the_jax_one_does(seed, sides):
    jax_side, port_side = sides
    rng = np.random.RandomState(1000 + seed)
    errors = set()
    ops = make_ops(seed)
    assert len(ops) == N_OPS
    for step, op in enumerate(ops):
        theirs = jax_side.outcome(op)
        ours = port_side.outcome(op)
        errors.add(theirs[1])
        assert mask(ours) == mask(to_port_vocab(theirs)), (step, op)
        if step % 40 == 39:
            patches = _patches(rng, step)
            assert mask(port_side.batch(patches)) == mask(to_port_vocab(jax_side.batch(patches))), step
    assert {"AlreadyExistsError", "ConflictError", "NotFoundError", "BadRequestError",
            "TooManyRequestsError", None} <= errors
    # each batch was one POST to the side's own batch endpoint
    assert jax_side.cluster._batch_supported is True and port_side.cluster._batch_supported is True
    assert mask(port_side.store.to_dict()) == mask(to_port_vocab(jax_side.store.to_dict()))


@pytest.mark.parametrize("direction", ["port-client-jax-facade", "jax-client-port-facade"])
def test_each_client_drives_the_other_packages_facade(direction):
    if direction == "port-client-jax-facade":
        store, node, facade = JaxInMemoryCluster(), jax_make_node, JaxFacade
        client_cls, config, write_op = KubeApiClient, KubeConfig, WriteOp
    else:
        store, node, facade = InMemoryCluster(), make_node, ApiServerFacade
        client_cls, config, write_op = JaxClient, JaxConfig, JaxWriteOp
    for i in range(4):
        store.create(node(f"n{i}", labels={"rack": str(i % 2)}))
    server = facade(store).start()
    client = client_cls(config(server=server.url), timeout=10.0)
    try:
        seq = client.journal_seq()
        client.patch("Node", "n0", {"metadata": {"labels": {"x": "1"}}})
        assert [n["metadata"]["name"] for n in client.list("Node", label_selector="rack=0")] == ["n0", "n2"]
        results = client.batch_write([
            write_op("patch", "Node", "n1", body={"metadata": {"labels": {"x": "2"}}}),
            write_op("patch", "Node", "missing", body={"metadata": {"labels": {"x": "3"}}}),
        ])
        assert results[0][1] is None and results[0][0]["metadata"]["labels"]["x"] == "2"
        assert type(results[1][1]).__name__ == "NotFoundError"
        assert client._batch_supported is False  # the other group's endpoint: per-op writes
        events = client.events_since(seq, kind="Node")
        assert [(e.type, e.new["metadata"]["name"]) for e in events] == [("Modified", "n0"), ("Modified", "n1")]
    finally:
        server.stop()
