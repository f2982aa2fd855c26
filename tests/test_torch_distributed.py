"""The port's multi-process path (k8s_operator_libs_tpu_torch/tpu/distributed.py,
multihost_trainer.py, the data-parallel train step of workload.py and
cluster/kubeclient.py) against the JAX package's.

Ranks are real processes over gloo on the CPU, started by the port's own
worker (``python -m k8s_operator_libs_tpu_torch.hack.dist_worker``) with a
free port for the rendezvous and a deadline on every wait; each fixture
starts one group and every case reads its results.  The collectives of
one rank run in this process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.cluster import errors, inmem
from k8s_operator_libs_tpu_torch.cluster.objects import make_node as port_make_node
from k8s_operator_libs_tpu_torch.cluster.apiserver import ApiServerFacade
from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeApiClient, KubeConfig
from k8s_operator_libs_tpu_torch.convert import params_to_jax
from k8s_operator_libs_tpu_torch.hack import dist_worker
from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
from k8s_operator_libs_tpu_torch.tpu import distributed as D
from k8s_operator_libs_tpu_torch.tpu import multihost_trainer as mt
from k8s_operator_libs_tpu_torch.tpu import workload as wl

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
#: seconds a group of ranks may take, start to exit
DEADLINE = 180


def _env(rank="0", world="1", **extra):
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": world,
            "RANK": rank, **extra}


# ------------------------------------ identity (TestResolveIdentity, ported)


def test_explicit_env():
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4", "RANK": "2"}
    assert D.resolve_identity(env) == ("10.0.0.1:1234", 4, 2)


@pytest.mark.parametrize("hostname,rank", [("tpu-worker-5", 5), ("trainer-0", 0), ("gpu-host-12", 12)])
def test_statefulset_ordinal_fallback(hostname, rank):
    env = {"MASTER_ADDR": "head", "MASTER_PORT": "1234", "WORLD_SIZE": "16", "HOSTNAME": hostname}
    assert D.resolve_identity(env)[2] == rank


@pytest.mark.parametrize(
    "env,match",
    [
        ({"WORLD_SIZE": "2"}, "coordinator"),
        ({"MASTER_ADDR": "h", "WORLD_SIZE": "2", "RANK": "0"}, "MASTER_PORT"),
        ({"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "many"}, "integer"),
        ({"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "2", "HOSTNAME": "nodename"}, "ordinal"),
        ({"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "2", "HOSTNAME": "no-trailing-number-"},
         "ordinal"),
        ({"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "2"}, "world size"),
        ({"MASTER_ADDR": "c", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "7"}, "world size"),
    ],
    ids=["no-coordinator", "no-port", "world-not-int", "no-ordinal", "trailing-dash",
         "rank-at-world", "rank-past-world"],
)
def test_identity_errors(env, match):
    with pytest.raises(ValueError, match=match):
        D.resolve_identity(env)


def test_ordinal_matches_the_jax_module():
    from k8s_operator_libs_tpu.tpu.distributed import _ordinal_from_hostname

    for name in ("a-1", "tpu-worker-17", "x", "x-", "a-b-3", "n-007"):
        assert D._ordinal_from_hostname(name) == _ordinal_from_hostname(name), name


def test_initialize_from_env_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.initialize_from_env(_env())
    assert not dist.is_initialized()


# ------------------------------------------- one rank in this process


@pytest.fixture(scope="module")
def one_rank():
    env = _env(MASTER_PORT=str(dist_worker.free_port()))
    assert D.initialize_from_env(env, device="cpu") == (0, 1)
    yield env
    dist.destroy_process_group()


def test_initialize_twice_raises(one_rank):
    with pytest.raises(RuntimeError, match="already initialized"):
        D.initialize_from_env(one_rank, device="cpu")
    assert dist.get_backend() == "gloo"


def test_global_mesh_axes_and_validation(one_rank):
    mesh = D.global_mesh()
    assert mesh.mesh_dim_names == ("data", "seq", "model", "expert")
    assert tuple(mesh.shape) == (1, 1, 1, 1) and mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="global devices"):
        D.global_mesh(dp=3, tp=2)
    with pytest.raises(ValueError, match="global devices"):
        D.global_mesh(tp=2)


def test_host_allreduce_max_single_process(one_rank):
    assert D.host_allreduce_max(0.0) == 0.0
    assert D.host_allreduce_max(2.0) == 2.0
    # the cached one-element tensor: a second call reuses it
    assert D.host_allreduce_max(1.0) == 1.0
    assert len({id(t) for (kind, _), t in D._scalars.items() if kind == "max"}) == 1


def test_sync_global_devices_single_process(one_rank):
    D.sync_global_devices("coverage-barrier")  # must simply not hang


def test_a_mesh_wider_than_data_is_not_ported(one_rank):
    # every axis is ported now: the data, seq and model axes
    # (tests/test_torch_spmd.py) and the expert axis
    # (tests/test_torch_moe_spmd.py).  On a (data 1, expert 2) mesh an MoE
    # model builds with its half of the experts, the router whole
    class Mesh:  # seen through the calls the model makes
        def __getitem__(self, name):
            return type("Dim", (), {"size": lambda self: 2 if name == "expert" else 1})()

        def get_local_rank(self, name):
            return 1 if name == "expert" else 0

        def get_group(self, name):
            return dist.group.WORLD

    cfg = wl.ModelConfig(**TINY, n_experts=4)
    model, opt = wl.create_train_state(cfg, "cpu", mesh=Mesh())
    full = wl.TinyLM(cfg, "cpu").state_dict()
    assert model.spmd.ep == 2 and model.spmd.expert_index == 1
    assert torch.equal(model.block_0.moe.experts_up.detach(), full["block_0.moe.experts_up"][2:])
    assert torch.equal(model.block_1.moe.router.weight.detach(), full["block_1.moe.router.weight"])
    model, opt = wl.create_train_state(cfg, "cpu")
    with pytest.raises(ValueError, match="not built on this mesh"):
        wl.make_train_step(model, opt, Mesh())


def test_one_rank_data_parallel_step_equals_the_plain_step(one_rank):
    cfg = wl.ModelConfig(**TINY)
    losses = {}
    for with_mesh in (False, True):
        mesh = D.global_mesh() if with_mesh else None
        model, opt = wl.create_train_state(cfg, "cpu", seed=0, mesh=mesh)
        step = wl.make_train_step(model, opt, mesh)
        losses[with_mesh] = [float(step(wl.make_batch(cfg, 8, seed=i))) for i in range(2)]
    assert losses[True] == losses[False]


# ----------------------- the mesh over four ranks (tp=2, as the JAX test)


@pytest.fixture(scope="module")
def four_rank_mesh():
    with Ranks(4, ["mesh", "--device", "cpu", "--tp", "2"]) as ranks:
        return ranks.results(DEADLINE)


def test_global_mesh_over_four_ranks(four_rank_mesh):
    for rank, line in enumerate(four_rank_mesh):
        assert (line["rank"], line["world_size"], line["backend"]) == (rank, 4, "gloo")
        assert line["mesh"] == {"names": ["data", "seq", "model", "expert"], "shape": [2, 1, 2, 1]}
        assert line["allreduce_max"] == 3.0  # the largest rank's value reached every rank


# --------- test_two_process_data_parallel_train_step_agrees, ported


@pytest.fixture(scope="module")
def two_rank_train():
    with Ranks(2, ["train", "--device", "cpu", "--steps", "3"]) as ranks:
        return ranks.results(DEADLINE)


def test_two_process_data_parallel_losses_are_identical(two_rank_train):
    by_rank = {line["rank"]: line for line in two_rank_train}
    assert set(by_rank) == {0, 1}
    for line in two_rank_train:
        assert line["world_size"] == 2 and line["backend"] == "gloo"
        assert len(line["losses"]) == 3 and all(x > 0 for x in line["losses"])
    # the collective proof: the all-reduced loss sequence is identical
    assert by_rank[0]["losses"] == by_rank[1]["losses"], by_rank


def test_two_process_losses_equal_the_jax_mesh_step(two_rank_train):
    """The JAX step on this process's 8-device data mesh, from the port's
    seed-0 weights carried across by convert.py, on the same global
    batches: within 1e-4 (the JAX suite's loss tolerance)."""
    cfg = jwl.ModelConfig(**TINY)
    torch_model = wl.TinyLM(wl.ModelConfig(**TINY), device="cpu", seed=0)
    np_params = params_to_jax(torch_model.state_dict(), TINY["n_heads"])
    mesh = jwl.make_mesh(n_devices=8, dp=8, tp=1)
    with mesh:
        model, _, tx, _ = jwl.create_train_state(cfg, mesh)
        params = jwl.shard_params(jax.tree.map(jnp.asarray, np_params), mesh)
        opt = tx.init(params)
        step = jwl.make_train_step(model, tx, mesh)
        ref = []
        for i in range(3):
            params, opt, loss = step(params, opt, jwl.make_batch(cfg, 8, seed=i))
            ref.append(float(loss))
    got = two_rank_train[0]["losses"]
    assert np.abs(np.array(got) - np.array(ref)).max() < 1e-4, (got, ref)


# --------------------- test_two_process_checkpoint_on_drain, ported


def test_two_process_checkpoint_on_drain(tmp_path):
    """The JAX orchestrator's facade over its in-memory cluster; the port's
    two-rank job drains through it.  The drain is requested once rank 0
    reports step 3; both ranks stop at one step, the node carries
    ``done:e2e-1``, and the port's restore finds the agreed step, rank 1's
    save in its shadow directory."""
    from k8s_operator_libs_tpu.cluster import ApiServerFacade, InMemoryCluster
    from k8s_operator_libs_tpu.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.upgrade import consts, util  # the workload's keys

    store = InMemoryCluster()
    store.create(make_node("tpu-host-0"))
    facade = ApiServerFacade(store).start()
    ckpt_dir = str(tmp_path / "ckpt")
    env = {"FACADE_URL": facade.url, "DRAIN_NODE_NAME": "tpu-host-0", "DRAIN_CKPT_DIR": ckpt_dir}
    key = util.get_pre_drain_checkpoint_annotation_key()
    try:
        with Ranks(2, ["drain", "--device", "cpu"], env) as ranks:
            ranks.wait_for(0, "] step 3 ", DEADLINE)
            store.patch("Node", "tpu-host-0", {"metadata": {"annotations": {
                key: f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:e2e-1",
            }}})
            results = ranks.results(DEADLINE)
    finally:
        facade.stop()
    by_rank = {r["rank"]: r for r in results}
    assert all(r["drained"] for r in results), by_rank
    stopped = by_rank[0]["stopped_at_step"]
    assert stopped >= 3 and by_rank[1]["stopped_at_step"] == stopped, by_rank
    assert by_rank[0]["final_loss"] == by_rank[1]["final_loss"], by_rank
    assert by_rank[0]["losses"] == by_rank[1]["losses"] and len(by_rank[0]["losses"]) == stopped
    ack = store.get("Node", "tpu-host-0")["metadata"]["annotations"][key]
    assert ack == f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:e2e-1"
    restored = wl.restore_checkpoint(ckpt_dir, stopped)
    assert restored["step"] == stopped
    shadow = wl.restore_checkpoint(mt.shadow_dir(ckpt_dir, 1), stopped)
    assert shadow["step"] == stopped
    for name, value in restored["model"].items():  # replicated state: the same weights
        assert torch.equal(value, shadow["model"][name]), name


# ------------------------------ MultihostDrainLoop with fake collectives


class _Collectives:
    """Stands in for host_allreduce_max / sync_global_devices: records
    every call, and combines this rank's flag with the peers' flags."""

    def __init__(self, peer_flags=None):
        self.calls = []
        self.peer_flags = list(peer_flags or [])

    def allreduce_max(self, value):
        self.calls.append(("max", value))
        peer = self.peer_flags.pop(0) if self.peer_flags else 0.0
        return max(value, peer)

    def barrier(self, name="barrier"):
        self.calls.append(("barrier", name))


class _Watcher:
    def __init__(self, requested_from_poll, events):
        self.polls, self.requested_from_poll, self.events = 0, requested_from_poll, events

    def checkpoint_requested(self):
        self.polls += 1
        return self.requested_from_poll is not None and self.polls >= self.requested_from_poll

    def acknowledge(self):
        self.events.append("ack")


def _loop(monkeypatch, coll, watcher, events, **kw):
    monkeypatch.setattr(mt, "host_allreduce_max", coll.allreduce_max)
    monkeypatch.setattr(mt, "sync_global_devices", coll.barrier)

    def step(state, i):
        events.append(("step", i))
        return state + 1, 0.0

    def save(state, i):
        events.append(("save", state, i))

    return mt.MultihostDrainLoop(step, save, watcher=watcher, **kw)


def test_drain_and_deadline_in_one_poll_is_a_drain(monkeypatch):
    """requested=2 over expired=1: a drain request wins even when a peer's
    wall-clock bound expires in the same poll."""
    events = []
    coll = _Collectives(peer_flags=[0.0, 1.0])  # the peer's deadline, at poll 2
    watcher = _Watcher(requested_from_poll=2, events=events)
    loop = _loop(monkeypatch, coll, watcher, events)
    state, steps, drained = loop.run(0)
    assert (state, steps, drained) == (2, 2, True)
    assert [c for c in coll.calls if c[0] == "max"] == [("max", 0.0), ("max", 2.0)]
    assert ("save", 2, 2) in events


def test_a_peers_deadline_alone_stops_without_a_drain(monkeypatch):
    events = []
    coll = _Collectives(peer_flags=[0.0, 0.0, 1.0])
    loop = _loop(monkeypatch, coll, _Watcher(None, events), events)
    assert loop.run(0) == (3, 3, False)
    assert not any(e[0] == "save" for e in events if isinstance(e, tuple)) and "ack" not in events


def test_own_deadline_is_polled_not_in_the_loop_condition(monkeypatch):
    events = []
    coll = _Collectives()
    loop = _loop(monkeypatch, coll, None, events, max_seconds=0.0)
    assert loop.run(0) == (1, 1, False)
    assert coll.calls == [("barrier", "multihost-loop-start"), ("max", 1.0),
                          ("barrier", "multihost-loop-done")]


def test_poll_every_and_max_steps(monkeypatch):
    events = []
    coll = _Collectives()
    loop = _loop(monkeypatch, coll, None, events, max_steps=7, poll_every=3)
    assert loop.run(0) == (7, 7, False)
    assert [c for c in coll.calls if c[0] == "max"] == [("max", 0.0)] * 2  # after steps 3 and 6


def test_ack_comes_after_the_save_and_the_last_barrier(monkeypatch):
    events = []
    coll = _Collectives()
    watcher = _Watcher(requested_from_poll=3, events=events)
    loop = _loop(monkeypatch, coll, watcher, events)

    def barrier(name="barrier"):
        coll.calls.append(("barrier", name))
        events.append(("barrier", name))

    monkeypatch.setattr(mt, "sync_global_devices", barrier)
    assert loop.run(0) == (3, 3, True)
    assert events[-3:] == [("save", 3, 3), ("barrier", "multihost-loop-done"), "ack"]
    assert events[0] == ("barrier", "multihost-loop-start")


def test_non_coordinators_save_to_a_shadow_dir():
    assert mt.shadow_dir("/ck", 0) == "/ck"
    assert mt.shadow_dir("/ck", 3) == "/ck-shadow-3"


# ------------------------------------------------------------ the client


def test_kube_client_reads_and_patches_the_jax_facade():
    from k8s_operator_libs_tpu.cluster import ApiServerFacade, InMemoryCluster
    from k8s_operator_libs_tpu.cluster.objects import make_node

    store = InMemoryCluster()
    store.create(make_node("n-1"))
    facade = ApiServerFacade(store).start()
    try:
        client = KubeApiClient(KubeConfig(server=facade.url), timeout=10.0)
        node = client.get("Node", "n-1")
        assert node["kind"] == "Node" and node["metadata"]["name"] == "n-1"
        client.patch("Node", "n-1", {"metadata": {"annotations": {"a": "1", "b": "2"}}})
        client.patch("Node", "n-1", {"metadata": {"annotations": {"a": None}}})
        annotations = store.get("Node", "n-1")["metadata"]["annotations"]
        assert annotations.get("b") == "2" and "a" not in annotations
        with pytest.raises(errors.NotFoundError):
            client.get("Node", "missing")
        with pytest.raises(errors.NotFoundError):
            client.patch("Node", "missing", {})
        # the full client reaches every registered kind, not Nodes alone
        with pytest.raises(errors.NotFoundError):
            client.get("Pod", "n-1", "default")
        client.close()
    finally:
        facade.stop()


def test_the_port_node_server_answers_the_client_and_the_watcher():
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
    from k8s_operator_libs_tpu_torch.upgrade import util

    store = inmem.InMemoryCluster()
    store.create(port_make_node("gpu-host"))
    key = util.get_pre_drain_checkpoint_annotation_key()
    with ApiServerFacade(store) as server, KubeApiClient(KubeConfig(server=server.url)) as client:
        watcher = DrainSignalWatcher(client, "gpu-host")
        assert not watcher.checkpoint_requested()
        store.patch("Node", "gpu-host", {"metadata": {"annotations": {key: "requested:t-9"}}})
        saved = []
        assert watcher.check_and_acknowledge(lambda: saved.append(1))
        assert saved == [1]
        assert store.get("Node", "gpu-host")["metadata"]["annotations"][key] == "done:t-9"
        with pytest.raises(errors.NotFoundError):
            client.get("Node", "nope")
        # a watcher on a missing node reads no request
        assert not DrainSignalWatcher(client, "nope").checkpoint_requested()


def test_data_parallel_config_is_the_jax_workers():
    cfg = dist_worker.model_config("tiny", torch.device("cpu"))
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in TINY} == TINY
    smoke = dist_worker.model_config("smoke", torch.device("cpu"))
    assert smoke.flash_attention and (smoke.d_model, smoke.n_layers, smoke.max_seq_len) == (512, 4, 256)
