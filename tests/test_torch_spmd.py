"""The port's sharded train step (the SPMD part of
k8s_operator_libs_tpu_torch/tpu/workload.py, ring_attention_sharded, and the
drain that saves a sharded model) against the JAX package's jitted step on
its (data, seq, model, expert) mesh.

The port runs as four gloo ranks on the CPU, real processes started once
for the file by the port's worker (``dist_worker spmd``): every
configuration below, from the port's seed-0 weights, on the meshes
dp 1 x sp 2 x tp 2, dp 2 x tp 2 and dp 2 x sp 2 (built in turn in that
one group).  Each
rank reports its losses, its plan, its shard shapes and the workload's
warnings; the gradients of the first step come back gathered to the full
state_dict.  The JAX side takes the same weights (``convert.params_to_jax``)
on ``make_mesh(n_devices=4, ...)`` of the conftest's CPU devices, with
Pallas in interpret mode; the port's flash pairs run the kernels' plain
versions.  Tolerances are the JAX suite's: losses and gradients 1e-4
(``tests/test_tpu_integration.py:570-611``, ``:1080``, ``:1217``), ring
against gather 1e-5 on the loss, remat against no remat 1e-6 on the loss
and 1e-4 on the gradients (``:1241``).
"""

import dataclasses
import json
import uuid

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from k8s_operator_libs_tpu.cluster import ApiServerFacade, InMemoryCluster
from k8s_operator_libs_tpu.cluster.objects import make_node
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu.upgrade import consts, util
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
from k8s_operator_libs_tpu_torch.tpu import ring_attention as ra
from k8s_operator_libs_tpu_torch.tpu import workload as wl

N = 4  # ranks
DEADLINE = 240
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=33)
SEQ = dict(TINY, seq_axis="seq")
RING = dict(SEQ, ring_attention=True)
RING_FLASH = dict(RING, ring_flash=True)
#: test_sharded_train_step_on_mesh and test_sequence_parallel_train_step's
#: config: 15 positions after the shift, which sp 2 does not divide
JAX_TEST = dict(vocab_size=128, n_heads=4, n_layers=2, d_model=32, d_ff=64, max_seq_len=16)

#: name -> (mesh (dp, sp, tp), ModelConfig fields, steps, extra run keys).
#: Every run with "grads" is held to the JAX mesh step, or where SAME_AS
#: names another run, to that run.
RUNS = {
    "gather-sp": ((1, 2, 2), SEQ, 2, {"grads": True}),
    "ring": ((1, 2, 2), RING, 6, {"grads": True}),
    "ring-flash": ((1, 2, 2), RING_FLASH, 2, {"grads": True}),
    "zigzag": ((1, 2, 2), dict(RING_FLASH, ring_layout="zigzag"), 2, {"grads": True}),
    "remat-ring-flash": ((1, 2, 2), dict(RING_FLASH, remat=True), 2, {"grads": True}),
    "seq-replicated": ((1, 2, 2), TINY, 2, {"grads": True}),
    # the loud fallbacks, each on its path
    "ring-indivisible": ((1, 2, 2), dict(RING, max_seq_len=32), 1, {"grads": True}),
    "zigzag-odd": ((1, 2, 2), dict(RING_FLASH, ring_layout="zigzag", max_seq_len=35), 1,
                   {"grads": True}),
    "flash-sp": ((1, 2, 2), dict(SEQ, flash_attention=True), 1, {"grads": True}),
    "sp-learns": ((1, 2, 2), dict(JAX_TEST, seq_axis="seq"), 4, {"batch": 4, "fixed_batch": True}),
    "drain": ((1, 2, 2), RING_FLASH, 5, {"drain": True}),
    # the second mesh
    "tp-flash": ((2, 1, 2), dict(TINY, flash_attention=True), 2, {"grads": True}),
    "dp-tp": ((2, 1, 2), JAX_TEST, 1, {}),
    # the third: gradients summed over a (data, seq) group of its own
    "dp-sp-ring-flash": ((2, 2, 1), RING_FLASH, 1, {"grads": True}),
}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Every run over one group of four gloo ranks, the drain's node
    patched to "requested" before the job starts (so it drains at the
    first poll, after one step).  Returns (JSON line by rank, gathered
    gradients by run, the node's annotation after the job, the
    checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("spmd")
    runs = [{"name": name, "mesh": list(mesh), "config": fields, "steps": steps, **extra}
            for name, (mesh, fields, steps, extra) in RUNS.items()]
    (tmp / "runs.json").write_text(json.dumps({"runs": runs}))
    store = InMemoryCluster()
    store.create(make_node("gpu-host-0"))
    key = util.get_pre_drain_checkpoint_annotation_key()
    token = uuid.uuid4().hex[:12]
    store.patch("Node", "gpu-host-0", {"metadata": {"annotations": {
        key: f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}"}}})
    facade = ApiServerFacade(store).start()
    env = {"FACADE_URL": facade.url, "DRAIN_NODE_NAME": "gpu-host-0",
           "DRAIN_CKPT_DIR": str(tmp / "ckpt")}
    args = ["spmd", "--device", "cpu", "--inputs", str(tmp / "runs.json"),
            "--out", str(tmp / "rank{rank}.pt")]
    try:
        with Ranks(N, args, env) as ranks:
            lines = ranks.results(DEADLINE)
    finally:
        facade.stop()
    ack = store.get("Node", "gpu-host-0")["metadata"]["annotations"].get(key)
    grads = torch.load(tmp / "rank0.pt", weights_only=True)
    return lines, grads, (ack, token), tmp / "ckpt" / "drain"


def _runs(job, name):
    return [line["runs"][name] for line in job[0]]


@pytest.fixture(scope="module")
def weights():
    """The port's seed-0 weights of each configuration's widths, as the
    flax tree."""
    cache = {}

    def get(fields):
        cfg = wl.ModelConfig(**{k: v for k, v in fields.items() if k in ("vocab_size", "d_model",
                                "n_heads", "n_layers", "d_ff", "max_seq_len")})
        key = dataclasses.astuple(cfg)
        if key not in cache:
            cache[key] = params_to_jax(wl.TinyLM(cfg, device="cpu", seed=0).state_dict(), cfg.n_heads)
        return cache[key]

    return get


def _jax_step(name, np_params, n_devices=N):
    """(loss, gradients in the port's layout) of the JAX step's
    ``value_and_grad`` on the run's mesh, sharding flag and batch; with
    *n_devices* 1, of the unsharded model on one device."""
    (dp, sp, tp), fields, _, extra = RUNS[name]
    cfg = jwl.ModelConfig(**fields)
    if n_devices == 1:
        dp = sp = tp = 1
    mesh = jwl.make_mesh(n_devices=n_devices, dp=dp, tp=tp, sp=sp)
    model = jwl.TinyLM(cfg)
    tokens = jwl.make_batch(cfg, extra.get("batch", 8), seed=0)

    def loss_and_grads(params, tokens):
        tokens = jax.lax.with_sharding_constraint(tokens, NamedSharding(mesh, P("data", cfg.seq_axis)))
        # what make_train_step's step sets around its value_and_grad
        jwl._seq_sharding_flag.on, jwl._seq_sharding_flag.mesh = True, mesh
        try:
            return jax.value_and_grad(lambda p: jwl.loss_fn(model, p, tokens))(params)
        finally:
            jwl._seq_sharding_flag.on, jwl._seq_sharding_flag.mesh = False, None

    with mesh:
        params = jwl.shard_params(jax.tree.map(jax.numpy.asarray, np_params), mesh)
        loss, grads = jax.jit(loss_and_grads)(params, tokens)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _max_grad_err(got, want) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max()) for k in want)


#: fallbacks that take another run's path on the same weights and batch
SAME_AS = {"flash-sp": "gather-sp", "seq-replicated": "gather-sp"}
GRADS = [name for name, (*_, extra) in RUNS.items() if extra.get("grads") and name not in SAME_AS]
#: The JAX mesh step pads a sequence that the seq axis does not divide;
#: at 31 positions on sp 2 its embedding gradients then differ from its
#: own one-device gradients by 0.0298 (every other leaf within 1e-7), and
#: the port's replicated sequence matches the one-device ones.
UNEVEN = {"ring-indivisible"}


@pytest.mark.parametrize("name", GRADS)
def test_step_loss_and_gathered_gradients_match_the_jax_mesh_step(job, weights, name):
    """Each configuration's first step: the loss identical on every rank
    and within 1e-4 of the JAX mesh step, the gathered gradients within
    1e-4 of ``jax.grad`` there (of the unsharded model for an uneven
    split), on the same weights and batch."""
    rows = _runs(job, name)
    losses = [row["losses"] for row in rows]
    assert all(x == losses[0] for x in losses), losses
    loss, grads = _jax_step(name, weights(RUNS[name][1]))
    assert abs(losses[0][0] - loss) < 1e-4, (losses[0][0], loss)
    if name in UNEVEN:
        grads = _jax_step(name, weights(RUNS[name][1]), n_devices=1)[1]
    assert _max_grad_err(job[1][name], grads) < 1e-4


def test_sharded_train_step_on_mesh(job):
    """test_sharded_train_step_on_mesh (dp x tp), ported: every parameter's
    shard follows param_partition_spec, mlp_up split on its output (the
    JAX test's ``P(None, "model")`` on the flax kernel), and the step
    runs."""
    full = wl.TinyLM(wl.ModelConfig(**JAX_TEST), device="cpu").state_dict()
    for row in _runs(job, "dp-tp"):
        for key, shape in row["shard_shapes"].items():
            want = list(full[key].shape)
            dim = wl.param_partition_spec(key)
            if dim is not None:
                want[dim] //= 2
            assert shape == want, (key, shape, want)
        assert row["shard_shapes"]["block_0.mlp_up.weight"] == [JAX_TEST["d_ff"] // 2, JAX_TEST["d_model"]]
        assert row["index"]["model"] in (0, 1) and row["losses"][0] > 0


def test_sequence_parallel_train_step(job):
    """test_sequence_parallel_train_step, ported: on a dp x sp x tp mesh the
    step overfits a fixed batch.  Its 15 positions do not divide over sp
    2: the sequence replicates over the seq axis, once and loudly."""
    rows = _runs(job, "sp-learns")
    losses = rows[0]["losses"]
    assert all(row["losses"] == losses for row in rows)
    assert losses[-1] < losses[0], losses
    assert rows[0]["plan"] == {"tier": "gather", "seq_split": False, "use_flash": False,
                               "layout": "contiguous", "block": 128}
    for row in rows:
        assert len(row["warnings"]) == 1 and "replicates over that axis" in row["warnings"][0]


def test_tinylm_ring_equals_gather_on_identical_weights(job):
    """The ring and gather SP modes from the same weights: the same loss
    (1e-5), and through the update, the same second-step loss (1e-4)."""
    ring, gather = _runs(job, "ring")[0], _runs(job, "gather-sp")[0]
    assert (ring["plan"]["tier"], gather["plan"]["tier"]) == ("ring", "gather")
    assert abs(ring["losses"][0] - gather["losses"][0]) < 1e-5
    assert abs(ring["losses"][1] - gather["losses"][1]) < 1e-4
    assert _max_grad_err(job[1]["ring"], job[1]["gather-sp"]) < 1e-4


def test_ring_trains_multiple_steps(job):
    losses = _runs(job, "ring")[0]["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # it actually learns


def test_tinylm_ring_flash_equals_einsum_ring(job):
    flash, einsum = _runs(job, "ring-flash")[0], _runs(job, "ring")[0]
    assert flash["plan"] == {"tier": "ring", "seq_split": True, "use_flash": True,
                             "layout": "contiguous", "block": 16}
    assert abs(flash["losses"][0] - einsum["losses"][0]) < 1e-4


def test_tinylm_zigzag_ring_equals_contiguous(job):
    zigzag, contiguous = _runs(job, "zigzag"), _runs(job, "ring-flash")
    assert zigzag[0]["plan"]["layout"] == "zigzag" and zigzag[0]["plan"]["block"] == 8
    assert all(abs(a - b) < 1e-4 for a, b in zip(zigzag[0]["losses"], contiguous[0]["losses"]))
    assert _max_grad_err(job[1]["zigzag"], job[1]["ring-flash"]) < 1e-4
    # the balanced schedule: every rank computes the same pairs
    assert {row["pairs"] for row in zigzag} == {len(ra.ring_schedule(2, 0, True, "zigzag"))}
    assert [row["pairs"] for row in contiguous] == [row["index"]["seq"] + 1 for row in contiguous]


def test_remat_matches_unremat_loss_and_grads_on_the_mesh(job):
    remat, plain = _runs(job, "remat-ring-flash")[0], _runs(job, "ring-flash")[0]
    assert all(abs(a - b) < 1e-6 for a, b in zip(remat["losses"], plain["losses"]))
    assert _max_grad_err(job[1]["remat-ring-flash"], job[1]["ring-flash"]) < 1e-4


@pytest.mark.parametrize("name,plan,warning", [
    ("ring-indivisible", {"tier": "gather", "seq_split": False}, "ring_attention requested but seq length 31"),
    ("zigzag-odd", {"tier": "ring", "seq_split": True, "use_flash": False, "layout": "contiguous"},
     "ring_flash(zigzag): flash block 8 does not tile the local sequence 17"),
    ("flash-sp", {"tier": "gather", "seq_split": True}, "flash_attention=True but sequence sharding"),
    ("seq-replicated", {"tier": "gather", "seq_split": False}, None),
])
def test_each_fallback_warns_on_every_rank_and_takes_its_path(job, name, plan, warning):
    for row in _runs(job, name):
        assert {k: row["plan"][k] for k in plan} == plan
        if warning is None:
            assert row["warnings"] == []
        else:
            assert len(row["warnings"]) == 1 and warning in row["warnings"][0], row["warnings"]
    if name in SAME_AS:  # the path it fell to, on the same weights and batch
        other = _runs(job, SAME_AS[name])[0]["losses"]
        assert all(abs(a - b) < 1e-6 for a, b in zip(_runs(job, name)[0]["losses"], other))
        assert _max_grad_err(job[1][name], job[1][SAME_AS[name]]) < 1e-5


def test_every_rank_reports_its_place_and_gloo(job):
    lines = job[0]
    assert [line["rank"] for line in lines] == list(range(N))
    for rank, line in enumerate(lines):
        assert line["backend"] == "gloo"
        # dp 1 x sp 2 x tp 2, rank-major as the JAX mesh's device order
        assert line["runs"]["ring"]["index"] == {"data": 0, "seq": rank // 2, "model": rank % 2, "expert": 0}
        assert line["runs"]["tp-flash"]["index"] == {"data": rank // 2, "seq": 0, "model": rank % 2,
                                                     "expert": 0}
        for row in line["runs"].values():
            # the CPU runs the plain versions: no kernel launch counts
            assert set(row["launches"].values()) == {0} and row["device_launches"] == {}
            assert row["transport"] == "gloo"


def test_drain_on_the_mesh_saves_a_full_checkpoint_a_single_device_restores(job):
    """Every rank stops at the same step (the request stood before the
    job: the first poll, after one step), the ack comes after the
    barrier, and the coordinator's checkpoint is the FULL state: a
    one-device trainer restored from it takes the mesh's next step
    within 1e-4."""
    rows = _runs(job, "drain")
    ack, token = job[2]
    assert ack == f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}"
    assert {(row["drained"], row["stopped_at_step"]) for row in rows} == {(True, 1)}
    assert len({row["next_loss"] for row in rows}) == 1
    cfg = wl.ModelConfig(**RING_FLASH)
    state = wl.restore_checkpoint(str(job[3]), 1)
    full = wl.TinyLM(dataclasses.replace(cfg, seq_axis=None), device="cpu").state_dict()
    assert {k: v.shape for k, v in state["model"].items()} == {k: v.shape for k, v in full.items()}
    for moments in state["optimizer"]["state"].values():
        assert moments["exp_avg"].shape == moments["exp_avg_sq"].shape
    trainer = wl.CheckpointingTrainer(dataclasses.replace(cfg, seq_axis=None), str(job[3]), device="cpu")
    trainer.load(state)
    trainer.run(1)
    assert abs(trainer.losses[0] - rows[0]["next_loss"]) < 1e-4, (trainer.losses, rows[0]["next_loss"])
