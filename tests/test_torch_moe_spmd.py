"""Expert parallelism in the port's sharded train step (MoeMlp on a mesh
with an ``expert`` axis, k8s_operator_libs_tpu_torch/tpu/workload.py)
against the JAX package's jitted step on its (data, seq, model, expert)
mesh.

The port runs as four gloo ranks on the CPU, one job for the file
(``dist_worker spmd``), on dp 1 x tp 2 x ep 2 and dp 2 x tp 1 x ep 2, the
two layouts of test_expert_parallel_moe_train_step's dp 2 x tp 2 x ep 2
that four ranks hold.  The JAX side takes the port's seed-0 weights
(``convert.params_to_jax``) on ``make_mesh(n_devices=4, ...)``.
Tolerances: losses and gathered gradients 1e-4, the JAX suite's.
"""

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
from k8s_operator_libs_tpu_torch.upgrade import consts, util  # the workload's keys
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
from k8s_operator_libs_tpu_torch.tpu import workload as wl

N = 4  # ranks
DEADLINE = 180
#: test_expert_parallel_moe_train_step's config (JAX's default vocab 128
#: and 4 heads)
MOE = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16, n_experts=4)

#: name -> (mesh (dp, sp, tp, ep), ModelConfig fields, steps, extra run keys)
RUNS = {
    "tp-ep": ((1, 1, 2, 2), MOE, 2, {"grads": True}),
    "dp-ep": ((2, 1, 1, 2), MOE, 2, {"grads": True}),
    "tp-ep-flash": ((1, 1, 2, 2), dict(MOE, flash_attention=True), 1, {"grads": True}),
    "tp-ep-learns": ((1, 1, 2, 2), MOE, 4, {"batch": 4, "fixed_batch": True}),
    "dp-ep-learns": ((2, 1, 1, 2), MOE, 4, {"batch": 4, "fixed_batch": True}),
    "drain": ((1, 1, 2, 2), MOE, 5, {"drain": True}),
}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Every run over one group of four gloo ranks, the drain's node
    patched to "requested" before the job starts (it drains at the first
    poll, after one step).  Returns (JSON line by rank, gathered gradients
    by run, (the node's annotation after the job, the token), the
    checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("moe-spmd")
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


def _jax_step(name):
    """(loss, gradients in the port's layout) of the JAX step's
    ``value_and_grad`` on the run's mesh and batch, from the port's seed-0
    weights."""
    (dp, sp, tp, ep), fields, _, extra = RUNS[name]
    cfg = jwl.ModelConfig(**fields)
    np_params = params_to_jax(wl.TinyLM(wl.ModelConfig(**fields), device="cpu", seed=0).state_dict(),
                              fields["n_heads"])
    mesh = jwl.make_mesh(n_devices=N, dp=dp, tp=tp, sp=sp, ep=ep)
    model = jwl.TinyLM(cfg)
    tokens = jwl.make_batch(cfg, extra.get("batch", 8), seed=0)

    def loss_and_grads(params, tokens):
        tokens = jax.lax.with_sharding_constraint(tokens, NamedSharding(mesh, P("data", None)))
        jwl._seq_sharding_flag.on, jwl._seq_sharding_flag.mesh = True, mesh
        try:
            return jax.value_and_grad(lambda p: jwl.loss_fn(model, p, tokens))(params)
        finally:
            jwl._seq_sharding_flag.on, jwl._seq_sharding_flag.mesh = False, None

    with mesh:
        params = jwl.shard_params(jax.tree.map(jax.numpy.asarray, np_params), mesh)
        assert params["block_0"]["moe"]["experts_up"].sharding.spec == P("expert", None, "model")
        loss, grads = jax.jit(loss_and_grads)(params, tokens)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _max_grad_err(got, want) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max()) for k in want)


@pytest.mark.parametrize("name", ["tp-ep", "dp-ep"])
def test_expert_parallel_step_matches_the_jax_mesh_step(job, name):
    """The first step on each layout: the loss identical on every rank and
    within 1e-4 of the JAX mesh step's, the gradients gathered over the
    model and expert groups within 1e-4 of ``jax.grad`` there."""
    rows = _runs(job, name)
    assert all(row["losses"] == rows[0]["losses"] for row in rows)
    loss, grads = _jax_step(name)
    assert abs(rows[0]["losses"][0] - loss) < 1e-4, (rows[0]["losses"][0], loss)
    assert _max_grad_err(job[1][name], grads) < 1e-4


def test_expert_parallel_moe_train_step(job):
    """test_expert_parallel_moe_train_step, ported: the expert tensors
    shard as JAX's P("expert", None, "model") / P("expert", "model",
    None), the router whole, and on either layout the step overfits a
    fixed batch over 4 steps."""
    e, d, f = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
    for name, (tp, ep) in (("tp-ep-learns", (2, 2)), ("dp-ep-learns", (1, 2))):
        rows = _runs(job, name)
        for rank, row in enumerate(rows):
            shapes = row["shard_shapes"]
            assert shapes["block_0.moe.experts_up"] == [e // ep, d, f // tp]
            assert shapes["block_1.moe.experts_down"] == [e // ep, f // tp, d]
            assert shapes["block_0.moe.router.weight"] == [e, d]
            assert row["index"]["expert"] == rank % 2 and row["index"]["model"] == (rank // 2 if tp > 1 else 0)
        losses = rows[0]["losses"]
        assert all(row["losses"] == losses for row in rows)
        assert len(losses) == 4 and losses[-1] < losses[0], (name, losses)


def test_flash_attention_composes_with_expert_parallelism(job):
    """The flash path on the EP mesh takes the gather path's loss and
    gradients on the same weights and batch (1e-4), with no warning."""
    flash, gather = _runs(job, "tp-ep-flash"), _runs(job, "tp-ep")
    assert flash[0]["plan"]["tier"] == "flash" and all(row["warnings"] == [] for row in flash)
    assert abs(flash[0]["losses"][0] - gather[0]["losses"][0]) < 1e-4
    assert _max_grad_err(job[1]["tp-ep-flash"], job[1]["tp-ep"]) < 1e-4


def test_drain_on_an_ep_mesh_saves_a_full_checkpoint_a_single_device_restores(job):
    """Every rank stops at step 1 and the ack comes after the barrier; the
    checkpoint holds the whole experts and both AdamW moments, gathered
    over the model and expert groups, and a one-device trainer restored
    from it takes the mesh's next step within 1e-4."""
    rows = _runs(job, "drain")
    ack, token = job[2]
    assert ack == f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}"
    assert {(row["drained"], row["stopped_at_step"]) for row in rows} == {(True, 1)}
    assert len({row["next_loss"] for row in rows}) == 1
    cfg = wl.ModelConfig(**MOE)
    state = wl.restore_checkpoint(str(job[3]), 1)
    full = wl.TinyLM(cfg, device="cpu").state_dict()
    assert {k: v.shape for k, v in state["model"].items()} == {k: v.shape for k, v in full.items()}
    names = list(full)
    for i, moments in state["optimizer"]["state"].items():
        assert moments["exp_avg"].shape == moments["exp_avg_sq"].shape == full[names[i]].shape
    trainer = wl.CheckpointingTrainer(cfg, str(job[3]), device="cpu")
    trainer.load(state)
    trainer.run(1)
    assert abs(trainer.losses[0] - rows[0]["next_loss"]) < 1e-4, (trainer.losses, rows[0]["next_loss"])
