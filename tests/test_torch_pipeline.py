"""The port's GPipe pipeline (k8s_operator_libs_tpu_torch/tpu/workload.py::
make_pipeline_mesh, stack_block_params, pipeline_blocks_apply,
pipeline_loss_fn, make_pipeline_train_step) against the JAX package's
pipeline and the sequential model.

The port runs as two gloo ranks on the CPU, one job for the file
(``dist_worker pipeline``): one block a stage, the batch of 4 in 2
microbatches, from the port's seed-0 weights.  The sequential port and
JAX's ``pipeline_loss_fn`` on a 2-stage mesh take the same weights
(``convert.params_to_jax``) and batch.  Tolerance 1e-5 on the loss and
the per-layer ``mlp_up`` gradients, the JAX suite's
(``tests/test_tpu_integration.py:404``, ``:415``).
"""

import jax
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_to_jax
from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
from k8s_operator_libs_tpu_torch.tpu import workload as wl

#: the JAX pipeline tests' config (4 heads, JAX's default)
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
STAGES, BATCH, MICRO, STEPS = 2, 4, 2, 5
DEADLINE = 120


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(JSON line by rank, the gradients of pipeline_loss_fn by rank)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    args = ["pipeline", "--device", "cpu", "--config", "tiny", "--steps", str(STEPS),
            "--batch", str(BATCH), "--microbatches", str(MICRO), "--out", str(tmp / "rank{rank}.pt")]
    with Ranks(STAGES, args) as ranks:
        lines = ranks.results(DEADLINE)
    return lines, [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(STAGES)]


@pytest.fixture(scope="module")
def sequential():
    """(loss, gradients) of the sequential port on the seed-0 weights."""
    model = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu", seed=0)
    loss = wl.loss_fn(model, wl.make_batch(wl.ModelConfig(**CFG), BATCH))
    loss.backward()
    return float(loss.detach()), {name: p.grad for name, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_pipeline():
    """(loss, per-layer mlp_up kernel gradients, port layout) of JAX's
    pipeline_loss_fn on a 2-stage mesh from the port's seed-0 weights."""
    cfg = jwl.ModelConfig(**CFG)
    params = params_to_jax(wl.TinyLM(wl.ModelConfig(**CFG), device="cpu", seed=0).state_dict(), CFG["n_heads"])
    stacked, rest = jwl.stack_block_params(jax.tree.map(jax.numpy.asarray, params), CFG["n_layers"])
    mesh = jwl.make_pipeline_mesh(STAGES)
    tokens = jwl.make_batch(cfg, BATCH)
    loss, grads = jax.value_and_grad(lambda sb: jwl.pipeline_loss_fn(cfg, mesh, sb, rest, tokens, MICRO))(stacked)
    kernels = np.asarray(grads["mlp_up"]["kernel"])
    return float(loss), [torch.from_numpy(kernels[i].T.copy()) for i in range(STAGES)]


def test_pipeline_parallel_matches_sequential_exactly(job, sequential, jax_pipeline):
    """test_pipeline_parallel_matches_sequential_exactly, ported: on every
    stage the pipelined loss is the sequential model's and JAX's pipeline's
    (1e-5), and stage i's ``mlp_up`` gradient is layer i's of the
    sequential model and of JAX's pipeline (1e-5)."""
    lines, grads = job
    seq_loss, seq_grads = sequential
    jax_loss, jax_mlp_up = jax_pipeline
    assert [line["stage"] for line in lines] == list(range(STAGES))
    for line in lines:
        assert abs(line["loss"] - seq_loss) < 1e-5 and abs(line["loss"] - jax_loss) < 1e-5
    for stage, g in enumerate(grads):
        got = g["block.mlp_up.weight"]
        assert float((got - seq_grads[f"block_{stage}.mlp_up.weight"]).abs().max()) < 1e-5, stage
        assert float((got - jax_mlp_up[stage]).abs().max()) < 1e-5, stage
        for key, want in seq_grads.items():
            if key.startswith(f"block_{stage}."):
                assert float((g["block." + key.split(".", 1)[1]] - want).abs().max()) < 1e-5, key


def test_every_stage_holds_its_own_block_and_takes_the_same_rest_gradients(job, sequential):
    """A stage holds one block's tensors (no stacked dimension) and the
    replicated rest; the rest's gradients are equal on every stage, so
    every stage's AdamW update of them matches, and equal to the
    sequential model's (1e-5)."""
    lines, grads = job
    full = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu").state_dict()
    for line in lines:
        assert line["shapes"] == {
            **{k.split(".", 1)[1]: list(v.shape) for k, v in full.items() if k.startswith("block_0.")},
            **{k: list(v.shape) for k, v in full.items() if not k.startswith("block_")},
        }
    rest = [k for k in full if not k.startswith("block_")]
    for key in rest:
        assert torch.equal(grads[0][key], grads[1][key]), key
        assert float((grads[0][key] - sequential[1][key]).abs().max()) < 1e-5, key


def test_pipeline_train_step_learns(job):
    """test_pipeline_train_step_learns, ported: 5 pipelined AdamW steps
    overfit the fixed batch, with the same losses on every stage."""
    lines, _ = job
    losses = lines[0]["losses"]
    assert all(line["losses"] == losses for line in lines)
    assert len(losses) == STEPS and losses[-1] < losses[0], losses
    # the CPU runs the plain versions: no kernel launch counts
    assert all(set(line["launches"].values()) == {0} for line in lines)


def test_stack_block_params_stacks_each_block_key_as_jax_does():
    state = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu").state_dict()
    stacked, rest = wl.stack_block_params(state, CFG["n_layers"])
    jstacked, jrest = jwl.stack_block_params(params_to_jax(state, CFG["n_heads"]), CFG["n_layers"])
    assert set(rest) == {"embed.embedding", "pos_embed.embedding", "ln_f.scale", "ln_f.bias",
                         "lm_head.weight", "lm_head.bias"}
    assert set(jrest) == {"embed", "pos_embed", "ln_f", "lm_head"}
    for layer in range(CFG["n_layers"]):
        mine = params_to_jax({f"block_{layer}.{k}": v[layer] for k, v in stacked.items()}, CFG["n_heads"])
        want = jax.tree.map(lambda a: np.asarray(a)[layer], jstacked)
        flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
        for (path, a), (_, b) in zip(flat(mine[f"block_{layer}"]), flat(want)):
            assert np.array_equal(a, b), path


class StageMesh:
    """A ``("stage",)`` mesh of *n* stages, seen through the calls
    pipeline_blocks_apply makes before any transfer."""

    def __init__(self, n: int) -> None:
        self.n = n

    def size(self):
        return self.n


def test_pipeline_rejects_layer_stage_mismatch():
    """test_pipeline_rejects_layer_stage_mismatch, ported: 4 layers on 2
    stages would silently drop layers, so it raises; so does a batch that
    the microbatches do not divide."""
    cfg = wl.ModelConfig(**dict(CFG, n_layers=4))
    stacked, rest = wl.stack_block_params(wl.TinyLM(cfg, device="cpu").state_dict(), cfg.n_layers)
    block = {k: v[0] for k, v in stacked.items()}
    tokens = wl.make_batch(cfg, BATCH)
    with pytest.raises(ValueError, match="one block per stage"):
        wl.pipeline_loss_fn(cfg, StageMesh(2), block, rest, tokens, 2)
    cfg = wl.ModelConfig(**CFG)
    x = torch.zeros(3, CFG["max_seq_len"] - 1, CFG["d_model"])
    with pytest.raises(ValueError, match="batch 3 not divisible into 2 microbatches"):
        wl.pipeline_blocks_apply(cfg, StageMesh(2), block, x, 2)
