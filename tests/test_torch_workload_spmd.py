"""The SPMD part of k8s_operator_libs_tpu_torch/tpu/workload.py in one
process: the parameter layout against the JAX package's
``param_partition_spec``, the shard and gather arithmetic, the attention
plan's loud fallbacks, the errors that remain, the zigzag seam's check,
and remat on one device against the JAX package's (the multi-rank paths
are tests/test_torch_spmd.py)."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.tpu import ring_attention as ra
from k8s_operator_libs_tpu_torch.tpu import workload as wl

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=33)


class FakeMesh:
    """A mesh seen through the calls the model makes at construction: a
    model axis of *tp* with this rank at *index*, an expert axis of *ep*;
    no group is ever used."""

    def __init__(self, tp=1, index=0, ep=1) -> None:
        self.sizes = {"data": 1, "seq": 1, "model": tp, "expert": ep}
        self.index = index

    def __getitem__(self, name):
        size = self.sizes[name]
        return type("Dim", (), {"size": lambda self: size})()

    def size(self):
        return self.sizes["model"] * self.sizes["expert"]

    def get_local_rank(self, name):
        return self.index if name == "model" else 0

    def get_group(self, name):
        return None


def _flax_path(key: str):
    """The flax path of torch key *key* (convert's naming)."""
    *mods, leaf = key.split(".")
    return tuple(mods) + ({"weight": "kernel"}.get(leaf, leaf),)


def _jax_split_dim(path, leaf):
    """The torch dimension that the JAX spec's ``model`` entry falls on,
    by side: a flax kernel is [in..., out...] (q/k/v [d, h, hd], out [h,
    hd, d]) and a torch weight [out, in]; an embedding keeps its layout."""
    spec = tuple(jwl.param_partition_spec(path, leaf))
    if "model" not in spec:
        return None
    axis = spec.index("model")
    if path[-1] == "embedding":
        return axis
    out_axes = (leaf.ndim - 1,) if leaf.ndim == 2 or path[-2] == "out" else (1, 2)
    return 0 if axis in out_axes else 1


@pytest.fixture(scope="module")
def model():
    return wl.TinyLM(wl.ModelConfig(**CFG), device="cpu", seed=0)


def test_weight_splits_follow_the_jax_rule(model):
    """Every kernel and embedding splits on the side the JAX spec does
    (torch's weight is flax's kernel transposed); biases and LayerNorms
    follow the port's Megatron roles: a column-parallel bias splits with
    its output, a row-parallel one and LayerNorms replicate."""
    tree = params_to_jax(model.state_dict(), CFG["n_heads"])
    for key, t in model.state_dict().items():
        path = _flax_path(key)
        leaf = tree
        for part in path:
            leaf = leaf[part]
        dim = wl.param_partition_spec(key)
        if path[-1] in ("kernel", "embedding"):
            assert dim == _jax_split_dim(path, jnp.asarray(leaf)), key
        else:
            column = path[-2] in ("query", "key", "value", "mlp_up", "lm_head") and path[-1] == "bias"
            assert dim == (0 if column else None), key
    assert wl.param_partition_spec("block_0.mlp_up.weight") == 0  # the JAX test's P(None, "model")
    assert wl.param_partition_spec("lm_head.weight") == 0  # the vocabulary


def test_shards_are_whole_heads_and_gather_back(model):
    """tp 2: rank r's q/k/v rows and out columns are heads 2r and 2r+1 of
    the flax kernels; the ranks' slices concatenate to the full state."""
    full = model.state_dict()
    tree = params_to_jax(full, CFG["n_heads"])
    shards = [wl.shard_params(full, FakeMesh(tp=2, index=r), CFG["n_heads"]) for r in (0, 1)]
    for r, shard in enumerate(shards):
        heads = slice(2 * r, 2 * r + 2)
        q = np.asarray(tree["block_0"]["attn"]["query"]["kernel"])[:, heads]  # [d, 2, hd]
        assert np.array_equal(shard["block_0.attn.query.weight"].numpy(), q.reshape(q.shape[0], -1).T)
        out = np.asarray(tree["block_1"]["attn"]["out"]["kernel"])[heads]  # [2, hd, d]
        assert np.array_equal(shard["block_1.attn.out.weight"].numpy(), out.reshape(-1, out.shape[-1]).T)
        assert shard["lm_head.bias"].shape == (CFG["vocab_size"] // 2,)
        assert shard["block_0.mlp_down.bias"] is full["block_0.mlp_down.bias"]
    for key, t in full.items():
        dim = wl.param_partition_spec(key)
        got = shards[0][key] if dim is None else torch.cat([s[key] for s in shards], dim)
        assert torch.equal(got, t), key


def test_a_model_axis_that_splits_a_head_raises():
    full = wl.TinyLM(wl.ModelConfig(**dict(CFG, n_heads=2)), device="cpu").state_dict()
    with pytest.raises(ValueError, match=r"param_partition_spec splits attention by whole heads: "
                                         r"n_heads \(2\) is not divisible by the model axis \(4\)"):
        wl.shard_params(full, FakeMesh(tp=4), 2)
    with pytest.raises(ValueError, match="not divisible"):
        wl.TinyLM(wl.ModelConfig(**dict(CFG, n_heads=2)), device="cpu", mesh=FakeMesh(tp=4))
    # the heads divide, mlp_up's 66 rows do not
    full = wl.TinyLM(wl.ModelConfig(**dict(CFG, d_ff=66)), device="cpu").state_dict()
    with pytest.raises(ValueError, match=r"splits block_0.mlp_up.weight on dim 0 \(66\)"):
        wl.shard_params(full, FakeMesh(tp=4), 4)


def test_what_remains_unported_raises_naming_a6b():
    # the MoE and the expert axis are ported; what still raises is JAX's
    # rule that the expert axis divides n_experts (JAX's placement of the
    # expert weights raises ValueError on the same mesh)
    with pytest.raises(ValueError, match="divisible"):
        jwl.create_train_state(jwl.ModelConfig(**CFG, n_experts=3), jwl.make_mesh(n_devices=2, dp=1, tp=1, ep=2))
    with pytest.raises(ValueError, match=r"n_experts \(3\) must be divisible by the mesh's expert axis \(2\)"):
        wl.TinyLM(wl.ModelConfig(**CFG, n_experts=3), device="cpu", mesh=FakeMesh(ep=2))
    wl.TinyLM(wl.ModelConfig(**CFG, n_experts=4), device="cpu", mesh=FakeMesh(ep=2))
    wl.TinyLM(wl.ModelConfig(**CFG), device="cpu", mesh=FakeMesh(ep=2))  # a dense model replicates


def test_a_sharded_model_does_not_decode_and_generate_turns_the_spmd_fields_off():
    cfg = wl.ModelConfig(**CFG)
    prompt = torch.zeros(2, 4, dtype=torch.long)
    sharded = wl.TinyLM(cfg, device="cpu", mesh=FakeMesh(tp=2))
    attn = sharded.block_0.attn
    assert attn.query.weight.shape[0] == 2 * attn.head_dim  # this rank's two heads
    with pytest.raises(ValueError, match="split over a model axis"):
        wl.generate(cfg, sharded, prompt, 2, device="cpu")
    spmd = dataclasses.replace(cfg, seq_axis="seq", ring_attention=True, ring_flash=True,
                               ring_layout="zigzag", remat=True)
    state = wl.TinyLM(cfg, device="cpu").state_dict()
    assert torch.equal(wl.generate(spmd, state, prompt, 3, device="cpu"),
                       wl.generate(cfg, state, prompt, 3, device="cpu"))


def test_a_trainer_on_a_mesh_refuses_a_watcher_of_one_rank(tmp_path):
    """A watcher polled by one rank would stop only that rank, whose
    save (a collective) then waits for ranks that never join."""
    trainer = wl.CheckpointingTrainer(wl.ModelConfig(**CFG), str(tmp_path), watcher=object(),
                                      device="cpu", mesh=FakeMesh(tp=2))
    with pytest.raises(ValueError, match="MultihostDrainLoop"):
        trainer.run(1)
    assert trainer.step == 0


@pytest.mark.parametrize("index", [0, 1])
def test_a_full_checkpoint_loads_into_a_sharded_trainer(tmp_path, index):
    """A one-device trainer's checkpoint, the full state, loads into a
    trainer on a model axis of 2: each parameter and both AdamW moments
    keep this rank's slice by param_partition_spec."""
    cfg = wl.ModelConfig(**CFG)
    one = wl.CheckpointingTrainer(cfg, str(tmp_path), device="cpu")
    one.run(1)
    one.save()
    state = wl.restore_checkpoint(str(tmp_path), 1)
    mesh = FakeMesh(tp=2, index=index)
    sharded = wl.CheckpointingTrainer(cfg, str(tmp_path / "sharded"), device="cpu", mesh=mesh)
    sharded.load(state)
    assert sharded.step == 1
    want = wl.shard_params(one.model.state_dict(), mesh, CFG["n_heads"])
    for name, p in sharded.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        moments = sharded.optimizer.state[p]
        ref = one.optimizer.state[dict(one.model.named_parameters())[name]]
        for key in ("exp_avg", "exp_avg_sq"):
            split = wl.shard_params({name: ref[key]}, mesh, CFG["n_heads"])[name]
            assert torch.equal(moments[key], split), (name, key)


# ------------------------------------------------ the attention plan


def _plan(caplog, fields, seq_len, sp, seq_sharding=True):
    wl._ring_fallback_warned.clear()
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=wl.__name__):
        plan = wl.attention_plan(wl.ModelConfig(**CFG, **fields), seq_len, sp, seq_sharding)
    return plan, [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("fields,seq_len,sp,want,warning", [
    # the tiers
    ({"seq_axis": "seq", "ring_attention": True}, 32, 2, ("ring", True, False, "contiguous", 16), None),
    ({"seq_axis": "seq", "ring_attention": True, "ring_flash": True}, 256, 2,
     ("ring", True, True, "contiguous", 128), None),
    ({"seq_axis": "seq", "ring_attention": True, "ring_flash": True, "ring_layout": "zigzag"}, 256, 2,
     ("ring", True, True, "zigzag", 64), None),
    ({"seq_axis": "seq"}, 32, 2, ("gather", True, False, "contiguous", 128), None),
    # zigzag without ring_flash: the einsum ring, contiguous (the JAX seam's layout rule)
    ({"seq_axis": "seq", "ring_attention": True, "ring_layout": "zigzag"}, 32, 2,
     ("ring", True, False, "contiguous", 16), None),
    # the loud fallbacks
    ({"seq_axis": "seq", "ring_attention": True}, 31, 2, ("gather", False, False, "contiguous", 128),
     "ring_attention requested but seq length 31 is not divisible by the 'seq' mesh axis (size 2)"),
    ({"seq_axis": "seq"}, 15, 2, ("gather", False, False, "contiguous", 128),
     "seq length 15 is not divisible by the 'seq' mesh axis (size 2); the sequence replicates"),
    ({"seq_axis": "seq", "ring_attention": True, "ring_flash": True}, 260, 2,
     ("ring", True, False, "contiguous", 128),
     "ring_flash(contiguous): flash block 128 does not tile the local sequence 130"),
    ({"seq_axis": "seq", "ring_attention": True, "ring_flash": True, "ring_layout": "zigzag"}, 34, 2,
     ("ring", True, False, "contiguous", 8),
     "ring_flash(zigzag): flash block 8 does not tile the local sequence 17"),
    ({"seq_axis": "seq", "flash_attention": True}, 32, 2, ("gather", True, False, "contiguous", 128),
     "flash_attention=True but sequence sharding is active"),
], ids=["ring", "ring-flash", "zigzag", "gather-sp", "zigzag-needs-flash", "ring-indivisible",
        "sp-indivisible", "flash-untileable", "zigzag-odd", "flash-under-sp"])
def test_attention_plan_and_its_loud_fallbacks(caplog, fields, seq_len, sp, want, warning):
    plan, messages = _plan(caplog, fields, seq_len, sp)
    assert dataclasses.astuple(plan) == want
    if warning is None:
        assert messages == []
    else:
        assert len(messages) == 1 and warning in messages[0], messages


def test_the_indivisible_fallback_warns_once_per_shape(caplog):
    fields = {"seq_axis": "seq", "ring_attention": True}
    _plan(caplog, fields, 31, 2)
    cfg = wl.ModelConfig(**CFG, **fields)
    with caplog.at_level(logging.WARNING, logger=wl.__name__):
        caplog.clear()
        wl.attention_plan(cfg, 31, 2, True)
        assert caplog.records == []
        wl.attention_plan(cfg, 33, 2, True)  # another shape warns again
        assert len(caplog.records) == 1


def test_without_sequence_sharding_the_plan_is_one_devices(caplog):
    """dp/tp meshes and one device keep flash; seq_axis without a mesh is
    inert, as the JAX flag is off outside a sharded step."""
    fields = {"seq_axis": "seq", "ring_attention": True, "flash_attention": True}
    assert _plan(caplog, fields, 32, 1, seq_sharding=False) == (wl.AttentionPlan("flash"), [])
    assert _plan(caplog, {}, 32, 1, seq_sharding=False) == (wl.AttentionPlan("gather"), [])


def test_zigzag_requires_flash_and_causal():
    """test_zigzag_requires_flash_and_causal, ported: raised before the
    mesh is read."""
    q = torch.zeros(2, 64, 4, 16)
    with pytest.raises(ValueError, match="requires use_flash=True and causal=True"):
        ra.ring_attention_sharded(q, q, q, None, "seq", causal=False, use_flash=True, layout="zigzag")
    with pytest.raises(ValueError, match="requires use_flash=True and causal=True"):
        ra.ring_attention_sharded(q, q, q, None, "seq", causal=True, use_flash=False, layout="zigzag")
    with pytest.raises(ValueError, match="layout"):
        ra.ring_attention_sharded(q, q, q, None, "seq", layout="striped")


# ------------------------------------------------------------ remat


def test_remat_matches_unremat_loss_and_grads():
    """test_remat_matches_unremat_loss_and_grads, ported: remat leaves the
    state_dict keys and the loss (1e-6) as they were and the gradients
    within 1e-4, all within 1e-4 of the JAX package's remat step on the
    same weights; it composes with the flash seam (1e-3, the JAX test's)."""
    cfg = wl.ModelConfig(**dict(CFG, max_seq_len=32))
    batch = wl.make_batch(cfg, 4, seed=0)

    def loss_and_grads(fields):
        m = wl.TinyLM(dataclasses.replace(cfg, **fields), device="cpu", seed=0)
        loss = wl.loss_fn(m, batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}, m

    l1, g1, plain = loss_and_grads({})
    l2, g2, remat = loss_and_grads({"remat": True})
    assert list(remat.state_dict()) == list(plain.state_dict())
    assert abs(l1 - l2) < 1e-6
    assert max(float((g1[k] - g2[k]).abs().max()) for k in g1) < 1e-4
    l3, _, _ = loss_and_grads({"remat": True, "flash_attention": True})
    assert abs(l1 - l3) < 1e-3

    jcfg = jwl.ModelConfig(**dict(CFG, max_seq_len=32), remat=True)
    params = jax.tree.map(jnp.asarray, params_to_jax(plain.state_dict(), cfg.n_heads))
    jbatch = jwl.make_batch(jcfg, 4, seed=0)
    jl, jg = jax.value_and_grad(lambda p: jwl.loss_fn(jwl.TinyLM(jcfg), p, jbatch))(params)
    jg = params_from_jax(jax.tree.map(np.asarray, jg))
    assert abs(l2 - float(jl)) < 1e-4
    assert max(float((g2[k] - jg[k]).abs().max()) for k in g2) < 1e-4
