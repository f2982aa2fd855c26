"""The port's soft-gated MoE on one device (k8s_operator_libs_tpu_torch/tpu/
workload.py::MoeMlp, Int8MoeMlp; convert.py; quantize.py) against the JAX
package's MoeMlp, its weights bridge, its int8 tree and its decode.

The flax params of an MoE TinyLM are carried into the port with
``params_from_jax``, and the same numpy batches and prompts go through
both.  Tolerances: logits, loss and gradients 1e-4 (the JAX suite's);
greedy and int8 tokens exactly, in fp32; the int8 tree's q and s exactly.
The parameter layout of expert parallelism is checked here against JAX's
``param_partition_spec``; its multi-rank step is tests/test_torch_moe_spmd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import quantize as jq
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.tpu import quantize as qz
from k8s_operator_libs_tpu_torch.tpu import workload as wl

#: test_moe_single_device_matches_dense_interface's config (JAX's default
#: vocab 128 and 4 heads) and test_moe_decode_matches_recompute's
SINGLE = dict(n_layers=1, d_model=32, d_ff=64, max_seq_len=16, n_experts=2)
DECODE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16, n_experts=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[SINGLE, DECODE], ids=["e2-single", "e4-decode"])
def case(request):
    """(config fields, flax params as numpy, the flax model)."""
    model, params, _, _ = jwl.create_train_state(jwl.ModelConfig(**request.param))
    return request.param, _np(params), model


def _port(fields, np_params):
    model = wl.TinyLM(wl.ModelConfig(**fields), device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def test_moe_single_device_matches_dense_interface(case):
    """test_moe_single_device_matches_dense_interface, ported and held to
    JAX: on the JAX weights and batch the logits, the loss and every
    gradient within 1e-4; one train step keeps the interface (a positive
    loss) and moves the expert weights."""
    fields, np_params, jmodel = case
    tokens = np.asarray(jwl.make_batch(jwl.ModelConfig(**fields), 4))
    jparams = jax.tree.map(jnp.asarray, np_params)
    loss_j, grads_j = jax.value_and_grad(lambda p: jwl.loss_fn(jmodel, p, jnp.asarray(tokens)))(jparams)
    logits_j = jmodel.apply({"params": jparams}, jnp.asarray(tokens[:, :-1]))
    model = _port(fields, np_params)
    batch = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        assert float((model(batch[:, :-1]) - torch.from_numpy(np.array(logits_j))).abs().max()) < 1e-4
    loss = wl.loss_fn(model, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) < 1e-4
    want = params_from_jax(_np(grads_j))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for key, g in want.items():
        assert float((got[key].grad - g).abs().max()) < 1e-4, key
    before = model.block_0.moe.experts_up.detach().clone()
    optimizer = torch.optim.AdamW(model.parameters(), **wl.ADAMW)
    step_loss = wl.make_train_step(model, optimizer)(batch)
    assert float(step_loss) > 0
    assert (before != model.block_0.moe.experts_up.detach()).any(), "expert weights did not update"


def test_a_bf16_moe_keeps_flax_dtypes_and_trains_like_jax():
    """flax stores the expert tensors in the compute dtype and every other
    leaf in fp32: in a bf16 config the port's parameters carry flax's
    dtype leaf by leaf, AdamW's moments of the experts are bf16 as optax's
    are, and from the JAX weights three steps' losses agree within 2^-7
    (the repo's bf16 bound; 2.0e-3 measured on the CPU)."""
    fields = dict(SINGLE, n_layers=2)
    jcfg = jwl.ModelConfig(dtype=jnp.bfloat16, **fields)
    jmodel, params, tx, opt_state = jwl.create_train_state(jcfg)
    tokens = np.asarray(jwl.make_batch(jcfg, 4))
    model = wl.TinyLM(wl.ModelConfig(dtype=torch.bfloat16, **fields), device="cpu")
    model.load_state_dict(params_from_jax(_np(params)))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want_dtypes = {".".join({"kernel": "weight"}.get(k.key, k.key) for k in path): str(v.dtype)
                   for path, v in flat}
    assert want_dtypes["block_0.moe.experts_up"] == "bfloat16"
    assert {k: str(p.dtype).removeprefix("torch.") for k, p in model.named_parameters()} == want_dtypes
    step = jwl.make_train_step(jmodel, tx)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        want.append(float(loss))
    optimizer = torch.optim.AdamW(model.parameters(), **wl.ADAMW)
    port_step = wl.make_train_step(model, optimizer)
    got = [float(port_step(torch.from_numpy(tokens.astype(np.int64)))) for _ in range(3)]
    assert max(abs(a - b) for a, b in zip(got, want)) < 2.0**-7, (got, want)
    moments = optimizer.state[model.block_0.moe.experts_up]
    assert model.block_0.moe.experts_up.dtype == moments["exp_avg"].dtype == torch.bfloat16
    assert opt_state[0].mu["block_0"]["moe"]["experts_up"].dtype == jnp.bfloat16


def test_moe_init_statistics_follow_flax_fan_in():
    """flax's lecun_normal on a 3-D expert tensor folds the experts axis
    into the fan-in (d·E, f·E): the port's stds within 30% of flax's on
    every leaf, the router's zero bias equal; at E 16 a fan-in of d alone
    would be 4x off."""
    fields = dict(DECODE, n_experts=16)
    ref = params_from_jax(_np(jwl.create_train_state(jwl.ModelConfig(**fields))[1]))
    got = wl.TinyLM(wl.ModelConfig(**fields), device="cpu", seed=0).state_dict()
    assert set(got) == set(ref)
    for key, t in ref.items():
        if key.endswith(("bias", "scale")):
            assert torch.equal(got[key], t), key
        else:
            assert 0.7 < float(got[key].std() / t.std()) < 1.3, key
    e, d, f = 16, fields["d_model"], fields["d_ff"]
    for key, fan_in in (("block_0.moe.experts_up", d * e), ("block_0.moe.experts_down", f * e)):
        assert abs(float(got[key].std()) * fan_in ** 0.5 - 1.0) < 0.1, key


def test_the_bridge_carries_the_router_and_the_expert_leaves(case):
    """The router is a Dense (its kernel transposed); the 3-D expert
    leaves have no ``kernel`` name and keep flax's layout.  flax -> port
    -> flax is exact."""
    fields, np_params, _ = case
    state = params_from_jax(np_params)
    e, d, f = fields["n_experts"], fields["d_model"], fields["d_ff"]
    moe = np_params["block_0"]["moe"]
    assert torch.equal(state["block_0.moe.router.weight"], torch.from_numpy(moe["router"]["kernel"].T.copy()))
    assert state["block_0.moe.router.bias"].shape == (e,)
    assert torch.equal(state["block_0.moe.experts_up"], torch.from_numpy(moe["experts_up"].copy()))
    assert state["block_0.moe.experts_up"].shape == (e, d, f)
    assert state["block_0.moe.experts_down"].shape == (e, f, d)
    back = params_to_jax(state, 4)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(np_params)]
    for (path, a), (_, b) in zip(flat(back), flat(np_params)):
        assert np.array_equal(a, b), path


def test_expert_weights_split_by_the_jax_rule(case):
    """JAX's P("expert", None, "model") / P("expert", "model", None) on
    the expert tensors (flax's layout on both sides), the router whole on
    both axes; nothing else splits over ``expert``."""
    fields, np_params, _ = case
    for key, t in wl.TinyLM(wl.ModelConfig(**fields), device="cpu").state_dict().items():
        *mods, leaf = key.split(".")
        path = (*mods, {"weight": "kernel"}.get(leaf, leaf))
        if mods[-1] == "moe":  # the expert tensors: the spec's axes are the torch dims
            spec = tuple(jwl.param_partition_spec(path, jnp.zeros(t.shape)))
            assert wl.param_partition_spec(key, "expert") == spec.index("expert"), key
            assert wl.param_partition_spec(key, "model") == spec.index("model"), key
        else:
            assert wl.param_partition_spec(key, "expert") is None, key
        if "router" in mods:
            assert tuple(jwl.param_partition_spec(path, jnp.zeros(t.shape))) == ()
            assert wl.param_partition_spec(key, "model") is None, key


class FakeMesh:
    """A mesh seen through the calls shard_params makes: a model axis of
    *tp* and an expert axis of *ep*, this rank at *index* on each."""

    def __init__(self, tp, ep, index) -> None:
        self.sizes = {"data": 1, "seq": 1, "model": tp, "expert": ep}
        self.index = dict(zip(("model", "expert"), index))

    def __getitem__(self, name):
        size = self.sizes[name]
        return type("Dim", (), {"size": lambda self: size})()

    def get_local_rank(self, name):
        return self.index.get(name, 0)


def test_an_expert_shard_is_its_experts_and_its_slice_of_f_and_gathers_back():
    """tp 2 x ep 2: rank (m, x) holds experts 2x, 2x+1 and half m of f of
    both expert tensors (flax's layout), the router whole; the four
    slices concatenate back to the full state."""
    full = wl.TinyLM(wl.ModelConfig(**DECODE), device="cpu").state_dict()
    shards = {(m, x): wl.shard_params(full, FakeMesh(2, 2, (m, x)), 4) for m in (0, 1) for x in (0, 1)}
    f = DECODE["d_ff"] // 2
    for (m, x), shard in shards.items():
        up, down = full["block_1.moe.experts_up"], full["block_1.moe.experts_down"]
        assert torch.equal(shard["block_1.moe.experts_up"], up[2 * x:2 * x + 2, :, m * f:(m + 1) * f])
        assert torch.equal(shard["block_1.moe.experts_down"], down[2 * x:2 * x + 2, m * f:(m + 1) * f])
        assert shard["block_1.moe.router.weight"] is full["block_1.moe.router.weight"]
    for key, t in full.items():
        rows = [torch.cat([shards[m, x][key] for m in (0, 1)], wl.param_partition_spec(key, "model"))
                if wl.param_partition_spec(key, "model") is not None else shards[0, x][key] for x in (0, 1)]
        dim = wl.param_partition_spec(key, "expert")
        assert torch.equal(rows[0] if dim is None else torch.cat(rows, dim), t), key
    with pytest.raises(ValueError, match=r"splits block_0.moe.experts_up on dim 0 \(4\), which the expert axis"):
        wl.shard_params(full, FakeMesh(1, 3, (0, 0)), 4)


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def decode_case():
    """test_moe_decode_matches_recompute's config: flax params, a prompt,
    JAX's greedy tokens, float and from its int8 tree, and that tree."""
    _, params, _, _ = jwl.create_train_state(jwl.ModelConfig(**DECODE))
    prompt = np.random.default_rng(3).integers(0, DECODE["vocab_size"], (2, 4)).astype(np.int32)
    jcfg = jwl.ModelConfig(**DECODE)
    qparams = jq.quantize_params_int8(params)
    want = jwl.greedy_generate(jcfg, params, jnp.asarray(prompt), 8)
    want_q = jwl.greedy_generate(jcfg, qparams, jnp.asarray(prompt), 8)
    return _np(params), prompt, np.asarray(want), np.asarray(want_q), _np(qparams)


def test_moe_decode_matches_recompute(decode_case):
    """test_moe_decode_matches_recompute, ported: soft-MoE routes per
    token, so the cached decode equals full-prefix recompute and JAX's
    greedy tokens (fp32).  Seeded sampling reproduces on its seed, and at
    top_k 1 is JAX's greedy (the two packages' random streams differ)."""
    np_params, prompt, want, _, _ = decode_case
    cfg = wl.ModelConfig(**DECODE)
    model = _port(DECODE, np_params)
    out = wl.greedy_generate(cfg, model, prompt, 8, device="cpu")
    assert np.array_equal(out.numpy(), want)
    buf = torch.from_numpy(prompt.astype(np.int64))
    with torch.no_grad():
        for _ in range(8):
            buf = torch.cat([buf, model(buf)[:, -1].float().argmax(-1)[:, None]], 1)
    assert torch.equal(out, buf)
    sample = lambda seed, k=8: wl.generate(cfg, model, prompt, 8, temperature=1.0, top_k=k,  # noqa: E731
                                           seed=seed, device="cpu")
    assert torch.equal(sample(7), sample(7))
    assert np.array_equal(sample(5, k=1).numpy(), want)


def test_moe_quantize_params_int8_equals_jax_exactly(decode_case):
    """JAX quantizes every leaf of ndim >= 2, the expert tensors too: one
    scale per last-axis column, shared across experts (s [1, 1, f] and
    [1, 1, d]); the router is a Dense.  The port's q and s equal JAX's."""
    np_params, _, _, _, jax_q = decode_case
    want = params_from_jax(jax_q)
    got = qz.quantize_params_int8(params_from_jax(np_params), n_heads=DECODE["n_heads"])
    assert set(got) == set(want)
    for key, node in want.items():
        if qz.is_quant_node(node):
            assert torch.equal(got[key]["q"], node["q"]) and torch.equal(got[key]["s"], node["s"]), key
        else:
            assert torch.equal(got[key], node), key
    e, d, f = DECODE["n_experts"], DECODE["d_model"], DECODE["d_ff"]
    assert got["block_0.moe.experts_up"]["s"].shape == (1, 1, f)
    assert got["block_0.moe.experts_down"]["s"].shape == (1, 1, d)
    assert got["block_0.moe.router.weight"]["q"].shape == (e, d)
    deq = qz.dequantize_params(got)
    assert torch.equal(deq["block_1.moe.experts_down"],
                       got["block_1.moe.experts_down"]["q"].float() * got["block_1.moe.experts_down"]["s"])


def test_the_int8_moe_model_decodes_like_jax_through_the_int8_layers(decode_case, monkeypatch):
    """The int8 MoE model: the router an Int8Dense, each expert's up and
    down int8 [N, K] buffers (q_e transposed once) with the shared scale;
    JAX's int8 tree and the port's own quantization decode JAX's int8
    tokens; a decode step calls int8_linear (5 + 2E)·n_layers + 1 times."""
    np_params, prompt, _, want_q, jax_q = decode_case
    cfg = wl.ModelConfig(**DECODE)
    model = wl.quantize_model(_port(DECODE, np_params))
    moe = model.block_0.moe
    e, d, f = DECODE["n_experts"], DECODE["d_model"], DECODE["d_ff"]
    assert isinstance(moe, wl.Int8MoeMlp) and isinstance(moe.router, wl.Int8Dense)
    assert moe.up_q.dtype == moe.down_q.dtype == torch.int8
    assert moe.up_q.shape == (e, f, d) and moe.up_s.shape == (f,)
    assert moe.down_q.shape == (e, d, f) and moe.down_s.shape == (d,)
    assert not any(isinstance(m, (wl.Dense, wl.Embed, wl.MoeMlp)) for m in model.modules())
    assert np.array_equal(wl.greedy_generate(cfg, params_from_jax(jax_q), prompt, 8, device="cpu").numpy(), want_q)
    calls = []
    plain = qz.int8_linear
    monkeypatch.setattr(qz, "int8_linear", lambda *a: calls.append(a[1].shape) or plain(*a))
    out = wl.greedy_generate(cfg, model, prompt, 8, device="cpu")
    assert np.array_equal(out.numpy(), want_q)
    steps = prompt.shape[1] + 8 - 1
    assert len(calls) == ((5 + 2 * e) * DECODE["n_layers"] + 1) * steps
    assert calls.count(torch.Size([e, d])) == DECODE["n_layers"] * steps  # the router, N = E
