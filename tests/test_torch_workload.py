"""The port's TinyLM, loss, train step and weights bridge
(k8s_operator_libs_tpu_torch/tpu/workload.py, convert.py) against the JAX
package's workload.py.

The flax params of a small config are carried into the torch model with
``params_from_jax``; logits, loss, every gradient and three AdamW steps
must then match the JAX reference (the flash path runs the Pallas kernels
in interpret mode on the JAX side and the kernels' plain versions on the
port's side).  The tests also pin the traps where flax/optax and torch
defaults differ.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.tpu import workload as wl

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=33)


@pytest.fixture(scope="module")
def jax_state():
    """(params as numpy, the flax model's batch) for the small config."""
    _, params, _, _ = jwl.create_train_state(jwl.ModelConfig(**CFG))
    np_params = jax.tree.map(np.asarray, params)
    batch = np.asarray(jwl.make_batch(jwl.ModelConfig(**CFG), 4, seed=0))
    return np_params, batch


def _port_model(np_params, flash: bool):
    model = wl.TinyLM(wl.ModelConfig(**CFG, flash_attention=flash), device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def _leaves(tree):
    return {
        "/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_make_batch_tokens_are_identical():
    cfg = wl.ModelConfig(**CFG)
    for seed in (0, 1, 7):
        port = wl.make_batch(cfg, 4, seed=seed)
        ref = np.asarray(jwl.make_batch(jwl.ModelConfig(**CFG), 4, seed=seed))
        assert port.dtype == torch.int64  # JAX's are int32
        assert ref.dtype == np.int32
        assert np.array_equal(port.numpy(), ref)


def test_params_bridge_covers_the_model_and_round_trips(jax_state):
    np_params, _ = jax_state
    state = params_from_jax(np_params)
    model = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu")
    assert set(state) == set(model.state_dict())
    for key, tensor in model.state_dict().items():
        assert state[key].shape == tensor.shape, key
    back = _leaves(params_to_jax(state, CFG["n_heads"]))
    ref = _leaves(np_params)
    assert set(back) == set(ref)
    for key in ref:
        assert back[key].shape == ref[key].shape and np.array_equal(back[key], ref[key]), key


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "flash"])
def test_logits_match_jax(flash, jax_state):
    np_params, batch = jax_state
    cfg = jwl.ModelConfig(**CFG, flash_attention=flash)
    ref = jwl.TinyLM(cfg).apply({"params": np_params}, jnp.asarray(batch[:, :-1]))
    got = _port_model(np_params, flash)(torch.tensor(batch[:, :-1], dtype=torch.int64))
    assert got.shape == ref.shape
    assert _max_err(got.detach(), ref) < 1e-4


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "flash"])
def test_loss_and_every_gradient_match_jax(flash, jax_state):
    np_params, batch = jax_state
    model = jwl.TinyLM(jwl.ModelConfig(**CFG, flash_attention=flash))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jwl.loss_fn(model, p, jnp.asarray(batch))
    )(np_params)
    port = _port_model(np_params, flash)
    loss = wl.loss_fn(port, torch.tensor(batch, dtype=torch.int64))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < 1e-4
    grads = params_to_jax(
        {name: p.grad for name, p in port.named_parameters()}, CFG["n_heads"]
    )
    ref = _leaves(grads_j)
    got = _leaves(grads)
    assert set(got) == set(ref)
    for key in ref:
        assert _max_err(got[key], ref[key]) < 1e-4, key


def test_three_adamw_steps_track_optax(jax_state):
    np_params, _ = jax_state
    cfg_j = jwl.ModelConfig(**CFG)
    tx = optax.adamw(3e-4)
    step_j = jwl.make_train_step(jwl.TinyLM(cfg_j), tx)
    params_j = jax.tree.map(jnp.asarray, np_params)
    opt_j = tx.init(params_j)
    model = _port_model(np_params, flash=False)
    optimizer = torch.optim.AdamW(model.parameters(), **wl.ADAMW)
    step = wl.make_train_step(model, optimizer)
    for i in range(3):
        tokens = jwl.make_batch(cfg_j, 4, seed=i)
        params_j, opt_j, loss_j = step_j(params_j, opt_j, tokens)
        loss = step(wl.make_batch(wl.ModelConfig(**CFG), 4, seed=i))
        assert abs(float(loss) - float(loss_j)) < 1e-4, i
    ref = _leaves(params_j)
    got = _leaves(params_to_jax(model.state_dict(), CFG["n_heads"]))
    start = _leaves(np_params)
    for key in ref:
        if key.endswith("attn/key/bias"):
            # softmax ignores a per-query constant, so this gradient is 0
            # up to rounding noise, which Adam scales to +-lr a step: both
            # sides may only have moved within 3 steps of lr
            assert _max_err(got[key], start[key]) <= 3 * 3e-4 * 1.001, key
            assert _max_err(ref[key], start[key]) <= 3 * 3e-4 * 1.001, key
        else:
            assert _max_err(got[key], ref[key]) < 1e-4, key


def test_create_train_state_matches_flax_init_statistics():
    """The port's seeded init follows flax's initializers: lecun-normal
    kernels, zero biases, unit LayerNorm scales, N(0, 1/d) embeddings."""
    model, optimizer = wl.create_train_state(wl.ModelConfig(**CFG), device="cpu", seed=0)
    again, _ = wl.create_train_state(wl.ModelConfig(**CFG), device="cpu", seed=0)
    for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name  # same seed, same weights
    ref = _leaves(jwl.create_train_state(jwl.ModelConfig(**CFG))[1])
    got = _leaves(params_to_jax(model.state_dict(), CFG["n_heads"]))
    for key in ref:
        if key.endswith(("bias", "scale")):
            assert np.array_equal(got[key], ref[key]), key
        else:  # same distribution: stds within 30% at these sizes
            assert 0.7 < got[key].std() / ref[key].std() < 1.3, key
    assert optimizer.defaults["weight_decay"] == 1e-4


@pytest.mark.parametrize(
    "field,value",
    [
        ("n_experts", 2),
        ("seq_axis", "seq"),
        ("ring_attention", True),
        ("ring_flash", True),
        ("ring_layout", "zigzag"),
        ("remat", True),
    ],
)
def test_config_fields_not_ported_raise(field, value):
    # the message names the JAX module the option waits for
    module = "ring_attention.py" if field.startswith("ring_") else "workload.py"
    with pytest.raises(NotImplementedError, match=rf"{field} .*port of .*k8s_operator_libs_tpu/tpu/{module}"):
        wl.ModelConfig(**CFG, **{field: value})


def test_decode_mode_is_ported():
    cfg = wl.ModelConfig(**CFG, decode=True)
    assert cfg.decode and jwl.ModelConfig(**CFG, decode=True).decode


# ------------------------------------------------- traps, pinned by name


def test_trap_flax_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    assert _max_err(F.gelu(t, approximate="tanh"), ref) < 1e-6
    assert _max_err(F.gelu(t), ref) > 1e-4  # torch's default is exact erf


def test_trap_flax_layernorm_eps_and_fast_variance():
    ln = fnn.LayerNorm()
    assert ln.epsilon == wl.LN_EPS == 1e-6 and torch.nn.LayerNorm(4).eps == 1e-5
    assert ln.use_fast_variance is True
    x = (np.random.default_rng(0).standard_normal((3, 32)) * 0.5 + 2).astype(np.float32)
    params = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(ln.apply(params, jnp.asarray(x)))
    got = wl.LayerNorm(32, torch.float32, "cpu")(torch.from_numpy(x)).detach()
    assert _max_err(got, ref) < 1e-5


def test_trap_optax_adamw_decays_every_parameter_by_1e_4():
    tx = optax.adamw(3e-4)
    params = {"bias": jnp.ones(3), "scale": jnp.full(3, 2.0)}
    zero = jax.tree.map(jnp.zeros_like, params)
    updates, _ = tx.update(zero, tx.init(params), params)
    for key in params:  # zero gradient: the update is the decay alone
        assert np.allclose(updates[key], -3e-4 * 1e-4 * params[key])
    assert wl.ADAMW["weight_decay"] == 1e-4
    assert torch.optim.AdamW([torch.zeros(1)]).defaults["weight_decay"] == 1e-2


def test_trap_jax_tokens_are_int32_and_the_port_feeds_int64():
    tokens = jwl.make_batch(jwl.ModelConfig(**CFG), 2)
    assert tokens.dtype == jnp.int32
    port = wl.make_batch(wl.ModelConfig(**CFG), 2)
    assert port.dtype == torch.int64
    out = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu")(port)
    assert out.shape == (2, CFG["max_seq_len"], CFG["vocab_size"])


def test_tinylm_flash_equals_gather_on_identical_weights():
    """test_tinylm_flash_equals_gather_on_identical_weights of the JAX
    suite, in the port: one train step's loss on the same weights."""
    cfg = wl.ModelConfig(**CFG)
    gather = wl.TinyLM(cfg, device="cpu", seed=1)
    flash = wl.TinyLM(dataclasses.replace(cfg, flash_attention=True), device="cpu")
    flash.load_state_dict(gather.state_dict())
    batch = wl.make_batch(cfg, 4, seed=0)
    losses = [
        float(wl.make_train_step(m, torch.optim.AdamW(m.parameters(), **wl.ADAMW))(batch))
        for m in (gather, flash)
    ]
    assert abs(losses[0] - losses[1]) < 1e-4
