"""The port's serving path (k8s_operator_libs_tpu_torch/tpu/workload.py::
generate, KVCache, the int8 layers; smoke.py::_decode_bench) against the
JAX package's workload.generate, on the CPU.

The flax params are carried into the port with ``params_from_jax`` (a
JAX-quantized tree as well), and the same numpy prompts go through both:
greedy decoding must agree token for token in fp32, dense and int8, and on
a ragged batch.  The JAX and torch random streams differ, so sampled
decoding is held to its properties on the port alone, and its draws to
jax.random.categorical in distribution.  The JAX calls run once each, in
module fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import quantize as jq
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_from_jax
from k8s_operator_libs_tpu_torch.tpu import quantize as qz
from k8s_operator_libs_tpu_torch.tpu import smoke
from k8s_operator_libs_tpu_torch.tpu import workload as wl

#: the configs of TestGreedyDecode, TestSampledDecode / the ragged test,
#: and TestInt8WeightOnlyServing (tests/test_tpu_integration.py)
GREEDY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
SAMPLED = dict(GREEDY, max_seq_len=32)
INT8 = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(cfg, train_steps: int = 0, batch_seed=lambda i: 0):
    model, params, tx, opt = jwl.create_train_state(jwl.ModelConfig(**cfg))
    if train_steps:
        step = jwl.make_train_step(model, tx)
        for i in range(train_steps):
            params, opt, _ = step(params, opt, jwl.make_batch(jwl.ModelConfig(**cfg), 8, seed=batch_seed(i)))
    return _np(params)


def _port(cfg, np_params):
    model = wl.TinyLM(wl.ModelConfig(**cfg), device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    return model


def _recompute(model, prompt, new_tokens):
    """Greedy by full-prefix recompute through the training-mode model."""
    buf = torch.as_tensor(prompt)
    with torch.no_grad():
        for _ in range(new_tokens):
            buf = torch.cat([buf, model(buf)[:, -1].float().argmax(-1)[:, None]], 1)
    return buf


# ------------------------------------------------------------- greedy


@pytest.fixture(scope="module", params=[GREEDY, SAMPLED], ids=["greedy-cfg", "sampled-cfg"])
def greedy_case(request):
    """(cfg, np params, prompt, JAX's greedy tokens) with fresh weights."""
    cfg = request.param
    params = _jax_params(cfg)
    prompt = np.random.default_rng(3).integers(0, cfg["vocab_size"], (2, 4)).astype(np.int32)
    out = jwl.greedy_generate(jwl.ModelConfig(**cfg), jax.tree.map(jnp.asarray, params), jnp.asarray(prompt), 6)
    return cfg, params, prompt, np.asarray(out)


def test_greedy_decode_equals_jax_and_full_prefix_recompute(greedy_case):
    cfg, params, prompt, want = greedy_case
    model = _port(cfg, params)
    out = wl.greedy_generate(wl.ModelConfig(**cfg), model, prompt, 6, device="cpu")
    assert out.shape == (2, 10) and out.dtype == torch.int64
    assert np.array_equal(out.numpy(), want)
    assert torch.equal(out, _recompute(model, prompt, 6))
    # a float state dict serves the same tokens as the model
    state = params_from_jax(params)
    assert torch.equal(wl.generate(wl.ModelConfig(**cfg), state, prompt, 6, device="cpu"), out)


def test_budget_overflow_and_a_mismatched_model_are_rejected():
    cfg = wl.ModelConfig(**dict(GREEDY, n_layers=1, max_seq_len=8))
    model = wl.TinyLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        wl.greedy_generate(cfg, model, torch.zeros(1, 4, dtype=torch.long), 8, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        wl.greedy_generate(dataclasses.replace(cfg, d_ff=32), model, torch.zeros(1, 4, dtype=torch.long), 2,
                           device="cpu")


def test_the_kv_cache_is_flax_s_decode_collection():
    """Sized to the generation's span, zero, one index for every row and
    layer; a decode-mode model refuses a call without it, and a decode
    call takes one token."""
    cfg = wl.ModelConfig(**GREEDY)
    cache = wl.KVCache(cfg, batch=3, total=7, device="cpu")
    assert len(cache.keys) == len(cache.values) == cfg.n_layers and cache.index == 0
    assert all(t.shape == (3, 7, 4, 8) and not t.any() for t in cache.keys + cache.values)
    model = wl.TinyLM(dataclasses.replace(cfg, decode=True), device="cpu")
    with pytest.raises(ValueError, match="KVCache"):
        model(torch.zeros(3, 1, dtype=torch.long))
    with torch.no_grad(), pytest.raises(ValueError, match="one token"):
        model(torch.zeros(3, 2, dtype=torch.long), cache=cache)
    with torch.no_grad():
        model(torch.zeros(3, 1, dtype=torch.long), torch.zeros(3, 1, dtype=torch.long), cache=cache)
    assert cache.index == 1 and cache.keys[0][:, 0].any() and not cache.keys[0][:, 1:].any()


def test_cached_decode_logits_equal_the_full_prefix_logits(greedy_case):
    cfg, params, prompt, want = greedy_case
    model = _port(cfg, params)
    tokens = torch.from_numpy(want.copy())
    cache = wl.KVCache(model.config, tokens.shape[0], tokens.shape[1], "cpu")
    with torch.no_grad():
        full = model(tokens)
        for i in range(tokens.shape[1]):
            pos = torch.full((tokens.shape[0], 1), i)
            step = model(tokens[:, i:i + 1], pos, cache=cache)[:, -1]
            assert float((step - full[:, i]).abs().max()) < 1e-5, i


# --------------------------------------------------------------- int8


@pytest.fixture(scope="module")
def int8_case():
    """JAX's TinyLM after 15 train steps (peaked logits, so argmax is
    stable), and JAX's greedy tokens, float and int8, from a 6-token
    prompt."""
    params = _jax_params(INT8, train_steps=15)
    prompt = np.random.default_rng(1).integers(0, INT8["vocab_size"], (2, 6)).astype(np.int32)
    jcfg = jwl.ModelConfig(**INT8)
    jparams = jax.tree.map(jnp.asarray, params)
    qparams = jq.quantize_params_int8(jparams)
    out = jwl.greedy_generate(jcfg, jparams, jnp.asarray(prompt), 10)
    out_q = jwl.greedy_generate(jcfg, qparams, jnp.asarray(prompt), 10)
    return params, _np(qparams), prompt, np.asarray(out), np.asarray(out_q)


def test_int8_greedy_decode_equals_jax_on_trained_weights(int8_case):
    params, qparams, prompt, want, want_q = int8_case
    cfg = wl.ModelConfig(**INT8)
    float_out = wl.greedy_generate(cfg, _port(INT8, params), prompt, 10, device="cpu")
    assert np.array_equal(float_out.numpy(), want)
    # the JAX-quantized tree, loaded into the port
    jax_q = wl.greedy_generate(cfg, params_from_jax(qparams), prompt, 10, device="cpu")
    assert np.array_equal(jax_q.numpy(), want_q)
    # the port's own quantization, as a state and as a model
    port_q = qz.quantize_params_int8(params_from_jax(params), n_heads=INT8["n_heads"])
    assert np.array_equal(wl.greedy_generate(cfg, port_q, prompt, 10, device="cpu").numpy(), want_q)
    model_q = wl.quantize_model(_port(INT8, params))
    assert np.array_equal(wl.greedy_generate(cfg, model_q, prompt, 10, device="cpu").numpy(), want_q)
    assert (want_q == want).mean() > 0.8  # near-lossless on peaked logits


def test_the_int8_model_holds_int8_and_runs_the_int8_layers(int8_case):
    params = int8_case[0]
    model = wl.quantize_model(_port(INT8, params))
    dense = [m for m in model.modules() if isinstance(m, wl.Int8Dense)]
    assert len(dense) == 6 * INT8["n_layers"] + 1
    assert not any(isinstance(m, (wl.Dense, wl.Embed)) for m in model.modules())
    assert all(m.q.dtype == torch.int8 and m.scale.shape == (m.q.shape[0],) for m in dense)
    assert model.block_0.attn.query.bias.dtype == torch.float32  # the dequantized [h, hd] bias
    assert {name for name, _ in model.named_parameters()} == {
        f"{p}.{leaf}" for p in ("ln_f", *(f"block_{i}.{ln}" for i in range(2) for ln in ("ln_attn", "ln_mlp")))
        for leaf in ("scale", "bias")
    }


# ------------------------------------------------------------- ragged


@pytest.fixture(scope="module")
def ragged_case():
    """test_ragged_prompt_generation_matches_solo_rows' weights (10 train
    steps) and JAX's ragged batch."""
    params = _jax_params(SAMPLED, train_steps=10, batch_seed=lambda i: i)
    full = np.random.default_rng(3).integers(0, 64, (2, 6)).astype(np.int32)
    out = jwl.generate(
        jwl.ModelConfig(**SAMPLED), jax.tree.map(jnp.asarray, params), jnp.asarray(full), 8,
        prompt_lens=jnp.asarray([3, 6], jnp.int32),
    )
    return params, full, np.asarray(out)


def test_ragged_prompt_generation_equals_jax_and_solo_rows(ragged_case):
    params, full, want = ragged_case
    cfg, model = wl.ModelConfig(**SAMPLED), _port(SAMPLED, params)
    out = wl.generate(cfg, model, full, 8, prompt_lens=[3, 6], device="cpu")
    assert np.array_equal(out.numpy(), want)
    for r, plen in ((0, 3), (1, 6)):
        solo = wl.generate(cfg, model, full[r:r + 1, :plen], 8 + (6 - plen), device="cpu")
        assert torch.equal(out[r], solo[0]), r


@pytest.mark.parametrize(
    "lens,match", [([3], "batch"), ([0, 6], r"\[1, 6\]"), ([3, 7], r"\[1, 6\]")], ids=["shape", "zero", "long"]
)
def test_ragged_prompt_lens_are_validated(lens, match):
    cfg = wl.ModelConfig(**SAMPLED)
    with pytest.raises(ValueError, match=match):
        wl.generate(cfg, wl.TinyLM(cfg, device="cpu"), torch.zeros(2, 6, dtype=torch.long), 4,
                    prompt_lens=torch.tensor(lens), device="cpu")


# ------------------------------------------------------------ sampled


@pytest.fixture(scope="module")
def sampled():
    """TestSampledDecode's weights in the port, and its prompt."""
    cfg = wl.ModelConfig(**SAMPLED)
    prompt = np.random.default_rng(0).integers(0, 64, (2, 5))
    return cfg, _port(SAMPLED, _jax_params(SAMPLED)), prompt


def test_seed_reproducibility(sampled):
    cfg, model, prompt = sampled
    run = lambda seed: wl.generate(cfg, model, prompt, 8, temperature=1.0, top_k=8, seed=seed, device="cpu")  # noqa: E731
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.array_equal(a[:, :5].numpy(), prompt)


def test_top_k_one_is_greedy(sampled):
    cfg, model, prompt = sampled
    greedy = wl.greedy_generate(cfg, model, prompt, 8, device="cpu")
    t1 = wl.generate(cfg, model, prompt, 8, temperature=5.0, top_k=1, seed=3, device="cpu")
    assert torch.equal(t1, greedy)


def test_samples_stay_inside_top_k_support(sampled):
    """Every sampled token is among its step's k most probable, as the
    port's full-prefix recompute ranks them."""
    cfg, model, prompt = sampled
    k = 4
    toks = wl.generate(cfg, model, prompt, 6, temperature=1.0, top_k=k, seed=11, device="cpu")
    with torch.no_grad():
        for i in range(prompt.shape[1], toks.shape[1]):
            topk = torch.topk(model(toks[:, :i])[:, -1].float(), k).indices
            for row in range(toks.shape[0]):
                assert toks[row, i] in topk[row], (row, i)


def test_draws_follow_jax_categorical_in_distribution():
    """Gumbel-max over the temperature-scaled, top-k-masked logits: the
    frequencies of 40000 draws match softmax and jax.random.categorical
    (the streams differ, so draws are compared as distributions)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 3.0]]).repeat(40000, 1)
    gen = torch.Generator().manual_seed(0)
    for top_k, temperature in ((0, 1.0), (3, 0.7)):
        draws = wl._sample(logits, temperature, top_k, gen)
        scaled = logits[0] / temperature
        if top_k:
            scaled = scaled.masked_fill(scaled < torch.topk(scaled, top_k).values[-1], float("-inf"))
        probs = torch.softmax(scaled, -1)
        freq = torch.bincount(draws, minlength=6).float() / len(draws)
        jax_draws = np.asarray(jax.random.categorical(jax.random.key(0), jnp.asarray(scaled.numpy()), shape=(40000,)))
        jax_freq = np.bincount(jax_draws, minlength=6) / len(jax_draws)
        assert float((freq - probs).abs().max()) < 0.01, (top_k, freq, probs)
        assert np.abs(freq.numpy() - jax_freq).max() < 0.015, (top_k, freq, jax_freq)


# ------------------------------------------ drain, and the decode bench


def test_a_drain_checkpoint_serves_the_live_model_s_tokens(tmp_path):
    """The weights across the drain: the checkpoint the trainer saves on
    the orchestrator's request, once restored, serves the same tokens."""
    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    cfg = wl.ModelConfig(**SAMPLED)
    nodes = InMemoryCluster()
    nodes.create(make_node("gpu-host"))
    trainer = wl.CheckpointingTrainer(
        cfg, str(tmp_path), watcher=DrainSignalWatcher(nodes, "gpu-host"), batch_size=4, device="cpu"
    )
    trainer.run(3)
    key = util.get_pre_drain_checkpoint_annotation_key()
    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {key: consts.PRE_DRAIN_CHECKPOINT_REQUESTED}}})
    assert trainer.run(10) == 3 and trainer.drained
    restored = wl.restore_checkpoint(str(tmp_path), 3)["model"]
    prompt = np.random.default_rng(5).integers(0, 64, (3, 4))
    live = wl.greedy_generate(cfg, trainer.model, prompt, 12, device="cpu")
    assert torch.equal(wl.greedy_generate(cfg, restored, prompt, 12, device="cpu"), live)
    qlive = wl.greedy_generate(cfg, wl.quantize_model(trainer.model), prompt, 12, device="cpu")
    qrestored = qz.quantize_params_int8(restored, n_heads=cfg.n_heads)
    assert torch.equal(wl.greedy_generate(cfg, qrestored, prompt, 12, device="cpu"), qlive)


def test_decode_bench_reports_and_int8_agrees(tmp_path):
    """The port of TestDecodeBenchCpu: the same keys and thresholds."""
    cfg = wl.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=48)
    trainer = wl.CheckpointingTrainer(cfg, str(tmp_path), watcher=None, batch_size=2, device="cpu")
    rec = smoke._decode_bench(cfg, trainer.model, new_tokens=8)
    assert rec["batch"] == 8 and rec["new_tokens"] == 8
    assert rec["tokens_per_s"] > 0 and rec["ms_per_token"] > 0
    assert set(rec["int8"]) == {"tokens_per_s", "speedup_vs_float", "token_agreement"}
    assert rec["int8"]["tokens_per_s"] > 0
    assert rec["int8"]["token_agreement"] >= 0.5


def test_run_smoke_on_the_cpu_carries_the_decode_bench(tmp_path):
    cfg = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=24)
    result = smoke.run_smoke(str(tmp_path), steps=1, warmup=1, batch_size=2, config=cfg, device="cpu")
    assert result["decode"]["new_tokens"] == 8  # min(32, 24 - 16)
    assert result["decode"]["int8"]["token_agreement"] >= 0.5
