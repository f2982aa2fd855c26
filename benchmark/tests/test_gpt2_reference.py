"""The plain reference against the program's TinyLM on the CPU, in fp32,
on the benchmark's weights: the same logits, the same int8 serving
logits, and the same training steps."""

import dataclasses

import pytest
import torch

from benchmark import inputs
from benchmark.reference import compare, gpt2
from k8s_operator_libs_tpu_torch.tpu import workload as wl

from .conftest import TINY_MODEL


def _program(model=TINY_MODEL, seed=3):
    cfg = wl.ModelConfig(**model, dtype=torch.float32)
    lm = wl.TinyLM(cfg, device="cpu", seed=0)
    lm.load_state_dict(inputs.make_weights(model, seed, "cpu"))
    return cfg, lm


def test_logits_match_the_program():
    cfg, lm = _program()
    tokens = inputs.train_batch(TINY_MODEL["vocab_size"], 3, 20, 11)
    w = inputs.make_weights(TINY_MODEL, 3, "cpu")
    with torch.no_grad():
        want = lm(tokens)
    got = gpt2.forward(w, tokens, TINY_MODEL["n_heads"], TINY_MODEL["n_layers"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_int8_logits_match_the_quantized_program():
    cfg, lm = _program()
    served = wl.quantize_model(lm)
    tokens = inputs.train_batch(TINY_MODEL["vocab_size"], 2, 12, 5)
    dcfg = dataclasses.replace(cfg, decode=True)
    cache = wl.KVCache(dcfg, 2, 12, "cpu")
    served.config = dcfg
    with torch.no_grad():
        want = torch.cat([served(tokens[:, i:i + 1], torch.full((2, 1), i), cache=cache)
                          for i in range(12)], 1)
    w = gpt2.quantized(inputs.make_weights(TINY_MODEL, 3, "cpu"), TINY_MODEL["n_heads"], 8)
    got = gpt2.forward(w, tokens, TINY_MODEL["n_heads"], TINY_MODEL["n_layers"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_int4_is_coarser_than_int8():
    w = inputs.make_weights(TINY_MODEL, 3, "cpu")
    err = {bits: max(float((gpt2.quantized(w, 4, bits)[k] - w[k]).abs().max()) for k in w) for bits in (8, 4)}
    assert 0 < err[8] < err[4]
    # q/k/v biases quantize too; the other biases stay as they are
    assert gpt2.quantized(w, 4, 8)["block_0.attn.out.bias"] is w["block_0.attn.out.bias"]


def test_training_steps_match_the_program():
    cfg, lm = _program()
    optimizer = torch.optim.AdamW(lm.parameters(), **wl.ADAMW)
    step = wl.make_train_step(lm, optimizer)
    batches = [inputs.train_batch(TINY_MODEL["vocab_size"], 4, 64, s) for s in (7, 8, 9)]
    losses = [float(step(b)) for b in batches]
    ref = gpt2.train_steps(inputs.make_weights(TINY_MODEL, 3, "cpu"), batches, TINY_MODEL["n_heads"],
                           TINY_MODEL["n_layers"], rows_per_block=3)
    assert ref["losses"] == pytest.approx(losses, rel=1e-6)
    w0 = inputs.make_weights(TINY_MODEL, 3, "cpu")
    change = {k: float((p.detach() - w0[k]).norm()) for k, p in lm.named_parameters()}
    # the key biases' gradient is nought to rounding: Adam moves them by
    # round-off alone, which is why the comparison leaves them out
    moving = compare.moving_leaves(ref["grad"])
    assert set(change) - set(moving) == {"block_0.attn.key.bias", "block_1.attn.key.bias"}
    assert {k: ref["change"][k] for k in moving} == pytest.approx({k: change[k] for k in moving}, rel=1e-4)


def test_fp8_control_rounds_each_operand():
    x = torch.randn(64, requires_grad=True)
    y = gpt2.fp8(x)
    err = float((y - x).detach().abs().max())
    assert 0 < err <= float(x.detach().abs().max()) / 8
    y.backward(torch.ones(64) * 3.0)
    assert torch.equal(x.grad, torch.full((64,), 3.0))
