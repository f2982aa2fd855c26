"""The port's measurement surface (k8s_operator_libs_tpu_torch/tpu/smoke.py:
run_smoke's record, STAGES and run_stage) against the JAX package's
smoke.py on the CPU.

The ports of TestTpuSmokeHarness::test_run_smoke_measures_and_drains and
TestRunStageCpu (tests/test_tpu_integration.py) on the same tiny
configs; both packages' run_smoke records on the same config must carry
the same keys, recursively, and each value the port rounds where JAX
does must be rounded to the same places.  The attention stage is s 8192:
no test runs it on the CPU (the port refuses it there), as the JAX suite
runs none.
"""

import math

import jax.numpy as jnp
import pytest
import torch

from k8s_operator_libs_tpu.tpu import smoke as jsmoke
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.tpu import smoke
from k8s_operator_libs_tpu_torch.tpu import workload as wl

#: tests/test_tpu_integration.py::TestTpuSmokeHarness's config
TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, max_seq_len=16)

#: Where the JAX module rounds, by path: decimal places, or "3g" for
#: three significant figures.
ROUNDED = {
    ("step_time_ms",): 3,
    ("tokens_per_s",): 1,
    ("final_loss",): 4,
    ("achieved_tflops",): "3g",
    ("flash_interpret", "max_abs_err"): 6,
    ("flash_interpret", "interpret_ms"): 1,
    ("drain_handshake", "resumed_loss"): 4,
}
DECODE_ROUNDED = {
    ("tokens_per_s",): 1,
    ("ms_per_token",): 3,
    ("int8", "tokens_per_s"): 1,
    ("int8", "speedup_vs_float"): 3,
    ("int8", "token_agreement"): 3,
}


def _rounded(value: float, places) -> float:
    return float(f"{value:.3g}") if places == "3g" else round(value, places)


def _at(record, path):
    for key in path:
        record = record[key]
    return record


def _keys(record, prefix=()):
    """Every key path of a nested dict."""
    out = set()
    for key, value in record.items():
        out.add(prefix + (key,))
        if isinstance(value, dict):
            out |= _keys(value, prefix + (key,))
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(JAX record, port record) of run_smoke on TINY, steps 2, batch 2."""
    tmp = tmp_path_factory.mktemp("smoke")
    jrec = jsmoke.run_smoke(
        checkpoint_dir=str(tmp / "jax"), steps=2, warmup=1, batch_size=2,
        config=jwl.ModelConfig(**TINY, dtype=jnp.float32),
    )
    prec = smoke.run_smoke(
        str(tmp / "port"), steps=2, warmup=1, batch_size=2,
        config=wl.ModelConfig(**TINY, dtype=torch.float32), device="cpu",
    )
    return jrec, prec


def test_run_smoke_measures_and_drains(records):
    """The port of TestTpuSmokeHarness::test_run_smoke_measures_and_drains."""
    _, result = records
    assert result["platform"] == "cpu"
    assert result["step_time_ms"] > 0
    assert result["tokens_per_s"] > 0
    fi = result["flash_interpret"]
    assert "error" not in fi, fi
    assert fi["max_abs_err"] < 2e-3
    assert "decode" not in result  # max_seq_len 16 leaves no token budget
    hs = result["drain_handshake"]
    assert hs["ack"] == "done"
    assert hs["checkpoint_step"] == 2
    assert hs["resumed_steps"] == 2


def test_run_smoke_record_has_the_jax_keys(records):
    jrec, prec = records
    assert _keys(prec) == _keys(jrec)
    assert "mfu_pct" not in prec and "attention_kernel" not in prec
    for key in ("platform", "device_kind", "model"):
        assert prec[key] == jrec[key], key
    for key in ("checkpoint_step", "ack", "resumed_steps"):
        assert prec["drain_handshake"][key] == jrec["drain_handshake"][key], key
    assert prec["flash_interpret"]["shape"] == jrec["flash_interpret"]["shape"]


@pytest.mark.parametrize("path", sorted(ROUNDED), ids="/".join)
def test_run_smoke_rounds_where_jax_rounds(records, path):
    jrec, prec = records
    places = ROUNDED[path]
    assert _rounded(_at(jrec, path), places) == _at(jrec, path)  # the table is JAX's
    value = _at(prec, path)
    assert isinstance(value, float) and math.isfinite(value)
    assert _rounded(value, places) == value


def test_decode_bench_rounds_where_jax_rounds(tmp_path):
    cfg = wl.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_seq_len=24)
    model = wl.TinyLM(cfg, device="cpu")
    rec = smoke._decode_bench(cfg, model, new_tokens=4)
    assert set(_keys(rec)) == {("batch",), ("new_tokens",), ("int8",)} | set(DECODE_ROUNDED)
    for path, places in DECODE_ROUNDED.items():
        assert _rounded(_at(rec, path), places) == _at(rec, path), path


def test_run_smoke_without_drain_has_no_watcher_and_stops_before_the_handshake(tmp_path, monkeypatch):
    from k8s_operator_libs_tpu_torch.tpu import drain_handshake

    monkeypatch.setattr(drain_handshake, "DrainSignalWatcher", lambda *a: pytest.fail("watcher built"))
    cfg = wl.ModelConfig(**TINY)
    rec = smoke.run_smoke(str(tmp_path), steps=1, warmup=1, batch_size=2, config=cfg,
                          drain=False, kernel_sections=False, device="cpu")
    assert set(rec) == {"platform", "device_kind", "step_time_ms", "tokens_per_s", "model",
                        "final_loss", "achieved_tflops"}
    assert list(tmp_path.iterdir()) == []  # nothing was checkpointed


def test_the_smoke_config_keeps_the_jax_flash_default():
    cfg = smoke.smoke_config(torch.device("cpu"))
    assert cfg.flash_attention is False
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff, cfg.max_seq_len) == (
        2048, 512, 8, 4, 2048, 256
    )


# ------------------------------------------- TestRunStageCpu, ported


def test_touch_stage():
    rec = smoke.run_stage("touch", device="cpu")
    assert rec["platform"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["touch"]["checksum"] == 512.0
    assert rec["touch"]["first_compute_ms"] > 0


def test_matmul_stage():
    rec = smoke.run_stage("matmul", device="cpu")
    assert rec["matmul"]["n"] == 1024  # the CPU size, not the card's 4096
    assert rec["matmul"]["dtype"] == "float32"
    # The rate is rounded to one place, as the JAX record rounds it: on a
    # loaded CPU a call may take over 42.9 ms and honestly read 0.0.  So
    # hold the time, and the rate as the record's formula of that time,
    # within the rounding of ms_per_matmul to three places.
    ms, n = rec["matmul"]["ms_per_matmul"], rec["matmul"]["n"]
    assert ms > 0
    rate = lambda t: round(2 * n**3 / (t / 1e3) / 1e12, 1)  # noqa: E731
    assert rate(ms + 5e-4) <= rec["matmul"]["tflops"] <= rate(ms - 5e-4)
    assert set(rec["matmul"]) == {"n", "dtype", "ms_per_matmul", "tflops"}


def test_unknown_stage_rejected():
    with pytest.raises(ValueError, match="unknown stage"):
        smoke.run_stage("nonsense", device="cpu")
    assert smoke.STAGES == jsmoke.STAGES


def test_train_stage_carries_mfu_fields(tmp_path):
    cfg = wl.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
    rec = smoke.run_smoke(
        str(tmp_path), steps=2, batch_size=2, config=cfg,
        drain=False, kernel_sections=False, device="cpu",
    )
    assert rec["platform"] == "cpu"
    assert rec["achieved_tflops"] > 0
    assert rec["model"]["params"] > 0
    assert "mfu_pct" not in rec  # MFU is stated for the card only


def test_train_stage_runs_the_smoke_config_without_benches():
    rec = smoke.run_stage("train", steps=1, batch_size=1, device="cpu")
    assert rec["platform"] == "cpu" and rec["model"]["d_model"] == 512
    assert not {"attention_kernel", "decode", "flash_interpret", "drain_handshake"} & set(rec)


def test_drain_stage_acknowledges_with_the_reference_value():
    rec = smoke.run_stage("drain", batch_size=1, device="cpu")
    assert rec["platform"] == "cpu"
    assert rec["drain_handshake"] == {
        **rec["drain_handshake"], "checkpoint_step": 2, "ack": "done", "resumed_steps": 2,
    }


def test_decode_stage_decodes_fresh_smoke_weights():
    rec = smoke.run_stage("decode", batch_size=1, device="cpu")
    assert rec["platform"] == "cpu"
    assert rec["decode"]["batch"] == 8 and rec["decode"]["new_tokens"] == 32
    assert rec["decode"]["int8"]["token_agreement"] >= 0.5


def test_attention_stage_refuses_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        smoke.run_stage("attention", device="cpu")


def test_flash_sanity_holds_the_cpu_route_to_the_dense_reference(monkeypatch):
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    rec = smoke._flash_interpret_sanity(iters=1)
    assert rec["shape"] == "b2 s128 h2 d64" and rec["max_abs_err"] < 2e-3
    # a wrong route raises; it is not recorded
    monkeypatch.setattr(fa, "flash_attention", lambda q, *a: q)
    with pytest.raises(RuntimeError, match="max abs err"):
        smoke._flash_interpret_sanity(iters=1)
