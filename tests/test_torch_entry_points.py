"""The port's single-device entry points and runner scripts on the CPU:
graft_entry.entry against the JAX package's __graft_entry__.entry,
examples/generate.py against the JAX example's output lines, and the
hack runners (gpu_smoke, gpu_stage) against the reference's record and
the rule that no card means a non-zero exit unless the CPU is asked for.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch import graft_entry
from k8s_operator_libs_tpu_torch.convert import params_from_jax
from k8s_operator_libs_tpu_torch.examples import generate as gen_example
from k8s_operator_libs_tpu_torch.hack import gpu_smoke, gpu_stage
from k8s_operator_libs_tpu_torch.tpu import workload as wl

ROOT = Path(__file__).resolve().parent.parent


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("jax_graft_entry", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


# ------------------------------------------------------------ graft entry


@pytest.fixture(scope="module")
def entries():
    """(JAX fn, params, tokens) and (port fn, model, tokens) of entry(),
    the port's model carrying JAX's params."""
    jfn, (params, jtokens) = _jax_graft_entry().entry()
    fn, (model, tokens) = graft_entry.entry(device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (jfn, params, jtokens), (fn, model, tokens)


def test_entry_is_the_reference_loss_step(entries):
    _, (fn, model, tokens) = entries
    cfg = model.config
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff, cfg.max_seq_len) == (
        256, 128, 8, 2, 512, 128
    )
    assert cfg.dtype == torch.bfloat16 and fn is wl.loss_fn
    assert tuple(tokens.shape) == (8, 128)


def test_entry_loss_equals_the_jax_entry_loss_in_bf16(entries):
    (jfn, params, jtokens), (fn, model, tokens) = entries
    assert np.array_equal(tokens.numpy(), np.asarray(jtokens))
    with torch.no_grad():
        loss = float(fn(model, tokens))
    assert loss == pytest.approx(float(jfn(params, jtokens)), abs=2e-2)


def test_entry_loss_equals_the_jax_loss_in_fp32(entries):
    (_, params, jtokens), (fn, model, tokens) = entries
    cfg32 = dataclasses.replace(model.config, dtype=torch.float32)
    model32 = wl.TinyLM(cfg32, device="cpu")
    model32.load_state_dict(model.state_dict())
    jcfg = dataclasses.replace(jwl.ModelConfig(**{
        f: getattr(cfg32, f) for f in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_seq_len")
    }), dtype=jnp.float32)
    ref = float(jwl.loss_fn(jwl.TinyLM(jcfg), params, jtokens))
    with torch.no_grad():
        assert float(fn(model32, tokens)) == pytest.approx(ref, abs=1e-4)


# ------------------------------------------------------- generate example


def _run_main(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _shape(line: str) -> str:
    """A line with its numbers replaced: what the two examples share."""
    return re.sub(r"\d+(\.\d+)?", "N", line)


@pytest.fixture(scope="module")
def jax_example_lines():
    module = runpy.run_path(str(ROOT / "examples" / "generate.py"), run_name="jax_example")
    argv, out = sys.argv, io.StringIO()
    sys.argv = ["generate.py", "--steps", "1", "--new-tokens", "4"]
    try:
        with contextlib.redirect_stdout(out):
            assert module["main"]() == 0
    finally:
        sys.argv = argv
    return out.getvalue().splitlines()


def test_generate_example_prints_the_reference_lines(jax_example_lines):
    lines = _run_main(gen_example.main, ["--device", "cpu", "--steps", "1", "--new-tokens", "4"])
    assert [_shape(x) for x in lines] == [_shape(x) for x in jax_example_lines]
    assert re.fullmatch(r"trained 1 steps, loss \d+\.\d{4}", lines[0])
    assert lines[-1].endswith("KV-cache decode, greedy)")
    # the same prompts as the JAX example: default_rng(seed) draws
    assert [x.split(" -> ")[0] for x in lines[1:3]] == [x.split(" -> ")[0] for x in jax_example_lines[1:3]]


def test_generate_example_serves_int8_and_samples():
    lines = _run_main(gen_example.main, [
        "--device", "cpu", "--steps", "0", "--new-tokens", "4", "--int8",
        "--temperature", "0.8", "--top-k", "5",
    ])
    assert lines[0] == "trained 0 steps (serving freshly initialized params)"
    assert len(lines) == 4 and lines[-1].endswith("KV-cache decode, int8, T=0.8 top_k=5)")


def test_generate_example_restores_a_drain_checkpoint(tmp_path):
    trainer = wl.CheckpointingTrainer(gen_example.CONFIG, str(tmp_path), batch_size=2, device="cpu")
    trainer.run(2)
    trainer.save()
    lines = _run_main(gen_example.main, [
        "--device", "cpu", "--restore-dir", str(tmp_path), "--restore-step", "2", "--new-tokens", "4",
    ])
    assert lines[0] == "restored checkpoint step 2"
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 8)))
    want = wl.greedy_generate(gen_example.CONFIG, trainer.model, prompt, 4, device="cpu")
    for line, row in zip(lines[1:3], want.tolist()):
        assert line == f"prompt [{' '.join(map(str, row[:8]))}] -> [{' '.join(map(str, row[8:]))}]"
    with pytest.raises(SystemExit):
        gen_example.main(["--device", "cpu", "--restore-dir", str(tmp_path)])


# ---------------------------------------------------------------- runners


def _compute_cpu_record() -> dict:
    """BENCH_r05.json's compute_cpu: the JAX run_smoke record on the CPU
    at the smoke configuration."""
    tail = json.loads((ROOT / "BENCH_r05.json").read_text())["tail"]
    start = tail.index('"compute_cpu": ') + len('"compute_cpu": ')
    return json.JSONDecoder().raw_decode(tail, start)[0]


def _key_paths(record, prefix=()):
    out = set()
    for key, value in record.items():
        out.add(prefix + (key,))
        if isinstance(value, dict):
            out |= _key_paths(value, prefix + (key,))
    return out


def test_gpu_smoke_on_the_cpu_prints_the_reference_record():
    [line] = _run_main(gpu_smoke.main, ["--device", "cpu", "--steps", "1", "--batch-size", "1"])
    rec = json.loads(line)
    assert (rec["metric"], rec["unit"]) == ("gpu_step_time_ms", "ms")
    assert rec["value"] == rec["detail"]["step_time_ms"] > 0
    assert _key_paths(rec["detail"]) == _key_paths(_compute_cpu_record())
    assert rec["detail"]["platform"] == "cpu" and rec["detail"]["drain_handshake"]["ack"] == "done"


def test_gpu_stage_on_the_cpu_merges_its_stages():
    out = subprocess.run(
        [sys.executable, "-m", "k8s_operator_libs_tpu_torch.hack.gpu_stage",
         "--device", "cpu", "--stages", "matmul,touch"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    [line] = out.stdout.splitlines()
    rec = json.loads(line)
    assert list(rec["stages"]) == ["touch", "matmul"]  # STAGES order
    assert all(v.startswith("ok") for v in rec["stages"].values())
    assert rec["platform"] == "cpu" and rec["touch"]["checksum"] == 512.0
    assert rec["matmul"]["n"] == 1024


def test_gpu_stage_exits_non_zero_when_a_stage_fails_or_times_out(monkeypatch, capsys):
    # the attention stage refuses the CPU: its process fails
    assert gpu_stage.main(["--device", "cpu", "--stages", "attention"]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["stages"]["attention"].startswith("failed (rc 1)")
    assert "attention_kernel" not in rec
    monkeypatch.setitem(gpu_stage.DEFAULT_TIMEOUTS, "touch", 0.01)
    assert gpu_stage.main(["--device", "cpu", "--stages", "touch"]) == 1
    assert json.loads(capsys.readouterr().out)["stages"]["touch"].startswith("timeout")


def test_gpu_stage_rejects_an_unknown_stage():
    with pytest.raises(SystemExit) as exit_:
        gpu_stage.main(["--device", "cpu", "--stages", "touch,nonsense"])
    assert exit_.value.code != 0


def test_runners_exit_non_zero_without_a_card(capsys):
    _no_cuda()
    assert gpu_smoke.main([]) == 1
    assert gpu_stage.main(["--stages", "touch"]) == 1
    err = capsys.readouterr()
    assert err.out == "" and err.err.count("--device cpu") == 2
