"""Measure the port on the card: train, time, drain, restore and resume,
and the staged benches.

The port of ``k8s_operator_libs_tpu/tpu/smoke.py``:

* :func:`detect_gpu` — the CUDA device, or None;
* :func:`run_smoke` — train :class:`~.workload.TinyLM` for a few timed
  steps (bf16 on the card), then drive the checkpoint-on-drain handshake:
  the orchestrator side requests a pre-drain checkpoint through the node
  annotation, the :class:`~.workload.CheckpointingTrainer` observes it
  between steps, saves, acknowledges and stops; a fresh trainer then
  resumes from the restored checkpoint.  With *kernel_sections* it adds
  the attention and decode benches on the card, and the decode bench and
  the flash sanity check on the CPU;
* :data:`STAGES` and :func:`run_stage` — one isolated measurement each,
  cheapest first, for the staged runner
  (``python -m k8s_operator_libs_tpu_torch.hack.gpu_stage``);
* the benches: :func:`_touch_bench`, :func:`_matmul_bench`,
  :func:`_attention_bench`, :func:`_decode_bench` and
  :func:`_flash_interpret_sanity`.

The record is the JAX module's: the same keys, each value rounded where
that module rounds it, to the same places.  Every record names the
device it ran on.  Unlike the JAX module, a failing section raises: no
failure is turned into an ``{"error": ...}`` entry of a record.
"""

from __future__ import annotations

import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

#: Published dense bf16 peak TFLOP/s, matched as a substring of
#: ``torch.cuda.get_device_name``: the H100 SXM data sheet's 989.  MFU is
#: stated against it whatever the card's power limit.
_PEAK_BF16_TFLOPS = {"H100": 989.0}

#: The staged-measurement vocabulary, cheapest first.  ``touch`` is one
#: 8x8 matmul: the cheapest proof that the device computes at all.
STAGES = ("touch", "matmul", "train", "attention", "decode", "drain")


def detect_gpu() -> Optional[Dict[str, Any]]:
    """``{platform, device_kind, n_devices, capability}`` when torch sees
    a CUDA device, else None."""
    if not torch.cuda.is_available():
        return None
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "n_devices": torch.cuda.device_count(),
        "capability": ".".join(map(str, torch.cuda.get_device_capability(0))),
    }


def peak_bf16_tflops(device_kind: str) -> Optional[float]:
    for key, peak in _PEAK_BF16_TFLOPS.items():
        if key in device_kind:
            return peak
    return None


def _stamp(device: torch.device) -> Dict[str, str]:
    """The platform and device kind every record carries."""
    if device.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "device_kind": "cpu"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _train_flops_per_step(config, model, batch_size: int) -> float:
    """Scaling-book train-step FLOPs estimate: 6·P per token for the
    matmul stack (fwd 2·P, bwd 4·P) plus the attention score/weight
    terms 12·L·S²·D per sequence (fwd+bwd, causal halving ignored —
    the convention MFU tables use).  As written in the JAX package, so
    the two MFU figures compare."""
    n_params = sum(p.numel() for p in model.parameters())
    tokens = batch_size * config.max_seq_len
    dense = 6.0 * n_params * tokens
    attn = 12.0 * config.n_layers * batch_size * config.max_seq_len**2 * config.d_model
    return dense + attn


def smoke_config(device: torch.device):
    """The repo's chip configuration (``smoke.py`` of the JAX package):
    vocab 2048, d_model 512, 8 heads, 4 layers, d_ff 2048, seq 256; bf16
    on the card, fp32 on the CPU."""
    from .workload import ModelConfig

    return ModelConfig(
        vocab_size=2048,
        d_model=512,
        n_heads=8,
        n_layers=4,
        d_ff=2048,
        max_seq_len=256,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_ms(fn: Callable[[], Any], iters: int, device: torch.device) -> float:
    """Milliseconds per call of *fn* on the host clock: one warm call,
    then *iters* calls ending in a synchronize."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def _touch_bench(device: torch.device) -> Dict[str, Any]:
    """One 8x8 matmul on the device, timed from dispatch to readback."""
    t0 = time.perf_counter()
    a = torch.ones(8, 8, device=device)
    checksum = float((a @ a).sum())  # the readback waits for the device
    wall_ms = (time.perf_counter() - t0) * 1e3
    return {"first_compute_ms": round(wall_ms, 1), "checksum": checksum}


def _matmul_bench(device: torch.device, iters: int = 30) -> Dict[str, Any]:
    """One large matmul, timed: n 4096 in bf16 on the card (137 GFLOP a
    call), n 1024 in fp32 on the CPU, where 4096 would take seconds a
    call.  ``torch.matmul``, as the JAX module times ``x @ y`` outside
    any Pallas kernel."""
    cuda = device.type == "cuda"
    n = 4096 if cuda else 1024
    dtype = torch.bfloat16 if cuda else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, device=device, generator=gen, dtype=dtype)
    b = torch.randn(n, n, device=device, generator=gen, dtype=dtype)
    ms = _timed_ms(lambda: a @ b, iters, device)
    return {
        "n": n,
        "dtype": _dtype_name(dtype),
        "ms_per_matmul": round(ms, 3),
        "tflops": round(2 * n**3 / (ms / 1e3) / 1e12, 1),
    }


def _attention_bench(device: torch.device, iters: int = 30) -> Dict[str, Any]:
    """The flash kernels against :func:`~.ring_attention.dense_reference`
    (b 4, h 8, d 64, bf16, causal) at s 1024 and 2048, forward only; then
    fwd+bwd of flash at s 8192, 5 timed calls after a warm one.  On the
    card only: the plain version at s 8192 would hold fp32 scores of
    8 GiB."""
    from .flash_attention import flash_attention
    from .ring_attention import dense_reference

    if device.type != "cuda":
        raise ValueError(f"the attention bench runs on the card, not on {device}")
    rng = np.random.default_rng(0)
    b, h, d = 4, 8, 64

    def mk(s):
        x = torch.from_numpy(rng.standard_normal((b, s, h, d)))
        return x.to(device, torch.bfloat16)

    out: Dict[str, Any] = {}
    for s in (1024, 2048):
        q, k, v = mk(s), mk(s), mk(s)
        flash = _timed_ms(lambda: flash_attention(q, k, v, True, 128, 128), iters, device)
        dense = _timed_ms(lambda: dense_reference(q, k, v, True), iters, device)
        out[f"seq_{s}"] = {
            "flash_ms": round(flash, 3),
            "dense_ms": round(dense, 3),
            "speedup": round(dense / flash, 3),
        }
        del q, k, v
    s = 8192
    q, k, v = (mk(s).requires_grad_() for _ in range(3))

    def train_step():
        loss = flash_attention(q, k, v, True, 128, 128).float().sum()
        return torch.autograd.grad(loss, (q, k, v))

    out["seq_8192_train"] = {
        "flash_fwd_bwd_ms": round(_timed_ms(train_step, 5, device), 3),
        "dense": "not timed at this shape, as in the JAX package (fp32 score "
        "and weight temps of 8 GiB each); SDPA's fwd+bwd at s 8192 is timed "
        "by chip_smoke.py's time_shape",
    }
    return out


def _decode_bench(config, model, new_tokens: int = 0) -> Dict[str, Any]:
    """KV-cache greedy decoding throughput at batch 8 from a 16-token
    prompt (``default_rng(0)``), float and then int8
    (:func:`~.workload.quantize_model`), each timed after a warm call.
    *new_tokens* 0 decodes the rest of the context window."""
    from .workload import generate, quantize_model

    device = next(model.parameters()).device
    b = 8
    new_tokens = new_tokens or (config.max_seq_len - 16)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, config.vocab_size, (b, 16))).to(device)

    def timed(served):
        generate(config, served, prompt, new_tokens, device=device)  # warm
        _sync(device)
        t0 = time.perf_counter()
        out = generate(config, served, prompt, new_tokens, device=device)
        _sync(device)
        return out, time.perf_counter() - t0

    out, elapsed = timed(model)
    out_q, elapsed_q = timed(quantize_model(model))
    return {
        "batch": b,
        "new_tokens": new_tokens,
        "tokens_per_s": round(b * new_tokens / elapsed, 1),
        "ms_per_token": round(elapsed / new_tokens * 1e3, 3),
        "int8": {
            "tokens_per_s": round(b * new_tokens / elapsed_q, 1),
            "speedup_vs_float": round(elapsed / elapsed_q, 3),
            "token_agreement": round(float((out == out_q).float().mean()), 3),
        },
    }


def _flash_interpret_sanity(iters: int = 3) -> Dict[str, Any]:
    """The flash wrapper's CPU route against the dense reference on a
    small shape (b 2, s 128, h 2, d 64, fp32, blocks of 64): max abs
    error, raising past 2e-3, and a wall-clock sanity number.

    The key keeps the JAX module's name, ``flash_interpret``, because it
    is part of the record.  The port has no interpret mode: on the CPU
    the wrapper runs the kernels' plain versions, so this holds that
    route, not a kernel, and its time is no performance claim."""
    from .flash_attention import flash_attention
    from .ring_attention import dense_reference

    rng = np.random.default_rng(0)
    b, s, h, d = 2, 128, 2, 64
    q, k, v = (
        torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
        for _ in range(3)
    )
    t0 = time.perf_counter()
    for _ in range(iters):
        out = flash_attention(q, k, v, True, 64, 64)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    err = float((out - dense_reference(q, k, v, True)).abs().max())
    if err > 2e-3:
        raise RuntimeError(f"flash CPU route mismatch: max abs err {err}")
    return {
        "shape": f"b{b} s{s} h{h} d{d}",
        "max_abs_err": round(err, 6),
        "interpret_ms": round(wall_ms, 1),
    }


def run_smoke(
    checkpoint_dir: str,
    steps: int = 10,
    warmup: int = 2,
    batch_size: int = 8,
    config=None,
    drain: bool = True,
    kernel_sections: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """Train, time, drain-checkpoint, resume; returns the measurement
    dict (see module docstring).  Raises when any phase fails.
    *drain* False returns before the handshake, with no watcher;
    *kernel_sections* False leaves out the benches (the staged stages
    time them separately)."""
    from ..cluster.inmem import InMemoryNodeStore, make_node
    from ..upgrade import consts, util
    from .drain_handshake import DrainSignalWatcher
    from .workload import (
        CheckpointingTrainer,
        make_batch,
        resolve_device,
        restore_checkpoint,
    )

    device = resolve_device(device)
    config = config or smoke_config(device)

    # ---- orchestrator side: a node carrying the drain annotation ----
    nodes = InMemoryNodeStore()
    nodes.create(make_node("gpu-host"))
    trainer = CheckpointingTrainer(
        config,
        checkpoint_dir,
        watcher=DrainSignalWatcher(nodes, "gpu-host") if drain else None,
        batch_size=batch_size,
        device=device,
    )

    # ---- timed training (first-call set-up excluded via warmup) ----
    batch = make_batch(config, batch_size, seed=0, device=device)
    for _ in range(max(warmup, 1)):
        loss = trainer.step_fn(batch)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = trainer.step_fn(make_batch(config, batch_size, seed=i + 1, device=device))
    _sync(device)
    elapsed = time.perf_counter() - t0
    step_ms = elapsed / steps * 1e3
    result: Dict[str, Any] = {
        **_stamp(device),
        "step_time_ms": round(step_ms, 3),
        "tokens_per_s": round(batch_size * config.max_seq_len * steps / elapsed, 1),
        "model": {
            "d_model": config.d_model,
            "n_layers": config.n_layers,
            "seq_len": config.max_seq_len,
            "batch": batch_size,
            "dtype": _dtype_name(config.dtype),
            "params": sum(p.numel() for p in trainer.model.parameters()),
        },
        "final_loss": round(float(loss), 4),
    }
    flops = _train_flops_per_step(config, trainer.model, batch_size)
    achieved_tflops = flops / (step_ms / 1e3) / 1e12
    # significant figures, not decimal places: a small model on the CPU
    # achieves ~1e-5 TFLOP/s and must not round to 0.0
    result["achieved_tflops"] = float(f"{achieved_tflops:.3g}")
    peak = peak_bf16_tflops(result["device_kind"])
    if device.type == "cuda" and peak:
        result["mfu_pct"] = round(100.0 * achieved_tflops / peak, 2)
    if kernel_sections and device.type == "cuda":
        result["attention_kernel"] = _attention_bench(device)
        result["decode"] = _decode_bench(config, trainer.model)
    elif kernel_sections:
        # a few tokens on the CPU; a tiny config leaves no room to decode
        cpu_tokens = min(32, config.max_seq_len - 16)
        if cpu_tokens > 0:
            result["decode"] = _decode_bench(config, trainer.model, new_tokens=cpu_tokens)
        result["flash_interpret"] = _flash_interpret_sanity()

    if not drain:
        return result

    # ---- checkpoint-on-drain handshake, then resume ----
    trainer.step = steps  # timed steps above bypassed run()'s counter
    key = util.get_pre_drain_checkpoint_annotation_key()
    token = "smoke-1"
    nodes.patch(
        "Node",
        "gpu-host",
        {"metadata": {"annotations": {key: f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}"}}},
    )
    completed = trainer.run(50)  # must stop at the drain, not at 50
    ack = nodes.get("Node", "gpu-host")["metadata"]["annotations"].get(key, "")
    # explicit raises, not asserts: they must survive python -O
    if not trainer.drained:
        raise RuntimeError("trainer ignored the drain request")
    if ack != f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}":
        raise RuntimeError(f"drain not acknowledged with the echoed token: {ack!r}")
    restored = restore_checkpoint(checkpoint_dir, completed, map_location=device)
    if restored["step"] != completed:
        raise RuntimeError(
            f"checkpoint step {restored['step']} != drained step {completed}"
        )
    # resume: a fresh trainer continues from the restored state
    resumed = CheckpointingTrainer(
        config, checkpoint_dir, watcher=None, batch_size=batch_size, device=device
    )
    resumed.load(restored)
    resumed.run(2)
    if resumed.step != completed + 2:
        raise RuntimeError(f"resume ran to step {resumed.step}, want {completed + 2}")
    result["drain_handshake"] = {
        "checkpoint_step": completed,
        "ack": ack.split(":", 1)[0],
        "resumed_steps": resumed.step - completed,
        "resumed_loss": round(resumed.losses[-1], 4),
    }
    return result


def run_stage(
    stage: str,
    checkpoint_dir: Optional[str] = None,
    steps: int = 10,
    batch_size: int = 8,
    device="cuda",
) -> Dict[str, Any]:
    """One isolated measurement stage of :data:`STAGES`, stamped with the
    platform and device kind.  ``train`` and ``drain`` are
    :func:`run_smoke` without the benches (``drain`` at 2 timed steps);
    ``decode`` benches the smoke configuration from fresh seed-0
    weights."""
    from .workload import CheckpointingTrainer, resolve_device

    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; want one of {STAGES}")
    device = resolve_device(device)
    stamp = _stamp(device)
    if stage == "touch":
        return {**stamp, "touch": _touch_bench(device)}
    if stage == "matmul":
        return {**stamp, "matmul": _matmul_bench(device)}
    if stage == "attention":
        return {**stamp, "attention_kernel": _attention_bench(device)}
    with tempfile.TemporaryDirectory(prefix="gpu-stage-") as tmp:
        ckpt = checkpoint_dir or tmp
        if stage == "decode":
            config = smoke_config(device)
            trainer = CheckpointingTrainer(
                config, ckpt, watcher=None, batch_size=batch_size, device=device
            )
            new_tokens = 0 if device.type == "cuda" else 32
            return {**stamp, "decode": _decode_bench(config, trainer.model, new_tokens)}
        if stage == "train":
            return run_smoke(
                ckpt, steps=steps, batch_size=batch_size, drain=False,
                kernel_sections=False, device=device,
            )
        rec = run_smoke(
            ckpt, steps=2, batch_size=batch_size, drain=True,
            kernel_sections=False, device=device,
        )
        return {**stamp, "drain_handshake": rec["drain_handshake"]}
