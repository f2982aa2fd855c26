"""Train, time, drain, restore and resume on the card.

The port of the trainer and drain part of
``k8s_operator_libs_tpu/tpu/smoke.py``:

* :func:`detect_gpu` — the CUDA device, or None;
* :func:`run_smoke` — train :class:`~.workload.TinyLM` for a few timed
  steps (bf16 on the card), then drive the checkpoint-on-drain handshake:
  the orchestrator side requests a pre-drain checkpoint through the node
  annotation, the :class:`~.workload.CheckpointingTrainer` observes it
  between steps, saves, acknowledges and stops; a fresh trainer then
  resumes from the restored checkpoint;
* :func:`_decode_bench` — KV-cache greedy decoding of the just-trained
  weights, float and weight-only int8: tokens/s, ms/token, the int8
  speedup and token agreement (``run_smoke``'s ``decode``).

Every result names the device it ran on.  ``run_stage`` and the matmul
bench of the JAX module are later slices (ROADMAP).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

#: Published dense bf16 peak TFLOP/s, matched as a substring of
#: ``torch.cuda.get_device_name``: the H100 SXM data sheet's 989.  MFU is
#: stated against it whatever the card's power limit.
_PEAK_BF16_TFLOPS = {"H100": 989.0}


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


def _decode_bench(config, model, new_tokens: int = 0) -> Dict[str, Any]:
    """KV-cache greedy decoding throughput at batch 8 from a 16-token
    prompt (``default_rng(0)``), float and then int8
    (:func:`~.workload.quantize_model`), each timed after a warm call.
    *new_tokens* 0 decodes the rest of the context window."""
    import numpy as np

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
        "tokens_per_s": b * new_tokens / elapsed,
        "ms_per_token": elapsed / new_tokens * 1e3,
        "int8": {
            "tokens_per_s": b * new_tokens / elapsed_q,
            "speedup_vs_float": elapsed / elapsed_q,
            "token_agreement": float((out == out_q).float().mean()),
        },
    }


def run_smoke(
    checkpoint_dir: str,
    steps: int = 10,
    warmup: int = 2,
    batch_size: int = 8,
    config=None,
    device="cuda",
) -> Dict[str, Any]:
    """Train, time, drain-checkpoint, resume; returns the measurement
    dict (see module docstring).  Raises when any phase fails."""
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
    watcher = DrainSignalWatcher(nodes, "gpu-host")
    trainer = CheckpointingTrainer(
        config,
        checkpoint_dir,
        watcher=watcher,
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
    gpu = detect_gpu() if device.type == "cuda" else None
    result: Dict[str, Any] = {
        "platform": "gpu" if gpu else "cpu",
        "device_kind": gpu["device_kind"] if gpu else "cpu",
        "warmup_steps": max(warmup, 1),
        "timed_steps": steps,
        "step_time_ms": step_ms,
        "tokens_per_s": batch_size * config.max_seq_len * steps / elapsed,
        "model": {
            "d_model": config.d_model,
            "n_layers": config.n_layers,
            "seq_len": config.max_seq_len,
            "batch": batch_size,
            "dtype": str(config.dtype).replace("torch.", ""),
            "flash_attention": config.flash_attention,
            "params": sum(p.numel() for p in trainer.model.parameters()),
        },
        "final_loss": float(loss),
    }
    flops = _train_flops_per_step(config, trainer.model, batch_size)
    result["achieved_tflops"] = flops / (step_ms / 1e3) / 1e12
    peak = peak_bf16_tflops(result["device_kind"])
    if gpu and peak:
        result["mfu_pct"] = 100.0 * result["achieved_tflops"] / peak
    # serving with the just-trained weights: the rest of the context
    # window on the card, a few tokens on the CPU
    new_tokens = 0 if gpu else min(32, config.max_seq_len - 16)
    if gpu or new_tokens > 0:
        result["decode"] = _decode_bench(config, trainer.model, new_tokens)

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
        "ack": ack,
        "resumed_steps": resumed.step - completed,
        "resumed_loss": resumed.losses[-1],
    }
    return result
