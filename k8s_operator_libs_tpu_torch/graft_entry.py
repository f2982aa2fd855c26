"""The single-device entry point of the port: a loss step on TinyLM.

The port of ``entry`` in the JAX package's ``__graft_entry__.py``: the
same configuration (vocab 256, d_model 128, 8 heads, 2 layers, d_ff 512,
seq 128, bf16) and batch (8 rows of ``make_batch`` seed 0).
"""

from __future__ import annotations

import torch

from .tpu import workload as wl


def entry(device="cuda"):
    """Returns ``(fn, (model, tokens))``, where ``fn(model, tokens)`` is
    :func:`~.tpu.workload.loss_fn`: the next-token loss of the batch."""
    config = wl.ModelConfig(
        vocab_size=256,
        d_model=128,
        n_heads=8,
        n_layers=2,
        d_ff=512,
        max_seq_len=128,
        dtype=torch.bfloat16,
    )
    device = wl.resolve_device(device)
    model, _optimizer = wl.create_train_state(config, device)
    tokens = wl.make_batch(config, batch_size=8, device=device)
    return wl.loss_fn, (model, tokens)
