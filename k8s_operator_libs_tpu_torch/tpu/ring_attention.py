"""The dense attention oracle of ``k8s_operator_libs_tpu/tpu/ring_attention.py``.

Only ``_NEG`` and :func:`dense_reference` are ported so far; ring attention
itself is a later slice (ROADMAP).
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30  # mask value: large-negative, not -inf (no NaN via exp)


def dense_reference(q, k, v, causal: bool = True):
    """Plain softmax attention (fp32 math) — the correctness oracle.
    Shapes: [batch, seq, heads, head_dim]; returns q's dtype."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)
