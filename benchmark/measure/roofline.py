"""What the work needs, counted from shapes, and the card's published
peaks: the yardstick of every roofline and utilization metric.

The flash count (:func:`flash_work`) and the int8 count
(:func:`int8_bound_s`) are frozen copies of ``chip_smoke.py``'s ``work``
and ``int8_bound_ms``: each input read once, each output written once,
products over the unmasked (query, key) pairs only.  Counts follow the
algorithm, never the implementation: padding, recomputation and masked
work are not counted."""

from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
#: bandwidth, at the full 700 W.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: The device kernels whose time the flash roofline divides, by entry.
FLASH_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
INT8_KERNEL = "int8_linear_tc_kernel"


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def flash_work(kernel: str, b: int, s: int, h: int, hk: int, d: int, causal: bool = True,
               elem: int = 2):
    """(bytes, flops) of one flash launch over [b, s, h, d] (hk K/V heads)."""
    q, kv, rows = b * h * s * d * elem, b * hk * s * d * elem, b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    if kernel == "flash_fwd_tc_kernel":  # q, k, v -> O, lse; QK^T and PV
        return 2 * q + 2 * kv + rows, 4 * pairs * d
    if kernel == "flash_bwd_dq_tc_kernel":  # q, k, v, dO, lse, dvec -> dQ
        return 3 * q + 2 * kv + 2 * rows, 6 * pairs * d
    if kernel == "flash_bwd_dkv_tc_kernel":  # q, k, v, dO, lse, dvec -> dK, dV
        return 4 * q + 2 * kv + 2 * rows, 8 * pairs * d
    raise ValueError(f"no flash count for {kernel}")


def int8_bound_s(m: int, k: int, n: int, elem: int = 2) -> float:
    """One int8 launch y[m, n] = x[m, k] . deq(q[n, k])^T + bias: q once,
    its fp32 scales, x, y and the bias; 2mnk operations."""
    nbytes = k * n + 4 * n + elem * (m * k + m * n + n)
    return bound_s(nbytes, 2 * m * n * k)


def int8_step_shapes(model: Dict):
    """(K, N, launches) of every int8 matmul of one decode step."""
    d, f, layers = model["d_model"], model["d_ff"], model["n_layers"]
    return [(d, d, 4 * layers), (d, f, layers), (f, d, layers), (d, model["vocab_size"], 1)]


def dense_weights(model: Dict) -> int:
    """Weights of every matmul: q/k/v/out, the MLP and the LM head (not
    the embedding tables, which are gathered)."""
    d, f = model["d_model"], model["d_ff"]
    return model["n_layers"] * (4 * d * d + 2 * d * f) + d * model["vocab_size"]


def train_flops_per_step(model: Dict, batch: int, seq_len: int) -> float:
    """One training step on [batch, seq_len] tokens, which trains on
    seq_len - 1 positions a row: 6 x the matmul weights a token (forward
    2, backward 4), and causal attention's 12 x d a (query, key) pair of
    the mask (forward QK^T and PV 4, backward 8) in every layer."""
    s = seq_len - 1
    pairs = s * (s + 1) // 2
    attention = 12 * model["n_layers"] * batch * pairs * model["d_model"]
    return 6.0 * dense_weights(model) * batch * s + attention


def decode_step_bound_s(model: Dict, batch: int, filled: int) -> float:
    """The least time of one decode step of *batch* rows, each attending
    over *filled* cached positions: its operations (2 a matmul weight a
    row, and QK^T and PV over the filled positions), or its bytes: each
    int8 weight and fp32 scale once, the float leaves, the embedding rows,
    each row's filled K/V positions once in bf16 and the new ones
    written."""
    d, f, layers, v = model["d_model"], model["d_ff"], model["n_layers"], model["vocab_size"]
    dense = dense_weights(model)
    scales = layers * (4 * d + f + d) + v + 2 * d  # per output channel, and per table column
    floats = 4 * (layers * (4 * d + 4 * d + f + d) + 2 * d + v)  # LayerNorms and biases
    embeds = batch * 2 * d
    cache = 2 * layers * d * 2 * batch * (filled + 1)
    nbytes = dense + 4 * scales + floats + embeds + cache
    flops = 2 * dense * batch + 4 * layers * batch * filled * d
    return bound_s(nbytes, flops)
