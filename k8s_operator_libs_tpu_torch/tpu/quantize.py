"""Weight-only int8 quantization for serving, and its int8 matmul kernel.

The port of ``k8s_operator_libs_tpu/tpu/quantize.py``.  Decode is bound
by the bytes of the weights, and int8 weights with per-output-channel
fp32 scales halve them against bf16.  The functions work on the port's
``state_dict`` (or a :class:`~.workload.TinyLM`) and give the JAX
package's numbers: each quantizable leaf is quantized in flax's layout,
through :mod:`..convert`, so the scales reduce over the axes JAX reduces
over and keep JAX's shapes:

* ``attn/{query,key,value}`` kernels ``[d, h, hd]`` and biases ``[h, hd]``
  scale per ``hd`` column, shared across heads (``s`` is ``[1, 1, hd]`` /
  ``[1, hd]``);
* ``Embed`` tables ``[num, features]`` scale per feature column;
* ``attn/out``, ``mlp_*``, ``lm_head`` and the MoE ``router`` kernels
  scale per output column, which is per row of the torch weight;
* the MoE's ``experts_up`` ``[E, d, f]`` and ``experts_down`` ``[E, f, d]``
  (flax's layout in both) scale per last-axis column, shared across
  experts (``s`` is ``[1, 1, f]`` / ``[1, 1, d]``);
* 1-D leaves (LayerNorm, the other biases) stay float.

A quantized state maps each key to a tensor or to a ``{"q", "s"}`` node,
``q`` int8 in the torch layout and ``s`` in JAX's shape.

The JAX package relies on XLA to fuse the dequantize into each consuming
matmul (``quantize.py:74-84``).  Eager PyTorch does not fuse, so the fusion
is hand-written CUDA, ``csrc/int8_matmul.cu``: :func:`int8_linear` launches
it for a CUDA tensor and runs :func:`int8_linear_plain` only for a CPU one.
bf16 runs on the tensor cores (``int8_linear_tc_kernel``, under the launch
plan of :func:`int8_plan`), fp32 on CUDA cores; :data:`DEVICE_KERNELS`
names the device kernel of each dtype.  The wrapper counts its launches in
:data:`launch_counts`, and by device kernel in :data:`device_launch_counts`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..convert import is_quant_node, params_from_jax, params_to_jax

#: Launches of the int8 kernel, counted by its wrapper right after the
#: launch was accepted.  The plain version does not count.
launch_counts: Dict[str, int] = {"int8_linear": 0}

#: The device kernel (in csrc/int8_matmul.cu) the entry point launches, by
#: dtype.
DEVICE_KERNELS: Dict[str, Dict[torch.dtype, str]] = {
    "int8_linear": {
        torch.bfloat16: "int8_linear_tc_kernel",
        torch.float32: "int8_linear_kernel<float>",
    },
}

#: Launches by device kernel, counted beside :data:`launch_counts`.
device_launch_counts: Dict[str, int] = {
    name: 0 for kernels in DEVICE_KERNELS.values() for name in kernels.values()
}

_X_DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for counts in (launch_counts, device_launch_counts):
        for name in counts:
            counts[name] = 0


# ------------------------------------------------------- the tree functions


def _quantize_leaf(leaf):
    """JAX's symmetric per-output-channel int8 of one flax-layout leaf:
    the scale reduces over every axis but the last (1.0 where the amax
    is 0), rounding half to even in fp32, ``q`` clipped to +-127."""
    if leaf.ndim < 2:
        return leaf
    f = leaf.astype(np.float32)
    amax = np.max(np.abs(f), axis=tuple(range(f.ndim - 1)), keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(f / scale), -127, 127).astype(np.int8)
    return {"q": q, "s": scale}


def _map_tree(fn, tree: Mapping):
    return {k: _map_tree(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def _state_of(params) -> Dict[str, Any]:
    """The state dict of a TinyLM, or a state dict with its numpy leaves
    as tensors."""
    if isinstance(params, nn.Module):
        return params.state_dict()
    return {k: v if is_quant_node(v) else torch.as_tensor(v) for k, v in params.items()}


def quantize_params_int8(params, n_heads: Optional[int] = None) -> Dict[str, Any]:
    """Symmetric per-output-channel int8 quantization of every leaf that
    is >= 2-D in flax's layout (kernels, embeddings, the q/k/v biases).
    *params* is a TinyLM, or its state dict (tensor or numpy leaves) with
    *n_heads*; the result lies on the CPU."""
    if n_heads is None:
        if not isinstance(params, nn.Module):
            raise ValueError("a state dict needs n_heads (a TinyLM carries its own)")
        n_heads = params.config.n_heads
    jax_tree = params_to_jax(_state_of(params), n_heads)
    return params_from_jax(_map_tree(_quantize_leaf, jax_tree))


def scale_like(key: str, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """*s* (JAX's shape) broadcast against *q* (the torch layout of leaf
    *key*): per column of an embedding table, per last-axis column of an
    expert tensor (flax's layout, shared by the experts); otherwise per
    row, tiled over the heads of a q/k/v weight or bias."""
    s = s.reshape(-1).float()
    if key.endswith("embedding"):
        return s.reshape(1, -1)
    if key.rsplit(".", 1)[-1].startswith("experts_"):
        return s.reshape(1, 1, -1)
    if q.shape[0] % s.numel():
        raise ValueError(f"{key}: {s.numel()} scales do not tile {q.shape[0]} rows")
    return s.repeat(q.shape[0] // s.numel()).reshape(-1, *([1] * (q.dim() - 1)))


def dequantize_leaf(key: str, node, dtype=torch.float32) -> torch.Tensor:
    """``(float(q) * s).to(dtype)`` of one node, in the torch layout."""
    q, s = node["q"], node["s"]
    return (q.float() * scale_like(key, q, s.to(q.device))).to(dtype)


def dequantize_params(qparams: Mapping[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """A float state dict from :func:`quantize_params_int8` output."""
    return {k: dequantize_leaf(k, v, dtype) if is_quant_node(v) else v for k, v in qparams.items()}


def quantization_error(params, qparams: Mapping[str, Any]) -> float:
    """Worst per-tensor relative reconstruction error (Frobenius-norm
    ratio, fp32) across the quantized leaves."""
    state = _state_of(params)
    worst = 0.0
    for key, node in qparams.items():
        if not is_quant_node(node):
            continue
        a = state[key].detach().to("cpu", torch.float32).flatten()
        b = dequantize_leaf(key, {k: t.cpu() for k, t in node.items()}).flatten()
        denom = float(torch.linalg.norm(a)) or 1.0
        worst = max(worst, float(torch.linalg.norm(a - b)) / denom)
    return worst


def quantized_bytes(qparams: Mapping[str, Any]) -> int:
    """Total parameter bytes as stored: int8 + scales + float residue."""
    total = 0
    for value in qparams.values():
        for t in value.values() if is_quant_node(value) else (value,):
            t = torch.as_tensor(t)
            total += t.numel() * t.element_size()
    return total


# -------------------------------------------------------- the int8 matmul


def int8_linear_plain(x, q, s, bias=None):
    """Plain version of the kernel: ``x . deq(q)^T + bias`` with the
    dequantized weight rounded to x's dtype, as JAX's dequantize-then-
    matmul rounds it."""
    w = (q.float() * s[:, None]).to(x.dtype)
    return F.linear(x, w, None if bias is None else bias.to(x.dtype))


#: The bf16 kernel's tile: 16 output rows per block (mma.sync's m16 side),
#: 8 rows of x (its n8 side), K in chunks of 64 (16 bytes of q per lane
#: and row); at most 8 warps per block and 8 blocks per cluster.
INT8_TILE_ROWS, INT8_TILE_M, INT8_K_CHUNK = 16, 8, 64
INT8_MAX_WARPS, INT8_MAX_CLUSTER = 8, 8
#: Chunks of q a warp keeps in flight (the kernel's ring, kTcStages).  A
#: cluster is formed only while a warp's slice would not fit in it: once
#: it fits, all of q is requested at the start, and a cluster's barrier
#: costs more than it saves (PERF.md §6).
INT8_RING_CHUNKS = 2


@dataclass(frozen=True)
class Int8Plan:
    """How ``int8_linear_tc_kernel`` covers ``y[m, n] = x[m, k] . q^T``:
    blocks of ``rows_per_block`` output rows, each cluster of ``cluster``
    blocks sharing one tile of rows, ``k_warps`` warps per block, and warp
    ``w`` of the block of cluster rank ``r`` summing K slice ``r * k_warps +
    w``, ``k_slices[r * k_warps + w]`` (``[begin, end)`` in K)."""

    rows_per_block: int
    k_warps: int
    cluster: int
    grid: Tuple[int, int]
    k_slices: Tuple[Tuple[int, int], ...]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=256)
def int8_plan(m: int, k: int, n: int, n_sms: int) -> Int8Plan:
    """The bf16 kernel's launch plan, a pure function of the shape and the
    card's SM count.  K is cut into 64-wide chunks, shared out among the
    warps of a block (8, or 4 once the grid has a block per SM) and, while
    the grid is smaller than the card and each warp would still walk more
    than :data:`INT8_RING_CHUNKS` chunks, among the blocks of a cluster
    (doubling, to at most 8).  The slices are contiguous, as even as the
    chunks allow, and in K order: the kernel sums them in that order, so a
    plan fixes the result bit for bit."""
    if min(m, k, n, n_sms) < 1:
        raise ValueError(f"int8_plan: m, k, n and n_sms must be >= 1, got {(m, k, n, n_sms)}")
    tiles = -(-n // INT8_TILE_ROWS)
    m_tiles = -(-m // INT8_TILE_M)
    chunks = -(-k // INT8_K_CHUNK)
    # 8 warps a block while the grid is smaller than the card; past that,
    # 4, whose smaller blocks pack the SMs more evenly
    k_warps = min(INT8_MAX_WARPS if tiles * m_tiles < n_sms else INT8_MAX_WARPS // 2, chunks)
    cluster = 1
    while (cluster < INT8_MAX_CLUSTER and tiles * cluster * m_tiles < n_sms
           and chunks > INT8_RING_CHUNKS * k_warps * cluster):
        cluster *= 2
    slices = cluster * k_warps
    cuts = [min(k, INT8_K_CHUNK * (j * chunks // slices)) for j in range(slices + 1)]
    return Int8Plan(
        rows_per_block=INT8_TILE_ROWS,
        k_warps=k_warps,
        cluster=cluster,
        grid=(tiles * cluster, m_tiles),
        k_slices=tuple(zip(cuts, cuts[1:])),
    )


def _check_kernel_inputs(x, q, s, bias) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"int8_linear: x dtype {x.dtype} not in {_X_DTYPES}")
    if q.dtype != torch.int8 or q.dim() != 2 or x.shape[-1] != q.shape[1]:
        raise ValueError(
            f"int8_linear: q must be int8 [N, K] with K = x's last dim {x.shape[-1]}, "
            f"got {q.dtype} {tuple(q.shape)}"
        )
    if s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0],):
        raise ValueError(f"int8_linear: s must be fp32 [{q.shape[0]}]")
    if bias is not None and (bias.dtype != x.dtype or tuple(bias.shape) != (q.shape[0],)):
        raise ValueError(f"int8_linear: bias must be {x.dtype} [{q.shape[0]}]")
    tensors = [t for t in (x, q, s, bias) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("int8_linear: tensors must be contiguous on one device")
    # 16-byte loads of q and x rows
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("int8_linear: x and q must start on a 16-byte boundary")
    if x.numel() == 0 or q.numel() == 0:
        raise ValueError("int8_linear: empty operand")


def _int8_linear_cuda(x, q, s, bias=None):
    _check_kernel_inputs(x, q, s, bias)
    lib = _build.load("int8_matmul")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {x.device}, but the current CUDA device is {torch.cuda.current_device()}"
        )
    n, k = q.shape
    m = x.numel() // k
    plan = int8_plan(m, k, n, torch.cuda.get_device_properties(x.device).multi_processor_count)
    y = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    _build.check(
        lib.int8_linear(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), 0 if bias is None else bias.data_ptr(),
            y.data_ptr(), m, k, n, int(x.dtype == torch.bfloat16), plan.k_warps, plan.cluster,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "int8_linear",
    )
    launch_counts["int8_linear"] += 1
    device_launch_counts[DEVICE_KERNELS["int8_linear"][x.dtype]] += 1
    return y


def int8_linear(x, q, s, bias=None):
    """``y[..., N] = x[..., K] . deq(q)^T + bias`` with q int8 [N, K] and
    s the fp32 scale of each row of q: the CUDA kernel for a CUDA x, the
    plain version for a CPU one."""
    if x.is_cuda:
        return _int8_linear_cuda(x, q, s, bias)
    if x.device.type == "cpu":
        return int8_linear_plain(x, q, s, bias)
    raise ValueError(f"int8_linear has no kernel for device {x.device}")
