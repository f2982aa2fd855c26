"""Flash attention — hand-written CUDA kernels for the H100.

The port of ``k8s_operator_libs_tpu/tpu/flash_attention.py``.  Its three
Pallas TPU kernels become three CUDA kernels in
``csrc/flash_attention.cu`` (built by :mod:`.._build`):

* forward (``_flash_kernel``): ``(q, k, v) -> (O, lse)``, one thread block
  per (batch*head, q-tile) folding K/V tiles into an fp32 online softmax;
* dQ (``_flash_bwd_dq_kernel``): ``(q, k, v, dO, lse, dvec) -> dQ``;
* dK/dV (``_flash_bwd_dkv_kernel``): ``(q, k, v, dO, lse, dvec) -> (dK,
  dV)`` per query head; the GQA group-sum runs here, in torch.

All three run bf16 on the tensor cores (wgmma) and fp32 on scalar
kernels; :data:`DEVICE_KERNELS` names the device kernel each (entry
point, dtype) launches.  The kernels are compiled for the head dims of
:data:`HEAD_DIMS`; a narrower head is zero-padded to the next of them
and its outputs sliced back (:func:`head_padded`), at the softmax scale
of its true width.

Beside each kernel sits its plain PyTorch version: dense, fp32, masked
with ``_NEG``.  A wrapper takes the plain version only for a tensor on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.  Each
wrapper counts its launches in :data:`launch_counts`, and by device
kernel in :data:`device_launch_counts`.

Beside them, :func:`decode_attention` runs a decode step's cached
attention on ``csrc/decode_attention.cu``: one query a row against the
written prefix of a :class:`.workload.KVCache` layer, read in place.  It
replaces no Pallas kernel (the JAX package leaves cached attention to
flax and XLA); its plain version is that attention, dense and masked.

The public functions keep the JAX layout ``[batch, seq, heads, head_dim]``
and fold to ``[batch*heads, seq, head_dim]`` inside.  ``block_q`` and
``block_k`` keep their meaning for validation and padding; the CUDA
kernels choose their own tiles and take any sequence length.  The row
term ``dvec = rowsum(dO * O) - g_lse`` stays a torch reduction outside the
kernels, as it stays outside Pallas in JAX.
"""

from __future__ import annotations

import math
import operator
from functools import lru_cache, partial
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .ring_attention import _NEG, dense_reference

#: Launches of each CUDA kernel, counted by its wrapper right after the
#: launch was accepted.  The plain versions do not count.
launch_counts: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "decode_attention": 0,
}

#: The entry points of the flash kernels (the train and ring paths).
FLASH_ENTRIES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

#: The device kernel (in csrc/flash_attention.cu) each entry point
#: launches, by dtype.
DEVICE_KERNELS: Dict[str, Dict[torch.dtype, str]] = {
    "flash_fwd": {
        torch.bfloat16: "flash_fwd_tc_kernel",
        torch.float32: "flash_fwd_kernel",
    },
    "flash_bwd_dq": {
        torch.bfloat16: "flash_bwd_dq_tc_kernel",
        torch.float32: "flash_bwd_dq_kernel",
    },
    "flash_bwd_dkv": {
        torch.bfloat16: "flash_bwd_dkv_tc_kernel",
        torch.float32: "flash_bwd_dkv_kernel",
    },
    # in csrc/decode_attention.cu, one template for both dtypes
    "decode_attention": {
        torch.bfloat16: "decode_attention_kernel",
        torch.float32: "decode_attention_kernel",
    },
}

#: The second pass of a split decode plan (:func:`decode_plan`).
DECODE_MERGE_KERNEL = "decode_attention_merge_kernel"

#: Launches by device kernel, counted beside :data:`launch_counts`.
device_launch_counts: Dict[str, int] = {
    **{name: 0 for kernels in DEVICE_KERNELS.values() for name in kernels.values()},
    DECODE_MERGE_KERNEL: 0,
}

#: Head dims the CUDA kernels are compiled for.  Any head dim up to the
#: last runs on them, padded to the next (:func:`head_padded`).
HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for counts in (launch_counts, device_launch_counts):
        for name in counts:
            counts[name] = 0


def flash_launch_counts() -> Dict[str, int]:
    """:data:`launch_counts` of the flash entry points alone."""
    return {entry: launch_counts[entry] for entry in FLASH_ENTRIES}


def _count_launch(entry: str, dtype: torch.dtype) -> None:
    launch_counts[entry] += 1
    device_launch_counts[DEVICE_KERNELS[entry][dtype]] += 1


def _causal_needed(qi, kj, block_q: int, block_k: int):
    """True when q-tile *qi* has at least one row at or below the
    diagonal of k-tile *kj* (the block pair contributes under the causal
    mask).  The CUDA kernels turn this into their loop bound."""
    return kj * block_k <= qi * block_q + (block_q - 1)


def _causal_mask(qi, kj, block_q: int, block_k: int, device=None):
    """[block_q, block_k] bool: query position >= key position."""
    q_pos = qi * block_q + torch.arange(block_q, device=device)[:, None]
    k_pos = kj * block_k + torch.arange(block_k, device=device)[None, :]
    return q_pos >= k_pos


def _group_size(q, k) -> int:
    """GQA group size g = q_heads // kv_heads (1 = plain MHA; kv_heads
    == 1 = MQA).  Head dims and batch must already agree."""
    h, hk = q.shape[2], k.shape[2]
    if hk == 0 or h % hk:
        raise ValueError(
            f"flash_attention GQA needs q heads ({h}) to be a multiple "
            f"of kv heads ({hk})"
        )
    return h // hk


def _check_blocks(s: int, block_q: int, block_k: int) -> tuple:
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(
            f"flash_attention needs seq ({s}) divisible by block_q "
            f"({block_q}) and block_k ({block_k}); pad the sequence "
            f"(make_flash_attention_fn does this for the causal case)"
        )
    return block_q, block_k


def _fold(x):
    """[b, s, h, d] -> [b*h, s, d], contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unfold(x, b: int):
    """[b*h, s, d] -> [b, s, h, d] (a view)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


# ----------------------------------------------------- plain versions


def _expand_kv(x, g: int):
    """K/V rows [b*hk, s, d] -> [b*h, s, d]: query row bh reads K/V row
    bh // g.  Only the plain versions repeat heads; the kernels index."""
    return x.repeat_interleave(g, dim=0) if g > 1 else x


def _scale(qf, scale):
    """The softmax scale: *scale*, or 1/sqrt(head_dim) of *qf*."""
    return 1.0 / math.sqrt(qf.shape[2]) if scale is None else scale


def _scores(qf, kf, g: int, causal: bool, scale=None):
    """Scaled fp32 scores [b*h, s, s], masked with ``_NEG``."""
    s = qf.shape[1]
    scores = torch.bmm(qf.float(), _expand_kv(kf, g).float().transpose(1, 2))
    scores.mul_(_scale(qf, scale))
    if causal:
        mask = _causal_mask(0, 0, s, s, device=qf.device)
        scores.masked_fill_(~mask, _NEG)
    return scores


def flash_forward_plain(qf, kf, vf, g: int, causal: bool, scale=None):
    """Plain version of the forward kernel: ``(O, lse)`` with O in q's
    dtype and lse fp32 [b*h, s].  *scale* defaults to 1/sqrt(head_dim)."""
    scores = _scores(qf, kf, g, causal, scale)
    lse = torch.logsumexp(scores, dim=-1)
    # out of place: autograd of the plain version is the kernels' oracle
    probs = torch.exp(scores - lse[..., None])
    out = torch.bmm(probs, _expand_kv(vf, g).float())
    return out.to(qf.dtype), lse


def _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g: int, causal: bool, scale=None):
    """P = exp(S*scale - lse) and dS = P (dO V^T - dvec) scale, fp32."""
    scale = _scale(qf, scale)
    probs = _scores(qf, kf, g, causal, scale).sub_(lse[..., None]).exp_()
    dp = torch.bmm(dof.float(), _expand_kv(vf, g).float().transpose(1, 2))
    ds = dp.sub_(dvec[..., None]).mul_(probs).mul_(scale)
    return probs, ds


def flash_bwd_dq_plain(qf, kf, vf, dof, lse, dvec, g: int, causal: bool, scale=None):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    _, ds = _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g, causal, scale)
    return torch.bmm(ds, _expand_kv(kf, g).float()).to(qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, dof, lse, dvec, g: int, causal: bool, scale=None):
    """Plain version of the dK/dV kernel: per-query-head partials
    dK = dS^T Q and dV = P^T dO, [b*h, s, d] in k's and v's dtypes."""
    probs, ds = _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g, causal, scale)
    dv = torch.bmm(probs.transpose(1, 2), dof.float())
    dk = torch.bmm(ds.transpose(1, 2), qf.float())
    return dk.to(kf.dtype), dv.to(vf.dtype)


# ------------------------------------------------------ kernel wrappers


def padded_head_dim(d: int) -> int:
    """The compiled head dim a *d*-wide head runs at: the least width of
    :data:`HEAD_DIMS` that holds it."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(
        f"flash attention kernels take head_dim up to {HEAD_DIMS[-1]}, got {d}"
    )


def head_padded(fn, n_padded: int, qf, *args):
    """``fn(qf, *args, scale=...)`` at the compiled head dim.

    The first *n_padded* tensors (q, k, v, and dO for the backward) are
    zero-padded to :func:`padded_head_dim`, and every 3-D output is sliced
    back to the true width.  Exact: a zero column adds 0 to each score,
    so lse and P are those of the true width, and the padded columns of
    O, dQ, dK and dV are dropped.  The scale is that of the true width;
    dvec = rowsum(dO * O) comes in from the caller, unpadded."""
    d = qf.shape[2]
    width = padded_head_dim(d)
    tensors = (qf, *args[: n_padded - 1])
    rest = args[n_padded - 1:]
    scale = 1.0 / math.sqrt(d)
    if width == d:
        return fn(*tensors, *rest, scale=scale)
    out = fn(*(F.pad(t, (0, width - d)) for t in tensors), *rest, scale=scale)
    narrow = lambda t: t[..., :d].contiguous() if t.dim() == 3 else t  # noqa: E731
    return tuple(map(narrow, out)) if isinstance(out, tuple) else narrow(out)


def _check_kernel_inputs(what: str, qf, kf, vf, g: int, dof=None, lse=None, dvec=None):
    """Raise on what the CUDA kernels do not take."""
    bh, s, d = qf.shape
    if qf.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: dtype {qf.dtype} not in {_KERNEL_DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS}")
    if bh % g or tuple(kf.shape) != (bh // g, s, d) or kf.shape != vf.shape:
        raise ValueError(
            f"{what}: k/v shapes {tuple(kf.shape)}, {tuple(vf.shape)} != "
            f"{(bh // g, s, d)}"
        )
    same = [t for t in (kf, vf, dof) if t is not None]
    rows = [t for t in (lse, dvec) if t is not None]
    if any(t.dtype != qf.dtype for t in same) or any(
        t.dtype != torch.float32 or tuple(t.shape) != (bh, s) for t in rows
    ):
        raise ValueError(f"{what}: q/k/v/dO must share a dtype, lse/dvec fp32 [b*h, s]")
    if dof is not None and dof.shape != qf.shape:
        raise ValueError(f"{what}: dO shape {tuple(dof.shape)} != {tuple(qf.shape)}")
    for t in (qf, *same, *rows):
        if t.device != qf.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous on one device")
    # the bf16 tensor-core kernels copy rows in 16-byte chunks
    if qf.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (qf, *same)):
        raise ValueError(f"{what}: bf16 q/k/v/dO must start on a 16-byte boundary")


def _launch_env(qf, scale, library: str = "flash_attention") -> Tuple:
    """(library, is_bf16, scale, stream) of a launch; *scale* defaults
    to 1/sqrt(head_dim).  The C entry points launch on the current
    device, so the tensors must be there."""
    lib = _build.load(library)
    if qf.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {qf.device}, but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    return (
        lib,
        int(qf.dtype == torch.bfloat16),
        _scale(qf, scale),
        torch.cuda.current_stream(qf.device).cuda_stream,
    )


def _flash_forward_cuda(qf, kf, vf, g: int, causal: bool, scale=None):
    _check_kernel_inputs("flash_fwd", qf, kf, vf, g)
    lib, is_bf16, scale, stream = _launch_env(qf, scale)
    bh, s, d = qf.shape
    out = torch.empty_like(qf)
    lse = torch.empty(bh, s, dtype=torch.float32, device=qf.device)
    _build.check(
        lib.flash_fwd(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, s, d, g, int(causal), is_bf16, scale, stream,
        ),
        "flash_fwd",
    )
    _count_launch("flash_fwd", qf.dtype)
    return out, lse


def _flash_bwd_dq_cuda(qf, kf, vf, dof, lse, dvec, g: int, causal: bool, scale=None):
    _check_kernel_inputs("flash_bwd_dq", qf, kf, vf, g, dof, lse, dvec)
    lib, is_bf16, scale, stream = _launch_env(qf, scale)
    bh, s, d = qf.shape
    dq = torch.empty_like(qf)
    _build.check(
        lib.flash_bwd_dq(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), bh, s, d, g,
            int(causal), is_bf16, scale, stream,
        ),
        "flash_bwd_dq",
    )
    _count_launch("flash_bwd_dq", qf.dtype)
    return dq


def _flash_bwd_dkv_cuda(qf, kf, vf, dof, lse, dvec, g: int, causal: bool, scale=None):
    _check_kernel_inputs("flash_bwd_dkv", qf, kf, vf, g, dof, lse, dvec)
    lib, is_bf16, scale, stream = _launch_env(qf, scale)
    bh, s, d = qf.shape
    dk = torch.empty_like(qf)  # per query head: group-summed by the caller
    dv = torch.empty_like(qf)
    _build.check(
        lib.flash_bwd_dkv(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s, d, g, int(causal), is_bf16, scale, stream,
        ),
        "flash_bwd_dkv",
    )
    _count_launch("flash_bwd_dkv", qf.dtype)
    return dk, dv


def _route(cuda_fn, plain_fn, qf, *args):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if qf.is_cuda:
        return cuda_fn(qf, *args)
    if qf.device.type == "cpu":
        return plain_fn(qf, *args)
    raise ValueError(f"flash attention has no kernel for device {qf.device}")


def flash_forward(qf, kf, vf, g: int, causal: bool):
    """Forward on folded tensors: ``(O [b*h, s, d], lse [b*h, s])``."""
    return _route(
        partial(head_padded, _flash_forward_cuda, 3), flash_forward_plain,
        qf, kf, vf, g, causal,
    )


def flash_bwd_dq(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """dQ on folded tensors."""
    return _route(
        partial(head_padded, _flash_bwd_dq_cuda, 4), flash_bwd_dq_plain,
        qf, kf, vf, dof, lse, dvec, g, causal,
    )


def flash_bwd_dkv(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """Per-query-head (dK, dV) partials on folded tensors."""
    return _route(
        partial(head_padded, _flash_bwd_dkv_cuda, 4), flash_bwd_dkv_plain,
        qf, kf, vf, dof, lse, dvec, g, causal,
    )


# ------------------------------------------------- decode attention

#: Positions folded at a time, the most a stage holds, and the bytes of K
#: and V a stage aims at, as ``csrc/decode_attention.cu`` takes them.
DECODE_GROUP = 4
DECODE_MAX_TILE = 32
DECODE_STAGE_BYTES = 16 * 1024
DECODE_MAX_THREADS = 256


class DecodePlan(NamedTuple):
    """How ``decode_attention_kernel`` covers a step: the compiled head
    width, ``heads`` a block (``groups`` blocks a row), ``threads`` a
    block, ``tile`` positions a stage, and the prefix cut into ``splits``
    parts of ``split_len`` positions (1: no merge pass)."""

    width: int
    heads: int
    groups: int
    threads: int
    tile: int
    splits: int
    split_len: int


def decode_plan(b: int, h: int, hd: int, elem: int, n: int, n_sms: int) -> DecodePlan:
    """The launch plan of a decode step over *n* cached positions of *b*
    rows of *h* heads of width *hd* (*elem* bytes an element) on a card of
    *n_sms* SMs, from the shape alone.

    A thread owns 16 bytes of a head (32 where a head of the compiled
    width would need more than 32 lanes); a block takes as many heads of
    one row as fit 256 threads, so all of GPT-2's.  A stage holds ~16 KB
    of K and V, whole groups of four positions.  Where b x groups blocks
    fill the card twice over (the serving cell: 512 on 132 SMs) each takes
    its row's whole prefix.  Otherwise (GPT-2 XL at b 8: 8 blocks) the
    prefix is split towards 2 x SMs blocks, each of four tiles at least,
    and a merge pass combines the parts."""
    width = padded_head_dim(hd)
    per_head = width // max(width // 32, 16 // elem)
    groups = -(-h // max(1, DECODE_MAX_THREADS // per_head))
    heads = -(-h // groups)
    threads = -(-heads * per_head // 32) * 32
    tile = DECODE_STAGE_BYTES // (2 * heads * hd * elem) // DECODE_GROUP * DECODE_GROUP
    tile = min(DECODE_MAX_TILE, max(DECODE_GROUP, tile))
    splits = 1
    if b * groups < 2 * n_sms:
        splits = max(1, min(-(-2 * n_sms // (b * groups)), n // (4 * tile)))
    per_split = -(-n // splits)
    split_len = -(-per_split // tile) * tile  # whole tiles but the last split's
    return DecodePlan(width, heads, groups, threads, tile, -(-n // split_len), split_len)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q, keys, values, index: int):
    """Plain version of the decode kernel: flax's cached attention as
    ``workload._attend`` takes it, dense over the whole cache in the
    inputs' dtype, positions after *index* masked with ``finfo.min``."""
    q = q / math.sqrt(q.shape[3])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, keys)
    visible = torch.arange(keys.shape[1], device=q.device) <= index
    scores = scores.masked_fill(~visible, torch.finfo(scores.dtype).min)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), values)


def _check_decode_inputs(q, keys, values, index: int) -> None:
    """Raise on what the decode kernel does not take, on every device."""
    what = "decode_attention"
    if keys.dim() != 4 or tuple(values.shape) != tuple(keys.shape):
        raise ValueError(f"{what}: keys {tuple(keys.shape)} and values "
                         f"{tuple(values.shape)} must be one [b, total, h, hd] shape")
    b, total, h, hd = keys.shape
    if tuple(q.shape) != (b, 1, h, hd):
        raise ValueError(f"{what}: q {tuple(q.shape)} != {(b, 1, h, hd)}")
    if not q.dtype == keys.dtype == values.dtype or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: q/keys/values dtypes {q.dtype}, {keys.dtype}, "
                         f"{values.dtype}: one of {_KERNEL_DTYPES}")
    if hd > HEAD_DIMS[-1] or hd * q.element_size() % 16:
        raise ValueError(f"{what}: head_dim {hd} must be at most {HEAD_DIMS[-1]}, "
                         f"a head row whole 16-byte chunks")
    if not 0 <= index < total:
        raise ValueError(f"{what}: index {index} outside [0, {total})")
    if not q.device == keys.device == values.device:
        raise ValueError(f"{what}: tensors on {q.device}, {keys.device}, {values.device}")


def _decode_attention_cuda(q, keys, values, index: int):
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("decode_attention: the cache must be contiguous (it is read in place)")
    q = q.contiguous()
    if any(t.data_ptr() % 16 for t in (q, keys, values)):
        raise ValueError("decode_attention: q/keys/values must start on a 16-byte boundary")
    b, total, h, hd = keys.shape
    lib, is_bf16, scale, stream = _launch_env(q, 1.0 / math.sqrt(hd), "decode_attention")
    plan = decode_plan(b, h, hd, q.element_size(), index + 1, _sm_count(q.device.index))
    out = torch.empty_like(q)
    # the split plan's scratch, each part's accumulator and its (max, sum),
    # held until the launch is queued
    parts = [torch.empty(b, plan.splits, h, width, dtype=torch.float32, device=q.device)
             for width in (hd, 2)] if plan.splits > 1 else []
    part_o, part_ml = (t.data_ptr() for t in parts) if parts else (0, 0)
    _build.check(
        lib.decode_attention(
            q.data_ptr(), keys.data_ptr(), values.data_ptr(), out.data_ptr(), part_o, part_ml,
            b, total, h, hd, index, plan.heads, plan.tile, plan.splits, plan.split_len,
            is_bf16, scale, stream,
        ),
        "decode_attention",
    )
    _count_launch("decode_attention", q.dtype)
    if plan.splits > 1:
        device_launch_counts[DECODE_MERGE_KERNEL] += 1
    return out


def decode_attention(q, keys, values, index: int):
    """A decode step's cached attention: q [b, 1, h, hd] against the
    positions ``0..index`` of one :class:`.workload.KVCache` layer's
    *keys* and *values* [b, total, h, hd], which this step has already
    written; returns [b, 1, h, hd] in q's dtype.  A CUDA tensor runs
    ``decode_attention_kernel`` over the written prefix only, reading the
    cache in place; a CPU tensor runs :func:`decode_attention_plain`.
    Shapes, dtypes, head dim and *index* are checked first, on every
    device."""
    index = operator.index(index)
    _check_decode_inputs(q, keys, values, index)
    if q.is_cuda:
        return _decode_attention_cuda(q, keys, values, index)
    if q.device.type == "cpu":
        return decode_attention_plain(q, keys, values, index)
    raise ValueError(f"decode_attention has no kernel for device {q.device}")


# ------------------------------------------------------- autograd layer


def _flash_forward(q, k, v, causal: bool, block_q: int, block_k: int):
    """Returns (out [b,s,h,d], lse [b*h, s] fp32).  Supports GQA/MQA: k/v
    may carry fewer heads than q (q heads must be a multiple)."""
    b, s = q.shape[:2]
    g = _group_size(q, k)
    _check_blocks(s, block_q, block_k)
    out, lse = flash_forward(_fold(q), _fold(k), _fold(v), g, causal)
    return _unfold(out, b), lse


def _flash_backward(
    q, k, v, o, lse, dout, causal: bool, block_q: int, block_k: int,
    g_lse=None,
):
    """Fused flash backward: (dq, dk, dv).  The kernels run over QUERY
    heads producing per-query-head dK/dV partials, which a reshape-sum
    reduces over each GQA group.  *g_lse* (the lse output's cotangent,
    [b*h, s]) folds into the row term: dvec = rowsum(dO * O) - g_lse."""
    b, s, h, d = q.shape
    g = _group_size(q, k)
    hk = h // g
    _check_blocks(s, block_q, block_k)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    dof = _fold(dout.to(q.dtype))
    dvec = (_fold(o).float() * dof.float()).sum(-1)
    if g_lse is not None:
        dvec = dvec - g_lse.float()
    dq = flash_bwd_dq(qf, kf, vf, dof, lse, dvec, g, causal)
    dk, dv = flash_bwd_dkv(qf, kf, vf, dof, lse, dvec, g, causal)
    if g > 1:
        # per-query-head partials -> group sums (the gradient of the
        # implicit head broadcast)
        dk = dk.reshape(b * hk, g, s, d).sum(1)
        dv = dv.reshape(b * hk, g, s, d).sum(1)
    return _unfold(dq, b), _unfold(dk, b), _unfold(dv, b)


def _recompute_backward(q, k, v, dout, causal: bool):
    """Differentiate dense attention (O(seq^2) memory — debugging)."""
    if _group_size(q, k) > 1:
        raise ValueError(
            "backward='recompute' does not support GQA (the dense "
            "reference wants equal head counts); use the default "
            "fused backward"
        )
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = dense_reference(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, backward):
        out, lse = _flash_forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, block_q, block_k, backward)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k, backward = ctx.config
        if backward == "recompute":
            grads = _recompute_backward(q, k, v, dout, causal)
        else:
            grads = _flash_backward(
                q, k, v, out, lse, dout, causal, block_q, block_k
            )
        return (*grads, None, None, None, None)


class _FlashAttentionLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = _flash_forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, block_q, block_k)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.config
        grads = _flash_backward(
            q, k, v, out, lse, dout, causal, block_q, block_k, g_lse=dlse
        )
        return (*grads, None, None, None)


def flash_attention(
    q,
    k,
    v,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
    backward: str = "fused",
):
    """Flash attention.  Shapes [batch, seq, heads, head_dim]; returns
    the same.  The tensors' device decides: CUDA runs the kernels, the
    CPU runs their plain versions.  Differentiable: ``backward="fused"``
    (default) runs the dQ and dK/dV kernels (O(seq) memory);
    ``"recompute"`` differentiates dense attention instead (O(seq^2) —
    debugging only)."""
    if backward not in ("fused", "recompute"):
        raise ValueError(f"backward must be 'fused' or 'recompute', got {backward!r}")
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, backward)


def flash_attention_lse(
    q,
    k,
    v,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
):
    """Flash attention returning ``(out, lse)`` — *lse* is the per-row
    logsumexp of the scaled scores, shape [batch*heads, seq] fp32.
    Differentiable in BOTH outputs: an lse cotangent folds into the
    fused backward as ``dvec - g_lse``, so the backward kernels run
    unchanged."""
    return _FlashAttentionLse.apply(q, k, v, causal, block_q, block_k)


def make_flash_attention_fn(block: int = 128):
    """An attention function ``(query, key, value) -> out`` running the
    causal flash kernel — the seam :mod:`.workload` uses.

    Sequences not divisible by *block* (the teacher-forcing shift makes
    seq = max_seq_len - 1) are PADDED up to the next multiple and the
    output sliced back — exact for causal attention: padded key
    positions sit after every real query, so the mask zeroes their
    contribution, and padded query rows are discarded."""

    def attention_fn(query, key, value):
        s = query.shape[1]
        pad = (-s) % block
        if pad:
            widths = (0, 0, 0, 0, 0, pad)  # [b, s, h, d]: pad seq at the end
            query = F.pad(query, widths)
            key = F.pad(key, widths)
            value = F.pad(value, widths)
        out = flash_attention(query, key, value, True, block, block)
        return out[:, :s].to(query.dtype)

    return attention_fn
