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
point, dtype) launches.

Beside each kernel sits its plain PyTorch version: dense, fp32, masked
with ``_NEG``.  A wrapper takes the plain version only for a tensor on the
CPU (the tests); for a CUDA tensor it launches the kernel or raises.  Each
wrapper counts its launches in :data:`launch_counts`, and by device
kernel in :data:`device_launch_counts`.

The public functions keep the JAX layout ``[batch, seq, heads, head_dim]``
and fold to ``[batch*heads, seq, head_dim]`` inside.  ``block_q`` and
``block_k`` keep their meaning for validation and padding; the CUDA
kernels choose their own tiles and take any sequence length.  The row
term ``dvec = rowsum(dO * O) - g_lse`` stays a torch reduction outside the
kernels, as it stays outside Pallas in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

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
}

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
}

#: Launches by device kernel, counted beside :data:`launch_counts`.
device_launch_counts: Dict[str, int] = {
    name: 0 for kernels in DEVICE_KERNELS.values() for name in kernels.values()
}

#: Head dims the CUDA kernels are compiled for.
HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for counts in (launch_counts, device_launch_counts):
        for name in counts:
            counts[name] = 0


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


def _scores(qf, kf, g: int, causal: bool):
    """Scaled fp32 scores [b*h, s, s], masked with ``_NEG``."""
    s, d = qf.shape[1], qf.shape[2]
    scores = torch.bmm(qf.float(), _expand_kv(kf, g).float().transpose(1, 2))
    scores.mul_(1.0 / math.sqrt(d))
    if causal:
        mask = _causal_mask(0, 0, s, s, device=qf.device)
        scores.masked_fill_(~mask, _NEG)
    return scores


def flash_forward_plain(qf, kf, vf, g: int, causal: bool):
    """Plain version of the forward kernel: ``(O, lse)`` with O in q's
    dtype and lse fp32 [b*h, s]."""
    scores = _scores(qf, kf, g, causal)
    lse = torch.logsumexp(scores, dim=-1)
    # out of place: autograd of the plain version is the kernels' oracle
    probs = torch.exp(scores - lse[..., None])
    out = torch.bmm(probs, _expand_kv(vf, g).float())
    return out.to(qf.dtype), lse


def _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """P = exp(S*scale - lse) and dS = P (dO V^T - dvec) scale, fp32."""
    scale = 1.0 / math.sqrt(qf.shape[2])
    probs = _scores(qf, kf, g, causal).sub_(lse[..., None]).exp_()
    dp = torch.bmm(dof.float(), _expand_kv(vf, g).float().transpose(1, 2))
    ds = dp.sub_(dvec[..., None]).mul_(probs).mul_(scale)
    return probs, ds


def flash_bwd_dq_plain(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    _, ds = _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g, causal)
    return torch.bmm(ds, _expand_kv(kf, g).float()).to(qf.dtype)


def flash_bwd_dkv_plain(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """Plain version of the dK/dV kernel: per-query-head partials
    dK = dS^T Q and dV = P^T dO, [b*h, s, d] in k's and v's dtypes."""
    probs, ds = _probs_and_dscores(qf, kf, vf, dof, lse, dvec, g, causal)
    dv = torch.bmm(probs.transpose(1, 2), dof.float())
    dk = torch.bmm(ds.transpose(1, 2), qf.float())
    return dk.to(kf.dtype), dv.to(vf.dtype)


# ------------------------------------------------------ kernel wrappers


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


def _launch_env(qf) -> Tuple:
    """(library, is_bf16, scale, stream) of a launch.  The C entry points
    launch on the current device, so the tensors must be there."""
    lib = _build.load("flash_attention")
    if qf.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {qf.device}, but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    return (
        lib,
        int(qf.dtype == torch.bfloat16),
        1.0 / math.sqrt(qf.shape[2]),
        torch.cuda.current_stream(qf.device).cuda_stream,
    )


def _flash_forward_cuda(qf, kf, vf, g: int, causal: bool):
    _check_kernel_inputs("flash_fwd", qf, kf, vf, g)
    lib, is_bf16, scale, stream = _launch_env(qf)
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


def _flash_bwd_dq_cuda(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    _check_kernel_inputs("flash_bwd_dq", qf, kf, vf, g, dof, lse, dvec)
    lib, is_bf16, scale, stream = _launch_env(qf)
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


def _flash_bwd_dkv_cuda(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    _check_kernel_inputs("flash_bwd_dkv", qf, kf, vf, g, dof, lse, dvec)
    lib, is_bf16, scale, stream = _launch_env(qf)
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
    return _route(_flash_forward_cuda, flash_forward_plain, qf, kf, vf, g, causal)


def flash_bwd_dq(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """dQ on folded tensors."""
    return _route(
        _flash_bwd_dq_cuda, flash_bwd_dq_plain,
        qf, kf, vf, dof, lse, dvec, g, causal,
    )


def flash_bwd_dkv(qf, kf, vf, dof, lse, dvec, g: int, causal: bool):
    """Per-query-head (dK, dV) partials on folded tensors."""
    return _route(
        _flash_bwd_dkv_cuda, flash_bwd_dkv_plain,
        qf, kf, vf, dof, lse, dvec, g, causal,
    )


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
