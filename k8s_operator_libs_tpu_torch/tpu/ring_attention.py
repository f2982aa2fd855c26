"""Ring attention: sequence-parallel exact attention over a process group.

The port of ``k8s_operator_libs_tpu/tpu/ring_attention.py``.  Q stays
sharded and the K/V blocks travel the ring: each rank sends its current
block to ``rank + 1`` and receives the next from ``rank - 1``
(``torch.distributed.batch_isend_irecv``, where JAX uses ``ppermute``
over the ``seq`` mesh axis), folding one block per step into an exact
online softmax.  Every function takes the rank's local shards
``[batch, seq_local, heads, head_dim]`` and a process group (the world
when None); chunks are contiguous, rank i holding global positions
``[i*seq_local, (i+1)*seq_local)``, except in the zigzag layout.

* :func:`ring_attention`: the einsum ring, fp32 (m, l, o) accumulators.
  It never skips a block: a masked block is computed and then masked,
  so every rank's autograd graph has the same shifts, and a
  differentiable shift (K and V forward to ``rank + 1``, their gradient
  back to ``rank - 1``) is its whole backward.
* :func:`ring_flash_attention` and :func:`zigzag_ring_flash_attention`:
  each block pair runs the flash kernels (:mod:`.flash_attention`), the
  partials merged exactly in the logsumexp frame.  Causal pairs below
  the diagonal run unmasked, the diagonal pair causal, and pairs above
  it are skipped without compute.  Because ranks skip different pairs, a
  per-shift autograd op would deadlock (a rank whose later blocks feed
  nothing never runs those shifts' backward, while its neighbour waits
  in a receive), so each is ONE autograd Function whose backward runs
  the ring again: K/V rotate as in the forward, each rank's fp32 dK/dV
  accumulators travel with their blocks and come home after one last
  shift, and every pair the forward computed runs the dQ and dK/dV
  kernels with the FINAL lse and ``dvec = rowsum(dO * O)`` of the merged
  output.  P = exp(s - lse_final) is then the exact global probability,
  so the kernels' contract holds unchanged.  Every rank issues the same
  sends and receives, forward and backward: a skip skips compute, never
  a shift.
* :func:`to_zigzag` / :func:`from_zigzag`: the balanced layout, rank i
  holding global chunks ``(i, 2n-1-i)`` of ``2n``.
* :func:`ring_schedule`: the pairs a rank computes, which the flash rings
  run and their launch counts follow.

The transport follows the group: NCCL sends CUDA tensors; gloo sends CPU
tensors, and a CUDA tensor under gloo (two ranks sharing one card, which
NCCL refuses) is staged through pinned host buffers
(:func:`.distributed.host_buffer`), the compute staying on the card.

* :func:`ring_attention_sharded`: the model seam over a mesh, the ring
  over this rank's ``seq`` group on its own heads.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist

from . import distributed

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


# ------------------------------------------------------------ transport


class _Ring:
    """One ring over *group*: the neighbours and the transport."""

    def __init__(self, group, device: torch.device) -> None:
        self.group = group if group is not None else dist.group.WORLD
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.next = dist.get_global_rank(self.group, (self.rank + 1) % self.n)
        self.prev = dist.get_global_rank(self.group, (self.rank - 1) % self.n)
        staged = distributed.via_host(device, self.group)
        self.transport = "gloo via pinned host buffers" if staged else dist.get_backend(self.group)

    def _exchange(self, flat: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        send = distributed.host_buffer(flat, self.group, "ring_send")
        staged = send is not None
        if staged:
            send.copy_(flat)  # synchronous: the stream has produced flat
            recv = distributed.host_buffer(flat, self.group, "ring_recv")
        else:
            send, recv = flat, torch.empty_like(flat)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, to, self.group),
            dist.P2POp(dist.irecv, recv, frm, self.group),
        ])
        for req in reqs:
            req.wait()
        return recv.to(flat.device) if staged else recv

    def shift(self, tensors: List[torch.Tensor], reverse: bool = False) -> List[torch.Tensor]:
        """Send *tensors* to ``rank + 1`` and receive the same shapes and
        dtypes from ``rank - 1`` (the other way round when *reverse*), as
        one message.  Dtypes of a wider item come first, so each view of
        the received bytes is aligned."""
        if self.n == 1:
            return list(tensors)
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
        to, frm = (self.prev, self.next) if reverse else (self.next, self.prev)
        recv = self._exchange(flat, to, frm)
        out, offset = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            out.append(recv[offset:offset + nbytes].view(t.dtype).view(t.shape))
            offset += nbytes
        return out


def ring_transport(group=None, device="cpu") -> str:
    """How the rings move blocks over *group* for tensors on *device*."""
    return _Ring(group, torch.device(device)).transport


# ------------------------------------------------------------ einsum ring


def _block_update(carry, q, k_blk, v_blk, block_mask):
    """Fold one K/V block into the online-softmax accumulator.

    carry = (o, m, l): weighted sum [b,q,h,d], running row max [b,h,q],
    running denominator [b,h,q] — all fp32.
    """
    o, m, l = carry
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) / math.sqrt(d)
    scores = scores.masked_fill(~block_mask, _NEG)
    m_new = torch.maximum(m, scores.amax(-1))
    # rescale the old accumulator into the new max's frame
    alpha = torch.exp(m - m_new)  # [b,h,q]
    # a masked score gives exp(_NEG - m_new) = 0: the first block is the
    # rank's own, whose diagonal makes m_new a real score
    p = torch.exp(scores - m_new[..., None])  # [b,h,q,k]
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk.float()
    )
    return o_new, m_new, l_new


class _Shift(torch.autograd.Function):
    """K and V to ``rank + 1`` in one message; their gradients back to
    ``rank - 1`` in one message."""

    @staticmethod
    def forward(ctx, ring: _Ring, k, v):
        ctx.ring = ring
        return tuple(ring.shift([k, v]))

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = ctx.ring.shift([dk, dv], reverse=True)
        return None, dk, dv


def ring_attention(q, k, v, group=None, causal: bool = True):
    """Exact attention with Q sharded and K/V rotating the ring (the
    einsum engine).  Shapes are the local shards [batch, seq_local,
    heads, head_dim]; chunks are contiguous.

    Causal note: with contiguous chunks the ring does uneven useful work
    per rank (rank 0 masks most blocks, rank n-1 none); the zigzag layout
    of :func:`zigzag_ring_flash_attention` rebalances it."""
    ring = _Ring(group, q.device)
    n, my = ring.n, ring.rank
    b, s_loc, h, d = q.shape
    o = torch.zeros(b, s_loc, h, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, s_loc, dtype=torch.float32, device=q.device)
    pos = torch.arange(s_loc, device=q.device)
    q_pos = my * s_loc + pos  # global query positions
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n  # ring position this K/V block came from
        if causal:
            block_mask = (q_pos[:, None] >= (src * s_loc + pos)[None, :])[None, None]
        else:
            block_mask = torch.ones(1, 1, s_loc, s_loc, dtype=torch.bool, device=q.device)
        o, m, l = _block_update((o, m, l), q, k_blk, v_blk, block_mask)
        if i < n - 1:  # the last block stays: no rank reads a further one
            k_blk, v_blk = _Shift.apply(ring, k_blk, v_blk)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ------------------------------------------------------------- flash rings


def ring_schedule(n: int, rank: int, causal: bool = True, layout: str = "contiguous"):
    """The block pairs *rank* computes in a ring of *n*, in order, as
    ``(step, q_part, k_part, causal_pair)``.  At step i the rank holds the
    K/V block of rank ``(rank - i) % n``.  Contiguous: one part each; a
    pair below the diagonal runs unmasked, the diagonal pair causal, a
    pair above is skipped.  Zigzag (causal only): two halves each,
    classified by their GLOBAL chunk ids ``(r, 2n-1-r)``: q-chunk >
    k-chunk unmasked, equal causal, less skipped."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    pairs = []
    for i in range(n):
        src = (rank - i) % n
        if layout == "contiguous":
            if not causal or src < rank:
                pairs.append((i, 0, 0, False))
            elif src == rank:
                pairs.append((i, 0, 0, True))
            continue
        q_ids, k_ids = (rank, 2 * n - 1 - rank), (src, 2 * n - 1 - src)
        for kh, kc in enumerate(k_ids):
            for qh, qc in enumerate(q_ids):
                if qc >= kc:
                    pairs.append((i, qh, kh, qc == kc))
    return pairs


def _parts(x, parts: int):
    """[b, s, h, d] -> *parts* folded [b*h, s/parts, d] slices."""
    from .flash_attention import _fold

    sp = x.shape[1] // parts
    return [_fold(x[:, j * sp:(j + 1) * sp]) for j in range(parts)]


def _merge(o, lse, o_p, lse_p):
    """Two normalized partials over disjoint key sets, merged exactly in
    the logsumexp frame (folded layout: o [b*h, s, d], lse [b*h, s])."""
    lse_new = torch.logaddexp(lse, lse_p)
    o_new = o * torch.exp(lse - lse_new)[..., None] + o_p.float() * torch.exp(lse_p - lse_new)[..., None]
    return o_new, lse_new


class _RingFlash(torch.autograd.Function):
    """The flash ring, forward and backward (module docstring).  Q, K and
    V are folded into the kernels' layout once, as *parts* contiguous
    slices each, and the ring shifts the folded K/V parts."""

    @staticmethod
    def forward(ctx, q, k, v, ring: _Ring, schedule, parts: int):
        from . import flash_attention as fa

        g = fa._group_size(q, k)
        qf = _parts(q, parts)
        o = [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in qf]
        lse = [torch.full(x.shape[:2], _NEG, dtype=torch.float32, device=q.device) for x in qf]
        kv = _parts(k, parts) + _parts(v, parts)  # K parts, then V parts
        for i in range(ring.n):
            for _, qh, kh, causal in (p for p in schedule if p[0] == i):
                o_p, lse_p = fa.flash_forward(qf[qh], kv[kh], kv[parts + kh], g, causal)
                o[qh], lse[qh] = _merge(o[qh], lse[qh], o_p, lse_p)
            if i < ring.n - 1:
                kv = ring.shift(kv)
        out = torch.cat([fa._unfold(x.to(q.dtype), q.shape[0]) for x in o], dim=1)
        ctx.save_for_backward(q, k, v, out, *lse)
        ctx.ring, ctx.schedule, ctx.parts = ring, schedule, parts
        return out

    @staticmethod
    def backward(ctx, dout):
        from . import flash_attention as fa

        q, k, v, out, *lse = ctx.saved_tensors
        ring, schedule, parts = ctx.ring, ctx.schedule, ctx.parts
        b = q.shape[0]
        g = fa._group_size(q, k)
        qf, of = _parts(q, parts), _parts(out, parts)
        dof = _parts(dout.to(q.dtype), parts)
        dvec = [(o_j.float() * do_j.float()).sum(-1) for o_j, do_j in zip(of, dof)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in qf]
        kv = _parts(k, parts) + _parts(v, parts)
        # the dK then dV accumulators of the parts held: fp32, travelling
        # with them
        dkv = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in kv]
        for i in range(ring.n):
            for _, qh, kh, causal in (p for p in schedule if p[0] == i):
                args = (qf[qh], kv[kh], kv[parts + kh], dof[qh], lse[qh], dvec[qh], g, causal)
                dq[qh] += fa.flash_bwd_dq(*args).float()
                dk_p, dv_p = fa.flash_bwd_dkv(*args)
                if g > 1:  # per-query-head partials -> group sums
                    dk_p = dk_p.reshape(-1, g, *dk_p.shape[1:]).sum(1)
                    dv_p = dv_p.reshape(-1, g, *dv_p.shape[1:]).sum(1)
                dkv[kh] += dk_p.float()
                dkv[parts + kh] += dv_p.float()
            if i < ring.n - 1:
                moved = ring.shift(dkv + kv)
                dkv, kv = moved[:2 * parts], moved[2 * parts:]
            else:  # home: the parts held last are rank + 1's
                dkv = ring.shift(dkv)
        unfold = lambda xs, dtype: torch.cat(  # noqa: E731
            [fa._unfold(x, b) for x in xs], dim=1).to(dtype)
        return (unfold(dq, q.dtype), unfold(dkv[:parts], k.dtype), unfold(dkv[parts:], v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, group=None, causal: bool = True, block: int = 128):
    """Ring attention with the flash kernels as the block-pair engine:
    the ring rotates K/V across ranks, and each pair runs the flash
    kernels (never a [seq_local, seq_local] score matrix).  Per pair the
    forward kernel returns a NORMALIZED partial and its logsumexp, and
    partials over disjoint key sets merge exactly: ``L =
    logaddexp(L, lse_p); o = o*exp(L_old-L) + o_p*exp(lse_p-L)``.

    Same contract as :func:`ring_attention`; *block* must divide the
    local sequence (the kernels choose their own tiles; the check is the
    JAX function's)."""
    s_loc = q.shape[1]
    if s_loc % min(block, s_loc):
        raise ValueError(
            f"ring_flash_attention needs block ({block}) to divide the "
            f"local sequence ({s_loc})"
        )
    ring = _Ring(group, q.device)
    schedule = ring_schedule(ring.n, ring.rank, causal)
    return _RingFlash.apply(q, k, v, ring, schedule, 1)


def _zigzag_order(n: int) -> List[int]:
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return order


def to_zigzag(x, n: int):
    """Permute the sequence axis (axis 1) from natural order into the
    zigzag layout: the sequence is cut into ``2n`` chunks and rank i holds
    chunks ``(i, 2n-1-i)``, so under a causal mask every rank carries one
    early (cheap) and one late (expensive) chunk and the ring's causal
    work balances."""
    b, s = x.shape[0], x.shape[1]
    if s % (2 * n):
        raise ValueError(f"seq {s} not divisible by 2n = {2 * n}")
    chunks = x.reshape((b, 2 * n, s // (2 * n)) + tuple(x.shape[2:]))
    return chunks[:, _zigzag_order(n)].reshape(x.shape)


def from_zigzag(x, n: int):
    """Inverse of :func:`to_zigzag`."""
    b, s = x.shape[0], x.shape[1]
    chunks = x.reshape((b, 2 * n, s // (2 * n)) + tuple(x.shape[2:]))
    inverse = [0] * (2 * n)
    for pos, c in enumerate(_zigzag_order(n)):
        inverse[c] = pos
    return chunks[:, inverse].reshape(x.shape)


def zigzag_ring_flash_attention(q, k, v, group=None, block: int = 128):
    """Causal ring of flash pairs over the ZIGZAG layout, the balanced
    form of :func:`ring_flash_attention`: each rank holds global chunks
    ``(rank, 2n-1-rank)`` (:func:`to_zigzag`), so every rank computes the
    same number of pairs.  Per step the 2x2 half-chunk pairs are
    classified by their global chunk ids (:func:`ring_schedule`), and
    each local half keeps its own (o, lse) accumulator.

    Inputs are the local zigzag shards."""
    s_loc = q.shape[1]
    if s_loc % 2:
        raise ValueError("zigzag needs an even local sequence")
    s_half = s_loc // 2
    blk = min(block, s_half)
    if s_half % blk:
        raise ValueError(
            f"zigzag_ring_flash_attention needs block ({blk}) to divide "
            f"the half-chunk ({s_half})"
        )
    ring = _Ring(group, q.device)
    schedule = ring_schedule(ring.n, ring.rank, True, "zigzag")
    return _RingFlash.apply(q, k, v, ring, schedule, 2)


def ring_attention_sharded(q, k, v, mesh, seq_axis: str, causal: bool = True,
                           use_flash: bool = False, flash_block: int = 128,
                           layout: str = "contiguous"):
    """The model seam over a :func:`.distributed.global_mesh`: a ring over
    *seq_axis*'s group of this rank's (data, model) coordinate.

    *q*, *k* and *v* are this rank's shards ``[b/dp, s/sp, h_local, d]``:
    its rows, its chunk of the sequence and its heads.  The projections
    before the seam split heads over ``model`` (the workload's
    ``param_partition_spec``), which is what the JAX seam's
    ``heads_axis="model"`` does: each model rank rings over its own
    heads.  The einsum ring, or with *use_flash* the flash ring
    (*flash_block* must divide the local sequence), or with
    ``layout="zigzag"`` (flash and causal only) the zigzag ring.  The JAX
    seam permutes natural-order arrays into the zigzag layout and back;
    here zigzag shards arrive in the layout, because the train step keeps
    its token batch zigzag-resident (the production setup the JAX
    docstring names)."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got {layout!r}")
    if layout == "zigzag" and not (use_flash and causal):
        raise ValueError("layout='zigzag' requires use_flash=True and causal=True")
    group = mesh.get_group(seq_axis)
    if layout == "zigzag":
        return zigzag_ring_flash_attention(q, k, v, group, flash_block)
    if use_flash:
        return ring_flash_attention(q, k, v, group, causal, flash_block)
    return ring_attention(q, k, v, group, causal)
