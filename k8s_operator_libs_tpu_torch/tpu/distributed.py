"""Multi-process initialization: identity, the global mesh and the host
collectives of a ``torch.distributed`` job.

The port of ``k8s_operator_libs_tpu/tpu/distributed.py``.  The JAX module
joins processes through ``jax.distributed`` and runs its collectives as
jitted XLA reductions over the global mesh; here the backend is
``torch.distributed``: NCCL between cards, gloo on the CPU.

* :func:`resolve_identity`: process identity from the environment, under
  torchrun's names (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``), with the StatefulSet hostname ordinal as the rank when
  ``RANK`` is unset;
* :func:`initialize_from_env`: ``init_process_group`` with that identity
  and an explicit ``tcp://`` address;
* :func:`global_mesh`: a ``(data, seq, model, expert)`` device mesh over
  every rank, one device per rank;
* :func:`host_allreduce_max` and :func:`sync_global_devices`: one
  all-reduce of a one-element tensor each, the drain poll and the named
  barrier of :mod:`.multihost_trainer`;
* :func:`all_reduce_sum`, :func:`all_gather` and :func:`reduce_scatter_sum`:
  the tensor collectives of the sharded train step (:mod:`.workload`)
  over one mesh group.  Under gloo a CUDA tensor (ranks sharing one card,
  which NCCL refuses) goes through a pinned host buffer
  (:func:`host_buffer`, which the rings of :mod:`.ring_attention` use
  too), the compute staying on the card;
* :func:`send`, :func:`recv` and :func:`broadcast`: the point-to-point
  transfers and the broadcast of the GPipe pipeline, staged the same way.
"""

from __future__ import annotations

import os
import re
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "seq", "model", "expert")


def _ordinal_from_hostname(hostname: str) -> Optional[int]:
    """StatefulSet pods are named <name>-<ordinal>; the ordinal is the
    natural rank for a job launched as a StatefulSet."""
    m = re.search(r"-(\d+)$", hostname)
    return int(m.group(1)) if m else None


def resolve_identity(env: Optional[dict] = None) -> Tuple[str, int, int]:
    """(coordinator ``host:port``, world size, rank) from the environment:

    * ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as
      torchrun sets them;
    * the rank falls back to the StatefulSet hostname ordinal
      (<pod>-<n>) when ``RANK`` is unset.

    Raises ValueError when the coordinator or the world size is missing,
    when there is no rank, or when the rank lies outside the world:
    single-process callers simply do not initialize."""
    env = dict(os.environ if env is None else env)
    host, port = env.get("MASTER_ADDR", ""), env.get("MASTER_PORT", "")
    if not host or not port:
        raise ValueError(
            "MASTER_ADDR and MASTER_PORT not both set (multi-process "
            "initialization needs a coordinator; single-process runs skip "
            "initialize)"
        )
    try:
        world = int(env.get("WORLD_SIZE", ""))
    except ValueError as err:
        raise ValueError("WORLD_SIZE must be an integer") from err
    rank_raw = env.get("RANK", "")
    if rank_raw:
        rank = int(rank_raw)
    else:
        hostname = env.get("HOSTNAME", "") or socket.gethostname()
        ordinal = _ordinal_from_hostname(hostname)
        if ordinal is None:
            raise ValueError(
                f"RANK unset and hostname carries no StatefulSet ordinal: {hostname!r}"
            )
        rank = ordinal
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world size {world}")
    return f"{host}:{port}", world, rank


def initialize_from_env(
    env: Optional[dict] = None, device="cuda", backend: Optional[str] = None
) -> Tuple[int, int]:
    """``torch.distributed.init_process_group`` with
    :func:`resolve_identity`.  Returns (rank, world size).

    The backend is NCCL for a CUDA *device* and gloo for the CPU, unless
    *backend* names one (gloo also reduces CUDA tensors: two ranks that
    share one card, which NCCL refuses).  On the card the rank is bound
    to its device, ``LOCAL_RANK`` or else the rank modulo the cards
    seen.  Calling it twice raises, as ``jax.distributed.initialize``
    does: a second call is a deployment bug worth seeing."""
    from .workload import resolve_device  # workload imports this module

    device = resolve_device(device)
    env = dict(os.environ if env is None else env)
    addr, world, rank = resolve_identity(env)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank, **kwargs
    )
    return rank, world


def global_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, ep: int = 1):
    """A ``(data, seq, model, expert)`` DeviceMesh over every rank, one
    device per rank.  Defaults to all-data-parallel; the axis sizes must
    multiply to the world size.  Its device type follows the backend:
    ``cuda`` under NCCL, ``cpu`` under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * sp * ep)
    if dp * tp * sp * ep != n:
        raise ValueError(f"dp*sp*tp*ep = {dp * sp * tp * ep} != global devices {n}")
    return init_device_mesh(group_device().type, (dp, sp, tp, ep), mesh_dim_names=AXES)


def group_device() -> torch.device:
    """Where the default group reduces: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


#: One-element tensors of the host collectives, by (reduction, device):
#: they run every training step, so they are allocated once per process,
#: as the JAX module caches its jitted reductions.
_scalars: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _scalar(kind: str, value: float) -> torch.Tensor:
    device = group_device()
    buf = _scalars.get((kind, device))
    if buf is None:
        buf = _scalars[(kind, device)] = torch.zeros(1, dtype=torch.float32, device=device)
    return buf.fill_(value)


def host_allreduce_max(value: float) -> float:
    """All-reduce a host-side scalar across every rank (max-combine):
    the pattern a drain signal needs.  ONE rank watches the node
    annotation and contributes its flag, every other rank 0.0, and every
    rank learns at the same step that a checkpoint-stop was requested
    (host control flow may not diverge across ranks, or their next
    collective deadlocks)."""
    buf = _scalar("max", value)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return float(buf.item())


def sync_global_devices(name: str = "barrier") -> None:
    """Cross-process barrier: every rank must reach this point before
    any continues.  An all-reduce of a one per rank, whose sum must be
    the world size; *name* only aids debugging of a failed barrier."""
    buf = _scalar("sum", 1.0)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    total, world = int(buf.item()), dist.get_world_size()
    if total != world:
        raise RuntimeError(f"{name}: barrier sum {total} != world size {world}")


# ------------------------------------------------- tensor collectives


def via_host(device, group) -> bool:
    """Whether a collective over *group* on a tensor on *device* goes
    through host memory: a CUDA tensor over a gloo group (ranks sharing
    one card, which NCCL refuses), since gloo reads host memory."""
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


#: Pinned host buffers of the staged collectives and the rings'
#: transport, by (use, bytes).  A train step issues the same few sizes
#: every step, so each is allocated once per process, as the one-element
#: tensors above are.
_pinned: Dict[Tuple[str, int], torch.Tensor] = {}


def host_buffer(t: torch.Tensor, group, use: str, shape=None) -> Optional[torch.Tensor]:
    """The staging of a collective over *group* on *t*: None where the
    backend reads *t* where it lies (:func:`via_host` is false); else a
    pinned host buffer of *t*'s dtype and *shape* (*t*'s by default), one
    per *use* and size.  Its contents last until the next call for the
    same use and size."""
    if not via_host(t.device, group):
        return None
    shape = t.shape if shape is None else torch.Size(shape)
    nbytes = shape.numel() * t.element_size()
    buf = _pinned.get((use, nbytes))
    if buf is None:
        buf = _pinned[use, nbytes] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return buf.view(t.dtype).view(shape)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """*t* summed over *group*, in place; returns *t*.  A group of one
    issues nothing."""
    if dist.get_world_size(group) == 1:
        return t
    host = host_buffer(t, group, "all_reduce")
    if host is None:
        dist.all_reduce(t, group=group)
        return t
    host.copy_(t)
    dist.all_reduce(host, group=group)
    return t.copy_(host)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's *t* of *group*, concatenated along *dim* in rank
    order.  The bytes travel as uint8, so any dtype gathers on either
    backend.  A group of one issues nothing."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous().view(torch.uint8)
    host = host_buffer(src, group, "all_gather")
    if host is not None:
        src = host.copy_(src)
    out = host_buffer(src, group, "all_gather_out", (n, *src.shape))
    if out is None:
        out = src.new_empty((n, *src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=group)
    whole = torch.cat(out.unbind(0), dim % t.dim()).view(t.dtype)
    return whole.to(t.device)


def reduce_scatter_sum(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along *dim* of *t* summed over *group*: of the
    group's equal chunks, the rank's.  A group of one issues nothing."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    chunks = torch.stack(t.chunk(n, dim))  # [n, chunk]: rank r's is row r
    flat = chunks.reshape(-1)  # gloo splits a flat input along its first dim
    out = flat.new_empty(flat.numel() // n)
    host_in = host_buffer(flat, group, "reduce_scatter")
    if host_in is None:
        dist.reduce_scatter_tensor(out, flat, group=group)
    else:
        host_out = host_buffer(out, group, "reduce_scatter_out")
        host_in.copy_(flat)
        dist.reduce_scatter_tensor(host_out, host_in, group=group)
        out.copy_(host_out)
    return out.view(chunks.shape[1:])


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send *t* to rank *dst* of *group* (a point-to-point send)."""
    host = host_buffer(t, group, "send")
    src = t.contiguous() if host is None else host.copy_(t)
    dist.send(src, dist.get_global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of *like*'s shape, dtype and device, received from rank
    *src* of *group*."""
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    host = host_buffer(out, group, "recv")
    dist.recv(out if host is None else host, dist.get_global_rank(group, src), group=group)
    return out if host is None else out.copy_(host)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """*t* of rank *src* of *group* on every rank, in place; returns *t*.
    A group of one issues nothing."""
    if dist.get_world_size(group) == 1:
        return t
    host = host_buffer(t, group, "broadcast")
    if host is None:
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
        return t
    host.copy_(t)
    dist.broadcast(host, dist.get_global_rank(group, src), group=group)
    return t.copy_(host)
