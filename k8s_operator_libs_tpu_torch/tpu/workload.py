"""The training job the orchestrator drains — TinyLM in PyTorch.

The port of ``k8s_operator_libs_tpu/tpu/workload.py``:

* :class:`ModelConfig`, :class:`Block` and :class:`TinyLM` — embed, pre-LN
  blocks (causal attention, then a GELU MLP), LN, LM head;
* :func:`loss_fn` — next-token NLL; :func:`make_train_step` — one AdamW
  update, on one device or SPMD over a :func:`.distributed.global_mesh`
  (below);
* :func:`save_checkpoint` / :func:`restore_checkpoint` — ``torch.save`` of
  the step, the model and the optimizer, the full state even from a
  sharded model;
* :class:`CheckpointingTrainer` — polls the drain watcher between steps,
  checkpoints, acknowledges and stops;
* :func:`generate` / :func:`greedy_generate` — the serving path: one token
  per step over a per-layer :class:`KVCache`, greedy or seeded
  temperature/top-k sampling, ragged prompts, and weight-only int8
  (:func:`quantized_model`, whose layers run the int8 kernel of
  :mod:`.quantize`).

The SPMD step on a ``(data, seq, model, expert)`` mesh is the JAX
module's jitted step under its shardings, with the collectives that XLA
inserts there written out, Megatron-style:

* ``model``, tensor parallelism: :func:`param_partition_spec` names the
  dimension of each parameter that a model rank holds a slice of
  (attention by whole heads); :func:`shard_params` and
  :func:`gather_params` move between the full state_dict and a rank's.
  Column-parallel layers (q/k/v, ``mlp_up``, ``lm_head``) take their
  input through an identity whose backward sums the gradient over the
  group; row-parallel ones (``out``, ``mlp_down``) sum their partial
  products in fp32 and then add the bias.  The embeddings' feature
  slices and the head's vocabulary slices are all-gathered, so every
  model rank computes the whole logits and the loss one device would.
* ``seq``, with ``seq_axis`` set: a rank holds ``[b/dp, S/sp, d]``
  outside attention, at global positions.  Attention runs one of three
  ways, chosen per shape by :func:`attention_plan` with the JAX module's
  loud fallbacks: gathered (an all-gather of the LN output, a
  reduce-scatter in the backward; this rank's chunk of the attention
  taken before ``out``), per-device flash on the local heads (the
  sequence whole on each rank), or a ring over the ``seq`` group
  (:func:`.ring_attention.ring_attention_sharded`).  For the zigzag ring
  the step keeps its token batch zigzag-resident: token ids, targets and
  position ids are permuted before the embedding, so attention finds
  its layout with no transfer; everything outside attention is per
  position and the loss is a mean.
* ``data``: each data rank takes its rows of the global batch.
* the loss of a rank is its NLL sum over the global token count; the
  gradients and the loss travel in one flat buffer, summed over
  ``data`` and, when the sequence is split, ``seq``.  Never over
  ``model`` or ``expert``: the identities' backward already summed what
  crosses them.
* ``remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant).  Every rank issues the
  same collectives in the same order, the recompute's included.
* ``expert``, with ``n_experts``: the soft-gated MoE (:class:`MoeMlp`,
  every expert computes every token and the router's softmax weights
  the sum) keeps its stacked expert weights split over ``expert`` and,
  composed with it, their hidden dimension over ``model``; the router
  replicates.  A rank computes its experts' slice of the hidden
  dimension, and the partial outputs are summed over the (model, expert)
  group; backward, one all-reduce over that group sums the gradients of
  the MoE input and of the gates (:class:`_ToExperts`), so the
  replicated router and everything before the MoE stay in step.

The GPipe pipeline (:func:`make_pipeline_mesh`, :func:`stack_block_params`,
:func:`pipeline_blocks_apply`, :func:`pipeline_loss_fn`,
:func:`make_pipeline_train_step`) runs one block a rank over a
``("stage",)`` mesh: microbatches flow downstream by point-to-point
sends, their input gradients upstream in the backward, and the
embeddings, final LN, head and loss replicate on every stage.

Numerics follow flax: parameters are fp32 masters, but for the MoE's
expert tensors, which flax keeps in ``config.dtype``, and every layer
casts its input and parameters to ``config.dtype`` in its forward (no
autocast); LayerNorm takes its statistics in fp32 with flax's eps 1e-6
and fast variance; GELU is the tanh approximation; AdamW uses optax's
weight decay 1e-4 on every parameter.  Attention runs dense ("gather")
by default and through the flash kernels with ``flash_attention=True``;
decode attends over the cache densely, as flax's decode mode does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..obs import hotpath
from . import distributed, quantize
from .flash_attention import decode_attention

#: optax.adamw(3e-4)'s settings (optax 0.2 defaults: b1 0.9, b2 0.999,
#: eps 1e-8, weight decay 1e-4 on every parameter).
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
#: flax LayerNorm's default epsilon (torch's is 1e-5).
LN_EPS = 1e-6

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq_len: int = 64
    dtype: Any = torch.float32  # bfloat16 on the card
    #: Mesh axis name of sequence parallelism (None = off).  On a mesh,
    #: activations outside attention are split over it (Megatron SP).
    seq_axis: Any = None
    #: Mixture-of-experts width (0 = dense MLP): the soft-gated
    #: :class:`MoeMlp`, its experts split over a mesh's ``expert`` axis,
    #: whose size must divide it.
    n_experts: int = 0
    #: With ``seq_axis``: ring attention over the seq group (Q stays
    #: split, K/V travel the ring) instead of gathering the sequence.
    ring_attention: bool = False
    #: With ``ring_attention``: the flash kernels as the ring's block-pair
    #: engine; the block must tile the local sequence, or the einsum ring
    #: runs, loudly.
    ring_flash: bool = False
    #: With ``ring_flash``: "zigzag" runs the balanced causal ring.
    ring_layout: str = "contiguous"
    #: Recompute each block's activations in the backward instead of
    #: keeping them.  Same loss; gradients equal up to rounding.
    remat: bool = False
    #: Route attention through the CUDA flash kernels
    #: (:mod:`.flash_attention`), padding the sequence to a whole block,
    #: where the sequence is whole on each rank.
    flash_attention: bool = False
    #: Decode mode: :class:`TinyLM` takes one token per call with a
    #: :class:`KVCache` (``generate`` sets it, as the JAX package does).
    decode: bool = False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises on a machine without CUDA: the caller asks
    for the CPU explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


# ------------------------------------------------------------- the mesh


class _Spmd:
    """This rank's place on a :func:`.distributed.global_mesh`: the axis
    sizes, its index on each, and the groups of the step's collectives
    (``model`` is None when the axis has one rank; ``data_seq`` spans
    this rank's (data, seq) submesh, the ranks that hold the same
    parameter slices; ``moe``, for a model of *experts* > 0, its (model,
    expert) submesh, the ranks whose partial MoE outputs sum, None when
    that is one rank).  Raises ValueError when the expert axis does not
    divide *experts*, as JAX's placement of the expert weights does."""

    def __init__(self, mesh, experts: int = 0) -> None:
        sizes = {name: mesh[name].size() for name in distributed.AXES}
        self.mesh = mesh
        self.dp, self.sp, self.tp = sizes["data"], sizes["seq"], sizes["model"]
        self.ep = sizes["expert"]
        if experts and experts % self.ep:
            raise ValueError(
                f"n_experts ({experts}) must be divisible by the mesh's expert axis ({self.ep})"
            )
        self.data_index = mesh.get_local_rank("data")
        self.seq_index = mesh.get_local_rank("seq")
        self.expert_index = mesh.get_local_rank("expert")
        self.data = mesh.get_group("data")
        self.seq = mesh.get_group("seq")
        self.model = mesh.get_group("model") if self.tp > 1 else None
        self.moe = None
        if experts and self.tp * self.ep > 1:
            if self.ep == 1:
                self.moe = self.model
            elif self.tp == 1:
                self.moe = mesh.get_group("expert")
            else:  # a group per (data, seq) coordinate, made on every rank
                ranks = mesh.mesh.reshape(-1, self.tp * self.ep).tolist()
                self.moe, _ = dist.new_subgroups_by_enumeration(ranks)
        if self.sp == 1:
            self.data_seq = self.data
        elif self.dp == 1:
            self.data_seq = self.seq
        else:  # a group per (model, expert) coordinate, made on every rank
            ranks = mesh.mesh.reshape(self.dp * self.sp, -1).T.tolist()
            self.data_seq, _ = dist.new_subgroups_by_enumeration(ranks)


def _own(x, group, dim: int):
    """This rank's chunk of *x* along *dim*, of the group's equal chunks."""
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


class _ToModel(torch.autograd.Function):
    """Megatron's f, before column-parallel layers: identity forward; the
    gradient summed over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        summed = distributed.all_reduce_sum(grad.to(torch.float32, copy=True), ctx.group)
        return summed.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g, after row-parallel layers: the partial products
    summed over the model group (in fp32, returned fp32) forward;
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return distributed.all_reduce_sum(x.to(torch.float32, copy=True), group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _ToExperts(torch.autograd.Function):
    """Megatron's f before the MoE's experts, for the input *h* and the
    router's *gates* at once: identity forward; backward, both gradients
    summed over the (model, expert) group in fp32, in one all-reduce.  A
    rank's experts see only their gates and their slice of the hidden
    dimension, so each gradient is a partial sum of the whole."""

    @staticmethod
    def forward(ctx, h, gates, group):
        ctx.group = group
        return h.view_as(h), gates.view_as(gates)

    @staticmethod
    def backward(ctx, dh, dgates):
        flat = torch.cat([dh.float().reshape(-1), dgates.float().reshape(-1)])
        distributed.all_reduce_sum(flat, ctx.group)
        n = dh.numel()
        return (flat[:n].view_as(dh).to(dh.dtype), flat[n:].view_as(dgates).to(dgates.dtype), None)


class _Gather(torch.autograd.Function):
    """All-gather along *dim* over *group*.  Backward: this rank's chunk
    of the gradient, summed over the group when *reduce* (a
    reduce-scatter, in fp32: the ranks use the gathered sequence for
    different outputs) and as it is otherwise (the ranks hold the same
    gradient: the model axis's features and logits)."""

    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return distributed.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            summed = distributed.reduce_scatter_sum(grad.float(), ctx.group, ctx.dim)
            return summed.to(grad.dtype), None, None, None
        return _own(grad, ctx.group, ctx.dim), None, None, None


class _Slice(torch.autograd.Function):
    """This rank's chunk along *dim* of a tensor every rank of *group*
    holds whole.  Backward: the gradient in that chunk and zero in the
    others, whose gradients arise on their own ranks (the gather's
    reduce-scatter sums them)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.shape = group, dim, x.shape
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        n = grad.shape[ctx.dim]
        full.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n).copy_(grad)
        return full, None, None


def param_partition_spec(name: str, axis: str = "model") -> Optional[int]:
    """The dimension of state_dict entry *name* that mesh axis *axis*
    (``model`` or ``expert``) splits, or None where every rank of the axis
    holds it whole: the JAX module's path rule over torch's layouts
    (``Dense.weight`` is ``[out, in]``, the transpose of flax's kernel).

    * ``experts_up`` ``[E, d, f]`` and ``experts_down`` ``[E, f, d]`` keep
      flax's layout: ``expert`` splits the experts, ``model`` the hidden
      ``f`` (JAX's ``P("expert", None, "model")`` and ``P("expert",
      "model", None)``); nothing else splits over ``expert``, the router
      included;
    * ``query``/``key``/``value``/``mlp_up`` split their output, weight
      and bias (column-parallel);
    * ``out``/``mlp_down`` split their input; their bias replicates
      (row-parallel);
    * ``embed``/``pos_embed`` split their features;
    * ``lm_head`` splits the vocabulary, weight and bias;
    * LayerNorms replicate.

    Attention splits by whole heads, not by head_dim as flax's 3-D
    kernel spec reads: the flash kernels need whole heads on a rank, and
    the rows of a ``[h*hd, d]`` weight are head-major, so a contiguous
    row slice is a set of heads (:func:`shard_params` checks that the
    heads divide)."""
    layer, leaf = name.split(".")[-2:]
    if leaf in ("experts_up", "experts_down"):
        if axis == "expert":
            return 0
        return 2 if leaf == "experts_up" else 1
    if axis != "model":
        return None
    if layer in ("query", "key", "value", "mlp_up", "lm_head"):
        return 0
    if layer in ("out", "mlp_down"):
        return 1 if leaf == "weight" else None
    if layer in ("embed", "pos_embed"):
        return 1
    return None


#: The mesh axes that split parameters, in the order shard and gather go.
_PARAM_AXES = ("model", "expert")


def shard_params(state_dict, mesh, n_heads: int) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full *state_dict* (a TinyLM's, or
    :func:`..convert.params_from_jax`'s) per :func:`param_partition_spec`:
    of each split dimension the axis's equal chunks, this rank's one.
    Raises ValueError when the model axis does not divide the heads, or
    an axis a split dimension."""
    tp = mesh["model"].size()
    if n_heads % tp:
        raise ValueError(
            f"param_partition_spec splits attention by whole heads: n_heads ({n_heads}) "
            f"is not divisible by the model axis ({tp})"
        )
    out = dict(state_dict)
    for axis in _PARAM_AXES:
        n, index = mesh[axis].size(), mesh.get_local_rank(axis)
        if n == 1:
            continue
        for name, t in out.items():
            dim = param_partition_spec(name, axis)
            if dim is None:
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"param_partition_spec splits {name} on dim {dim} ({t.shape[dim]}), "
                    f"which the {axis} axis ({n}) does not divide"
                )
            out[name] = t.chunk(n, dim)[index].contiguous()
    return out


def gather_params(state_dict, mesh) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: the full state_dict from every
    rank's slices.  A collective over the model group and then the
    expert group: every rank of them calls, and each gets the whole."""
    out = dict(state_dict)
    for axis in _PARAM_AXES:
        if mesh[axis].size() == 1:
            continue
        group = mesh.get_group(axis)
        for name, t in out.items():
            dim = param_partition_spec(name, axis)
            if dim is not None:
                out[name] = distributed.all_gather(t, group, dim)
    return out


def _is_split(spmd) -> bool:
    """Whether a model on *spmd* holds slices of its parameters."""
    return spmd is not None and (spmd.tp > 1 or spmd.ep > 1)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How attention runs for one shape (:func:`attention_plan`)."""

    tier: str  # "ring", "flash" (per-device kernel) or "gather" (dense)
    #: The sequence is split over the seq axis outside attention.
    seq_split: bool = False
    #: ring: the flash kernels as the pair engine, the layout, the block
    use_flash: bool = False
    layout: str = "contiguous"
    block: int = 128


#: (seq_len, sp) combinations already warned about: the fallback from an
#: indivisible sequence is logged once per shape, as the JAX module does.
_ring_fallback_warned: set = set()


def attention_plan(config: ModelConfig, seq_len: int, sp: int = 1,
                   seq_sharding: bool = False) -> AttentionPlan:
    """Block's choice of attention for a sequence of *seq_len* (after the
    teacher-forcing shift): the JAX module's three tiers and their loud
    fallbacks.  *seq_sharding*: the step runs on a mesh with the seq
    axis configured, of *sp* ranks.

    * ring, when ``ring_attention`` is set and *seq_len* divides by *sp*;
      with ``ring_flash`` its block is ``min(128, span)``, the span being
      the local sequence, or its half for zigzag; an untileable span
      warns and runs the einsum ring;
    * flash, when ``flash_attention`` is set and the sequence is whole on
      each rank;
    * gather otherwise; ``flash_attention`` under sequence sharding warns.

    An indivisible *seq_len* warns once per ``(seq_len, sp)`` and
    gathers, as in JAX; here the sequence then also replicates over the
    seq axis for that shape, where XLA pads an uneven split."""
    cfg = config
    split = seq_sharding and seq_len % sp == 0
    if seq_sharding and not split and (seq_len, sp) not in _ring_fallback_warned:
        _ring_fallback_warned.add((seq_len, sp))
        if cfg.ring_attention:
            _log.warning(
                "ring_attention requested but seq length %d is not divisible by the %r "
                "mesh axis (size %d); falling back to all-gather attention (O(seq) "
                "memory) for this shape — pad/choose a divisible sequence length to "
                "get the ring", seq_len, cfg.seq_axis, sp,
            )
        else:
            _log.warning(
                "sequence parallelism: seq length %d is not divisible by the %r mesh "
                "axis (size %d); the sequence replicates over that axis for this "
                "shape — pad/choose a divisible sequence length to split it",
                seq_len, cfg.seq_axis, sp,
            )
    if cfg.ring_attention and split:
        s_loc = max(1, seq_len // sp)
        use_flash = cfg.ring_flash
        layout = cfg.ring_layout if use_flash else "contiguous"
        if use_flash:
            span = s_loc // 2 if layout == "zigzag" else s_loc
            blk = min(128, max(1, span))
            if span <= 0 or span % blk or (layout == "zigzag" and s_loc % 2):
                _log.warning(
                    "ring_flash(%s): flash block %d does not tile the local sequence "
                    "%d — falling back to the einsum ring for this shape",
                    layout, blk, s_loc,
                )
                use_flash, layout = False, "contiguous"
        else:
            blk = min(128, s_loc)
        return AttentionPlan("ring", True, use_flash, layout, blk)
    if cfg.flash_attention and not seq_sharding:
        return AttentionPlan("flash")
    if cfg.flash_attention:
        _log.warning(
            "flash_attention=True but sequence sharding is active: the per-chip flash "
            "kernel needs the full sequence — falling back to all-gather attention "
            "(use ring_attention for the sharded path)"
        )
    return AttentionPlan("gather", split)


# ------------------------------------------------------------- layers


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    """flax's lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(
        w, std=std, a=-2 * std, b=2 * std, generator=generator
    )


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 master weights and flax Dense numerics:
    input, weight and bias cast to *dtype* in the forward.  The weight is
    torch's ``[out, in]``; flax's kernel is its transpose.

    *parallel* is its role once its weight is split over a model group
    (``group``, set by :class:`TinyLM`): "column" splits the output (the
    caller passes the input through :class:`_ToModel`), "row" the input:
    the partial products are summed over the group in fp32, then the
    bias, whole on every rank, is added; None (the MoE router) keeps it
    whole on every rank."""

    def __init__(self, in_f, out_f, dtype, device, generator, parallel=None) -> None:
        super().__init__(in_f, out_f, device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        self.parallel = parallel
        self.group = None
        with torch.no_grad():
            _lecun_normal_(self.weight, in_f, generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        if self.group is None or self.parallel != "row":
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        y = _ReduceFromModel.apply(F.linear(x.to(dt), self.weight.to(dt)), self.group)
        return (y + self.bias.to(dt).float()).to(dt)


class Embed(nn.Module):
    """flax ``Embed``: an fp32 table, rows cast to *dtype*."""

    def __init__(self, num, features, dtype, device, generator) -> None:
        super().__init__()
        self.compute_dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features, device=device))
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(features), generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.embedding).to(self.compute_dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: statistics in fp32 with the fast variance
    E[x^2] - E[x]^2, eps 1e-6, output in *dtype*."""

    def __init__(self, features, dtype, device) -> None:
        super().__init__()
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x - mean) * torch.rsqrt(var + LN_EPS) * self.scale + self.bias
        return y.to(self.compute_dtype)


def _attend(q, k, v, visible):
    """flax ``dot_product_attention`` in the compute dtype: q [b, sq, h,
    d] scaled by 1/sqrt(d), keys where *visible* ([sq, sk] or [sk]) is
    False masked with ``finfo.min``, softmax in the scores' dtype."""
    q = q / math.sqrt(q.shape[3])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores.masked_fill(~visible, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class KVCache:
    """flax's decode-mode ``cache`` collection for :class:`TinyLM`: per
    layer ``cached_key`` / ``cached_value`` [b, total, h, hd] in the
    compute dtype, zero at the start, sized to one generation's span
    (*total* = prompt + new tokens), and ONE index shared by every row and
    layer: the position the next call writes."""

    def __init__(self, config: ModelConfig, batch: int, total: int, device) -> None:
        shape = (batch, total, config.n_heads, config.d_model // config.n_heads)
        zeros = lambda: torch.zeros(shape, dtype=config.dtype, device=device)  # noqa: E731
        self.keys = [zeros() for _ in range(config.n_layers)]
        self.values = [zeros() for _ in range(config.n_layers)]
        self.index = 0


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = d_model):
    query/key/value/out projections with biases, causal attention between
    them as the :class:`AttentionPlan` says — dense, the flash kernels or
    a ring; over a :class:`KVCache` in decode.  On a model axis its
    projections hold this rank's heads, ``head_dim`` wide each."""

    def __init__(self, cfg: ModelConfig, device, generator) -> None:
        super().__init__()
        d = cfg.d_model
        self.seq_axis = cfg.seq_axis
        self.head_dim = d // cfg.n_heads
        for name in ("query", "key", "value", "out"):
            role = "row" if name == "out" else "column"
            self.add_module(name, Dense(d, d, cfg.dtype, device, generator, role))

    @staticmethod
    def _dense_causal(q, k, v):
        """Causal attention in the compute dtype (the "gather" path)."""
        s = q.shape[1]
        return _attend(q, k, v, torch.ones(s, s, dtype=torch.bool, device=q.device).tril())

    @staticmethod
    def _cached(q, k, v, cache: KVCache, layer: int):
        """flax's decode step: write this token's K/V at the cache index,
        then attend over the cached keys ``arange(total) <= index``: on the
        card the decode kernel reads that prefix of the cache in place."""
        i, keys, values = cache.index, cache.keys[layer], cache.values[layer]
        keys[:, i] = k[:, 0]
        values[:, i] = v[:, 0]
        return decode_attention(q, keys, values, i)

    def forward(self, x, plan: AttentionPlan, cache: KVCache = None, layer: int = 0,
                spmd: Optional[_Spmd] = None):
        gathered = plan.tier == "gather" and plan.seq_split
        if gathered:  # Megatron SP: attention sees the whole sequence
            x = _Gather.apply(x, spmd.seq, 1, True)
        if spmd is not None and spmd.model is not None:
            x = _ToModel.apply(x, spmd.model)
        b, s, _ = x.shape
        split = lambda t: t.reshape(b, s, -1, self.head_dim)  # noqa: E731
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if cache is not None:
            h = self._cached(q, k, v, cache, layer)
        elif plan.tier == "ring":
            from .ring_attention import ring_attention_sharded

            h = ring_attention_sharded(
                q, k, v, spmd.mesh, self.seq_axis, causal=True, use_flash=plan.use_flash,
                flash_block=plan.block, layout=plan.layout,
            )
        elif plan.tier == "flash":
            from .flash_attention import make_flash_attention_fn

            h = make_flash_attention_fn()(q, k, v)
        else:
            h = self._dense_causal(q, k, v)
        h = h.reshape(b, s, -1)
        if gathered:  # back to this rank's chunk, before the out projection
            h = _Slice.apply(h, spmd.seq, 1)
        return self.out(h)


class MoeMlp(nn.Module):
    """flax ``MoeMlp``, the soft-gated mixture of experts: the ``router``
    Dense to E gates, softmax in fp32 cast to the compute dtype; every
    expert computes every token, ``up = einsum("bsd,edf->bsef")``,
    tanh-GELU, ``down = einsum("bsef,efd->bsed")``, and the gates weight
    the sum over experts.  ``experts_up`` ``[E, d, f]`` and
    ``experts_down`` ``[E, f, d]`` keep flax's layout and, as flax stores
    them, the compute dtype (not fp32 masters like the Dense layers):
    lecun-normal over flax's fan-in, which folds the experts axis in
    (``d·E`` and ``f·E``), drawn in fp32 and cast.

    On a mesh a rank holds ``E/ep`` experts and ``f/tp`` of their hidden
    dimension (:func:`param_partition_spec`): it takes its experts'
    gates, computes its partial output, and the partials are summed over
    the (model, expert) group, in fp32."""

    def __init__(self, cfg: ModelConfig, device, generator) -> None:
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.compute_dtype = cfg.dtype
        self.router = Dense(d, e, cfg.dtype, device, generator)
        up, down = torch.empty(e, d, f, device=device), torch.empty(e, f, d, device=device)
        with torch.no_grad():
            _lecun_normal_(up, d * e, generator)
            _lecun_normal_(down, f * e, generator)
        self.experts_up = nn.Parameter(up.to(cfg.dtype))
        self.experts_down = nn.Parameter(down.to(cfg.dtype))

    def forward(self, h, spmd: Optional[_Spmd] = None):
        dt = self.compute_dtype
        gates = torch.softmax(self.router(h).float(), dim=-1).to(dt)
        group = None if spmd is None else spmd.moe
        if group is not None:
            h, gates = _ToExperts.apply(h, gates, group)
        if spmd is not None and spmd.ep > 1:  # this rank's experts' gates
            local = self.experts_up.shape[0]
            gates = gates[..., spmd.expert_index * local:(spmd.expert_index + 1) * local]
        up = torch.einsum("bsd,edf->bsef", h.to(dt), self.experts_up)
        down = torch.einsum("bsef,efd->bsed", F.gelu(up, approximate="tanh"), self.experts_down)
        y = torch.einsum("bsed,bse->bsd", down, gates)
        if group is None:
            return y
        return _ReduceFromModel.apply(y, group).to(dt)


class Block(nn.Module):
    """Pre-LN transformer block with causal self-attention, then the MLP
    (``mlp_up``, GELU, ``mlp_down``) or, with ``n_experts``, :class:`MoeMlp`."""

    def __init__(self, cfg: ModelConfig, device, generator) -> None:
        super().__init__()
        dt = cfg.dtype
        self.ln_attn = LayerNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg, device, generator)
        self.ln_mlp = LayerNorm(cfg.d_model, dt, device)
        if cfg.n_experts > 0:
            self.moe = MoeMlp(cfg, device, generator)
        else:
            self.mlp_up = Dense(cfg.d_model, cfg.d_ff, dt, device, generator, "column")
            self.mlp_down = Dense(cfg.d_ff, cfg.d_model, dt, device, generator, "row")

    def forward(self, x, plan: AttentionPlan, cache: KVCache = None, layer: int = 0,
                spmd: Optional[_Spmd] = None):
        x = x + self.attn(self.ln_attn(x), plan, cache, layer, spmd)
        h = self.ln_mlp(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, spmd)
        if spmd is not None and spmd.model is not None:
            h = _ToModel.apply(h, spmd.model)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)


class TinyLM(nn.Module):
    """Causal LM: embed → blocks → LN → logits.  Submodule names follow
    the flax param tree (``block_0/attn/query`` is ``block_0.attn.query``)
    so :mod:`..convert` maps one onto the other.

    With a *mesh* (:func:`.distributed.global_mesh`) the model is built
    whole from *seed* on every rank, then keeps this rank's slice of each
    parameter (:func:`shard_params`); its state_dict keys stay TinyLM's."""

    def __init__(self, config: ModelConfig, device="cuda", seed: int = 0, mesh=None) -> None:
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device, gen)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, cfg.dtype, device, gen)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, device, gen))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device, gen, "column")
        self.spmd: Optional[_Spmd] = None
        self._plans: Dict[tuple, AttentionPlan] = {}
        if mesh is not None:
            self._place(mesh)

    def _place(self, mesh) -> None:
        spmd = self.spmd = _Spmd(mesh, self.config.n_experts)
        if _is_split(spmd):
            shards = shard_params(self.state_dict(), mesh, self.config.n_heads)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    p.data = shards[name].clone()  # not a view that keeps the whole alive
        for module in self.modules():
            if isinstance(module, Dense):
                module.group = spmd.model

    def plan(self, seq_len: int, seq_sharding: bool = False) -> AttentionPlan:
        """:func:`attention_plan` for this model, once per shape (its
        warnings with it, as the JAX module's come once per trace)."""
        key = (seq_len, seq_sharding)
        if key not in self._plans:
            sp = self.spmd.sp if self.spmd is not None else 1
            self._plans[key] = attention_plan(self.config, seq_len, sp, seq_sharding)
        return self._plans[key]

    def forward(self, tokens, positions=None, cache: KVCache = None, plan: AttentionPlan = None):
        """Logits [b, s, vocab].  With a *cache* (decode) *tokens* is one
        token per row, written at ``cache.index``, which then advances.
        On a mesh *tokens* are this rank's, at global *positions*, and
        *plan* says how attention runs (the whole sequence on every rank
        when None)."""
        if cache is None and self.config.decode:
            raise ValueError("a decode-mode TinyLM takes a KVCache")
        if cache is not None and tokens.shape[1] != 1:
            raise ValueError(f"decode feeds one token per row, got {tokens.shape[1]}")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        if plan is None:
            plan = self.plan(tokens.shape[1])
        model_group = self.spmd.model if self.spmd is not None else None
        x = self.embed(tokens) + self.pos_embed(positions)
        if model_group is not None:  # feature slices -> whole features
            x = _Gather.apply(x, model_group, -1, False)
        remat = self.config.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.config.n_layers):
            block = getattr(self, f"block_{i}")
            if remat:
                x = checkpoint(block, x, plan, None, i, self.spmd, use_reentrant=False)
            else:
                x = block(x, plan, cache, i, self.spmd)
        if cache is not None:
            cache.index += 1
        x = self.ln_f(x)
        if model_group is None:
            return self.lm_head(x)
        logits = self.lm_head(_ToModel.apply(x, model_group))
        return _Gather.apply(logits, model_group, -1, False)  # vocabulary slices


# ------------------------------------------------------------ train state


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def create_train_state(config: ModelConfig, device="cuda", seed: int = 0, mesh=None):
    """(model, optimizer): TinyLM from *seed* and ``optax.adamw(3e-4)``'s
    torch counterpart.  With a *mesh* every rank builds the same whole
    model from *seed* and keeps its slice, as the JAX module inits its
    params and places them on the mesh."""
    model = TinyLM(config, device=resolve_device(device), seed=seed, mesh=mesh)
    optimizer = torch.optim.AdamW(model.parameters(), **ADAMW)
    return model, optimizer


def _token_nll(logits, targets):
    """Mean next-token negative log-likelihood, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def loss_fn(model: TinyLM, tokens):
    """Next-token cross-entropy (teacher-forced causal LM)."""
    return _token_nll(model(tokens[:, :-1]), tokens[:, 1:])


def _rank_loss(model: TinyLM, tokens):
    """(this rank's share of the loss of the global batch *tokens*, the
    attention plan).  The share covers the rank's rows (data axis) and,
    when the sequence is split, its chunk of positions (the zigzag pair
    of chunks for the zigzag ring); its NLL sum over the global token
    count, so the shares sum to the mean over the ranks that the step
    reduces over."""
    spmd = model.spmd
    if tokens.shape[0] % spmd.dp:
        raise ValueError(f"global batch {tokens.shape[0]} not divisible by the data axis ({spmd.dp})")
    rows = tokens.shape[0] // spmd.dp
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    n_tokens = targets.numel()
    inputs, targets = (t[spmd.data_index * rows:(spmd.data_index + 1) * rows] for t in (inputs, targets))
    s = inputs.shape[1]
    plan = model.plan(s, seq_sharding=model.config.seq_axis is not None)
    positions = torch.arange(s, device=tokens.device)[None, :]
    if plan.seq_split:
        if plan.layout == "zigzag":
            from .ring_attention import to_zigzag

            inputs, targets, positions = (to_zigzag(t, spmd.sp) for t in (inputs, targets, positions))
        n = s // spmd.sp
        inputs, targets, positions = (
            t[:, spmd.seq_index * n:(spmd.seq_index + 1) * n] for t in (inputs, targets, positions)
        )
    nll = _token_nll(model(inputs, positions, plan=plan), targets)
    return nll * (targets.numel() / n_tokens), plan


def make_train_step(model: TinyLM, optimizer, mesh=None):
    """``step(tokens) -> loss``: one AdamW update, in place.

    With a *mesh* (the one *model* was built on) the step is SPMD, as the
    JAX step is under its shardings: every rank passes the same global
    batch, computes its share of the loss (:func:`_rank_loss`), and the
    gradients and the loss travel in one flat buffer, summed over the
    data group, or the (data, seq) group when the sequence is split,
    before AdamW.  So every rank applies the update the unsharded model would
    and returns the same loss, the mean over the global batch.  Plain
    collectives, not ``DistributedDataParallel``: the model keeps
    TinyLM's state_dict keys for checkpoints and :mod:`..convert`.

    Inside a ``train.step`` trace (:meth:`CheckpointingTrainer.run`) the
    forward, the backward and the optimizer are its timed phases
    (:mod:`..obs.hotpath`); on a mesh the backward's device time takes in
    the gradients' all-reduce.  Called outside one, the step records
    nothing."""
    if mesh is None:

        def step(tokens):
            optimizer.zero_grad(set_to_none=True)
            with hotpath.phase("train.forward", timed=True):
                loss = loss_fn(model, tokens)
            with hotpath.phase("train.backward", timed=True):
                loss.backward()
            with hotpath.phase("train.optimizer", timed=True, closes=True):
                optimizer.step()
            return loss.detach()

        return step

    spmd = model.spmd
    if spmd is None or spmd.mesh is not mesh:
        raise ValueError("the model was not built on this mesh: create_train_state(..., mesh=mesh)")
    params = list(model.parameters())

    def spmd_step(tokens):
        optimizer.zero_grad(set_to_none=True)
        with hotpath.phase("train.forward", timed=True):
            loss, plan = _rank_loss(model, tokens)
        with hotpath.phase("train.backward", timed=True):
            loss.backward()
        flat = _flat([p.grad for p in params] + [loss.detach().float().reshape(1)])
        distributed.all_reduce_sum(flat, spmd.data_seq if plan.seq_split else spmd.data)
        _unflatten_into(flat[:-1], [p.grad for p in params])
        with hotpath.phase("train.optimizer", timed=True, closes=True):
            optimizer.step()
        return flat[-1]

    return spmd_step


def make_batch(config: ModelConfig, batch_size: int, seed: int = 0, device="cpu"):
    """The JAX package's batch, token for token (same numpy generator),
    as int64 for ``nn.Embedding``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, config.vocab_size, size=(batch_size, config.max_seq_len))
    return torch.from_numpy(tokens.astype(np.int64)).to(device)


# ---------------------------------------------------- pipeline parallelism


def make_pipeline_mesh(n_stages: int):
    """A 1-D ``("stage",)`` DeviceMesh over ranks ``0..n_stages-1`` for the
    GPipe pipeline, kept apart from the (data, seq, model, expert) mesh as
    the JAX module keeps it.  Every rank calls it (a collective); ranks
    past *n_stages* are not on it.  Raises ValueError when the job has
    fewer ranks than stages."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if world < n_stages:
        raise ValueError(f"need {n_stages} devices, have {world}")
    return DeviceMesh(distributed.group_device().type, torch.arange(n_stages), mesh_dim_names=("stage",))


def stack_block_params(state_dict, n_layers: int):
    """(stacked, rest) of a TinyLM *state_dict*: ``block_0..block_{L-1}``
    stacked into one ``[L, ...]`` tensor per key of one :class:`Block`
    (``attn.query.weight``, ...), and every other entry as it is.  Stage
    ``i`` of the pipeline takes ``{k: v[i]}``, its own block."""
    keys = [k.split(".", 1)[1] for k in state_dict if k.startswith("block_0.")]
    stacked = {k: torch.stack([state_dict[f"block_{i}.{k}"] for i in range(n_layers)]) for k in keys}
    rest = {k: v for k, v in state_dict.items() if not k.startswith("block_")}
    return stacked, rest


def pipeline_stage_params(state_dict, n_layers: int, stage: int):
    """Stage *stage*'s tensors from a full TinyLM *state_dict*: (its block,
    keyed like one :class:`Block`; the rest), copies that require grad,
    for :func:`pipeline_loss_fn` and an optimizer."""
    stacked, rest = stack_block_params(state_dict, n_layers)
    return ({k: v[stage].clone().requires_grad_() for k, v in stacked.items()},
            {k: v.clone().requires_grad_() for k, v in rest.items()})


def _sub(params, prefix: str):
    """The entries of *params* under module *prefix*, keyed below it."""
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class _Pipeline(torch.autograd.Function):
    """This stage's share of the GPipe schedule, forward and backward,
    as one autograd node (so the point-to-point order is fixed, not left
    to the autograd engine): stage ``s`` applies its block to microbatch
    ``m`` at tick ``m + s`` of ``M + S - 1``, taking it from stage ``s-1``
    (stage 0: from *x*) and sending the result to ``s+1``; the last
    stage's outputs go to every stage.  Backward runs the ticks in
    reverse: each microbatch's output gradient comes from ``s+1`` (the
    last stage: from the loss), its input gradient goes to ``s-1``, and
    stage 0's input gradients go to every stage, whose embeddings then
    take the same gradient."""

    @staticmethod
    def forward(ctx, x, run, *params):
        group, stage, stages = run["group"], run["stage"], run["stages"]
        micro = x.detach().chunk(run["microbatches"])
        leaves = [p.detach().requires_grad_() for p in params]
        weights = dict(zip(run["names"], leaves))
        ins, outs = [], []
        for tick in range(len(micro) + stages - 1):
            m = tick - stage
            if not 0 <= m < len(micro):
                continue
            if stage == 0:
                x_in = micro[m].clone()
            else:
                x_in = distributed.recv(micro[m], stage - 1, group)
            x_in.requires_grad_()
            with torch.enable_grad():
                y = torch.func.functional_call(run["block"], weights, (x_in, run["plan"]))
            if stage < stages - 1:
                distributed.send(y.detach(), stage + 1, group)
            ins.append(x_in)
            outs.append(y)
        ctx.run, ctx.ins, ctx.outs, ctx.leaves = run, ins, outs, leaves
        if stage == stages - 1:
            out = torch.cat([y.detach() for y in outs])
        else:
            out = torch.empty_like(x)
        return distributed.broadcast(out, stages - 1, group)

    @staticmethod
    def backward(ctx, dout):
        run = ctx.run
        group, stage, stages = run["group"], run["stage"], run["stages"]
        grads = [torch.zeros_like(p) for p in ctx.leaves]
        d_micro = dout.chunk(run["microbatches"])
        dx = [None] * len(d_micro)
        for m in reversed(range(len(d_micro))):
            if stage == stages - 1:
                dy = d_micro[m].contiguous()
            else:
                dy = distributed.recv(d_micro[m], stage + 1, group)
            g = torch.autograd.grad(ctx.outs[m], [ctx.ins[m], *ctx.leaves], dy)
            for acc, gp in zip(grads, g[1:]):
                acc.add_(gp)
            if stage > 0:
                distributed.send(g[0], stage - 1, group)
            dx[m] = g[0]
        dx = torch.cat(dx) if stage == 0 else torch.empty_like(dout)
        ctx.ins = ctx.outs = None
        return (distributed.broadcast(dx, 0, group), None, *grads)


def pipeline_blocks_apply(config: ModelConfig, mesh, stage_params, x, n_microbatches: int):
    """Run the block stack as a GPipe pipeline over *mesh*'s ``stage``
    axis, each stage applying its own block: *stage_params* (this
    stage's slice of :func:`stack_block_params`' stack) to the embedded
    activations *x* ``(B, S, D)``, split into *n_microbatches*.
    Differentiable: gradients reach *stage_params* and *x*.  Returns the
    last stage's output on every stage.

    One block per stage (``n_layers == n_stages``), as in JAX: raises
    ValueError otherwise, and when the microbatches do not divide the
    batch."""
    n_stages = mesh.size()
    if config.n_layers != n_stages:
        raise ValueError(
            f"pipeline demo runs one block per stage: n_layers ({config.n_layers}) must "
            f"equal the stage-mesh size ({n_stages})"
        )
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible into {n_microbatches} microbatches")
    run = {
        "group": mesh.get_group(), "stage": mesh.get_local_rank(), "stages": n_stages,
        "microbatches": n_microbatches, "names": list(stage_params),
        # a Block on the meta device: functional_call gives it the stage's tensors
        "block": Block(config, torch.device("meta"), None),
        "plan": attention_plan(config, x.shape[1]),
    }
    return _Pipeline.apply(x, run, *stage_params.values())


def pipeline_loss_fn(config: ModelConfig, mesh, stage_params, rest_params, tokens,
                     n_microbatches: int = 2):
    """Next-token loss with the block stack pipelined over the stages
    (:func:`pipeline_blocks_apply`).  The embeddings, final LayerNorm,
    head and loss run replicated on every stage from *rest_params*, as
    the JAX module runs them outside its shard_map, and the NLL is the
    mean over the whole batch: the loss of :func:`loss_fn` on the same
    weights."""
    meta, dt = torch.device("meta"), config.dtype
    inputs = tokens[:, :-1]
    positions = torch.arange(inputs.shape[1], device=tokens.device)[None, :]
    embed = Embed(config.vocab_size, config.d_model, dt, meta, None)
    pos_embed = Embed(config.max_seq_len, config.d_model, dt, meta, None)
    x = (torch.func.functional_call(embed, _sub(rest_params, "embed"), (inputs,))
         + torch.func.functional_call(pos_embed, _sub(rest_params, "pos_embed"), (positions,)))
    x = pipeline_blocks_apply(config, mesh, stage_params, x, n_microbatches)
    x = torch.func.functional_call(LayerNorm(config.d_model, dt, meta), _sub(rest_params, "ln_f"), (x,))
    head = Dense(config.d_model, config.vocab_size, dt, meta, None)
    return _token_nll(torch.func.functional_call(head, _sub(rest_params, "lm_head"), (x,)), tokens[:, 1:])


def make_pipeline_train_step(config: ModelConfig, mesh, optimizer, n_microbatches: int = 2):
    """``step(stage_params, rest_params, tokens) -> loss``: one AdamW update
    of the pipelined model, in place; *optimizer* holds this stage's
    block tensors and the rest, which every stage updates alike (their
    gradients and the loss are the same on every stage)."""

    def step(stage_params, rest_params, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = pipeline_loss_fn(config, mesh, stage_params, rest_params, tokens, n_microbatches)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ------------------------------------------------------------ checkpoints


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def _moments_by_rule(model, opt_state, fn):
    """*opt_state* (AdamW's) with its moments passed through *fn*, a map
    of ``{parameter name: tensor}`` dicts such as :func:`gather_params`:
    each moment is split as its parameter is."""
    names = [name for name, _ in model.named_parameters()]
    per_param = opt_state["state"]
    moments = {
        key: fn({names[i]: s[key] for i, s in per_param.items()}) for key in ("exp_avg", "exp_avg_sq")
    }
    return {**opt_state, "state": {
        i: {**s, **{key: moments[key][names[i]] for key in moments}} for i, s in per_param.items()
    }}


def _full_state(model, optimizer):
    """(model state_dict, optimizer state_dict) of the whole model.  A
    model split over the model or expert axis gathers both
    (:func:`gather_params`), as orbax saves the ``jax.device_get`` of
    sharded arrays: a collective over those groups, which every rank of
    them calls."""
    model_state, opt_state = model.state_dict(), optimizer.state_dict()
    spmd = getattr(model, "spmd", None)
    if not _is_split(spmd):
        return model_state, opt_state
    gather = lambda d: gather_params(d, spmd.mesh)  # noqa: E731
    return gather(model_state), _moments_by_rule(model, opt_state, gather)


def save_checkpoint(directory: str, step: int, model, optimizer) -> None:
    """``torch.save`` of the full training state (:func:`_full_state`)."""
    model_state, opt_state = _full_state(model, optimizer)
    os.makedirs(directory, exist_ok=True)
    path = _checkpoint_path(directory, step)
    tmp = path + ".tmp"
    torch.save({"step": step, "model": model_state, "optimizer": opt_state}, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def restore_checkpoint(directory: str, step: int, map_location="cpu") -> Dict[str, Any]:
    return torch.load(
        _checkpoint_path(directory, step), map_location=map_location, weights_only=True
    )


class CheckpointingTrainer:
    """The drain-aware training loop.

    Runs train steps; between steps polls the drain watcher — when the
    orchestrator requests a pre-drain checkpoint the trainer saves,
    acknowledges, and stops cleanly so the eviction finds an idle process.

    With a *mesh* it holds this rank's share of the sharded state and
    steps SPMD; :meth:`save` writes the full state (a collective) and
    :meth:`load` takes one.  A job of several ranks drives ``step_fn``
    and ``save`` under :class:`.multihost_trainer.MultihostDrainLoop`,
    which stops every rank at one step: :meth:`run` refuses a watcher on
    such a mesh, since polled by one rank alone it would stop only that
    rank, whose save then waits for ranks that never join.
    """

    def __init__(
        self,
        config: ModelConfig,
        checkpoint_dir: str,
        watcher=None,
        batch_size: int = 8,
        device="cuda",
        seed: int = 0,
        mesh=None,
    ) -> None:
        self.config = config
        self.checkpoint_dir = checkpoint_dir
        self.watcher = watcher
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model, self.optimizer = create_train_state(config, self.device, seed, mesh)
        self.step_fn = make_train_step(self.model, self.optimizer, mesh)
        self.step = 0
        self.drained = False
        self.losses: list = []

    def save(self) -> None:
        save_checkpoint(self.checkpoint_dir, self.step, self.model, self.optimizer)

    def load(self, state: Dict[str, Any]) -> None:
        """Continue from a :func:`restore_checkpoint` result, the full
        state; on a mesh this rank keeps its slice (:func:`shard_params`,
        AdamW's moments by their parameter's rule)."""
        model_state, opt_state = state["model"], state["optimizer"]
        if _is_split(self.model.spmd):
            shard = lambda d: shard_params(d, self.mesh, self.config.n_heads)  # noqa: E731
            model_state = shard(model_state)
            opt_state = _moments_by_rule(self.model, opt_state, shard)
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(opt_state)
        self.step = state["step"]

    def run(self, n_steps: int) -> int:
        """Train up to *n_steps*; returns the step counter (it stops
        early when a drain checkpoint ends the loop).  Raises ValueError
        for a watcher on a mesh of more than one rank.

        Each step is one ``train.step`` trace in
        :func:`..obs.tracing.workload_tracer` (attributes ``step`` and, once
        trained, ``tokens``, b x (s - 1)), its phases in order:
        ``train.poll`` (the watcher), ``train.batch``, the step function's
        ``train.forward``, ``train.backward`` and ``train.optimizer``, and
        ``train.loss_read``, whose host read of the loss waits for the
        step and anchors the card's times (:mod:`..obs.hotpath`)."""
        if self.watcher is not None and self.mesh is not None and self.mesh.size() > 1:
            raise ValueError(
                "a watcher polled by one rank of a mesh stops only that rank: drive "
                "step_fn and save under multihost_trainer.MultihostDrainLoop instead"
            )
        tokens = self.batch_size * (self.config.max_seq_len - 1)
        for _ in range(n_steps):
            with hotpath.StepTrace("train.step", self.device, {"step": self.step}) as trace:
                with trace.phase("train.poll"):
                    drained = self.watcher is not None and self.watcher.check_and_acknowledge(self.save)
                if drained:
                    self.drained = True
                    break
                with trace.phase("train.batch"):
                    batch = make_batch(self.config, self.batch_size, self.step, self.device)
                loss = self.step_fn(batch)
                with trace.phase("train.loss_read"):
                    self.losses.append(float(loss))
                    trace.anchor()
                trace.root.set_attribute("tokens", tokens)
            self.step += 1
        return self.step


# --------------------------------------------------------------- serving


class Int8Dense(nn.Module):
    """:class:`Dense` with weight-only int8: ``q`` int8 [out, in], the
    per-row fp32 scale expanded from the node's ``s``, and the bias in the
    compute dtype (a quantized q/k/v bias is dequantized).  The forward is
    :func:`.quantize.int8_linear`: the CUDA kernel on the card, its plain
    version on the CPU."""

    def __init__(self, key: str, weight, bias, dtype, device) -> None:
        super().__init__()
        self.compute_dtype = dtype
        q = weight["q"]
        scale = quantize.scale_like(f"{key}.weight", q, weight["s"]).reshape(-1)
        if quantize.is_quant_node(bias):
            bias = quantize.dequantize_leaf(f"{key}.bias", bias)
        self.register_buffer("q", q.to(device, torch.int8).contiguous())
        self.register_buffer("scale", scale.to(device, torch.float32).contiguous())
        self.register_buffer("bias", bias.to(device, torch.float32).to(dtype))

    def forward(self, x):
        return quantize.int8_linear(x.to(self.compute_dtype).contiguous(), self.q, self.scale, self.bias)


class Int8Embed(nn.Module):
    """flax ``Embed`` over an int8 table: the rows taken, times the
    per-feature scale, in *dtype* (a gather of b rows needs no kernel)."""

    def __init__(self, key: str, node, dtype, device) -> None:
        super().__init__()
        self.compute_dtype = dtype
        scale = quantize.scale_like(key, node["q"], node["s"])
        self.register_buffer("q", node["q"].to(device, torch.int8))
        self.register_buffer("scale", scale.to(device, torch.float32))

    def forward(self, ids):
        return (self.q[ids].float() * self.scale).to(self.compute_dtype)


class Int8MoeMlp(nn.Module):
    """:class:`MoeMlp` with weight-only int8 experts: each expert's
    ``up`` and ``down`` are :func:`.quantize.int8_linear` launches, one per
    expert and projection, on ``q_e`` transposed once here to the kernel's
    ``[N, K]``, with the per-column scale that JAX shares across experts.
    *router* is the float Dense, which :func:`quantized_model` swaps for an
    :class:`Int8Dense` as it does every Dense."""

    def __init__(self, router, up, down, dtype, device) -> None:
        super().__init__()
        self.compute_dtype = dtype
        self.router = router
        for name, node in (("up", up), ("down", down)):
            q = node["q"].transpose(1, 2).contiguous()  # [E, in, out] -> [E, out, in]
            self.register_buffer(f"{name}_q", q.to(device, torch.int8))
            self.register_buffer(f"{name}_s", node["s"].reshape(-1).to(device, torch.float32).contiguous())

    def forward(self, h, spmd: Optional[_Spmd] = None):
        dt = self.compute_dtype
        gates = torch.softmax(self.router(h).float(), dim=-1).to(dt)
        x = h.to(dt).contiguous()
        downs = []
        for e in range(self.up_q.shape[0]):
            act = F.gelu(quantize.int8_linear(x, self.up_q[e], self.up_s), approximate="tanh")
            downs.append(quantize.int8_linear(act, self.down_q[e], self.down_s))
        return torch.einsum("bsed,bse->bsd", torch.stack(downs, -2), gates)


def quantized_model(config: ModelConfig, qstate: Dict[str, Any], device="cuda") -> TinyLM:
    """A TinyLM serving a :func:`.quantize.quantize_params_int8` state:
    its Dense and Embed layers are :class:`Int8Dense` / :class:`Int8Embed`
    and its MoE layers :class:`Int8MoeMlp`, holding the int8 nodes;
    LayerNorms keep their float leaves."""
    device = resolve_device(device)
    model = TinyLM(config, device=device)
    for name, module in list(model.named_modules()):  # a parent comes before its children
        parent, _, attr = name.rpartition(".")
        if isinstance(module, MoeMlp):
            layer = Int8MoeMlp(module.router, qstate[f"{name}.experts_up"], qstate[f"{name}.experts_down"],
                               config.dtype, device)
        elif isinstance(module, Dense):
            layer = Int8Dense(name, qstate[f"{name}.weight"], qstate[f"{name}.bias"], config.dtype, device)
        elif isinstance(module, Embed):
            layer = Int8Embed(f"{name}.embedding", qstate[f"{name}.embedding"], config.dtype, device)
        else:
            continue
        setattr(model.get_submodule(parent), attr, layer)
    # what is left as parameters is the LayerNorms'
    model.load_state_dict({k: qstate[k] for k, _ in model.named_parameters()}, strict=False)
    return model


def quantize_model(model: TinyLM) -> TinyLM:
    """The int8 serving model of a float TinyLM, on the same device."""
    device = next(model.parameters()).device
    return quantized_model(model.config, quantize.quantize_params_int8(model), device)


def _serving_model(config: ModelConfig, model_or_state, device: torch.device) -> nn.Module:
    """The model *generate* runs: a TinyLM as given, or one built from a
    float or quantized state dict."""
    if isinstance(model_or_state, nn.Module):
        mc = model_or_state.config
        fields = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_seq_len", "n_experts",
                  "dtype")
        if any(getattr(mc, f) != getattr(config, f) for f in fields):
            raise ValueError(f"model config {mc} does not match {config}")
        if _is_split(getattr(model_or_state, "spmd", None)):
            raise ValueError(
                "decode runs on one device: this model is split over a model axis or an "
                "expert axis; pass gather_params(model.state_dict(), mesh) instead"
            )
        where = {t.device.type for t in model_or_state.state_dict().values()}
        if where != {device.type}:
            raise ValueError(f"model on {where}, generate on {device}")
        return model_or_state
    if any(quantize.is_quant_node(v) for v in model_or_state.values()):
        return quantized_model(config, model_or_state, device)
    model = TinyLM(config, device=device)
    model.load_state_dict(model_or_state)
    return model


def _prompt_lens(prompt_lens, b: int, prompt_len: int, device):
    """([b] int64 on *device*, their sum); validated here, once, on the
    host."""
    if prompt_lens is None:
        return torch.full((b,), prompt_len, dtype=torch.long, device=device), b * prompt_len
    lens = torch.as_tensor(prompt_lens)
    if tuple(lens.shape) != (b,):
        raise ValueError(f"prompt_lens must be [batch] = [{b}], got {tuple(lens.shape)}")
    host = lens.cpu()
    if int(host.min()) < 1 or int(host.max()) > prompt_len:
        # out-of-range lengths would teacher-force the zero padding into
        # the cache: garbage, not an error
        raise ValueError(f"prompt_lens must lie in [1, {prompt_len}], got {host.tolist()}")
    return host.to(device, torch.long), int(host.sum())


def _sample(last, temperature: float, top_k: int, generator):
    """Gumbel-max draw from softmax(last / temperature), restricted to the
    logits >= the k-th largest (ties stay) when *top_k* > 0."""
    scaled = last / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (scaled + gumbel).argmax(-1)


def generate(
    config: ModelConfig,
    model_or_state,
    prompt,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    prompt_lens=None,
    device="cuda",
):
    """KV-cache decoding, the serving path (``workload.generate`` of the
    JAX package, step for step).

    *model_or_state* is a TinyLM (float, or int8 from :func:`quantize_model`
    / :func:`quantized_model`) or a state dict, float or quantized.  Step
    ``i`` of ``total - 1`` feeds ``buf[:, i]`` at position ``i`` and writes
    ``buf[:, i + 1]``: the prompt token while ``i + 1 < prompt_lens`` (rows
    may be ragged), else the argmax of the fp32 last logits
    (``temperature <= 0``) or a draw at ``max(temperature, 1e-6)`` from the
    ``top_k`` largest logits, seeded by *seed* on the device.  Returns the
    buffer [b, prompt_len + max_new_tokens], int64 on the device.  The loop
    keeps every decision on the device: no host synchronisation per token.

    The call is one ``decode.generate`` trace in
    :func:`..obs.tracing.workload_tracer` (attributes ``batch``,
    ``total_len`` and ``served_tokens``, the positions after each row's
    prompt), with one ``decode.step`` span a step (attribute ``i``), timed
    on the card (:mod:`..obs.hotpath`).  On the card the call ends in one
    host wait, for the event recorded after its last step, which anchors
    the steps' device times on the host's clock: the buffer is ready when
    it returns.
    """
    cfg = dataclasses.replace(
        config, decode=True, seq_axis=None, ring_attention=False, flash_attention=False, remat=False
    )
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt)
    b, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds max_seq_len ({cfg.max_seq_len})"
        )
    plens, prompt_tokens = _prompt_lens(prompt_lens, b, prompt_len, device)
    model = _serving_model(cfg, model_or_state, device)
    cache = KVCache(cfg, b, total, device)
    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, :prompt_len] = prompt.to(device)
    generator = torch.Generator(device=device).manual_seed(seed) if temperature > 0.0 else None
    attributes = {"batch": b, "total_len": total, "served_tokens": b * total - prompt_tokens}
    with hotpath.StepTrace("decode.generate", device, attributes) as trace:
        with torch.inference_mode():
            for i in range(total - 1):
                with trace.phase("decode.step", timed=True, i=i):
                    positions = torch.full((b, 1), i, dtype=torch.long, device=device)
                    last = model(buf[:, i:i + 1], positions, cache=cache)[:, -1].float()
                    if generator is None:
                        nxt = last.argmax(-1)
                    else:
                        nxt = _sample(last, max(temperature, 1e-6), top_k, generator)
                    buf[:, i + 1] = torch.where(plens > i + 1, buf[:, i + 1], nxt)
        trace.mark()
        trace.anchor(wait=True)
    return buf


def greedy_generate(config: ModelConfig, model_or_state, prompt, max_new_tokens: int, device="cuda"):
    """KV-cache greedy decoding: :func:`generate` at temperature 0."""
    return generate(config, model_or_state, prompt, max_new_tokens, device=device)
