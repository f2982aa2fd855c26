"""The training job the orchestrator drains — TinyLM in PyTorch.

The port of the single-device gather and flash paths of
``k8s_operator_libs_tpu/tpu/workload.py``:

* :class:`ModelConfig`, :class:`Block` and :class:`TinyLM` — embed, pre-LN
  blocks (causal attention, then a GELU MLP), LN, LM head;
* :func:`loss_fn` — next-token NLL; :func:`make_train_step` — one AdamW
  update;
* :func:`save_checkpoint` / :func:`restore_checkpoint` — ``torch.save`` of
  the step, the model and the optimizer;
* :class:`CheckpointingTrainer` — polls the drain watcher between steps,
  checkpoints, acknowledges and stops.

Numerics follow flax: parameters are fp32 masters and every layer casts
its input and parameters to ``config.dtype`` in its forward (no
autocast); LayerNorm takes its statistics in fp32 with flax's eps 1e-6
and fast variance; GELU is the tanh approximation; AdamW uses optax's
weight decay 1e-4 on every parameter.  Attention runs dense ("gather")
by default and through the flash kernels with ``flash_attention=True``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: optax.adamw(3e-4)'s settings (optax 0.2 defaults: b1 0.9, b2 0.999,
#: eps 1e-8, weight decay 1e-4 on every parameter).
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
#: flax LayerNorm's default epsilon (torch's is 1e-5).
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq_len: int = 64
    dtype: Any = torch.float32  # bfloat16 on the card
    #: The fields below exist in the JAX config; the port runs none of
    #: them yet and raises rather than ignore one (ROADMAP, queue A).
    seq_axis: Any = None
    n_experts: int = 0
    ring_attention: bool = False
    ring_flash: bool = False
    ring_layout: str = "contiguous"
    remat: bool = False
    #: Route attention through the CUDA flash kernels
    #: (:mod:`.flash_attention`), padding the sequence to a whole block.
    flash_attention: bool = False
    decode: bool = False

    def __post_init__(self) -> None:
        not_ported = {
            "n_experts": (self.n_experts > 0, "A8 (SPMD: MoE/EP)"),
            "seq_axis": (self.seq_axis is not None, "A8 (SPMD: sequence parallelism)"),
            "ring_attention": (self.ring_attention, "A9 (ring_attention.py)"),
            "ring_flash": (self.ring_flash, "A9 (ring_attention.py)"),
            "ring_layout": (
                self.ring_layout != "contiguous", "A9 (ring_attention.py)"
            ),
            "remat": (self.remat, "A8 (SPMD: remat)"),
            "decode": (self.decode, "A4 (serving)"),
        }
        for field, (set_, item) in not_ported.items():
            if set_:
                raise NotImplementedError(
                    f"ModelConfig.{field} is not ported to PyTorch yet "
                    f"(ROADMAP item {item})"
                )


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
    torch's ``[out, in]``; flax's kernel is its transpose."""

    def __init__(self, in_f, out_f, dtype, device, generator) -> None:
        super().__init__(in_f, out_f, device=device, dtype=torch.float32)
        self.compute_dtype = dtype
        with torch.no_grad():
            _lecun_normal_(self.weight, in_f, generator)
            self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = d_model):
    query/key/value/out projections with biases, causal attention between
    them — dense, or the flash kernels."""

    def __init__(self, cfg: ModelConfig, device, generator) -> None:
        super().__init__()
        d = cfg.d_model
        self.n_heads = cfg.n_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(d, d, cfg.dtype, device, generator))
        if cfg.flash_attention:
            from .flash_attention import make_flash_attention_fn

            self.attention_fn = make_flash_attention_fn()
        else:
            self.attention_fn = self._dense_causal

    def _dense_causal(self, q, k, v):
        """flax ``dot_product_attention`` with the causal mask, in the
        compute dtype (the "gather" path)."""
        s, d = q.shape[1], q.shape[3]
        q = q / math.sqrt(d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)

    def forward(self, x):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.n_heads, d // self.n_heads)  # noqa: E731
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        h = self.attention_fn(q, k, v)
        return self.out(h.reshape(b, s, d))


class Block(nn.Module):
    """Pre-LN transformer block with causal self-attention."""

    def __init__(self, cfg: ModelConfig, device, generator) -> None:
        super().__init__()
        dt = cfg.dtype
        self.ln_attn = LayerNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg, device, generator)
        self.ln_mlp = LayerNorm(cfg.d_model, dt, device)
        self.mlp_up = Dense(cfg.d_model, cfg.d_ff, dt, device, generator)
        self.mlp_down = Dense(cfg.d_ff, cfg.d_model, dt, device, generator)

    def forward(self, x):
        x = x + self.attn(self.ln_attn(x))
        h = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TinyLM(nn.Module):
    """Causal LM: embed → blocks → LN → logits.  Submodule names follow
    the flax param tree (``block_0/attn/query`` is ``block_0.attn.query``)
    so :mod:`..convert` maps one onto the other."""

    def __init__(self, config: ModelConfig, device="cuda", seed: int = 0) -> None:
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device, gen)
        self.pos_embed = Embed(cfg.max_seq_len, cfg.d_model, cfg.dtype, device, gen)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", Block(cfg, device, gen))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device, gen)

    def forward(self, tokens, positions=None):
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.embed(tokens) + self.pos_embed(positions)
        for i in range(self.config.n_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.lm_head(self.ln_f(x))


# ------------------------------------------------------------ train state


def create_train_state(config: ModelConfig, device="cuda", seed: int = 0):
    """(model, optimizer): TinyLM from *seed* and ``optax.adamw(3e-4)``'s
    torch counterpart."""
    device = resolve_device(device)
    model = TinyLM(config, device=device, seed=seed)
    optimizer = torch.optim.AdamW(model.parameters(), **ADAMW)
    return model, optimizer


def _token_nll(logits, targets):
    """Mean next-token negative log-likelihood, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def loss_fn(model: TinyLM, tokens):
    """Next-token cross-entropy (teacher-forced causal LM)."""
    return _token_nll(model(tokens[:, :-1]), tokens[:, 1:])


def make_train_step(model: TinyLM, optimizer):
    """``step(tokens) -> loss``: one AdamW update, in place."""

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_batch(config: ModelConfig, batch_size: int, seed: int = 0, device="cpu"):
    """The JAX package's batch, token for token (same numpy generator),
    as int64 for ``nn.Embedding``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, config.vocab_size, size=(batch_size, config.max_seq_len))
    return torch.from_numpy(tokens.astype(np.int64)).to(device)


# ------------------------------------------------------------ checkpoints


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def save_checkpoint(directory: str, step: int, model, optimizer) -> None:
    """``torch.save`` of the full training state."""
    os.makedirs(directory, exist_ok=True)
    path = _checkpoint_path(directory, step)
    tmp = path + ".tmp"
    torch.save(
        {
            "step": step,
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
        },
        tmp,
    )
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
    """

    def __init__(
        self,
        config: ModelConfig,
        checkpoint_dir: str,
        watcher=None,
        batch_size: int = 8,
        device="cuda",
        seed: int = 0,
    ) -> None:
        self.config = config
        self.checkpoint_dir = checkpoint_dir
        self.watcher = watcher
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model, self.optimizer = create_train_state(config, self.device, seed)
        self.step_fn = make_train_step(self.model, self.optimizer)
        self.step = 0
        self.drained = False
        self.losses: list = []

    def save(self) -> None:
        save_checkpoint(self.checkpoint_dir, self.step, self.model, self.optimizer)

    def load(self, state: Dict[str, Any]) -> None:
        """Continue from a :func:`restore_checkpoint` result."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]

    def run(self, n_steps: int) -> int:
        """Train up to *n_steps*; returns the step counter (it stops
        early when a drain checkpoint ends the loop)."""
        for _ in range(n_steps):
            if self.watcher is not None and self.watcher.check_and_acknowledge(
                self.save
            ):
                self.drained = True
                break
            batch = make_batch(self.config, self.batch_size, self.step, self.device)
            self.losses.append(float(self.step_fn(batch)))
            self.step += 1
        return self.step
