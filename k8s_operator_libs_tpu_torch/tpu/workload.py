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
  checkpoints, acknowledges and stops;
* :func:`generate` / :func:`greedy_generate` — the serving path: one token
  per step over a per-layer :class:`KVCache`, greedy or seeded
  temperature/top-k sampling, ragged prompts, and weight-only int8
  (:func:`quantized_model`, whose layers run the int8 kernel of
  :mod:`.quantize`).

Numerics follow flax: parameters are fp32 masters and every layer casts
its input and parameters to ``config.dtype`` in its forward (no
autocast); LayerNorm takes its statistics in fp32 with flax's eps 1e-6
and fast variance; GELU is the tanh approximation; AdamW uses optax's
weight decay 1e-4 on every parameter.  Attention runs dense ("gather")
by default and through the flash kernels with ``flash_attention=True``;
decode attends over the cache densely, as flax's decode mode does.
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

from . import quantize

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
    #: them yet and raises rather than ignore one.
    seq_axis: Any = None
    n_experts: int = 0
    ring_attention: bool = False
    ring_flash: bool = False
    ring_layout: str = "contiguous"
    remat: bool = False
    #: Route attention through the CUDA flash kernels
    #: (:mod:`.flash_attention`), padding the sequence to a whole block.
    flash_attention: bool = False
    #: Decode mode: :class:`TinyLM` takes one token per call with a
    #: :class:`KVCache` (``generate`` sets it, as the JAX package does).
    decode: bool = False

    def __post_init__(self) -> None:
        spmd = "the SPMD part of k8s_operator_libs_tpu/tpu/workload.py"
        ring = "k8s_operator_libs_tpu/tpu/ring_attention.py"
        not_ported = {
            "n_experts": (self.n_experts > 0, f"{spmd} (MoE, expert parallelism)"),
            "seq_axis": (self.seq_axis is not None, f"{spmd} (sequence parallelism)"),
            "ring_attention": (self.ring_attention, ring),
            "ring_flash": (self.ring_flash, ring),
            "ring_layout": (self.ring_layout != "contiguous", ring),
            "remat": (self.remat, f"{spmd} (remat)"),
        }
        for field, (set_, module) in not_ported.items():
            if set_:
                raise NotImplementedError(
                    f"ModelConfig.{field} is not ported to PyTorch yet: it waits "
                    f"for the port of {module}"
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
    them — dense, or the flash kernels; over a :class:`KVCache` in
    decode."""

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
        """Causal attention in the compute dtype (the "gather" path)."""
        s = q.shape[1]
        return _attend(q, k, v, torch.ones(s, s, dtype=torch.bool, device=q.device).tril())

    @staticmethod
    def _cached(q, k, v, cache: KVCache, layer: int):
        """flax's decode step: write this token's K/V at the cache index,
        then attend over the cached keys ``arange(total) <= index``."""
        i, keys, values = cache.index, cache.keys[layer], cache.values[layer]
        keys[:, i] = k[:, 0]
        values[:, i] = v[:, 0]
        visible = torch.arange(keys.shape[1], device=q.device) <= i
        return _attend(q, keys, values, visible)

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.n_heads, d // self.n_heads)  # noqa: E731
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if cache is None:
            h = self.attention_fn(q, k, v)
        else:
            h = self._cached(q, k, v, cache, layer)
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

    def forward(self, x, cache: KVCache = None, layer: int = 0):
        x = x + self.attn(self.ln_attn(x), cache, layer)
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

    def forward(self, tokens, positions=None, cache: KVCache = None):
        """Logits [b, s, vocab].  With a *cache* (decode) *tokens* is one
        token per row, written at ``cache.index``, which then advances."""
        if cache is None and self.config.decode:
            raise ValueError("a decode-mode TinyLM takes a KVCache")
        if cache is not None and tokens.shape[1] != 1:
            raise ValueError(f"decode feeds one token per row, got {tokens.shape[1]}")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x = self.embed(tokens) + self.pos_embed(positions)
        for i in range(self.config.n_layers):
            x = getattr(self, f"block_{i}")(x, cache, i)
        if cache is not None:
            cache.index += 1
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


def quantized_model(config: ModelConfig, qstate: Dict[str, Any], device="cuda") -> TinyLM:
    """A TinyLM serving a :func:`.quantize.quantize_params_int8` state:
    its Dense and Embed layers are :class:`Int8Dense` / :class:`Int8Embed`
    holding the int8 nodes, LayerNorms keep their float leaves."""
    device = resolve_device(device)
    model = TinyLM(config, device=device)
    for name, module in list(model.named_modules()):
        parent, _, attr = name.rpartition(".")
        if isinstance(module, Dense):
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
        fields = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_seq_len", "dtype")
        if any(getattr(mc, f) != getattr(config, f) for f in fields):
            raise ValueError(f"model config {mc} does not match {config}")
        where = {t.device.type for t in model_or_state.state_dict().values()}
        if where != {device.type}:
            raise ValueError(f"model on {where}, generate on {device}")
        return model_or_state
    if any(quantize.is_quant_node(v) for v in model_or_state.values()):
        return quantized_model(config, model_or_state, device)
    model = TinyLM(config, device=device)
    model.load_state_dict(model_or_state)
    return model


def _prompt_lens(prompt_lens, b: int, prompt_len: int, device) -> torch.Tensor:
    """[b] int64 on *device*; validated here, once, on the host."""
    if prompt_lens is None:
        return torch.full((b,), prompt_len, dtype=torch.long, device=device)
    lens = torch.as_tensor(prompt_lens)
    if tuple(lens.shape) != (b,):
        raise ValueError(f"prompt_lens must be [batch] = [{b}], got {tuple(lens.shape)}")
    host = lens.cpu()
    if int(host.min()) < 1 or int(host.max()) > prompt_len:
        # out-of-range lengths would teacher-force the zero padding into
        # the cache: garbage, not an error
        raise ValueError(f"prompt_lens must lie in [1, {prompt_len}], got {host.tolist()}")
    return host.to(device, torch.long)


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
    plens = _prompt_lens(prompt_lens, b, prompt_len, device)
    model = _serving_model(cfg, model_or_state, device)
    cache = KVCache(cfg, b, total, device)
    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, :prompt_len] = prompt.to(device)
    generator = torch.Generator(device=device).manual_seed(seed) if temperature > 0.0 else None
    with torch.inference_mode():
        for i in range(total - 1):
            positions = torch.full((b, 1), i, dtype=torch.long, device=device)
            last = model(buf[:, i:i + 1], positions, cache=cache)[:, -1].float()
            if generator is None:
                nxt = last.argmax(-1)
            else:
                nxt = _sample(last, max(temperature, 1e-6), top_k, generator)
            buf[:, i + 1] = torch.where(plens > i + 1, buf[:, i + 1], nxt)
    return buf


def greedy_generate(config: ModelConfig, model_or_state, prompt, max_new_tokens: int, device="cuda"):
    """KV-cache greedy decoding: :func:`generate` at temperature 0."""
    return generate(config, model_or_state, prompt, max_new_tokens, device=device)
