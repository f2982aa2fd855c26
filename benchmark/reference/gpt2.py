"""Plain PyTorch GPT-2, as the program's configurations state it, in
float32 with TF32 off: the reference that decides ``correct``.

The block is GPT-2's: learned positions, pre-LN LayerNorm with biases,
causal multi-head attention with biased q/k/v/out projections, a tanh-GELU
MLP, a final LayerNorm and a biased LM head.  The program's departures from
published GPT-2 are followed (an untied head with a bias, LayerNorm eps
1e-6, no dropout).  Weights are a dict of fp32 tensors under the program's
state-dict names and torch layouts (``[out, in]``), as
``benchmark/inputs.py`` makes them; nothing here imports the program or
takes anything it made.

* :func:`train_steps` runs AdamW steps from given weights on given batches,
  a block of rows at a time, and returns what the comparison reads: each
  step's loss, each leaf's first-gradient norm and each leaf's change.
* :func:`quantized` derives weight-only int8 (or int4) weights from float
  ones, per output channel; :func:`served_gaps` judges served tokens by
  how far each lies below the reference's best logit.

``cast`` (a function applied to every matmul operand) puts a lower
precision in: :func:`fp8` is the training control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
#: AdamW as the configurations state it.
LR, BETA1, BETA2, ADAM_EPS, WEIGHT_DECAY = 3e-4, 0.9, 0.999, 1e-8, 1e-4

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def fp32_matmuls():
    """float32 matmuls and convolutions in full float32 (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _identity(x):
    return x


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """*x* rounded to *dtype* under one per-tensor scale that maps its
    largest magnitude to the type's largest, and back to x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype)) * scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding: the operand to e4m3 forward, its gradient
    to e5m2 backward, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round_to(grad, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's cast: a matmul operand in fp8 (see :class:`_Fp8`)."""
    return _Fp8.apply(x)


def layer_norm(x, scale, bias):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, LN_EPS)


def linear(x, w: Weights, name: str, cast: Callable = _identity):
    return F.linear(cast(x), cast(w[f"{name}.weight"]), w[f"{name}.bias"])


def attention(x, w: Weights, prefix: str, n_heads: int, cast: Callable = _identity):
    """Causal multi-head self-attention of x [r, s, d]."""
    r, s, d = x.shape
    hd = d // n_heads
    split = lambda t: t.reshape(r, s, n_heads, hd).transpose(1, 2)  # noqa: E731
    q, k, v = (split(linear(x, w, f"{prefix}.{n}", cast)) for n in ("query", "key", "value"))
    scores = cast(q) @ cast(k).transpose(-1, -2) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    h = (cast(probs) @ cast(v)).transpose(1, 2).reshape(r, s, d)
    return linear(h, w, f"{prefix}.out", cast)


def forward(w: Weights, tokens: torch.Tensor, n_heads: int, n_layers: int,
            cast: Callable = _identity) -> torch.Tensor:
    """Logits [r, s, vocab] of tokens [r, s], in the weights' dtype."""
    s = tokens.shape[1]
    x = w["embed.embedding"][tokens] + w["pos_embed.embedding"][:s][None]
    for i in range(n_layers):
        b = f"block_{i}"
        x = x + attention(layer_norm(x, w[f"{b}.ln_attn.scale"], w[f"{b}.ln_attn.bias"]), w,
                          f"{b}.attn", n_heads, cast)
        h = layer_norm(x, w[f"{b}.ln_mlp.scale"], w[f"{b}.ln_mlp.bias"])
        h = F.gelu(linear(h, w, f"{b}.mlp_up", cast), approximate="tanh")
        x = x + linear(h, w, f"{b}.mlp_down", cast)
    x = layer_norm(x, w["ln_f.scale"], w["ln_f.bias"])
    return linear(x, w, "lm_head", cast)


# ----------------------------------------------------------------- training


def train_steps(w0: Weights, batches: Iterable[torch.Tensor], n_heads: int, n_layers: int,
                rows_per_block: int = 1, cast: Callable = _identity) -> Dict:
    """AdamW steps from *w0* (fp32, taken over and updated in place), one a
    batch of tokens [b, S]: next-token cross-entropy over the b x (S - 1)
    targets, its gradient summed over blocks of *rows_per_block* rows.
    Returns ``losses`` (one a step), ``grad`` (each leaf's norm of the
    first step's gradient) and ``change`` (each leaf's norm of its change
    over all the steps)."""
    params = {k: t.requires_grad_() for k, t in w0.items()}
    start = {k: t.detach().clone() for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, tokens in enumerate(batches, start=1):
        tokens = tokens.to(next(iter(params.values())).device)
        n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
        total = 0.0
        for rows in tokens.split(rows_per_block):
            logits = forward(params, rows[:, :-1], n_heads, n_layers, cast)
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                  rows[:, 1:].reshape(-1), reduction="sum")
            (nll / n_targets).backward()
            total += float(nll.detach())
            del logits, nll
        losses.append(total / n_targets)
        with torch.no_grad():
            if step == 1:
                grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
            for k, p in params.items():
                g = p.grad
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (v[k] / (1 - BETA2 ** step)).sqrt_().add_(ADAM_EPS)
                p.mul_(1 - LR * WEIGHT_DECAY)
                p.addcdiv_(m[k], denom, value=-LR / (1 - BETA1 ** step))
                p.grad = None
    with torch.no_grad():
        change = {k: float((p - start[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad": grad_norms, "change": change}


# ------------------------------------------------------------------ serving


def _per_channel(view: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric quantization of *view* with one scale per last-axis
    column, amax / qmax (1 where amax is 0), rounded half to even and
    clipped, dequantized."""
    amax = view.abs().amax(dim=tuple(range(view.dim() - 1)), keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(view / scale), -qmax, qmax) * scale


def quantized(w: Weights, n_heads: int, bits: int = 8) -> Weights:
    """The weights as weight-only symmetric *bits*-bit quantization serves
    them, dequantized to fp32.  Channels: an embedding table per feature
    column; a q/k/v weight or bias per head-dim column, shared by the
    heads; every other matrix per output row.  LayerNorms and the other
    biases stay as they are."""
    qmax = 2 ** (bits - 1) - 1
    out = {}
    for name, t in w.items():
        layer, leaf = name.rsplit(".", 2)[-2:]
        t = t.float()
        if leaf == "embedding":
            out[name] = _per_channel(t, qmax)
        elif layer in ("query", "key", "value"):
            hd = t.shape[0] // n_heads
            if leaf == "weight":  # [h*hd, d] -> [h, d, hd]
                view = t.reshape(n_heads, hd, -1).transpose(1, 2)
                out[name] = _per_channel(view, qmax).transpose(1, 2).reshape(t.shape)
            else:
                out[name] = _per_channel(t.reshape(n_heads, hd), qmax).reshape(t.shape)
        elif t.dim() == 2:  # [out, in]: per output row
            out[name] = _per_channel(t.t(), qmax).t().contiguous()
        else:
            out[name] = t
    return out


@torch.no_grad()
def served_gaps(w: Weights, rows: torch.Tensor, prompt_lens: torch.Tensor, n_heads: int,
                n_layers: int, pick: Optional[Weights] = None) -> torch.Tensor:
    """For each row of *rows* [r, T] (prompt, then served tokens) the widest
    gap by which a served token's logit lies below the best logit of the
    reference (*w*), teacher-forced over the row.  With *pick*, the token
    judged at each served position is not the served one but the one that
    the weights *pick* put first there (the control).  Returns [r] fp32."""
    out = []
    for row, plen in zip(rows, prompt_lens.tolist()):
        inputs = row[None, :-1]
        logits = forward(w, inputs, n_heads, n_layers)[0, plen - 1:]
        if pick is None:
            chosen = row[plen:]
        else:
            chosen = forward(pick, inputs, n_heads, n_layers)[0, plen - 1:].argmax(-1)
        gap = logits.max(-1).values - logits.gather(-1, chosen[:, None])[:, 0]
        out.append(gap.max())
    return torch.stack(out)
