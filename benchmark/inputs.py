"""What the benchmark hands the program and the reference alike: the
initial weights, the training batches and the prompts, each made from the
seed.  Nothing here imports the program."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

#: Seeds are taken modulo this, so any whole number is a seed.
SEED_MOD = 2**63


def leaf_shapes(model: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the GPT-2 block stack, under the
    names and torch layouts (``[out, in]`` weights) of the program's
    state dict, in a fixed order."""
    v, d, f, s = model["vocab_size"], model["d_model"], model["d_ff"], model["max_seq_len"]
    leaves = [("embed.embedding", (v, d)), ("pos_embed.embedding", (s, d))]
    for i in range(model["n_layers"]):
        b = f"block_{i}"
        leaves += [(f"{b}.ln_attn.scale", (d,)), (f"{b}.ln_attn.bias", (d,))]
        for name in ("query", "key", "value", "out"):
            leaves += [(f"{b}.attn.{name}.weight", (d, d)), (f"{b}.attn.{name}.bias", (d,))]
        leaves += [(f"{b}.ln_mlp.scale", (d,)), (f"{b}.ln_mlp.bias", (d,))]
        leaves += [(f"{b}.mlp_up.weight", (f, d)), (f"{b}.mlp_up.bias", (f,))]
        leaves += [(f"{b}.mlp_down.weight", (d, f)), (f"{b}.mlp_down.bias", (d,))]
    leaves += [("ln_f.scale", (d,)), ("ln_f.bias", (d,))]
    leaves += [("lm_head.weight", (v, d)), ("lm_head.bias", (v,))]
    return leaves


def init_std(name: str, n_layers: int) -> float:
    """GPT-2's initial standard deviation of a matrix: 0.02, the residual
    projections (``attn.out``, ``mlp_down``) 0.02 / sqrt(2 * n_layers), the
    position table 0.01."""
    if name == "pos_embed.embedding":
        return 0.01
    if name.endswith(("attn.out.weight", "mlp_down.weight")):
        return 0.02 / math.sqrt(2 * n_layers)
    return 0.02


def make_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial fp32 weights: every matrix from one normal draw on
    *device* by a generator seeded with *seed*, scaled by
    :func:`init_std`; biases 0, LayerNorm scales 1.  The matrices are
    views of one buffer."""
    leaves = leaf_shapes(model)
    total = sum(math.prod(shape) for _, shape in leaves if len(shape) == 2)
    gen = torch.Generator(device=device).manual_seed(seed % SEED_MOD)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in leaves:
        if len(shape) == 2:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(init_std(name, model["n_layers"]))
            offset += n
        elif name.endswith(".scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def train_batch(vocab_size: int, batch: int, seq_len: int, step: int) -> torch.Tensor:
    """The tokens of training step *step*: uniform over the vocabulary,
    [batch, seq_len] int64 on the host, from numpy's generator seeded by
    the step (the draw of the program's ``make_batch``)."""
    rng = np.random.default_rng(step)
    return torch.from_numpy(rng.integers(0, vocab_size, size=(batch, seq_len)).astype(np.int64))


def prompt_lengths(spec: Dict, batch: int) -> np.ndarray:
    """The multiset of prompt lengths of one call, sorted: log-normal
    quantiles (median *spec["median"]*, shape *spec["sigma"]*) at
    ``(i + 0.5) / batch``, rounded and clipped to [min, max].  The same for
    every seed, so every call does the same work."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / batch) for i in range(batch)])
    lens = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(lens, spec["min"], spec["max"]).astype(np.int64)


def decode_prompts(spec: Dict, vocab_size: int, batch: int, seed: int, call: int):
    """(prompt [batch, max] int64, lengths [batch] int64) of call *call*:
    :func:`prompt_lengths` permuted, tokens uniform over the vocabulary,
    both from numpy's generator seeded by (seed, call).  Positions past a
    row's length hold 0."""
    rng = np.random.default_rng([seed % SEED_MOD, call])
    lens = rng.permutation(prompt_lengths(spec, batch))
    tokens = rng.integers(0, vocab_size, size=(batch, spec["max"]))
    tokens[np.arange(spec["max"])[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(lens)
