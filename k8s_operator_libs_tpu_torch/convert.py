"""Weights bridge: a flax TinyLM param tree <-> the port's ``state_dict``.

The flax tree (``model.init(...)["params"]``, leaves as numpy arrays) and
:class:`~.tpu.workload.TinyLM` share module names, so a path
``block_0/attn/query/kernel`` becomes the key ``block_0.attn.query.weight``.
What changes is each leaf's layout:

* ``Dense`` kernels are ``[in, out]``; ``nn.Linear`` weights ``[out, in]``:
  transposed;
* ``attn/{query,key,value}/kernel`` is ``[d, h, hd]``: reshaped to
  ``[d, h*hd]``, then transposed; their biases ``[h, hd]`` flatten;
* ``attn/out/kernel`` is ``[h, hd, d]``: reshaped to ``[h*hd, d]``, then
  transposed;
* ``Embed/embedding`` and ``LayerNorm/{scale,bias}`` keep their names and
  layouts.

A weight-only int8 tree (:mod:`.tpu.quantize`) carries ``{"q", "s"}``
nodes in place of leaves: ``q`` stays int8 and takes its leaf's layout
change; ``s`` keeps the shape JAX gave it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def is_quant_node(node: Any) -> bool:
    """A ``{"q": int8, "s": fp32 scale}`` node of a quantized tree."""
    return isinstance(node, Mapping) and set(node.keys()) == {"q", "s"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping) and not is_quant_node(value):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _layout_from_jax(path: tuple, arr: np.ndarray):
    """(array in the torch layout, torch leaf name) of flax leaf *path*."""
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 3 and path[-2] == "out":  # [h, hd, d]
            arr = arr.reshape(-1, arr.shape[-1])
        elif arr.ndim == 3:  # [d, h, hd]
            arr = arr.reshape(arr.shape[0], -1)
        return arr.T, "weight"
    if name == "bias" and arr.ndim == 2:  # attn q/k/v bias [h, hd]
        return arr.reshape(-1), name
    return arr, name


def _layout_to_jax(path: list, arr: np.ndarray, n_heads: int):
    """The inverse of :func:`_layout_from_jax` for torch key *path*."""
    name = path[-1]
    attn = len(path) >= 3 and path[-3] == "attn"
    if name == "weight":
        arr, name = arr.T, "kernel"
        if attn and path[-2] == "out":  # [h*hd, d] -> [h, hd, d]
            arr = arr.reshape(n_heads, -1, arr.shape[-1])
        elif attn:  # [d, h*hd] -> [d, h, hd]
            arr = arr.reshape(arr.shape[0], n_heads, -1)
    elif name == "bias" and attn and path[-2] != "out":
        arr = arr.reshape(n_heads, -1)
    return arr, name


def params_from_jax(np_params: Mapping) -> Dict[str, Any]:
    """A flax TinyLM param tree (numpy leaves) -> a fp32 ``state_dict``
    for :class:`~.tpu.workload.TinyLM`; a quantized tree's nodes become
    ``{"q": int8 tensor, "s": fp32 tensor}`` under the same keys."""
    state: Dict[str, Any] = {}
    for path, leaf in _flatten(np_params).items():
        if is_quant_node(leaf):
            q, name = _layout_from_jax(path, np.array(leaf["q"], dtype=np.int8))
            value = {
                "q": torch.from_numpy(np.ascontiguousarray(q)),
                "s": torch.from_numpy(np.array(leaf["s"], dtype=np.float32)),
            }
        else:
            # np.array: a writable copy
            arr, name = _layout_from_jax(path, np.array(leaf, dtype=np.float32))
            value = torch.from_numpy(np.ascontiguousarray(arr))
        state[".".join(path[:-1] + (name,))] = value
    return state


def params_to_jax(state_dict: Mapping[str, Any], n_heads: int) -> Dict:
    """The inverse of :func:`params_from_jax`: a nested dict of numpy
    arrays in flax's layouts (*n_heads* restores the head axes)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        path = key.split(".")
        if is_quant_node(value):
            q, name = _layout_to_jax(path, value["q"].detach().cpu().numpy(), n_heads)
            leaf = {
                "q": np.ascontiguousarray(q),
                "s": value["s"].detach().to("cpu", torch.float32).numpy(),
            }
        else:
            arr = torch.as_tensor(value).detach().to("cpu", torch.float32).numpy()
            arr, name = _layout_to_jax(path, arr, n_heads)
            leaf = np.ascontiguousarray(arr)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree
