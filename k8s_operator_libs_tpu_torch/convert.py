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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def params_from_jax(np_params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax TinyLM param tree (numpy leaves) -> a fp32 ``state_dict``
    for :class:`~.tpu.workload.TinyLM`."""
    state = {}
    for path, leaf in _flatten(np_params).items():
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 3 and path[-2] == "out":  # [h, hd, d]
                arr = arr.reshape(-1, arr.shape[-1])
            elif arr.ndim == 3:  # [d, h, hd]
                arr = arr.reshape(arr.shape[0], -1)
            arr, name = arr.T, "weight"
        elif name == "bias" and arr.ndim == 2:  # attn q/k/v bias [h, hd]
            arr = arr.reshape(-1)
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def params_to_jax(state_dict: Mapping[str, torch.Tensor], n_heads: int) -> Dict:
    """The inverse of :func:`params_from_jax`: a nested dict of numpy
    arrays in flax's layouts (*n_heads* restores the head axes)."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        arr = tensor.detach().to("cpu", torch.float32).numpy()
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
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
